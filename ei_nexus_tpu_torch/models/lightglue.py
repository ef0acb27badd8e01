"""LightGlue attention matcher: the inference forward and the training
forward of stage 2.

Counterpart of `ei_nexus_tpu/models/lightglue.py`: transformer layers with
the rotary learnable-Fourier positional encoding, bidirectional shared-QK
cross attention, the sigmoid-gated dual-softmax assignment head and
mutual + threshold match filtering, over static K slots per side with
validity masks. In training (`forward(training=True)`, on a model built
with `training_heads=True`) every layer's assignment head and the token
confidence heads (on detached descriptors) feed the deep-supervision loss.

`attention_impl`: "auto" and "pallas" take the fused kernels of
ops/attention_kernels.py (the CUDA kernels on a CUDA tensor, their plain
versions on a CPU tensor; key-side masks) where the token counts lie on
the JAX package's `_pallas_supported` grid (N % 128 == 0, heads of 64,
N*M <= 1024^2; the cross-attention also M % 128 == 0), and the einsum
path elsewhere, as the JAX package does: kernels A and B at inference,
or kernel E (q-blocked; rotary fused for self-attention, two rotary-free
launches at scale 1 for the cross-attention) when `block_q` > 0 divides
the token counts, the counterpart of the JAX package's
EI_NEXUS_ATTN_QBLOCK; the differentiable kernel D/F pair in training
(rotary applied outside, scale d^-0.5 for self-attention, two calls at
scale 1 for the cross-attention). Unlike the JAX package, which trains on
XLA attention unless EI_NEXUS_ATTN_TRAIN=pallas is set, training takes
the kernels without a switch. "flash" takes kernel G
(ops/flash_kernel.py, jax's TPU flash attention with the key mask as
segment ids) at inference where the JAX package does, for token counts
that are multiples of 128 (its `_flash_supported` without the backend
term): rotary applied outside and scale d^-0.5 for self-attention, two
passes at scale 1 for the cross-attention; elsewhere, and in training, the
einsum path. "xla" takes the plain einsum path with `_attention_xla` and
the CrossBlock's joint mask, under autograd in training.

The linear layers (`layers.Linear`) take kernel L (ops/linear_kernel.py,
3xTF32 products) on the card in float32 wherever no autograd graph is
wanted; there the FFN's first product reads [x, message] in place of
their concatenation and its second adds the residual as it stores
(`_ffn_residual`). Elsewhere, F.linear, torch.cat and an add.

Adaptive inference (`depth_confidence` / `width_confidence` > 0, the
reference's defaults 0.95 / 0.99; training ignores them): after each layer
the token-confidence heads decide whether the whole batch stops (every
pair's share of confident valid, surviving tokens above
depth_confidence, against the threshold clip(0.8 + 0.1 exp(-4i/L), 0, 1))
and which tokens are pruned (confident and unmatchable). Shapes never
change: pruning folds into the attention's key masks, which every
attention setting takes, and into the exit layer's assignment head (the
joint outer product of the pruning masks set to -1e9), kept apart from the
slots' validity so that a run that prunes nothing equals the plain
forward bit for bit. The layers after the exit are skipped: the JAX
package's `lax.cond` on the batch's `done` becomes a host read of it, one
sync a layer until the batch stops (at most L - 1). `scan_layers=True`
runs the unrolled loop (the JAX package's scanned layers are the same
math); its parameters are every layer's assignment head, as the scanned
tree holds them (`port_jax.load_jax_variables` unstacks that tree).

`shard_heads` (tensor-parallel heads, the JAX package's sharding of the
head axis over the mesh's "model" axis) takes the einsum path, as the JAX
package's dispatch does (`attention_impl` "xla"), and, under a mesh whose
model group holds more than one rank (`parallel.mesh.use_mesh`), splits
each attention block's heads over it: the parameters stay whole on every
rank (the JAX package replicates them), and a rank computes its heads'
rows of Wqkv (to_qk and to_v in the cross-attention) and its heads'
columns of out_proj (to_out); the input (and the rotary tables) enter
through `copy_to_group`, the partial product leaves through
`reduce_from_group`, and the bias is added once after it. The
head-sliced parameters (`head_sliced_parameters`) take a gradient in
their rank's slice only, which the training step sums over the model
group; every other parameter carries its whole gradient on every rank,
which the step averages there (the card's atomic adds round the ranks
apart). Outside a mesh, or at model size 1, the blocks compute every
head. The head count must divide by the model size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention_kernels import (cross_attention_bidir, fused_attention,
                                     rotate_half, self_attention)
from ..ops.flash_kernel import flash_attention, segment_ids_from_mask
from ..parallel.collectives import copy_to_group, reduce_from_group
from ..parallel.mesh import active_mesh, use_mesh
from ..utils.profiling import annotate
from .layers import LayerNorm, Linear

_MASK_BIAS = -1e9


@dataclasses.dataclass(frozen=True)
class LightGlueConfig:
    input_dim: int = 256
    descriptor_dim: int = 256
    n_layers: int = 9
    num_heads: int = 4
    filter_threshold: float = 0.0
    gamma: float = 1.0           # deep-supervision layer weighting (loss)
    nll_balancing: float = 0.5   # (loss)
    dtype: str = "float32"       # compute dtype of dense/attention layers
    score_dtype: str = "float32"  # dtype of the einsum path's score matrices
    shard_heads: bool = False
    attention_impl: str = "auto"  # "auto" | "pallas" | "xla" | "flash"
    # q-block size of the "auto"/"pallas" inference kernels (0: kernels A
    # and B; 64 or 128: kernel E where it divides the token counts), the
    # counterpart of ops/pallas_attention._QBLOCK
    block_q: int = 0
    scan_layers: bool = False
    depth_confidence: float = -1.0
    width_confidence: float = -1.0


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor
                        ) -> torch.Tensor:
    """Center and scale (B, N, 2) keypoints by the (B, 2) image size, both
    in the same axis order (yx with (H, W))."""
    shift = size / 2.0
    scale = size.amax(dim=-1, keepdim=True) / 2.0
    return (kpts - shift[:, None, :]) / scale[:, None, :]


def apply_rotary(freqs, t: torch.Tensor) -> torch.Tensor:
    return t * freqs[0] + rotate_half(t) * freqs[1]


class FourierPositionalEncoding(nn.Module):
    """Learnable Fourier features -> rotary (cos, sin) tables, each
    (B, 1, N, head_dim) with pairs of equal lanes (repeat_interleave)."""

    def __init__(self, head_dim: int, gamma: float = 1.0):
        super().__init__()
        self.Wr = Linear(2, head_dim // 2, bias=False, init_std=gamma ** -2)

    def forward(self, x: torch.Tensor):
        proj = self.Wr(x)
        cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)
        sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)
        return cos[:, None], sin[:, None]


def _scalar(value: float, like: torch.Tensor) -> float:
    """A scale rounded to the operand's dtype first, as JAX rounds a Python
    scalar multiplying an array (a host value: no copy to the device)."""
    return torch.tensor(value, dtype=like.dtype).item()


def _flash_supported(n: int, d: int) -> bool:
    """Token counts kernel G takes in LightGlue: the JAX package's
    `_flash_supported` (tiles of at least 128) without its backend term."""
    return n % 128 == 0 and n >= 128 and d % 8 == 0


def _pallas_supported(n: int, d: int, m: Optional[int] = None) -> bool:
    """Token counts the "auto"/"pallas" kernels (A, B, D, E, F) take in
    LightGlue: the JAX package's `_pallas_supported` (tiles of 128, heads
    of 64, at most 1024^2 scores a head) without its backend term; the
    cross-attention also needs M % 128 == 0 there. Elsewhere the blocks
    take the einsum path, as the JAX package does."""
    return n % 128 == 0 and d % 64 == 0 and n * (m or n) <= 1024 ** 2


def _flash(q, k, v, kv_mask, sm_scale: float) -> torch.Tensor:
    """Kernel G with the key mask as segment ids (queries 1, valid keys 1,
    invalid keys 2), as the JAX package's `_flash_attention`."""
    q_seg, kv_seg = segment_ids_from_mask(kv_mask, q.shape[2])
    return flash_attention(q, k, v, q_seg, kv_seg, sm_scale)


def _attention_xla(q, k, v, kv_mask: Optional[torch.Tensor],
                   score_dtype=torch.float32) -> torch.Tensor:
    """(B, h, N, d) attention, kv_mask (B, M) masks keys: the scale folded
    into q in its dtype, float32 products, scores kept in `score_dtype`,
    float32 softmax, probabilities in the value dtype."""
    q = q * _scalar(q.shape[-1] ** -0.5, q)
    sim = torch.matmul(q.float(), k.float().mT).to(score_dtype)
    if kv_mask is not None:
        sim = sim.masked_fill(~kv_mask[:, None, None, :], _MASK_BIAS)
    attn = torch.softmax(sim.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


def _head_split(num_heads: int):
    """(model group, heads a rank, first head) of this rank under the
    active mesh's model group, or None where every head is computed here
    (no mesh, or model size 1). Raises when the heads do not divide."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return None
    if num_heads % mesh.model:
        raise ValueError(f"{num_heads} heads do not divide over "
                         f"{mesh.model} model ranks")
    per = num_heads // mesh.model
    return mesh.model_group, per, per * mesh.model_index


def _sliced_linear(layer: Linear, x: torch.Tensor, rows: slice
                   ) -> torch.Tensor:
    """`layer`'s output rows `rows` only (the features of some heads)."""
    dt = layer.compute_dtype or x.dtype
    return F.linear(x.to(dt), layer.weight[rows].to(dt),
                    layer.bias[rows].to(dt))


def _merged_out(layer: Linear, msg: torch.Tensor, cols: slice, group
                ) -> torch.Tensor:
    """`layer` over the heads' message split across `group`: this rank's
    input columns `cols`, the partial products summed over the group,
    then the bias, added once. The partial products of the compute dtype's
    operands stay float32 until the sum, which is rounded once to the
    compute dtype, as the whole product (float32 accumulation) is."""
    dt = layer.compute_dtype or msg.dtype
    part = F.linear(msg.to(dt).float(), layer.weight[:, cols].to(dt).float())
    out = reduce_from_group(part, group) + layer.bias.to(dt).float()
    return out.to(dt)


def _ffn(dim: int, dtype) -> nn.Sequential:
    return nn.Sequential(Linear(2 * dim, 2 * dim, dtype=dtype),
                         LayerNorm(2 * dim, dtype=dtype), nn.GELU(),
                         Linear(2 * dim, dim, dtype=dtype))


def _ffn_residual(ffn: nn.Sequential, x: torch.Tensor,
                  message: torch.Tensor) -> torch.Tensor:
    """x + ffn([x, message]) in x's dtype. Where kernel L takes the
    products, the first reads x and the message in place of their
    concatenation and the second adds x as it stores."""
    first, norm, act, last = ffn
    return last(act(norm(first((x, message)))), residual=x)


class SelfBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "xla",
                 score_dtype=torch.float32, block_q: int = 0,
                 shard_heads: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.score_dtype = score_dtype
        self.block_q = block_q
        self.shard_heads = shard_heads
        self.Wqkv = Linear(embed_dim, 3 * embed_dim, dtype=dtype)
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.ffn = _ffn(embed_dim, dtype)

    def head_sliced_parameters(self):
        return [self.Wqkv.weight, self.Wqkv.bias, self.out_proj.weight]

    def forward(self, x, encoding, kv_mask=None, training: bool = False):
        B, N, D = x.shape
        h = self.num_heads
        hd = D // h
        split = _head_split(h) if self.shard_heads else None
        if split is None:
            # (B, N, h, hd, 3): q, k, v interleaved at stride 3
            qkv = self.Wqkv(x)
        else:
            group, h, h0 = split
            # this rank's heads: rows h0 * hd * 3 onwards of Wqkv; x and
            # the rotary tables enter the rank's heads, so their gradients
            # (and the positional encoder's) sum over the model group
            qkv = _sliced_linear(self.Wqkv, copy_to_group(x, group),
                                 slice(3 * hd * h0, 3 * hd * (h0 + h)))
            encoding = tuple(copy_to_group(e, group) for e in encoding)
        qkv = qkv.unflatten(-1, (h, hd, 3)).transpose(1, 2)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        kernels = self.attn_impl == "pallas" and _pallas_supported(N, hd)
        if kernels and training:
            # kernels D/F: rotary outside, scale d^-0.5 on the product
            q = apply_rotary(encoding, q)
            k = apply_rotary(encoding, k)
            ctx = fused_attention(q, k, v, kv_mask).to(q.dtype)
        elif kernels:
            # kernel A (or E) reads the strided views in place and rotates
            # q, k
            rot = (encoding[0][:, 0], encoding[1][:, 0])   # (B, N, hd)
            ctx = self_attention(q, k, v, kv_mask, rot=rot,
                                 block_q=self.block_q).to(q.dtype)
        else:
            q = apply_rotary(encoding, q)
            k = apply_rotary(encoding, k)
            if self.attn_impl == "flash" and not training \
                    and _flash_supported(N, hd):
                ctx = _flash(q, k, v, kv_mask, hd ** -0.5).to(q.dtype)
            else:
                ctx = _attention_xla(q, k, v, kv_mask, self.score_dtype)
        message = ctx.transpose(1, 2).reshape(B, N, h * hd)
        if split is None:
            message = self.out_proj(message)
        else:
            message = _merged_out(self.out_proj, message,
                                  slice(hd * h0, hd * (h0 + h)), group)
        return _ffn_residual(self.ffn, x, message)


class CrossBlock(nn.Module):
    """Bidirectional cross attention with a shared QK projection."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype=torch.float32, attn_impl: str = "xla",
                 score_dtype=torch.float32, block_q: int = 0,
                 shard_heads: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.score_dtype = score_dtype
        self.block_q = block_q
        self.shard_heads = shard_heads
        self.to_qk = Linear(embed_dim, embed_dim, dtype=dtype)
        self.to_v = Linear(embed_dim, embed_dim, dtype=dtype)
        self.to_out = Linear(embed_dim, embed_dim, dtype=dtype)
        self.ffn = _ffn(embed_dim, dtype)

    def head_sliced_parameters(self):
        return [self.to_qk.weight, self.to_qk.bias, self.to_v.weight,
                self.to_v.bias, self.to_out.weight]

    def forward(self, x0, x1, mask0=None, mask1=None, training: bool = False):
        B, N, D = x0.shape
        M = x1.shape[1]
        h = self.num_heads
        hd = D // h
        scale = hd ** -0.5
        sharded = _head_split(h) if self.shard_heads else None
        if sharded is None:
            def proj(layer, x):
                return layer(x)
        else:
            group, h, h0 = sharded
            heads = slice(hd * h0, hd * (h0 + h))

            def proj(layer, x):
                return _sliced_linear(layer, copy_to_group(x, group), heads)

        def split(t):
            return t.unflatten(-1, (h, hd)).transpose(1, 2)

        qk0 = split(proj(self.to_qk, x0))
        qk1 = split(proj(self.to_qk, x1))
        qk0 = qk0 * _scalar(scale ** 0.5, qk0)
        qk1 = qk1 * _scalar(scale ** 0.5, qk1)
        v0 = split(proj(self.to_v, x0))
        v1 = split(proj(self.to_v, x1))

        kernels = self.attn_impl == "pallas" \
            and _pallas_supported(N, hd, M) and M % 128 == 0
        if kernels and training:
            # kernels D/F, one call a direction at scale 1 (pre-scaled qk);
            # autograd sums the q-role and k-role gradients of the shared qk
            m0 = fused_attention(qk0, qk1, v1, mask1, 1.0).to(v1.dtype)
            m1 = fused_attention(qk1, qk0, v0, mask0, 1.0).to(v0.dtype)
        elif kernels:
            m0, m1 = cross_attention_bidir(qk0, qk1, v0, v1, mask0, mask1,
                                           block_q=self.block_q)
            m0, m1 = m0.to(v1.dtype), m1.to(v0.dtype)
        elif self.attn_impl == "flash" and not training \
                and _flash_supported(N, hd) and M % 128 == 0:
            # two passes of kernel G (qk pre-scaled on both sides)
            m0 = _flash(qk0, qk1, v1, mask1, 1.0).to(v1.dtype)
            m1 = _flash(qk1, qk0, v0, mask0, 1.0).to(v0.dtype)
        else:
            sim = torch.matmul(qk0.float(), qk1.float().mT).to(
                self.score_dtype)
            if mask0 is not None and mask1 is not None:
                joint = mask0[:, None, :, None] & mask1[:, None, None, :]
                sim = sim.masked_fill(~joint, _MASK_BIAS)
            simf = sim.float()
            attn01 = torch.softmax(simf, dim=-1).to(v1.dtype)
            attn10 = torch.softmax(simf, dim=-2).to(v0.dtype)
            m0 = torch.matmul(attn01.float(), v1.float()).to(v1.dtype)
            m1 = torch.matmul(attn10.float().mT, v0.float()).to(v0.dtype)

        def merge(t, n):
            t = t.transpose(1, 2).reshape(B, n, h * hd)
            if sharded is None:
                return self.to_out(t)
            return _merged_out(self.to_out, t, heads, group)

        m0 = merge(m0, N)
        m1 = merge(m1, M)

        return (_ffn_residual(self.ffn, x0, m0),
                _ffn_residual(self.ffn, x1, m1))


class TransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "xla", score_dtype=torch.float32,
                 block_q: int = 0, shard_heads: bool = False):
        super().__init__()
        self.self_attn = SelfBlock(embed_dim, num_heads, dtype, attn_impl,
                                   score_dtype, block_q, shard_heads)
        self.cross_attn = CrossBlock(embed_dim, num_heads, dtype, attn_impl,
                                     score_dtype, block_q, shard_heads)

    def forward(self, desc0, desc1, enc0, enc1, mask0=None, mask1=None,
                training: bool = False):
        with annotate("ei.match.self"):
            desc0 = self.self_attn(desc0, enc0, mask0, training)
        with annotate("ei.match.self"):
            desc1 = self.self_attn(desc1, enc1, mask1, training)
        with annotate("ei.match.cross"):
            return self.cross_attn(desc0, desc1, mask0, mask1, training)


def sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor,
                               z1: torch.Tensor) -> torch.Tensor:
    """(B, N, M) similarity + matchability logits (B, N|M, 1) ->
    (B, N+1, M+1) log assignment."""
    B, N, M = sim.shape
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    scores0 = F.log_softmax(sim, dim=2)
    scores1 = F.log_softmax(sim, dim=1)
    scores = sim.new_zeros(B, N + 1, M + 1)
    scores[:, :N, :M] = scores0 + scores1 + certainties
    scores[:, :-1, -1] = F.logsigmoid(-z0[..., 0])
    scores[:, -1, :-1] = F.logsigmoid(-z1[..., 0])
    return scores


class MatchAssignment(nn.Module):
    """Shared final projection + matchability head (float32)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.final_proj = Linear(dim, dim)
        self.matchability = Linear(dim, 1)

    def forward(self, desc0, desc1, mask0=None, mask1=None):
        """mask0/mask1 (adaptive inference only): the pruning masks; the
        similarity outside their outer product is -1e9, so both softmaxes
        run over surviving slots only."""
        mdesc0 = self.final_proj(desc0) / self.dim ** 0.25
        mdesc1 = self.final_proj(desc1) / self.dim ** 0.25
        sim = torch.einsum("bmd,bnd->bmn", mdesc0, mdesc1)
        if mask0 is not None and mask1 is not None:
            joint = mask0[:, :, None] & mask1[:, None, :]
            sim = sim.masked_fill(~joint, _MASK_BIAS)
        scores = sigmoid_log_double_softmax(
            sim, self.matchability(desc0), self.matchability(desc1))
        return scores, sim


def filter_matches(scores: torch.Tensor, threshold: float):
    """Mutual-max + threshold match extraction from a log-assignment matrix
    (argmax ties go to the first index, as jnp.argmax)."""
    core = scores[:, :-1, :-1]
    m0 = core.argmax(dim=2)
    m1 = core.argmax(dim=1)
    max0 = core.amax(dim=2)
    indices0 = torch.arange(m0.shape[1], device=core.device)[None]
    indices1 = torch.arange(m1.shape[1], device=core.device)[None]
    mutual0 = indices0 == torch.gather(m1, 1, m0)
    mutual1 = indices1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    m0 = torch.where(valid0, m0, -1).to(torch.int32)
    m1 = torch.where(valid1, m1, -1).to(torch.int32)
    return m0, m1, mscores0, mscores1


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(values, 1, idx.to(torch.int64))


class LightGlue(nn.Module):
    """`training_heads=True` adds what training reads: every layer's
    assignment head (`log_assignment.{i}`) and the token-confidence heads
    (`token_confidence.{i}`, i < L-1), the parameters of the JAX package's
    training init; inference needs only the last layer's head, adaptive
    inference every head (the JAX package's adaptive init) and
    `scan_layers` every assignment head (its scanned init)."""

    def __init__(self, config: LightGlueConfig = LightGlueConfig(),
                 training_heads: bool = False):
        super().__init__()
        cfg = config
        if cfg.attention_impl not in ("auto", "pallas", "xla", "flash"):
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} is not ported yet")
        self.config = cfg
        D = cfg.descriptor_dim
        dtype = getattr(torch, cfg.dtype)
        attn_impl = "pallas" if cfg.attention_impl == "auto" \
            else cfg.attention_impl
        # as the JAX package: scanned layers take no adaptive path
        self.adaptive = (cfg.depth_confidence > 0
                         or cfg.width_confidence > 0) and not cfg.scan_layers
        if cfg.shard_heads:
            # tensor-parallel heads take the einsum path, as in the JAX
            # package; the heads must divide over an active model group
            attn_impl = "xla"
            _head_split(cfg.num_heads)
        if cfg.input_dim != D:
            self.input_proj = Linear(cfg.input_dim, D)
        self.posenc = FourierPositionalEncoding(D // cfg.num_heads)
        self.transformers = nn.ModuleList(
            TransformerLayer(D, cfg.num_heads, dtype, attn_impl,
                             getattr(torch, cfg.score_dtype), cfg.block_q,
                             cfg.shard_heads)
            for _ in range(cfg.n_layers))
        L = cfg.n_layers
        tokens = training_heads or self.adaptive
        heads = range(L) if tokens or cfg.scan_layers else [L - 1]
        self.log_assignment = nn.ModuleDict(
            {str(i): MatchAssignment(D) for i in heads})
        self.token_confidence = nn.ModuleDict(
            {str(i): Linear(D, 1) for i in range(L - 1)} if tokens else {})
        self.training_heads = training_heads
        self.compute_dtype = dtype

    def forward(self, feats0: Dict[str, torch.Tensor],
                feats1: Dict[str, torch.Tensor],
                training: bool = False) -> Dict[str, torch.Tensor]:
        if training and not self.training_heads:
            raise ValueError("LightGlue training needs a model built with "
                             "training_heads=True")
        cfg = self.config
        kpts0 = feats0["sparse_positions"][..., :2]
        kpts1 = feats1["sparse_positions"][..., :2]
        desc0 = feats0["sparse_descriptors"]
        desc1 = feats1["sparse_descriptors"]
        mask0 = feats0.get("sparse_valid")
        mask1 = feats1.get("sparse_valid")

        nk0 = normalize_keypoints(kpts0, feats0["image_size"])
        nk1 = normalize_keypoints(kpts1, feats1["image_size"])
        if cfg.input_dim != cfg.descriptor_dim:
            desc0, desc1 = self.input_proj(desc0), self.input_proj(desc1)

        dt = self.compute_dtype
        desc0, desc1 = desc0.to(dt), desc1.to(dt)
        enc0 = tuple(e.to(dt) for e in self.posenc(nk0))
        enc1 = tuple(e.to(dt) for e in self.posenc(nk1))
        L = cfg.n_layers
        adaptive = self.adaptive and not training
        all_scores, conf0, conf1 = [], [], []
        if adaptive:
            # the masks become the surviving ones; every rank runs every
            # head here, as the JAX package builds its adaptive layers with
            # shard_heads=False
            with use_mesh(None):
                scores, sim, mask0, mask1, exit_layer = \
                    self._adaptive_layers(desc0, desc1, enc0, enc1, mask0,
                                          mask1)
        else:
            for i, layer in enumerate(self.transformers):
                desc0, desc1 = layer(desc0, desc1, enc0, enc1, mask0, mask1,
                                     training)
                if training or i == L - 1:
                    d0f, d1f = desc0.float(), desc1.float()
                    with annotate("ei.match.assign"):
                        scores, sim = self.log_assignment[str(i)](d0f, d1f)
                    all_scores.append(scores)
                if training and i < L - 1:
                    token = self.token_confidence[str(i)]
                    conf0.append(token(d0f.detach())[..., 0])
                    conf1.append(token(d1f.detach())[..., 0])
        with torch.no_grad(), annotate("ei.match.filter"):
            out = self._matches(scores, mask0, mask1)
        out["similarity"] = sim
        out["log_assignment"] = scores
        if adaptive:
            out["exit_layer"] = exit_layer
            out["surviving0"], out["surviving1"] = mask0, mask1
        if training:
            out["all_log_assignments"] = torch.stack(all_scores, dim=1)
            out["confidence_logits0"] = torch.stack(conf0, dim=1)
            out["confidence_logits1"] = torch.stack(conf1, dim=1)
        return out

    @torch.no_grad()
    def _adaptive_layers(self, desc0, desc1, enc0, enc1, mask0, mask1):
        """Early exit and point pruning with static shapes (the JAX
        package's `_adaptive_layers`). Returns (scores, sim, the surviving
        masks, exit layer as an int32 tensor)."""
        cfg = self.config
        L = cfg.n_layers
        do_stop = cfg.depth_confidence > 0
        do_prune = cfg.width_confidence > 0
        B, N = desc0.shape[:2]
        M = desc1.shape[1]
        dev = desc0.device
        # the pruning masks p*, apart from the slots' validity: the head
        # renormalises over pruned slots only (the plain forward feeds
        # padded slots through it unmasked)
        p0 = torch.ones(B, N, dtype=torch.bool, device=dev)
        p1 = torch.ones(B, M, dtype=torch.bool, device=dev)
        a0 = mask0 if mask0 is not None else p0
        a1 = mask1 if mask1 is not None else p1
        scores = sim = None
        exit_layer = L - 1

        def confidence(i, d):
            return torch.sigmoid(self.token_confidence[str(i)](
                d.float())[..., 0])

        def matchable(i, d):
            head = self.log_assignment[str(i)].matchability
            return torch.sigmoid(head(d.float())[..., 0]) \
                > (1 - cfg.width_confidence)

        for i, layer in enumerate(self.transformers):
            desc0, desc1 = layer(desc0, desc1, enc0, enc1, a0, a1)
            last = i == L - 1
            stop = last
            if not last and (do_stop or do_prune):
                conf0, conf1 = confidence(i, desc0), confidence(i, desc1)
                th = float(np.clip(0.8 + 0.1 * np.exp(-4.0 * i / L), 0, 1))
            if not last and do_stop:
                # over valid and surviving tokens of both sides; one host
                # read a layer decides whether the batch goes on
                low = ((conf0 < th) & a0).sum(1) + ((conf1 < th) & a1).sum(1)
                num = (a0.sum(1) + a1.sum(1)).clamp(min=1)
                stop = bool(((1.0 - low / num) > cfg.depth_confidence).all())
                LightGlue.host_syncs += 1
            if stop:
                with annotate("ei.match.assign"):
                    scores, sim = self.log_assignment[str(i)](
                        desc0.float(), desc1.float(),
                        p0 if do_prune else None, p1 if do_prune else None)
                exit_layer = i
                break
            if do_prune:
                # keep: matchable or not yet confident
                keep0, keep1 = matchable(i, desc0), matchable(i, desc1)
                if do_stop:
                    keep0 = keep0 | (conf0 <= th)
                    keep1 = keep1 | (conf1 <= th)
                p0, p1 = p0 & keep0, p1 & keep1
                a0, a1 = a0 & p0, a1 & p1
        return (scores, sim, a0, a1,
                torch.full((), exit_layer, dtype=torch.int32, device=dev))

    def _matches(self, scores, mask0, mask1) -> Dict[str, torch.Tensor]:
        m0, m1, ms0, ms1 = filter_matches(scores, self.config.filter_threshold)
        if mask0 is not None:
            m0 = torch.where(mask0, m0, -1)
            ms0 = torch.where(mask0, ms0, 0.0)
        if mask1 is not None:
            m1 = torch.where(mask1, m1, -1)
            ms1 = torch.where(mask1, ms1, 0.0)
        # a valid query must not match an INVALID key slot (the assignment
        # head sees the padded slots unmasked)
        if mask1 is not None:
            ok0 = _take(mask1, m0.clamp(min=0))
            m0 = torch.where(ok0, m0, -1)
            ms0 = torch.where(ok0, ms0, 0.0)
        if mask0 is not None:
            ok1 = _take(mask0, m1.clamp(min=0))
            m1 = torch.where(ok1, m1, -1)
            ms1 = torch.where(ok1, ms1, 0.0)
        return {
            "matches0": m0,
            "matches1": m1,
            "matching_scores0": ms0,
            "matching_scores1": ms1,
        }


# host reads of the adaptive loop's stop decision (one a layer until the
# batch stops)
LightGlue.host_syncs = 0


def head_sliced_parameters(model: nn.Module):
    """The parameters of `model`'s head-sharded attention blocks that a
    rank reads only in its heads' slice (under a model group, their
    gradients are partial and must be summed over it)."""
    return [p for m in model.modules()
            if isinstance(m, (SelfBlock, CrossBlock)) and m.shard_heads
            for p in m.head_sliced_parameters()]
