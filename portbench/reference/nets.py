"""Plain float32 reference of the EI-Nexus models the benchmark serves and
trains: the voxel grid, the four keypoint extractors ("vgg", "vgg_np",
"superpointv1", "silk") with their keypoint selection, LightGlue with its
assignment head and match filter, the stage-2 supervision (ground truth
from pose and depth, the deep-supervision NLL) and AdamW.

Everything is written out in plain `torch` operations over a state dict
whose keys are the served model's parameter names, so the same seeded
weights load into both. It imports nothing of the program under test and
no kernel: attention is an einsum with a softmax, the NMS a max-pool loop,
the top-k a full stable sort. The semantics are those of the model
configs (`configs/model/*.yaml`): the NMS runs its 4 fixed suppression
rounds, top-k ties go to the lower index, attention masks the keys only.
The caller turns TF32 off (`harness.common.set_tf32`) for the float32
reference and on for the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

MASK_BIAS = -1e9
# How the cross-attention masks: "keys" (each query attends to the other
# side's valid slots: kernel B's rule, which the benchmark's token counts
# take) or "joint" (the port's einsum path off the kernels' token grid,
# such as at the CPU tests' sizes: an invalid query row attends to every
# key). The two differ only on invalid slots, which reach the valid
# entries of the log assignment through its unmasked softmaxes.
CROSS_MASK = "keys"


# --------------------------------------------------------------------------
# events -> voxel grid and occupancy
# --------------------------------------------------------------------------

def voxel_grid(x, y, t, p, valid, bins: int, H: int, W: int) -> torch.Tensor:
    """(B, N) padded events -> the standardised trilinear voxel grid
    (B, H, W, bins): time normalised over each row's valid events, each
    event split over its 8 (t, y, x) corners with value +-1, then every
    row's nonzero voxels standardised (mean 0, unbiased std 1)."""
    B = x.shape[0]
    big = torch.full_like(t, float("inf"))
    t0 = torch.where(valid, t, big).amin(dim=1, keepdim=True)
    t0 = torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))
    span = torch.where(valid, t - t0, torch.zeros_like(t)).amax(
        dim=1, keepdim=True)
    ts = (bins - 1) * ((t - t0) / (span + 1e-8))
    xi, yi, ti = x.long(), y.long(), ts.long()
    val = torch.where(p < 1, -1.0, 1.0)
    size = bins * H * W
    grid = torch.zeros(B * size, dtype=torch.float32, device=x.device)
    base = (torch.arange(B, device=x.device) * size)[:, None]
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = xi + dx, yi + dy, ti + dt
                inb = ((xl >= 0) & (xl < W) & (yl >= 0) & (yl < H)
                       & (tl >= 0) & (tl < bins) & valid)
                w = (val * (1 - (xl.float() - x).abs())
                     * (1 - (yl.float() - y).abs())
                     * (1 - (tl.float() - ts).abs()))
                idx = torch.where(inb, (tl * H + yl) * W + xl, 0) + base
                grid.index_add_(0, idx.reshape(-1),
                                torch.where(inb, w, 0.0).reshape(-1))
    g = grid.reshape(B, -1)
    nz = g != 0
    cnt = nz.sum(1, keepdim=True)
    mean = torch.where(nz, g, 0.0).sum(1, keepdim=True) / cnt.clamp(min=1)
    var = (torch.where(nz, (g - mean) ** 2, 0.0).sum(1, keepdim=True)
           / (cnt - 1).clamp(min=1))
    std = var.sqrt()
    cen = torch.where(nz, g - mean, g)
    out = torch.where(std > 0, cen / torch.where(std > 0, std, 1.0), cen)
    out = torch.where(cnt > 0, out, g)
    return out.reshape(B, bins, H, W).permute(0, 2, 3, 1)


def occupancy(x, y, valid, H: int, W: int) -> torch.Tensor:
    """(B, H, W) bool: pixels that hold at least one valid event."""
    xi, yi = x.long(), y.long()
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & valid
    B = x.shape[0]
    occ = torch.zeros(B, H * W, dtype=torch.bool, device=x.device)
    rows = torch.arange(B, device=x.device)[:, None].expand_as(xi)
    occ[rows[inb], (yi * W + xi)[inb]] = True
    return occ.reshape(B, H, W)


# --------------------------------------------------------------------------
# extractors
# --------------------------------------------------------------------------

def _conv(x, sd, name, padding):
    w = sd[name + ".weight"]
    pad = w.shape[-1] // 2 if padding == "SAME" else 0
    return F.conv2d(x, w, sd[name + ".bias"], padding=pad)


def _bn(x, sd, name):
    return F.batch_norm(x, sd[name + ".running_mean"],
                        sd[name + ".running_var"], sd[name + ".weight"],
                        sd[name + ".bias"], False, 0.0, 1e-5)


def _block(x, sd, name, padding, use_bn=True):
    x = F.relu(_conv(x, sd, name + ".conv", padding))
    return _bn(x, sd, name + ".bn") if use_bn else x


def _vgg(x, sd, pre, stages, pool, padding, use_bn=True):
    for si, widths in enumerate(stages):
        for ci in range(len(widths)):
            x = _block(x, sd, f"{pre}.backbone.l{si + 1}_{ci}", padding,
                       use_bn)
            if pool and ci == len(widths) - 1 and si < len(stages) - 1:
                x = F.max_pool2d(x, 2, 2)
    return x


def _head(x, sd, name, padding, use_bn=True):
    x = _conv(_block(x, sd, name + ".h1", padding, use_bn), sd,
              name + ".h2_conv", "SAME")
    return _bn(x, sd, name + ".h2_bn") if use_bn else x


def _pad_amounts(H, W, cell):
    hp, wp = (-H) % cell, (-W) % cell
    return hp // 2, hp - hp // 2, wp // 2, wp - wp // 2


def _pad_edge(x, H, W, cell):
    """NHWC replicate-edge padding to a multiple of `cell`."""
    top, bot, left, right = _pad_amounts(H, W, cell)
    rows = (torch.arange(H + top + bot, device=x.device) - top).clamp(0, H - 1)
    cols = (torch.arange(W + left + right, device=x.device) - left).clamp(
        0, W - 1)
    return x[:, rows][:, :, cols]


def _window_max(x, r):
    return F.max_pool2d(x[:, None], 2 * r + 1, stride=1, padding=r)[:, 0]


def nms(score, radius: int, rounds: int = 4):
    """`rounds` suppression rounds: a pixel equal to its (2r+1)^2 window
    max (and > 0) is a max; every non-max within r of a max is zeroed."""
    x = score
    for _ in range(rounds):
        is_max = (x == _window_max(x, radius)) & (x > 0)
        near = _window_max(is_max.float(), radius) > 0
        x = torch.where(near & ~is_max, torch.zeros_like(x), x)
    return x


def topk_keypoints(nms_map, k: int, thresh: float):
    """(B, H, W) -> ((B, k, 3) (y+.5, x+.5, score) by descending score,
    ties to the lower flat index; (B, k) valid: score > the cut; (B, 1)
    the cut, min(thresh, the midpoint of the k-th and (k+1)-th scores))."""
    B, H, W = nms_map.shape
    vals, idx = torch.sort(nms_map.reshape(B, H * W), dim=1,
                           descending=True, stable=True)
    if k >= H * W:
        cut = torch.zeros(B, 1, device=vals.device)
        vals = F.pad(vals, (0, k - H * W))
        idx = F.pad(idx, (0, k - H * W))
    else:
        cut = (vals[:, k - 1:k] + vals[:, k:k + 1]) / 2
    vals, idx = vals[:, :k], idx[:, :k]
    cut = cut.clamp(max=thresh)
    valid = vals > cut
    pos = torch.stack([(idx // W).float() + 0.5, (idx % W).float() + 0.5,
                       vals], dim=-1)
    return pos, valid, cut


def _normalize(d, scale):
    return scale * (d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12))


def sample_lowres(raw, pos_padded, padded_size, scale):
    """Bilinear sample of a coarse (B, h, w, D) map at full-resolution
    (y, x) positions on the padded grid, zero outside, then normalised."""
    Hp, Wp = padded_size
    B, h, w, D = raw.shape
    uy = 2.0 * (pos_padded[..., 0] - 0.5) / (Hp - 1) - 1.0
    ux = 2.0 * (pos_padded[..., 1] - 0.5) / (Wp - 1) - 1.0
    ly = (uy + 1.0) / 2.0 * h - 0.5
    lx = (ux + 1.0) / 2.0 * w - 0.5
    y0, x0 = ly.floor().long(), lx.floor().long()
    wy, wx = (ly - y0)[..., None], (lx - x0)[..., None]
    flat = raw.reshape(B, h * w, D)

    def at(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        i = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        v = torch.gather(flat, 1, i[..., None].expand(-1, -1, D))
        return v * inb[..., None]

    top = at(y0, x0) * (1 - wx) + at(y0, x0 + 1) * wx
    bot = at(y0 + 1, x0) * (1 - wx) + at(y0 + 1, x0 + 1) * wx
    return _normalize(top * (1 - wy) + bot * wy, scale)


def sample_fullres(raw, pos, scale):
    """Floor gather of a full-resolution (B, H, W, D) map, clipped."""
    B, H, W, D = raw.shape
    yi = pos[..., 0].floor().long().clamp(0, H - 1)
    xi = pos[..., 1].floor().long().clamp(0, W - 1)
    d = torch.gather(raw.reshape(B, H * W, D), 1,
                     (yi * W + xi)[..., None].expand(-1, -1, D))
    return _normalize(d, scale)


def extractor_spec(section: dict) -> dict:
    """One extractor section of a model config -> what the reference runs."""
    etype = section["type"]
    p = section.get(etype, {})
    cell1 = etype in ("vgg_np", "silk")
    return {
        "type": etype,
        "cell": 1 if cell1 else 8,
        "top_k": p.get("detection_top_k", 1024),
        "thresh": p.get("detection_threshold", 1.0),
        "radius": p.get("nms_radius", 4),
        "border": p.get("remove_borders", 4),
        "scale": 1.41 if etype == "silk" else p.get(
            "descriptor_scale_factor", 1.0),
        "padding": "VALID" if p.get("padding", 1) == 0 else "SAME",
        "feat": p.get("feat_channels", 128),
        "use_bn": p.get("use_batchnorm", True),
        "smooth_mask": etype in ("vgg", "vgg_np"),
        "desc_dim": 128 if etype == "silk" else p.get(
            "descriptor_dim", 128 if etype == "vgg_np" else 256),
    }


_SUPERPOINT = (("conv1a", False), ("conv1b", True), ("conv2a", False),
               ("conv2b", True), ("conv3a", False), ("conv3b", True),
               ("conv4a", False), ("conv4b", False))


def extract(sd: Dict[str, torch.Tensor], pre: str, spec: dict,
            x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> dict:
    """One extractor on an NHWC input ((B, H, W, bins) events or (B, H, W,
    1) a frame in [0, 255]) with an optional (B, H, W) occupancy mask.
    Returns the keypoints (positions (B, K, 3) in image coordinates, valid,
    descriptors) and what the comparison reads: `cut` (B, 1), the score a
    valid keypoint exceeds, `score` (B, H, W), the score map before the
    NMS, and `describe(positions)`, which samples the descriptor map at
    given image positions."""
    if spec["padding"] != "SAME":
        raise NotImplementedError("the reference takes SAME padding")
    t = spec["type"]
    B, H, W = x.shape[:3]
    cell = spec["cell"]
    if t in ("superpointv1", "silk"):
        x = x / 255.0
    if cell == 8:
        top, _, left, _ = _pad_amounts(H, W, 8)
        xp = _pad_edge(x, H, W, 8)
    else:
        top = left = 0
        xp = x
    Hp, Wp = xp.shape[1], xp.shape[2]
    h = xp.permute(0, 3, 1, 2)
    if t == "superpointv1":
        for name, pool in _SUPERPOINT:
            h = F.relu(_conv(h, sd, f"{pre}.{name}", "SAME"))
            if pool:
                h = F.max_pool2d(h, 2, 2)
        logits = _conv(F.relu(_conv(h, sd, f"{pre}.convPa", "SAME")), sd,
                       f"{pre}.convPb", "SAME")
        raw = _conv(F.relu(_conv(h, sd, f"{pre}.convDa", "SAME")), sd,
                    f"{pre}.convDb", "SAME")
    else:
        f = spec["feat"]
        stages = ((64, 64), (64, 64), (128, 128), (f, f))
        h = _vgg(h, sd, pre, stages, cell == 8, "SAME", spec["use_bn"])
        logits = _head(h, sd, f"{pre}.detector_head", "SAME", spec["use_bn"])
        raw = _head(h, sd, f"{pre}.descriptor_head", "SAME", spec["use_bn"])
    logits = logits.permute(0, 2, 3, 1).float()
    raw = raw.permute(0, 2, 3, 1).float()
    if cell == 8:
        prob = torch.softmax(logits, dim=-1)[..., :64]
        hh, ww = prob.shape[1], prob.shape[2]
        score = prob.reshape(B, hh, ww, 8, 8).permute(0, 1, 3, 2, 4).reshape(
            B, hh * 8, ww * 8)
    else:
        score = torch.sigmoid(logits[..., 0])
    if mask is not None:
        m = torch.zeros(B, Hp, Wp, dtype=torch.bool, device=x.device)
        m[:, top:top + H, left:left + W] = mask
        if spec["smooth_mask"]:
            m = _window_max(m.float(), 1) > 0
        score = torch.where(m, score, torch.zeros_like(score))
    b = spec["border"]
    keep = torch.zeros(Hp, Wp, dtype=torch.bool, device=x.device)
    keep[b:Hp - b, b:Wp - b] = True
    score = torch.where(keep, score, torch.zeros_like(score))
    pos, valid, cut = topk_keypoints(nms(score, spec["radius"]),
                                     spec["top_k"], spec["thresh"])
    shift = torch.tensor([float(top), float(left)], device=x.device)

    def describe(positions):
        if cell == 8:
            return sample_lowres(raw, positions[..., :2] + shift, (Hp, Wp),
                                 spec["scale"])
        return sample_fullres(raw, positions, spec["scale"])

    # `describe` takes image coordinates: shift the padded grid's first
    pos = torch.cat([pos[..., :2] - shift, pos[..., 2:]], dim=-1)
    desc = describe(pos[..., :2])
    valid = valid & (pos[..., 0] >= 0) & (pos[..., 0] < H) \
        & (pos[..., 1] >= 0) & (pos[..., 1] < W)
    return {"positions": pos, "valid": valid, "descriptors": desc,
            "cut": cut, "score": score[:, top:top + H, left:left + W],
            "describe": describe}


# --------------------------------------------------------------------------
# LightGlue
# --------------------------------------------------------------------------

def _linear(x, sd, name):
    return F.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _ffn(x, sd, name):
    h = _linear(x, sd, name + ".0")
    h = F.layer_norm(h, (h.shape[-1],), sd[name + ".1.weight"],
                     sd[name + ".1.bias"], 1e-6)
    return _linear(F.gelu(h), sd, name + ".3")


def _rotate_half(t):
    y = t.unflatten(-1, (-1, 2))
    return torch.stack([-y[..., 1], y[..., 0]], dim=-1).flatten(-2)


def _attend(q, k, v, key_mask):
    """softmax(q k^T) v over the valid keys; q carries its scale."""
    s = q @ k.mT
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], MASK_BIAS)
    return torch.softmax(s, dim=-1) @ v


def _self_block(x, enc, mask, sd, name, heads):
    B, N, D = x.shape
    hd = D // heads
    qkv = _linear(x, sd, name + ".Wqkv").unflatten(-1, (heads, hd, 3))
    qkv = qkv.transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    cos, sin = enc
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    ctx = _attend(q * hd ** -0.5, k, v, mask)
    msg = _linear(ctx.transpose(1, 2).reshape(B, N, D), sd,
                  name + ".out_proj")
    return x + _ffn(torch.cat([x, msg], -1), sd, name + ".ffn")


def _cross_block(x0, x1, m0, m1, sd, name, heads):
    B, N, D = x0.shape
    hd = D // heads

    def split(t):
        return t.unflatten(-1, (heads, hd)).transpose(1, 2)

    s = hd ** -0.25
    qk0 = split(_linear(x0, sd, name + ".to_qk")) * s
    qk1 = split(_linear(x1, sd, name + ".to_qk")) * s
    v0 = split(_linear(x0, sd, name + ".to_v"))
    v1 = split(_linear(x1, sd, name + ".to_v"))
    if CROSS_MASK == "keys" or m0 is None:
        c0 = _attend(qk0, qk1, v1, m1)
        c1 = _attend(qk1, qk0, v0, m0)
    else:
        sim = (qk0 @ qk1.mT).masked_fill(
            ~(m0[:, None, :, None] & m1[:, None, None, :]), MASK_BIAS)
        c0 = torch.softmax(sim, -1) @ v1
        c1 = torch.softmax(sim, -2).mT @ v0

    def out(x, c):
        msg = _linear(c.transpose(1, 2).reshape(B, x.shape[1], D), sd,
                      name + ".to_out")
        return x + _ffn(torch.cat([x, msg], -1), sd, name + ".ffn")

    return out(x0, c0), out(x1, c1)


def log_assignment(d0, d1, sd, name):
    """The assignment head: (B, N+1, M+1) log assignment with dustbins."""
    D = d0.shape[-1]
    md0 = _linear(d0, sd, name + ".final_proj") / D ** 0.25
    md1 = _linear(d1, sd, name + ".final_proj") / D ** 0.25
    sim = md0 @ md1.mT
    z0 = _linear(d0, sd, name + ".matchability")
    z1 = _linear(d1, sd, name + ".matchability")
    B, N, M = sim.shape
    core = (F.log_softmax(sim, 2) + F.log_softmax(sim, 1)
            + F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2))
    row = F.logsigmoid(-z0)                          # (B, N, 1)
    col = F.logsigmoid(-z1).transpose(1, 2)          # (B, 1, M)
    top = torch.cat([core, row], dim=2)
    bottom = torch.cat([col, torch.zeros_like(col[..., :1])], dim=2)
    return torch.cat([top, bottom], dim=1)


def lightglue(sd, cfg: dict, kp0, kp1, desc0, desc1, mask0, mask1,
              size0, size1, training: bool = False):
    """LightGlue over the fixed slots ((B, N, 2) (y, x) keypoints, (B, N,
    D_in) descriptors, (B, N) validity, (B, 2) (H, W) image sizes).
    Inference returns the last layer's log assignment; training every
    layer's, stacked (B, L, N+1, M+1), and the token-confidence logits of
    layers 0..L-2 on detached descriptors."""
    pre = "matcher.lightglue"
    heads, L = cfg["num_heads"], cfg["n_layers"]

    def norm(k, size):
        return (k - size[:, None] / 2) / (size.amax(-1, keepdim=True)[:, None]
                                          / 2)

    if cfg["input_dim"] != cfg["descriptor_dim"]:
        desc0 = _linear(desc0, sd, pre + ".input_proj")
        desc1 = _linear(desc1, sd, pre + ".input_proj")

    def posenc(k):
        proj = k @ sd[pre + ".posenc.Wr.weight"].mT
        return (torch.repeat_interleave(proj.cos(), 2, -1)[:, None],
                torch.repeat_interleave(proj.sin(), 2, -1)[:, None])

    enc0, enc1 = posenc(norm(kp0, size0)), posenc(norm(kp1, size1))
    scores, conf0, conf1 = [], [], []
    for i in range(L):
        name = f"{pre}.transformers.{i}"
        desc0 = _self_block(desc0, enc0, mask0, sd, name + ".self_attn",
                            heads)
        desc1 = _self_block(desc1, enc1, mask1, sd, name + ".self_attn",
                            heads)
        desc0, desc1 = _cross_block(desc0, desc1, mask0, mask1, sd,
                                    name + ".cross_attn", heads)
        if training or i == L - 1:
            scores.append(log_assignment(desc0, desc1, sd,
                                         f"{pre}.log_assignment.{i}"))
        if training and i < L - 1:
            tok = f"{pre}.token_confidence.{i}"
            conf0.append(_linear(desc0.detach(), sd, tok)[..., 0])
            conf1.append(_linear(desc1.detach(), sd, tok)[..., 0])
    if not training:
        return scores[-1]
    return (torch.stack(scores, 1), torch.stack(conf0, 1),
            torch.stack(conf1, 1))


def filter_matches(la, mask0, mask1, threshold: float = 0.0):
    """Mutual argmax matches of a log assignment (first index on ties)
    whose probability exceeds `threshold`, restricted to valid slots on
    both sides: (B, N) matches0, -1 none."""
    core = la[:, :-1, :-1]
    m0, m1 = core.argmax(2), core.argmax(1)
    mutual = torch.arange(m0.shape[1], device=la.device)[None] \
        == torch.gather(m1, 1, m0)
    ok = mutual & (core.amax(2).exp() > threshold) & mask0 \
        & torch.gather(mask1, 1, m0)
    return torch.where(ok, m0, -1)


# --------------------------------------------------------------------------
# stage-2 supervision and optimizer
# --------------------------------------------------------------------------

def _sample_depth(pts, depth):
    """Bilinear depth at (B, N, 2) xy pixel positions (centres at +0.5),
    falling back to nearest where the footprint touches depth <= 0."""
    B, H, W = depth.shape
    d = torch.where(depth > 0, depth, torch.full_like(depth, float("nan")))
    flat = d.reshape(B, H * W)

    def at(xx, yy):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = torch.gather(flat, 1, yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1))
        return torch.where(inb, v, torch.zeros_like(v))

    x, y = pts[..., 0] - 0.5, pts[..., 1] - 0.5
    x0, y0 = x.floor().long(), y.floor().long()
    wx, wy = x - x0, y - y0
    lin = ((at(x0, y0) * (1 - wx) + at(x0 + 1, y0) * wx) * (1 - wy)
           + (at(x0, y0 + 1) * (1 - wx) + at(x0 + 1, y0 + 1) * wx) * wy)
    near = at(pts[..., 0].floor().long(), pts[..., 1].floor().long())
    val = torch.where(torch.isnan(lin), near, lin)
    return torch.nan_to_num(val), ~torch.isnan(val) & (val > 0)


def _project(kp, d, K_i, K_j, R, t, size, valid):
    """xy pixels of view i with depths -> xy pixels in view j, visible."""
    fi = torch.stack([K_i[:, 0, 0], K_i[:, 1, 1]], -1)[:, None]
    ci = torch.stack([K_i[:, 0, 2], K_i[:, 1, 2]], -1)[:, None]
    fj = torch.stack([K_j[:, 0, 0], K_j[:, 1, 1]], -1)[:, None]
    cj = torch.stack([K_j[:, 0, 2], K_j[:, 1, 2]], -1)[:, None]
    ray = torch.cat([(kp - ci) / fi, torch.ones_like(kp[..., :1])], -1)
    p3 = (ray * d[..., None]) @ R.mT + t[:, None]
    z = p3[..., 2]
    ok = z > 1e-4
    uv = p3[..., :2] / z.clamp(min=1e-4)[..., None] * fj + cj
    inside = ((uv >= 0) & (uv <= size - 1)).all(-1)
    return uv, valid & ok & inside


def gt_matches(kp0_yx, kp1_yx, K0, K1, depth0, depth1, T01, T10,
               pos_th: float, neg_th: float):
    """Ground-truth labels from pose and depth: (assignment (B, N, M) bool,
    matches0 (B, N), matches1 (B, M)) with -1 unmatched, -2 ignored: a
    mutual nearest pair within pos_th px (the larger of the two
    reprojection errors) is positive; a point whose reprojection lies
    farther than neg_th px from every point of the other view is
    unmatched."""
    H, W = depth0.shape[-2:]
    size = torch.tensor([W, H], dtype=torch.float32, device=kp0_yx.device)
    kp0, kp1 = kp0_yx.flip(-1), kp1_yx.flip(-1)
    d0, v0 = _sample_depth(kp0, depth0)
    d1, v1 = _sample_depth(kp1, depth1)
    p01, vis0 = _project(kp0, d0, K0, K1, T01[:, :3, :3], T01[:, :3, 3],
                         size, v0)
    p10, vis1 = _project(kp1, d1, K1, K0, T10[:, :3, :3], T10[:, :3, 3],
                         size, v1)
    e0 = ((p01[:, :, None] - kp1[:, None]) ** 2).sum(-1)
    e1 = ((kp0[:, :, None] - p10[:, None]) ** 2).sum(-1)
    dist = torch.maximum(e0, e1)
    dist = torch.where(vis0[:, :, None] & vis1[:, None], dist,
                       torch.full_like(dist, float("inf")))
    a0, a1 = dist.argmin(2), dist.argmin(1)
    N, M = dist.shape[1:]
    pos = ((torch.arange(M, device=dist.device) == a0[..., None])
           & (torch.arange(N, device=dist.device)[:, None]
              == a1[:, None, :]) & (dist < pos_th ** 2))
    m0 = torch.where(pos.any(2), a0, -2)
    m1 = torch.where(pos.any(1), a1, -2)
    m0 = torch.where((e0.amin(2) > neg_th ** 2) & v0, -1, m0)
    m1 = torch.where((e1.amin(1) > neg_th ** 2) & v1, -1, m1)
    return pos, m0, m1


def _nll(la, w, balance):
    N, M = la.shape[-2] - 1, la.shape[-1] - 1
    s = la * w
    neg0 = w[:, :N, -1].sum(-1).clamp(min=1)
    neg1 = w[:, -1, :M].sum(-1).clamp(min=1)
    npos = w[:, :N, :M].sum((-1, -2)).clamp(min=1)
    pos = -s[:, :N, :M].sum((-1, -2)) / npos
    neg = (-s[:, :N, -1].sum(-1) - s[:, -1, :M].sum(-1)) / (neg0 + neg1)
    return balance * pos + (1 - balance) * neg


def _bce(logits, target):
    return (logits.clamp(min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def matcher_loss(all_la, conf0, conf1, assignment, m0, m1, gamma: float,
                 balance: float):
    """LightGlue's deep-supervision NLL (layer i weighs gamma^(L-1-i),
    normalised) plus the token-confidence BCE against each layer's argmax
    agreement with the last; the batch mean."""
    B, L = all_la.shape[:2]
    N, M = all_la.shape[2] - 1, all_la.shape[3] - 1
    w = torch.zeros_like(all_la[:, 0])
    w[:, :N, :M] = assignment.float()
    w[:, :N, -1] = (m0 == -1).float()
    w[:, -1, :M] = (m1 == -1).float()
    last = all_la[:, -1]
    total = _nll(last, w, balance)
    wsum = 1.0
    conf = torch.zeros(B, device=all_la.device)
    fin0 = last[:, :-1, :].argmax(-1)
    fin1 = last[:, :, :-1].argmax(-2)
    for i in range(L - 1):
        la = all_la[:, i]
        wi = gamma ** (L - i - 1) if gamma > 0 else float(i + 1)
        total = total + _nll(la, w, balance) * wi
        wsum += wi
        ok0 = (la[:, :-1, :].argmax(-1) == fin0).float()
        ok1 = (la[:, :, :-1].argmax(-2) == fin1).float()
        bce0 = _bce(conf0[:, i], ok0[:, :conf0.shape[2]]).mean(-1)
        bce1 = _bce(conf1[:, i], ok1[:, :conf1.shape[2]]).mean(-1)
        conf = conf + (bce0 + bce1) / 2 / (L - 1)
    return (total / wsum + conf).mean()


def cosine_lr(step: int, base: float, eta_min: float, t_max: int,
              steps_per_epoch: int) -> float:
    """CosineAnnealingLR in closed form over epochs of `steps_per_epoch`."""
    epoch = min(step // max(steps_per_epoch, 1), t_max)
    return eta_min + (base - eta_min) * 0.5 * (1 + math.cos(
        math.pi * epoch / t_max))


class AdamW:
    """AdamW with decoupled weight decay, written out: p <- p (1 - lr wd),
    then the bias-corrected Adam step."""

    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-5):
        self.p = params
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def fit_slots(pos, desc, valid, length: int,
              fill: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Cut or zero-pad the fixed keypoint slots to `length`; with `fill`
    (positions, descriptors for every slot) invalid slots take it and all
    slots become valid."""
    K = pos.shape[1]
    if K >= length:
        pos, desc, valid = pos[:, :length], desc[:, :length], valid[:, :length]
    else:
        pos = F.pad(pos, (0, 0, 0, length - K))
        desc = F.pad(desc, (0, 0, 0, length - K))
        valid = F.pad(valid, (0, length - K))
    if fill is not None:
        pos = torch.where(valid[..., None], pos, fill[0])
        desc = torch.where(valid[..., None], desc, fill[1])
        valid = torch.ones_like(valid)
    return pos, desc, valid
