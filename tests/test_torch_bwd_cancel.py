"""Kernel F's backward where dP - c cancels, on the CPU, against the JAX
package: the port's `fused_attention` gradients (the plain versions of
kernels D and F) against `jax.grad` of `fused_attention_vjp` with the
Pallas kernels interpreted, on the cases of `tests/torch_bwd_cases.py`
(collapsed value rows, one-hot softmax rows), in float32 and bfloat16.

Tolerances, relative norm ||port - jax|| / ||jax|| of each gradient:
1e-4 in float32 (the same float32 products and softmax summed in another
order) and 2e-3 in bfloat16 (both round dS and P^T to bfloat16 before
their products, and a rounding that falls the other way moves one
element by 2^-8). On the collapsed case the rowsum(dO o O) form of c,
with O rounded to bfloat16, departs from these gradients by more than
5 x 1e-2 (the card's bound on F against the plain version): the cases
tell the two forms of c apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ei_nexus_tpu.ops.pallas_attention import fused_attention_vjp
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.torch_bwd_cases import CASES, bwd_case

B, H, N, D = 1, 2, 128, 64
REL = {"float32": 1e-4, "bfloat16": 2e-3}
BWD_REL_BF16 = 1e-2   # F against its plain version on the card, bf16


def _rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_grads(q, k, v, do, mask, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = ak.fused_attention(tq, tk, tv, torch.from_numpy(mask))
    grads = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(),
                                (tq, tk, tv))
    return [g.float().numpy() for g in grads]


def _jax_grads(q, k, v, do, mask, dtype):
    jdt = jnp.dtype(dtype)

    def loss(q, k, v):
        out = fused_attention_vjp(q, k, v, jnp.asarray(mask), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * do)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_fused_attention_grads_match_pallas_vjp(case, dtype):
    q, k, v, do, mask = bwd_case(case, B, H, N, N, D)
    got = _port_grads(q, k, v, do, mask, getattr(torch, dtype))
    want = _jax_grads(q, k, v, do, mask, dtype)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        assert _rel(a, b) <= REL[dtype], (name, _rel(a, b))


def _grads_c_from_out(q, k, v, do, bias, scale):
    """The plain version's (dq, dk, dv) with c = rowsum(dO o O) from the
    output O rounded to q's dtype, FlashAttention-2's form, in place of
    rowsum(dP o P)."""
    s = torch.matmul(q.float(), k.float().mT) * scale + bias[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    dp = torch.matmul(do.float(), v.float().mT)
    c = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - c)).to(q.dtype).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    dk = (torch.matmul(ds.mT, q.float()) * scale).to(k.dtype)
    return dq, dk


def test_c_from_rounded_output_departs_on_collapsed_case():
    q, k, v, do, mask = bwd_case("collapsed", B, H, N, N, D)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    bias = ak.key_bias(torch.from_numpy(mask), B, N, "cpu")
    want = ak.fused_attention_bwd_plain(tq, tk, tv, bias, tdo, D ** -0.5)
    got = _grads_c_from_out(tq, tk, tv, tdo, bias, D ** -0.5)
    for name, a, b in zip(("dq", "dk"), got, want[:2]):
        assert _rel(a.float().numpy(), b.float().numpy()) \
            > 5 * BWD_REL_BF16, name
