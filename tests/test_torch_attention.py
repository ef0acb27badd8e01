"""Plain versions of the port's attention kernels (A: self-attention with
fused rotary, B: bidirectional cross-attention) against the JAX package's
Pallas kernels in interpret mode and its XLA attention, on the CPU.

Shapes follow tests/test_pallas.py. Tolerance atol 1e-5: both sides do the
same float32 products and softmax, in another summation order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.models import lightglue as jlg
from ei_nexus_tpu.ops.pallas_attention import (cross_attention_bidir,
                                               self_attention)
from ei_nexus_tpu_torch.models import lightglue as tlg
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot_tables(rng, B, N, d):
    ang = rng.uniform(0, 2 * np.pi, (B, N, d // 2)).astype(np.float32)
    return (np.repeat(np.cos(ang), 2, axis=-1),
            np.repeat(np.sin(ang), 2, axis=-1))


@pytest.mark.parametrize("B,h,N,masked", [(2, 3, 128, True),
                                          (1, 2, 128, False),
                                          (2, 2, 256, True)])
def test_self_attention_plain_matches_pallas(rng, B, h, N, masked):
    d = 64
    q, k, v = (rng.normal(size=(B, h, N, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(B, N)) > 0.2 if masked else None
    cos, sin = _rot_tables(rng, B, N, d)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)
    want = self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jmask, interpret=True, block_q=0,
                          rot=(jnp.asarray(cos), jnp.asarray(sin)))
    got = ak.self_attention_plain(_t(q), _t(k), _t(v), tmask,
                                  rot=(_t(cos), _t(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        ak.self_attention(_t(q), _t(k), _t(v), tmask,
                          rot=(_t(cos), _t(sin))).numpy(), got.numpy())
    # and without rotary, against the rotary-free Pallas kernel
    want = self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jmask, interpret=True, block_q=0)
    got = ak.self_attention_plain(_t(q), _t(k), _t(v), tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_self_attention_plain_matches_xla(rng):
    """Kernel A == apply_rotary outside + the XLA attention (JAX's and the
    port's `_attention_xla`), every row: self-attention masks keys only."""
    B, h, N, d = 2, 2, 128, 64
    q, k, v = (rng.normal(size=(B, h, N, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(B, N)) > 0.2
    cos, sin = _rot_tables(rng, B, N, d)
    enc = (jnp.asarray(cos)[:, None], jnp.asarray(sin)[:, None])
    want = jlg._attention_xla(jlg.apply_rotary(enc, jnp.asarray(q)),
                              jlg.apply_rotary(enc, jnp.asarray(k)),
                              jnp.asarray(v), jnp.asarray(mask))
    got = ak.self_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                  rot=(_t(cos), _t(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    tenc = (_t(cos)[:, None], _t(sin)[:, None])
    port_xla = tlg._attention_xla(tlg.apply_rotary(tenc, _t(q)),
                                  tlg.apply_rotary(tenc, _t(k)), _t(v),
                                  _t(mask))
    np.testing.assert_allclose(port_xla.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("B,h,N,M", [(2, 2, 128, 256), (1, 3, 128, 128)])
def test_cross_bidir_plain_matches_pallas_all_rows(rng, B, h, N, M):
    """Kernel B's plain version == the Pallas kernel on ALL rows (both use
    key-side masks only)."""
    d = 64
    s = d ** -0.25
    qk0 = (rng.normal(size=(B, h, N, d)) * s).astype(np.float32)
    qk1 = (rng.normal(size=(B, h, M, d)) * s).astype(np.float32)
    v0 = rng.normal(size=(B, h, N, d)).astype(np.float32)
    v1 = rng.normal(size=(B, h, M, d)).astype(np.float32)
    m0 = rng.uniform(size=(B, N)) > 0.2
    m1 = rng.uniform(size=(B, M)) > 0.2
    w0, w1 = cross_attention_bidir(*(jnp.asarray(a) for a in
                                     (qk0, qk1, v0, v1, m0, m1)),
                                   interpret=True, block_q=0)
    g0, g1 = ak.cross_attention_bidir_plain(*(_t(a) for a in
                                              (qk0, qk1, v0, v1, m0, m1)))
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), atol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), atol=1e-5)
    c0, c1 = ak.cross_attention_bidir(*(_t(a) for a in
                                        (qk0, qk1, v0, v1, m0, m1)))
    np.testing.assert_array_equal(c0.numpy(), g0.numpy())
    np.testing.assert_array_equal(c1.numpy(), g1.numpy())


def test_cross_bidir_plain_matches_einsum_on_valid_rows(rng):
    """Kernel B == the CrossBlock einsum path (joint mask) on valid query
    rows; invalid rows differ by design and are masked downstream."""
    B, h, N, M, d = 2, 2, 128, 256, 64
    qk0 = rng.normal(size=(B, h, N, d)).astype(np.float32)
    qk1 = rng.normal(size=(B, h, M, d)).astype(np.float32)
    v0 = rng.normal(size=(B, h, N, d)).astype(np.float32)
    v1 = rng.normal(size=(B, h, M, d)).astype(np.float32)
    m0 = rng.uniform(size=(B, N)) > 0.2
    m1 = rng.uniform(size=(B, M)) > 0.2
    sim = jnp.einsum("bhid,bhjd->bhij", qk0, qk1)
    joint = m0[:, None, :, None] & m1[:, None, None, :]
    sim = jnp.where(joint, sim, -1e9)
    w0 = jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(sim, -1), v1)
    w1 = jnp.einsum("bhij,bhid->bhjd", jax.nn.softmax(sim, -2), v0)
    g0, g1 = ak.cross_attention_bidir_plain(*(_t(a) for a in
                                              (qk0, qk1, v0, v1, m0, m1)))
    sel0, sel1 = m0[:, None, :, None], m1[:, None, :, None]
    np.testing.assert_allclose(np.where(sel0, g0.numpy(), 0),
                               np.where(sel0, np.asarray(w0), 0), atol=1e-5)
    np.testing.assert_allclose(np.where(sel1, g1.numpy(), 0),
                               np.where(sel1, np.asarray(w1), 0), atol=1e-5)


def test_rotate_half_pairs_adjacent_lanes():
    x = torch.arange(8.0).reshape(1, 8)
    np.testing.assert_array_equal(
        ak.rotate_half(x).numpy(),
        np.asarray(jlg.rotate_half(jnp.arange(8.0).reshape(1, 8))))


def test_cuda_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never run
    on the plain path."""
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError):
        ak.self_attention(q, q, q)
    with pytest.raises(ValueError):
        ak.cross_attention_bidir(q, q, q, q)
