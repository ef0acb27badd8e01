"""LightGlue's "auto"/"pallas" dispatch mirrors the JAX package's shape
guard (`_pallas_supported` in `ei_nexus_tpu/models/lightglue.py`): the
kernels A, B, D, E and F only at token counts that are multiples of 128,
heads of 64 and at most 1024^2 scores a head (the cross-attention also
M % 128 == 0); elsewhere the einsum path, whose cross-attention masks with
the joint mask.

Off that grid the port's "pallas" CrossBlock equals the JAX package's on
every row, invalid query rows included, and no kernel wrapper is called;
on it the wrappers are called. Same variables and numpy inputs on both
sides, float32 on the CPU; tolerance atol 1e-4 with rtol 1e-4 (float32
products summed in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.models import lightglue as jlg
from ei_nexus_tpu_torch.models import lightglue as tlg
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(rng, B, N, D):
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.3
    return x, mask


def _encoding(rng, B, N, hd):
    ang = rng.uniform(0, 2 * np.pi, (B, 1, N, hd // 2)).astype(np.float32)
    return np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1)


# (embed width, heads, N, M): heads of 16 at 24/20 tokens, heads of 64 at
# 120/136 tokens (neither a multiple of 128)
OFF_GRID = [(64, 4, 24, 20), (128, 2, 120, 136)]


@pytest.mark.parametrize("D,heads,N,M", OFF_GRID)
def test_off_grid_cross_block_matches_jax_on_every_row(rng, D, heads, N, M):
    x0, m0 = _tokens(rng, 2, N, D)
    x1, m1 = _tokens(rng, 2, M, D)
    jm = jlg.CrossBlock(D, heads, attn_impl="pallas")
    args = tuple(jnp.asarray(a) for a in (x0, x1, m0, m1))
    variables = jm.init(jax.random.PRNGKey(0), *args)
    w0, w1 = jm.apply(variables, *args)
    tm = tlg.CrossBlock(D, heads, attn_impl="pallas")
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    with torch.no_grad():
        g0, g1 = tm(*(_t(a) for a in (x0, x1, m0, m1)))
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), **TOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), **TOL)


def _spy(monkeypatch):
    """Record every call of the kernel wrappers the blocks reach."""
    seen = []

    def recording(name):
        real = getattr(tlg, name)

        def call(*args, **kw):
            seen.append(name)
            return real(*args, **kw)
        return call
    for name in ("self_attention", "cross_attention_bidir",
                 "fused_attention"):
        monkeypatch.setattr(tlg, name, recording(name))
    return seen


def _run_blocks(rng, D, heads, N, M, training):
    """One SelfBlock and one CrossBlock under "pallas" on random tokens;
    in training, a backward through both."""
    x0, m0 = _tokens(rng, 2, N, D)
    x1, m1 = _tokens(rng, 2, M, D)
    enc = tuple(_t(e) for e in _encoding(rng, 2, N, D // heads))
    sb = tlg.SelfBlock(D, heads, attn_impl="pallas")
    cb = tlg.CrossBlock(D, heads, attn_impl="pallas")
    with torch.set_grad_enabled(training):
        y = sb(_t(x0), enc, _t(m0), training=training)
        y0, y1 = cb(_t(x0), _t(x1), _t(m0), _t(m1), training=training)
        if training:
            (y.sum() + y0.sum() + y1.sum()).backward()
    for t in (y, y0, y1):
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("D,heads,N,M", OFF_GRID)
def test_off_grid_blocks_call_no_kernel(rng, monkeypatch, D, heads, N, M,
                                        training):
    seen = _spy(monkeypatch)
    _run_blocks(rng, D, heads, N, M, training)
    assert seen == []


@pytest.mark.parametrize("training,want", [
    (False, ["self_attention", "cross_attention_bidir"]),
    (True, ["fused_attention"] * 3)])
def test_on_grid_blocks_call_the_kernels(rng, monkeypatch, training, want):
    """128 and 256 tokens with heads of 64: A and B at inference, D/F in
    training (one self-attention call, two cross directions)."""
    seen = _spy(monkeypatch)
    _run_blocks(rng, 128, 2, 128, 256, training)
    assert seen == want


@pytest.mark.parametrize("n,d,m,want", [
    (1024, 64, None, True), (128, 64, 256, True), (1024, 64, 1024, True),
    (2048, 64, None, False), (1024, 64, 2048, False), (120, 64, None, False),
    (128, 32, None, False), (128, 16, 128, False)])
def test_guard_is_the_jax_guard_without_its_backend_term(n, d, m, want):
    assert tlg._pallas_supported(n, d, m) is want
