"""Kernels E (q-blocked attention) and G (segment-masked flash attention)
and LightGlue under "flash" and under "pallas" with q blocks, against the
JAX package running the very TPU kernels on the CPU.

G's plain version is held to jax's library TPU flash kernel, interpreted;
E's to the repo's q-blocked Pallas kernels with `interpret=True`; the
port's LightGlue to the JAX LightGlue on the same variables, its dispatch
made to ignore the backend (monkeypatch) and its kernels interpreted, so
that the JAX side really runs G or E. Kernels that JAX code calls without
an `interpret` argument are interpreted under
`pltpu.force_tpu_interpret_mode(True)`: every pallas_call traced inside
runs with interpret=True, jax's discharge interpreter, as
tests/test_pallas.py runs the repo's kernels. (The TPU interpret mode,
`InterpretParams`, keeps one simulated shared memory per process and can
deadlock when two interpreted kernels run at once, as the eager LightGlue
forward dispatches them.)

Tolerances: float32 atol 1e-5 (the same products, softmax and block
rescaling, summed in another order); bfloat16 2e-2 * max(1, max|ref|)
(float32 sums in another order can round P or the output to the
neighbouring bfloat16); LightGlue's log-assignment 1e-4 after two layers,
matches exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (SegmentIds,
                                                             flash_attention)

from ei_nexus_tpu.models import lightglue as jlg
from ei_nexus_tpu.ops import pallas_attention as jpa
from ei_nexus_tpu_torch.flagship import flagship_config
from ei_nexus_tpu_torch.models import lightglue as tlg
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from ei_nexus_tpu_torch.ops import flash_kernel as fk
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot_tables(rng, B, N, d):
    ang = rng.uniform(0, 2 * np.pi, (B, N, d // 2)).astype(np.float32)
    return (np.repeat(np.cos(ang), 2, axis=-1),
            np.repeat(np.sin(ang), 2, axis=-1))


# ---------------------------------------------------------------------------
# G: the library's TPU flash kernel
# ---------------------------------------------------------------------------


def _flash_library(q, k, v, q_seg, kv_seg, sm_scale, dtype):
    seg = None if q_seg is None else SegmentIds(jnp.asarray(q_seg),
                                                jnp.asarray(kv_seg))
    with pltpu.force_tpu_interpret_mode(True):
        out = flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                              segment_ids=seg, sm_scale=sm_scale)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,M,sm_scale", [(128, 256, 0.125), (256, 128, 1.0)])
def test_flash_plain_matches_library_kernel(rng, monkeypatch, dtype, N, M,
                                           sm_scale):
    """N != M, random query and key segments, one batch row whose keys are
    all in a segment no query has (fully masked: a uniform average)."""
    B, h, d = 2, 2, 64
    q, k, v = (rng.normal(size=(B, h, n, d)).astype(np.float32)
               for n in (N, M, M))
    q_seg = rng.integers(1, 3, (B, N)).astype(np.int32)
    kv_seg = rng.integers(1, 3, (B, M)).astype(np.int32)
    kv_seg[1] = 3
    want = _flash_library(q, k, v, q_seg, kv_seg, sm_scale, dtype)
    tdt = getattr(torch, dtype)
    args = [_t(a).to(tdt) for a in (q, k, v)] + [_t(q_seg), _t(kv_seg)]
    got = fk.flash_attention_plain(*args, sm_scale=sm_scale)
    assert got.dtype == tdt and np.isfinite(got.float().numpy()).all()
    tol = 1e-5 if dtype == "float32" else 2e-2 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    # the wrapper takes the plain version for CPU tensors
    calls = []
    monkeypatch.setattr(fk, "flash_attention_plain",
                        lambda *a: calls.append(a) or got)
    assert fk.flash_attention(*args, sm_scale=sm_scale) is got
    assert len(calls) == 1 and calls[0][-1] == sm_scale


def test_flash_plain_without_segments_matches_library(rng):
    B, h, N, M, d = 1, 2, 128, 384, 64
    q, k, v = (rng.normal(size=(B, h, n, d)).astype(np.float32)
               for n in (N, M, M))
    want = _flash_library(q, k, v, None, None, 0.125, "float32")
    got = fk.flash_attention_plain(_t(q), _t(k), _t(v), sm_scale=0.125)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_segment_ids_from_mask_follow_lightglue():
    """Queries 1, valid keys 1, invalid keys 2 (lightglue.py:149-154)."""
    mask = torch.tensor([[True, False, True], [False, False, False]])
    q_seg, kv_seg = fk.segment_ids_from_mask(mask, 4)
    assert q_seg.dtype == kv_seg.dtype == torch.int32
    assert q_seg.shape == (2, 4) and (q_seg == 1).all()
    assert kv_seg.tolist() == [[1, 2, 1], [2, 2, 2]]
    assert fk.segment_ids_from_mask(None, 4) == (None, None)


def test_flash_wrapper_refuses_half_segments_and_other_devices():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError):
        fk.flash_attention(q, q, q, torch.ones(1, 8, dtype=torch.int32))
    m = torch.zeros(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError):
        fk.flash_attention(m, m, m)


# ---------------------------------------------------------------------------
# E: the q-blocked Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rot", [True, False])
def test_qblock_self_attention_matches_pallas(rng, rot):
    B, h, N, d = 2, 2, 128, 64
    q, k, v = (rng.normal(size=(B, h, N, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(B, N)) > 0.2
    cos, sin = _rot_tables(rng, B, N, d)
    jrot = (jnp.asarray(cos), jnp.asarray(sin)) if rot else None
    trot = (_t(cos), _t(sin)) if rot else None
    want = jpa.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), interpret=True, block_q=64,
                              rot=jrot)
    got = ak.self_attention(_t(q), _t(k), _t(v), _t(mask), rot=trot,
                            block_q=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # kernel E's own wrapper on the CPU: the same plain arithmetic
    bias = ak.key_bias(_t(mask), B, N, "cpu")
    np.testing.assert_allclose(
        ak.qblock_attention(_t(q), _t(k), _t(v), bias, d ** -0.5, 64,
                            trot).numpy(), np.asarray(want), atol=1e-5)


def test_qblock_cross_attention_matches_pallas(rng):
    """The q-blocked cross path: two single-direction calls at scale 1."""
    B, h, N, M, d = 2, 2, 128, 256, 64
    s = d ** -0.25
    qk0 = (rng.normal(size=(B, h, N, d)) * s).astype(np.float32)
    qk1 = (rng.normal(size=(B, h, M, d)) * s).astype(np.float32)
    v0 = rng.normal(size=(B, h, N, d)).astype(np.float32)
    v1 = rng.normal(size=(B, h, M, d)).astype(np.float32)
    m0 = rng.uniform(size=(B, N)) > 0.2
    m1 = rng.uniform(size=(B, M)) > 0.2
    w0, w1 = jpa.cross_attention_bidir(*(jnp.asarray(a) for a in
                                         (qk0, qk1, v0, v1, m0, m1)),
                                       interpret=True, block_q=64)
    g0, g1 = ak.cross_attention_bidir(*(_t(a) for a in
                                        (qk0, qk1, v0, v1, m0, m1)),
                                      block_q=64)
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), atol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), atol=1e-5)


# ---------------------------------------------------------------------------
# LightGlue under "flash" and under "pallas" with q blocks
# ---------------------------------------------------------------------------

LG = dict(input_dim=128, descriptor_dim=128, n_layers=2, num_heads=2)


def _lightglue_inputs(rng, B=2, N=128, D=128, H=32, W=48):
    def feats():
        pos = np.concatenate([rng.uniform(0, H, (B, N, 1)),
                              rng.uniform(0, W, (B, N, 1)),
                              rng.uniform(0, 1, (B, N, 1))], -1)
        desc = rng.normal(size=(B, N, D))
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        valid = np.zeros((B, N), bool)
        for b, n in enumerate(rng.integers(N // 2, N, B)):
            valid[b, :n] = True          # ragged: valid slots first
        return {"sparse_positions": pos.astype(np.float32),
                "sparse_descriptors": desc.astype(np.float32),
                "sparse_valid": valid,
                "image_size": np.tile(np.float32([H, W]), (B, 1))}
    return feats(), feats()


def _compare_lightglue(rng, jcfg, tcfg):
    f0, f1 = _lightglue_inputs(rng)
    jf0 = {k: jnp.asarray(v) for k, v in f0.items()}
    jf1 = {k: jnp.asarray(v) for k, v in f1.items()}
    init_cfg = jlg.LightGlueConfig(**LG, attention_impl="xla")
    variables = jlg.LightGlue(config=init_cfg).init(jax.random.PRNGKey(5),
                                                    jf0, jf1)
    with pltpu.force_tpu_interpret_mode(True):
        want = jlg.LightGlue(config=jcfg).apply(variables, jf0, jf1)
    tm = tlg.LightGlue(tcfg)
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tm.eval()({k: _t(v) for k, v in f0.items()},
                        {k: _t(v) for k, v in f1.items()})
    np.testing.assert_allclose(got["log_assignment"].numpy(),
                               np.asarray(want["log_assignment"]),
                               atol=1e-4)
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    return got


def test_lightglue_flash_matches_jax_flash_kernel(rng, monkeypatch):
    monkeypatch.setattr(jlg, "_flash_supported",
                        lambda n, d: n % 128 == 0 and n >= 128 and d % 8 == 0)
    calls = []
    real = fk.flash_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(tlg, "flash_attention", counted)
    _compare_lightglue(
        rng, jlg.LightGlueConfig(**LG, attention_impl="flash"),
        tlg.LightGlueConfig(**LG, attention_impl="flash"))
    # every attention of both layers went through G: 2 self + 2 cross each
    assert len(calls) == 4 * LG["n_layers"]


@pytest.fixture
def qblock_jax(monkeypatch):
    """The JAX package's q-blocked kernels at block_q 64, its jitted
    wrappers retraced around the test (the global is read at trace time)."""
    monkeypatch.setattr(jlg, "_pallas_supported",
                        lambda n, d, m=None: (n % 128 == 0 and d % 64 == 0
                                              and n * (m or n) <= 1024 ** 2))
    monkeypatch.setattr(jpa, "_QBLOCK", 64)
    for fn in (jpa.self_attention, jpa.cross_attention_bidir):
        fn.clear_cache()
    yield
    for fn in (jpa.self_attention, jpa.cross_attention_bidir):
        fn.clear_cache()


def test_lightglue_qblock_matches_jax_qblock_kernels(rng, qblock_jax,
                                                     monkeypatch):
    seen = []

    def recording(fn):
        def call(*args, **kw):
            seen.append((fn.__name__, kw.get("block_q")))
            return fn(*args, **kw)
        return call
    for name in ("self_attention", "cross_attention_bidir"):
        monkeypatch.setattr(tlg, name, recording(getattr(ak, name)))
    _compare_lightglue(
        rng, jlg.LightGlueConfig(**LG, attention_impl="pallas"),
        tlg.LightGlueConfig(**LG, attention_impl="pallas", block_q=64))
    # every attention asked the kernel wrappers for q blocks of 64
    assert sorted(set(seen)) == [("cross_attention_bidir", 64),
                                 ("self_attention", 64)]
    assert len(seen) == 3 * LG["n_layers"]


def test_flagship_config_passes_attention_settings():
    cfg, _ = flagship_config(tiny=True, dtype="float32",
                             attention_impl="flash", block_q=64)
    lg = cfg.matcher.lightglue
    assert (lg.attention_impl, lg.block_q) == ("flash", 64)
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    assert (cfg.matcher.lightglue.attention_impl,
            cfg.matcher.lightglue.block_q) == ("auto", 0)


def test_lightglue_flash_training_takes_the_einsum_path(rng, monkeypatch):
    """Training under "flash" runs the einsum path (the JAX package's
    training takes XLA for "flash"), never kernel G."""
    monkeypatch.setattr(tlg, "flash_attention", None)   # G must not run
    cfg = tlg.LightGlueConfig(**LG, attention_impl="flash")
    f0, f1 = _lightglue_inputs(rng)
    tm = tlg.LightGlue(cfg, training_heads=True)
    out = tm({k: _t(v) for k, v in f0.items()},
             {k: _t(v) for k, v in f1.items()}, training=True)
    assert torch.isfinite(out["all_log_assignments"]).all()
