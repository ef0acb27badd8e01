"""The port's models against the JAX package's, on the same weights (flax
variables carried across with `load_jax_variables`) and the same numpy
inputs, in float32 on the CPU.

Every module is initialised in JAX, its normalisation statistics and biases
perturbed (flax initialises them to identities) so that the weight mapping
is exercised, then loaded into the port with `strict=True`.

Tolerances: keypoint positions, validity and matches exact (the same maps
and the same tie-breaking); features, descriptors and scores atol 1e-4 with
rtol 1e-4, float32 convolutions and matmuls summing in another order
through several layers (observed differences are ~1e-6).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.models import extractor as jext
from ei_nexus_tpu.models import lightglue as jlg
from ei_nexus_tpu.models.superpoint import SuperPointV1 as JSuperPoint
from ei_nexus_tpu_torch.models import extractor as text
from ei_nexus_tpu_torch.models import lightglue as tlg
from ei_nexus_tpu_torch.models.eim import EIM
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.models.superpoint import SuperPointV1
from ei_nexus_tpu_torch.flagship import flagship_config

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(variables, seed=0):
    """Random biases, norm scales and BN statistics (numpy, seeded)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "mean"):
                out[k] = jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
            elif k in ("scale", "var"):
                out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
            else:
                out[k] = v
        return out
    return {col: walk(jax.tree_util.tree_map(lambda x: x, tree))
            for col, tree in variables.items()}


def _load(module, variables):
    module.load_state_dict(load_jax_variables(variables), strict=True)
    return module.eval()


def _compare_feats(got, want, keys=None):
    for k in keys or want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        if k == "sparse_positions":   # (y, x) exact, the score close
            np.testing.assert_array_equal(a[..., :2], b[..., :2], err_msg=k)
            np.testing.assert_allclose(a[..., 2], b[..., 2], err_msg=k, **TOL)
        elif a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)


def test_vgg_extractor_matches_jax(rng):
    B, H, W, bins = 2, 32, 48, 4
    x = rng.normal(size=(B, H, W, bins)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.4
    kcfg = jext.KeypointExtractorConfig(detection_top_k=32)
    jm = jext.VGGExtractor(config=kcfg, feat_channels=16, descriptor_dim=32,
                           lat_channels=32)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(mask)))
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    tm = _load(text.VGGExtractor(
        text.KeypointExtractorConfig(detection_top_k=32), in_channels=bins,
        feat_channels=16, descriptor_dim=32, lat_channels=32), variables)
    with torch.no_grad():
        got = tm(_t(x), _t(mask), dense=True)
    assert set(got) == set(want)
    _compare_feats(got, want)


def test_superpoint_matches_jax(rng):
    B, H, W = 2, 30, 45
    image = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    kcfg = jext.KeypointExtractorConfig(detection_top_k=24)
    jm = JSuperPoint(config=kcfg, descriptor_dim=32)
    variables = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(image)))
    want = jm.apply(variables, jnp.asarray(image))
    tm = _load(SuperPointV1(text.KeypointExtractorConfig(detection_top_k=24),
                            descriptor_dim=32), variables)
    with torch.no_grad():
        got = tm(_t(image))     # the inference path: no dense maps
    assert set(want) - set(got) == {"normalized_descriptors",
                                    "dense_descriptors", "dense_positions"}
    _compare_feats(got, want, keys=got.keys())


def _tokens(rng, B=2, N=24, D=64, hd=16):
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) > 0.3
    ang = rng.uniform(0, 2 * np.pi, (B, 1, N, hd // 2)).astype(np.float32)
    enc = (np.repeat(np.cos(ang), 2, -1), np.repeat(np.sin(ang), 2, -1))
    return x, mask, enc


# (impl, embed width, heads, N, M): 4 heads of 16 at 24/20 tokens (off the
# kernels' grid: both impls take the einsum path), and 2 heads of 64 at 128
# tokens, where "pallas" takes the kernels (their plain versions here)
BLOCK_CASES = pytest.mark.parametrize(
    "impl,D,heads,N,M", [("xla", 64, 4, 24, 20), ("pallas", 64, 4, 24, 20),
                         ("pallas", 128, 2, 128, 128)],
    ids=["xla", "pallas", "pallas-heads64"])


@BLOCK_CASES
def test_self_block_matches_jax(rng, impl, D, heads, N, M):
    """SelfBlock: the port's einsum path and its kernel path (the plain
    version on the CPU) against JAX's einsum path on every row, since
    self-attention masks keys only."""
    x, mask, enc = _tokens(rng, N=N, D=D, hd=D // heads)
    jm = jlg.SelfBlock(D, heads)
    jenc = tuple(jnp.asarray(e) for e in enc)
    variables = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                 jenc, jnp.asarray(mask)))
    want = jm.apply(variables, jnp.asarray(x), jenc, jnp.asarray(mask))
    tm = _load(tlg.SelfBlock(D, heads, attn_impl=impl), variables)
    with torch.no_grad():
        got = tm(_t(x), tuple(_t(e) for e in enc), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@BLOCK_CASES
def test_cross_block_matches_jax(rng, impl, D, heads, N, M):
    """CrossBlock: the einsum path on every row; the kernel path (key-side
    masks, on the kernels' grid) on valid rows, where the two masking
    rules agree."""
    x0, m0, _ = _tokens(rng, N=N, D=D)
    x1, m1, _ = _tokens(rng, N=M, D=D)
    jm = jlg.CrossBlock(D, heads)
    args = tuple(jnp.asarray(a) for a in (x0, x1, m0, m1))
    variables = _perturb(jm.init(jax.random.PRNGKey(3), *args))
    w0, w1 = jm.apply(variables, *args)
    tm = _load(tlg.CrossBlock(D, heads, attn_impl=impl), variables)
    with torch.no_grad():
        g0, g1 = tm(*(_t(a) for a in (x0, x1, m0, m1)))
    kernels = impl == "pallas" and tlg._pallas_supported(N, D // heads, M)
    rows0 = m0[..., None] if kernels else True
    rows1 = m1[..., None] if kernels else True
    np.testing.assert_allclose(np.where(rows0, g0.numpy(), 0),
                               np.where(rows0, np.asarray(w0), 0), **TOL)
    np.testing.assert_allclose(np.where(rows1, g1.numpy(), 0),
                               np.where(rows1, np.asarray(w1), 0), **TOL)


def _feats(rng, B, N, D, H=32, W=48):
    pos = np.concatenate([rng.uniform(0, H, (B, N, 1)),
                          rng.uniform(0, W, (B, N, 1)),
                          rng.uniform(0, 1, (B, N, 1))], -1)
    desc = rng.normal(size=(B, N, D))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return {"sparse_positions": pos.astype(np.float32),
            "sparse_descriptors": desc.astype(np.float32),
            "sparse_valid": rng.uniform(size=(B, N)) > 0.2,
            "image_size": np.tile(np.float32([H, W]), (B, 1))}


def test_lightglue_matches_jax(rng):
    cfg = dict(input_dim=32, descriptor_dim=64, n_layers=2, num_heads=4,
               attention_impl="xla")
    f0, f1 = _feats(rng, 2, 24, 32), _feats(rng, 2, 20, 32)
    jf0 = {k: jnp.asarray(v) for k, v in f0.items()}
    jf1 = {k: jnp.asarray(v) for k, v in f1.items()}
    jm = jlg.LightGlue(config=jlg.LightGlueConfig(**cfg))
    variables = _perturb(jm.init(jax.random.PRNGKey(4), jf0, jf1))
    want = jm.apply(variables, jf0, jf1)
    tm = _load(tlg.LightGlue(tlg.LightGlueConfig(**cfg)), variables)
    with torch.no_grad():
        got = tm({k: _t(v) for k, v in f0.items()},
                 {k: _t(v) for k, v in f1.items()})
    assert set(got) == set(want)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("matching_scores0", "matching_scores1", "similarity",
              "log_assignment"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_tiny_flagship_eim_matches_jax(monkeypatch):
    """The whole tiny flagship (voxel grid from bursty events, event VGG,
    SuperPoint, LightGlue) with attention_impl="xla" on both sides."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu.train.steps import batch_representation as jax_rep
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation

    monkeypatch.setenv("EI_NEXUS_ATTN", "xla")
    jm, (H, W, bins) = _flagship(tiny=True)
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    image = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    rep, mask = jax_rep(ev, "VoxelGrid", bins, H, W, fast=False)
    variables = _perturb(jm.init({"params": jax.random.PRNGKey(0)}, rep,
                                 image, mask))
    je, ji, jmatch = jm.apply(variables, rep, image, mask)

    cfg, shape = flagship_config(tiny=True, dtype="float32")
    assert shape == (H, W, bins)
    lg = dataclasses.replace(cfg.matcher.lightglue, attention_impl="xla")
    cfg = dataclasses.replace(
        cfg, matcher=dataclasses.replace(cfg.matcher, lightglue=lg))
    tm = _load(EIM(cfg), variables)
    trep, tmask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                       device="cpu")
    with torch.no_grad():
        te, ti, tmatch = tm(trep, _t(image), tmask)
    for got, want in ((te, je), (ti, ji)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors", "score"))
    np.testing.assert_array_equal(tmatch["matches0"].numpy(),
                                  np.asarray(jmatch["matches0"]))
    np.testing.assert_allclose(tmatch["matching_scores0"].numpy(),
                               np.asarray(jmatch["matching_scores0"]), **TOL)
    assert (tmatch["matches0"] > -1).any()
