"""The port's MNN matcher (`models/mnn.py`), `mnn_loss`, the Matcher's MNN
branch and `ImageImageMatcher` against the JAX package's, on the same
numpy inputs and weights, in float32 on the CPU, at `_flagship(tiny=True)`
sizes.

Tolerances: matches exact. The matcher-level cases use descriptors on a
1/4 grid in 16 dimensions, so every similarity is an exact float32 sum
whatever the summation order and ties are common: both sides must give a
tie to the lower index (jnp.argmax, lax.top_k). Similarity,
log-assignment and loss atol 1e-5 with rtol 1e-5 (log-softmax sums in
another order); the whole-model cases' features as
tests/test_torch_models.py holds them.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.losses.matcher_loss import mnn_loss as jax_mnn_loss
from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.models import mnn as jmnn
from ei_nexus_tpu_torch.losses import mnn_loss
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models import mnn as tmnn
from ei_nexus_tpu_torch.flagship import flagship_config

from test_torch_models import _compare_feats, _load, _perturb, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _grid_feats(rng, B, K, D=16, p_valid=0.8):
    """Descriptors on a 1/4 grid (exact similarities, many ties)."""
    desc = rng.integers(-2, 3, (B, K, D)).astype(np.float32) / 4
    pos = np.concatenate([rng.uniform(0, 32, (B, K, 2)),
                          rng.uniform(0, 1, (B, K, 1))], -1)
    return {"sparse_descriptors": desc,
            "sparse_positions": pos.astype(np.float32),
            "sparse_valid": rng.uniform(size=(B, K)) < p_valid}


@pytest.mark.parametrize("ratio,dist,mutual,masked", [
    (None, None, True, True),
    (None, None, False, True),
    (0.9, None, True, True),
    (None, 1.2, True, True),
    (0.95, 1.5, True, True),
    (0.9, 1.2, False, False),
], ids=["plain", "no-mutual", "ratio", "distance", "both", "unmasked"])
def test_mnn_match_matches_jax(ratio, dist, mutual, masked):
    rng = np.random.default_rng(0)
    f0, f1 = _grid_feats(rng, 3, 32), _grid_feats(rng, 3, 24)
    f1["sparse_descriptors"][:, 5] = f1["sparse_descriptors"][:, 2]  # ties
    if not masked:
        for f in (f0, f1):
            del f["sparse_valid"]
    want = jmnn.mnn_match({k: jnp.asarray(v) for k, v in f0.items()},
                          {k: jnp.asarray(v) for k, v in f1.items()},
                          ratio, dist, mutual_check=mutual)
    got = tmnn.mnn_match({k: _t(v) for k, v in f0.items()},
                         {k: _t(v) for k, v in f1.items()},
                         ratio, dist, mutual_check=mutual)
    assert set(got) == set(want)
    for k in ("matches0", "matches1", "matching_scores0",
              "matching_scores1"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("similarity", "log_assignment"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    assert (got["matches0"] > -1).any()


def test_ties_go_to_the_lower_index():
    sim = torch.tensor([[[0.5, 0.9, 0.9, 0.1], [0.2, 0.2, 0.2, 0.2],
                         [0.0, float("nan"), 1.0, float("nan")]]])
    _, idx = tmnn._first_argmax(sim)
    assert idx.tolist() == [[1, 0, 1]]
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jnp.argmax(jnp.asarray(sim.numpy()), -1)))
    # ratio test on a tie: the second neighbour equals the first
    m = tmnn._find_nn(sim[:, :2], 0.99, None)
    assert m.tolist() == [[-1, -1]]


def test_gather_matched_keypoints_matches_jax():
    rng = np.random.default_rng(1)
    k0 = rng.normal(size=(2, 6, 3)).astype(np.float32)
    k1 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    m0 = rng.integers(-1, 5, (2, 6)).astype(np.int32)
    want = jmnn.gather_matched_keypoints(jnp.asarray(k0), jnp.asarray(k1),
                                         jnp.asarray(m0))
    got = tmnn.gather_matched_keypoints(_t(k0), _t(k1), _t(m0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_mnn_loss_matches_jax(weight):
    rng = np.random.default_rng(2)
    d0 = rng.normal(size=(2, 20, 16))
    d1 = rng.normal(size=(2, 18, 16))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    sim = np.einsum("bnd,bmd->bnm", d0, d1).astype(np.float32)
    sim[0, 0, 0] = 1.0        # the 1e-6 floor under the square root
    assign = rng.uniform(size=sim.shape) < 0.05
    assign[1] = False          # no matchable pair: num clamps to 1
    want_loss, want_info = jax_mnn_loss({"similarity": jnp.asarray(sim)},
                                        {"assignment": jnp.asarray(assign)},
                                        weight)
    loss, info = mnn_loss({"similarity": _t(sim)},
                          {"assignment": _t(assign)}, weight)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert info.keys() == want_info.keys()
    for k in info:
        np.testing.assert_allclose(float(info[k]), float(want_info[k]),
                                   err_msg=k, **TOL)


def _mnn_config(jcfg, ratio=None, dist=None):
    """The tiny flagship's config with the stage-1 matcher (MNN, frozen,
    max_points_num K) in place of LightGlue; `jcfg` from either package."""
    mod = jeim if isinstance(jcfg, jeim.EIMConfig) else teim
    return dataclasses.replace(jcfg, matcher=mod.MatcherConfig(
        type="MNN", freeze=True,
        max_points_num=jcfg.matcher.max_points_num,
        ratio_thresh=ratio, distance_thresh=dist))


@pytest.mark.parametrize("ratio,dist", [(None, None), (0.995, 1.3)],
                         ids=["plain", "thresholds"])
def test_tiny_eim_with_mnn_matches_jax(ratio, dist):
    """The tiny flagship EIM with the MNN matcher (the stage-1 model):
    voxel grid from bursty events, event VGG, SuperPoint, MNN."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu.train.steps import batch_representation as jax_rep
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.train.steps import batch_representation

    jm0, (H, W, bins) = _flagship(tiny=True)
    jm = jeim.EIM(config=_mnn_config(jm0.config, ratio, dist))
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    image = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    rep, mask = jax_rep(ev, "VoxelGrid", bins, H, W, fast=False)
    variables = _perturb(jm.init({"params": jax.random.PRNGKey(0)}, rep,
                                 image, mask))
    je, ji, jmatch = jm.apply(variables, rep, image, mask)

    cfg, _ = flagship_config(tiny=True, dtype="float32")
    tm = _load(teim.EIM(_mnn_config(cfg, ratio, dist)), variables)
    assert not list(tm.matcher.parameters())
    trep, tmask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                       device="cpu")
    with torch.no_grad():
        te, ti, tmatch = tm(trep, _t(image), tmask)
    for got, want in ((te, je), (ti, ji)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors"))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tmatch[k].numpy(),
                                      np.asarray(jmatch[k]), err_msg=k)
    np.testing.assert_allclose(tmatch["similarity"].numpy(),
                               np.asarray(jmatch["similarity"]), atol=1e-4,
                               rtol=1e-4)
    assert (tmatch["matches0"] > -1).any()
    assert set(tmatch["input_feats0"]) == set(jmatch["input_feats0"])


@pytest.mark.parametrize("matcher", ["MNN", "LightGlue"])
def test_tiny_image_image_matcher_matches_jax(matcher, monkeypatch):
    """ImageImageMatcher (one shared SuperPoint for both frames) at the
    tiny flagship's sizes, with either matcher (LightGlue's einsum path on
    both sides), built through `build_model`."""
    from __graft_entry__ import _flagship

    monkeypatch.setenv("EI_NEXUS_ATTN", "xla")
    jm0, (H, W, _) = _flagship(tiny=True)
    jcfg = jm0.config if matcher == "LightGlue" else _mnn_config(jm0.config)
    jm = jeim.build_model("ImageImageMatcher", jcfg)
    rng = np.random.default_rng(4)
    im0 = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    im1 = np.clip(np.roll(im0, 2, axis=2)
                  + rng.normal(0, 5, im0.shape), 0, 255).astype(np.float32)
    variables = _perturb(jm.init({"params": jax.random.PRNGKey(1)}, im0,
                                 im1))
    jf0, jf1, jmatch = jm.apply(variables, im0, im1)

    cfg, _ = flagship_config(tiny=True, dtype="float32")
    if matcher == "LightGlue":
        lg = dataclasses.replace(cfg.matcher.lightglue, attention_impl="xla")
        cfg = dataclasses.replace(
            cfg, matcher=dataclasses.replace(cfg.matcher, lightglue=lg))
    else:
        cfg = _mnn_config(cfg)
    tm = teim.build_model("ImageImageMatcher", cfg, device="cpu")
    assert isinstance(tm, teim.ImageImageMatcher)
    _load(tm, variables)
    with torch.no_grad():
        tf0, tf1, tmatch = tm(_t(im0), _t(im1))
    for got, want in ((tf0, jf0), (tf1, jf1)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors"))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tmatch[k].numpy(),
                                      np.asarray(jmatch[k]), err_msg=k)
    assert (tmatch["matches0"] > -1).any()


def test_build_model_refuses_unknown_names():
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    with pytest.raises(ValueError, match="unknown model type"):
        teim.build_model("nope", cfg, device="cpu")
