"""The EIM and ImageImageMatcher of every SiLK model config against the JAX
package, on the CPU, in float32, at the tiny sizes of
`flagship.silk_config`, built through `build_model` (split from
tests/test_torch_silk.py, whose helpers and tolerances they share, so that
two workers run the two files side by side).

Every model is initialised in JAX, its normalisation statistics and
biases perturbed, then loaded into the port with `strict=True`.
Tolerances: keypoint positions, validity and matches exact (the same maps
and the same tie-breaking); every map atol 1e-4 with rtol 1e-4 (float32
convolutions summing in another order through ten layers at full
resolution; observed differences ~1e-6).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.models.config_adapter import (
    eim_config_from_dict as jax_config_from_dict)
from ei_nexus_tpu_torch.flagship import (SILK_CONFIGS, silk_config,
                                         silk_model_dict)
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables

from tests.test_torch_silk import TOL, _compare_feats, _perturb, _t
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _jax_model(name, model_dict):
    jcfg = jax_config_from_dict(model_dict)
    return jeim.build_model(SILK_CONFIGS[name][1], jcfg), jcfg


def _silk_inputs(H, W, B=2, seed=0):
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    rng = np.random.default_rng(seed)
    ev = bursty_event_batch(rng, B, 3000, 4096, H, W)
    image = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    return ev, image


@pytest.mark.parametrize("name,padding", [
    ("EI_SiLK_LG", 1), ("EI_SiLK_MNN", 1), ("SiLK_MNN", 1),
    ("EIM_stage2_SiLK_LG", 1), ("EI_SiLK_MNN", 0)])
def test_tiny_silk_eim_matches_jax(name, padding, monkeypatch):
    """The EIM of each SiLK model config at its tiny sizes (voxel grid
    from bursty events, vgg_np, SiLK, LightGlue on the einsum path or
    MNN), built through `build_model`; at padding 0 both extractors run
    VALID and the event mask stays out (VALID takes none)."""
    from ei_nexus_tpu.train.steps import batch_representation as jax_rep
    from ei_nexus_tpu_torch.train.steps import batch_representation

    monkeypatch.setenv("EI_NEXUS_ATTN", "xla")
    model_dict, (H, W, bins) = silk_model_dict(True, "float32", name)
    for side in ("event_extractor", "image_extractor"):
        model_dict[side][model_dict[side]["type"]]["padding"] = padding
    jm, _ = _jax_model(name, model_dict)
    ev, image = _silk_inputs(H, W)
    rep, mask = jax_rep(ev, "VoxelGrid", bins, H, W, fast=False)
    if padding == 0:
        mask = None
    variables = _perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                          rep, image, mask))
    je, ji, jmatch = jax.jit(jm.apply)(variables, rep, image, mask)

    cfg, _ = silk_config(True, "float32", name)
    cfg = dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(cfg.event_extractor,
                                            padding=padding),
        image_extractor=dataclasses.replace(cfg.image_extractor,
                                            padding=padding),
        matcher=dataclasses.replace(cfg.matcher, lightglue=dataclasses.replace(
            cfg.matcher.lightglue, attention_impl="xla")))
    tm = teim.build_model("EIM", cfg, device="cpu")
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    trep, tmask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                       device="cpu")
    with torch.no_grad():
        te, ti, tmatch = tm(trep, _t(image),
                            tmask if padding else None)
    for got, want in ((te, je), (ti, ji)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors", "score",
                                        "nms"))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tmatch[k].numpy(),
                                      np.asarray(jmatch[k]), err_msg=k)
    np.testing.assert_allclose(tmatch["matching_scores0"].numpy(),
                               np.asarray(jmatch["matching_scores0"]), **TOL)
    if padding == 0:
        assert te["score"].shape == (2, H - 18, W - 18)


def test_tiny_silk_matcher_matches_jax():
    """SiLKMatcher: one shared SiLK on two frames, then MNN."""
    model_dict, (H, W, _) = silk_model_dict(True, "float32", "SiLKMatcher")
    jm, _ = _jax_model("SiLKMatcher", model_dict)
    rng = np.random.default_rng(4)
    im0 = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    im1 = np.clip(np.roll(im0, 2, axis=2)
                  + rng.normal(0, 5, im0.shape), 0, 255).astype(np.float32)
    variables = _perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(1)},
                                          im0, im1))
    jf0, jf1, jmatch = jax.jit(jm.apply)(variables, im0, im1)
    cfg, _ = silk_config(True, "float32", "SiLKMatcher")
    tm = teim.build_model("ImageImageMatcher", cfg, device="cpu")
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    with torch.no_grad():
        tf0, tf1, tmatch = tm(_t(im0), _t(im1))
    for got, want in ((tf0, jf0), (tf1, jf1)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors"))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tmatch[k].numpy(),
                                      np.asarray(jmatch[k]), err_msg=k)
    assert (tmatch["matches0"] > -1).any()
