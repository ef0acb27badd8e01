"""Reference `.pth` checkpoints into the port (`models/port_torch.py`)
against the JAX package's import (`ei_nexus_tpu/models/port_torch.py`)
carried across with `load_jax_variables`, on the CPU.

The reference state dicts are synthetic, in the reference's layout (no
checkpoint is in the repository): a tiny model's seeded weights written
out by `to_reference_layout`, with BatchNorm's `num_batches_tracked`
beside its statistics; the VGG extractor with batchnorm also as
tests/test_port_torch.py's independently built reference module. Both
imports must give the same tensors bit for bit (both read the same
float32 values and only rename or transpose), and the tiny EIM loaded
from a `.pth` file on each side must give the same forward: keypoints,
validity and matches exact, scores atol 1e-4 with rtol 1e-4 (float32
layers summed in another order, as tests/test_torch_models.py).
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from ei_nexus_tpu.models import port_torch as jpt
from ei_nexus_tpu_torch.flagship import build_silk, flagship_config
from ei_nexus_tpu_torch.models import port_torch as tpt
from ei_nexus_tpu_torch.models.eim import EIM
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _randomised(model, seed):
    """`model`'s state dict with flax's initialisers drawn from a seed,
    then biases and normalisation statistics and scales perturbed (flax
    initialises them to identities), as tests/test_torch_models.py does."""
    from ei_nexus_tpu_torch.models.layers import init_parameters
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith(("bias", "running_mean")):
            v = torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                 .astype(np.float32))
        elif k.endswith("running_var") or v.ndim == 1:
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        out[k] = v.float().clone()
    return out


def _flagship_model(seed=0, xla=False):
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    if xla:
        cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
            cfg.matcher, lightglue=dataclasses.replace(
                cfg.matcher.lightglue, attention_impl="xla")))
    model = EIM(cfg, training_heads=True)
    model.load_state_dict(_randomised(model, seed))
    return model.eval(), cfg


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_bit_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["flagship", "EI_SiLK_LG"])
def test_eim_mapping_matches_jax(name):
    if name == "flagship":
        model, cfg = _flagship_model()
        image = "superpointv1"
    else:
        model, _ = build_silk(name, tiny=True, dtype="float32",
                              device="cpu", training_heads=True)
        model.load_state_dict(_randomised(model, 1))
        cfg, image = model.config, "silk"
    kw = dict(image_extractor_type=image, matcher_type="LightGlue",
              n_lightglue_layers=cfg.matcher.lightglue.n_layers,
              use_batchnorm=cfg.event_extractor.use_batchnorm)
    ref = tpt.to_reference_layout(model.state_dict(), image)
    assert any(k.endswith("num_batches_tracked") for k in ref)
    assert any(".token.0." in k for k in ref)
    got = tpt.load_eim_torch_checkpoint(ref, **kw)
    want = load_jax_variables(jpt.load_eim_torch_checkpoint(_numpy(ref),
                                                            **kw))
    _assert_bit_equal(got, want)
    # the round trip through the reference layout is the identity
    _assert_bit_equal(got, model.state_dict())
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_vgg_mapping_matches_jax(use_batchnorm):
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    cfg = dataclasses.replace(cfg, event_extractor=dataclasses.replace(
        cfg.event_extractor, use_batchnorm=use_batchnorm))
    model = EIM(cfg)
    ref = tpt.to_reference_layout(_randomised(model, 2))
    pre = "event_extractor.extractor."
    ev = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert any(".2.running_mean" in k for k in ev) == use_batchnorm
    got = tpt.load_vgg_extractor_torch_weights(ev, use_batchnorm)
    want = load_jax_variables(jpt.load_vgg_extractor_torch_weights(
        _numpy(ev), use_batchnorm))
    _assert_bit_equal(got, want)
    model.event_extractor.load_state_dict(got, strict=True)


def test_independent_reference_vgg_matches_jax():
    """The reference-layout VGG trunk that tests/test_port_torch.py builds
    from torch.nn (Conv -> ReLU -> BN blocks, its own module names)."""
    from tests.test_port_torch import TorchVGGTrunk
    torch.manual_seed(0)
    sd = TorchVGGTrunk().state_dict()
    got = tpt.load_vgg_extractor_torch_weights(sd)
    want = load_jax_variables(jpt.load_vgg_extractor_torch_weights(
        _numpy(sd)))
    _assert_bit_equal(got, want)


def test_old_style_lightglue_keys_match_jax():
    """`self_attn.{i}` / `cross_attn.{i}` at the top level, as older
    LightGlue releases name them."""
    model, cfg = _flagship_model(seed=3)
    pre = "matcher.matcher."
    lg = {k[len(pre):]: v for k, v in tpt.to_reference_layout(
        model.state_dict()).items() if k.startswith(pre)}
    old = {}
    for k, v in lg.items():
        parts = k.split(".")
        if parts[0] == "transformers":
            k = ".".join([parts[2], parts[1]] + parts[3:])
        old[k] = v
    assert "self_attn.1.Wqkv.weight" in old
    L = cfg.matcher.lightglue.n_layers
    got = tpt.load_lightglue_torch_weights(old, n_layers=L)
    want = load_jax_variables(jpt.load_lightglue_torch_weights(
        _numpy(old), n_layers=L))
    _assert_bit_equal(got, want)
    _assert_bit_equal(got, tpt.load_lightglue_torch_weights(lg, n_layers=L))


def test_missing_key_raises():
    model, _ = _flagship_model()
    ref = tpt.to_reference_layout(model.state_dict())
    del ref["image_extractor.extractor.convDb.bias"]
    with pytest.raises(KeyError, match="convDb"):
        tpt.load_eim_torch_checkpoint(ref, n_lightglue_layers=2)


def test_tiny_eim_from_pth_matches_jax(tmp_path, monkeypatch):
    """The tiny flagship read from the same `.pth` file on both sides
    (JAX: `load_eim_checkpoint_file` onto its init; the port:
    `restore_any_checkpoint`) gives the same forward (LightGlue on the
    einsum path on both)."""
    import types
    from __graft_entry__ import _flagship
    from ei_nexus_tpu.train.steps import batch_representation as jax_rep
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.train import restore_any_checkpoint
    from ei_nexus_tpu_torch.train.steps import batch_representation

    src, cfg = _flagship_model(seed=5, xla=True)
    path = tmp_path / "eim.pth"
    torch.save({"model": tpt.to_reference_layout(src.state_dict())}, path)

    monkeypatch.setenv("EI_NEXUS_ATTN", "xla")
    jm, (H, W, bins) = _flagship(tiny=True)
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    image = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    rep, mask = jax_rep(ev, "VoxelGrid", bins, H, W, fast=False)
    init = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, rep, image,
                            mask)
    variables = jpt.load_eim_checkpoint_file(str(path), init,
                                             n_lightglue_layers=2)
    je, ji, jmatch = jax.jit(jm.apply)(variables, rep, image, mask)

    model = EIM(cfg, training_heads=True)
    state, epoch = restore_any_checkpoint(
        str(path), types.SimpleNamespace(model=model, step=0), cfg)
    assert epoch == 0
    _assert_bit_equal(model.state_dict(), src.state_dict())
    trep, tmask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                       device="cpu")
    with torch.no_grad():
        te, ti, tmatch = model.eval()(trep, torch.from_numpy(image), tmask)
    for got, want in ((te, je), (ti, ji)):
        np.testing.assert_array_equal(got["sparse_positions"][..., :2],
                                      np.asarray(want["sparse_positions"])
                                      [..., :2])
        np.testing.assert_array_equal(got["sparse_valid"],
                                      np.asarray(want["sparse_valid"]))
        np.testing.assert_allclose(got["sparse_descriptors"],
                                   np.asarray(want["sparse_descriptors"]),
                                   **TOL)
    np.testing.assert_array_equal(tmatch["matches0"].numpy(),
                                  np.asarray(jmatch["matches0"]))
    np.testing.assert_allclose(tmatch["matching_scores0"].numpy(),
                               np.asarray(jmatch["matching_scores0"]), **TOL)
    assert (tmatch["matches0"] > -1).any()


def test_mnn_eim_keeps_the_roots_a_file_lacks(tmp_path):
    """A file without a matcher (the MNN models): the extractors are read,
    the matcher root (no parameters) stays, as `strict=False` does."""
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
        cfg.matcher, type="MNN"))
    model = EIM(cfg)
    src = _randomised(model, 5)
    ref = tpt.to_reference_layout(src)
    assert not any(k.startswith("matcher") for k in ref)
    path = tmp_path / "mnn.pth"
    torch.save(ref, path)
    tpt.load_eim_checkpoint_file(str(path), model, matcher_type="MNN")
    _assert_bit_equal(model.state_dict(), src)


def test_silk_lightning_file_matches_jax(tmp_path):
    model, _ = build_silk("EI_SiLK_LG", tiny=True, dtype="float32",
                          device="cpu")
    silk = _randomised(model.image_extractor, 6)
    ref = tpt.to_reference_layout(
        {f"image_extractor.{k}": v for k, v in silk.items()}, "silk")
    pre = "image_extractor.extractor.model."
    lightning = {"state_dict": {"_mods.model." + k[len(pre):]: v
                                for k, v in ref.items()}}
    path = tmp_path / "pvgg-4.ckpt"
    torch.save(lightning, path)
    got = tpt.load_silk_lightning_file(str(path))
    want = load_jax_variables(jpt.load_silk_lightning_file(str(path)))
    _assert_bit_equal(got, want)
    _assert_bit_equal(got, silk)
