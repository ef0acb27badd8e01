"""The SiLK family's training steps against the JAX package's, on the CPU,
in float32, at the tiny sizes of `flagship.silk_config`: the stage-1 step
of `configs/model/SiLK_MNN.yaml` (the cell-1 event extractor distilled
against the frozen SiLK with the losses of configs/train/train_stage1.yaml)
and the stage-2 step of `configs/model/EIM_stage2_SiLK_LG.yaml` (LightGlue
through its 128 -> 256 input projection), 2 steps each.

Tolerances, as tests/test_torch_stage1.py and tests/test_torch_train.py
hold the SuperPoint family: loss and each term rtol 1e-5 (atol 1e-7;
the stage-1 FeatureLoss and total 1e-4, see FEATURE_RTOL),
grad_norm rtol 1e-4 at the first step and 1e-3 at the second, trained
parameters atol 4 * lr (Adam's first steps move a parameter by about lr
whatever its gradient's size, so a near-zero gradient whose sign differs
flips its step), running statistics atol 1e-5, frozen tensors bit-equal;
the second stage-1 step starts from the JAX state's parameters (see
tests/test_torch_stage1.py for why).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.models.config_adapter import (
    eim_config_from_dict as jax_config_from_dict)
from ei_nexus_tpu_torch.flagship import silk_config, silk_model_dict
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BN_TOL = dict(atol=1e-5, rtol=0)
# FeatureLoss (and the total it dominates) at rtol 1e-4: it is the mean
# square of the two 128-wide full-resolution backbones, whose last
# BatchNorm layers (train() on the event side) shift whole channels by
# their float32 statistics; on this batch the JAX side's float32 loss is
# 2.6e-5 from a float64 forward of the same weights, the port's 1.5e-8
FEATURE_RTOL = 1e-4


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


def _exact_voxels(monkeypatch):
    """The JAX step's voxel grid pinned to its exact scatter (fast=False),
    the port's; returns that function."""
    from ei_nexus_tpu.train import steps as jsteps
    exact = jsteps.batch_representation
    monkeypatch.setattr(jsteps, "batch_representation",
                        lambda *a, **k: exact(*a, fast=False, **k))
    return exact


def _check_state(model, jstate, start, trained_root, lr):
    want = load_jax_variables({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        if k.startswith(trained_root):
            tol = (BN_TOL if k.endswith(("running_mean", "running_var"))
                   else dict(atol=4 * lr, rtol=0))
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=k, **tol)
        else:   # frozen: bit-equal to the JAX state and to the start
            assert torch.equal(got[k], want[k]), k
            assert torch.equal(got[k], start[k]), k
    return got, want


def test_silk_stage1_step_matches_jax(monkeypatch):
    """SiLK_MNN's stage-1 step: vgg_np in train() (BatchNorm on batch
    statistics at full resolution), the frozen SiLK, ScoreLoss mse,
    DescriptorsLoss mae on the normalised maps (at cell 1 the coarse maps
    themselves) and FeatureLoss mse (both backbones 128 wide)."""
    from ei_nexus_tpu.losses.factory import build_losses as jax_losses
    from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                    freeze_mask)
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
    from ei_nexus_tpu.train.partition import frozen_roots_from_config
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES, STAGE1_LR,
                                             STAGE1_OPTIMIZER,
                                             STAGE1_SCHEDULER,
                                             stage1_train_state)
    from ei_nexus_tpu_torch.losses.factory import build_losses
    from ei_nexus_tpu_torch.train.steps import make_stage1_train_step

    exact = _exact_voxels(monkeypatch)
    model_dict, (H, W, bins) = silk_model_dict(True, "float32", "SiLK_MNN")
    jm = jeim.EIM(config=jax_config_from_dict(model_dict))
    rng = np.random.default_rng(0)
    view = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    view["image"] = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    batch = (view,)
    rep, mask = exact(view, "VoxelGrid", bins, H, W, fast=False)
    variables = _perturb(jax.jit(jm.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, view["image"], mask, None, True))
    tx = build_optimizer(STAGE1_OPTIMIZER,
                         jax_schedule(STAGE1_SCHEDULER, STAGE1_LR, 1))
    jstate = create_train_state(jm, variables, tx)
    jstep = jsteps.make_stage1_train_step(
        jm, jax_losses(STAGE1_LOSSES),
        freeze_mask(jstate.params, frozen_roots_from_config(jm.config)),
        "VoxelGrid", bins, H, W)

    cfg, _ = silk_config(True, "float32", "SiLK_MNN")
    model = teim.EIM(cfg)
    model.load_state_dict(load_jax_variables(variables), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = stage1_train_state(model)
    tstep = make_stage1_train_step(build_losses(STAGE1_LOSSES), "VoxelGrid",
                                   bins, H, W)
    for i in range(2):
        jstate, jinfo = jstep(jstate, batch, jax.random.PRNGKey(10 + i))
        tinfo = tstep(state, batch)
        assert set(tinfo) == set(jinfo)
        assert "feature_loss" in tinfo
        np.testing.assert_allclose(float(tinfo["loss"]),
                                   float(jinfo["loss"]), rtol=FEATURE_RTOL)
        for k in tinfo:
            if k.startswith(("extractor_", "feature")):
                np.testing.assert_allclose(
                    float(tinfo[k]), float(jinfo[k]), atol=1e-7,
                    rtol=FEATURE_RTOL if k == "feature_loss" else 1e-5,
                    err_msg=k)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]),
                                   rtol=1e-4 if i == 0 else 1e-3)
        got, want = _check_state(model, jstate, start, "event_extractor.",
                                 STAGE1_LR)
        moved = [k for k in start if k.startswith("event_extractor.")
                 and not torch.equal(start[k], got[k])]
        assert len(moved) == sum(k.startswith("event_extractor.")
                                 for k in start)
        with torch.no_grad():
            for k, v in got.items():
                v.copy_(want[k])
    assert state.step == 2


def test_silk_stage2_step_matches_jax(monkeypatch):
    """EIM_stage2_SiLK_LG's stage-2 step: both cell-1 extractors frozen
    (16 keypoints in 32 slots at the tiny size, as 512 in 1024 at full
    size), LightGlue through its input projection, GT matches from pose
    and depth; pad_mode "zeros" and the einsum attention on both sides
    (the random fill draws from different generators)."""
    from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                    freeze_mask)
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
    from ei_nexus_tpu.train.partition import frozen_roots_from_config
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (STAGE2_LR, STAGE2_OPTIMIZER,
                                             STAGE2_SCHEDULER,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    exact = _exact_voxels(monkeypatch)
    model_dict, (H, W, bins) = silk_model_dict(True, "float32",
                                               "EIM_stage2_SiLK_LG")
    model_dict["matcher"]["pad_mode"] = "zeros"
    jcfg = jax_config_from_dict(model_dict)
    jcfg = dataclasses.replace(jcfg, matcher=dataclasses.replace(
        jcfg.matcher, lightglue=dataclasses.replace(
            jcfg.matcher.lightglue, attention_impl="xla")))
    jm = jeim.EIM(config=jcfg)
    # focal 61 keeps keypoint pairs off the pos_th / neg_th boundaries
    batch = stage2_batch(np.random.default_rng(0), 2, 3000, 4096, H, W,
                         focal=61.0)
    rep, mask = exact(batch[0], "VoxelGrid", bins, H, W, fast=False)
    variables = _perturb(jax.jit(jm.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, batch[1]["image"], mask, None, True))
    tx = build_optimizer(STAGE2_OPTIMIZER,
                         jax_schedule(STAGE2_SCHEDULER, STAGE2_LR, 1))
    jstate = create_train_state(jm, variables, tx)
    jstep = jsteps.make_stage2_train_step(
        jm, freeze_mask(jstate.params, frozen_roots_from_config(jcfg)),
        "VoxelGrid", bins, H, W)

    cfg, _ = silk_config(True, "float32", "EIM_stage2_SiLK_LG")
    cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(
        cfg.matcher, pad_mode="zeros", lightglue=dataclasses.replace(
            cfg.matcher.lightglue, attention_impl="xla")))
    model = teim.EIM(cfg, training_heads=True)
    assert model.matcher.lightglue.input_proj.in_features == 128
    model.load_state_dict(load_jax_variables(variables), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = stage2_train_state(model)
    tstep = make_stage2_train_step("VoxelGrid", bins, H, W)
    for i in range(2):
        jstate, jinfo = jstep(jstate, batch, jax.random.PRNGKey(10 + i))
        tinfo = tstep(state, batch)
        assert set(tinfo) == set(jinfo)
        np.testing.assert_allclose(float(tinfo["loss"]),
                                   float(jinfo["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        assert float(tinfo["gt_matches"]) == float(jinfo["gt_matches"])
        _check_state(model, jstate, start, "matcher.", STAGE2_LR)
    assert float(jinfo["gt_matches"]) > 0
    assert state.step == 2
