"""Data-parallel training of the port on the CPU: 4 gloo ranks
(`dryrun.launch`; `tests/torch_ranks.py:ddp_cases`) take the stage-2 and
the stage-1 step of the tiny flagship (32x48, 4 bins, K=32, 2 LightGlue
layers of 4 heads, float32) on their rows of one global batch of 4, and
the parent holds them against the JAX package's step over
`make_mesh(data=4)` on the 8-device CPU platform, and against the port's
own step in one process.

Bounds, each with its reason:
 - the scalars against JAX, the dry run's (`__graft_entry__.
   dryrun_multichip`, `parallel/dryrun.py`): loss 1e-4 relative,
   grad_norm 1e-3 relative; against one process of the port, the same
   float32 arithmetic in another summation order (4 partial sums, then the
   all-reduce): loss and its terms 1e-6 relative, grad_norm 1e-5;
 - each trainable leaf's gradient, as the update read it (JAX's from its
   Adam first moment, (1 - b1) g after one step), elementwise within 1e-4
   of its leaf's largest |g| (a hundredth of the largest leaf's at least):
   3.3e-6 seen in stage 2, 3.3e-5 in stage 1, whose BatchNorm backward
   subtracts means; a norm cannot see gradients swapped between leaves of
   one shape or a mis-split of the flattened all-reduce, this can;
 - parameters: Adam's first step moves an element by about lr whatever
   its gradient's size, so one whose gradient is at rounding noise may
   step the other way: every element within 3 lr, and each whose
   reference gradient stands above 1e-3 of its leaf's largest and above
   1e-6 within 1e-2 lr (1.5e-4 lr seen); frozen tensors bit-equal;
   BatchNorm running statistics 1e-5 absolute against JAX
   (tests/test_torch_stage1.py's BN_TOL) and 1e-6 against one process;
 - the stage-1 batch's event masks differ between the ranks' rows (3000,
   700, 1600 and 120 valid events), so a rank's masked mean over its own
   mask is not the global one: the average of the ranks' local-
   normaliser terms must miss the JAX terms by more than 100 times the
   1e-5 that the port's global ones hold.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from ei_nexus_tpu.losses import build_losses as jax_build_losses
from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.parallel import make_mesh as jax_make_mesh
from ei_nexus_tpu.parallel import replicate as jax_replicate
from ei_nexus_tpu.parallel import shard_batch as jax_shard_batch
from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                freeze_mask)
from ei_nexus_tpu.train import steps as jsteps
from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
from ei_nexus_tpu.train.partition import frozen_roots_from_config
from ei_nexus_tpu_torch.data.synth import bursty_event_batch, stage2_batch
from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES, STAGE1_LR,
                                         STAGE1_OPTIMIZER, STAGE1_SCHEDULER,
                                         STAGE2_LR, STAGE2_OPTIMIZER,
                                         STAGE2_SCHEDULER, stage1_config,
                                         stage2_config)
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.parallel import dryrun
from tests import torch_ranks
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
S1_LOSSES = {k: v for k, v in STAGE1_LOSSES.items() if k != "feature_loss"}
MASK_COUNTS = (3000, 700, 1600, 120)
GRAD_RTOL = 1e-4


def _perturb(variables, seed=0):
    """Random biases, norm scales and BN statistics (numpy, seeded), as
    tests/test_torch_stage1.py perturbs them."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "mean"):
                out[k] = jax.numpy.asarray(rng.normal(0, 0.1, v.shape),
                                           v.dtype)
            elif k in ("scale", "var"):
                out[k] = jax.numpy.asarray(rng.uniform(0.5, 1.5, v.shape),
                                           v.dtype)
            else:
                out[k] = v
        return out
    return {col: walk(tree) for col, tree in variables.items()}


def adam_grads(opt_state, b1=0.9):
    """The gradient a first step read, by the port's names: Adam's first
    moment after one step is (1 - b1) g."""
    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)
    mu, = [s.mu for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
           if is_adam(s)]
    return load_jax_variables({"params": jax.tree.map(lambda m: m / (1 - b1),
                                                      mu)})


def jax_mesh_step(step, state, batch, key, mesh):
    """The JAX step over `mesh`: (state dict, info, gradients)."""
    with jax.set_mesh(mesh):
        st, info = step(jax_replicate(state, mesh),
                        jax_shard_batch(batch, mesh), key)
        return (load_jax_variables({"params": st.params,
                                    "batch_stats": st.batch_stats}),
                {k: float(v) for k, v in info.items()},
                adam_grads(st.opt_state))


def _jax_mesh_step(step, state, batch, key):
    return jax_mesh_step(step, state, batch, key, jax_make_mesh(
        data=WORLD, devices=jax.devices()[:WORLD]))


@pytest.fixture(scope="module")
def cases():
    from __graft_entry__ import _flagship

    exact = jsteps.batch_representation
    jm0, (H, W, bins) = _flagship(tiny=True)
    jc = jm0.config
    key = jax.random.PRNGKey(10)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "batch_representation",
                   lambda *a, **k: exact(*a, fast=False, **k))
        # stage 2: LightGlue trained, both extractors frozen, the fill the
        # JAX model draws from `key` handed to the port
        jcfg = dataclasses.replace(
            jc, event_extractor=dataclasses.replace(jc.event_extractor,
                                                    freeze=True),
            matcher=dataclasses.replace(
                jc.matcher, lightglue=dataclasses.replace(
                    jc.matcher.lightglue, attention_impl="xla")))
        jm = jeim.EIM(config=jcfg)
        batch2 = stage2_batch(np.random.default_rng(0), WORLD, 3000, 4096,
                              H, W, focal=61.0)
        rep, mask = exact(batch2[0], "VoxelGrid", bins, H, W, fast=False)
        variables = _perturb(jax.jit(jm.init, static_argnums=(5,))(
            {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
            rep, batch2[1]["image"], mask, None, True))
        (_, _, m), _ = jm.apply(variables, rep, batch2[1]["image"], mask,
                                None, True, mutable=["batch_stats"],
                                rngs={"pad": key})
        fill = tuple((torch.from_numpy(np.array(
            m[f"input_feats{s}"]["sparse_positions"])),
            torch.from_numpy(np.array(
                m[f"input_feats{s}"]["sparse_descriptors"])))
            for s in (0, 1))
        tx = build_optimizer(STAGE2_OPTIMIZER,
                             jax_schedule(STAGE2_SCHEDULER, STAGE2_LR, 1))
        jstate = create_train_state(jm, variables, tx)
        jstep = jsteps.make_stage2_train_step(
            jm, freeze_mask(jstate.params, frozen_roots_from_config(jcfg)),
            "VoxelGrid", bins, H, W)
        out["jax2"] = _jax_mesh_step(jstep, jstate, batch2, key)
        s2_state = load_jax_variables(variables)
        tcfg2, _ = stage2_config(tiny=True, dtype="float32")
        tcfg2 = dataclasses.replace(tcfg2, matcher=dataclasses.replace(
            tcfg2.matcher, lightglue=dataclasses.replace(
                tcfg2.matcher.lightglue, attention_impl="xla")))

        # stage 1: the event extractor trained (BatchNorm in train()) under
        # masks of unequal counts
        rng = np.random.default_rng(1)
        view = bursty_event_batch(rng, WORLD, max(MASK_COUNTS), 4096, H, W)
        for i, n in enumerate(MASK_COUNTS):
            view["events_valid"][i, n:] = False
        view["image"] = rng.uniform(0, 255, (WORLD, H, W, 1)).astype(
            np.float32)
        batch1 = (view,)
        jcfg1 = dataclasses.replace(
            jc, event_extractor=dataclasses.replace(jc.event_extractor,
                                                    freeze=False),
            matcher=jeim.MatcherConfig(
                type="MNN", freeze=True,
                max_points_num=jc.matcher.max_points_num))
        jm1 = jeim.EIM(config=jcfg1)
        rep1, mask1 = exact(view, "VoxelGrid", bins, H, W, fast=False)
        counts = np.asarray(mask1).reshape(WORLD, -1).sum(1)
        assert len(set(counts.tolist())) == WORLD, counts
        variables1 = _perturb(jax.jit(jm1.init, static_argnums=(5,))(
            {"params": jax.random.PRNGKey(2), "pad": jax.random.PRNGKey(1)},
            rep1, view["image"], mask1, None, True), seed=1)
        tx1 = build_optimizer(STAGE1_OPTIMIZER,
                              jax_schedule(STAGE1_SCHEDULER, STAGE1_LR, 1))
        jstate1 = create_train_state(jm1, variables1, tx1)
        jstep1 = jsteps.make_stage1_train_step(
            jm1, jax_build_losses(S1_LOSSES),
            freeze_mask(jstate1.params, frozen_roots_from_config(jcfg1)),
            "VoxelGrid", bins, H, W)
        out["jax1"] = _jax_mesh_step(jstep1, jstate1, batch1, key)
    s1_state = load_jax_variables(variables1)
    tcfg1, _ = stage1_config(tiny=True, dtype="float32")

    args = (tcfg2, s2_state, batch2, fill, tcfg1, s1_state, batch1,
            S1_LOSSES)
    out["ranks"] = dryrun.launch(torch_ranks.ddp_cases, WORLD,
                                 (WORLD,) + args, device="cpu",
                                 timeout_s=300)
    out["one"] = torch_ranks.ddp_cases(1, *args)
    out["counts"] = counts
    return out


def close_grads(got, want, rtol):
    """Each trainable leaf's gradient (`got`, by name) against `want`,
    elementwise within `rtol` of the larger of its leaf's largest |want|
    and a hundredth of the largest over all leaves (a leaf whose gradient
    is zero but for rounding, as a bias before a normalisation, is held at
    that floor); every leaf of `want` that `got` lacks (frozen) zero."""
    floor = 1e-2 * max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        scale = max(float(want[k].abs().max()), floor)
        err = float((g - want[k]).abs().max())
        assert err <= rtol * scale, (k, err, scale)
    for k in set(want) - set(got):
        assert not want[k].any(), k


def close_params(got, want, grads, lr, stats_atol=None):
    """Parameters after the first step, `got` against `want` (state
    dicts): a tensor without a gradient in `grads` (frozen, or a
    statistic) bit-equal, or running statistics within `stats_atol`; each
    trainable element within 3 lr, and within 1e-2 lr where its gradient
    stands above 1e-3 of its leaf's largest and above 1e-6."""
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")) and stats_atol:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       atol=stats_atol, rtol=0, err_msg=k)
        elif k not in grads:
            assert torch.equal(got[k], w), k
        else:
            g = grads[k].abs().numpy()
            sure = (g > 1e-3 * g.max()) & (g > 1e-6)
            d = (got[k] - w).abs().numpy()
            np.testing.assert_array_less(d, 3 * lr, err_msg=k)
            assert d[sure].max(initial=0) <= 1e-2 * lr, k


def test_stage2_step_at_world_4_matches_the_jax_mesh(cases):
    want_sd, want, want_grads = cases["jax2"]
    got = cases["ranks"][0]["stage2_fill"]
    info = got["info"]
    assert set(info) == set(want)
    np.testing.assert_allclose(info["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(info["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    assert info["gt_matches"] == want["gt_matches"]
    assert want["gt_matches"] > 0
    assert got["grads"] and all(k.startswith("matcher.")
                                for k in got["grads"])
    close_grads(got["grads"], want_grads, GRAD_RTOL)
    close_params(got["state_dict"], want_sd, want_grads, STAGE2_LR)
    # every rank reports the global values and holds the global gradient
    for r in cases["ranks"]:
        assert r["stage2_fill"]["info"] == info
        close_grads(r["stage2_fill"]["grads"], got["grads"], 0.0)


@pytest.mark.parametrize("fill", ["stage2_fill", "stage2_drawn"])
def test_stage2_step_at_world_4_matches_one_process(cases, fill):
    """The fill handed in (the global batch's), and drawn from one seeded
    generator by every rank for the global batch, each rank keeping its
    rows: both equal one process's step."""
    got, one = cases["ranks"][0][fill], cases["one"][fill]
    a, b = got["info"], one["info"]
    for k in set(b) - {"grad_norm"}:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    assert set(got["grads"]) == set(one["grads"])
    close_grads(got["grads"], one["grads"], GRAD_RTOL)
    close_params(got["state_dict"], one["state_dict"], one["grads"],
                 STAGE2_LR)
    assert set(got["launches"].values()) == {0}


def test_stage1_step_at_world_4_matches_the_jax_mesh(cases):
    """Global BatchNorm statistics and the global mask count of each
    masked mean: loss, terms, grad_norm, gradients, parameters and running
    statistics against the JAX data-4 mesh."""
    want_sd, want, want_grads = cases["jax1"]
    got = cases["ranks"][0]["stage1"]
    info = got["info"]
    assert set(info) == set(want)
    for k in ("loss", "extractor_keypoints_loss",
              "extractor_descriptor_loss"):
        np.testing.assert_allclose(info[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(info["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    assert got["grads"] and all(k.startswith("event_extractor.")
                                for k in got["grads"])
    close_grads(got["grads"], want_grads, GRAD_RTOL)
    close_params(got["state_dict"], want_sd, want_grads, STAGE1_LR,
                 stats_atol=1e-5)
    for r in cases["ranks"]:
        assert r["stage1"]["info"] == info
        close_grads(r["stage1"]["grads"], got["grads"], 0.0)


def test_stage1_local_normalisers_would_miss_the_jax_loss(cases):
    """The ranks' rows carry unequal mask counts, so the mean of the
    ranks' local masked means is not the global masked mean: removing the
    global normalisers would break the parity above."""
    _, want, _ = cases["jax1"]
    terms = [r["terms"] for r in cases["ranks"]]
    counts = [t["mask_count"] for t in terms]
    assert len(set(counts)) == WORLD
    assert counts == cases["counts"].tolist()
    for name, key in (("keypoints_loss", "extractor_keypoints_loss"),
                      ("descriptors_loss", "extractor_descriptor_loss")):
        glob = np.mean([t[f"{name}_global"] for t in terms])
        local = np.mean([t[f"{name}_local"] for t in terms])
        np.testing.assert_allclose(glob, want[key], rtol=1e-5)
        assert abs(local - want[key]) > 100 * 1e-5 * abs(want[key]), (
            local, want[key])


def test_stage1_step_at_world_4_matches_one_process(cases):
    got, one = cases["ranks"][0]["stage1"], cases["one"]["stage1"]
    for k in set(one["info"]) - {"grad_norm"}:
        np.testing.assert_allclose(got["info"][k], one["info"][k],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["info"]["grad_norm"],
                               one["info"]["grad_norm"], rtol=1e-5)
    assert set(got["grads"]) == set(one["grads"])
    close_grads(got["grads"], one["grads"], GRAD_RTOL)
    close_params(got["state_dict"], one["state_dict"], one["grads"],
                 STAGE1_LR, stats_atol=1e-6)
