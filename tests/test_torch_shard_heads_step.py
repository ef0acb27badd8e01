"""The stage-2 step with tensor-parallel LightGlue heads on the CPU: 4
gloo ranks over a (data 2, model 2) mesh (`dryrun.launch`;
`parallel/dryrun.py:stage2_rank`) take the tiny flagship's step
(float32, 4 heads: 2 a rank) on their rows of one global batch of 4,
against the JAX package's `shard_heads` step over its (2, 2) mesh on the
8-device CPU platform, and against the port in one process computing
every head. tests/test_torch_shard_heads.py holds the forward.

Bounds, as tests/test_torch_ddp.py's (its docstring gives the reasons):
against JAX loss 1e-4 and grad_norm 1e-3 relative, against one process
loss 1e-6 and grad_norm 1e-5; each trainable leaf's gradient within 1e-4
of its leaf's largest; parameters within 3 lr, and 1e-2 lr where the
reference gradient stands clear of rounding; frozen tensors bit-equal. A
wrong per-parameter gradient rule (the head-sliced gradients not summed
over the model group, the replicated ones summed, not averaged, or the
rotary tables outside `copy_to_group`) moves the leaves' gradients by
their own size, and leaves the ranks' gradients unequal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.parallel import make_mesh as jax_make_mesh
from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                freeze_mask)
from ei_nexus_tpu.train import steps as jsteps
from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
from ei_nexus_tpu.train.partition import frozen_roots_from_config
from ei_nexus_tpu_torch.data.synth import stage2_batch
from ei_nexus_tpu_torch.flagship import (STAGE2_LR, STAGE2_OPTIMIZER,
                                         STAGE2_SCHEDULER, stage2_config)
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.parallel import dryrun
from tests.test_torch_ddp import (GRAD_RTOL, _perturb, close_grads,
                                  close_params, jax_mesh_step)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DATA, MODEL = 2, 2


@pytest.fixture(scope="module")
def cases():
    from __graft_entry__ import _flagship

    mesh = jax_make_mesh(data=DATA, model=MODEL,
                         devices=jax.devices()[:DATA * MODEL])
    out = {}
    exact = jsteps.batch_representation
    jm0, (H, W, bins) = _flagship(tiny=True, shard_heads=True)
    jc = jm0.config
    jcfg = dataclasses.replace(jc, event_extractor=dataclasses.replace(
        jc.event_extractor, freeze=True))
    jm = jeim.EIM(config=jcfg)
    batch = stage2_batch(np.random.default_rng(2), 4, 3000, 4096, H, W,
                         focal=61.0)
    rep, mask = exact(batch[0], "VoxelGrid", bins, H, W, fast=False)
    variables = _perturb(jax.jit(jm.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, batch[1]["image"], mask, None, True))
    key = jax.random.PRNGKey(10)
    (_, _, m), _ = jm.apply(variables, rep, batch[1]["image"], mask, None,
                            True, mutable=["batch_stats"],
                            rngs={"pad": key})
    fill = tuple((torch.from_numpy(np.array(
        m[f"input_feats{s}"]["sparse_positions"])), torch.from_numpy(
            np.array(m[f"input_feats{s}"]["sparse_descriptors"])))
        for s in (0, 1))
    tx = build_optimizer(STAGE2_OPTIMIZER,
                         jax_schedule(STAGE2_SCHEDULER, STAGE2_LR, 1))
    jstate = create_train_state(jm, variables, tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "batch_representation",
                   lambda *a, **k: exact(*a, fast=False, **k))
        jstep = jsteps.make_stage2_train_step(
            jm, freeze_mask(jstate.params, frozen_roots_from_config(jcfg)),
            "VoxelGrid", bins, H, W)
        out["jax_step"] = jax_mesh_step(jstep, jstate, batch, key, mesh)
    s2_cfg, _ = stage2_config(tiny=True, dtype="float32", shard_heads=True)
    s2_state = load_jax_variables(variables)

    out["ranks"] = dryrun.launch(
        dryrun.stage2_rank, DATA * MODEL,
        (DATA, MODEL, "cpu", s2_cfg, s2_state, batch, fill), device="cpu",
        timeout_s=300)
    out["one_step"] = dryrun.stage2_rank(1, 1, "cpu", s2_cfg, s2_state,
                                         batch, fill)
    return out


def test_stage2_step_over_data_2_model_2_matches_the_jax_mesh(cases):
    want_sd, want, want_grads = cases["jax_step"]
    got = cases["ranks"][0]
    info = got["info"]
    assert set(info) == set(want)
    np.testing.assert_allclose(info["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(info["grad_norm"], want["grad_norm"],
                               rtol=1e-3)
    assert info["gt_matches"] == want["gt_matches"] > 0
    assert got["grads"] and all(k.startswith("matcher.")
                                for k in got["grads"])
    close_grads(got["grads"], want_grads, GRAD_RTOL)
    close_params(got["state_dict"], want_sd, want_grads, STAGE2_LR)
    # every rank reports the global values and holds the whole gradient
    # of every parameter, head-sliced ones included
    for r in cases["ranks"]:
        assert r["info"] == info
        close_grads(r["grads"], got["grads"], 0.0)
    # the einsum path: no attention kernel under shard_heads
    assert got["launches"]["attention_fwd"] == 0


def test_stage2_step_over_data_2_model_2_matches_one_process(cases):
    got, one = cases["ranks"][0], cases["one_step"]
    a, b = got["info"], one["info"]
    for k in set(b) - {"grad_norm"}:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    assert set(got["grads"]) == set(one["grads"])
    close_grads(got["grads"], one["grads"], GRAD_RTOL)
    close_params(got["state_dict"], one["state_dict"], one["grads"],
                 STAGE2_LR)
