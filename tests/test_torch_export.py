"""TPU-trained weights reach the port: a tiny JAX EIM (tests/test_train.py's
small LightGlue config, perturbed biases, norm scales and BatchNorm
statistics) saved with the JAX package's `save_checkpoint`, exported by
tools/export_jax_checkpoint.py to an `.npz` of flattened flax paths, and
restored in the port through `train/checkpoint.py:restore_any_checkpoint`
(`strict=True`): the forward equals the JAX forward on the same input
(float32: keypoints and matches exactly, scores and log-assignments to
1e-5), and a model the file does not fit is refused."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, its variables, the exported .npz, one batch)."""
    from ei_nexus_tpu.models import EIM
    from ei_nexus_tpu.train import create_train_state
    from ei_nexus_tpu.train.checkpoint import save_checkpoint
    from ei_nexus_tpu.train.steps import batch_representation
    from tests.test_torch_train import _perturb
    from tests.test_train import BINS, H, W, small_config, synth_batch
    from tools.export_jax_checkpoint import export

    rng = np.random.default_rng(0)
    model = EIM(config=small_config("LightGlue"))
    batch = synth_batch(rng)
    rep, mask = batch_representation(
        {k: jnp.asarray(v) for k, v in batch[0].items()
         if k.startswith("events")}, "VoxelGrid", BINS, H, W, fast=False)
    variables = _perturb(jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0)}, rep,
        jnp.asarray(batch[1]["image"]), mask))
    state = create_train_state(model, variables, optax.sgd(0.0))
    tmp = tmp_path_factory.mktemp("export")
    path = save_checkpoint(str(tmp), state, 3, "final")
    leaves = export(path, str(tmp / "final.npz"))
    assert leaves
    return model, variables, str(tmp / "final.npz"), batch


def test_npz_holds_the_flax_variables(exported):
    """Every leaf of params and batch_stats under its flax path, equal."""
    from ei_nexus_tpu_torch.models.port_jax import read_jax_npz

    _, variables, npz, _ = exported
    got = read_jax_npz(npz)
    assert sorted(got) == ["batch_stats", "params"]
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(variables)}
    have = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(got)}
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(have[k], v, err_msg=k)


def test_exported_checkpoint_restores_the_jax_forward(exported):
    from ei_nexus_tpu.train.steps import batch_representation as jrep
    from ei_nexus_tpu_torch.models import eim as teim
    from ei_nexus_tpu_torch.train.checkpoint import restore_any_checkpoint
    from ei_nexus_tpu_torch.train.steps import batch_representation
    from tests.test_torch_evaluate import _port_config
    from tests.test_train import BINS, H, W

    model, variables, npz, batch = exported
    cfg = _port_config(model.config)
    port = teim.EIM(cfg)
    state, epoch = restore_any_checkpoint(
        npz, types.SimpleNamespace(model=port, step=0), cfg)
    assert epoch == 0 and state.model is port
    events = {k: v for k, v in batch[0].items() if k.startswith("events")}
    rep, mask = jrep({k: jnp.asarray(v) for k, v in events.items()},
                     "VoxelGrid", BINS, H, W, fast=False)
    want = jax.jit(lambda v: model.apply(v, rep, jnp.asarray(
        batch[1]["image"]), mask))(variables)
    trep, tmask = batch_representation(events, "VoxelGrid", BINS, H, W,
                                       device="cpu")
    with torch.no_grad():
        got = port.eval()(trep, torch.as_tensor(batch[1]["image"]), tmask)
    for side in (0, 1):
        for k in ("sparse_positions", "sparse_valid"):
            np.testing.assert_array_equal(
                got[side][k][..., :2].numpy() if k == "sparse_positions"
                else got[side][k].numpy(),
                np.asarray(want[side][k])[..., :2]
                if k == "sparse_positions" else np.asarray(want[side][k]),
                err_msg=f"{side} {k}")
        np.testing.assert_allclose(got[side]["sparse_descriptors"].numpy(),
                                   np.asarray(want[side]["sparse_descriptors"]),
                                   rtol=1e-5, atol=1e-5)
    m_got, m_want = got[2], want[2]
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(m_got[k].numpy(), np.asarray(m_want[k]),
                                      err_msg=k)
    assert int((m_got["matches0"] > -1).sum()) > 0
    for k in ("matching_scores0", "log_assignment"):
        np.testing.assert_allclose(m_got[k].numpy(), np.asarray(m_want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_exported_checkpoint_is_loaded_strictly(exported):
    """A model with a tensor the file lacks (LightGlue's training heads,
    which this inference init does not hold) is refused."""
    from ei_nexus_tpu_torch.models import eim as teim
    from ei_nexus_tpu_torch.train.checkpoint import restore_any_checkpoint
    from tests.test_torch_evaluate import _port_config

    model, _, npz, _ = exported
    cfg = _port_config(model.config)
    wider = teim.EIM(cfg, training_heads=True)
    with pytest.raises(RuntimeError, match="Missing key"):
        restore_any_checkpoint(npz, types.SimpleNamespace(model=wider), cfg)
