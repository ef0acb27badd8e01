"""`python -m ei_nexus_tpu_torch.eval_adaptive` against
tools/eval_adaptive.py, on the CPU, over a mini-EC rendered by
tools/make_mini_ec.py and a tiny stage-2 model (4 bins, descriptors 32,
32 keypoints in 32 slots, 2 LightGlue layers) at the reference's
adaptive defaults (depth 0.95, width 0.99), with `--skip-timing
--max-batches 2`.

The weights are one JAX init of the adaptive model (every layer's
assignment head and the token confidence) saved with the JAX package's
`save_checkpoint`; the JAX tool reads that orbax checkpoint, the port's
the `.npz` tools/export_jax_checkpoint.py writes from it. The init is
steered so that the two protocols differ: every matchability bias at +10
and the token confidence's at +10 (every pair exits after layer 0), each
layer's FFN update scaled by 0.1 and each extractor's descriptor output
centred on the first pair (a constant off the event head's last
BatchNorm bias and SuperPoint's convDb bias), without which random
weights give nearly parallel descriptors and LightGlue about one match a
pair whether it exits or not. It still matches a few pairs a frame (a
few keypoints are every other's nearest neighbour), too few for
RANSAC's 5:
the pose errors are then None and the ratios and AUCs 0 on both sides
alike; the RANSAC itself is held in tests/test_torch_evaluate.py.

The JAX tool runs with its voxel grid as the exact scatter (fast=False,
the port's), OpenCV's RANSAC seeded alike (`cv2.setRNGSeed(0)`) before
each tool, and its base protocol repaired: its `make_eval_step(model,
...)` calls `state.apply_fn`, and the tool's one state is the adaptive
model's, so as written its "base" numbers are the adaptive forward's
(`_own_model_step` runs the model each step is made for).

Held: the JSON keys; the exit histogram, n_matches_mean and every None
equal; the AUCs within 1e-4 and every other mean within 1e-4 relative
(the same matched keypoints into the same seeded RANSAC).
"""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CONFIG = "configs/train_EIM_stage2.yaml"
TINY = ["dataset.channel=4", "model.event_extractor.vgg.in_channels=4",
        "model.event_extractor.vgg.descriptor_dim=32",
        "model.event_extractor.vgg.detection_top_k=32",
        "model.image_extractor.superpointv1.descriptor_dim=32",
        "model.image_extractor.superpointv1.detection_top_k=32",
        "model.matcher.max_points_num=32",
        "model.matcher.LightGlue.input_dim=32",
        "model.matcher.LightGlue.descriptor_dim=32",
        "model.matcher.LightGlue.n_layers=2"]
ADAPTIVE = ["model.matcher.LightGlue.depth_confidence=0.95",
            "model.matcher.LightGlue.width_confidence=0.99"]
FFN_SCALE = 0.1   # each layer's update, against the descriptors it adds to


@pytest.fixture(scope="module")
def mini_ec(tmp_path_factory, monkeypatch_module):
    """The first EC validation sequence rendered by tools/make_mini_ec.py
    at 210 frames (two pairs 6 apart after the readers' crop), copied to
    the other validation names, with the tool's pair files."""
    import tools.make_mini_ec as tool
    import tools.make_mini_mvsec as mm
    from ei_nexus_tpu.data.ec import VAL_SEQUENCES, ECArchive, ECSequence

    for name in ("W", "H", "FX", "FY", "CX", "CY", "FPS", "SUBSTEPS",
                 "C_THRESH", "_K_INV_RAYS"):
        monkeypatch_module.setattr(mm, name, getattr(mm, name))
    tool._configure_renderer()
    root = tmp_path_factory.mktemp("mini_ec")
    first, *rest = VAL_SEQUENCES
    tool.gen_sequence(str(root), first, 210, phase=0.7 * 6, seed=106)
    for seq in rest:
        shutil.copytree(root / first, root / seq)
    for seq in VAL_SEQUENCES:
        n = len(ECSequence(ECArchive(str(root)), seq))
        idx = np.arange(0, max(n - 6, 1))
        np.savetxt(root / f"new_{seq}_val.txt",
                   np.stack([idx, np.minimum(idx + 6, n - 1)], 1), fmt="%d")
    return root


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _centre_descriptors(variables, npz, overrides):
    """The JAX variables with each extractor's descriptor output centred
    on the first validation pair, its mean read through the port's model
    (`npz` holds the same weights)."""
    import jax.numpy as jnp
    from ei_nexus_tpu_torch.data import DataLoader
    from ei_nexus_tpu_torch.train.evaluate import (build_eval_model,
                                                   val_dataset)
    from ei_nexus_tpu_torch.train.steps import make_eval_step
    from ei_nexus_tpu_torch.utils import load_config

    cfg = load_config(CONFIG, overrides)
    model = build_eval_model(cfg.model.to_dict(), npz, "cpu")
    ds = cfg.dataset.to_dict()
    batch = next(iter(DataLoader(val_dataset(ds), batch_size=1)))
    means = {}

    def hook(name):
        def read(module, args, out):
            means[name] = out.float().mean(dim=(0, 2, 3)).numpy()
        return read

    hooks = [mod.register_forward_hook(hook(name)) for name, mod in (
        ("event", model.event_extractor.descriptor_head),
        ("image", model.image_extractor.convDb))]
    make_eval_step(ds["representation_type"], ds["channel"],
                   *ds["resolution"])(model, batch)
    for h in hooks:
        h.remove()
    params = variables["params"]
    ev = params["event_extractor"]["descriptor_head"]["h2_bn"]
    ev["bias"] = ev["bias"] - jnp.asarray(means["event"])
    im = params["image_extractor"]["convDb"]
    im["bias"] = im["bias"] - jnp.asarray(means["image"])
    return variables


@pytest.fixture(scope="module")
def checkpoints(mini_ec, tmp_path_factory):
    """(orbax checkpoint, exported .npz) of the tiny adaptive model's
    steered init."""
    import jax
    import jax.numpy as jnp
    import optax
    from ei_nexus_tpu.models import build_model, eim_config_from_dict
    from ei_nexus_tpu.train import create_train_state
    from ei_nexus_tpu.train.checkpoint import save_checkpoint
    from ei_nexus_tpu.train.steps import batch_representation
    from ei_nexus_tpu.utils import load_config
    from tools.export_jax_checkpoint import export

    overrides = ["dataset=test_ec", f"dataset.data_path={mini_ec}"] + TINY
    cfg = load_config(CONFIG, overrides + ADAPTIVE)
    model = build_model("EIM", eim_config_from_dict(cfg.model.to_dict()))
    zeros = {k: np.zeros((1, 8), np.float32) for k in
             ("events_x", "events_y", "events_t", "events_p")}
    rep, mask = batch_representation(
        {**zeros, "events_valid": np.zeros((1, 8), bool)}, "VoxelGrid", 4,
        180, 240)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, rep,
                                    jnp.zeros((1, 180, 240, 1)), mask)
    variables = jax.tree_util.tree_map(lambda x: x, variables)
    lg = variables["params"]["matcher"]["lightglue"]
    for name in ("log_assignment_0", "log_assignment_1"):
        b = lg[name]["matchability"]["bias"]
        lg[name]["matchability"]["bias"] = jnp.full_like(b, 10.0)
    lg["token_confidence_0"]["bias"] = jnp.full_like(
        lg["token_confidence_0"]["bias"], 10.0)
    for i in range(2):
        for block in ("self_attn", "cross_attn"):
            ffn = lg[f"transformers_{i}"][block]["ffn_3"]
            ffn["kernel"] = ffn["kernel"] * FFN_SCALE
            ffn["bias"] = ffn["bias"] * FFN_SCALE
    tmp = tmp_path_factory.mktemp("ckpt")

    def save(v, name):
        state = create_train_state(model, v, optax.sgd(0.0))
        path = save_checkpoint(str(tmp), state, 0, name)
        export(path, str(tmp / f"{name}.npz"))
        return path, str(tmp / f"{name}.npz")

    _, npz = save(variables, "init")
    return save(_centre_descriptors(variables, npz, overrides), "final")


def _run(fn, argv):
    import cv2
    cv2.setRNGSeed(0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(argv)
    return ret, json.loads(out.getvalue().strip().splitlines()[-1])


def _own_model_step(make_eval_step):
    """The JAX package's make_eval_step running the model it is given:
    its step calls `state.apply_fn`, and the JAX tool builds its one state
    from the adaptive model, so that tool's base protocol runs the
    adaptive forward too."""
    def make(model, *args):
        step = make_eval_step(model, *args)
        return lambda state, batch: step(state.replace(apply_fn=model.apply),
                                         batch)
    return make


def test_eval_adaptive_matches_the_jax_tool(mini_ec, checkpoints,
                                            monkeypatch):
    import tools.eval_adaptive as jtool
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.utils import cache
    from ei_nexus_tpu_torch import eval_adaptive

    exact = jsteps.batch_representation
    monkeypatch.setattr(jsteps, "batch_representation",
                        lambda *a, **k: exact(*a, fast=False, **k))
    monkeypatch.setattr(jsteps, "make_eval_step", _own_model_step(
        jsteps.make_eval_step))
    monkeypatch.setattr(cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    orbax, npz = checkpoints
    common = ["--config", CONFIG, "--max-batches", "2", "--skip-timing"]
    overrides = ["dataset=test_ec", f"dataset.data_path={mini_ec}"] + TINY
    _, want = _run(jtool.main, common + ["--ckpt", orbax] + overrides)
    got, printed = _run(eval_adaptive.main, common + [
        "--ckpt", npz, "--device", "cpu"] + overrides)
    assert printed == got
    assert list(got) == list(want)
    assert got["exit_layer_hist"] == want["exit_layer_hist"] \
        == [2] + [0] * 8
    assert got["exit_layer_mean"] == want["exit_layer_mean"] == 0.0
    for part in ("base", "adaptive"):
        g, w = got[part], want[part]
        assert list(g) == list(w), part
        assert g["n_matches_mean"] == w["n_matches_mean"], part
        for k in w:
            assert (g[k] is None) == (w[k] is None), (part, k)
            if w[k] is None:
                continue
            tol = 1e-4 if k.startswith("auc@") else 1e-4 * abs(w[k])
            assert abs(g[k] - w[k]) <= tol, (part, k, g[k], w[k])
    assert got["base"] != got["adaptive"]


def test_eval_adaptive_off_equals_base(mini_ec, checkpoints):
    """--depth -1 --width -1: the "adaptive" model is LightGlue without
    its adaptive path, and its forward equals the base one bit for bit;
    `time_forwards` (the timing without --skip-timing, on the host clock
    here) times both."""
    from ei_nexus_tpu_torch.data import DataLoader
    from ei_nexus_tpu_torch.eval_adaptive import build_models, time_forwards
    from ei_nexus_tpu_torch.train.evaluate import val_dataset
    from ei_nexus_tpu_torch.train.steps import make_eval_step
    from ei_nexus_tpu_torch.utils import load_config

    overrides = ["dataset=test_ec", f"dataset.data_path={mini_ec}"] + TINY
    cfg = load_config(CONFIG, overrides)
    off = load_config(CONFIG, overrides + [
        "model.matcher.LightGlue.depth_confidence=-1",
        "model.matcher.LightGlue.width_confidence=-1"])
    base, ad = build_models(cfg, off, checkpoints[1], "cpu")
    assert not ad.matcher.lightglue.adaptive
    ds = cfg.dataset.to_dict()
    batch = next(iter(DataLoader(val_dataset(ds), batch_size=1)))
    step = make_eval_step(ds["representation_type"], ds["channel"],
                          *ds["resolution"])
    want, got = step(base, batch)[2], step(ad, batch)[2]
    assert sorted(got) == sorted(want) and "exit_layer" not in got
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.equal(got[k], v), k
    for model in (base, ad):
        assert time_forwards(model, batch, ds["representation_type"],
                             ds["channel"], *ds["resolution"], 2) > 0
