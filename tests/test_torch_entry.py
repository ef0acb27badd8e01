"""The port's stage-1 host code against the JAX package's, on the CPU: the
config loader, the model-config adapter, checkpoints (round trip, exact
resume, the stage surgery), the mini-EC renderer, the augmented batch on
the wire, and the stage-1 entry point (`python -m
ei_nexus_tpu_torch.train_extractor`) over a rendered mini-EC, with its
resume.

Every comparison here is exact: the same host arithmetic on both sides,
or the same float32 CPU computation run twice.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu import native as jnative
from ei_nexus_tpu.train import steps as jsteps
from ei_nexus_tpu_torch import native as tnative
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.train import steps as tsteps

ROOT = Path(__file__).resolve().parent.parent
TRAIN_CONFIGS = sorted((ROOT / "configs").glob("train_*.yaml"))
MODEL_CONFIGS = sorted((ROOT / "configs" / "model").rglob("*.yaml"))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", TRAIN_CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax(path):
    from ei_nexus_tpu.utils import load_config as jload
    from ei_nexus_tpu_torch.utils import load_config

    assert load_config(str(path)).to_dict() == jload(str(path)).to_dict()
    overrides = ["train.optimizer.lr=5e-4", "dataset.train.batch_size=2",
                 "logger.status_freq=1", "model=SP_MNN",
                 "train.scheduler.type=StepLR"]
    got = load_config(str(path), overrides)
    assert got.to_dict() == jload(str(path), overrides).to_dict()
    assert got.train.optimizer.lr == 5e-4
    assert got.model.matcher.type == "MNN"


def test_save_config_round_trips(tmp_path):
    from ei_nexus_tpu_torch.utils import load_config, save_config

    cfg = load_config(str(TRAIN_CONFIGS[0]), ["seed=7"])
    save_config(cfg, str(tmp_path / "config.yaml"))
    again = load_config(str(tmp_path / "config.yaml"))
    assert again.to_dict() == cfg.to_dict()


@pytest.mark.parametrize("path", MODEL_CONFIGS,
                         ids=lambda p: str(p.relative_to(ROOT / "configs")))
def test_eim_config_from_dict_matches_jax(path):
    """Field for field, "vgg_np" and "silk" specs included (only
    `build_model` refuses those). An ImageImageMatcher config has no event
    extractor section; both sides get the same stand-in."""
    import yaml
    from ei_nexus_tpu.models.config_adapter import (
        eim_config_from_dict as jadapt)
    from ei_nexus_tpu_torch.models.config_adapter import eim_config_from_dict

    raw = yaml.safe_load(path.read_text())
    if "event_extractor" not in raw:   # ImageImageMatcher configs
        raw["event_extractor"] = {"type": "vgg"}
    got = dataclasses.asdict(eim_config_from_dict(raw))
    # the port's one extra field: LightGlue's q-block size, which the JAX
    # package reads from EI_NEXUS_ATTN_QBLOCK and no config sets
    assert got["matcher"]["lightglue"].pop("block_q") == 0
    assert got == dataclasses.asdict(jadapt(raw))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tiny_state(seed=0, stage=1):
    from ei_nexus_tpu_torch import flagship as fl

    if stage == 1:
        model, shape = fl.build_stage1_flagship(
            tiny=True, dtype="float32", device="cpu",
            generator=torch.Generator().manual_seed(seed))
        return model, fl.stage1_train_state(model, steps_per_epoch=3), shape
    model, shape = fl.build_stage2_flagship(
        tiny=True, dtype="float32", device="cpu",
        generator=torch.Generator().manual_seed(seed))
    return model, fl.stage2_train_state(model, steps_per_epoch=3), shape


def _batches(H, W, n=4):
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        view = bursty_event_batch(rng, 2, 2000, 4096, H, W)
        view["image"] = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
        out.append((view,))
    return out


def _step_fn(H, W, bins):
    from ei_nexus_tpu_torch.flagship import STAGE1_LOSSES
    from ei_nexus_tpu_torch.losses import build_losses
    losses = build_losses({k: v for k, v in STAGE1_LOSSES.items()
                           if k != "feature_loss"})
    return tsteps.make_stage1_train_step(losses, "VoxelGrid", bins, H, W)


def test_checkpoint_round_trip_and_exact_resume(tmp_path):
    """save -> restore into a fresh model and optimizer gives the same
    tensors, optimizer state, step and epoch; 2 steps, a checkpoint, a
    fresh state restored from it and 2 more steps equal 4 uninterrupted
    steps bit for bit (float32 on the CPU)."""
    from ei_nexus_tpu_torch.train import (restore_checkpoint,
                                          save_checkpoint)

    model_a, state_a, (H, W, bins) = _tiny_state()
    step = _step_fn(H, W, bins)
    batches = _batches(H, W)
    for b in batches:
        step(state_a, b)

    model_b, state_b, _ = _tiny_state()
    for b in batches[:2]:
        step(state_b, b)
    path = save_checkpoint(str(tmp_path / "ckpt"), state_b, epoch=0)
    assert os.path.isfile(os.path.join(path, "state.pt"))

    model_c, state_c, _ = _tiny_state(seed=5)     # other weights
    state_c, epoch = restore_checkpoint(path, state_c)
    assert epoch == 0 and state_c.step == 2
    for k, v in model_b.state_dict().items():
        assert torch.equal(v, model_c.state_dict()[k]), k
    ob, oc = state_b.optimizer.state_dict(), state_c.optimizer.state_dict()
    assert ob["param_groups"] == oc["param_groups"]
    for i, s in ob["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(oc["state"][i][k])), (i, k)
    for b in batches[2:]:
        step(state_c, b)
    assert state_a.step == state_c.step == 4
    for k, v in model_a.state_dict().items():
        assert torch.equal(v, model_c.state_dict()[k]), k

    # params_only leaves the optimizer as it is
    model_d, state_d, _ = _tiny_state(seed=6)
    restore_checkpoint(path, state_d, params_only=True)
    assert state_d.optimizer.state_dict()["state"] == {}
    for k, v in model_b.state_dict().items():
        assert torch.equal(v, model_d.state_dict()[k]), k


def test_restore_any_checkpoint_refuses_reference_files(tmp_path):
    from ei_nexus_tpu_torch.train import restore_any_checkpoint
    _, state, _ = _tiny_state()
    with pytest.raises(NotImplementedError, match="port_torch"):
        restore_any_checkpoint(str(tmp_path / "model.pth"), state, None)


def _jax_state(model, variables, lr=1e-3):
    from ei_nexus_tpu.train import build_optimizer, create_train_state
    tx = build_optimizer({"type": "AdamW", "AdamW": {}}, lambda s: lr)
    return create_train_state(model, variables, tx)


def _jax_init(model, H, W, bins):
    """(the checkpointed weights, the receiving model's weights): one
    flax init, the second set moved off the first everywhere, BatchNorm
    statistics included, so that every copied tensor shows."""
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    rng = np.random.default_rng(0)
    ev = bursty_event_batch(rng, 1, 500, 1024, H, W)
    rep, mask = jsteps.batch_representation(ev, "VoxelGrid", bins, H, W,
                                            fast=False)
    image = rng.uniform(0, 255, (1, H, W, 1)).astype(np.float32)
    src = jax.jit(model.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, image, mask, None, True)
    src = {"params": src["params"],
           "batch_stats": jax.tree_util.tree_map(
               lambda a: a + 0.25, src.get("batch_stats", {}))}
    dst = jax.tree_util.tree_map(lambda a: 0.5 * a - 0.125, src)
    return src, dst


def _port_model(variables):
    """The tiny stage-2 model with LightGlue's training heads, holding
    `variables`."""
    from ei_nexus_tpu_torch.flagship import stage2_config
    from ei_nexus_tpu_torch.models.eim import EIM
    model = EIM(stage2_config(tiny=True, dtype="float32")[0],
                training_heads=True)
    model.load_state_dict(load_jax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def surgery_checkpoints(tmp_path_factory):
    """The tiny stage-2 model's weights (it holds both subtrees: the event
    extractor with its running statistics, and LightGlue with its training
    heads) checkpointed by each package, and the receiving model's
    weights."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu.models import eim as jeim
    from ei_nexus_tpu.train import checkpoint as jck
    from ei_nexus_tpu_torch.train import checkpoint as tck
    from ei_nexus_tpu_torch.train.state import create_train_state

    root = tmp_path_factory.mktemp("surgery")
    jm0, (H, W, bins) = _flagship(tiny=True)
    jc = jm0.config
    jm = jeim.EIM(config=dataclasses.replace(
        jc, event_extractor=dataclasses.replace(jc.event_extractor,
                                                freeze=True)))
    src, dst = _jax_init(jm, H, W, bins)
    jpath = jck.save_checkpoint(str(root / "jax"), _jax_state(jm, src),
                                epoch=1)
    state = create_train_state(_port_model(src), (), {"type": "AdamW"},
                               {"type": "CosineAnnealingLR"}, 1e-3)
    tpath = tck.save_checkpoint(str(root / "port"), state, epoch=1)
    return jpath, tpath, dst


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_surgery_matches_jax(surgery_checkpoints, stage):
    """load_stage1_event_extractor (parameters and running statistics)
    and load_stage2_matcher (parameters) copy the same subtree from a
    checkpoint into another model's weights as the JAX package's do from
    its orbax checkpoint of the same weights."""
    from ei_nexus_tpu.train import checkpoint as jck
    from ei_nexus_tpu_torch.train import checkpoint as tck

    jpath, tpath, dst = surgery_checkpoints
    load = {1: "load_stage1_event_extractor", 2: "load_stage2_matcher"}
    want = load_jax_variables(getattr(jck, load[stage])(jpath, dst))
    got = getattr(tck, load[stage])(tpath, _port_model(dst)).state_dict()
    assert set(got) == set(want)
    root = "event_extractor." if stage == 1 else "matcher."
    before = load_jax_variables(dst)
    n_copied = 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
        if k.startswith(root) and not torch.equal(before[k], want[k]):
            n_copied += 1
        if not k.startswith(root):   # everything else left as it was
            assert torch.equal(got[k], before[k]), k
    assert n_copied > 0
    stats = [k for k in got if k.startswith(root)
             and k.endswith("running_var")]
    # stage 1 copies the running statistics too; the matcher has none
    assert bool(stats) == (stage == 1)
    assert all(not torch.equal(before[k], got[k]) for k in stats)


# ---------------------------------------------------------------------------
# the mini-EC renderer
# ---------------------------------------------------------------------------


def test_mini_ec_renderer_matches_the_tool(tmp_path, monkeypatch):
    """`data/mini_ec.py:gen_sequence` writes the same events, poses,
    frame list, calibration and images as tools/make_mini_ec.py's for the
    same sequence, phase and seed (the tool's renderer globals are
    restored afterwards)."""
    import cv2
    import tools.make_mini_ec as jtool
    import tools.make_mini_mvsec as mm
    from ei_nexus_tpu_torch.data import mini_ec

    for name in ("W", "H", "FX", "FY", "CX", "CY", "FPS", "SUBSTEPS",
                 "C_THRESH", "_K_INV_RAYS"):
        monkeypatch.setattr(mm, name, getattr(mm, name))
    jtool._configure_renderer()
    n_want = jtool.gen_sequence(str(tmp_path / "tool"), "hdr_boxes", 5,
                                phase=0.7, seed=101)
    n_got = mini_ec.gen_sequence(str(tmp_path / "port"), "hdr_boxes", 5,
                                 phase=0.7, seed=101)
    assert n_got == n_want > 0
    a, b = tmp_path / "port" / "hdr_boxes", tmp_path / "tool" / "hdr_boxes"
    for f in ("events_corrected.npy", "groundtruth.npy"):
        np.testing.assert_array_equal(np.load(a / f), np.load(b / f),
                                      err_msg=f)
    for f in ("images.txt", "calib.txt"):
        assert (a / f).read_text() == (b / f).read_text(), f
    frames = sorted(p.name for p in (b / "images_corrected").iterdir())
    assert frames == sorted(p.name for p in
                            (a / "images_corrected").iterdir())
    assert len(frames) == 5
    for f in frames:
        np.testing.assert_array_equal(
            cv2.imread(str(a / "images_corrected" / f), 0),
            cv2.imread(str(b / "images_corrected" / f), 0), err_msg=f)


def test_mini_ec_refuses_unknown_sequences(tmp_path):
    from ei_nexus_tpu_torch.data import mini_ec
    with pytest.raises(ValueError, match="unknown"):
        mini_ec.make_mini_ec(str(tmp_path), 5, sequences=["no_such"])


# ---------------------------------------------------------------------------
# the augmented batch on the wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_augmented_batch_wire_matches_jax(monkeypatch, native):
    """An augmented (`pair_aug`) stage-1 batch through
    `compact_stage1_batch` and the decode, equal on both sides, out-of-crop
    slots included: the port keeps the JAX trainer's wire, whose events_n
    counts the valid events while out-of-crop ones (x = y = -1) still sit
    among the first n slots."""
    from ei_nexus_tpu_torch.data.augment import PairAugmentationEvents
    from ei_nexus_tpu_torch.data.pipeline import collate
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch

    if native:
        if jnative.lib() is None or tnative.lib() is None:
            pytest.skip("no C++ toolchain")
    else:
        monkeypatch.setattr(jnative, "compact_encode", lambda *a: None)
        monkeypatch.setattr(tnative, "compact_encode", lambda *a: None)
    H, W = 180, 240
    aug = PairAugmentationEvents(crop_size=(160, 160))
    rng = np.random.default_rng(8)
    ev = bursty_event_batch(rng, 3, 5000, 8192, H, W)
    views = []
    for b in range(3):
        view = {k: v[b] for k, v in ev.items()}
        view["image"] = rng.uniform(0, 255, (H, W, 1)).astype(np.float32)
        views.append(aug(view, rng=np.random.default_rng([0, 0, b])))
    batch = (collate(views),)
    out_of_crop = batch[0]["events_x"] < 0
    n_valid = batch[0]["events_valid"].sum(-1)
    assert (out_of_crop[:, :5000].sum(-1) > 0).all()
    assert (n_valid < 5000).all()

    want = jsteps.compact_stage1_batch(batch)
    got = tsteps.compact_stage1_batch(batch)
    assert len(got) == len(want) == 1
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        a, b = np.asarray(got[0][k]), np.asarray(want[0][k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(got[0]["events_n"], n_valid)
    dec_j = jax.jit(jsteps._decode_event_view)(
        {k: jnp.asarray(v) for k, v in want[0].items()})
    dec_t = tsteps._decode_event_view(got[0], "cpu")
    assert set(dec_t) == set(dec_j)
    for k in dec_j:
        np.testing.assert_array_equal(np.asarray(dec_t[k]),
                                      np.asarray(dec_j[k]), err_msg=k)
    # out-of-crop slots among the first n decode as valid, on both sides
    first = np.asarray(dec_t["events_valid"])
    assert (first & out_of_crop[:, :first.shape[1]]).any()


# ---------------------------------------------------------------------------
# the entry point over a rendered mini-EC
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mini_ec_root(tmp_path_factory):
    """The six EC training sequences, each a copy of one rendered at 203
    frames: the reader's [100:-100] crop of its valid frames leaves one
    sample a sequence, three batches of 2. (The renderer is held to the
    tool by the test above; the copies save five renders.)"""
    import shutil
    from ei_nexus_tpu_torch.data.ec import TRAIN_SEQUENCES
    from ei_nexus_tpu_torch.data.mini_ec import make_mini_ec
    root = tmp_path_factory.mktemp("mini_ec")
    first, *rest = TRAIN_SEQUENCES
    make_mini_ec(str(root), frames=203, sequences=[first])
    for seq in rest:
        shutil.copytree(root / first, root / seq)
    return root


def _run_entry(options, overrides, out):
    """Run the entry point in this process (options before the key=value
    overrides, as argparse wants them); returns (state, run directory,
    the rows of metrics.jsonl)."""
    from ei_nexus_tpu_torch import train_extractor
    state = train_extractor.main(
        options + overrides + [f"logger.output_dir={out}"])
    run, = [p for p in Path(out).iterdir() if p.is_dir()]
    rows = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    return state, run, rows


def _entry_args(root):
    options = ["--config", str(ROOT / "configs" /
                               "train_EIM_stage1_EC_SP_MNN.yaml"),
               "--device", "cpu"]
    overrides = [f"dataset.data_path={root}", "dataset.train.batch_size=2",
                 "dataset.train.num_workers=2", "logger.status_freq=1"]
    return options, overrides


def test_train_extractor_entry_runs_and_resumes(mini_ec_root, tmp_path):
    """`train_extractor.main` with --device cpu: 2 steps of the EC stage-1
    config at its 160x160 crops from the rendered mini-EC, a `final`
    checkpoint at step 2, finite logged losses; then --resume from it to
    step 3, in the middle of the epoch: the step counter continues at 3.
    (That a resumed run equals an uninterrupted one bit for bit is held
    at the step's level above.)"""
    options, overrides = _entry_args(mini_ec_root)
    state, run, rows = _run_entry(options + ["--max-steps", "2"], overrides,
                                  tmp_path / "a")
    final = run / "checkpoints" / "final"
    assert (final / "state.pt").is_file() and state.step == 2
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        for k in ("loss", "extractor_keypoints_loss",
                  "extractor_descriptor_loss", "feature_loss", "grad_norm"):
            assert np.isfinite(r[k]), (r["step"], k)
        assert r["dropped_splat_weight"] == 0.0
    assert (run / "config.yaml").is_file()
    log = (run / "log.txt").read_text()
    assert "training at 160x160" in log
    assert "6 samples, 3 steps/epoch" in log

    resumed, run_b, rows_b = _run_entry(
        options + ["--max-steps", "3", "--resume", str(final)], overrides,
        tmp_path / "b")
    assert [r["step"] for r in rows_b] == [3] and resumed.step == 3
    assert "resumed from" in (run_b / "log.txt").read_text()
    assert "@ epoch 0 batch 2" in (run_b / "log.txt").read_text()
    assert (run_b / "checkpoints" / "final" / "state.pt").is_file()


def test_train_extractor_refuses_superpoint_weights(mini_ec_root, tmp_path):
    from ei_nexus_tpu_torch import train_extractor
    options, overrides = _entry_args(mini_ec_root)
    with pytest.raises(NotImplementedError, match="port_torch"):
        train_extractor.main(options + overrides + [
            f"logger.output_dir={tmp_path}",
            "superpoint_weights=superpoint_v1.pth"])
