"""The port's stage-2 entry point and evaluation entry points on the CPU,
over a rendered mini-EC and a tiny model: `python -m
ei_nexus_tpu_torch.train_matcher` (the homography route on EC, which has
no depth; the pose + depth route on a dataset with depth; the stage-1
event extractor loaded only from a checkpoint that exists; an exact
resume), then `val_extractor`, `val_matcher`,
`test_events_image_same_time` and `test_events_image_different_time`
(both RANSAC backends) with `--device cpu --max-batches 1`, each printing
its JSON dict.

The entries run in this process (options before the key=value overrides,
as argparse wants them). The model is the configs' at tiny sizes: 4
bins, descriptors 32, 32 keypoints in 32 slots, 2 LightGlue layers
(`TINY`); the event VGG keeps SuperPoint's backbone width, 128, which
the stage-1 feature loss compares.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
STAGE1 = str(ROOT / "configs" / "train_EIM_stage1_EC_SP_MNN.yaml")
STAGE2 = str(ROOT / "configs" / "train_EIM_stage2.yaml")
TINY = ["dataset.channel=4", "model.event_extractor.vgg.in_channels=4",
        "model.event_extractor.vgg.descriptor_dim=32",
        "model.event_extractor.vgg.detection_top_k=32",
        "model.image_extractor.superpointv1.descriptor_dim=32",
        "model.image_extractor.superpointv1.detection_top_k=32",
        "model.matcher.max_points_num=32",
        "model.matcher.LightGlue.input_dim=32",
        "model.matcher.LightGlue.descriptor_dim=32",
        "model.matcher.LightGlue.n_layers=2"]
TRAIN = ["dataset.train.batch_size=2", "dataset.train.num_workers=2",
         "logger.status_freq=1"]


@pytest.fixture(scope="module")
def mini_ec(tmp_path_factory):
    """A mini-EC of every sequence: one training sequence rendered at 203
    frames (one sample after the reader's [100:-100] crop) and one
    validation sequence at 208 (one pair, 6 frames apart), each copied to
    the other names of its split with its pair file (the renderer is held
    to the tool in tests/test_torch_entry.py; the copies save renders)."""
    from ei_nexus_tpu_torch.data.ec import TRAIN_SEQUENCES, VAL_SEQUENCES
    from ei_nexus_tpu_torch.data.mini_ec import make_mini_ec
    root = tmp_path_factory.mktemp("mini_ec")
    for frames, (first, *rest) in ((203, TRAIN_SEQUENCES),
                                   (208, VAL_SEQUENCES)):
        make_mini_ec(str(root), frames=frames, sequences=[first])
        for seq in rest:
            shutil.copytree(root / first, root / seq)
            if (root / f"new_{first}_val.txt").exists():
                shutil.copy(root / f"new_{first}_val.txt",
                            root / f"new_{seq}_val.txt")
    return root


def _train(module, options, overrides, out):
    """Run a training entry; returns (state, run directory, metrics rows,
    log text)."""
    state = module.main(options + overrides + [f"logger.output_dir={out}"])
    run, = [p for p in Path(out).iterdir() if p.is_dir()]
    rows = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    return state, run, rows, (run / "log.txt").read_text()


def _stage2(root, options, out, extra=()):
    from ei_nexus_tpu_torch import train_matcher
    return _train(train_matcher, ["--config", STAGE2, "--device", "cpu"]
                  + options, ["dataset=ec", f"dataset.data_path={root}"]
                  + TINY + TRAIN + list(extra), out)


@pytest.fixture(scope="module")
def stage1_final(mini_ec, tmp_path_factory):
    """A stage-1 `final` checkpoint of the tiny event extractor: one step
    of the EC stage-1 entry."""
    from ei_nexus_tpu_torch import train_extractor
    _, run, _, _ = _train(
        train_extractor, ["--config", STAGE1, "--device", "cpu",
                          "--max-steps", "1"],
        [f"dataset.data_path={mini_ec}"] + TINY + TRAIN,
        tmp_path_factory.mktemp("stage1"))
    return run / "checkpoints" / "final"


@pytest.fixture(scope="module")
def stage2_run(mini_ec, stage1_final, tmp_path_factory):
    """Two steps of the stage-2 entry on EC from the stage-1 checkpoint."""
    return _stage2(mini_ec, ["--max-steps", "2", "--stage1-ckpt",
                             str(stage1_final)],
                   tmp_path_factory.mktemp("stage2"))


def test_train_matcher_homography_route(stage2_run, stage1_final):
    """EC has no depth: the homography step runs, on the 180x240 grid
    (dataset.resolution, no crop clamp), with finite logged values at
    steps 1 and 2 and a `final` checkpoint at step 2; the stage-1
    checkpoint's event extractor is loaded (parameters and statistics
    equal to the file's: it stays frozen)."""
    state, run, rows, log = stage2_run
    assert "homography-supervised stage 2" in log
    assert "grid 180x240" in log
    assert "loaded stage-1 event extractor" in log
    assert [r["step"] for r in rows] == [1, 2] and state.step == 2
    for r in rows:
        assert all(np.isfinite(v) for v in r.values()), r
    assert (run / "checkpoints" / "final" / "state.pt").is_file()
    want = torch.load(stage1_final / "state.pt", weights_only=True)["model"]
    got = state.model.state_dict()
    ev = [k for k in want if k.startswith("event_extractor.")]
    assert ev and all(torch.equal(got[k], want[k]) for k in ev)


def test_train_matcher_resume_continues_the_stream(mini_ec, stage1_final,
                                                   stage2_run, tmp_path):
    """--resume from step 2's `final` to step 3 gives the loss and the
    parameters that an uninterrupted 3-step run from the same start has
    at step 3: the loader's epoch stream and the step's draws are keyed by
    the step."""
    _, run, _, _ = stage2_run
    final = run / "checkpoints" / "final"
    resumed, _, rows, log = _stage2(
        mini_ec, ["--max-steps", "3", "--resume", str(final)],
        tmp_path / "b")
    assert "resumed from" in log and "@ epoch 0 batch 2" in log
    assert [r["step"] for r in rows] == [3] and resumed.step == 3
    whole, _, rows3, _ = _stage2(
        mini_ec, ["--max-steps", "3", "--stage1-ckpt", str(stage1_final)],
        tmp_path / "c")
    assert [r["step"] for r in rows3] == [1, 2, 3]
    assert rows3[2] == rows[0]
    a, b = resumed.model.state_dict(), whole.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_matcher_stage1_checkpoint_only_where_it_exists(mini_ec,
                                                              tmp_path):
    """An absent --stage1-ckpt (and the config's placeholder path) trains
    on from the seed's weights, as the JAX entry does."""
    _, _, rows, log = _stage2(mini_ec, ["--max-steps", "1", "--stage1-ckpt",
                                        str(tmp_path / "absent")],
                              tmp_path / "a")
    assert "loaded stage-1" not in log and [r["step"] for r in rows] == [1]


class _DepthPairs:
    """A map-style dataset with depth: (data0, data1, T01, T10) samples of
    `data.synth.stage2_batch` at EC's grid."""

    def __init__(self, n=4, H=180, W=240):
        from ei_nexus_tpu_torch.data.synth import stage2_batch
        d0, d1, T01, T10 = stage2_batch(np.random.default_rng(0), n, 2000,
                                        4096, H, W, focal=150.0)
        self.samples = [({k: v[i] for k, v in d0.items()},
                         {k: v[i] for k, v in d1.items()}, T01[i], T10[i])
                        for i in range(n)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def test_train_matcher_takes_pose_depth_step_with_depth(mini_ec, tmp_path,
                                                        monkeypatch):
    """Samples that carry depth take the pose + depth step."""
    from ei_nexus_tpu_torch.data import ec
    monkeypatch.setattr(ec, "fetch_ec_dataset",
                        lambda cfg, split: _DepthPairs())
    state, _, rows, log = _stage2(mini_ec, ["--max-steps", "2"],
                                  tmp_path)
    assert "pose + depth supervised stage 2" in log
    assert "homography" not in log
    assert [r["step"] for r in rows] == [1, 2] and state.step == 2
    assert all(np.isfinite(r["loss"]) for r in rows)


def _eval(module, options, overrides, capsys):
    capsys.readouterr()
    out = module.main(options + ["--device", "cpu", "--max-batches", "1"]
                      + overrides)
    printed = json.loads(capsys.readouterr().out)
    assert printed.keys() == out.keys()
    return printed


@pytest.mark.parametrize("backend", ["opencv", "torch"])
def test_rpe_entry_runs(mini_ec, stage2_run, backend, capsys):
    from ei_nexus_tpu_torch import test_events_image_different_time as entry
    final = stage2_run[1] / "checkpoints" / "final"
    out = _eval(entry, ["--config", STAGE2, "--ckpt", str(final),
                        "--backend", backend],
                ["dataset=test_ec", f"dataset.data_path={mini_ec}"] + TINY,
                capsys)
    assert out["n_pairs"] == 1
    assert all(np.isfinite(out[f"RPE@{t}_auc"]) for t in (5, 10, 20))


def test_val_matcher_entry_runs(mini_ec, stage2_run, capsys):
    """EC has no depth: the loss part stops at once, the RPE part runs."""
    from ei_nexus_tpu_torch import val_matcher
    final = stage2_run[1] / "checkpoints" / "final"
    out = _eval(val_matcher, ["--config", STAGE2, "--ckpt", str(final)],
                ["dataset=test_ec", f"dataset.data_path={mini_ec}"] + TINY,
                capsys)
    assert out["n_pairs"] == 1 and "matcher_loss" not in out


@pytest.mark.parametrize("entry", ["val_extractor",
                                   "test_events_image_same_time"])
def test_extractor_entries_run(mini_ec, stage1_final, entry, capsys):
    import importlib
    module = importlib.import_module(f"ei_nexus_tpu_torch.{entry}")
    out = _eval(module, ["--config", STAGE1, "--ckpt", str(stage1_final)],
                [f"dataset.data_path={mini_ec}"] + TINY, capsys)
    for k in ("R@1", "R@3", "MR", "HE@3_auc"):
        assert k in out and np.isfinite(out[k]), k


def test_eval_entries_refuse_reference_checkpoints(mini_ec, tmp_path,
                                                   capsys):
    """A reference `.pth` is no longer refused: the tiny model's weights
    from another seed, written in the reference's layout, load into the
    eval model bit for bit, and the entry evaluates them."""
    from ei_nexus_tpu_torch import test_events_image_different_time as entry
    from ei_nexus_tpu_torch.models.port_torch import to_reference_layout
    from ei_nexus_tpu_torch.train.evaluate import build_eval_model
    from ei_nexus_tpu_torch.utils import load_config
    overrides = ["dataset=test_ec", f"dataset.data_path={mini_ec}"] + TINY
    model_dict = load_config(STAGE2, overrides).model.to_dict()
    src = build_eval_model(model_dict, device="cpu", seed=5)
    path = tmp_path / "eim.pth"
    torch.save(to_reference_layout(src.state_dict()), path)
    got = build_eval_model(model_dict, str(path), "cpu").state_dict()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
    out = _eval(entry, ["--config", STAGE2, "--ckpt", str(path)], overrides,
                capsys)
    assert out["n_pairs"] == 1
    assert all(np.isfinite(out[f"RPE@{t}_auc"]) for t in (5, 10, 20))
