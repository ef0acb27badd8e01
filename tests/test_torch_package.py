"""Boundary of the port: it imports nothing of JAX or of the JAX package,
and its entry points run on the card or raise; they never fall back to the
CPU unless the caller asks for it."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ei_nexus_tpu",
             "__graft_entry__", "bench")


# the port's `python -m` entry points
ENTRIES = ("train_extractor", "train_matcher", "val_extractor",
           "val_matcher", "test_events_image_same_time",
           "test_events_image_different_time")


def _port_files():
    return sorted((ROOT / "ei_nexus_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path):
    """Absolute module names imported anywhere in a file (relative imports
    stay inside the port)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        # ei_nexus_tpu_torch starts with "ei_nexus_tpu": compare whole names
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, chip_smoke, ei_nexus_tpu_torch.flagship, "
            "ei_nexus_tpu_torch.models, ei_nexus_tpu_torch.data.synth, "
            "ei_nexus_tpu_torch.train.steps, ei_nexus_tpu_torch.geometry, "
            "ei_nexus_tpu_torch.losses, ei_nexus_tpu_torch.train.state, "
            "ei_nexus_tpu_torch.metrics, ei_nexus_tpu_torch.train, "
            "ei_nexus_tpu_torch.train_extractor, "
            "ei_nexus_tpu_torch.data.mini_ec, ei_nexus_tpu_torch.utils, "
            "ei_nexus_tpu_torch.models.config_adapter, "
            + ", ".join(f"ei_nexus_tpu_torch.{m}" for m in ENTRIES)
            + ", ei_nexus_tpu_torch.train.evaluate, "
            "ei_nexus_tpu_torch.train.loop, "
            "ei_nexus_tpu_torch.data.val_pairs, "
            "ei_nexus_tpu_torch.ops.homographic, "
            "ei_nexus_tpu_torch.models.port_torch, "
            "ei_nexus_tpu_torch.models.pointnet, "
            "ei_nexus_tpu_torch.geometry.triangulation, "
            "ei_nexus_tpu_torch.parallel.ba, ei_nexus_tpu_torch.parallel.slam, "
            "ei_nexus_tpu_torch.parallel.mesh, "
            "ei_nexus_tpu_torch.parallel.collectives, "
            "ei_nexus_tpu_torch.parallel.dryrun, "
            "ei_nexus_tpu_torch.data.rectify, ei_nexus_tpu_torch.utils.setup, "
            "ei_nexus_tpu_torch.utils.profiling, "
            "ei_nexus_tpu_torch.utils.image_io, "
            "ei_nexus_tpu_torch.utils.visualize, "
            "ei_nexus_tpu_torch.data.mini_mvsec, "
            "ei_nexus_tpu_torch.slam_mvsec, ei_nexus_tpu_torch.eval_adaptive; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_default_to_the_card():
    """Without a card, an entry point called without `device=` raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    from ei_nexus_tpu_torch.flagship import build_flagship, flagship_config
    from ei_nexus_tpu_torch.models.eim import build_model
    from ei_nexus_tpu_torch.train.steps import batch_representation

    from ei_nexus_tpu_torch.flagship import (build_stage1_flagship,
                                             build_stage2_flagship)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_stage2_flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_stage1_flagship(tiny=True)
    from ei_nexus_tpu_torch.flagship import build_silk
    with pytest.raises(RuntimeError, match="CUDA"):
        build_silk(tiny=True)
    import importlib
    for name in ENTRIES:
        entry = importlib.import_module(f"ei_nexus_tpu_torch.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.main(["--config", str(
                ROOT / "configs" / "train_EIM_stage1_EC_SP_MNN.yaml")])
    # the tools: the SLAM chain on MVSEC and the adaptive evaluation
    from ei_nexus_tpu_torch import eval_adaptive, slam_mvsec
    with pytest.raises(RuntimeError, match="CUDA"):
        slam_mvsec.main(["--ckpt", "unread"])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_adaptive.main(["--config", str(
            ROOT / "configs" / "train_EIM_stage2.yaml"), "--ckpt", "unread"])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("EIM", flagship_config(tiny=True)[0])
    ev = bursty_event_batch(np.random.default_rng(0), 1, 10, 16, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_representation(ev, "VoxelGrid", 4, 8, 8)
    from ei_nexus_tpu_torch.metrics import estimate_pose_batch_from_matches
    pos = np.zeros((1, 8, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate_pose_batch_from_matches(pos, pos, np.zeros((1, 8), int),
                                         np.eye(3)[None], np.eye(3)[None],
                                         1.0)
    from ei_nexus_tpu_torch.metrics import (RelativePoseEstimation,
                                            estimate_pose_torch)
    with pytest.raises(RuntimeError, match="CUDA"):
        estimate_pose_torch(pos[0], pos[0], 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        RelativePoseEstimation("RPE", [5], backend="torch").update_one(
            pos[0], pos[0], np.eye(3), np.eye(3), np.eye(4))
    from ei_nexus_tpu_torch.data.val_pairs import pair_overlap_ratio
    with pytest.raises(RuntimeError, match="CUDA"):
        pair_overlap_ratio(np.ones((8, 8)), np.ones((8, 8)), np.eye(3),
                           np.eye(4), np.eye(4))
    from ei_nexus_tpu_torch.train.evaluate import build_eval_model
    with pytest.raises(RuntimeError, match="CUDA"):
        build_eval_model({"name": "EIM", "event_extractor": {"type": "vgg"},
                          "image_extractor": {"type": "superpointv1"},
                          "matcher": {"type": "MNN"}})
    from ei_nexus_tpu_torch.geometry import Camera, Pose
    from ei_nexus_tpu_torch.parallel.slam import (Keyframe, build_ba_problem,
                                                  refine_map)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_ba_problem([], [])
    kf = Keyframe(np.zeros((2, 3), np.float32), np.ones(2, bool), np.eye(4),
                  np.eye(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        refine_map([kf, kf], [np.arange(2)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Pose.identity()
    with pytest.raises(RuntimeError, match="CUDA"):
        Camera.from_params(8, 8, 1.0, 1.0, 4.0, 4.0)
    from ei_nexus_tpu_torch.parallel import dryrun, mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.distributed_init()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--world", "2", "--model", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.launch(print, 2)
    # asking for the CPU works
    model, _ = build_flagship(tiny=True, dtype="float32", device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_flagship_weights_come_from_the_generator():
    from ei_nexus_tpu_torch.flagship import build_flagship

    def weights(seed):
        m, _ = build_flagship(tiny=True, dtype="float32", device="cpu",
                              generator=torch.Generator().manual_seed(seed))
        return m.state_dict()

    a, b, c = weights(5), weights(5), weights(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_unported_paths_raise():
    import dataclasses
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.models.eim import EIM, Matcher, MatcherConfig
    from ei_nexus_tpu_torch.models.lightglue import (LightGlue,
                                                     LightGlueConfig)

    with pytest.raises(NotImplementedError):
        Matcher(MatcherConfig(type="SuperGlue"))
    # adaptive inference, scanned layers and tensor-parallel heads are
    # ported: they build, with the heads their JAX inits create
    for ok, heads, tokens in ((dict(scan_layers=True), 9, 0),
                              (dict(depth_confidence=0.95), 9, 8),
                              (dict(width_confidence=0.99), 9, 8),
                              (dict(shard_heads=True), 1, 0)):
        lg = LightGlue(LightGlueConfig(**ok))
        assert len(lg.log_assignment) == heads
        assert len(lg.token_confidence) == tokens
    # under a model group of 2 the heads must divide by 2 (the mesh's
    # groups are not read at construction)
    from ei_nexus_tpu_torch.parallel.mesh import Mesh, use_mesh
    with use_mesh(Mesh(data=1, model=2, data_index=0, model_index=0,
                       device=torch.device("cpu"))):
        LightGlue(LightGlueConfig(shard_heads=True, num_heads=4))
        with pytest.raises(ValueError, match="do not divide"):
            LightGlue(LightGlueConfig(shard_heads=True, num_heads=3,
                                      descriptor_dim=255, input_dim=255))
    cfg, _ = flagship_config(tiny=True, dtype="float32")
    with pytest.raises(ValueError, match="unknown extractor type"):
        EIM(dataclasses.replace(cfg, image_extractor=dataclasses.replace(
            cfg.image_extractor, type="superpointv2")))


def test_unported_training_options_raise():
    from ei_nexus_tpu_torch.flagship import build_stage2_flagship
    from ei_nexus_tpu_torch.train.optim import (build_optimizer,
                                                build_schedule)

    sched = build_schedule({"type": "CosineAnnealingLR"}, 1e-4)
    params = [torch.nn.Parameter(torch.zeros(2))]
    # every optimizer and schedule of the JAX package is ported; other
    # names raise
    for otype in ("Adam", "SGD", "AdamW"):
        build_optimizer({"type": otype}, params, sched)
    for otype in ("RMSprop", "Adagrad"):
        with pytest.raises(NotImplementedError):
            build_optimizer({"type": otype}, params, sched)
    for stype in ("StepLR", "OneCycleLR", "ReduceLROnPlateau"):
        build_schedule({"type": stype}, 1e-4)
    for stype in ("PolynomialLR", "LambdaLR"):
        with pytest.raises(NotImplementedError):
            build_schedule({"type": stype}, 1e-4)
    # an inference-built LightGlue has only the last layer's head
    model, (H, W, bins) = build_stage2_flagship(tiny=True, dtype="float32",
                                                device="cpu")
    lg = model.matcher.lightglue
    assert sorted(lg.log_assignment) == ["0", "1"]
    assert sorted(lg.token_confidence) == ["0"]
    from ei_nexus_tpu_torch.models.lightglue import LightGlue
    with pytest.raises(ValueError, match="training_heads"):
        LightGlue(lg.config)({}, {}, training=True)


def test_kernel_library_names_track_their_sources():
    """A library's file name carries a digest of its sources, so an edited
    kernel is rebuilt rather than a stale build loaded."""
    from ei_nexus_tpu_torch.ops import cuda_build
    paths = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == cuda_build.BUILD_DIR
        assert (cuda_build.CSRC / cuda_build.SOURCES[name]).is_file()
        assert set(cuda_build.SIGNATURES[name])  # declared entry points
