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

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ei_nexus_tpu",
             "__graft_entry__", "bench")


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
            "ei_nexus_tpu_torch.models.config_adapter; "
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
    from ei_nexus_tpu_torch import train_extractor
    with pytest.raises(RuntimeError, match="CUDA"):
        build_flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_stage2_flagship(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_stage1_flagship(tiny=True)
    from ei_nexus_tpu_torch.flagship import build_silk
    with pytest.raises(RuntimeError, match="CUDA"):
        build_silk(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_extractor.main(["--config", str(
            ROOT / "configs" / "train_EIM_stage1_EC_SP_MNN.yaml")])
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
    for bad in (dict(scan_layers=True), dict(depth_confidence=0.95),
                dict(shard_heads=True)):
        with pytest.raises(NotImplementedError):
            LightGlue(LightGlueConfig(**bad))
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
