"""`python -m ei_nexus_tpu_torch.slam_mvsec` against tools/slam_mvsec.py,
on the CPU, over a mini-MVSEC sequence rendered into a temporary
directory (indoor_flying1, 14 frames: shorter than its crop, so the
readers keep it whole) with `--frames 6 --topk 64`.

The stage-1 weights are one seeded JAX init of the flagship event
extractor (VGG 128/256/256, its BatchNorm variances raised), saved with
the JAX package's `save_checkpoint`; the JAX tool reads that orbax
checkpoint, the port's the `.npz` tools/export_jax_checkpoint.py writes
from it. The JAX tool runs with its voxel grid as the exact scatter
(fast=False, the port's) and without `--check-sharded` (it sets XLA_FLAGS
before importing JAX, which this process has imported).

Held: the JSON keys; keyframes, MNN matches a pair, landmarks and
observations equal; the ATE before BA to rtol 1e-5 and the first robust
cost to rtol 1e-5 (the same front end and triangulation, float32); the
last robust cost and the ATE after to rtol 1e-3, BA's float32 noise once
both solves have converged (tests/test_torch_ba.py): the solve runs 25
LM iterations, since at 3 the two sides sit at different points of the
way (on this problem of a few landmarks the JAX package's own solve
moves its early costs when its points move at float32 noise: an LM step
accepted on one side and refused on the other). The port's
`--check-sharded` over 2 gloo ranks: the final cost within 1.5e-3
relative of one process's.
"""

import contextlib
import io
import json
import types

import numpy as np
import pytest
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ARGS = ["--device", "cpu", "--frames", "6", "--topk", "64", "--iters", "25"]


@pytest.fixture(scope="module")
def mini_mvsec(tmp_path_factory):
    from ei_nexus_tpu_torch.data.mini_mvsec import make_mini_mvsec
    root = tmp_path_factory.mktemp("mini_mvsec")
    make_mini_mvsec(str(root), train_frames=14, sequences=["indoor_flying1"])
    return root


@pytest.fixture(scope="module")
def stage1_checkpoint(tmp_path_factory):
    """(orbax checkpoint, exported .npz) of a seeded stage-1 event
    extractor: params and batch_stats under `event_extractor`."""
    import jax
    import jax.numpy as jnp
    from ei_nexus_tpu.models import KeypointExtractorConfig, VGGExtractor
    from ei_nexus_tpu.train.checkpoint import save_checkpoint
    from tools.export_jax_checkpoint import export

    model = VGGExtractor(config=KeypointExtractorConfig(detection_top_k=64),
                         feat_channels=128, descriptor_dim=256,
                         lat_channels=256)
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 260, 346, 16)), None)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.abs(
            rng.normal(size=a.shape)).astype(np.float32), v["batch_stats"])
    state = types.SimpleNamespace(
        params={"event_extractor": v["params"]},
        batch_stats={"event_extractor": stats},
        opt_state={"count": np.zeros((), np.int32)}, step=np.asarray(0))
    tmp = tmp_path_factory.mktemp("stage1")
    path = save_checkpoint(str(tmp), state, 0, "final")
    export(path, str(tmp / "final.npz"))
    return path, str(tmp / "final.npz")


def _last_json(fn, argv, lines=1):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(argv)
    text = out.getvalue().strip().splitlines()
    return ret, [json.loads(x) for x in text[-lines:]]


def test_slam_tool_matches_the_jax_tool(mini_mvsec, stage1_checkpoint,
                                        monkeypatch):
    import tools.slam_mvsec as jtool
    from ei_nexus_tpu.parallel import ba as jba
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.utils import cache
    from ei_nexus_tpu_torch import slam_mvsec

    exact = jsteps.batch_representation
    monkeypatch.setattr(jsteps, "batch_representation",
                        lambda *a, **k: exact(*a, fast=False, **k))
    monkeypatch.setattr(cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    seen = {"jax_costs": [], "jax_ate": [], "ate": [], "runs": []}

    def recording(fn, key):
        def call(*a, **k):
            out = fn(*a, **k)
            seen[key].append(out)
            return out
        return call

    monkeypatch.setattr(jba, "ba_solve", recording(jba.ba_solve,
                                                   "jax_costs"))
    monkeypatch.setattr(jtool, "umeyama_ate", recording(jtool.umeyama_ate,
                                                        "jax_ate"))
    monkeypatch.setattr(slam_mvsec, "umeyama_ate",
                        recording(slam_mvsec.umeyama_ate, "ate"))
    monkeypatch.setattr(slam_mvsec, "slam_chain",
                        recording(slam_mvsec.slam_chain, "runs"))

    orbax, npz = stage1_checkpoint
    data = ["--data", str(mini_mvsec)]
    _, (want,) = _last_json(jtool.main, ["--ckpt", orbax] + data + ARGS)
    got, (printed, sharded) = _last_json(
        slam_mvsec.main, ["--ckpt", npz, "--check-sharded"] + data + ARGS,
        lines=2)

    assert list(printed) == list(want)
    assert got["sharded"] == sharded
    assert list(sharded) == ["sharded_check", "final_cost_single",
                             "final_cost_sharded", "ate_after_sharded_m"]
    for k in ("sequence", "keyframes", "landmarks", "observations",
              "mnn_matches_per_pair", "reproj_median_px_and_frac3px_before"):
        assert printed[k] == want[k], k
    assert want["keyframes"] == 6 and want["landmarks"] >= 5
    (_, run), = seen["runs"]
    jcosts = np.asarray(seen["jax_costs"][0][1])
    costs = run["costs"]
    assert len(costs) == len(jcosts) == 26
    np.testing.assert_allclose(costs[0], jcosts[0], rtol=1e-5)
    np.testing.assert_allclose(costs[-1], jcosts[-1], rtol=1e-3)
    # umeyama_ate's calls: before, after (and, port, after the sharded
    # solve)
    np.testing.assert_allclose(seen["ate"][0], seen["jax_ate"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(seen["ate"][1], seen["jax_ate"][1],
                               rtol=1e-3)
    single, split = sharded["final_cost_single"], \
        sharded["final_cost_sharded"]
    assert abs(split - single) <= 1.5e-3 * single, (single, split)
    assert costs[-1] < costs[0]


def test_slam_tool_defaults_to_the_card(mini_mvsec, stage1_checkpoint):
    """Without --device the tool asks for the card and raises here."""
    import torch
    from ei_nexus_tpu_torch import slam_mvsec
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        slam_mvsec.main(["--ckpt", stage1_checkpoint[1], "--data",
                         str(mini_mvsec)])


def test_slam_chain_lowers_the_ate_on_exact_tracks():
    """`slam_chain` on chip_smoke.py phase 15a's frames (indoor_flying1
    rendered in memory, read through the MVSEC reader, 40 keyframes at
    stride 2) with its `ExactFrontEnd` (tracks right to 0.5 px): the
    robust cost and the ATE fall, and `check_sharded`'s solve over 2
    gloo ranks ends within 1.5e-3 of one process's."""
    import chip_smoke as cs
    from ei_nexus_tpu_torch import slam_mvsec
    from ei_nexus_tpu_torch.data import mini_mvsec
    from ei_nexus_tpu_torch.data.mvsec import MVSECSequence

    arrays = mini_mvsec.render_sequence(cs.SLAM_MVSEC_FRAMES, 0.0, 10)
    seq = MVSECSequence(mini_mvsec.RenderedArchive(
        {"indoor_flying1": arrays}), "indoor_flying1")
    frames = [seq.view(cs.SLAM_MVSEC_FIRST + cs.SLAM_MVSEC_STRIDE * i,
                       slam_mvsec.EVENT_DT, slam_mvsec.MAX_EVENTS)
              for i in range(cs.SLAM_KF)]
    metrics, run = slam_mvsec.slam_chain(
        frames, cs.ExactFrontEnd(frames, device="cpu"),
        iters=cs.SLAM_MVSEC_ITERS)
    assert metrics["keyframes"] == cs.SLAM_KF and metrics["landmarks"] > 100
    costs = run["costs"]
    assert np.isfinite(costs).all() and costs[-1] < 0.2 * costs[0]
    before, after = (slam_mvsec.umeyama_ate(slam_mvsec.centers_from_poses6(
        p.poses.numpy()), run["gt_centers"])
        for p in (run["problem"], run["refined"]))
    assert after < before
    sharded = slam_mvsec.check_sharded(run)
    single = sharded["final_cost_single"]
    assert abs(sharded["final_cost_sharded"] - single) <= 1.5e-3 * single
