"""The plain reference against the port's CPU path at the tests' sizes,
for both configurations: a whole served run and a whole stage-2 run of the
harness (the look for a chip skipped), judged by the benchmark's own
comparison. At these sizes the port takes its einsum attention, whose
cross-attention masks jointly, so the reference does the same here."""

import time

import pytest

from portbench import run as bench_run
from portbench.harness import common
from portbench.reference import nets

# float32 on the CPU: the same operations in the same order, bar the
# reductions' order inside the attention and the optimizer's foreach
TIGHT = 1e-5


@pytest.fixture
def joint_mask(monkeypatch):
    monkeypatch.setattr(nets, "CROSS_MASK", "joint")


def run_tiny(name: str, seed: int, config: str = None) -> dict:
    common.prepare_environment()
    cell = common.tiny_cell(name, config)
    return bench_run.execute(cell, seed, 0.5, False, "cpu",
                             time.perf_counter())


@pytest.mark.parametrize("config", ["eim_sp_lg", "silk_lg"])
def test_serving_agrees(config, joint_mask):
    line = run_tiny("eim_sp_lg.serve_b16", 2 ** 31 + 7, config)
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    for check, c in line["checks"].items():
        assert c["value"] <= TIGHT, check
    assert set(line["checks"]) >= {"la_gap", "desc_gap.event",
                                   "kp_score_gap.event", "score_gap_median.image"}
    assert line["metrics"]["setup_s"]["value"] > 0


def test_stage2_step_agrees():
    line = run_tiny("eim_sp_lg.train_s2_b8", 3_000_000_019)
    assert line["correct"] is True
    for check, c in line["checks"].items():
        assert c["value"] <= TIGHT, check
    assert set(line["checks"]) >= {"loss_gap", "grad_gap", "update_gap",
                                   "desc_gap.event"}


def test_same_seed_same_work():
    a = common.seeds(2 ** 31 + 99)
    assert a == common.seeds(2 ** 31 + 99)
    assert a != common.seeds(2 ** 31 + 100)
    from portbench.harness import data
    mix = common.tiny_cell("eim_sp_lg.serve_b16")["traffic"]
    p1 = data.serve_pool(a["pool"], mix, 32, 48)
    p2 = data.serve_pool(common.seeds(5)["pool"], mix, 32, 48)
    assert all((p1[0][k] == data.serve_pool(a["pool"], mix, 32, 48)[0][k])
               .all() for k in p1[0])
    # every seed gives the same amount of work
    assert [v.shape for v in p1[0].values()] == \
        [v.shape for v in p2[0].values()]
    assert p1[0]["events_valid"].sum() == p2[0]["events_valid"].sum()


@pytest.mark.parametrize("config", ["eim_sp_lg", "silk_lg"])
def test_own_descriptors_sit_at_own_keypoints(config):
    """At a frame that the cell-8 extractors pad (30 x 46), the reference's
    own descriptors are its descriptor map sampled at its own keypoints,
    in image coordinates, as the comparison samples it."""
    import torch
    from portbench.harness.serve import build_model
    cell = common.tiny_cell("eim_sp_lg.serve_b16", config)
    model_dict = cell["config"]["model"]
    model, _ = build_model(model_dict, "cpu")
    sd = common.init_weights(model, 11, "cpu")
    ref = common.reference_module(config)
    gen = torch.Generator().manual_seed(5)
    H, W, bins = 30, 46, cell["config"]["shape"]["bins"]
    voxel = torch.randn(2, H, W, bins, generator=gen)
    occ = torch.rand(2, H, W, generator=gen) < 0.8
    image = torch.rand(2, H, W, 1, generator=gen) * 255
    with torch.no_grad():
        for out in ref.extract_pair(model_dict, sd, voxel, occ, image):
            assert out["valid"].any()
            again = out["describe"](out["positions"][..., :2])
            assert torch.equal(out["descriptors"], again)
