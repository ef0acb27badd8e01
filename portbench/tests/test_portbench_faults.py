"""A run with its timed path broken underneath reads `correct` false: each
fault a cell can have (`tools/faults.py`), the look for a chip skipped,
the rest of the run driven on the CPU at the tests' sizes."""

import time

import pytest

from portbench import run as bench_run
from portbench.harness import common
from portbench.reference import nets
from portbench.tools.faults import ROLES, plant

CELLS = {"serve": "eim_sp_lg.serve_b16", "train": "eim_sp_lg.train_s2_b8"}
CAUGHT_BY = {"unchanged_state": "update_gap", "half_batch": "loss_gap",
             "altered_gt": "loss_gap", "altered_match": "la_gap",
             "altered_keypoint": "desc_gap.event"}


@pytest.mark.parametrize("fault", sorted(ROLES))
def test_fault_fails_the_run(fault, monkeypatch):
    monkeypatch.setattr(nets, "CROSS_MASK", "joint")
    common.prepare_environment()
    cell = common.tiny_cell(CELLS[ROLES[fault]])
    with plant(fault):
        line = bench_run.execute(cell, 1234567, 0.5, False, "cpu",
                                 time.perf_counter())
    assert line["correct"] is False
    c = line["checks"][CAUGHT_BY[fault]]
    assert c["value"] > c["limit"], (fault, c)
