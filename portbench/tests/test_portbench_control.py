"""The lower-precision control fails the cell's checks: the float32
reference with TF32 on, put in the program's place at the cell's own
size, judged against the reference in float32 with the cell's limits.
Needs the GPU (TF32 exists only there)."""

import pytest

from portbench.harness import common, serve, train
from portbench.harness.verdict import make_checks, verdict
from portbench.tools import readings

# every workload file, listed in BENCHMARK.json or not yet
CELLS = sorted(p.stem for p in (common.BENCH / "workloads").glob("*.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, need_cuda):
    common.prepare_environment()
    cell = common.load_cell(name)
    seed = 2 ** 31 + 4242
    if cell["traffic"]["kind"] == "serve_closed":
        sd, pool_np, kept = readings.serve_control(cell, seed, "cuda")
        found, failed = serve.judge(cell, sd, pool_np, kept, "cuda")
    else:
        found, failed = train.judge(
            cell, *readings.train_control(cell, seed, "cuda"), "cuda")
    found["failed"] = failed
    assert verdict(make_checks(found, cell["limits"])) is False
