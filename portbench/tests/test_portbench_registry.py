"""Every cell of BENCHMARK.json resolves by name to its files: the
workload, its configuration with a plain reference, its traffic mix with
a driver, its limits, and a reader for each per-layer metric."""

import json

import pytest

from portbench import run as bench_run
from portbench.harness import common

BENCH = json.loads((common.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = common.load_cell(name)
    assert cell["config_name"] == entry["config"]
    assert cell["traffic_name"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
    assert cell["traffic"]["kind"] in bench_run.DRIVERS
    ref = common.reference_module(entry["config"])
    for fn in ("representation", "extract_pair", "match", "stage2_steps"):
        assert callable(getattr(ref, fn))
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"portbench/configs/{entry['config']}.json"
    assert cell["config"]["reduced"] == conf["reduced"]
    assert cell["limits"]["failed"] == 0
    e2e, per = bench_run.applicable(name, {}, BENCH)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for metric in per:
        assert callable(common.metric_reader(metric))


def test_every_metric_and_config_is_used():
    names = set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= names
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        common.metric_reader(m["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_readers_return_nothing_without_a_trace():
    ctx = {"role": "serve", "host_s": [], "window_s": 0}
    for m in BENCH["per_layer"]:
        assert common.metric_reader(m["name"])(ctx) is None
