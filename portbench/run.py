"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. The cell (`workloads/<cell>.json`) names its configuration
(`configs/<config>.json`, with its plain reference `reference/<config>.py`)
and its traffic mix (`traffic/<mix>.json`, whose `kind` picks the driver
in `harness/`). With `--trace 0` the line carries the cell's end-to-end
metrics of `BENCHMARK.json`; with `--trace 1` its per-layer metrics, each
read by `metrics/<name>.py` from a traced stretch after the window. The
last lines of standard error list every check with its limit; `correct`
is their conjunction, and the line's last key, `checks`, repeats them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402
from portbench.harness.verdict import make_checks, print_checks  # noqa: E402

DRIVERS = {"serve_closed": "portbench.harness.serve",
           "train_stage2": "portbench.harness.train"}


def applicable(cell: str, reported, bench: dict):
    """(end-to-end names, per-layer names) that BENCHMARK.json gives this
    cell; without the file, every end-to-end metric the driver reported
    and no per-layer metric."""
    if not bench:
        return list(reported), []
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    per = [m["name"] for m in bench["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in e2e
                            else [])]
    return e2e, per


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            t0: float, bench: dict = None) -> dict:
    """Run the cell once on `device` and return its result line."""
    import importlib
    driver = importlib.import_module(DRIVERS[cell["traffic"]["kind"]])
    res = driver.run(cell, seed, seconds, trace, device, t0)
    found = common.forbidden_modules()
    if found:
        raise SystemExit("loaded after the window: " + ", ".join(found))
    readings = dict(res["readings"])
    readings["failed"] = res["failed"]
    e2e, per = applicable(cell["name"], res["e2e"], bench)
    metrics = {}
    units = {m["name"]: m["unit"] for m in (bench or {}).get(
        "end_to_end", []) + (bench or {}).get("per_layer", [])}
    if trace:
        ctx = dict(res["ctx"], trace=res["trace"])
        for name in per:
            value = common.metric_reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        for name in e2e:
            metrics[name] = {"value": res["e2e"][name],
                             "unit": units.get(name, "")}
    import torch
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = res["trace"].busy_us / 1e6
        dev["window_s"] = res["trace"].window_us / 1e6
    checks = make_checks(readings, cell["limits"])
    line = {"correct": print_checks(checks), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = res["trace"].breakdown()
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.prepare_environment()
    cell = common.load_cell(args.workload)
    import torch
    # one process, and one CPU thread for torch's own operators: the
    # timed loops only launch work on the card, and idle threads of the
    # pool competed with it for the host's cores (set-up ~28 s against
    # ~17 s with one thread, on an H100 host)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    bench_path = common.ROOT / "BENCHMARK.json"
    bench = common.load_json(bench_path) if bench_path.exists() else None
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T0, bench)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
