#!/usr/bin/env python
"""Where a benchmark cell's time goes, by the program's spans.

    python tools/trace_spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the chips the cell asks
for. Runs the cell once as `portbench/run.py --trace 1` runs it and prints
its result line; then reads the same traced stretch by the program's
`ei.` spans (`utils/profiling.py:SpanTrace`) and prints one JSON line,
also written to chiprun_out/trace_spans_<cell>_<seed>.json:
 - `launches`: kernel launch calls a batch made inside an `ei.` span;
 - `host_wait_ms`: host ms a batch those spans spent in calls that waited
   on the card (`profiling.waits`), by call and by innermost span;
 - `select_dev_ms`: device ms a batch launched inside `ei.extract.nms` and
   `ei.extract.topk`;
 - `linear_kernel`: kernel L's (`linear_tf32_kernel`, LightGlue's float32
   linears) launches and device ms a batch inside `ei.match.self`,
   `ei.match.cross`, `ei.match.assign` and the whole `ei.match`;
 - `spans`: each span's count, host ms, device ms (with what its own body
   launched, `self_`), launches and waiting ms, a batch;
 - `calls`: every runtime call a batch inside an `ei.` span, by name:
   (count, host ms);
 - `traced_host_ms`: the harness's `submit` (or `step`) range a batch,
   the host's enqueue under the profiler;
 - `ranges_dev_ms`: each of the harness's ranges, device ms a batch as the
   benchmark reads it (the profiler's `device_time_total`) and as the
   kernels launched inside it add up;
 - `idle_gaps`: the longest idle gaps (ms), each labelled by the
   innermost span, the program's or the harness's, that held the launch
   of the operation ending it, and the idle ms by label over all gaps;
 - checks: the busy union against the benchmark's, how many device
   operations were linked to a launch, and whether a span reached the
   benchmark's operations.
A batch is a served batch or a training step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


# the spans kernel L is read in: LightGlue's blocks, its assignment head,
# and the matcher's whole span
LINEAR_SPANS = ("ei.match.self", "ei.match.cross", "ei.match.assign",
                "ei.match")


def readings(trace) -> dict:
    """The span readings of a benchmark `Trace` that kept its events."""
    from ei_nexus_tpu_torch.utils.profiling import SpanTrace
    st = SpanTrace(trace.events, prefixes=("ei.", "portbench."))
    n = trace.batches
    by_call, by_span = st.waiting()
    spans = {}
    for name, row in sorted(st.table().items()):
        spans[name] = {k.replace("_us", "_ms"): v / n / (
            1e3 if k.endswith("_us") else 1) for k, v in row.items()}
    host = [t1 - t0 for name, t0, t1 in trace.host
            if name in ("submit", "step")]
    every = st.gap_labels(len(st.idle))
    by_label = {}
    for label, us in every:
        by_label[label] = by_label.get(label, 0.0) + us / 1e3 / n
    return {
        "batches": n,
        "launches": st.launches() / n,
        "host_wait_ms": sum(by_call.values()) / 1e3 / n,
        "host_wait_ms_by_call": {k: v / 1e3 / n for k, v in by_call.items()},
        "host_wait_ms_by_span": {k: v / 1e3 / n for k, v in by_span.items()},
        "select_dev_ms": st.device_us(("ei.extract.nms",
                                       "ei.extract.topk")) / 1e3 / n,
        "linear_kernel": {
            span: dict(zip(("launches", "device_ms"), (
                c / n, us / 1e3 / n))) for span, (c, us) in (
                    (span, st.kernel_us("linear_tf32_kernel", (span,)))
                    for span in LINEAR_SPANS)},
        "calls": {k: [c / n, us / 1e3 / n]
                  for k, (c, us) in sorted(st.call_us().items())},
        "traced_host_ms": sum(host) / len(host) / 1e3 if host else None,
        "ranges_dev_ms": {
            k: [trace.device_ms(k), st.device_us(("portbench." + k,))
                / 1e3 / n] for k in sorted(trace.ranges)},
        "busy_ms": st.busy_us / 1e3 / n,
        "busy_as_benchmark": abs(st.busy_us - trace.busy_us) <= 1e-6 * max(
            trace.busy_us, 1.0),
        "ops": len(st.ops),
        "ops_linked": st.linked,
        "spans_in_benchmark_ops": sum(1 for o in trace.ops
                                      if o[0].startswith("ei.")),
        "idle_gaps": [[label, us / 1e3] for label, us in every[:20]],
        "idle_ms_by_label": by_label,
        "spans": spans,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import run
    from portbench.harness import trace as bench_trace

    kept = []

    class Kept(bench_trace.Trace):
        """The benchmark's trace, with the profiler's events kept."""

        def __init__(self, events, batches):
            super().__init__(events, batches)
            self.events = events
            kept.append(self)

    bench_trace.Trace = Kept
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc:
        return rc
    import torch
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), **readings(kept[-1])}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"trace_spans_{args.workload}_"
                           f"{args.seed}.json"), "w") as f:
        json.dump(out, f, indent=1)
    brief = {k: v for k, v in out.items() if k != "spans"}
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
