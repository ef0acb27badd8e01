"""The serving driver: a closed loop of batches of event-frame pairs
through the port's served forward, dispatched ahead.

Each batch is a copy of one of the pool's batches, held in pinned host
memory: its submit copies it to the card without blocking, builds the
voxel grid (`train/steps.py:batch_representation`) and runs
`EIM.forward` in eval mode, and records an event; `in_flight` batches are
submitted before the host waits for the oldest. A batch's latency runs
from its submit to the host's return from waiting on its event. The
window closes `seconds` after its first submit; batches submitted before
then are completed and counted, and the rate is all pairs completed over
the time to the last completion.

Set-up builds the model from the configuration's model dict through the
port's config adapter, draws the weights and the pool from the seed, and
runs `warmup` batches (the first builds the kernels). After the window
the outputs of the batches drawn for checking (one early ordinal drawn
from the seed, and the last batch) are judged against the reference.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np

from . import common, compare, data
from .flops import FlopCounter, lightglue_attention_flops
from .trace import span, traced


class Pending:
    __slots__ = ("t", "event", "i", "out")

    def __init__(self, t, event, i, out):
        self.t, self.event, self.i, self.out = t, event, i, out


def lightglue_shape(model_dict: dict, batch: int) -> Dict[str, int]:
    lg = model_dict["matcher"].get("LightGlue", {})
    N = model_dict["matcher"].get("max_points_num", 1024)
    D, h = lg.get("descriptor_dim", 256), lg.get("num_heads", 4)
    return {"B": batch, "h": h, "N": N, "M": N, "d": D // h, "D": D,
            "layers": lg.get("n_layers", 9)}


def build_model(model_dict: dict, device, training_heads: bool = False):
    """The port's EIM of a config dict, built on `device`."""
    import torch
    from ei_nexus_tpu_torch.models.config_adapter import eim_config_from_dict
    from ei_nexus_tpu_torch.models.eim import EIM
    ecfg = eim_config_from_dict(model_dict)
    with torch.device(device):
        model = EIM(ecfg, training_heads)
    return model.to(device), ecfg


def extractor_hooks(model):
    """Host ranges around the extractors' and LightGlue's forwards."""
    handles = []
    for name, mod in (("extract.event", model.event_extractor),
                      ("extract.image", model.image_extractor),
                      ("match", getattr(model.matcher, "lightglue", None))):
        if mod is None:
            continue
        rng = {}

        def pre(m, args, _name=name, _rng=rng):
            _rng["r"] = span(_name)
            _rng["r"].__enter__()

        def post(m, args, out, _rng=rng):
            _rng.pop("r").__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return handles


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    import torch
    from ei_nexus_tpu_torch.train.steps import batch_representation
    from ei_nexus_tpu_torch.utils.setup import setup

    cfg, mix = cell["config"], cell["traffic"]
    shp = cfg["shape"]
    H, W, bins, kind = shp["height"], shp["width"], shp["bins"], shp["kind"]
    cuda = torch.device(device).type == "cuda"
    seeds = common.seeds(seed)
    setup(seeds["host"])
    common.set_tf32(False)
    model, _ = build_model(cfg["model"], device)
    model.eval()
    sd_ref = {k: v.clone()
              for k, v in common.init_weights(model, seeds["weights"],
                                              device).items()}
    pool_np = data.serve_pool(seeds["pool"], mix, H, W)
    pool = data.pinned(pool_np, device)
    B = mix["batch"]

    def submit(i: int) -> Pending:
        t = time.perf_counter()
        with span("submit"):
            b = data.to_device(pool[i % len(pool)], device)
            with span("repr"):
                rep, mask = batch_representation(b, kind, bins, H, W,
                                                 device=device)
            with torch.no_grad():
                ef, imf, m = model(rep, b["image"], mask, None,
                                   training=False)
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
        return Pending(t, ev, i, (i % len(pool), ef, imf, m))

    def wait(p: Pending) -> float:
        with span("wait"):
            if p.event is not None:
                p.event.synchronize()
        return time.perf_counter()

    def closed_loop(n: int = 0, deadline: float = None, keep=()):
        """Run batches, `in_flight` at a time, until `n` are submitted or
        the deadline passes; returns (latencies, host s, kept outputs,
        completed, first submit, last completion)."""
        pending = collections.deque()
        lat, host, kept = [], [], []
        i = done = 0
        start = time.perf_counter()
        last = None

        def more():
            return (i < n) if deadline is None \
                else time.perf_counter() < deadline

        while len(pending) < mix["in_flight"] and more():
            h0 = time.perf_counter()
            pending.append(submit(i))
            host.append(time.perf_counter() - h0)
            i += 1
        while pending:
            p = pending.popleft()
            t_done = wait(p)
            lat.append(t_done - p.t)
            done += 1
            last = p
            if p.i in keep:
                kept.append(p.out)
            if more():
                h0 = time.perf_counter()
                pending.append(submit(i))
                host.append(time.perf_counter() - h0)
                i += 1
        if last is not None and last.i not in keep:
            kept.append(last.out)
        return lat, host, kept, done, start, t_done if done else start

    # set-up: the first batch builds the kernels; the FLOPs of one
    # forward are counted by hooks on it
    counter = FlopCounter(model)
    closed_loop(n=1)
    counter.remove()
    closed_loop(n=max(mix["warmup"] - 1, 0))
    if cuda:
        torch.cuda.synchronize()
    lgs = lightglue_shape(cfg["model"], B)
    flops_batch = counter.frozen + counter.trained + \
        lightglue_attention_flops(B, lgs["N"], lgs["M"], lgs["D"], lgs["h"],
                                  lgs["layers"], 1)
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng(seeds["check"])
    early = int(rng.integers(0, mix["check_early"]))
    lat, host, kept, done, w0, w1 = closed_loop(
        deadline=time.perf_counter() + seconds, keep={early})
    if cuda:
        torch.cuda.synchronize()
    window_s = w1 - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    res = {
        "setup_s": setup_s,
        "e2e": {"pairs_per_s": done * B / window_s,
                "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                "setup_s": setup_s},
        "attempted": len(host) * B,
        "memory_peak_bytes": int(peak),
        "ctx": {"role": "serve", "shape": lgs, "flops_per_batch": flops_batch,
                "window_batches": done, "window_s": window_s,
                "host_s": host, "pairs_per_batch": B},
    }
    if trace:
        handles = extractor_hooks(model)

        def run_n(n):
            closed_loop(n=n)

        res["trace"] = traced(run_n, mix["trace_warmup"], mix["trace_batches"])
        for h in handles:
            h.remove()

    # the program's state freed; the reference judges what was kept
    del model, pool
    if cuda:
        torch.cuda.empty_cache()
    res["readings"], res["failed"] = judge(cell, sd_ref, pool_np, kept,
                                           device)
    return res


def judge(cell: dict, sd, pool_np: List[dict], kept, device):
    """The worst reading of each check over the kept batches (the median
    pair's, for a check read a pair at a time), in chunks of pairs, and
    the pairs whose outputs were not finite."""
    import torch
    cfg = cell["config"]
    ref = common.reference_module(cell["config_name"])
    chunk = cell["traffic"].get("check_chunk", 4)
    readings: Dict[str, float] = {}
    pairs: Dict[str, List[float]] = {}
    failed = 0

    def note(name, value):
        if isinstance(value, list):
            pairs.setdefault(name, []).extend(value)
        else:
            readings[name] = compare.worst([readings.get(name, 0.0), value])

    with torch.no_grad():
        for idx, ef, imf, m in kept:
            b = {k: torch.as_tensor(v).to(device)
                 for k, v in pool_np[idx].items()}
            voxel, occ = ref.representation(cfg["shape"], b)
            la = m["log_assignment"]
            bad = ~torch.isfinite(la).flatten(1).all(1)
            failed += int(bad.sum())
            for s in range(0, voxel.shape[0], chunk):
                sl = slice(s, s + chunk)
                r_ev, r_im = ref.extract_pair(cfg["model"], sd, voxel[sl],
                                              occ[sl], b["image"][sl])
                for side, prog, r in (("event", ef, r_ev),
                                      ("image", imf, r_im)):
                    part = {k: prog[k][sl] for k in (
                        "sparse_positions", "sparse_valid",
                        "sparse_descriptors")}
                    for k, v in compare.extractor_gaps(part, r).items():
                        note(f"{k}.{side}", v)
                keys = ("sparse_positions", "sparse_descriptors",
                        "sparse_valid", "image_size")
                f0 = {k: m["input_feats0"][k][sl] for k in keys}
                f1 = {k: m["input_feats1"][k][sl] for k in keys}
                r_la, r_m0, mask0, mask1 = ref.match(cfg["model"], sd, f0, f1)
                for k, v in compare.matcher_gaps(
                        la[sl], m["matches0"][sl], r_la, r_m0, mask0,
                        mask1).items():
                    note(k, v)
    readings.update({k: compare.median(v) for k, v in pairs.items()})
    return readings, failed
