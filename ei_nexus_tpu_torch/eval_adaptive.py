"""Adaptive LightGlue inference on a trained matcher and real data.

The port's counterpart of `tools/eval_adaptive.py`, with its flags and
JSON keys: at the reference's shipping defaults (depth_confidence 0.95,
width_confidence 0.99) it reports the exit layer's histogram over the
validation pairs, the relative pose protocol twice (the full forward,
then the adaptive one: RPE errors, inlier ratios, AUC@5/10/20 and the
mean match count) and, unless `--skip-timing`, the time of a batch of 8
both ways.

    python -m ei_nexus_tpu_torch.eval_adaptive \\
        --config configs/train_EIM_stage2.yaml \\
        --ckpt runs/<stage2>/checkpoints/final [--depth 0.95] \\
        [--width 0.99] [--iters 30] [--max-batches N] [--skip-timing] \\
        [--device cuda] [key=value overrides...]

`--ckpt` takes what the evaluation entries take (`train/checkpoint.py:
restore_any_checkpoint`: a checkpoint directory of the port's trainers, a
reference `.pth`, an exported JAX `.npz`). The weights are restored into
the adaptive model, built as the JAX tool inits it with every layer's
assignment head and token confidence (the superset), and the base model
takes the same tensors. The RANSAC is OpenCV's on the host, as in the
JAX tool. The timing runs `--iters` forwards (representation and model)
back to back on the first validation batch of 8, between CUDA events on
the card, best of 3; the JAX tool chains its forwards in one `lax.scan`
so that one dispatch covers them, which eager PyTorch has no use for.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

EXIT_BINS = 9   # the histogram's length: the flagship's layers


def build_models(cfg, ad_cfg, ckpt: str, device) -> Tuple[torch.nn.Module,
                                                           torch.nn.Module]:
    """(base, adaptive) eval models of two configs that differ in
    LightGlue's depth and width confidences alone: the checkpoint is
    restored into the adaptive one, and the base one takes its tensors."""
    from .train.evaluate import build_eval_model
    model_ad = build_eval_model(ad_cfg.model.to_dict(), ckpt, device)
    model = build_eval_model(cfg.model.to_dict(), None, device)
    model.load_state_dict(model_ad.state_dict(), strict=True)
    return model, model_ad


def run_protocol(model: torch.nn.Module, loader, rep: str, bins: int,
                 height: int, width: int, max_batches: Optional[int] = None,
                 collect_exit: bool = False
                 ) -> Tuple[Dict[str, Any], List[int]]:
    """The stock RPE protocol over `loader`'s pairs (B=1): (the mean of
    each finite per-pair value and the AUCs, rounded as the JAX tool
    prints them, with n_matches_mean; the exit layer of each pair where
    `collect_exit` and the model reports it)."""
    from .metrics.matching import RelativePoseEstimation
    from .train.evaluate import _matched_pairs, _slot_feats
    from .train.steps import make_eval_step

    step = make_eval_step(rep, bins, height, width)
    rpe = RelativePoseEstimation("RPE", [5, 10, 20], ransac_thresh=1.0,
                                 ordering="yx", backend="opencv")
    acc: Dict[str, List[float]] = {}
    exits: List[int] = []
    nmatches: List[int] = []
    for bi, batch in enumerate(loader):
        if max_batches and bi >= max_batches:
            break
        data0, data1, T01 = batch[:3]
        ev, im, matches = step(model, batch)
        if collect_exit and "exit_layer" in matches:
            exits.append(int(matches["exit_layer"]))
        m0 = matches["matches0"][0].cpu().numpy()
        nmatches.append(int((m0 >= 0).sum()))
        s0, s1 = _slot_feats(matches, ev, im)
        mk0, mk1 = _matched_pairs(m0, s0["sparse_positions"][0],
                                  s1["sparse_positions"][0])
        out = rpe.update_one(mk0, mk1, np.asarray(data0["K"][0]),
                             np.asarray(data1["K"][0]), np.asarray(T01[0]))
        for k, v in out.items():
            acc.setdefault(k, []).append(v)
    summary: Dict[str, Any] = {}
    for k, v in acc.items():
        arr = np.asarray(v, np.float64)
        arr = arr[np.isfinite(arr)]
        summary[k] = round(float(arr.mean()), 4) if arr.size else None
    auc = rpe.compute_all_auc()
    for t in (5, 10, 20):
        summary[f"auc@{t}"] = round(auc[f"{t}"], 4)
    summary["n_matches_mean"] = round(float(np.mean(nmatches)), 1)
    return summary, exits


def time_forwards(model: torch.nn.Module, batch, rep: str, bins: int,
                  height: int, width: int, iters: int) -> float:
    """ms a forward of `batch` (events to matches: the representation and
    the model), over `iters` forwards back to back, best of 3 after one
    warm forward; CUDA events on the card, the host clock elsewhere."""
    from .train.steps import batch_representation

    dev = next(model.parameters()).device
    data0, data1 = batch[0], batch[1]
    ev = {k: torch.as_tensor(np.asarray(v)).to(dev)
          for k, v in data0.items() if k.startswith("events")}
    image = torch.as_tensor(np.asarray(data1["image"])).to(dev)

    def run(n):
        for _ in range(n):
            r, m = batch_representation(ev, rep, bins, height, width,
                                        device=dev)
            model(r, image, m)

    best = float("inf")
    with torch.no_grad():
        run(1)                              # warm
        for _ in range(3):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(iters)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                run(iters)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms)
    return best / iters


def main(argv=None) -> Dict[str, Any]:
    from .data import DataLoader
    from .device import resolve_device
    from .train.evaluate import val_dataset
    from .utils import load_config

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--depth", type=float, default=0.95)
    p.add_argument("--width", type=float, default=0.99)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--skip-timing", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the card (default) or another torch device")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.overrides)
    ad_cfg = load_config(args.config, list(args.overrides) + [
        f"model.matcher.LightGlue.depth_confidence={args.depth}",
        f"model.matcher.LightGlue.width_confidence={args.width}"])
    ds_cfg = cfg.dataset.to_dict()
    H, W = ds_cfg["resolution"]
    bins, rep = ds_cfg["channel"], ds_cfg["representation_type"]
    val_ds = val_dataset(ds_cfg)
    model, model_ad = build_models(cfg, ad_cfg, args.ckpt, dev)

    def loader(batch_size=1, drop_last=False):
        return DataLoader(val_ds, batch_size=batch_size, shuffle=False,
                          drop_last=drop_last)

    base, _ = run_protocol(model, loader(), rep, bins, H, W,
                           args.max_batches)
    adaptive, exits = run_protocol(model_ad, loader(), rep, bins, H, W,
                                   args.max_batches, collect_exit=True)
    result: Dict[str, Any] = {
        "depth_confidence": args.depth, "width_confidence": args.width,
        "exit_layer_hist": (np.bincount(exits, minlength=EXIT_BINS).tolist()
                            if exits else []),
        "exit_layer_mean": round(float(np.mean(exits)), 2) if exits else None,
        "base": base, "adaptive": adaptive,
    }
    if not args.skip_timing:
        b8 = next(iter(loader(8, drop_last=True)))
        ms_base = time_forwards(model, b8, rep, bins, H, W, args.iters)
        ms_ad = time_forwards(model_ad, b8, rep, bins, H, W, args.iters)
        result["ms_per_batch8_base"] = round(ms_base, 2)
        result["ms_per_batch8_adaptive"] = round(ms_ad, 2)
        result["speedup"] = round(ms_base / ms_ad, 3)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
