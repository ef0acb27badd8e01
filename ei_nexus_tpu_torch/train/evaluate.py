"""Evaluation loops: extractor validation (same time) and the relative pose
benchmark (different times).

Counterpart of `ei_nexus_tpu/train/evaluate.py`: the forward is the eval
step (`steps.make_eval_step`, on the model's device); the metrics are the
host-side numpy of `metrics/` over the fixed-K outputs, the ragged
per-pair views recovered by masking. `val_extractor` gives R@1/3, VVD,
MMA@1/3, MR and HE under the identity homography (and the validation
losses), `rpe_eval` the RPE errors and AUC@{5,10,20} with the OpenCV
RANSAC on the host, one call a pair, or (backend "torch", the JAX
package's "jax") the batched RANSAC on the model's device, one call a
batch. The evaluation entry points share `eval_arguments`,
`build_eval_model` and `val_dataset`.
"""

from __future__ import annotations

import argparse
import json
import types
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..metrics import (HomographyEstimation, MatchingRatio,
                       MeanMatchingAccuracy, RelativePoseEstimation,
                       Repeatability, ValidDescriptorsDistance)
from .steps import batch_representation, make_eval_step

_SPARSE = ("sparse_positions", "sparse_valid", "sparse_descriptors")


def _host(feats: Mapping[str, torch.Tensor], keys=_SPARSE
          ) -> Dict[str, np.ndarray]:
    """The named tensors of a feature dict as numpy arrays (float32 for
    the floating ones)."""
    out = {}
    for k in keys:
        v = feats[k].detach()
        out[k] = (v.float() if v.is_floating_point() else v).cpu().numpy()
    return out


def _slot_feats(matches: Mapping, feats0: Mapping, feats1: Mapping):
    """The keypoints the match indices address: the matcher's own input
    feats (its padded slot space, which can exceed the extractor's K:
    SiLK's 512 keypoints in 1024 slots), else the extractors' feats."""
    f0 = matches.get("input_feats0", feats0)
    f1 = matches.get("input_feats1", feats1)
    return _host(f0, ("sparse_positions",)), _host(f1, ("sparse_positions",))


def _matched_pairs(m0: np.ndarray, kp0: np.ndarray, kp1: np.ndarray):
    """One sample's ragged matched keypoint lists from its matches0 slots
    into kp1."""
    sel = m0 > -1
    return kp0[sel], kp1[m0[sel]]


def _add(acc: Dict[str, List[float]], out: Mapping[str, float]) -> None:
    for k, v in out.items():
        acc.setdefault(k, []).append(v)


def val_extractor(model: torch.nn.Module, loader, rep_kind: str, bins: int,
                  height: int, width: int,
                  losses: Optional[Dict[str, Callable]] = None,
                  max_batches: Optional[int] = None) -> Dict[str, float]:
    """Same-time validation of `model` (on its device) over `loader`'s
    (data0, data1, ...) batches: keypoint, descriptor and matching metrics
    under the identity homography, and, with `losses` (as
    `losses.build_losses` returns them), the validation keypoints and
    descriptors losses."""
    step = make_eval_step(rep_kind, bins, height, width,
                          dense=losses is not None)
    rep1 = Repeatability("R@1", 1, ordering="yx")
    rep3 = Repeatability("R@3", 3, ordering="yx")
    vvd = ValidDescriptorsDistance("VVD", [1, 3], ordering="yx")
    mma1 = MeanMatchingAccuracy("MMA@1", 1, ordering="yx")
    mma3 = MeanMatchingAccuracy("MMA@3", 3, ordering="yx")
    mr = MatchingRatio("MR")
    he = HomographyEstimation("HE", [3, 5, 10], ordering="yx")
    eye = np.eye(3)
    shp = (height, width)
    acc: Dict[str, List[float]] = {}
    dev = next(model.parameters()).device

    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        ev_t, im_t, matches = step(model, batch)
        if losses is not None:
            with torch.no_grad():
                _, mask = batch_representation(batch[0], rep_kind, bins,
                                               height, width, device=dev)
                for name in ("keypoints_loss", "descriptors_loss"):
                    value, _ = losses[name](ev_t, im_t, mask)
                    acc.setdefault(f"val_{name}", []).append(float(value))
        ev, im = _host(ev_t), _host(im_t)
        s0, s1 = _slot_feats(matches, ev_t, im_t)
        m0 = matches["matches0"].cpu().numpy()
        for b in range(len(ev["sparse_positions"])):
            v0, v1 = ev["sparse_valid"][b], im["sparse_valid"][b]
            p0 = ev["sparse_positions"][b][v0]
            p1 = im["sparse_positions"][b][v1]
            d0 = ev["sparse_descriptors"][b][v0]
            d1 = im["sparse_descriptors"][b][v1]
            for m in (rep1, rep3):
                _add(acc, m.update_one(p0[:, :2], p1[:, :2], shp, shp, eye))
            _add(acc, vvd.update_one(p0[:, :2], p1[:, :2], d0, d1, shp, shp,
                                     eye))
            mk0, mk1 = _matched_pairs(m0[b], s0["sparse_positions"][b],
                                      s1["sparse_positions"][b])
            _add(acc, mr.update_one(mk0, mk1, p0, p1))
            if len(mk0):
                for m in (mma1, mma3):
                    _add(acc, m.update_one(mk0[:, :2], mk1[:, :2], eye))
                _add(acc, he.update_one(shp, mk0, mk1, eye))

    out = {k: float(np.mean([x for x in v if np.isfinite(x)] or [np.nan]))
           for k, v in acc.items()}
    auc = he.compute_all_auc()
    out.update({f"HE@{t}_auc": auc[f"{t}"] for t in (3, 5, 10)})
    return out


def rpe_eval(model: torch.nn.Module, loader, rep_kind: str, bins: int,
             height: int, width: int, pose_thresh=(5, 10, 20),
             ransac_thresh: float = 1.0, backend: str = "opencv",
             solver: str = "5pt", max_batches: Optional[int] = None
             ) -> Dict[str, float]:
    """The time-separated relative pose benchmark over `loader`'s (data0,
    data1, T01, T10) batches: the mean of each finite per-pair value, the
    pose AUC at each of `pose_thresh` degrees and n_pairs. `backend`
    "opencv" (cv2 on the host, a call a pair) or "torch" (the batched
    RANSAC on the model's device, a call a batch; `solver` "5pt" or
    "8pt")."""
    step = make_eval_step(rep_kind, bins, height, width)
    rpe = RelativePoseEstimation(
        "RPE", list(pose_thresh), ransac_thresh=ransac_thresh,
        ordering="yx", backend=backend, solver=solver,
        device=next(model.parameters()).device)
    acc: Dict[str, List[float]] = {}
    n_pairs = 0
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        data0, data1, T01 = batch[:3]
        ev, im, matches = step(model, batch)
        s0, s1 = _slot_feats(matches, ev, im)
        m0 = matches["matches0"].cpu().numpy()
        T01 = np.asarray(T01)
        if backend == "torch":
            # one RANSAC call on the device for the whole batch
            for out in rpe.update_batch_device(
                    s0["sparse_positions"], s1["sparse_positions"], m0,
                    np.asarray(data0["K"]), np.asarray(data1["K"]), T01):
                _add(acc, out)
        else:
            for b in range(len(T01)):
                mk0, mk1 = _matched_pairs(m0[b], s0["sparse_positions"][b],
                                          s1["sparse_positions"][b])
                _add(acc, rpe.update_one(mk0, mk1, np.asarray(data0["K"][b]),
                                         np.asarray(data1["K"][b]), T01[b]))
        n_pairs += len(T01)
    summary = {}
    for k, v in acc.items():
        arr = np.asarray(v, np.float64)
        arr = arr[np.isfinite(arr)]
        summary[k] = float(arr.mean()) if arr.size else float("nan")
    auc = rpe.compute_all_auc()
    for t in pose_thresh:
        summary[f"RPE@{t}_auc"] = auc[f"{t}"]
    summary["n_pairs"] = n_pairs
    return summary


def matcher_val_losses(model: torch.nn.Module, loader, rep_kind: str,
                       bins: int, height: int, width: int,
                       pos_th: float = 3.0, neg_th: float = 5.0,
                       gamma: float = 1.0, nll_balancing: float = 0.5,
                       max_batches: Optional[int] = None
                       ) -> Dict[str, float]:
    """The stage-2 loss without a gradient and the assignment metrics
    (`matcher_metrics`) over `loader`'s (data0, data1, T01, T10) batches,
    averaged over the batches: GT matches from pose and depth as in
    training, the forward in training mode (every layer's outputs; the
    random slot fill from a generator reseeded to 0 each batch, as the JAX
    package uses one fixed key). Stops at the first batch without depth
    (EC has none), as the JAX package's val_matcher does."""
    from ..geometry import Camera, Pose, gt_matches_from_pose_depth
    from ..losses.matcher_loss import lightglue_loss
    from ..metrics import matcher_metrics

    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev)
    sums: Dict[str, float] = {}
    n = 0
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        if "depth" not in batch[0]:
            break
        data0, data1, T01, T10 = batch[:4]

        def get(x):
            return torch.as_tensor(np.asarray(x)).to(dev).float()

        generator.manual_seed(0)
        with torch.no_grad():
            ev_rep, ev_mask = batch_representation(data0, rep_kind, bins,
                                                   height, width, device=dev)
            K = get(data0["K"])
            one = torch.ones_like(K[..., 0, 0])
            cam = Camera.from_calibration_matrix(
                K, size=torch.stack([one * width, one * height], dim=-1))
            _, _, matches = model(ev_rep, get(data1["image"]), ev_mask, None,
                                  training=True, generator=generator)
            gt = gt_matches_from_pose_depth(
                matches["input_feats0"]["sparse_positions"][..., :2],
                matches["input_feats1"]["sparse_positions"][..., :2],
                cam, cam, get(data0["depth"]), get(data1["depth"]),
                Pose.from_4x4mat(get(T01)), Pose.from_4x4mat(get(T10)),
                pos_th=pos_th, neg_th=neg_th, ordering="yx")
            loss, info = lightglue_loss(matches, gt, gamma=gamma,
                                        nll_balancing=nll_balancing,
                                        training=True)
        vals = {k: float(v.float().mean())
                for k, v in {"matcher_loss": loss, **info}.items()}
        mm = matcher_metrics(matches["matches0"].cpu().numpy(),
                             gt["matches0"].cpu().numpy(),
                             matches["matching_scores0"].float().cpu()
                             .numpy())
        vals.update({k: float(np.mean(v)) for k, v in mm.items()})
        for k, v in vals.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


# ---------------------------------------------------------------------------
# what the evaluation entry points share
# ---------------------------------------------------------------------------


def eval_arguments(default_config: str, description: str,
                   backend: bool = False) -> argparse.ArgumentParser:
    """The evaluation entries' command line: --config, --ckpt,
    --max-batches, --device and the key=value overrides; with `backend`
    also --backend opencv|torch (the JAX package's opencv|jax) and
    --solver 5pt|8pt."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=default_config)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint directory of this package's trainers")
    if backend:
        p.add_argument("--backend", default="opencv",
                       choices=["opencv", "torch"],
                       help="RANSAC: cv2 on the host, or batched on the "
                            "device (the JAX package's --backend jax)")
        p.add_argument("--solver", default="5pt", choices=["8pt", "5pt"],
                       help="the torch backend's minimal solver")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="the card (default) or another torch device")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    return p


def build_eval_model(model_dict: Mapping, ckpt: Optional[str] = None,
                     device=None, seed: int = 0) -> torch.nn.Module:
    """The model a config's `model` section names, in eval mode on `device`
    (the card unless the caller names another), its weights from `ckpt`
    (a checkpoint directory of this package's trainers, read through
    `restore_any_checkpoint`) or else random from `seed`. LightGlue is
    built with its training heads, so a stage-2 checkpoint loads whole;
    inference reads the last layer's head only."""
    from ..device import resolve_device
    from ..models import build_model
    from ..models.config_adapter import eim_config_from_dict
    from ..models.layers import init_parameters
    from .checkpoint import restore_any_checkpoint

    dev = resolve_device(device)
    cfg = eim_config_from_dict(dict(model_dict))
    model = build_model(model_dict.get("name", "EIM"), cfg, device="cpu",
                        training_heads=True)
    init_parameters(model, torch.Generator().manual_seed(seed))
    if ckpt:
        restore_any_checkpoint(ckpt, types.SimpleNamespace(model=model,
                                                           step=0), cfg)
    return model.to(dev).eval()


def val_dataset(ds_cfg: Mapping):
    """The config's validation split (the MVSEC or EC reader's)."""
    from ..data.ec import fetch_ec_dataset
    from ..data.mvsec import fetch_mvsec_dataset
    fetch = fetch_mvsec_dataset if ds_cfg["name"] == "mvsec" \
        else fetch_ec_dataset
    return fetch(dict(ds_cfg), "val")


def print_metrics(metrics: Mapping[str, float]) -> None:
    print(json.dumps(metrics, indent=2, sort_keys=True))
