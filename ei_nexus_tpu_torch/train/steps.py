"""Batch preparation and the stage-2 training step.

Counterpart of `ei_nexus_tpu/train/steps.py`: padded raw events become the
voxel grid (NHWC) and the event-occupancy mask on the device
(`batch_representation`), and `make_stage2_train_step` trains LightGlue on
time-separated pairs with ground-truth matches from pose and depth. The
stage-1 and homography steps come with their slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..data import representations as reps
from ..device import resolve_device
from ..geometry import Camera, Pose, gt_matches_from_pose_depth
from ..losses.matcher_loss import lightglue_loss
from .partition import check_frozen
from .state import TrainState


def batch_representation(batch_view: Mapping[str, object], kind: str,
                         bins: int, height: int, width: int,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded raw events -> (events_rep NHWC (B, H, W, bins), mask (B, H, W)).

    `batch_view` holds (B, N) arrays or tensors `events_x`, `events_y`,
    `events_t`, `events_p`, `events_valid`; they are moved to `device` (the
    card unless the caller names another). Exact-scatter semantics (the JAX
    package's `fast=False`); VoxelGrid only in this slice."""
    dev = resolve_device(device)
    if kind != "VoxelGrid":
        raise NotImplementedError(f"representation {kind!r} is not ported")

    def get(key, dtype):
        return torch.as_tensor(batch_view[key]).to(device=dev, dtype=dtype)

    x = get("events_x", torch.float32)
    y = get("events_y", torch.float32)
    t = get("events_t", torch.float32)
    p = get("events_p", torch.float32)
    m = get("events_valid", torch.bool)
    rep = reps.events_to_voxel_grid(x, y, t, p, bins=bins, height=height,
                                    width=width, mask=m)
    acc = reps.events_to_accumulation_image(x, y, height=height, width=width,
                                            mask=m)
    return rep.permute(0, 2, 3, 1), acc > 0


def make_stage2_train_step(
    rep_kind: str, bins: int, height: int, width: int,
    pos_th: float = 3.0, neg_th: float = 5.0, gamma: float = 1.0,
    nll_balancing: float = 0.5,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The stage-2 (LightGlue) step: per-step GT matches from pose and
    depth, deep-supervision NLL, one AdamW update.

    step(state, batch, generator=None, fill=None) -> info. `batch` is
    (data0, data1, T01, T10) as the JAX step takes it: data0 with the
    padded events, "K" (B, 3, 3) and "depth" (B, H, W); data1 with
    "image" (B, H, W, 1) and "depth"; T01, T10 (B, 4, 4). Arrays are moved
    to the model's device (a no-op for tensors already there). `generator`
    draws the matcher's random slot fill (or `fill` hands it in, see
    models/eim.py). `state` is updated in place. info holds 0-d tensors,
    left on the device (the step never synchronises with the host): loss,
    gt_matches, the matcher_* terms, grad_norm (over the trainable
    parameters) and dropped_splat_weight (always 0: the voxel grid is the
    exact scatter, the JAX package's fast=False)."""

    def step(state: TrainState, batch, generator=None, fill=None
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = next(model.parameters()).device
        data0, data1, T01, T10 = batch[:4]

        def get(x):
            return torch.as_tensor(x).to(dev)

        ev_rep, ev_mask = batch_representation(data0, rep_kind, bins,
                                               height, width, device=dev)
        K = get(data0["K"]).float()
        depth0, depth1 = get(data0["depth"]), get(data1["depth"])
        # the image size built on the device, not copied from the host
        one = torch.ones_like(K[..., 0, 0])
        cam = Camera.from_calibration_matrix(
            K, size=torch.stack([one * width, one * height], dim=-1))
        T_0to1 = Pose.from_4x4mat(get(T01).float())
        T_1to0 = Pose.from_4x4mat(get(T10).float())

        state.optimizer.zero_grad(set_to_none=True)
        _, _, matches = model(ev_rep, get(data1["image"]), ev_mask, None,
                              training=True, generator=generator, fill=fill)
        with torch.no_grad():
            kp0 = matches["input_feats0"]["sparse_positions"][..., :2]
            kp1 = matches["input_feats1"]["sparse_positions"][..., :2]
            gt = gt_matches_from_pose_depth(
                kp0, kp1, cam, cam, depth0, depth1, T_0to1, T_1to0,
                pos_th=pos_th, neg_th=neg_th, ordering="yx")
        loss, info = lightglue_loss(matches, gt, gamma=gamma,
                                    nll_balancing=nll_balancing,
                                    training=True)
        loss.backward()
        check_frozen(model, state.frozen_roots)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.trainable]
        grad_norm = torch.nn.utils.get_total_norm(grads)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        n_gt = (gt["matches0"] > -1).sum(dim=-1).float().mean()
        return {"loss": loss.detach(), "gt_matches": n_gt,
                **{k: v.detach() for k, v in info.items()},
                "grad_norm": grad_norm,
                "dropped_splat_weight": torch.zeros((), device=dev)}

    return step
