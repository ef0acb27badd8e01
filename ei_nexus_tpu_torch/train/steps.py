"""The wire format, batch preparation and the stage-2 training step.

Counterpart of `ei_nexus_tpu/train/steps.py`. The host shrinks a collated
batch's padded event arrays to the compact wire format
(`compact_event_view`: uint16 fixed-point coordinates, float32 relative
times, uint8 polarity and one valid count per row, the columns cut to a
bucketed length); `_decode_event_view` restores the float arrays on the
device. `batch_representation` accepts either format and builds the
representation (NHWC) and the event-occupancy mask on the device, and
`make_stage1_train_step` distils the event extractor against the frozen
image extractor, `make_stage2_train_step` trains LightGlue on
time-separated pairs with ground-truth matches from pose and depth,
`make_stage2_homography_train_step` trains it on a frame and its random
perspective warp with ground-truth matches from the known homography
(datasets without depth, EC), and `make_eval_step` is the inference
forward of the evaluation loops.

A training state with a mesh (`parallel.mesh.replicate`) makes its
training steps run over it, as the JAX package's jitted steps run over
its mesh: each rank takes its rows of the global batch (its data index's;
the ranks of a model group share them), the forward, losses and backward
run with the mesh active (`use_mesh`: BatchNorm's global statistics, the
stage-1 losses' global normalisers, the global random fill and jitter,
LightGlue's heads split over the model group), and `_apply_gradients`
sums the head-sliced gradients over the model group (averaging the
replicated ones there) and averages every gradient over the data group
before the norm and the update, so the
state stays equal on every rank and equal to one process's step on the
global batch. The info scalars come back averaged over the data group:
the global batch's values.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import native as native_ops
from ..data import representations as reps
from ..device import resolve_device
from ..geometry import (Camera, Pose, gt_matches_from_homography,
                        gt_matches_from_pose_depth)
from ..losses.matcher_loss import lightglue_loss
from ..models.lightglue import head_sliced_parameters
from ..ops.homographic import (extract_crops_batched,
                               perspective_transform_from_points)
from ..parallel.mesh import local_rows, use_mesh
from ..utils.profiling import annotate
from .optim import set_learning_rate
from .partition import check_frozen
from .state import TrainState


# uint16 fixed-point event coordinates: 1/64-px resolution. 64 is a power
# of two, so encode and decode round-trip exactly in float32.
EVENT_COORD_SCALE = 64.0


def compact_event_view(view: Mapping[str, np.ndarray],
                       keep: Tuple[str, ...] = (), bucket: bool = True,
                       native: Optional[bool] = None
                       ) -> Dict[str, np.ndarray]:
    """A collated view's padded event arrays -> the compact wire format.

    x and y become uint16 round(v * 64), t float32 relative to the
    window's first event (float64 stamps are shifted before narrowing;
    float32 ones pass through), p uint8, and the tail-padded validity mask
    one int32 count a row (`events_n`). `keep` lists the other keys to
    carry through (e.g. "image", "K", "depth"); the rest is dropped.
    `bucket` cuts the columns to the smallest `EVENT_BUCKETS` length that
    holds every row's events (lossless).

    `native` picks the encoder of (B, L) inputs: None takes the C++
    encoder where it builds and numpy elsewhere, as the JAX package does;
    True requires the C++ encoder (raises when it does not build); False
    takes numpy. They differ at exact half quanta: C++ rounds half up,
    numpy half to even."""
    x = np.asarray(view["events_x"])
    y = np.asarray(view["events_y"])
    pol = np.asarray(view["events_p"])
    valid = np.asarray(view["events_valid"])
    t = np.asarray(view["events_t"])
    enc = None
    if x.ndim == 2 and native is not False:
        enc = native_ops.compact_encode(
            x.astype(np.float32, copy=False),
            y.astype(np.float32, copy=False),
            pol.astype(np.float32, copy=False), valid, EVENT_COORD_SCALE)
        if enc is None and native:
            raise RuntimeError("the native event encoder did not build "
                               "(g++ with OpenMP is needed)")
    elif native:
        raise ValueError("the native encoder takes (B, L) event arrays")
    if enc is not None:
        xq, yq, pq, n = enc
    else:
        n = valid.sum(axis=-1).astype(np.int32)
        xq = np.round(x * EVENT_COORD_SCALE).astype(np.uint16)
        yq = np.round(y * EVENT_COORD_SCALE).astype(np.uint16)
        pq = pol.astype(np.uint8)
    if t.dtype == np.float64:
        t0 = t[..., :1] * (n > 0)[..., None]
        t = ((t - t0) * valid).astype(np.float32)
    out = {
        "events_xq": xq,
        "events_yq": yq,
        "events_tr": np.asarray(t, np.float32),
        "events_pq": pq,
        "events_n": n,
    }
    if bucket:
        out = bucket_event_view(out)
    for k in keep:
        if k in view:
            out[k] = view[k]
    return out


# wire lengths of the padded event columns: real windows fill far fewer
# than the max_events=262144 slots (mini-MVSEC median 27k, max 55k events
# a window, as the JAX package records), and the columns are tail-padded,
# so cutting them to the smallest bucket that holds the batch is lossless
EVENT_BUCKETS = (16384, 32768, 65536, 131072)


def bucket_event_view(enc: Dict[str, np.ndarray],
                      buckets: Tuple[int, ...] = EVENT_BUCKETS
                      ) -> Dict[str, np.ndarray]:
    """Cut tail-padded compact event columns to a bucketed length."""
    L = enc["events_xq"].shape[-1]
    n = int(np.max(enc["events_n"])) if enc["events_n"].size else 0
    b = next((bk for bk in sorted(buckets) if bk >= n), L)
    if b >= L:
        return enc
    out = dict(enc)
    for k in ("events_xq", "events_yq", "events_tr", "events_pq"):
        out[k] = np.ascontiguousarray(enc[k][..., :b])
    return out


def _decode_event_view(view: Mapping[str, object],
                       device: Union[str, torch.device]
                       ) -> Dict[str, object]:
    """The inverse of `compact_event_view` on `device`: float32 events_x,
    events_y, events_t, events_p and the bool events_valid from events_n
    (the columns' length is the wire's). A view without the compact keys
    passes through unchanged."""
    if "events_xq" not in view:
        return dict(view)
    out = {k: v for k, v in view.items() if not k.startswith("events_")}

    def get(key):
        return torch.as_tensor(view[key]).to(device)

    L = view["events_xq"].shape[-1]
    out["events_x"] = get("events_xq").to(torch.float32) / EVENT_COORD_SCALE
    out["events_y"] = get("events_yq").to(torch.float32) / EVENT_COORD_SCALE
    out["events_t"] = get("events_tr").to(torch.float32)
    out["events_p"] = get("events_pq").to(torch.float32)
    n = get("events_n")
    out["events_valid"] = (torch.arange(L, device=n.device)[None, :]
                           < n[:, None])
    return out


def compact_stage1_batch(batch) -> Tuple[Dict[str, np.ndarray]]:
    """The stage-1 step's wire: batch[0]'s events and image (data1 is the
    same view in the single-pair protocol)."""
    return (compact_event_view(batch[0], keep=("image",)),)


def compact_stage2_batch(batch):
    """The stage-2 step's wire: data0's events (compact), K and depth,
    data1's image and depth, and the relative poses."""
    data0, data1, T01, T10 = batch[:4]
    return (compact_event_view(data0, keep=("K", "depth")),
            {"image": data1["image"], "depth": data1["depth"]},
            T01, T10)


def compact_stage2_homography_batch(batch):
    """The homography-supervised stage-2 step's wire (EC): data0's events
    and frame; the second view is made on the device inside the step."""
    return (compact_event_view(batch[0], keep=("image",)),)


def batch_representation(batch_view: Mapping[str, object], kind: str,
                         bins: int, height: int, width: int,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded raw events -> (events_rep NHWC (B, H, W, C), mask (B, H, W)).

    `batch_view` holds (B, N) arrays or tensors `events_x`, `events_y`,
    `events_t`, `events_p`, `events_valid`, or the compact wire format of
    `compact_event_view` (decoded on the device first); they are moved to
    `device` (the card unless the caller names another). N may be any
    length. `kind` is any of `data.representations.build_representation`
    (VoxelGrid, TimeSurface, EventStack, DistanceMap, AccumulationImage),
    with the JAX package's `fast=False` semantics: the voxel grid is the
    exact scatter, not the TPU's matmul splat."""
    with annotate("ei.repr"):
        dev = resolve_device(device)
        batch_view = _decode_event_view(batch_view, dev)

        def get(key, dtype):
            return torch.as_tensor(batch_view[key]).to(device=dev,
                                                       dtype=dtype)

        x = get("events_x", torch.float32)
        y = get("events_y", torch.float32)
        t = get("events_t", torch.float32)
        p = get("events_p", torch.float32)
        m = get("events_valid", torch.bool)
        rep = reps.build_representation(kind, x, y, t, p, bins=bins,
                                        height=height, width=width, mask=m)
        acc = reps.events_to_accumulation_image(x, y, height=height,
                                                width=width, mask=m)
        return rep.permute(0, 2, 3, 1), acc > 0


def _all_reduce_flat(grads, group, scale: Optional[float] = None) -> None:
    """Sum `grads` over `group` in place, in one flattened all-reduce, then
    multiply by `scale`."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat.mul_(scale)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _reduce_gradients(state: TrainState) -> None:
    """The global gradient on every rank of the state's mesh: over the
    model group the head-sliced parameters' gradients (partial on each
    rank) summed and the replicated ones (whole on each, and equal but
    where the card's atomic adds round the ranks apart) averaged, in one
    all-reduce, so every rank keeps bit-equal parameters; then every
    trainable gradient averaged over the data group (each rank's loss is
    its rows' mean, or for a global-normalised loss the data size times
    its share: the average is the global loss's gradient either way). A
    parameter without a gradient has none on any rank, and keeps none."""
    mesh = state.mesh
    params = [p for p in state.trainable if p.grad is not None]
    if mesh.model_group is not None:
        sliced = {id(p) for p in head_sliced_parameters(state.model)}
        for p in params:
            if id(p) not in sliced:
                p.grad.div_(mesh.model)
        _all_reduce_flat([p.grad for p in params], mesh.model_group)
    if mesh.data_group is not None:
        _all_reduce_flat([p.grad for p in params], mesh.data_group,
                         1.0 / mesh.data)


def _global_info(state: TrainState, info: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """`info`'s scalars averaged over the state's data group (grad_norm,
    already the global gradient's, as it is), in one all-reduce."""
    mesh = state.mesh
    if mesh is None or mesh.data_group is None:
        return info
    keys = [k for k in info if k != "grad_norm"]
    vals = torch.stack([info[k].float() for k in keys])
    dist.all_reduce(vals, group=mesh.data_group)
    mean = dict(zip(keys, (vals / mesh.data).unbind()))
    return {k: info[k] if k == "grad_norm" else mean[k] for k in info}


def _global_rows(state: TrainState, batch_size: int):
    """(global batch size, this rank's rows of it) under the state's
    mesh; (batch_size, every row) without one."""
    mesh = state.mesh
    if mesh is None:
        return batch_size, slice(None)
    return batch_size * mesh.data, local_rows(batch_size * mesh.data, mesh)


def _apply_gradients(state: TrainState) -> torch.Tensor:
    """After the backward: check that no frozen parameter took a gradient,
    make the gradients global over the state's mesh (`_reduce_gradients`:
    one or two flattened all-reduces, no host synchronisation over NCCL;
    gloo, which takes CUDA tensors on one card, stages them through the
    host), take the global gradient norm over the trainable parameters,
    write lr(step) into the optimizer (unless the schedule is
    host-driven), make one update and count the step. Returns the norm, a
    0-d tensor left on the device."""
    check_frozen(state.model, state.frozen_roots)
    if state.mesh is not None:
        _reduce_gradients(state)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in state.trainable]
    grad_norm = torch.nn.utils.get_total_norm(grads)
    if not state.host_lr:
        set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    state.step += 1
    return grad_norm


def make_stage1_train_step(
    losses: Mapping[str, Callable], rep_kind: str, bins: int, height: int,
    width: int,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The stage-1 (extractor distillation) step.

    step(state, batch) -> info. `batch` is (data0, ...) as the JAX step
    takes it: data0 with the padded events or their wire format
    (`compact_stage1_batch`) and "image" (B, H, W, 1); arrays are moved to
    the model's device. The model's stage-1 forward gives both
    extractors' dense maps (the trainable one's BatchNorm on batch
    statistics, its running statistics updated); `losses` (as
    `losses.build_losses` returns them) compare them: keypoints_loss and
    descriptors_loss under the event mask, feature_loss unmasked; their
    sum is differentiated and one update made. No NMS, top-k or matcher
    runs: nothing the losses read depends on them, as in the compiled JAX
    step. `state` is updated in place. info holds 0-d tensors, left on the
    device (the step never synchronises with the host): loss, each loss's
    term (extractor_keypoints_loss, extractor_descriptor_loss,
    feature_loss, for the losses the config names), grad_norm (over the
    trainable parameters) and dropped_splat_weight (always 0: the exact
    scatter)."""

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = next(model.parameters()).device
        data0 = batch[0]
        ev_rep, ev_mask = batch_representation(data0, rep_kind, bins,
                                               height, width, device=dev)
        image = torch.as_tensor(data0["image"]).to(dev)

        state.optimizer.zero_grad(set_to_none=True)
        with use_mesh(state.mesh):
            ev_feats, im_feats, _ = model(ev_rep, image, ev_mask, None,
                                          training=True)
            l_kp, i_kp = losses["keypoints_loss"](ev_feats, im_feats,
                                                  ev_mask)
            l_de, i_de = losses["descriptors_loss"](ev_feats, im_feats,
                                                    ev_mask)
            l_fe, i_fe = losses["feature_loss"](ev_feats, im_feats)
            total = l_kp + l_de + l_fe
            total.backward()
        grad_norm = _apply_gradients(state)
        return _global_info(state, {
            "loss": total.detach(),
            **{k: v.detach() for i in (i_kp, i_de, i_fe)
               for k, v in i.items()},
            "grad_norm": grad_norm,
            "dropped_splat_weight": torch.zeros((), device=dev)})

    return step


def make_stage2_train_step(
    rep_kind: str, bins: int, height: int, width: int,
    pos_th: float = 3.0, neg_th: float = 5.0, gamma: float = 1.0,
    nll_balancing: float = 0.5,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The stage-2 (LightGlue) step: per-step GT matches from pose and
    depth, deep-supervision NLL, one AdamW update.

    step(state, batch, generator=None, fill=None) -> info. `batch` is
    (data0, data1, T01, T10) as the JAX step takes it: data0 with the
    padded events or their wire format (`compact_stage2_batch`), "K"
    (B, 3, 3) and "depth" (B, H, W); data1 with
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
        with use_mesh(state.mesh):
            _, _, matches = model(ev_rep, get(data1["image"]), ev_mask,
                                  None, training=True, generator=generator,
                                  fill=fill)
            with torch.no_grad(), annotate("ei.train.gt"):
                kp0 = matches["input_feats0"]["sparse_positions"][..., :2]
                kp1 = matches["input_feats1"]["sparse_positions"][..., :2]
                gt = gt_matches_from_pose_depth(
                    kp0, kp1, cam, cam, depth0, depth1, T_0to1, T_1to0,
                    pos_th=pos_th, neg_th=neg_th, ordering="yx")
            with annotate("ei.train.loss"):
                loss, info = lightglue_loss(matches, gt, gamma=gamma,
                                            nll_balancing=nll_balancing,
                                            training=True)
            with annotate("ei.train.backward"):
                loss.backward()
        with annotate("ei.train.optim"):
            grad_norm = _apply_gradients(state)
        n_gt = (gt["matches0"] > -1).sum(dim=-1).float().mean()
        return _global_info(state, {
            "loss": loss.detach(), "gt_matches": n_gt,
            **{k: v.detach() for k, v in info.items()},
            "grad_norm": grad_norm,
            "dropped_splat_weight": torch.zeros((), device=dev)})

    return step


def homography_view(image0: torch.Tensor, jitter: torch.Tensor,
                    height: int, width: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The homography step's second view: the frame's corners
    [[0, 0], [W, 0], [W, H], [0, H]] moved by `jitter` (B, 4, 2) give the
    quad in image0 that H (B, 3, 3, solved from the 4 points in float32)
    maps onto the whole (height, width) frame; image1 is image0
    (B, h, w, C) warped by H into that frame, zero outside. Returns
    (H, image1)."""
    corners = torch.tensor([[0.0, 0.0], [width, 0.0], [width, height],
                            [0.0, height]], dtype=torch.float32,
                           device=image0.device)
    src = corners + jitter.float()
    dst = corners.expand_as(src)
    Hmat = perspective_transform_from_points(src, dst)
    return Hmat, extract_crops_batched(image0.float(), Hmat,
                                       (height, width))


def make_stage2_homography_train_step(
    rep_kind: str, bins: int, height: int, width: int,
    pos_th: float = 3.0, neg_th: float = 5.0, gamma: float = 1.0,
    nll_balancing: float = 0.5, max_corner_jitter: float = 0.125,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The stage-2 (LightGlue) step with homography supervision, for
    datasets without depth (EC): the events stay as they are, the frame is
    warped by a random perspective transform and the ground-truth matches
    come from the known H.

    step(state, batch, generator=None, fill=None, jitter=None) -> info.
    `batch` is (data0, ...) as the JAX step takes it: data0 with the
    padded events or their wire format (`compact_stage2_homography_batch`)
    and "image" (B, h, w, 1), moved to the model's device. Per step the
    corner jitter U(-1, 1) * (W, H) * max_corner_jitter of shape (B, 4, 2)
    is drawn from `generator` (a generator of the model's device), or
    handed in scaled (`jitter`; under a mesh both are the global batch's,
    of which the rank keeps its rows); `homography_view` makes H and
    image1 at
    (height, width); the matcher's random slot fill is drawn from
    `generator` after the jitter, or handed in (`fill`, see
    models/eim.py). `state` is updated in place. info holds 0-d tensors,
    left on the device (no host sync): loss, gt_matches, the matcher_*
    terms, grad_norm and dropped_splat_weight (always 0), as the JAX
    step's."""

    def step(state: TrainState, batch, generator=None, fill=None,
             jitter=None) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = next(model.parameters()).device
        data0 = batch[0]
        ev_rep, ev_mask = batch_representation(data0, rep_kind, bins,
                                               height, width, device=dev)
        image0 = torch.as_tensor(data0["image"]).to(dev)
        Bg, rows = _global_rows(state, image0.shape[0])
        if jitter is None:
            u = torch.rand(Bg, 4, 2, generator=generator, device=dev)
            scale = torch.tensor([width, height], dtype=torch.float32,
                                 device=dev) * max_corner_jitter
            jitter = (u * 2 - 1) * scale
        Hmat, image1 = homography_view(
            image0, torch.as_tensor(jitter).to(dev)[rows], height, width)

        state.optimizer.zero_grad(set_to_none=True)
        with use_mesh(state.mesh):
            _, _, matches = model(ev_rep, image1, ev_mask, None,
                                  training=True, generator=generator,
                                  fill=fill)
            with torch.no_grad():
                # sparse positions are (y, x): the homography's GT takes xy
                f0, f1 = matches["input_feats0"], matches["input_feats1"]
                gt = gt_matches_from_homography(
                    f0["sparse_positions"][..., :2].flip(-1),
                    f1["sparse_positions"][..., :2].flip(-1), Hmat,
                    pos_th=pos_th, neg_th=neg_th, mask0=f0["sparse_valid"],
                    mask1=f1["sparse_valid"])
            loss, info = lightglue_loss(matches, gt, gamma=gamma,
                                        nll_balancing=nll_balancing,
                                        training=True)
            loss.backward()
        grad_norm = _apply_gradients(state)
        n_gt = (gt["matches0"] > -1).sum(dim=-1).float().mean()
        return _global_info(state, {
            "loss": loss.detach(), "gt_matches": n_gt,
            **{k: v.detach() for k, v in info.items()},
            "grad_norm": grad_norm,
            "dropped_splat_weight": torch.zeros((), device=dev)})

    return step


def make_eval_step(rep_kind: str, bins: int, height: int, width: int,
                   dense: bool = False
                   ) -> Callable[..., Tuple[Dict, Dict, Optional[Dict]]]:
    """The inference step of the evaluation loops: step(model, batch) ->
    (event feats, image feats, matches) of `model(ev_rep, data1["image"],
    ev_mask)` under `torch.no_grad()`, in inference mode (no random slot
    fill: invalid slots stay masked); `dense` adds the full-resolution
    descriptor maps the validation losses read (the JAX package's
    extractors always return them). `batch` is (data0, data1, ...):
    data0's padded events or their wire format; arrays are moved to the
    model's device."""

    def step(model: torch.nn.Module, batch
             ) -> Tuple[Dict, Dict, Optional[Dict]]:
        dev = next(model.parameters()).device
        data0, data1 = batch[0], batch[1]
        with torch.no_grad():
            ev_rep, ev_mask = batch_representation(data0, rep_kind, bins,
                                                   height, width, device=dev)
            image = torch.as_tensor(data1["image"]).to(dev)
            return model(ev_rep, image, ev_mask, None, training=False,
                         dense=dense)

    return step
