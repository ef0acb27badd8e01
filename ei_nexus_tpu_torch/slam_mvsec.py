"""The SLAM back end on mini-MVSEC front-end tracks.

The port's counterpart of `tools/slam_mvsec.py`, with its flags, its
drift generator, its gate and its JSON keys. Events -> voxel grid -> the
trained stage-1 event extractor (VGG 128/256/256, kernel C once a frame)
-> MNN between consecutive keyframes -> `chain_tracks` -> triangulation
-> Schur-complement BA with the Cauchy loss, the cheirality gate and the
odometry prior. The initial poses accumulate noisy relative motions from
the first (the drift of odometry); the tool reports the ATE (the camera
centres' RMSE after a similarity alignment) before and after BA, the
reprojection statistics and the robust cost of every iteration.

    python -m ei_nexus_tpu_torch.slam_mvsec --ckpt <stage-1 checkpoint> \\
        [--data data/mini_mvsec] [--device cuda] [--frames 40] \\
        [--stride 2] [--topk 512] [--iters 12] [--check-sharded]

`--ckpt` takes a checkpoint directory of the port's trainers, a
reference `.pth` of a whole EIM, or an `.npz` exported from a JAX run
(`tools/export_jax_checkpoint.py`); only its event extractor is read.
`--device` defaults to the card. `--check-sharded` solves the same
problem again with its observations split over 2 gloo processes
(`parallel/ba.py:ba_solve(..., group=)`; the JAX tool's 8-device CPU
mesh) and prints the final costs of both solves. `slam_chain` is the
whole chain on frames already read (the dicts `MVSECSequence.view`
returns); `main` reads MVSEC from its HDF5 files and prints.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# the flagship stage-1 event extractor (configs/model/EIM_stage1.yaml)
BINS, HEIGHT, WIDTH = 16, 260, 346
EVENT_DT, MAX_EVENTS = 0.4, 1 << 18
MNN_RATIO = 0.95
HUBER_PX, Z_MIN = 2.0, 0.05
RANKS = 2   # the gloo processes of --check-sharded


def umeyama_ate(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """Camera-centre RMSE after a similarity (sim3) alignment: the gauge
    freedom of monocular BA (first pose fixed, scale free)."""
    mu_e = est_centers.mean(0)
    mu_g = gt_centers.mean(0)
    E = est_centers - mu_e
    G = gt_centers - mu_g
    U, S, Vt = np.linalg.svd(E.T @ G)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    # S comes from the un-normalised cross-covariance E^T G, so the
    # denominator is the un-normalised source energy
    s = (S * np.diag(D)).sum() / max((E ** 2).sum(), 1e-12)
    aligned = s * (E @ R) + mu_g
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean()))


def centers_from_poses6(poses6: np.ndarray) -> np.ndarray:
    """(M, 6) [so3 log | t] world->camera -> (M, 3) camera centres."""
    from .geometry.se3 import so3exp_map
    R = so3exp_map(torch.as_tensor(np.asarray(poses6[:, :3]))).numpy()
    t = poses6[:, 3:]
    return -np.einsum("mij,mi->mj", R, t)


def stage1_extractor(ckpt: str, topk: int, device) -> torch.nn.Module:
    """The flagship stage-1 event extractor (float32, K = `topk`) with a
    checkpoint's event-extractor weights, in eval mode on `device`: a
    checkpoint directory of the port's trainers, a reference `.pth` or an
    exported JAX `.npz` (strictly: every tensor of the extractor)."""
    from .models.extractor import KeypointExtractorConfig, VGGExtractor
    from .models.port_jax import load_jax_npz
    from .models.port_torch import (load_torch_file,
                                    load_vgg_extractor_torch_weights)
    from .train.checkpoint import load_stage1_event_extractor

    model = VGGExtractor(KeypointExtractorConfig(detection_top_k=topk),
                         in_channels=BINS, feat_channels=128,
                         descriptor_dim=256, lat_channels=256)
    holder = torch.nn.Module()
    holder.event_extractor = model
    path = str(ckpt)
    if path.endswith(".npz"):
        holder.load_state_dict({k: v for k, v in load_jax_npz(path).items()
                                if k.split(".")[0] == "event_extractor"},
                               strict=True)
    elif path.endswith((".pth", ".pt")):
        pre = "event_extractor.extractor."
        sd = {k[len(pre):]: v for k, v in load_torch_file(path).items()
              if k.startswith(pre)}
        model.load_state_dict(load_vgg_extractor_torch_weights(sd),
                              strict=True)
    else:
        load_stage1_event_extractor(path, holder)
    return model.to(device).eval()


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drifted_poses(P_wc: np.ndarray, drift: float) -> np.ndarray:
    """World->camera poses (M, 4, 4) re-accumulated from the first with
    noisy relative motions: each step's rotation by a rotation vector and
    its translation by a vector, both N(0, drift) per axis, from
    `np.random.default_rng(7)`."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(7)
    P_drift = [P_wc[0]]
    for i in range(1, len(P_wc)):
        rel = P_wc[i] @ np.linalg.inv(P_wc[i - 1])
        noise = np.eye(4)
        noise[:3, :3] = Rotation.from_rotvec(
            rng.normal(0, drift, 3)).as_matrix()
        noise[:3, 3] = rng.normal(0, drift, 3)
        P_drift.append(noise @ rel @ P_drift[-1])
    return np.stack(P_drift)


def reproj_stats(problem) -> Tuple[float, float]:
    """Median and share below 3 px of the valid observations'
    reprojection errors (a few tracks can collapse to the projection pole
    under the redescending loss, so the mean is no use)."""
    from .parallel.ba import residuals
    r = np.linalg.norm(residuals(problem).cpu().numpy(), axis=-1)
    v = problem.obs_valid.cpu().numpy()
    return (float(np.median(r[v])), float((r[v] < 3.0).mean()))


def slam_chain(frames: Sequence[Dict[str, np.ndarray]],
               extractor: torch.nn.Module, iters: int = 12,
               drift: float = 0.01, prior_weight: float = 50.0,
               gate_px: float = 15.0) -> Tuple[Dict[str, Any],
                                               Dict[str, Any]]:
    """The chain on keyframes read already (`MVSECSequence.view`'s dicts:
    padded events, K, pose) with `extractor` (its device is the chain's).
    Returns (the tool's metrics, in its key order, without "sequence" and
    "device"; what a further solve or a check needs: the gated problem,
    the prior, the solve's arguments, the refined problem and its costs,
    the true camera centres, the extract seconds, each keyframe's
    keypoints and the consecutive pairs' matches)."""
    from .models.mnn import mnn_match
    from .parallel.ba import _obs_z, ba_solve, residuals
    from .parallel.slam import Keyframe, build_ba_problem, chain_tracks
    from .train.steps import batch_representation

    dev = next(extractor.parameters()).device
    topk = extractor.config.detection_top_k
    n_kf = len(frames)

    # front end: the event extractor a frame, MNN between consecutive
    feats = []
    _synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        for fr in frames:
            ev = {k: np.asarray(v)[None] for k, v in fr.items()
                  if k.startswith("events")}
            rep, mask = batch_representation(ev, "VoxelGrid", BINS, HEIGHT,
                                             WIDTH, device=dev)
            out = extractor(rep, mask)
            feats.append({k: out[k] for k in (
                "sparse_positions", "sparse_descriptors", "sparse_valid")})
        _synchronize(dev)
        t_extract = time.perf_counter() - t0
        matches01, n_match = [], []
        for a, b in zip(feats[:-1], feats[1:]):
            m0 = mnn_match(a, b, ratio_thresh=MNN_RATIO)["matches0"][0]
            matches01.append(m0.cpu().numpy())
            n_match.append(int((matches01[-1] > -1).sum()))
    host = [{k: v.float().cpu().numpy() if v.is_floating_point()
             else v.cpu().numpy() for k, v in f.items()} for f in feats]

    # "pose" is world->camera (T_0to1 = pose1 @ inv(pose0))
    P_wc = np.stack([fr["pose"] for fr in frames]).astype(np.float64)

    def make_kfs(P):
        return [Keyframe(keypoints=host[i]["sparse_positions"][0],
                         valid=host[i]["sparse_valid"][0],
                         pose=P[i].astype(np.float32), K=frames[i]["K"])
                for i in range(n_kf)]

    tracks = chain_tracks(matches01, topk)
    prob = build_ba_problem(make_kfs(drifted_poses(P_wc, drift)), tracks,
                            min_track_len=3, device=dev)
    if prob is None:
        raise RuntimeError("the front end gave no track of 3 views")

    # the front end's outlier gate: every observation of a track that, at
    # the initial poses' own triangulation, has an observation behind a
    # camera or one reprojecting more than gate_px away is dropped
    r0 = np.linalg.norm(residuals(prob).cpu().numpy(), axis=-1)
    z0 = _obs_z(prob).cpu().numpy()
    obs_point = prob.obs_point.cpu().numpy()
    bad_obs = (z0 < Z_MIN) | (r0 > gate_px)
    bad_lm = np.zeros(prob.points.shape[0], bool)
    np.logical_or.at(bad_lm, obs_point[bad_obs], True)
    keep = ~bad_lm[obs_point]
    prob = prob._replace(obs_valid=torch.as_tensor(
        prob.obs_valid.cpu().numpy() & keep, device=dev))
    n_obs = int(keep.sum())
    n_lm = int((~bad_lm).sum())

    prior = prob.poses.clone() if prior_weight > 0 else None
    solve = dict(iters=iters, huber_delta=HUBER_PX, robust="cauchy",
                 z_min=Z_MIN, prior_weight=prior_weight)
    _synchronize(dev)
    t0 = time.perf_counter()
    refined, errs = ba_solve(prob, prior_poses=prior, **solve)
    errs = errs.cpu().numpy()
    t_ba = time.perf_counter() - t0

    gt_centers = centers_from_poses6(build_ba_problem(
        make_kfs(P_wc), tracks, min_track_len=3, device=dev).poses.cpu()
        .numpy())
    ate_before = umeyama_ate(centers_from_poses6(prob.poses.cpu().numpy()),
                             gt_centers)
    ate_after = umeyama_ate(
        centers_from_poses6(refined.poses.cpu().numpy()), gt_centers)
    metrics = {
        "keyframes": n_kf, "landmarks": n_lm, "observations": n_obs,
        "mnn_matches_per_pair": round(float(np.mean(n_match)), 1),
        "robust_cost": [round(float(e), 4) for e in errs],
        "reproj_median_px_and_frac3px_before": [round(x, 3) for x in
                                                reproj_stats(prob)],
        "reproj_median_px_and_frac3px_after": [round(x, 3) for x in
                                               reproj_stats(refined)],
        "ate_before_m": round(ate_before, 4),
        "ate_after_m": round(ate_after, 4),
        "ba_seconds": round(t_ba, 2),
    }
    run = {"problem": prob, "prior": prior, "solve": solve,
           "gt_centers": gt_centers, "refined": refined, "costs": errs,
           "tracks": len(tracks), "extract_seconds": t_extract,
           "keypoints": [h["sparse_positions"][0] for h in host],
           "matches01": matches01}
    return metrics, run


def _solve(problem, prior, solve: Dict[str, Any], group=None):
    from .parallel.ba import ba_solve
    if prior is not None:
        prior = prior.to(problem.poses.device)
    return ba_solve(problem, prior_poses=prior, group=group, **solve)


def ba_rank(problem, prior: Optional[torch.Tensor], solve: Dict[str, Any],
            device_type: str):
    """One rank's side of the sharded check (run by
    `parallel/dryrun.py:launch`): its contiguous share of the
    observations, the poses, points and prior whole, on this rank's device
    (the current card for "cuda"), solved over the default group. Returns
    (the refined poses, the costs) on the CPU."""
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    rank, world = dist.get_rank(), dist.get_world_size()
    O = problem.obs_pose.shape[0]
    rows = slice(rank * O // world, (rank + 1) * O // world)
    problem = problem.to(dev)
    problem = problem._replace(**{f: getattr(problem, f)[rows] for f in (
        "obs_pose", "obs_point", "obs_uv", "obs_valid")})
    refined, errs = _solve(problem, prior, solve, dist.group.WORLD)
    return refined.poses.cpu(), errs.cpu()


def check_sharded(run: Dict[str, Any]) -> Dict[str, Any]:
    """The gated problem of `slam_chain` padded with invalid observations
    to a multiple of RANKS, solved in this process and over RANKS gloo
    processes on the same device type; the final costs of both and the
    ATE after the sharded solve."""
    from .parallel.dryrun import launch

    prob, prior, solve = run["problem"], run["prior"], run["solve"]
    pad = (-prob.obs_pose.shape[0]) % RANKS

    def padded(a, fill=0):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])

    prob_p = prob._replace(obs_pose=padded(prob.obs_pose),
                           obs_point=padded(prob.obs_point),
                           obs_uv=padded(prob.obs_uv),
                           obs_valid=padded(prob.obs_valid, False))
    _, errs_s = _solve(prob_p, prior, solve)
    # the ranks import this module by its name (a `python -m` run's own
    # functions belong to __main__)
    rank_fn = importlib.import_module("ei_nexus_tpu_torch.slam_mvsec").ba_rank
    out = launch(rank_fn, RANKS, (prob_p.to("cpu"),
                                  None if prior is None else prior.cpu(),
                                  solve, prob.poses.device.type),
                 device=prob.poses.device.type, backend="gloo")
    poses_m, errs_m = out[0]
    for r, (p, e) in enumerate(out[1:], 1):
        if not (torch.equal(p, poses_m) and torch.equal(e, errs_m)):
            raise RuntimeError(f"rank {r}'s solve differs from rank 0's")
    ate_sh = umeyama_ate(centers_from_poses6(poses_m.numpy()),
                         run["gt_centers"])
    return {"sharded_check": f"{RANKS} gloo ranks vs one process",
            "final_cost_single": round(float(errs_s[-1]), 4),
            "final_cost_sharded": round(float(errs_m[-1]), 4),
            "ate_after_sharded_m": round(ate_sh, 4)}


def main(argv=None) -> Dict[str, Any]:
    from .device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="stage-1 checkpoint: a directory of the port's "
                        "trainers, a reference .pth or an exported .npz")
    p.add_argument("--data", default="data/mini_mvsec")
    p.add_argument("--sequence", default="indoor_flying1")
    p.add_argument("--device", default="cuda",
                   help="the card (default) or another torch device")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--topk", type=int, default=512)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--drift", type=float, default=0.01,
                   help="per-step relative-pose noise (rad / m units)")
    p.add_argument("--prior-weight", type=float, default=50.0,
                   help="odometry prior weight (px per rad|m; 0 = off)")
    p.add_argument("--gate-px", type=float, default=15.0,
                   help="front-end track gate at init (px; scale with "
                        "--drift)")
    p.add_argument("--check-sharded", action="store_true")
    args = p.parse_args(argv)

    from .data.mvsec import MVSECArchive, MVSECSequence
    dev = resolve_device(args.device)
    extractor = stage1_extractor(args.ckpt, args.topk, dev)
    seq = MVSECSequence(MVSECArchive(args.data), args.sequence)
    n_kf = min(args.frames, len(seq) // args.stride)
    frames = [seq.view(i * args.stride, EVENT_DT, MAX_EVENTS)
              for i in range(n_kf)]
    metrics, run = slam_chain(frames, extractor, iters=args.iters,
                              drift=args.drift,
                              prior_weight=args.prior_weight,
                              gate_px=args.gate_px)
    print(f"front-end: {metrics['keyframes']} keyframes (stride "
          f"{args.stride}), {metrics['mnn_matches_per_pair']:.0f} MNN "
          f"matches/pair, {run['tracks']} tracks -> {metrics['landmarks']} "
          f"gated landmarks / {metrics['observations']} obs (extract "
          f"{run['extract_seconds']:.1f}s)", flush=True)
    result = {"sequence": args.sequence, **metrics, "device": str(dev)}
    print(json.dumps(result), flush=True)
    if args.check_sharded:
        result["sharded"] = check_sharded(run)
        print(json.dumps(result["sharded"]), flush=True)
    return result


if __name__ == "__main__":
    main()
