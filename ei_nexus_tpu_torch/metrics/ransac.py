"""Batched essential-matrix RANSAC and pose recovery, on whatever device
its inputs lie (the card for the serving path with pose).

Counterpart of `ei_nexus_tpu/metrics/ransac.py` with its per-pair
functions written out over a leading pair dimension B (the JAX package
vmaps them); static shapes throughout, so a call makes no host sync of its
own:
 1. S random minimal samples of the valid correspondences per pair;
 2. "5pt" (default): Nistér's solver (metrics/fivepoint.py), up to 10
    candidates a sample, ranked on a 128-point random subset so that only
    each sample's best candidate is fully scored (two-phase scoring, the
    JAX package's default); "8pt": the nullspace of the (8, 9) constraints
    from a complete QR, projected onto the essential manifold;
 3. score by symmetric epipolar distance under the threshold, keep the
    best hypothesis (first on ties);
 4. decompose E and resolve the 4-fold (R, t) ambiguity by cheirality
    votes over the inliers.

Sampling. torch cannot replay `jax.random.categorical`, so the samples are
injectable: `indices=(samples, subset)`, samples (B, S, 5 or 8) slot
indices and subset the (B, 128) phase-1 points (None for 8pt or without
two-phase scoring). Otherwise they are drawn uniformly with replacement
over each pair's valid slots from a torch.Generator on the inputs' device.
A pair with no valid slot samples slot 0 everywhere, as `categorical`
over all -inf logits does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .fivepoint import five_point_candidates

_PHASE1_POINTS = 128


def _gather(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p (B, N, 2), idx (B, ...) -> (B, ..., 2): p[b, idx[b, ...]]."""
    B = p.shape[0]
    flat = idx.reshape(B, -1, 1).expand(-1, -1, p.shape[-1])
    return torch.gather(p, 1, flat).reshape(*idx.shape, p.shape[-1])


def _take(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x (B, H, ...) at best (B,) -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), best]


def _eight_point(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """(..., 8, 2) normalized correspondences -> (..., 3, 3) essential
    matrices (x1^T E x0 = 0 with x = (x, y, 1))."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = torch.ones_like(x0)
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     ones], dim=-1)                      # (..., 8, 9)
    # the 1-D nullspace: trailing column of a complete QR of A^T
    Q, _ = torch.linalg.qr(A.mT, mode="complete")
    E = Q[..., -1].reshape(*Q.shape[:-2], 3, 3)
    # project onto the essential manifold (singular values -> 1, 1, 0)
    U, _, Vt = torch.linalg.svd(E)
    D = torch.eye(3, dtype=E.dtype, device=E.device)
    D[2, 2:] = 0.0      # a slice: see _decompose_E
    return U @ D @ Vt


def _sym_epi_dist(p0: torch.Tensor, p1: torch.Tensor,
                  E: torch.Tensor) -> torch.Tensor:
    """p0, p1 (B, N, 2), E (B, *H, 3, 3) -> (B, *H, N) symmetric epipolar
    distance of every point under every hypothesis."""
    B, N = p0.shape[:2]
    H = E.shape[1:-2]
    Ef = E.reshape(B, -1, 3, 3)
    p0h = torch.cat([p0, torch.ones_like(p0[..., :1])], dim=-1)
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    Ep0 = torch.einsum("bhij,bnj->bhni", Ef, p0h)
    Etp1 = torch.einsum("bhji,bnj->bhni", Ef, p1h)
    num = torch.einsum("bni,bhni->bhn", p1h, Ep0)
    d0 = Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2
    d1 = Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2
    d = num.abs() * (1 / d0.clamp(min=1e-12).sqrt()
                     + 1 / d1.clamp(min=1e-12).sqrt()) / 2
    return d.reshape(B, *H, N)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactors (its sign is all
    that is read: of orthogonal matrices, +-1)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    return (a * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - b * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + c * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _decompose_E(E: torch.Tensor):
    """(..., 3, 3) -> (R1, R2, t): the two rotations and the translation
    direction of E = [t]x R, U and V^T made proper rotations first."""
    U, _, Vt = torch.linalg.svd(E)
    flip = torch.ones_like(E)
    flip[..., :, -1] = -1.0
    U = torch.where((_det3(U) < 0)[..., None, None], U * flip, U)
    Vt = torch.where((_det3(Vt) < 0)[..., None, None], Vt * flip.mT, Vt)
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], filled on the device through
    # slices: setting one element copies a host scalar and synchronises
    W = torch.zeros(3, 3, dtype=E.dtype, device=E.device)
    W[0, 1:2], W[1, 0:1], W[2, 2:] = -1.0, 1.0, 1.0
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, -1]


def _triangulate_depths(p0h, p1h, R, t):
    """Linear two-view depths, solving [R p0h, -p1h] [z0, z1]^T = -t per
    point. p0h, p1h (B, N, 3); R (B, 3, 3); t (B, 3) -> (z0, z1) (B, N)."""
    a = torch.einsum("bij,bnj->bni", R, p0h)
    b = -p1h
    mt = -t[:, None, :]
    # normal equations of the 3x2 least-squares system [a b] z = -t
    aa = (a * a).sum(-1)
    ab = (a * b).sum(-1)
    bb = (b * b).sum(-1)
    at = (a * mt).sum(-1)
    bt = (b * mt).sum(-1)
    det = aa * bb - ab * ab
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    return (at * bb - bt * ab) / det, (aa * bt - ab * at) / det


def sample_indices(mask: torch.Tensor, n_hypotheses: int, solver: str,
                   generator: Optional[torch.Generator] = None,
                   two_phase: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(samples (B, S, 5 or 8), subset (B, 128) or None) drawn uniformly
    with replacement over each pair's valid slots (mask (B, N)), on the
    mask's device; a pair with no valid slot gets slot 0 everywhere."""
    B, N = mask.shape
    if generator is None:
        generator = torch.Generator(device=mask.device).manual_seed(0)
    # multinomial refuses an all-zero row: such rows weigh slot 0 alone
    first = torch.zeros(N, dtype=torch.float32, device=mask.device)
    first[:1] = 1.0     # a slice: see _decompose_E
    w = torch.where(mask.any(dim=-1, keepdim=True), mask.float(), first)
    k = 5 if solver == "5pt" else 8
    samples = torch.multinomial(w, n_hypotheses * k, replacement=True,
                                generator=generator)
    subset = None
    if solver == "5pt" and two_phase:
        subset = torch.multinomial(w, _PHASE1_POINTS, replacement=True,
                                   generator=generator)
    return samples.reshape(B, n_hypotheses, k), subset


def estimate_essential_ransac(
    p0: torch.Tensor, p1: torch.Tensor, mask: torch.Tensor,
    thresh: torch.Tensor, n_hypotheses: int = 512, solver: str = "8pt",
    two_phase: bool = True,
    indices: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
):
    """RANSAC essential matrices for B pairs (fixed size, maskable).

    p0, p1: (B, N, 2) K-normalized coords; mask: (B, N) valid
    correspondences; thresh: (B,) inlier thresholds (normalized units).
    solver "8pt" (one hypothesis a sample) or "5pt" (up to 10 candidates a
    sample; with two_phase, each sample's candidates are ranked on the
    phase-1 subset and only the best is scored on all points). indices:
    injected (samples, subset), else drawn from `generator`.
    Returns (E (B, 3, 3), inliers (B, N) bool, n_inliers (B,))."""
    B = p0.shape[0]
    if indices is None:
        indices = sample_indices(mask, n_hypotheses, solver, generator,
                                 two_phase)
    samples, subset = indices
    S = samples.shape[1]
    if solver == "5pt":
        E, valid = five_point_candidates(
            _gather(p0, samples).reshape(B * S, 5, 2),
            _gather(p1, samples).reshape(B * S, 5, 2))
        E, valid = E.reshape(B, S, 10, 3, 3), valid.reshape(B, S, 10)
        E = torch.where(torch.isfinite(E).all(-1).all(-1)[..., None, None],
                        E, 0.0)
        if two_phase:
            d1 = _sym_epi_dist(_gather(p0, subset), _gather(p1, subset), E)
            s1 = torch.where(valid, (d1 < thresh[:, None, None, None]).sum(
                -1), -1)                                 # (B, S, 10)
            cand = s1.argmax(dim=-1)                     # (B, S)
            E = torch.gather(E, 2, cand[..., None, None, None].expand(
                -1, -1, 1, 3, 3))[:, :, 0]
            valid = torch.gather(valid, 2, cand[..., None])[..., 0]
        else:
            E = E.reshape(B, S * 10, 3, 3)
            valid = valid.reshape(B, S * 10)
    else:
        E = _eight_point(_gather(p0, samples), _gather(p1, samples))
        valid = torch.ones(E.shape[:2], dtype=torch.bool, device=E.device)
        E = torch.where(torch.isfinite(E).all(-1).all(-1)[..., None, None],
                        E, 0.0)
    d = _sym_epi_dist(p0, p1, E)                         # (B, H, N)
    inl = (d < thresh[:, None, None]) & mask[:, None]
    scores = torch.where(valid, inl.sum(-1), -1)
    best = scores.argmax(dim=-1)
    return (_take(E, best), _take(inl, best),
            _take(scores, best).clamp(min=0))


def recover_pose_from_essential(E: torch.Tensor, p0: torch.Tensor,
                                p1: torch.Tensor, inliers: torch.Tensor):
    """Resolve the 4-fold (R, t) ambiguity of E (B, 3, 3) by cheirality
    votes over the inliers (B, N). Returns (R (B, 3, 3), t (B, 3)) with
    x1 ~ R x0 + t."""
    R1, R2, t = _decompose_E(E)
    p0h = torch.cat([p0, torch.ones_like(p0[..., :1])], dim=-1)
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    Rs = torch.stack([R1, R1, R2, R2], dim=1)
    ts = torch.stack([t, -t, t, -t], dim=1)
    votes = []
    for i in range(4):
        z0, z1 = _triangulate_depths(p0h, p1h, Rs[:, i], ts[:, i])
        votes.append(((z0 > 0) & (z1 > 0) & inliers).sum(-1))
    best = torch.stack(votes, dim=-1).argmax(dim=-1)
    return _take(Rs, best), _take(ts, best)


def estimate_pose_batch(
    p0: torch.Tensor, p1: torch.Tensor, mask: torch.Tensor,
    thresh: torch.Tensor, n_hypotheses: Optional[int] = None,
    solver: str = "5pt",
    indices: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
):
    """Pose of B pairs at once: p0, p1 (B, N, 2) normalized coords, mask
    (B, N), thresh (B,). Returns (R (B, 3, 3), t (B, 3), inliers (B, N),
    n_inliers (B,)). Defaults: 5-point with 128 samples (1024 for 8pt)."""
    if n_hypotheses is None:
        n_hypotheses = 128 if solver == "5pt" else 1024
    E, inl, n = estimate_essential_ransac(
        p0, p1, mask, thresh, n_hypotheses=n_hypotheses, solver=solver,
        indices=indices, generator=generator)
    R, t = recover_pose_from_essential(E, p0, p1, inl)
    return R, t, inl, n


def estimate_pose_batch_from_matches(
    positions0: np.ndarray, positions1: np.ndarray, matches0: np.ndarray,
    K0: np.ndarray, K1: np.ndarray, thresh: float, ordering: str = "yx",
    n_hypotheses: Optional[int] = None, solver: str = "5pt",
    indices: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """One device call for a batch of fixed-K match outputs.

    positions0/1: (B, K, >=2) keypoints (`ordering`); matches0: (B, K) slot
    indices into positions1, < 0 unmatched; K0/K1: (B, 3, 3); thresh: the
    pixel threshold, normalized per pair by the mean focal length. The
    correspondences are built and K-normalized on the host, then posed on
    `device` (the card unless the caller names another). Returns B entries:
    (R, t, inlier mask over the matched slots) or None (too few matches or
    inliers)."""
    dev = resolve_device(device)
    if n_hypotheses is None:
        n_hypotheses = 128 if solver == "5pt" else 1024
    min_n = 5 if solver == "5pt" else 8
    matches0 = np.asarray(matches0)
    B, K = matches0.shape
    sel = matches0 > -1                                    # (B, K)
    idx = np.clip(matches0, 0, K - 1)
    p0 = np.ascontiguousarray(np.asarray(positions0)[..., :2], np.float32)
    p1 = np.take_along_axis(
        np.ascontiguousarray(np.asarray(positions1)[..., :2], np.float32),
        idx[..., None], axis=1)
    if ordering == "yx":
        p0, p1 = p0[..., ::-1], p1[..., ::-1]
    K0 = np.asarray(K0, np.float64).reshape(B, 3, 3)
    K1 = np.asarray(K1, np.float64).reshape(B, 3, 3)
    c0 = K0[:, [0, 1], [2, 2]][:, None]                    # (B, 1, 2)
    f0 = K0[:, [0, 1], [0, 1]][:, None]
    c1 = K1[:, [0, 1], [2, 2]][:, None]
    f1 = K1[:, [0, 1], [0, 1]][:, None]
    p0n = ((p0 - c0) / f0).astype(np.float32)
    p1n = ((p1 - c1) / f1).astype(np.float32)
    thr = thresh / np.mean(
        np.stack([K0[:, 0, 0], K1[:, 1, 1], K0[:, 0, 0], K1[:, 1, 1]], -1),
        axis=-1).astype(np.float32)                        # (B,)
    R, t, inl, n_inl = estimate_pose_batch(
        torch.as_tensor(p0n, device=dev), torch.as_tensor(p1n, device=dev),
        torch.as_tensor(sel, device=dev),
        torch.as_tensor(np.asarray(thr, np.float32), device=dev),
        n_hypotheses=n_hypotheses, solver=solver, indices=indices,
        generator=generator)
    R = R.cpu().numpy().astype(np.float64)
    t = t.cpu().numpy().astype(np.float64)
    inl = inl.cpu().numpy()
    n_inl = n_inl.cpu().numpy()
    n_matches = sel.sum(-1)
    return [None if n_matches[b] < min_n or n_inl[b] < min_n
            else (R[b], t[b], inl[b][sel[b]]) for b in range(B)]


def estimate_pose_torch(
    p0n: np.ndarray, p1n: np.ndarray, thresh: float, solver: str = "5pt",
    device: Optional[Union[str, torch.device]] = "cuda",
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """One pair's pose with the contract of the OpenCV backend of
    `RelativePoseEstimation.estimate_pose`: (R, t, inlier mask) or None.

    The counterpart of the JAX package's `estimate_pose_jax`: p0n, p1n
    (N, 2) K-normalised correspondences are cut to 2048, padded to a power
    of two (at least 8) and masked, then posed by `estimate_pose_batch` as
    one pair on `device` (the card unless the caller names another) with
    its default hypotheses, the samples drawn by `sample_indices` from a
    generator seeded 0. None with fewer than 5 (8 for 8pt)
    correspondences or inliers."""
    dev = resolve_device(device)
    min_n = 5 if solver == "5pt" else 8
    n = len(p0n)
    if n < min_n:
        return None
    n_pad = min(2048, int(2 ** np.ceil(np.log2(max(n, 8)))))
    if n > n_pad:
        p0n, p1n = p0n[:n_pad], p1n[:n_pad]
        n = n_pad
    pad = ((0, n_pad - n), (0, 0))
    p0 = np.pad(np.asarray(p0n, np.float32), pad)
    p1 = np.pad(np.asarray(p1n, np.float32), pad)
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    R, t, inl, n_inl = estimate_pose_batch(
        torch.as_tensor(p0[None], device=dev),
        torch.as_tensor(p1[None], device=dev),
        torch.as_tensor(mask[None], device=dev),
        torch.full((1,), thresh, dtype=torch.float32, device=dev),
        solver=solver)
    if int(n_inl[0]) < min_n:
        return None
    return (R[0].cpu().numpy().astype(np.float64),
            t[0].cpu().numpy().astype(np.float64),
            inl[0].cpu().numpy()[:len(p0n)])
