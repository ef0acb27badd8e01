"""Epipolar geometry: essential and fundamental matrices, symmetric
epipolar distances, the decomposition of an essential matrix and angular
pose errors.

Counterpart of `ei_nexus_tpu/geometry/epipolar.py`; every function follows
its inputs' device and dtype.
"""

from __future__ import annotations

import torch

from .camera import Camera
from .se3 import Pose, skew_symmetric, to_homogeneous


def T_to_E(T: Pose) -> torch.Tensor:
    """Pose -> essential matrix E = [t]x R."""
    return skew_symmetric(T.t) @ T.R


def E_to_F(cam0: Camera, cam1: Camera, E: torch.Tensor) -> torch.Tensor:
    """Essential -> fundamental matrix: K1^-T E K0^-1."""
    K0inv = torch.linalg.inv(cam0.calibration_matrix())
    K1inv = torch.linalg.inv(cam1.calibration_matrix())
    return K1inv.mT @ E @ K0inv


def T_to_F(cam0: Camera, cam1: Camera, T_0to1: Pose) -> torch.Tensor:
    return E_to_F(cam0, cam1, T_to_E(T_0to1))


def F_to_E(cam0: Camera, cam1: Camera, F: torch.Tensor) -> torch.Tensor:
    """Fundamental -> essential matrix: K1^T F K0."""
    return cam1.calibration_matrix().mT @ F @ cam0.calibration_matrix()


def sym_epipolar_distance(p0: torch.Tensor, p1: torch.Tensor,
                          E: torch.Tensor, squared: bool = True
                          ) -> torch.Tensor:
    """Symmetric epipolar distance of N aligned point pairs: p0, p1
    (..., N, 2|3), E (..., 3, 3) -> (..., N). The squared line norms are
    floored at 1e-6."""
    if p0.shape[-1] != 3:
        p0 = to_homogeneous(p0)
    if p1.shape[-1] != 3:
        p1 = to_homogeneous(p1)
    p1_E_p0 = torch.einsum("...ni,...ij,...nj->...n", p1, E, p0)
    E_p0 = torch.einsum("...ij,...nj->...ni", E, p0)
    Et_p1 = torch.einsum("...ij,...ni->...nj", E, p1)
    d0 = (E_p0[..., 0] ** 2 + E_p0[..., 1] ** 2).clamp(min=1e-6)
    d1 = (Et_p1[..., 0] ** 2 + Et_p1[..., 1] ** 2).clamp(min=1e-6)
    if squared:
        return p1_E_p0 ** 2 * (1 / d0 + 1 / d1)
    return p1_E_p0.abs() * (1 / torch.sqrt(d0) + 1 / torch.sqrt(d1)) / 2


def sym_epipolar_distance_all(p0: torch.Tensor, p1: torch.Tensor,
                              E: torch.Tensor, eps: float = 1e-15
                              ) -> torch.Tensor:
    """All-pairs symmetric epipolar distance: p0 (..., N, 2|3), p1
    (..., M, 2|3), E (..., 3, 3) -> (..., N, M)."""
    if p0.shape[-1] != 3:
        p0 = to_homogeneous(p0)
    if p1.shape[-1] != 3:
        p1 = to_homogeneous(p1)
    p1_E_p0 = torch.einsum("...mi,...ij,...nj->...nm", p1, E, p0).abs()
    E_p0 = torch.einsum("...ij,...nj->...ni", E, p0)
    Et_p1 = torch.einsum("...ij,...mi->...mj", E, p1)
    d0 = p1_E_p0 / torch.sqrt(E_p0[..., None, 0] ** 2
                              + E_p0[..., None, 1] ** 2 + eps)
    d1 = p1_E_p0 / torch.sqrt(Et_p1[..., None, :, 0] ** 2
                              + Et_p1[..., None, :, 1] ** 2 + eps)
    return (d0 + d1) / 2


def decompose_essential_matrix(E: torch.Tensor):
    """E (..., 3, 3) -> (R1, R2, t), the candidate rotations and the
    translation direction. U and Vt are made proper rotations by flipping
    their last column (row) where their determinant is negative, so
    det(R1) = det(R2) = +1; the SVD's signs are the library's, so R1 and
    R2 may come in either order and t with either sign."""
    U, _, Vt = torch.linalg.svd(E)
    U = torch.where((torch.linalg.det(U) < 0)[..., None, None],
                    torch.cat([U[..., :2], -U[..., 2:]], dim=-1), U)
    Vt = torch.where((torch.linalg.det(Vt) < 0)[..., None, None],
                     torch.cat([Vt[..., :2, :], -Vt[..., 2:, :]], dim=-2),
                     Vt)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., -1]


def angle_error_mat(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angular distance in degrees between two rotation matrices."""
    trace = (R1.mT @ R2).diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = ((trace - 1) / 2).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos).abs())


def angle_error_vec(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-10
                    ) -> torch.Tensor:
    """Angular distance in degrees between two vectors."""
    n = (torch.linalg.vector_norm(v1, dim=-1)
         * torch.linalg.vector_norm(v2, dim=-1)).clamp(min=eps)
    cos = ((v1 * v2).sum(-1) / n).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def relative_pose_error(T_0to1: Pose, R: torch.Tensor, t: torch.Tensor,
                        eps: float = 1e-10):
    """(t_err, R_err) in degrees of an estimated relative pose against the
    truth; t_err is folded to <= 90 degrees (an essential matrix fixes t
    up to its sign)."""
    t_err = angle_error_vec(t, T_0to1.t, eps)
    t_err = torch.minimum(t_err, 180.0 - t_err)
    return t_err, angle_error_mat(R, T_0to1.R)


def generalized_epi_dist(kpts0: torch.Tensor, kpts1: torch.Tensor,
                         cam0: Camera, cam1: Camera, T_0to1: Pose,
                         all_pairs: bool = True, essential: bool = True
                         ) -> torch.Tensor:
    """Epipolar distances in normalised camera coordinates (`essential`)
    or in pixels (the fundamental matrix), all pairs (..., N, M) or
    aligned pairs (..., N)."""
    if essential:
        E = T_to_E(T_0to1)
        p0 = cam0.image2cam(kpts0)
        p1 = cam1.image2cam(kpts1)
        if all_pairs:
            return sym_epipolar_distance_all(p0, p1, E)
        return sym_epipolar_distance(p0, p1, E, squared=False)
    F = E_to_F(cam0, cam1, T_to_E(T_0to1))
    if all_pairs:
        return sym_epipolar_distance_all(kpts0, kpts1, F)
    return sym_epipolar_distance(kpts0, kpts1, F, squared=False)
