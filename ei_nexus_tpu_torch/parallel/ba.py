"""Schur-complement bundle adjustment and pose-graph relaxation.

Counterpart of `ei_nexus_tpu/parallel/ba.py`, on one device or with the
observations sharded over the ranks of a process group: M keyframes
(se3 twists), L landmarks and O observations as flat index and
measurement tensors with validity masks. Each Levenberg-Marquardt step
builds the reduced camera system implicitly: the 3x3 landmark blocks are
inverted in closed form (`torch.linalg.inv_ex`, no info check and so no
host sync), and S dp = b is solved matrix-free by Jacobi-preconditioned
conjugate gradients, every iteration two `index_add_` segment sums over
the observations. The JAX package's `lax.scan` loops are Python loops of
fixed length, and the LM accept is a `torch.where` over the problem's
fields, so a solve reads nothing back to the host. Everything is float32.

Sharded (`ba_solve(..., group=)`), as the JAX package's solve runs with
the observation arrays sharded over a mesh: each rank holds its rows of
the obs_* fields and the same poses, points, intrinsics and fixed_poses;
every segment sum over the observations (Hpp, Hll, bp, bl, and the W and
W^T products: two a CG step) and the cost's numerator and count are
all-reduced, so the replicated fields stay equal on every rank.

Conventions: twists are (rot, trans) 6-vectors mapping world -> camera as
x_cam = R(w) x_world + t; pinhole projection with per-keyframe
intrinsics (fx, fy, cx, cy).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..geometry.se3 import skew_symmetric, so3exp_map


class BAProblem(NamedTuple):
    """Fixed-shape bundle adjustment problem.

    poses:      (M, 6)  se3 twists (w, t), world->camera
    intrinsics: (M, 4)  fx, fy, cx, cy
    points:     (L, 3)  world landmarks
    obs_pose:   (O,)    keyframe index per observation
    obs_point:  (O,)    landmark index per observation
    obs_uv:     (O, 2)  pixel measurements
    obs_valid:  (O,)    validity mask
    fixed_poses:(M,)    True = keep this pose fixed (gauge)
    """

    poses: torch.Tensor
    intrinsics: torch.Tensor
    points: torch.Tensor
    obs_pose: torch.Tensor
    obs_point: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor
    fixed_poses: torch.Tensor

    def to(self, device) -> "BAProblem":
        return BAProblem(*(t.to(device) for t in self))


def _transform(pose6: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    R = so3exp_map(pose6[..., :3])
    return torch.einsum("...ij,...j->...i", R, X) + pose6[..., 3:]


def _project(intr: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    z = Xc[..., 2].clamp(min=1e-6)
    u = intr[..., 0] * Xc[..., 0] / z + intr[..., 2]
    v = intr[..., 1] * Xc[..., 1] / z + intr[..., 3]
    return torch.stack([u, v], dim=-1)


def residuals(problem: BAProblem) -> torch.Tensor:
    """(O, 2) masked reprojection residuals."""
    pose = problem.poses[problem.obs_pose]
    intr = problem.intrinsics[problem.obs_pose]
    X = problem.points[problem.obs_point]
    r = _project(intr, _transform(pose, X)) - problem.obs_uv
    return r * problem.obs_valid[..., None]


def _obs_jacobians(problem: BAProblem):
    """Per-observation Jacobians: Jp (O, 2, 6) with respect to the pose
    twist (left-multiplied increment), Jx (O, 2, 3) to the landmark."""
    pose = problem.poses[problem.obs_pose]
    intr = problem.intrinsics[problem.obs_pose]
    X = problem.points[problem.obs_point]
    Xc = _transform(pose, X)
    z = Xc[..., 2].clamp(min=1e-6)
    fx, fy = intr[..., 0], intr[..., 1]
    x, y = Xc[..., 0], Xc[..., 1]
    zero = torch.zeros_like(z)
    Jproj = torch.stack([
        torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
        torch.stack([zero, fy / z, -fy * y / z ** 2], -1),
    ], -2)                                                   # (O, 2, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device)
    JXc_pose = torch.cat([-skew_symmetric(Xc),
                          eye.expand(Xc.shape[:-1] + (3, 3))], -1)
    Jp = Jproj @ JXc_pose                                    # (O, 2, 6)
    Jx = Jproj @ so3exp_map(pose[..., :3])                   # (O, 2, 3)
    m = problem.obs_valid[..., None, None]
    return Jp * m, Jx * m


def _obs_z(problem: BAProblem) -> torch.Tensor:
    """(O,) camera-frame depth of each observed landmark."""
    return _transform(problem.poses[problem.obs_pose],
                      problem.points[problem.obs_point])[..., 2]


def _irls_weights(r: torch.Tensor, delta: float, robust: str
                  ) -> torch.Tensor:
    """(O,) square-root IRLS weights of the robust loss on each residual
    pair's 2-norm, applied to residuals and Jacobians alike. huber: 1
    inside delta, delta/|r| outside (monotone); cauchy: 1/(1+(|r|/delta)^2)
    (redescending: gross outliers get about no influence)."""
    n2 = (r * r).sum(-1) + 1e-12
    if robust == "cauchy":
        return torch.sqrt(1.0 / (1.0 + n2 / (delta * delta)))
    return torch.sqrt((delta / torch.sqrt(n2)).clamp(max=1.0))


def _segment_sum(idx: torch.Tensor, values: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """sum of `values` rows grouped by `idx` into n rows."""
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, idx, values)


def ba_solve(problem: BAProblem, iters: int = 10, cg_iters: int = 20,
             damping: float = 1e-4,
             huber_delta: Optional[float] = None,
             z_min: Optional[float] = None,
             robust: str = "huber",
             prior_poses: Optional[torch.Tensor] = None,
             prior_weight: float = 1.0,
             group: Any = None,
             ) -> Tuple[BAProblem, torch.Tensor]:
    """Levenberg-Marquardt BA with the Schur complement and matrix-free CG.

    huber_delta: the robust loss's scale in pixels (IRLS weighting of
    residuals and Jacobians; the accept test scores the robust cost);
    robust: "huber" or "cauchy". z_min: the cheirality gate, observations
    whose landmark lies at camera depth < z_min get no weight in this
    iteration (without it a point behind a camera sits on the projection's
    z-clamp pole and its ~1e9 px residual dominates). prior_poses /
    prior_weight: a Gaussian pose prior, residuals prior_weight *
    log(P @ P_prior^-1) per free pose (Hpp += w^2 I, bp -= w^2 rel),
    scored by the accept test too. group: a process group over which the
    observations are sharded (see the module's docstring); None solves
    the problem this rank holds alone.

    Returns (refined problem, the mean cost before and after each
    iteration (iters + 1,): squared-px MSE, or the mean robust cost)."""
    M = problem.poses.shape[0]
    L = problem.points.shape[0]
    op = problem.obs_pose.long()
    ox = problem.obs_point.long()
    free = (~problem.fixed_poses)[:, None]
    fixed = problem.fixed_poses[:, None, None]
    dev, f32 = problem.poses.device, problem.poses.dtype
    eye6 = torch.eye(6, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)

    def seg(idx, values, n):
        """A segment sum over every rank's observations."""
        out = _segment_sum(idx, values, n)
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    def gate(prob, dtype):
        g = prob.obs_valid.to(dtype)
        if z_min is not None:
            g = g * (_obs_z(prob) > z_min)
        return g

    def prior_rel(prob):
        return _pose_compose(prob.poses, _pose_inv(prior_poses))

    def gn_step(prob: BAProblem, lam: torch.Tensor) -> BAProblem:
        r = residuals(prob)                                  # (O, 2)
        Jp, Jx = _obs_jacobians(prob)
        w = gate(prob, r.dtype)
        if huber_delta is not None:
            w = w * _irls_weights(r, huber_delta, robust)
        r = r * w[:, None]
        Jp = Jp * w[:, None, None]
        Jx = Jx * w[:, None, None]

        Hpp = seg(op, torch.einsum("oik,oil->okl", Jp, Jp), M)
        Hll = seg(ox, torch.einsum("oik,oil->okl", Jx, Jx), L)
        bp = seg(op, -torch.einsum("oik,oi->ok", Jp, r), M)
        bl = seg(ox, -torch.einsum("oik,oi->ok", Jx, r), L)
        if prior_poses is not None:
            Hpp = Hpp + (prior_weight ** 2) * eye6
            bp = bp - (prior_weight ** 2) * prior_rel(prob)
        Hpp_d = Hpp + lam * eye6
        Hll_inv = torch.linalg.inv_ex(Hll + lam * eye3).inverse
        # gauge: fixed poses get identity rows (zero update)
        Hpp_d = torch.where(fixed, eye6, Hpp_d)
        bp = bp * free

        def W_apply(y_l):
            """x_m = sum over observations of Jp^T Jx y[landmark]."""
            return seg(
                op, torch.einsum("oik,oil,ol->ok", Jp, Jx, y_l[ox]), M)

        def Wt_apply(x_m):
            return seg(
                ox, torch.einsum("oik,oil,ok->ol", Jp, Jx, x_m[op]), L)

        b_red = bp - W_apply(torch.einsum("lij,lj->li", Hll_inv, bl))
        b_red = b_red * free

        def S_apply(x_m):
            """S x = (Hpp + lam) x - W Hll^-1 W^T x, matrix-free."""
            x_m = x_m * free
            h = torch.einsum("mij,mj->mi", Hpp_d, x_m)
            h = h - W_apply(torch.einsum("lij,lj->li", Hll_inv,
                                         Wt_apply(x_m)))
            return h * free + x_m * problem.fixed_poses[:, None]

        precond = 1.0 / Hpp_d.diagonal(dim1=-2, dim2=-1).clamp(min=1e-8)
        x = torch.zeros(M, 6, dtype=f32, device=dev)
        rr = b_red
        p = rr * precond
        rz = (rr * p).sum()
        for _ in range(cg_iters):
            Sp = S_apply(p)
            alpha = rz / (p * Sp).sum().clamp(min=1e-12)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = rr * precond
            rz_new = (rr * z).sum()
            beta = rz_new / rz.clamp(min=1e-12)
            p = z + beta * p
            rz = rz_new
        dp = x

        # back-substitute landmarks: dl = Hll^-1 (bl - W^T dp)
        dl = torch.einsum("lij,lj->li", Hll_inv, bl - Wt_apply(dp))
        # left-multiplied pose update: T_new = exp(dp) * T
        R_inc = so3exp_map(dp[:, :3])
        R_new = R_inc @ so3exp_map(prob.poses[:, :3])
        t_new = torch.einsum("mij,mj->mi", R_inc, prob.poses[:, 3:]) \
            + dp[:, 3:]
        new_poses = torch.cat([_so3log(R_new), t_new], dim=-1)
        new_poses = torch.where(free, new_poses, prob.poses)
        return prob._replace(poses=new_poses, points=prob.points + dl)

    def cost(prob: BAProblem) -> torch.Tensor:
        r = residuals(prob)
        g = gate(prob, r.dtype)
        if huber_delta is None:
            total = (g[:, None] * r ** 2).sum()
        else:
            d = huber_delta
            n2 = (r * r).sum(-1) + 1e-12
            if robust == "cauchy":
                rho = 0.5 * d * d * torch.log1p(n2 / (d * d))
            else:
                nr = torch.sqrt(n2)
                rho = torch.where(nr <= d, 0.5 * nr ** 2, d * (nr - 0.5 * d))
            total = (g * rho).sum()
        total_n = torch.stack([total, g.sum()])
        if group is not None:
            dist.all_reduce(total_n, group=group)
        n = total_n[1].clamp(min=1)
        c = total_n[0] / n
        if prior_poses is not None:
            rel = prior_rel(prob) * free
            c = c + (prior_weight ** 2) * (rel ** 2).sum() / n
        return c

    lam = torch.full((), damping, dtype=f32, device=dev)
    err = cost(problem)
    errs: List[torch.Tensor] = [err]
    prob = problem
    for _ in range(iters):
        cand = gn_step(prob, lam)
        cand_err = cost(cand)
        # a candidate that blew up (inf/NaN cost) is rejected like any
        # uphill step; `where`, not `minimum`, which would carry a NaN on
        accept = (cand_err < err) & torch.isfinite(cand_err)
        prob = BAProblem(*(torch.where(accept, a, b)
                           for a, b in zip(cand, prob)))
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        err = torch.where(accept, cand_err, err)
        errs.append(err)
    return prob, torch.stack(errs)


def _so3log(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3):
    theta = atan2(|axis|, trace - 1), |axis| = 2 sin(theta), with an
    eps-regularised norm (gradient-safe at the identity)."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    norm = torch.sqrt((axis ** 2).sum(-1) + eps)
    theta = torch.atan2(norm, trace - 1.0)
    small = norm < 1e-6
    safe_norm = torch.where(small, torch.ones_like(norm), norm)
    scale = torch.where(small, torch.full_like(norm, 0.5),
                        theta / safe_norm)
    return axis * scale[..., None]


# ---------------------------------------------------------------------------
# pose-graph optimisation
# ---------------------------------------------------------------------------


class PoseGraph(NamedTuple):
    """poses: (M, 6) twists world->camera; edges (i, j) with measured
    relative transforms T_j * T_i^-1 (as twists) and scalar weights."""

    poses: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_rel: torch.Tensor    # (E, 6)
    edge_weight: torch.Tensor
    fixed: torch.Tensor       # (M,) gauge

    def to(self, device) -> "PoseGraph":
        return PoseGraph(*(t.to(device) for t in self))


def _pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    Ra, Rb = so3exp_map(a[..., :3]), so3exp_map(b[..., :3])
    t = a[..., 3:] + torch.einsum("...ij,...j->...i", Ra, b[..., 3:])
    return torch.cat([_so3log(Ra @ Rb), t], dim=-1)


def _pose_inv(a: torch.Tensor) -> torch.Tensor:
    Rt = so3exp_map(a[..., :3]).mT
    t = -torch.einsum("...ij,...j->...i", Rt, a[..., 3:])
    return torch.cat([-a[..., :3], t], dim=-1)


def pose_graph_residuals(g: PoseGraph) -> torch.Tensor:
    """(E, 6) residual twists log(meas^-1 * T_j * T_i^-1), weighted."""
    Ti = g.poses[g.edge_i.long()]
    Tj = g.poses[g.edge_j.long()]
    r = _pose_compose(_pose_inv(g.edge_rel),
                      _pose_compose(Tj, _pose_inv(Ti)))
    return r * g.edge_weight[..., None]


def pose_graph_solve(g: PoseGraph, iters: int = 20, lr: float = 0.5
                     ) -> Tuple[PoseGraph, torch.Tensor]:
    """Gradient steps on the quadratic edge cost, each pose's step scaled
    by its weighted edge degree; fixed poses stay. Returns (relaxed graph,
    the cost before each step (iters,))."""
    deg = g.poses.new_zeros(g.poses.shape[0])
    deg = deg.index_add(0, g.edge_i.long(), g.edge_weight)
    deg = deg.index_add(0, g.edge_j.long(), g.edge_weight)
    scale = deg.clamp(min=1.0)[:, None]
    keep = g.fixed[:, None]
    poses = g.poses.detach()
    costs = []
    for _ in range(iters):
        with torch.enable_grad():
            p = poses.detach().requires_grad_(True)
            c = 0.5 * (pose_graph_residuals(g._replace(poses=p)) ** 2).sum()
            grad, = torch.autograd.grad(c, p)
        poses = torch.where(keep, poses, poses - lr * grad / scale)
        costs.append(c.detach())
    return g._replace(poses=poses), torch.stack(costs)
