"""Batched 5-point minimal essential-matrix solver (Nistér 2004).

Counterpart of `ei_nexus_tpu/metrics/fivepoint.py`, step for step and with
its own copy of the static monomial tables (numpy, built at import):

 1. the nullspace of the (5, 9) epipolar constraint matrix from a complete
    QR of its transpose -> E(x, y, z) = x X + y Y + z Z + W;
 2. the ten cubic constraints det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0
    as a (10, 20) coefficient matrix over trivariate monomials;
 3. Gauss-Jordan elimination of the leading 10x10 block (unrolled, with
    partial pivoting, as the JAX package does instead of a LAPACK solve);
 4. Nistér's <k>, <l>, <m> rows -> a degree-10 polynomial n(z) whose real
    roots are bracketed on a 256-point tan-substitution grid of the
    homogenised form, then refined by 10 bisections and 3 clamped Newton
    steps (the grid is signed with one evaluator, the refinement uses
    another, as in the JAX package);
 5. each real root z gives (x, y) by least squares and a candidate E.

Everything is batched over leading dimensions with static shapes, so the
solver runs wherever its inputs lie (CPU or CUDA) without a host sync of
its own. A QR implementation may return another orthonormal basis of the
nullspace (signs, rotation), which permutes the candidates: compare
candidate sets, not slots.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# static monomial bookkeeping (numpy, import time)
# ---------------------------------------------------------------------------

# canonical monomial lists by total degree in (x, y, z)
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]            # x, y, z, 1
_DEG2 = [m for m in itertools.product(range(3), repeat=3) if sum(m) <= 2]
_DEG3 = [m for m in itertools.product(range(4), repeat=3) if sum(m) <= 3]
_I3 = {m: i for i, m in enumerate(_DEG3)}                        # 20


def _mul_table(basis_a, basis_b, basis_out):
    """One-hot tensor T s.t. (a outer b).flat @ T = product coefficients."""
    T = np.zeros((len(basis_a) * len(basis_b), len(basis_out)), np.float32)
    idx = {m: i for i, m in enumerate(basis_out)}
    for i, ma in enumerate(basis_a):
        for j, mb in enumerate(basis_b):
            m = tuple(x + y for x, y in zip(ma, mb))
            T[i * len(basis_b) + j, idx[m]] = 1.0
    return T


_T11 = _mul_table(_DEG1, _DEG1, _DEG2)                           # (16, 10)
_T21 = _mul_table(_DEG2, _DEG1, _DEG3)                           # (40, 20)

# Nistér's column order: 10 leading monomials eliminated by Gauss-Jordan,
# 10 trailing ones kept (grouped as x*, y*, const)
_LEAD = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
         (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0)]
_TRAIL = [(1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
          (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]
_PERM = np.array([_I3[m] for m in _LEAD + _TRAIL], np.int64)

# row positions (within _LEAD) of the monomials Nistér pairs up
_ROW_X2Z, _ROW_X2, _ROW_Y2Z, _ROW_Y2, _ROW_XYZ, _ROW_XY = 4, 5, 6, 7, 8, 9


def _conv_table(la: int, lb: int) -> np.ndarray:
    """One-hot tensor for 1-D polynomial multiply of coeff lengths la, lb."""
    T = np.zeros((la * lb, la + lb - 1), np.float32)
    for i in range(la):
        for j in range(lb):
            T[i * lb + j, i + j] = 1.0
    return T


_TABLES = {"T11": _T11, "T21": _T21, "PERM": _PERM}


@functools.lru_cache(maxsize=None)
def _const(name, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A static table on `device`, copied there once (a copy from the host
    on every solve would synchronise the stream each time)."""
    if name.startswith("conv"):
        la, lb = name[4:].split("x")
        table = _conv_table(int(la), int(lb))
    else:
        table = _TABLES[name]
    return torch.as_tensor(table, device=device).to(dtype)


def _table(name: str, like: torch.Tensor) -> torch.Tensor:
    return _const(name, like.device, like.dtype)


# ---------------------------------------------------------------------------
# batched polynomial helpers
# ---------------------------------------------------------------------------

def _p11(a, b):
    """(..., 4) x (..., 4) -> (..., 10)"""
    o = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], 16)
    return o @ _table("T11", a)


def _p21(a, b):
    """(..., 10) x (..., 4) -> (..., 20)"""
    o = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], 40)
    return o @ _table("T21", a)


def _polymul(a, b):
    """ascending-coefficient univariate multiply, static lengths."""
    la, lb = a.shape[-1], b.shape[-1]
    o = (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], la * lb)
    return o @ _table(f"conv{la}x{lb}", a)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def _nullspace_basis(p0, p1):
    """(S, 5, 2) x2 -> (S, 4, 3, 3) nullspace basis (X, Y, Z, W): the
    trailing 4 columns of a complete QR of A^T, A the (5, 9) constraints."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = torch.ones_like(x0)
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                     x0, y0, ones], dim=-1)                      # (S, 5, 9)
    Q, _ = torch.linalg.qr(A.mT, mode="complete")
    basis = Q[..., 5:].mT                                        # (S, 4, 9)
    return basis.reshape(*basis.shape[:-1], 3, 3)


def _constraint_matrix(basis):
    """(S, 4, 3, 3) -> (S, 10, 20) cubic-constraint coefficients
    (canonical monomial order _DEG3)."""
    # E entries as degree-1 polynomials over (x, y, z, 1)
    Ep = torch.movedim(basis, -3, -1)                            # (S,3,3,4)

    # EE^T entries (degree 2)
    G = torch.einsum("...ikp,...jkq,pqm->...ijm", Ep, Ep,
                     _table("T11", Ep).reshape(4, 4, 10))
    tr = G[..., 0, 0, :] + G[..., 1, 1, :] + G[..., 2, 2, :]     # (S,10)
    eye = torch.eye(3, dtype=Ep.dtype, device=Ep.device)
    T = 2.0 * G - tr[..., None, None, :] * eye[..., :, :, None]
    # (T E) entries (degree 3): nine equations
    TE = torch.einsum("...ikp,...kjq,pqm->...ijm", T, Ep,
                      _table("T21", Ep).reshape(10, 4, 20))
    eqs = TE.reshape(*TE.shape[:-3], 9, 20)

    # det(E) (degree 3): cofactor expansion along the first row
    def minor(i0, i1, j0, j1):
        return _p11(Ep[..., i0, j0, :], Ep[..., i1, j1, :]) - \
            _p11(Ep[..., i0, j1, :], Ep[..., i1, j0, :])
    det = (_p21(minor(1, 2, 1, 2), Ep[..., 0, 0, :])
           - _p21(minor(1, 2, 0, 2), Ep[..., 0, 1, :])
           + _p21(minor(1, 2, 0, 1), Ep[..., 0, 2, :]))          # (S, 20)

    return torch.cat([det[..., None, :], eqs], dim=-2)           # (S,10,20)


def _action_polys(C):
    """Reduced trailing block (S, 10, 10) -> B(z) coefficient tensors
    (bx, by, b1): (S, 3, 4), (S, 3, 4), (S, 3, 5) ascending z-coefficients
    of the 3x3 Nistér matrix rows <k>, <l>, <m>."""
    def kx(Ca, Cb):
        # trailing x-group: xz^2, xz, x at indices 0, 1, 2
        return torch.stack([Ca[..., 2], Ca[..., 1] - Cb[..., 2],
                            Ca[..., 0] - Cb[..., 1], -Cb[..., 0]], dim=-1)

    def ky(Ca, Cb):
        return torch.stack([Ca[..., 5], Ca[..., 4] - Cb[..., 5],
                            Ca[..., 3] - Cb[..., 4], -Cb[..., 3]], dim=-1)

    def k1(Ca, Cb):
        # const group: z^3, z^2, z, 1 at indices 6..9
        return torch.stack([Ca[..., 9], Ca[..., 8] - Cb[..., 9],
                            Ca[..., 7] - Cb[..., 8], Ca[..., 6] - Cb[..., 7],
                            -Cb[..., 6]], dim=-1)

    pairs = [(_ROW_X2Z, _ROW_X2), (_ROW_Y2Z, _ROW_Y2), (_ROW_XYZ, _ROW_XY)]
    bx = torch.stack([kx(C[..., a, :], C[..., b, :]) for a, b in pairs], -2)
    by = torch.stack([ky(C[..., a, :], C[..., b, :]) for a, b in pairs], -2)
    b1 = torch.stack([k1(C[..., a, :], C[..., b, :]) for a, b in pairs], -2)
    return bx, by, b1


def _det_poly(bx, by, b1):
    """det of the 3x3 polynomial matrix [bx | by | b1] -> (S, 11)."""
    def m2(c0, c1, r0, r1):
        cols = (bx, by, b1)
        return _polymul(cols[c0][..., r0, :], cols[c1][..., r1, :]) - \
            _polymul(cols[c0][..., r1, :], cols[c1][..., r0, :])
    # expand along the b1 column (degree 4) times 2x2 minors of (bx, by)
    return (_polymul(b1[..., 0, :], m2(0, 1, 1, 2))
            - _polymul(b1[..., 1, :], m2(0, 1, 0, 2))
            + _polymul(b1[..., 2, :], m2(0, 1, 0, 1)))           # (S, 11)


def _homog_eval(c, t):
    """h(t) = sum_i c_i sin^i t cos^(10-i) t and dh/dt, branch-free: Horner
    in whichever of tan t / cot t is <= 1 in magnitude. c: (..., 11); t
    broadcastable with c[..., 0]."""
    s, co = torch.sin(t), torch.cos(t)
    use_tan = s.abs() <= co.abs()
    denom = torch.where(use_tan, co, s)
    x = torch.where(use_tan, s, co) / torch.where(
        denom.abs() < 1e-30, 1e-30, denom)

    def horner(coeffs_desc, x):
        # value and derivative in one pass
        p = torch.zeros_like(x)
        dp = torch.zeros_like(x)
        for a in coeffs_desc:
            dp = dp * x + p
            p = p * x + a
        return p, dp

    cs = [c[..., i] for i in range(11)]
    p_t, dp_t = horner(cs[::-1], x)          # P(tan t), P'(tan t)
    p_c, dp_c = horner(cs, x)                # Q(cot t), Q'(cot t)
    co2, s2 = co * co, s * s
    co8, s8 = (co2 * co2) ** 2, (s2 * s2) ** 2
    sc = s * co
    h = torch.where(use_tan, co8 * co2 * p_t, s8 * s2 * p_c)
    dh = torch.where(use_tan, co8 * (dp_t - 10.0 * sc * p_t),
                     s8 * (10.0 * sc * p_c - dp_c))
    return h, dh


def _real_roots_deg10(coeffs, n_grid: int = 256, n_bisect: int = 10,
                      n_newton: int = 3):
    """Real roots of ascending-coefficient degree-10 polynomials.

    coeffs: (S, 11). Returns (roots (S, 10), valid (S, 10)): sign changes
    of the homogenised form on a grid over t in (-pi/2, pi/2) (the first
    ten brackets by cumulative count, no data-dependent shapes), n_bisect
    bisections, then n_newton Newton steps clamped into the bracket."""
    scale = coeffs.abs().amax(dim=-1, keepdim=True)
    c = coeffs / scale.clamp(min=1e-30)

    def hterms(t):
        s, co = torch.sin(t), torch.cos(t)
        return torch.stack([s ** i * co ** (10 - i) for i in range(11)], -1)

    eps = 1e-4
    ts = torch.linspace(-np.pi / 2 + eps, np.pi / 2 - eps, n_grid,
                        dtype=coeffs.dtype, device=coeffs.device)
    vals = c @ hterms(ts).T                                      # (S, G)
    sgn = torch.sign(vals)
    change = (sgn[:, :-1] * sgn[:, 1:]) < 0                      # (S, G-1)

    # the first <= 10 bracketing cells by cumulative count (no nonzero)
    pos = torch.cumsum(change, dim=-1) - 1                       # (S, G-1)
    slot = torch.arange(10, device=c.device)
    slot_hit = change[..., None] & (pos[..., None] == slot)      # (S,G-1,10)
    idx = slot_hit.to(torch.uint8).argmax(dim=-2)   # 0 when the slot is empty
    valid = slot_hit.any(dim=-2)
    lo, hi = ts[idx], ts[idx + 1]
    ci = c[:, None, :]

    f_lo, _ = _homog_eval(ci, lo)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_m, _ = _homog_eval(ci, mid)
        left = f_lo * f_m <= 0
        lo, hi, f_lo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                        torch.where(left, f_lo, f_m))

    t = 0.5 * (lo + hi)
    for _ in range(n_newton):
        f, df = _homog_eval(ci, t)
        step = f / torch.where(df.abs() < 1e-30, 1e-30, df)
        # clamp into the isolating bracket (jnp.clip's order of min/max)
        t = torch.minimum(torch.maximum(t - step, lo), hi)
    return torch.tan(t), valid


def _solve_gj(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A^{-1} B for tiny systems by unrolled Gauss-Jordan with
    partial pivoting; a singular pivot propagates inf/nan, which the
    candidates' validity then drops. A: (..., n, n), B: (..., n, m)."""
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)                        # (..., n, n+m)
    rows_done = torch.zeros(A.shape[:-2] + (n,), dtype=torch.bool,
                            device=A.device)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    arange = torch.arange(n, device=A.device)
    for k in range(n):
        col = M[..., :, k].abs()
        col = torch.where(rows_done, -torch.inf, col)
        piv = col.argmax(dim=-1)                         # (...,)
        pk = F.one_hot(piv, n).to(A.dtype)               # (..., n)
        ek = eye[k]
        # swap rows k <-> piv (no-op when piv == k)
        Mk = M[..., k, :]
        Mp = torch.einsum("...r,...rc->...c", pk, M)
        M = (M + ek[:, None] * (Mp - Mk)[..., None, :]
             + pk[..., :, None] * (Mk - Mp)[..., None, :])
        # normalize row k, eliminate everywhere else
        a = M[..., k, k][..., None]
        rowk = M[..., k, :] / a
        f = M[..., :, k] * (1.0 - ek)                    # keep row k
        M = M - f[..., :, None] * rowk[..., None, :]
        M = M + ek[:, None] * (rowk - M[..., k, :])[..., None, :]
        rows_done = rows_done | (arange == k)
    return M[..., :, n:]


def five_point_candidates(p0: torch.Tensor, p1: torch.Tensor):
    """(S, 5, 2), (S, 5, 2) normalized correspondences ->
    (E (S, 10, 3, 3), valid (S, 10)): all real-root essential-matrix
    candidates of each minimal problem (unit Frobenius norm)."""
    basis = _nullspace_basis(p0, p1)                             # (S,4,3,3)
    M = _constraint_matrix(basis)                                # (S,10,20)
    Mp = M[..., _const("PERM", M.device, torch.int64)]
    A, B = Mp[..., :10], Mp[..., 10:]
    # singular leading blocks (degenerate samples) show as non-finite C
    C = _solve_gj(A, B)                                          # (S,10,10)
    bx, by, b1 = _action_polys(C)
    n = _det_poly(bx, by, b1)                                    # (S, 11)
    z, valid = _real_roots_deg10(n)                              # (S, 10)

    # x, y from least squares over the three rows of B(z)
    zp4 = z[..., None] ** torch.arange(4, dtype=z.dtype, device=z.device)
    zp5 = z[..., None] ** torch.arange(5, dtype=z.dtype, device=z.device)
    Ax = torch.einsum("...rc,...kc->...kr", bx, zp4)             # (S,10,3)
    Ay = torch.einsum("...rc,...kc->...kr", by, zp4)
    bz = -torch.einsum("...rc,...kc->...kr", b1, zp5)
    # normal equations of the 3x2 system [Ax Ay] [x y]^T = bz
    axx = (Ax * Ax).sum(-1)
    axy = (Ax * Ay).sum(-1)
    ayy = (Ay * Ay).sum(-1)
    bxs = (Ax * bz).sum(-1)
    bys = (Ay * bz).sum(-1)
    det = axx * ayy - axy * axy
    det = torch.where(det.abs() < 1e-30, 1e-30, det)
    x = (bxs * ayy - bys * axy) / det
    y = (axx * bys - axy * bxs) / det

    xyz1 = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)   # (S,10,4)
    # E is normalised below, so scale (x, y, z, 1) to unit max first: a
    # root with huge x, y would otherwise overflow E's squared norm to inf
    # and turn E into an exact zero that every point fits (XLA's fused
    # arithmetic of the JAX package returns the unit-norm E there)
    xyz1 = xyz1 / xyz1.abs().amax(dim=-1, keepdim=True)
    E = torch.einsum("...kc,...cij->...kij", xyz1, basis)        # (S,10,3,3)
    norm = (E * E).sum(dim=(-2, -1), keepdim=True).sqrt()
    E = E / norm.clamp(min=1e-30)
    finite = torch.isfinite(E).all(dim=-1).all(dim=-1)
    return E, valid & finite
