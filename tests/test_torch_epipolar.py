"""The last geometry and detector functions of the port against the JAX
package, on the CPU: the epipolar module (fundamental and essential
matrices, aligned and all-pairs distances, the decomposition of E, the
angular errors, `generalized_epi_dist` in its four branches),
`depthproj.dense_warp_consistency`, `ops.space_to_depth` and
`Pose.as_4x4mat`, each on seeded numpy inputs.

Tolerances: float32 values to rtol 1e-5, with an absolute floor of 1e-5
times the largest |value| where a value is a difference of larger terms
(an epipolar residual p1^T E p0 cancels nine products, so its relative
error grows where it is small). The SVD's signs differ between LAPACK
builds and between torch and jax, so the decomposition of E is held as a
set: {R1, R2} equal as a pair in either order, t up to its sign, det = +1,
and one rotation equal to the true one. Angles in degrees: in float64 to
1e-6 degree; in float32 to 0.03 degree absolute (cos carries float32
rounding, ~6e-8, and arccos is steep near +-1: sqrt(2 x 6e-8) rad is 0.02
degree). Masks, `as_4x4mat` and `space_to_depth`'s cells exactly, its
dustbin to 1e-6 absolute (1 minus a float32 sum near 1, summed in another
order: a few ulps of 1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.geometry import depthproj as jdp
from ei_nexus_tpu.geometry import epipolar as jep
from ei_nexus_tpu.geometry.camera import Camera as JCamera
from ei_nexus_tpu.geometry.se3 import Pose as JPose
from ei_nexus_tpu.ops import detector as jdet
from ei_nexus_tpu_torch.geometry import depthproj as tdp
from ei_nexus_tpu_torch.geometry import epipolar as tep
from ei_nexus_tpu_torch.geometry.camera import Camera as TCamera
from ei_nexus_tpu_torch.geometry.se3 import Pose as TPose
from ei_nexus_tpu_torch.ops import depth_to_space, space_to_depth
from tests.test_torch_threads import one_torch_thread  # noqa: F401

B = 3
RTOL = 1e-5


def _rotations(rng, n, scale=0.3):
    """n rotation matrices from axis-angle vectors of ~`scale` rad."""
    out = []
    for w in rng.normal(0, scale, (n, 3)):
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx)
    return np.stack(out)


def _scene(rng, dtype=np.float32):
    """B poses (R, t), intrinsics K0, K1 and the image sizes."""
    R = _rotations(rng, B)
    t = rng.normal(0, 1, (B, 3)) + np.array([0.5, 0.0, 0.1])
    K = np.zeros((2, B, 3, 3))
    K[:, :, 0, 0] = rng.uniform(150, 250, (2, B))
    K[:, :, 1, 1] = rng.uniform(150, 250, (2, B))
    K[:, :, 0, 2] = rng.uniform(150, 190, (2, B))
    K[:, :, 1, 2] = rng.uniform(110, 150, (2, B))
    K[:, :, 2, 2] = 1.0
    size = np.tile([346.0, 260.0], (B, 1))
    return (R.astype(dtype), t.astype(dtype), K[0].astype(dtype),
            K[1].astype(dtype), size.astype(dtype))


def _both(R, t, K0, K1, size):
    """(JAX pose, cameras), (port pose, cameras) of one scene."""
    jside = (JPose.from_Rt(R, t),
             JCamera.from_calibration_matrix(jnp.asarray(K0), size),
             JCamera.from_calibration_matrix(jnp.asarray(K1), size))
    tt = torch.from_numpy
    tside = (TPose.from_Rt(tt(R), tt(t)),
             TCamera.from_calibration_matrix(tt(K0), tt(size)),
             TCamera.from_calibration_matrix(tt(K1), tt(size)))
    return jside, tside


def _close(got, want, floor=False):
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max()) if floor else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


def test_fundamental_and_essential_matrices_match_jax():
    rng = np.random.default_rng(0)
    scene = _scene(rng)
    (jT, jc0, jc1), (tT, tc0, tc1) = _both(*scene)
    _close(tep.T_to_E(tT), jep.T_to_E(jT), floor=True)
    F = tep.T_to_F(tc0, tc1, tT)
    _close(F, jep.T_to_F(jc0, jc1, jT), floor=True)
    _close(tep.E_to_F(tc0, tc1, tep.T_to_E(tT)),
           jep.E_to_F(jc0, jc1, jep.T_to_E(jT)), floor=True)
    _close(tep.F_to_E(tc0, tc1, F),
           jep.F_to_E(jc0, jc1, jnp.asarray(F.numpy())), floor=True)
    # E -> F -> E is the identity
    _close(tep.F_to_E(tc0, tc1, F), tep.T_to_E(tT).numpy(), floor=True)


def _points(rng, n=40, m=30):
    p0 = rng.uniform([0, 0], [346, 260], (B, n, 2)).astype(np.float32)
    p1 = rng.uniform([0, 0], [346, 260], (B, m, 2)).astype(np.float32)
    return p0, p1


@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("homogeneous", [False, True])
def test_sym_epipolar_distance_matches_jax(squared, homogeneous):
    """Aligned pairs, both forms, from 2-vectors or 3-vectors, one pair
    placed so that E p0 has a zero line norm (the 1e-6 floor)."""
    rng = np.random.default_rng(1)
    scene = _scene(rng)
    (jT, jc0, jc1), (tT, tc0, tc1) = _both(*scene)
    p0, p1 = _points(rng, 40, 40)
    p0 = np.concatenate([p0, np.ones_like(p0[..., :1])], -1) \
        if homogeneous else p0
    p1 = np.concatenate([p1, np.ones_like(p1[..., :1])], -1) \
        if homogeneous else p1
    F = tep.T_to_F(tc0, tc1, tT)
    want = jep.sym_epipolar_distance(jnp.asarray(p0), jnp.asarray(p1),
                                     jnp.asarray(F.numpy()), squared=squared)
    got = tep.sym_epipolar_distance(torch.from_numpy(p0),
                                    torch.from_numpy(p1), F, squared=squared)
    _close(got, want, floor=True)
    # E p0 = 0 where p0 is the epipole: the floor keeps the distance finite
    E = np.diag([1.0, 1.0, 0.0]).astype(np.float32)[None]
    ep = np.zeros((1, 1, 2), np.float32)
    got = tep.sym_epipolar_distance(torch.from_numpy(ep), torch.from_numpy(ep),
                                    torch.from_numpy(E), squared=squared)
    want = jep.sym_epipolar_distance(jnp.asarray(ep), jnp.asarray(ep),
                                     jnp.asarray(E), squared=squared)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("essential", [True, False])
@pytest.mark.parametrize("all_pairs", [True, False])
def test_generalized_epi_dist_matches_jax(essential, all_pairs):
    rng = np.random.default_rng(2)
    scene = _scene(rng)
    (jT, jc0, jc1), (tT, tc0, tc1) = _both(*scene)
    p0, p1 = _points(rng, 40, 30 if all_pairs else 40)
    want = jep.generalized_epi_dist(jnp.asarray(p0), jnp.asarray(p1), jc0,
                                    jc1, jT, all_pairs=all_pairs,
                                    essential=essential)
    got = tep.generalized_epi_dist(torch.from_numpy(p0), torch.from_numpy(p1),
                                   tc0, tc1, tT, all_pairs=all_pairs,
                                   essential=essential)
    assert got.shape == ((B, 40, 30) if all_pairs else (B, 40))
    _close(got, want, floor=True)


def _as_set_equal(got_pair, want_pair, atol):
    """Two rotation pairs equal in either order."""
    g1, g2 = got_pair
    w1, w2 = want_pair
    straight = max(np.abs(g1 - w1).max(), np.abs(g2 - w2).max())
    crossed = max(np.abs(g1 - w2).max(), np.abs(g2 - w1).max())
    assert min(straight, crossed) <= atol, (straight, crossed)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decompose_essential_matrix_matches_jax(dtype):
    """Each batch entry: {R1, R2} as a set, t up to its sign, det +1, one
    of the rotations the true R and t the true direction up to sign."""
    rng = np.random.default_rng(3)
    R, t, *_ = _scene(rng, dtype)
    E_t = tep.T_to_E(TPose.from_Rt(torch.from_numpy(R), torch.from_numpy(t)))
    with jax.enable_x64(dtype == np.float64):
        jR1, jR2, jt = (np.asarray(x) for x in jep.decompose_essential_matrix(
            jnp.asarray(E_t.numpy())))
    tR1, tR2, tt = (x.numpy() for x in tep.decompose_essential_matrix(E_t))
    atol = 1e-5 if dtype == np.float32 else 1e-10
    for b in range(B):
        _as_set_equal((tR1[b], tR2[b]), (jR1[b], jR2[b]), atol)
        assert min(np.abs(tt[b] - jt[b]).max(),
                   np.abs(tt[b] + jt[b]).max()) <= atol
        for Rc in (tR1[b], tR2[b]):
            assert abs(np.linalg.det(Rc) - 1.0) <= 10 * atol
        assert min(np.abs(tR1[b] - R[b]).max(),
                   np.abs(tR2[b] - R[b]).max()) <= 10 * atol
        u = t[b] / np.linalg.norm(t[b])
        assert min(np.abs(tt[b] - u).max(), np.abs(tt[b] + u).max()) \
            <= 10 * atol


def _angle_inputs(rng, dtype):
    """Rotation pairs and vector pairs from far apart down to equal (cos
    at +1, clipped) and opposite (cos at -1)."""
    R1 = _rotations(rng, 8)
    small = _rotations(rng, 8, scale=1e-4)
    R2 = np.concatenate([_rotations(rng, 4, scale=1.0) @ R1[:4],
                         small[:3] @ R1[4:7], R1[7:]])
    v1 = rng.normal(size=(8, 3))
    v2 = np.concatenate([rng.normal(size=(4, 3)), v1[4:6] + 1e-5,
                         v1[6:7] * 3.0, -v1[7:]])
    return (R1.astype(dtype), R2.astype(dtype), v1.astype(dtype),
            v2.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_angle_errors_and_relative_pose_error_match_jax(dtype):
    rng = np.random.default_rng(4)
    R1, R2, v1, v2 = _angle_inputs(rng, dtype)
    atol = 3e-2 if dtype == np.float32 else 1e-6
    tt = torch.from_numpy
    with jax.enable_x64(dtype == np.float64):
        want = {
            "mat": np.asarray(jep.angle_error_mat(jnp.asarray(R1),
                                                  jnp.asarray(R2))),
            "vec": np.asarray(jep.angle_error_vec(jnp.asarray(v1),
                                                  jnp.asarray(v2))),
            "rpe": [np.asarray(x) for x in jep.relative_pose_error(
                JPose.from_Rt(R1, v1), jnp.asarray(R2), jnp.asarray(v2))]}
        assert want["mat"].dtype == dtype
    got = {"mat": tep.angle_error_mat(tt(R1), tt(R2)).numpy(),
           "vec": tep.angle_error_vec(tt(v1), tt(v2)).numpy(),
           "rpe": [x.numpy() for x in tep.relative_pose_error(
               TPose.from_Rt(tt(R1), tt(v1)), tt(R2), tt(v2))]}
    for k in ("mat", "vec"):
        assert got[k].dtype == dtype
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    for g, w in zip(got["rpe"], want["rpe"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    assert (got["rpe"][0] <= 90.0).all()
    # equal rotations and parallel vectors read 0, opposite vectors 180
    assert got["mat"][7] <= atol and got["vec"][6] <= atol
    assert abs(got["vec"][7] - 180.0) <= atol


@pytest.mark.parametrize("ccth", [None, 4.0])
def test_dense_warp_consistency_matches_jax(ccth):
    """Two depth maps of a tilted plane with holes (depth 0), warped with
    and without the round-trip check through view j's depth."""
    rng = np.random.default_rng(5)
    H, W = 12, 16
    R, t, K0, _, _ = _scene(rng)
    t = (t * 0.05).astype(np.float32)
    K0 = K0.copy()
    K0[:, :2] *= 0.05
    K0[:, 2, 2] = 1.0
    size = np.tile([W, H], (B, 1)).astype(np.float32)
    ys, xs = np.mgrid[:H, :W]
    depth = (3.0 + 0.05 * xs + 0.02 * ys)[None] \
        + rng.uniform(0, 0.1, (2, B, H, W))
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    depth = depth.astype(np.float32)
    jcam = JCamera.from_calibration_matrix(jnp.asarray(K0), size)
    tcam = TCamera.from_calibration_matrix(torch.from_numpy(K0),
                                           torch.from_numpy(size))
    kw = {} if ccth is None else {"ccth": ccth}
    want = jdp.dense_warp_consistency(
        jnp.asarray(depth[0]), jnp.asarray(depth[1]), JPose.from_Rt(R, t),
        jcam, jcam, **kw)
    got = tdp.dense_warp_consistency(
        torch.from_numpy(depth[0]), torch.from_numpy(depth[1]),
        TPose.from_Rt(torch.from_numpy(R), torch.from_numpy(t)), tcam, tcam,
        **kw)
    assert got[0].shape == (B, H, W, 2) and got[1].shape == (B, H, W)
    _close(got[0], want[0], floor=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < int(got[1].sum()) < B * H * W


@pytest.mark.parametrize("cell", [8, 4])
def test_space_to_depth_matches_jax(cell):
    """Cells summing below and above 1 (the dustbin clamped at 0); the
    inverse of depth_to_space."""
    rng = np.random.default_rng(6)
    score = rng.uniform(0, 2.0 / cell ** 2, (2, 3 * cell, 4 * cell)).astype(
        np.float32)
    want = np.asarray(jdet.space_to_depth(jnp.asarray(score), cell))
    got = space_to_depth(torch.from_numpy(score), cell)
    assert got.shape == (2, 3, 4, cell * cell + 1)
    np.testing.assert_array_equal(got[..., :-1].numpy(), want[..., :-1])
    np.testing.assert_allclose(got[..., -1].numpy(), want[..., -1], rtol=0,
                               atol=1e-6)
    dustbin = got[..., -1]
    assert (dustbin == 0).any() and (dustbin > 0).any()
    np.testing.assert_array_equal(
        depth_to_space(got, cell).numpy(), score)


def test_pose_as_4x4mat_matches_jax():
    rng = np.random.default_rng(7)
    R, t, *_ = _scene(rng)
    want = np.asarray(JPose.from_Rt(R, t).as_4x4mat())
    got = TPose.from_Rt(torch.from_numpy(R), torch.from_numpy(t)).as_4x4mat()
    np.testing.assert_array_equal(got.numpy(), want)
    back = TPose.from_4x4mat(got)
    assert torch.equal(back.R, torch.from_numpy(R))
    assert torch.equal(back.t, torch.from_numpy(t))
    one = TPose.from_Rt(torch.from_numpy(R[0]), torch.from_numpy(t[0]))
    assert one.as_4x4mat().shape == (4, 4)
