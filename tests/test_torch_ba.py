"""The port's SLAM back end against the JAX package's on the same
problems, on the CPU: `parallel/ba.py` (every case of tests/test_ba.py but
the 8-device sharded one, which waits for the multi-process slice),
`parallel/slam.py`, `geometry/triangulation.py` and the `se3`/`camera`
members the back end uses.

Tolerances: both solvers sum float32 segment sums in another order
(XLA's scatter-add, `index_add_` here) and run 20-25 float32 CG
iterations, so the trajectories part at float32 noise: the initial cost
rtol 1e-6; the cost after the first LM iteration rtol 2e-2 (observed
~1e-2: CG's early iterates amplify the summation order); refined poses
atol 1e-4 and points atol 1e-3 (observed 7e-6 and 1.2e-4 on landmarks
~5 units away) where the problem has an exact solution. Where it has
none (pixel noise, a pose prior), both end in the optimum's flat valley
at different points: the final costs rtol 1e-3, poses atol 1e-3 and
points atol 5e-2 (observed 7e-5, 4.5e-4 and 1.8e-2: landmarks slide
along their rays at almost no cost). With gross outliers the trajectories
part for good on the way (an LM step accepted on one side and refused
on the other): after 12 iterations JAX's Huber solve had stalled at a
robust cost of 1.800 and the port's gone on to 1.684, with inlier MSEs
of 0.90 and 1.42; both reach the same optimum by 40 iterations (costs
within 0.3%, inlier MSEs 0.661/0.657, 0.627/0.627, 0.0338/0.0339). That
test therefore runs 40 iterations and holds the inlier MSEs to rtol 2e-2
and, on both sides, to what the converged solves show: Huber below L2,
Cauchy below 0.05 and below a tenth of L2 (tests/test_ba.py's "a
twentieth" describes its 12-iteration snapshot; converged, JAX's own
solve gives 0.0338 against L2's 0.661).
Below 1e-6 px^2 both
are at float32's floor and are only held under the tests' own bounds.
The rest is closed-form float32:
rtol 1e-5 / atol 1e-5, and index bookkeeping exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.geometry import Camera as JCamera
from ei_nexus_tpu.geometry import Pose as JPose
from ei_nexus_tpu.geometry.se3 import from_homogeneous as j_from_h
from ei_nexus_tpu.geometry.se3 import so3exp_map as j_exp
from ei_nexus_tpu.geometry.triangulation import triangulate_tracks as j_tri
from ei_nexus_tpu.parallel import ba as jba
from ei_nexus_tpu_torch.geometry import Camera, Pose
from ei_nexus_tpu_torch.geometry.se3 import from_homogeneous, so3exp_map
from ei_nexus_tpu_torch.geometry.triangulation import (triangulate_linear,
                                                       triangulate_tracks)
from ei_nexus_tpu_torch.parallel import ba as tba
from tests.test_ba import synth_ba_problem
from tests.test_torch_threads import one_torch_thread  # noqa: F401

POSE_ATOL, POINT_ATOL, STEP1_RTOL = 1e-4, 1e-3, 2e-2
VALLEY = dict(poses=1e-3, points=5e-2, cost=1e-3)   # no exact solution
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(prob):
    return tba.BAProblem(*(_t(x) for x in prob))


def _both(prob, **kw):
    """(JAX refined, JAX costs, port refined, port costs) as numpy."""
    jr, je = jba.ba_solve(prob, **kw)
    tr, te = tba.ba_solve(_port(prob), **kw)
    return jr, np.asarray(je), tr, te.numpy()


def _agree(jr, je, tr, te, exact=True):
    np.testing.assert_allclose(te[0], je[0], rtol=1e-6)
    np.testing.assert_allclose(te[1], je[1], rtol=STEP1_RTOL)
    if exact:
        np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses),
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points),
                                   atol=POINT_ATOL)
    else:
        np.testing.assert_allclose(te[-1], je[-1], rtol=VALLEY["cost"])
        np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses),
                                   atol=VALLEY["poses"])
        np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points),
                                   atol=VALLEY["points"])


class TestBA:
    def test_converges_to_zero_error(self, rng):
        prob, _, _ = synth_ba_problem(rng)
        err0 = float(tba.residuals(_port(prob)).pow(2).mean())
        np.testing.assert_allclose(
            err0, float(jnp.mean(jba.residuals(prob) ** 2)), rtol=1e-6)
        jr, je, tr, te = _both(prob, iters=12, cg_iters=25)
        assert err0 > 1.0
        assert te[-1] < err0 * 1e-3 and je[-1] < err0 * 1e-3
        _agree(jr, je, tr, te)

    def test_fixed_pose_untouched(self, rng):
        prob, *_ = synth_ba_problem(rng)
        refined, _ = tba.ba_solve(_port(prob), iters=5)
        assert torch.equal(refined.poses[0], _t(prob.poses[0]))

    def test_noisy_measurements_plateau(self, rng):
        prob, *_ = synth_ba_problem(rng, noise_px=0.5)
        jr, je, tr, te = _both(prob, iters=10)
        assert 0.01 < te[-1] < 1.0
        _agree(jr, je, tr, te, exact=False)

    def test_invalid_observations_ignored(self, rng):
        prob, *_ = synth_ba_problem(rng)
        bad_uv = prob.obs_uv.at[::2].add(500.0)
        valid = jnp.asarray(np.arange(len(prob.obs_pose)) % 2 == 1)
        prob2 = prob._replace(obs_uv=bad_uv, obs_valid=valid)
        jr, je, tr, te = _both(prob2, iters=10)
        assert te[-1] < 1e-3
        _agree(jr, je, tr, te)

    def test_huber_survives_gross_outliers(self, rng):
        """5% of the measurements moved by +300 px and left valid: at
        convergence the robust losses recover the inliers' solution."""
        prob, *_ = synth_ba_problem(rng)
        O = len(np.asarray(prob.obs_pose))
        out_idx = np.arange(O) % 20 == 0
        prob2 = prob._replace(
            obs_uv=prob.obs_uv.at[np.nonzero(out_idx)[0]].add(300.0))
        clean = _t(prob.obs_uv)

        def inlier_mse(refined):
            r = tba.residuals(refined._replace(obs_uv=clean)).numpy()
            return float((r[~out_idx] ** 2).mean())

        got, want = [], []
        for kw in ({}, dict(huber_delta=2.0),
                   dict(huber_delta=2.0, robust="cauchy")):
            jr, je, tr, te = _both(prob2, iters=40, cg_iters=25, **kw)
            np.testing.assert_allclose(te[0], je[0], rtol=1e-6)
            np.testing.assert_allclose(te[1], je[1], rtol=STEP1_RTOL)
            np.testing.assert_allclose(te[-1], je[-1], rtol=1e-2)
            got.append(inlier_mse(tr))
            want.append(inlier_mse(_port(jr)))
        np.testing.assert_allclose(got, want, rtol=2e-2)
        for l2, hu, ca in (got, want):
            assert hu < l2 and ca < 0.05 and ca < l2 * 0.1, (got, want)

    def test_cheirality_gate_blocks_clamp_pole(self, rng):
        prob, *_ = synth_ba_problem(rng)
        prob2 = prob._replace(
            points=prob.points.at[0].set(jnp.asarray([0.0, 0.0, -50.0])))
        _, je, _, te = _both(prob2, iters=8, cg_iters=25)
        assert te[-1] > 1e6 and je[-1] > 1e6
        np.testing.assert_allclose(te, je, rtol=1e-6)   # every step refused
        jr, je, tr, te = _both(prob2, iters=8, cg_iters=25, z_min=0.01,
                               huber_delta=4.0)
        assert te[-1] < 1e-2, te
        _agree(jr, je, tr, te)

    def test_pose_prior(self, rng):
        """The Gaussian pose prior (slam_mvsec's odometry regulariser)."""
        prob, gt_poses, _ = synth_ba_problem(rng, noise_px=0.3)
        prior = jnp.asarray(gt_poses, jnp.float32)
        jr, je = jba.ba_solve(prob, iters=6, prior_poses=prior,
                              prior_weight=20.0)
        tr, te = tba.ba_solve(_port(prob), iters=6, prior_poses=_t(prior),
                              prior_weight=20.0)
        _agree(jr, np.asarray(je), tr, te.numpy(), exact=False)
        assert te[-1] < te[0]


class TestPoseGraph:
    def _graphs(self, rng, M=8, noise=0.05):
        gt = np.zeros((M, 6), np.float32)
        gt[:, 4] = np.linspace(0, 1.0, M)
        gt[:, 1] = np.linspace(0, 0.3, M)
        ei = list(range(M - 1)) + [M - 1]
        ej = list(range(1, M)) + [0]
        rels = [np.asarray(jba._pose_compose(jnp.asarray(gt[j]),
                                             jba._pose_inv(jnp.asarray(gt[i]))))
                for i, j in zip(ei, ej)]
        init = gt.copy()
        init[1:] += rng.normal(0, noise, (M - 1, 6)).astype(np.float32)
        fixed = np.zeros(M, bool)
        fixed[0] = True
        fields = (init, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
                  np.stack(rels).astype(np.float32),
                  np.ones(len(ei), np.float32), fixed)
        return (jba.PoseGraph(*(jnp.asarray(f) for f in fields)),
                tba.PoseGraph(*(_t(f) for f in fields)))

    def test_reduces_residuals(self, rng):
        jg, tg = self._graphs(rng)
        np.testing.assert_allclose(
            tba.pose_graph_residuals(tg).numpy(),
            np.asarray(jba.pose_graph_residuals(jg)), **TOL)
        r0 = float((tba.pose_graph_residuals(tg) ** 2).sum())
        js, jc = jba.pose_graph_solve(jg, iters=100)
        ts, tc = tba.pose_graph_solve(tg, iters=100)
        r1 = float((tba.pose_graph_residuals(ts) ** 2).sum())
        assert r1 < r0 * 0.05, (r0, r1)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                                   atol=1e-4)

    def test_gauge_fixed(self, rng):
        _, tg = self._graphs(rng)
        solved, _ = tba.pose_graph_solve(tg, iters=10)
        assert torch.equal(solved.poses[0], tg.poses[0])


class TestSO3Log:
    def test_roundtrip(self, rng):
        w = rng.normal(0, 0.8, (16, 3)).astype(np.float32)
        R = so3exp_map(_t(w))
        np.testing.assert_allclose(R.numpy(), np.asarray(j_exp(w)), **TOL)
        w2 = tba._so3log(R).numpy()
        np.testing.assert_allclose(w2, w, atol=1e-4)
        np.testing.assert_allclose(w2, np.asarray(jba._so3log(
            jnp.asarray(R.numpy()))), **TOL)

    def test_identity(self):
        w = tba._so3log(torch.eye(3)).numpy()
        np.testing.assert_allclose(w, 0.0, atol=1e-7)
        assert torch.equal(so3exp_map(torch.zeros(3)), torch.eye(3))


def _scene(rng, M=4, L=60, noise=0.02):
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    X = rng.uniform([-1.5, -1, 4], [1.5, 1, 7], (L, 3))
    poses, kps = [], []
    for m in range(M):
        t = np.array([0.25 * m, 0.0, 0.0])
        pose = np.eye(4)
        pose[:3, 3] = -t
        uv = (K @ (X - t).T).T
        uv = uv[:, :2] / uv[:, 2:]
        kps.append(np.concatenate([uv[:, ::-1], np.ones((L, 1))],
                                  1).astype(np.float32))
        if m > 0:
            pose[:3, 3] += rng.normal(0, noise, 3)
        poses.append(pose)
    return K, X, poses, kps


class TestSLAMAssembly:
    def _keyframes(self, mod, K, poses, kps):
        return [mod.Keyframe(keypoints=k, valid=np.ones(len(k), bool),
                             pose=p, K=K) for p, k in zip(poses, kps)]

    def test_tracks_and_refinement(self, rng):
        from ei_nexus_tpu.parallel import slam as jslam
        from ei_nexus_tpu_torch.parallel import slam as tslam
        K, X, poses, kps = _scene(rng)
        L = len(X)
        matches01 = [np.arange(L) for _ in range(3)]
        tracks = tslam.chain_tracks(matches01, L)
        assert tracks == jslam.chain_tracks(matches01, L)
        assert len(tracks) == L and all(len(t) == 4 for t in tracks)

        jprob = jslam.build_ba_problem(self._keyframes(jslam, K, poses, kps),
                                       tracks)
        tprob = tslam.build_ba_problem(self._keyframes(tslam, K, poses, kps),
                                       tracks, device="cpu")
        for name, a, b in zip(tprob._fields, tprob, jprob):
            if a.dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           err_msg=name, rtol=1e-5,
                                           atol=2e-4)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=name)

        refined, errs = tslam.refine_map(
            self._keyframes(tslam, K, poses, kps), matches01, iters=8,
            device="cpu")
        jref, jerrs = jslam.refine_map(
            self._keyframes(jslam, K, poses, kps), matches01, iters=8)
        assert errs[0] > 0.3 and errs[-1] < 1e-2
        np.testing.assert_allclose(errs[0], jerrs[0], rtol=1e-4)
        np.testing.assert_allclose(refined.points.numpy(), X, atol=0.05)
        np.testing.assert_allclose(refined.points.numpy(),
                                   np.asarray(jref.points), atol=POINT_ATOL)

    def test_partial_matches(self):
        from ei_nexus_tpu.parallel import slam as jslam
        from ei_nexus_tpu_torch.parallel import slam as tslam
        m = [np.array([1, -1, 0]), np.array([2, 0, -1])]
        tracks = tslam.chain_tracks(m, 3)
        assert tracks == jslam.chain_tracks(m, 3)
        assert sorted(len(t) for t in tracks) == [3, 3]
        assert tslam.build_ba_problem([], [], device="cpu") is None

    def test_build_ba_problem_defaults_to_the_card(self):
        from ei_nexus_tpu_torch.parallel.slam import build_ba_problem
        if torch.cuda.is_available():
            pytest.skip("this host has a card: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA"):
            build_ba_problem([], [])


class TestTriangulation:
    def _views(self, rng, V=4):
        K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
        w = rng.normal(0, 0.05, (V, 3)).astype(np.float32)
        ts = np.stack([[0.3 * v, 0.05 * v, 0] for v in range(V)]
                      ).astype(np.float32)
        R = np.asarray(j_exp(w))
        X = rng.uniform([-1, -1, 4], [1, 1, 8], (10, 3)).astype(np.float32)
        Xc = np.einsum("vij,tj->tvi", R, X) + ts
        uv = np.einsum("ij,tvj->tvi", K, Xc)
        kpts = (uv[..., :2] / uv[..., 2:]).astype(np.float32)
        Ks = np.tile(K, (V, 1, 1)).astype(np.float32)
        return Ks, R, ts, X, kpts

    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_jax(self, rng, masked):
        Ks, R, ts, X, kpts = self._views(rng)
        mask = np.ones(kpts.shape[:2], bool)
        if masked:
            kpts[:, 3] = 9999.0            # a corrupted view, masked out
            mask[:, 3] = False
        want = np.asarray(j_tri(jnp.asarray(kpts), JPose.from_Rt(R, ts),
                                JCamera.from_calibration_matrix(Ks),
                                jnp.asarray(mask)))
        got = triangulate_tracks(_t(kpts), Pose.from_Rt(_t(R), _t(ts)),
                                 Camera.from_calibration_matrix(_t(Ks)),
                                 _t(mask)).numpy()
        np.testing.assert_allclose(got, X, atol=1e-2)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        one = triangulate_linear(_t(kpts[0]), Pose.from_Rt(_t(R), _t(ts)),
                                 Camera.from_calibration_matrix(_t(Ks)),
                                 _t(mask[0]))
        np.testing.assert_allclose(one.numpy(), got[0], **TOL)


class TestSE3Camera:
    def test_pose_members_match_jax(self, rng):
        aa = rng.normal(0, 0.5, (5, 3)).astype(np.float32)
        t = rng.normal(size=(5, 3)).astype(np.float32)
        aa2 = rng.normal(0, 0.5, (5, 3)).astype(np.float32)
        p3d = rng.normal(size=(5, 7, 3)).astype(np.float32)
        jA, jB = JPose.from_aa(aa, t), JPose.from_aa(aa2, -t)
        tA, tB = Pose.from_aa(_t(aa), _t(t)), Pose.from_aa(_t(aa2), _t(-t))
        for got, want in (((tA @ tB).R, (jA @ jB).R),
                          ((tA @ tB).t, (jA @ jB).t),
                          (tA.compose(tB.inv()).t, jA.compose(jB.inv()).t),
                          (tA @ _t(p3d), jA @ jnp.asarray(p3d)),
                          (tA.J_transform(_t(p3d)),
                           jA.J_transform(jnp.asarray(p3d))),
                          (tA.magnitude()[0], jA.magnitude()[0]),
                          (tA.magnitude()[1], jA.magnitude()[1]),
                          (from_homogeneous(_t(p3d), 1e-3),
                           j_from_h(jnp.asarray(p3d), 1e-3))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-4)
        i_t, i_j = Pose.identity((2, 3), device="cpu"), JPose.identity((2, 3))
        np.testing.assert_array_equal(i_t.R.numpy(), np.asarray(i_j.R))
        np.testing.assert_array_equal(i_t.t.numpy(), np.asarray(i_j.t))
        assert i_t.shape == (2, 3) and i_t.dtype == torch.float32
        R = so3exp_map(_t(aa))
        np.testing.assert_array_equal(Pose.from_Rt(R, _t(t)).R.numpy(),
                                      R.numpy())

    def test_camera_members_match_jax(self, rng):
        args = (346.0, 260.0, 226.0, 226.5, 173.0, 130.0)
        dist = [-0.05, 0.01]
        tc, jc = Camera.from_params(*args, dist=dist, device="cpu"), \
            JCamera.from_params(*args, dist=dist)
        assert tc.shape == ()
        for got, want in ((tc, jc), (tc.scale(0.5), jc.scale(0.5)),
                          (tc.scale((0.5, 2.0)), jc.scale((0.5, 2.0))),
                          (tc.crop((10.0, 20.0), (100, 80)),
                           jc.crop((10.0, 20.0), (100, 80))),
                          (Camera.from_params(*args, device="cpu"),
                           JCamera.from_params(*args))):
            for f in ("size", "f", "c", "dist"):
                np.testing.assert_allclose(getattr(got, f).numpy(),
                                           np.asarray(getattr(want, f)),
                                           err_msg=f, **TOL)
        p3d = rng.normal(size=(6, 3)).astype(np.float32)
        p3d[:, 2] = np.abs(p3d[:, 2]) + 0.1
        p3d[0, 2] = 0.0                         # the clamp's branch
        np.testing.assert_allclose(tc.J_project(_t(p3d)).numpy(),
                                   np.asarray(jc.J_project(
                                       jnp.asarray(p3d))), **TOL)
