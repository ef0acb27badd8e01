"""The port's evaluation against the JAX package's, on the CPU: the metric
classes (numpy copies: equal on the same inputs, cv2's RANSAC seeded
alike with `cv2.setRNGSeed(0)` before each side's call), the device
RANSAC backend ("torch" here, "jax" there) with the same samples injected,
`val_extractor` and `rpe_eval` over a tiny MNN and a tiny LightGlue model
with the same weights, and the evaluation-pair generation.

Tolerances: the numpy metrics are compared exactly (the same arithmetic);
the device backend's R and t to 1e-4 (float32 RANSAC on both sides, as
tests/test_torch_pose.py holds it), so its angular errors to 0.01 degree
(1e-4 in R or t moves an angle by up to ~0.006 degree), its AUCs to 2e-3
(0.01 degree over the 5 degree threshold), its inlier fractions to one
inlier of 40 (the pose test allows one inlier to differ) and its
threshold ratios exactly; the evaluation loops' metrics to 1e-6 once
their matches are equal (float32 keypoints and descriptors through the
same numpy metrics).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import ei_nexus_tpu.metrics as jmet
from ei_nexus_tpu.metrics import matching as jmatching
from ei_nexus_tpu.metrics import ransac as jransac
import ei_nexus_tpu_torch.metrics as tmet
from ei_nexus_tpu_torch.metrics import ransac as transac

from tests.test_metrics import synthetic_pose_scene
from tests.test_torch_pose import _jax_indices
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _cv2_seeded(fn, *args, **kw):
    import cv2
    cv2.setRNGSeed(0)
    return fn(*args, **kw)


def _assert_rpe_close(got, want):
    """A device-RANSAC metric dict against JAX's, at the tolerances of the
    module docstring."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        atol = (1e-2 if k.endswith("_errs") else 2e-3 if k.endswith("_auc")
                else 0.025 if k.endswith("_inliers") else 0.0)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def _assert_dicts_equal(got, want, rtol=0.0, atol=0.0):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the metric classes
# ---------------------------------------------------------------------------


def test_compute_auc_and_detection_metric_match_jax():
    rng = np.random.default_rng(0)
    errors = list(rng.uniform(0, 30, 50)) + [np.inf, np.nan]
    assert tmet.compute_auc(errors, [5, 10, 20]) == \
        jmet.compute_auc(errors, [5, 10, 20])
    assert tmet.compute_auc([], [5]) == jmet.compute_auc([], [5])
    score = rng.uniform(size=(2, 1, 12, 16)).astype(np.float32)
    gt = rng.uniform(size=(2, 12, 16)).astype(np.float32)
    nms0 = (rng.uniform(size=(2, 12, 16)) > 0.9) * score[:, 0]
    nms1 = (rng.uniform(size=(2, 12, 16)) > 0.9) * gt
    em = rng.uniform(size=(2, 1, 12, 16)) > 0.3
    assert tmet.detection_metric(score, gt, nms0, nms1, em) == \
        jmet.detection_metric(score, gt, nms0, nms1, em)


@pytest.mark.parametrize("ordering", ["xy", "yx"])
def test_keypoint_metrics_match_jax(ordering):
    """Repeatability and ValidDescriptorsDistance under a perspective
    homography, with points leaving the frame and a pair with none."""
    rng = np.random.default_rng(1)
    H = np.array([[1.02, 0.03, 4.0], [-0.02, 0.97, -3.0],
                  [1e-4, -5e-5, 1.0]])
    pts1, pts2, d1, d2 = [], [], [], []
    for n in (40, 25, 0):
        p = rng.uniform(-5, 105, (n, 2)).astype(np.float32)
        w = np.concatenate([p, np.ones((n, 1), np.float32)], 1) @ H.T
        w = (w[:, :2] / w[:, 2:] + rng.normal(0, 1.5, (n, 2)))
        flip = (lambda a: a[:, ::-1]) if ordering == "yx" else (lambda a: a)
        pts1.append(flip(p).astype(np.float32))
        pts2.append(flip(w).astype(np.float32))
        d1.append(rng.normal(size=(n, 8)).astype(np.float32))
        d2.append(rng.normal(size=(n, 8)).astype(np.float32))
    Hs = [H] * 3
    for name, cls, args in (
            ("R", "Repeatability", (3,)),
            ("VVD", "ValidDescriptorsDistance", ([1, 3],))):
        tm = getattr(tmet, cls)(name, *args, ordering=ordering)
        jm = getattr(jmet, cls)(name, *args, ordering=ordering)
        if name == "R":
            call = (pts1, pts2, (100, 110), (100, 110), Hs)
        else:
            call = (pts1, pts2, d1, d2, (100, 110), (100, 110), Hs)
        _assert_dicts_equal(tm.update_batch(*call), jm.update_batch(*call))
        one = tuple(c[0] if isinstance(c, list) else c for c in call)
        _assert_dicts_equal(tm.update_one(*one), jm.update_one(*one))


def test_matching_metrics_match_jax():
    """MatchingRatio, MeanMatchingAccuracy (with outliers and an empty
    pair), HomographyEstimation with its AUCs (cv2 RANSAC, seeded alike)
    and the assignment-level matcher_metrics."""
    rng = np.random.default_rng(2)
    H = np.array([[1.05, 0.02, 5.0], [-0.01, 0.98, -3.0],
                  [1e-5, -2e-5, 1.0]])
    mk1, mk2 = [], []
    for n, out in ((80, 10), (30, 20), (3, 0), (0, 0)):
        p = rng.uniform(10, 300, (n, 2))
        w = np.concatenate([p, np.ones((n, 1))], 1) @ H.T
        w = w[:, :2] / w[:, 2:] + rng.normal(0, 0.8, (n, 2))
        w[:out] = rng.uniform(10, 300, (out, 2))
        mk1.append(p[:, ::-1].astype(np.float32))
        mk2.append(w[:, ::-1].astype(np.float32))
    kps = [rng.uniform(0, 300, (100, 2)) for _ in mk1]
    assert tmet.MatchingRatio("MR").update_batch(mk1, mk2, kps, kps) == \
        jmet.MatchingRatio("MR").update_batch(mk1, mk2, kps, kps)
    for th in (1, 3):
        tm = tmet.MeanMatchingAccuracy(f"MMA@{th}", th, ordering="yx")
        jm = jmet.MeanMatchingAccuracy(f"MMA@{th}", th, ordering="yx")
        assert tm.update_batch(mk1, mk2, [H] * 4) == \
            jm.update_batch(mk1, mk2, [H] * 4)
    shapes = [(240, 320)] * 4
    got = _cv2_seeded(tmet.HomographyEstimation("HE", [3, 5, 10])
                      .update_batch, shapes, mk1, mk2, [H] * 4)
    want = _cv2_seeded(jmet.HomographyEstimation("HE", [3, 5, 10])
                       .update_batch, shapes, mk1, mk2, [H] * 4)
    _assert_dicts_equal(got, want)
    assert got["HE@10_auc"] > 0

    B, N = 3, 40
    pred = rng.integers(-1, N, (B, N))
    gt = rng.integers(-2, N, (B, N))
    gt[:, :10] = pred[:, :10]
    scores = rng.uniform(size=(B, N))
    got = tmet.matcher_metrics(pred, gt, scores, prefix="v_")
    want = jmatching.matcher_metrics(pred, gt, scores, prefix="v_")
    _assert_dicts_equal(got, want)


def _pose_batch(rng, counts):
    mk1, mk2, Ks, Ts = [], [], [], []
    for n in counts:
        x0, x1, K, T, _ = synthetic_pose_scene(rng, n=max(n, 1), noise=0.3,
                                               outlier_frac=0.2)
        mk1.append(x0[:n, ::-1].astype(np.float32))
        mk2.append(x1[:n, ::-1].astype(np.float32))
        Ks.append(K)
        Ts.append(T)
    return mk1, mk2, Ks, Ts


def test_relative_pose_opencv_matches_jax():
    """The OpenCV protocol on three scenes and a pair with too few
    matches, cv2 seeded alike: every per-pair value and AUC equal."""
    mk1, mk2, Ks, Ts = _pose_batch(np.random.default_rng(3),
                                   [120, 60, 30, 3])
    got = _cv2_seeded(tmet.RelativePoseEstimation("RPE", [5, 10, 20])
                      .update_batch, mk1, mk2, Ks, Ks, Ts)
    want = _cv2_seeded(jmet.RelativePoseEstimation("RPE", [5, 10, 20])
                       .update_batch, mk1, mk2, Ks, Ks, Ts)
    _assert_dicts_equal(got, want)
    assert got["RPE@20_auc"] > 0.5
    with pytest.raises(ValueError, match="backend"):
        tmet.RelativePoseEstimation("RPE", [5], backend="jax")


def _slot_batch(rng, counts, K=128):
    pos0 = np.zeros((len(counts), K, 3), np.float32)
    pos1 = np.zeros((len(counts), K, 3), np.float32)
    m0 = np.full((len(counts), K), -1, np.int32)
    Ks, Ts = [], []
    for b, n in enumerate(counts):
        x0, x1, Km, Tm, _ = synthetic_pose_scene(rng, n=max(n, 1), noise=0.2,
                                                 outlier_frac=0.1)
        perm = rng.permutation(K)[:n]
        pos0[b, :n, :2] = x0[:n, ::-1]
        pos1[b, perm, :2] = x1[:n, ::-1]
        m0[b, :n] = perm
        Ks.append(Km)
        Ts.append(Tm)
    return pos0, pos1, m0, np.stack(Ks), np.stack(Ts)


def test_relative_pose_device_backend_matches_jax(monkeypatch):
    """The batched backend ("torch" here, "jax" there) on three scenes and
    a pair with too few matches, the port given JAX's samples (its draws
    from PRNGKey(0), the key `estimate_pose_batch_from_matches` uses):
    R and t per pair to 1e-4, the per-pair metrics and the AUCs at the
    tolerances of the module docstring.
    Then the per-pair path (`estimate_pose_torch` against
    `estimate_pose_jax`), injected likewise."""
    pos0, pos1, m0, Ks, Ts = _slot_batch(np.random.default_rng(4),
                                         [110, 70, 40, 4])

    def jax_samples(mask, n_hypotheses, solver, generator=None,
                    two_phase=True):
        return _jax_indices(jax.random.PRNGKey(0), mask.cpu().numpy(),
                            n_hypotheses, solver)

    monkeypatch.setattr(transac, "sample_indices", jax_samples)
    args = (pos0, pos1, m0, Ks, Ks)
    want = jransac.estimate_pose_batch_from_matches(*args, thresh=1.0)
    got = transac.estimate_pose_batch_from_matches(*args, thresh=1.0,
                                                   device="cpu")
    assert [g is None for g in got] == [w is None for w in want] \
        == [False, False, False, True]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[0], w[0], atol=1e-4)
        np.testing.assert_allclose(g[1], w[1], atol=1e-4)

    tm = tmet.RelativePoseEstimation("RPE", [5, 10, 20], backend="torch",
                                     device="cpu")
    jm = jmet.RelativePoseEstimation("RPE", [5, 10, 20], backend="jax")
    touts = tm.update_batch_device(*args, Ts)
    jouts = jm.update_batch_device(*args, Ts)
    for g, w in zip(touts, jouts):
        _assert_rpe_close(g, w)
    _assert_rpe_close({f"{k}_auc": v for k, v in tm.compute_all_auc().items()},
                      {f"{k}_auc": v for k, v in jm.compute_all_auc().items()})
    assert jm.compute_all_auc()["20"] > 0.5

    # one pair through the OpenCV backend's contract
    def jax_pair_samples(mask, n_hypotheses, solver, generator=None,
                         two_phase=True):
        logits = jnp.where(jnp.asarray(mask[0].numpy()), 0.0, -jnp.inf)
        k_samp, k_sub = jax.random.split(jax.random.PRNGKey(0))
        s = jax.random.categorical(k_samp, logits, shape=(n_hypotheses, 5))
        sub = jax.random.categorical(k_sub, logits, shape=(128,))
        return (torch.from_numpy(np.array(s))[None].long(),
                torch.from_numpy(np.array(sub))[None].long())

    monkeypatch.setattr(transac, "sample_indices", jax_pair_samples)
    x0, x1, K, T, _ = synthetic_pose_scene(np.random.default_rng(5), n=90,
                                           noise=0.3, outlier_frac=0.2)
    p0n = ((x0 - K[[0, 1], [2, 2]]) / K[[0, 1], [0, 1]]).astype(np.float32)
    p1n = ((x1 - K[[0, 1], [2, 2]]) / K[[0, 1], [0, 1]]).astype(np.float32)
    g = tmet.estimate_pose_torch(p0n, p1n, 1.0 / 320, device="cpu")
    w = jransac.estimate_pose_jax(p0n, p1n, 1.0 / 320)
    np.testing.assert_allclose(g[0], w[0], atol=1e-4)
    np.testing.assert_allclose(g[1], w[1], atol=1e-4)
    assert (g[2] != w[2]).sum() <= 1 and len(g[2]) == 90
    assert tmet.estimate_pose_torch(p0n[:4], p1n[:4], 0.01,
                                    device="cpu") is None


# ---------------------------------------------------------------------------
# the evaluation loops
# ---------------------------------------------------------------------------


def _port_config(jcfg):
    """The port's EIMConfig with the fields of a JAX EIMConfig."""
    from ei_nexus_tpu_torch.models import eim as teim
    from ei_nexus_tpu_torch.models.extractor import KeypointExtractorConfig

    def spec(s):
        return teim.ExtractorSpec(**{
            **{f.name: getattr(s, f.name)
               for f in dataclasses.fields(teim.ExtractorSpec)
               if f.name != "keypoints"},
            "keypoints": KeypointExtractorConfig(**{
                f.name: getattr(s.keypoints, f.name)
                for f in dataclasses.fields(KeypointExtractorConfig)})})

    m = jcfg.matcher
    lg = teim.LightGlueConfig(**{
        f.name: getattr(m.lightglue, f.name)
        for f in dataclasses.fields(teim.LightGlueConfig)
        if hasattr(m.lightglue, f.name) and f.name != "attention_impl"})
    return teim.EIMConfig(
        event_extractor=spec(jcfg.event_extractor),
        image_extractor=spec(jcfg.image_extractor),
        matcher=teim.MatcherConfig(
            type=m.type, freeze=m.freeze, max_points_num=m.max_points_num,
            pad_mode=m.pad_mode, desc_scale_factor=m.desc_scale_factor,
            ratio_thresh=m.ratio_thresh, distance_thresh=m.distance_thresh,
            lightglue=lg))


@pytest.fixture(scope="module", params=["MNN", "LightGlue"])
def eval_models(request):
    """(JAX state, JAX eval step, port model, batches, empty batch): the
    small config of tests/test_evaluate.py with either matcher, the same
    perturbed weights on both sides, two synthetic batches and an
    empty-event one. The JAX eval step is compiled once here (its loops
    would build and compile their own each call) with the voxel grid as
    the exact scatter (fast=False, the port's)."""
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.models import EIM
    from ei_nexus_tpu.train import create_train_state
    from ei_nexus_tpu.train.steps import batch_representation
    from ei_nexus_tpu_torch.models import eim as teim
    from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
    from tests.test_evaluate import empty_event_batch
    from tests.test_torch_train import _perturb
    from tests.test_train import BINS, H, W, small_config, synth_batch

    rng = np.random.default_rng(0)
    jcfg = small_config(request.param)
    jmodel = EIM(config=jcfg)
    batch = synth_batch(rng)
    ev_rep, ev_mask = batch_representation(
        {k: jnp.asarray(v) for k, v in batch[0].items()
         if k.startswith("events")}, "VoxelGrid", BINS, H, W)
    variables = _perturb(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0)}, ev_rep,
        jnp.asarray(batch[0]["image"]), ev_mask))
    jstate = create_train_state(jmodel, variables, optax.sgd(0.0))
    model = teim.EIM(_port_config(jcfg))
    model.load_state_dict(load_jax_variables(variables), strict=True)
    batches = [synth_batch(rng) for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        exact = jsteps.batch_representation
        mp.setattr(jsteps, "batch_representation",
                   lambda *a, **k: exact(*a, fast=False, **k))
        jstep = jsteps.make_eval_step(jmodel, "VoxelGrid", BINS, H, W)
        jstep(jstate, batches[0])       # traced with the exact scatter
    return jstate, jstep, model.eval(), batches, empty_event_batch(rng)


@pytest.fixture
def jax_loops(eval_models, monkeypatch):
    """The JAX evaluation loops, running the fixture's compiled step."""
    from ei_nexus_tpu.train import evaluate as jeval
    monkeypatch.setattr(jeval, "make_eval_step", lambda *a: eval_models[1])
    return jeval


def _same_matches(jstate, jstep, model, batches):
    """The JAX and port eval steps give equal matches0 on every batch."""
    from ei_nexus_tpu_torch.train.steps import make_eval_step
    from tests.test_train import BINS, H, W
    tstep = make_eval_step("VoxelGrid", BINS, H, W)
    n = 0
    for b in batches:
        want = np.asarray(jstep(jstate, b)[2]["matches0"])
        got = tstep(model, b)[2]["matches0"].numpy()
        np.testing.assert_array_equal(got, want)
        n += int((got > -1).sum())
    return n


def test_val_extractor_matches_jax(eval_models, jax_loops):
    from ei_nexus_tpu_torch.train.evaluate import val_extractor
    from tests.test_train import BINS, H, W

    jstate, jstep, model, batches, empty = eval_models
    assert _same_matches(jstate, jstep, model, batches) > 0
    for run in (batches, [empty]):
        _same_matches(jstate, jstep, model, run)
        want = _cv2_seeded(jax_loops.val_extractor, jstate, None, run,
                           "VoxelGrid", BINS, H, W)
        got = _cv2_seeded(val_extractor, model, run, "VoxelGrid", BINS, H,
                          W)
        _assert_dicts_equal(got, want, rtol=1e-6, atol=1e-6)
        assert "R@1" in got and "MR" in got and "HE@3_auc" in got


@pytest.mark.parametrize("backend", ["opencv", "torch"])
def test_rpe_eval_matches_jax(eval_models, jax_loops, backend, monkeypatch):
    """Both backends, the device one given JAX's samples (PRNGKey(0) for
    every batch, as the JAX loop draws); the batches, then an empty-event
    batch and a real one together (failed pairs are inf and left out of
    the means)."""
    from ei_nexus_tpu_torch.train.evaluate import rpe_eval
    from tests.test_train import BINS, H, W

    def jax_samples(mask, n_hypotheses, solver, generator=None,
                    two_phase=True):
        return _jax_indices(jax.random.PRNGKey(0), mask.cpu().numpy(),
                            n_hypotheses, solver)

    monkeypatch.setattr(transac, "sample_indices", jax_samples)
    jstate, jstep, model, batches, empty = eval_models
    for run in (batches, [empty, batches[0]]):
        _same_matches(jstate, jstep, model, run)
        want = _cv2_seeded(jax_loops.rpe_eval, jstate, None, run,
                           "VoxelGrid", BINS, H, W,
                           backend="jax" if backend == "torch" else "opencv")
        got = _cv2_seeded(rpe_eval, model, run, "VoxelGrid", BINS, H, W,
                          backend=backend)
        if backend == "opencv":
            _assert_dicts_equal(got, want, rtol=1e-6, atol=1e-6)
        else:
            _assert_rpe_close(got, want)
        assert got["n_pairs"] == 2 * len(run)
        assert all(not np.isinf(v) for v in got.values())


def test_eval_loops_address_the_matchers_slots():
    """512-of-1024 in small: extractor K half the matcher's slots (the
    SiLK configuration); the loops read keypoints from the matcher's
    input feats, which the match indices address."""
    from ei_nexus_tpu_torch.models import eim as teim
    from ei_nexus_tpu_torch.models.extractor import KeypointExtractorConfig
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.train.evaluate import rpe_eval, val_extractor
    from tests.test_train import BINS, H, KPTS, W, small_config, synth_batch

    cfg = _port_config(small_config("MNN"))
    k = KeypointExtractorConfig(detection_top_k=KPTS // 2)
    cfg = dataclasses.replace(
        cfg, event_extractor=dataclasses.replace(cfg.event_extractor,
                                                 keypoints=k),
        image_extractor=dataclasses.replace(cfg.image_extractor,
                                            keypoints=k))
    model = teim.EIM(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    batches = [synth_batch(np.random.default_rng(1))]
    out = val_extractor(model.eval(), batches, "VoxelGrid", BINS, H, W)
    assert "MR" in out and np.isfinite(out["MR"])
    for backend in ("opencv", "torch"):
        assert rpe_eval(model, batches, "VoxelGrid", BINS, H, W,
                        backend=backend)["n_pairs"] == 2


# ---------------------------------------------------------------------------
# evaluation pairs
# ---------------------------------------------------------------------------


class _Sequence:
    """What `filter_pairs_by_overlap` reads of a sequence: a plane at 3 m
    seen by a camera moving along x."""

    def __init__(self, n=12, H=24, W=32):
        self.K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
        self.depth = np.full((n, H, W), 3.0, np.float32)
        self.depth[:, :2] = np.nan
        self.depth_ts = np.arange(n, dtype=np.float64)
        self.pose_interpolator = self

    @staticmethod
    def interpolate(t):
        T = np.eye(4)
        T[0, 3] = -0.35 * t
        return T


def test_val_pairs_match_jax():
    from ei_nexus_tpu.data import val_pairs as jvp
    from ei_nexus_tpu_torch.data import val_pairs as tvp

    np.testing.assert_array_equal(
        tvp.generate_candidate_pairs(40, 8, 30, np.random.default_rng(0)),
        jvp.generate_candidate_pairs(40, 8, 30, np.random.default_rng(0)))
    seq = _Sequence()
    cands = jvp.generate_candidate_pairs(len(seq.depth), 6, 10,
                                         np.random.default_rng(1))
    for a, b in ((0, 1), (0, 3), (2, 2), (1, 7)):
        T01 = seq.pose_interpolator.interpolate(b) @ np.linalg.inv(
            seq.pose_interpolator.interpolate(a))
        args = (np.nan_to_num(seq.depth[a]), np.nan_to_num(seq.depth[b]),
                seq.K, T01, np.linalg.inv(T01))
        assert tvp.pair_overlap_ratio(*args, stride=2, device="cpu") == \
            jvp.pair_overlap_ratio(*args, stride=2)
    kept = tvp.filter_pairs_by_overlap(seq, cands, 0.2, 0.95, stride=2,
                                       device="cpu")
    np.testing.assert_array_equal(
        kept, jvp.filter_pairs_by_overlap(seq, cands, 0.2, 0.95, stride=2))
    assert 0 < len(kept) < len(cands)
    np.testing.assert_array_equal(
        tvp.sample_final_indices(kept, 3, np.random.default_rng(2)),
        jvp.sample_final_indices(kept, 3, np.random.default_rng(2)))
