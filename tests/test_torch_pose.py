"""The port's pose tail (metrics/fivepoint.py, metrics/ransac.py) against
the JAX package's, on the CPU.

The five-point solver is held to JAX's candidates as SETS: another QR
returns another orthonormal basis of the nullspace, which permutes the
candidates, so each valid JAX candidate must appear among the port's up to
sign, to 1e-4, both sides in float64. RANSAC (float32) is compared with the
sample indices JAX draws (recomputed from its own key chain and injected
into the port), since torch cannot replay `jax.random.categorical`: R and
t to 1e-4 on the solvable pairs, n_inliers to +-1 (float32 distances
summed in another order can move a point across the threshold), a pair
without valid slots exactly equal. In float32 the candidates of an
ill-conditioned minimal sample differ between the two sides (the degree-10
polynomial's clustered roots), which can reorder near-tied hypotheses: on
some random scenes another sample then wins, its rotation a little away,
both near the truth. The scenes below are fixed and their winners agree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.metrics import ransac as jr
from ei_nexus_tpu.metrics.fivepoint import five_point_candidates as jfive
from ei_nexus_tpu_torch.metrics import ransac as tr
from ei_nexus_tpu_torch.metrics.fivepoint import five_point_candidates
from test_fivepoint import make_scene
from tests.test_torch_threads import one_torch_thread  # noqa: F401

THRESH = 5e-3   # normalized units: 1/199 px at the flagship's focal 199


def _t(a):
    return torch.from_numpy(np.array(a))


def _sign_match(a, cands):
    """Smallest max|a -+ c| over candidate matrices c."""
    return min(min(np.abs(a - c).max(), np.abs(a + c).max()) for c in cands)


def test_five_point_candidate_sets_match_jax(rng):
    """Float64 on both sides: the candidate sets agree to 1e-4. In float32
    the spurious roots of a clustered degree-10 polynomial move under
    rounding alone, on either side, so there the test holds the count of
    valid candidates and the truth."""
    S = 24
    scenes = [make_scene(rng, 5) for _ in range(S)]
    p0 = np.stack([s[0] for s in scenes]).astype(np.float64)
    p1 = np.stack([s[1] for s in scenes]).astype(np.float64)
    with jax.enable_x64(True):
        Ej, vj = map(np.asarray, jax.jit(jfive)(jnp.asarray(p0),
                                                jnp.asarray(p1)))
    assert Ej.dtype == np.float64
    Et, vt = five_point_candidates(_t(p0), _t(p1))
    Et, vt = Et.numpy(), vt.numpy()
    assert Et.shape == (S, 10, 3, 3) and vt.shape == (S, 10)
    np.testing.assert_array_equal(vt.sum(1), vj.sum(1))
    for i in range(S):
        got = [Et[i, k] for k in range(10) if vt[i, k]]
        for k in range(10):
            if vj[i, k]:
                assert _sign_match(Ej[i, k], got) < 1e-4, (i, k)
    # float32, the pose tail's type
    Ej, vj = map(np.asarray, jax.jit(jfive)(p0.astype(np.float32),
                                            p1.astype(np.float32)))
    Et, vt = five_point_candidates(_t(p0).float(), _t(p1).float())
    np.testing.assert_array_equal(vt.sum(1).numpy(), vj.sum(1))
    # the truth is among them but for a couple of ill-conditioned misses,
    # as tests/test_fivepoint.py asks of the JAX solver
    recovered = sum(_sign_match(scenes[i][2], [Et[i, k].numpy() for k in
                                               range(10) if vt[i, k]]) < 2e-2
                    for i in range(S))
    assert recovered >= S - 2


def test_five_point_degenerate_sample_stays_finite():
    p = torch.ones(1, 5, 2)
    E, valid = five_point_candidates(p, p * 0.5)
    assert torch.isfinite(E[valid]).all()


def _scene_batch(rng, counts, N=256, noise=1e-3, outliers=0.2):
    """B pairs of N slots; pair b has counts[b] valid correspondences
    (first), the rest zero padding."""
    B = len(counts)
    p0 = np.zeros((B, N, 2), np.float32)
    p1 = np.zeros((B, N, 2), np.float32)
    mask = np.zeros((B, N), bool)
    truth = []
    for b, n in enumerate(counts):
        mask[b, :n] = True
        if n:
            a0, a1, _, R, t = make_scene(rng, n, noise=noise,
                                         outlier_frac=outliers)
            p0[b, :n], p1[b, :n] = a0, a1
            truth.append((R, t))
        else:
            truth.append(None)
    return p0, p1, mask, truth


def _jax_indices(key, mask, S, solver):
    """The indices jax's estimate_pose_batch draws: split(key, B), then per
    pair split(k_i) and categorical over the valid slots of shapes (S, 5)
    and (128,) for 5pt, or categorical(k_i) of shape (S, 8) for 8pt."""
    samples, subsets = [], []
    for b, k_i in enumerate(jax.random.split(key, mask.shape[0])):
        logits = jnp.where(jnp.asarray(mask[b]), 0.0, -jnp.inf)
        if solver == "5pt":
            k_samp, k_sub = jax.random.split(k_i)
            samples.append(jax.random.categorical(k_samp, logits,
                                                  shape=(S, 5)))
            subsets.append(jax.random.categorical(k_sub, logits,
                                                  shape=(128,)))
        else:
            samples.append(jax.random.categorical(k_i, logits, shape=(S, 8)))
    return (torch.from_numpy(np.stack(samples)).long(),
            torch.from_numpy(np.stack(subsets)).long() if subsets else None)


@pytest.mark.parametrize("solver,S", [("5pt", 128), ("8pt", 256)])
def test_estimate_pose_batch_matches_jax(rng, solver, S):
    counts = [150, 100, 3, 0]   # two solvable, one too few, one empty
    p0, p1, mask, truth = _scene_batch(rng, counts)
    thr = np.full(len(counts), THRESH, np.float32)
    key = jax.random.PRNGKey(3)
    Rj, tj, ij, nj = map(np.asarray, jr.estimate_pose_batch(
        p0, p1, mask, thr, key, n_hypotheses=S, solver=solver))
    indices = _jax_indices(key, mask, S, solver)
    Rt, tt, it, nt = (x.numpy() for x in tr.estimate_pose_batch(
        _t(p0), _t(p1), _t(mask), _t(thr), n_hypotheses=S, solver=solver,
        indices=indices))
    assert np.abs(nt - nj).max() <= 1
    for b in (0, 1):
        np.testing.assert_allclose(Rt[b], Rj[b], atol=1e-4)
        np.testing.assert_allclose(tt[b], tj[b], atol=1e-4)
        assert (it[b] != ij[b]).sum() <= 1
        cos = np.clip((np.trace(Rt[b].T @ truth[b][0]) - 1) / 2, -1, 1)
        assert np.degrees(np.arccos(cos)) < 1.0
    # no valid slot: every sample is slot 0, as categorical gives
    assert nt[3] == nj[3] == 0 and not it[3].any()
    np.testing.assert_array_equal(Rt[3], Rj[3])
    np.testing.assert_array_equal(tt[3], tj[3])


def test_estimate_pose_batch_from_matches_matches_jax(rng):
    """Fixed-K match outputs (yx positions, matches0 slots into side 1,
    per-pair intrinsics) posed in one call on each side."""
    B, K = 3, 128
    counts = [90, 60, 4]
    pos0 = np.zeros((B, K, 3), np.float32)
    pos1 = np.zeros((B, K, 3), np.float32)
    m0 = np.full((B, K), -1, np.int32)
    Ks = np.tile(np.array([[199.0, 0, 173], [0, 199.0, 130], [0, 0, 1]]),
                 (B, 1, 1))
    for b, n in enumerate(counts):
        a0, a1, *_ = make_scene(rng, n, noise=5e-4, outlier_frac=0.2)
        perm = rng.permutation(K)[:n]      # side-1 slots of the matches
        pos0[b, :n, :2] = (a0 * 199 + [173, 130])[:, ::-1]
        pos1[b, perm, :2] = (a1 * 199 + [173, 130])[:, ::-1]
        m0[b, :n] = perm
    want = jr.estimate_pose_batch_from_matches(pos0, pos1, m0, Ks, Ks,
                                               thresh=1.0, seed=7)
    sel = m0 > -1
    indices = _jax_indices(jax.random.PRNGKey(7), sel, 128, "5pt")
    got = tr.estimate_pose_batch_from_matches(pos0, pos1, m0, Ks, Ks,
                                              thresh=1.0, indices=indices,
                                              device="cpu")
    assert [g is None for g in got] == [w is None for w in want] \
        == [False, False, True]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[0], w[0], atol=1e-4)
        np.testing.assert_allclose(g[1], w[1], atol=1e-4)
        assert (g[2] != w[2]).sum() <= 1


def test_sampling_draws_valid_slots_and_slot_zero_without_any():
    mask = torch.zeros(3, 64, dtype=torch.bool)
    mask[0, 10:20] = True
    mask[1, 63] = True
    gen = torch.Generator().manual_seed(0)
    samples, subset = tr.sample_indices(mask, 32, "5pt", gen)
    assert samples.shape == (3, 32, 5) and subset.shape == (3, 128)
    for idx in (samples, subset):
        flat = idx.reshape(3, -1)
        assert ((flat[0] >= 10) & (flat[0] < 20)).all()
        assert (flat[1] == 63).all() and (flat[2] == 0).all()
    eight, none = tr.sample_indices(mask, 16, "8pt", gen)
    assert eight.shape == (3, 16, 8) and none is None
    # a generator reseeded gives the same draw
    again, _ = tr.sample_indices(mask, 32, "5pt",
                                 torch.Generator().manual_seed(0))
    assert torch.equal(again, samples)


def test_pose_from_drawn_samples_recovers_the_scene(rng):
    """Without injected indices: uniform draws from a seeded generator
    recover the rotation of solvable pairs to < 1 degree."""
    p0, p1, mask, truth = _scene_batch(rng, [614, 400], N=1024)
    R, t, inl, n = tr.estimate_pose_batch(
        _t(p0), _t(p1), _t(mask), torch.full((2,), THRESH),
        generator=torch.Generator().manual_seed(1))
    for b in range(2):
        cos = np.clip((np.trace(R[b].numpy().T @ truth[b][0]) - 1) / 2,
                      -1, 1)
        assert np.degrees(np.arccos(cos)) < 1.0
        assert int(n[b]) == int(inl[b].sum()) >= 0.7 * mask[b].sum()
