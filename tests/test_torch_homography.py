"""The port's homography-supervised stage 2 against the JAX package, on the
CPU, in float32: the homographic sampling ops, homography warping and
sampling, ground-truth matches from a known homography, and the whole
homography step.

Tolerances, each with its reason:
 - H from the 4-point DLT: rtol 1e-4 (an 8x8 float32 solve whose LU
   pivots may round differently on the two sides; a jittered quad's
   condition number amplifies the rounding);
 - bilinear sampling: 1e-5 x max|image| (the same four float32 taps
   and weights); perspective crops: that plus max|image| times how far
   the two sides' float32 H^-1 put the sampling points apart (`_moved`:
   at 180x240 the inverses' rounding moves a point ~1e-4 px, which a
   noise image turns into ~0.01 grey levels);
 - warping: 1e-5 (float32 products of 3x3 matrices);
 - the step: as the pose+depth stage-2 parity test (loss rel 1e-5,
   grad_norm rel 1e-4, matcher parameters atol 4 * lr, frozen tensors
   bit-equal), H and image1 as above.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.geometry import gt_matches_from_homography as jax_gt_h
from ei_nexus_tpu.geometry import homography as jhom
from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.ops import homographic as jops
from ei_nexus_tpu_torch.geometry import gt_matches_from_homography
from ei_nexus_tpu_torch.geometry import homography as thom
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.ops import homographic as tops
from ei_nexus_tpu_torch.train.steps import homography_view

from tests.test_torch_train import _perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _jittered_quads(rng, n, height, width, max_jitter=0.125):
    corners = np.float32([[0, 0], [width, 0], [width, height], [0, height]])
    jitter = (rng.uniform(-1, 1, (n, 4, 2)) * np.float32([width, height])
              * max_jitter).astype(np.float32)
    return corners[None] + jitter, np.broadcast_to(corners, (n, 4, 2))


# ---------------------------------------------------------------------------
# ops/homographic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalized", [True, False])
def test_create_meshgrid_matches_jax(normalized):
    want = np.asarray(jops.create_meshgrid(7, 5, normalized))
    got = tops.create_meshgrid(7, 5, normalized).numpy()
    assert got.shape == (5, 7, 2)
    np.testing.assert_array_equal(got, want)


def test_perspective_transform_matches_jax():
    """The DLT on 64 seeded quads jittered by up to 1/8 of a 180x240
    frame: H against JAX's, and H maps each src corner onto its dst."""
    src, dst = _jittered_quads(np.random.default_rng(0), 64, 180, 240)
    want = np.asarray(jops.perspective_transform_from_points(
        jnp.asarray(src), jnp.asarray(dst)))
    got = tops.perspective_transform_from_points(_t(src), _t(dst))
    assert got.shape == (64, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)
    assert (got[:, 2, 2] == 1).all()
    mapped = tops.transform_points(got, _t(src))
    np.testing.assert_allclose(mapped.numpy(), dst, atol=1e-3)


def test_bilinear_sample_matches_jax():
    """Points inside, on the border and outside the image (zero there)."""
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 255, (2, 9, 13, 3)).astype(np.float32)
    pts = rng.uniform(-3, 16, (2, 5, 7, 2)).astype(np.float32)
    pts[0, 0, :3] = [[0.5, 0.5], [13.0, 9.0], [-0.5, 4.0]]
    want = np.stack([np.asarray(jops.bilinear_sample_image(
        jnp.asarray(image[b]), jnp.asarray(pts[b]))) for b in range(2)])
    got = tops.bilinear_sample_image(_t(image), _t(pts)).numpy()
    assert got.shape == (2, 5, 7, 3)
    np.testing.assert_allclose(got, want, atol=1e-5 * 255, rtol=0)


@pytest.mark.parametrize("frame,crop", [((24, 32), (24, 32)),
                                        ((16, 16), (18, 24))])
def test_extract_crops_batched_matches_jax(frame, crop):
    """Crops through jittered homographies, the crop the frame's size or
    larger (EC: a 160x160 frame warped into the 180x240 grid)."""
    rng = np.random.default_rng(2)
    image = rng.uniform(0, 255, (3, *frame, 1)).astype(np.float32)
    src, dst = _jittered_quads(rng, 3, *crop)
    H = jops.perspective_transform_from_points(jnp.asarray(src),
                                               jnp.asarray(dst))
    want = np.asarray(jops.extract_crops_batched(jnp.asarray(image), H,
                                                 crop))
    got = tops.extract_crops_batched(_t(image), _t(H), crop).numpy()
    assert got.shape == (3, *crop, 1)
    bound = (1e-5 + _moved(_t(H), H, *crop)) * 255
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
    one = tops.extract_crop(_t(image[1]), _t(H[1]), crop).numpy()
    np.testing.assert_array_equal(one, got[1])


def _moved(tH, jH, height, width):
    """How far (|dx| + |dy|, px, the largest over the grid) the crop grid's
    sampling points lie apart when each side maps it through its own
    float32 H^-1."""
    grid = tops.create_meshgrid(width, height, normalized=False)
    grid = grid.reshape(-1, 2)
    tp = tops.transform_points(torch.linalg.inv_ex(tH)[0], grid)
    jp = jops.transform_points(jnp.linalg.inv(jnp.asarray(jH)),
                               jnp.asarray(grid.numpy()))
    return float(np.abs(tp.numpy() - np.asarray(jp)).sum(-1).max())


def _check_view(image0, jitter, jH, jimage1, height, width):
    """The port's (H, image1) from `homography_view` against JAX's: H to
    rtol 1e-4; image1 to 1e-5 x max|image| plus what the sampling points'
    rounding allows: each side inverts H in float32, and bilinear sampling
    moves a value by at most max|image| for each pixel a point moves along
    x and along y (zero outside included). Checked through JAX's H and
    through the port's own."""
    H, image1 = homography_view(_t(image0), _t(jitter), height, width)
    assert image1.shape == jimage1.shape == (len(image0), height, width, 1)
    jH, jimage1 = np.asarray(jH), np.asarray(jimage1)
    np.testing.assert_allclose(H.numpy(), jH, rtol=1e-4, atol=1e-7)
    top = float(np.abs(image0).max())
    for h in (_t(jH), H):
        crop = tops.extract_crops_batched(_t(image0), h, (height, width))
        bound = (1e-5 + _moved(h, jH, height, width)) * top
        np.testing.assert_allclose(crop.numpy(), jimage1, atol=bound,
                                   rtol=0)
    return H, image1


def test_homography_view_at_ec_shapes_matches_jax():
    """The step's second view at EC's shapes, pinned on both sides: the
    grid is dataset.resolution (180x240, no crop clamp), the pair
    augmentation's frame is 160x160, so image1 is that frame warped into
    the 180x240 grid, zero where the warp leaves it."""
    rng = np.random.default_rng(3)
    image0 = rng.uniform(0, 255, (2, 160, 160, 1)).astype(np.float32)
    src, dst = _jittered_quads(rng, 2, 180, 240)
    jH = jops.perspective_transform_from_points(jnp.asarray(src),
                                                jnp.asarray(dst))
    jimage1 = jops.extract_crops_batched(jnp.asarray(image0), jH,
                                         (180, 240))
    _, image1 = _check_view(image0, src - dst, jH, jimage1, 180, 240)
    # the frame covers 160 of 240 columns at most: the right side is empty
    assert (image1[:, :, 225:] == 0).all()


# ---------------------------------------------------------------------------
# geometry/homography
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [True, False])
def test_warp_points_homography_matches_jax(inverse):
    rng = np.random.default_rng(4)
    src, dst = _jittered_quads(rng, 3, 32, 48)
    H = np.asarray(jops.perspective_transform_from_points(
        jnp.asarray(src), jnp.asarray(dst)))
    pts = rng.uniform(0, 48, (3, 20, 2)).astype(np.float32)
    want = np.asarray(jhom.warp_points_homography(jnp.asarray(pts),
                                                  jnp.asarray(H), inverse))
    got = thom.warp_points_homography(_t(pts), _t(H), inverse).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    xyp = np.concatenate([pts, rng.uniform(size=(3, 20, 1))], -1)
    xyp = xyp.astype(np.float32)
    np.testing.assert_allclose(
        thom.warp_points_prob(_t(xyp), _t(H)).numpy(),
        np.asarray(jhom.warp_points_prob(jnp.asarray(xyp), jnp.asarray(H))),
        atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_homography_corners_matches_jax(seed):
    """The host sampler from one `np.random.Generator` seed on each side:
    the same draws, the same H (float64) and warped corners (float32)."""
    kw = dict(shape=(240, 180), patch_shape=(160, 120), difficulty=0.8)
    jH, jfull, jwarp, jpatch = jhom.sample_homography_corners(
        rng=np.random.default_rng(seed), **kw)
    H, full, warp, patch = thom.sample_homography_corners(
        rng=np.random.default_rng(seed), **kw)
    np.testing.assert_allclose(H, jH, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(full, jfull)
    np.testing.assert_allclose(warp, jwarp, atol=1e-5, rtol=1e-6)
    assert patch == jpatch
    np.testing.assert_array_equal(thom.compute_homography_4pt(full, full),
                                  jhom.compute_homography_4pt(full, full))


# ---------------------------------------------------------------------------
# ground-truth matches from a homography
# ---------------------------------------------------------------------------


def test_gt_matches_from_homography_matches_jax():
    """kp1 is kp0 warped by H and moved by offsets around the thresholds
    (pos_th 3, neg_th 6: 0.5, 2.9, 3.1, 5.9, 6.1, 9 px), shuffled, with
    masked slots on both sides: labels, assignment and reward equal."""
    rng = np.random.default_rng(5)
    B, N = 2, 24
    src, dst = _jittered_quads(rng, B, 32, 48)
    H = np.asarray(jops.perspective_transform_from_points(
        jnp.asarray(src), jnp.asarray(dst)))
    kp0 = rng.uniform(4, 44, (B, N, 2)).astype(np.float32)
    warped = np.asarray(jhom.warp_points_homography(
        jnp.asarray(kp0), jnp.asarray(H), inverse=False))
    radius = rng.choice([0.5, 2.9, 3.1, 5.9, 6.1, 9.0], (B, N))
    angle = rng.uniform(0, 2 * np.pi, (B, N))
    off = radius[..., None] * np.stack([np.cos(angle), np.sin(angle)], -1)
    perm = np.stack([rng.permutation(N) for _ in range(B)])
    kp1 = np.take_along_axis(warped + off, perm[..., None], 1)
    kp1 = kp1.astype(np.float32)
    mask0 = rng.uniform(size=(B, N)) > 0.2
    mask1 = rng.uniform(size=(B, N)) > 0.2
    for masks in ((None, None), (mask0, mask1)):
        want = jax_gt_h(jnp.asarray(kp0), jnp.asarray(kp1), jnp.asarray(H),
                        mask0=None if masks[0] is None
                        else jnp.asarray(masks[0]),
                        mask1=None if masks[1] is None
                        else jnp.asarray(masks[1]))
        got = gt_matches_from_homography(
            _t(kp0), _t(kp1), _t(H),
            mask0=None if masks[0] is None else _t(masks[0]),
            mask1=None if masks[1] is None else _t(masks[1]))
        assert set(got) == set(want)
        for k in ("matches0", "matches1", "assignment", "reward",
                  "matching_scores0", "matching_scores1"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("proj_0to1", "proj_1to0"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-4, err_msg=k)
        assert (got["matches0"] >= 0).sum() > 0
        assert (got["matches0"] == -1).sum() > 0
    assert (got["matches0"][~_t(mask0)] == -2).all()


# ---------------------------------------------------------------------------
# the homography step
# ---------------------------------------------------------------------------


def _jax_side(monkeypatch):
    """(jax stage-2 model with its event extractor frozen and XLA
    attention, its perturbed variables, the batch, (H, W, bins), the exact
    JAX batch_representation); the JAX voxel grid switched to its exact
    scatter (fast=False, the port's)."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu_torch.data.synth import homography_batch

    exact = jsteps.batch_representation
    monkeypatch.setattr(jsteps, "batch_representation",
                        lambda *a, **k: exact(*a, fast=False, **k))
    jm0, (H, W, bins) = _flagship(tiny=True)
    jc = jm0.config
    jcfg = dataclasses.replace(
        jc, event_extractor=dataclasses.replace(jc.event_extractor,
                                                freeze=True),
        matcher=dataclasses.replace(jc.matcher, lightglue=dataclasses.replace(
            jc.matcher.lightglue, attention_impl="xla")))
    jm = jeim.EIM(config=jcfg)
    batch = homography_batch(np.random.default_rng(0), 2, 3000, 4096, H, W)
    rep, mask = exact(batch[0], "VoxelGrid", bins, H, W, fast=False)
    init = jax.jit(lambda keys, r, im, m: jm.init(keys, r, im, m, None,
                                                  True))
    variables = _perturb(init(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, jnp.asarray(batch[0]["image"]), mask))
    return jm, variables, batch, (H, W, bins), (rep, mask)


def _port_state(variables):
    from ei_nexus_tpu_torch.flagship import stage2_config, stage2_train_state
    tcfg, _ = stage2_config(tiny=True, dtype="float32")
    tcfg = dataclasses.replace(tcfg, matcher=dataclasses.replace(
        tcfg.matcher, lightglue=dataclasses.replace(
            tcfg.matcher.lightglue, attention_impl="xla")))
    model = teim.EIM(tcfg, training_heads=True)
    model.load_state_dict(load_jax_variables(variables), strict=True)
    return model, stage2_train_state(model)


def test_homography_step_matches_jax(monkeypatch):
    """`make_stage2_homography_train_step` for 2 steps against the JAX step
    on the tiny flagship in float32 (random slot fill, XLA attention on
    both sides). JAX's draws are reproduced from its key as the step makes
    them (rng_h, rng_pad = split(key); the jitter from rng_h; the fill is
    what the JAX model's training forward under rng_pad puts in the
    slots) and handed to the port's step. Both steps take the float
    events, from which the fill's forward builds its voxel grid: the
    wire's 1/64-px coordinates would move the event keypoints, and so the
    slots the fill takes (the wire is held equal to the JAX package's in
    tests/test_torch_wire.py; the next test trains from it)."""
    from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                    freeze_mask)
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
    from ei_nexus_tpu.train.partition import frozen_roots_from_config
    from ei_nexus_tpu_torch.flagship import (STAGE2_LR, STAGE2_OPTIMIZER,
                                             STAGE2_SCHEDULER)
    from ei_nexus_tpu_torch.train.steps import (
        make_stage2_homography_train_step)

    jm, variables, batch, (H, W, bins), (rep, mask) = _jax_side(monkeypatch)
    tx = build_optimizer(STAGE2_OPTIMIZER,
                         jax_schedule(STAGE2_SCHEDULER, STAGE2_LR, 1))
    jstate = create_train_state(jm, variables, tx)
    jstep = jsteps.make_stage2_homography_train_step(
        jm, freeze_mask(jstate.params, frozen_roots_from_config(jm.config)),
        "VoxelGrid", bins, H, W)
    model, state = _port_state(variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tstep = make_stage2_homography_train_step("VoxelGrid", bins, H, W)
    image0 = jnp.asarray(batch[0]["image"])
    corners = jnp.asarray([[0.0, 0.0], [W, 0.0], [W, H], [0.0, H]],
                          jnp.float32)

    @jax.jit
    def jax_draws(params, batch_stats, key):
        rng_h, rng_pad = jax.random.split(key)
        jitter = jax.random.uniform(rng_h, (2, 4, 2), minval=-1.0,
                                    maxval=1.0) * \
            jnp.asarray([W, H], jnp.float32) * 0.125
        Hmat = jops.perspective_transform_from_points(
            corners[None] + jitter, jnp.broadcast_to(corners, (2, 4, 2)))
        image1 = jops.extract_crops_batched(image0, Hmat, (H, W))
        (_, _, m), _ = jm.apply(
            {"params": params, "batch_stats": batch_stats}, rep, image1,
            mask, None, True, mutable=["batch_stats"],
            rngs={"pad": rng_pad})
        fill = tuple((m[f"input_feats{s}"]["sparse_positions"],
                      m[f"input_feats{s}"]["sparse_descriptors"])
                     for s in (0, 1))
        return jitter, Hmat, image1, fill

    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jitter, jH, jimage1, jfill = jax_draws(jstate.params,
                                               jstate.batch_stats, key)
        _check_view(batch[0]["image"], np.asarray(jitter), jH, jimage1,
                    H, W)
        fill = tuple((_t(p), _t(d)) for p, d in jfill)
        jstate, jinfo = jstep(jstate, batch, key)
        tinfo = tstep(state, batch, fill=fill, jitter=_t(jitter))
        assert set(tinfo) == set(jinfo)
        np.testing.assert_allclose(float(tinfo["loss"]),
                                   float(jinfo["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-4)
        assert float(tinfo["gt_matches"]) == float(jinfo["gt_matches"])
        assert float(tinfo["dropped_splat_weight"]) == 0.0
        want = load_jax_variables({"params": jstate.params,
                                   "batch_stats": jstate.batch_stats})
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            if k.startswith("matcher."):
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           atol=4 * STAGE2_LR, rtol=0,
                                           err_msg=k)
            else:   # frozen: bit-equal to the JAX state and to the start
                assert torch.equal(got[k], want[k]), k
                assert torch.equal(got[k], start[k]), k
    assert float(jinfo["gt_matches"]) > 0
    assert state.step == 2


def test_homography_step_loss_falls():
    """The port's own homography step for 6 steps on the tiny stage-2
    flagship (the port's seeded initialisation) from the wire, each step's
    jitter and fill drawn from one seeded generator, as the JAX package's
    test runs its step with a new key each step: the loss falls, finite
    throughout, and the frozen extractors do not move."""
    from ei_nexus_tpu_torch.data.synth import homography_batch
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import (
        compact_stage2_homography_batch, make_stage2_homography_train_step)

    model, (H, W, bins) = build_stage2_flagship(tiny=True, dtype="float32",
                                                device="cpu")
    state = stage2_train_state(model)
    batch = homography_batch(np.random.default_rng(0), 2, 3000, 4096, H, W)
    start = {k: v.clone() for k, v in model.state_dict().items()
             if not k.startswith("matcher.")}
    step = make_stage2_homography_train_step("VoxelGrid", bins, H, W)
    wire = compact_stage2_homography_batch(batch)
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(state, wire, gen)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in start.items())
