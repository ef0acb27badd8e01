"""The port's stage-2 training slice against the JAX package, on the CPU, in
float32: the differentiable attention (plain versions of kernels D and F)
against the interpreted Pallas kernels under `jax.grad`, the ground-truth
geometry, the loss, the schedule, LightGlue's training forward and
gradients, and the whole stage-2 step.

Tolerances, each with its reason:
 - D/F: atol 1e-5 at scale d^-0.5 and 5e-5 at scale 1.0 (the same float32
   products and softmax in another summation order; scale 1 gives larger
   logits), as tests/test_pallas.py holds the kernels to XLA;
 - geometry: projections and distances atol 1e-4 px (float32 matmul
   order), labels exact;
 - loss: rtol 1e-5 (float32 sums);
 - LightGlue training: outputs atol 1e-4 with rtol 1e-4, gradients atol
   1e-4 with rtol 1e-3 (float32 sums through two layers and the
   assignment heads' log-softmaxes);
 - the stage-2 step: loss rel 1e-5, grad_norm rel 1e-4, parameters atol
   4 * lr (Adam's first steps move a parameter by about lr whatever its
   gradient's size, so a near-zero gradient whose sign differs flips its
   step), frozen parameters bit-equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.geometry import Camera as JCamera, Pose as JPose
from ei_nexus_tpu.geometry import gt_matches_from_pose_depth as jax_gt
from ei_nexus_tpu.losses.matcher_loss import lightglue_loss as jax_loss
from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.ops.pallas_attention import fused_attention_vjp
from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
from ei_nexus_tpu_torch.geometry import Camera, Pose
from ei_nexus_tpu_torch.geometry import gt_matches_from_pose_depth
from ei_nexus_tpu_torch.losses import lightglue_loss
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.ops import attention_kernels as ak
from ei_nexus_tpu_torch.train.optim import build_schedule


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(variables, seed=0):
    """Random biases, norm scales and BN statistics (numpy, seeded), so
    that the weight mapping is exercised."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bias", "mean"):
                out[k] = jnp.asarray(rng.normal(0, 0.1, v.shape), v.dtype)
            elif k in ("scale", "var"):
                out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
            else:
                out[k] = v
        return out
    return {col: walk(jax.tree_util.tree_map(lambda x: x, tree))
            for col, tree in variables.items()}


# ---------------------------------------------------------------------------
# kernels D and F
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,atol", [(None, 1e-5), (1.0, 5e-5)])
def test_fused_attention_plain_matches_pallas_vjp(rng, scale, atol):
    B, h, N, M, d = 2, 2, 128, 256, 64
    q, co = (rng.normal(size=(B, h, N, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, h, M, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.uniform(size=(B, M)) > 0.2

    def jloss(q, k, v):
        out = fused_attention_vjp(q, k, v, jnp.asarray(mask), scale=scale,
                                  interpret=True)
        return jnp.sum(out * co), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = ak.fused_attention(tq, tk, tv, _t(mask), scale)
    tgrads = torch.autograd.grad((out * _t(co)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=atol)
    np.testing.assert_allclose(
        ak.fused_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                 scale).numpy(), np.asarray(jout), atol=atol)
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   err_msg=name)
    # the wrappers ran the plain versions: no kernel launched on the CPU
    assert ak.attention_fwd.launches == 0 and ak.attention_bwd.launches == 0


def test_fused_attention_masked_row_matches_pallas_vjp(rng):
    """A batch row whose keys are all masked: its softmax is uniform (the
    TPU backward recomputes m and Z in the kernel), and the port's
    gradients are that softmax's, as `jax.grad` of the interpreted Pallas
    kernels gives them."""
    B, h, N, M, d = 2, 2, 64, 128, 64
    q, co = (rng.normal(size=(B, h, N, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(B, h, M, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.uniform(size=(B, M)) > 0.2
    mask[1] = False

    def jloss(q, k, v):
        out = fused_attention_vjp(q, k, v, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * co)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = ak.fused_attention(tq, tk, tv, _t(mask))
    tgrads = torch.autograd.grad((out * _t(co)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=name)
    # the masked row's dV is the mean of its dO over the queries
    np.testing.assert_allclose(tgrads[2][1].numpy(),
                               np.broadcast_to(co[1].sum(1, keepdims=True)
                                               / M, (h, M, d)), atol=1e-5)


def _rebuilds_softmax(p: torch.Tensor, s: torch.Tensor) -> bool:
    """p is the row softmax of the scores s, to float32 rounding."""
    return bool(torch.allclose(p, torch.softmax(s, dim=-1), rtol=1e-5,
                               atol=1e-7))


def test_fwd_statistics_rebuild_the_softmax_of_a_masked_row(rng):
    """The row statistics `attention_fwd` returns on the CPU (row max m, row
    sum l of exp(s - m)) rebuild the plain softmax exp(s - m) / l, for a
    batch row whose keys are all masked too (1/M a key), as kernel F
    rebuilds P from kernel D's. A log-sum-exp would not: every masked score
    and m are -1e9, where a float32 ulp is 64, so m + log(l) rounds to m and
    exp(s - lse) is 1 for every key, M times the softmax."""
    B, h, N, M, d = 2, 2, 16, 1024, 64
    q = _t(rng.normal(size=(B, h, N, d)).astype(np.float32))
    k, v = (_t(rng.normal(size=(B, h, M, d)).astype(np.float32))
            for _ in range(2))
    mask = _t(rng.uniform(size=(B, M)) > 0.2)
    mask[1] = False
    bias = ak.key_bias(mask, B, M, "cpu")
    out, stats, v_read = ak.attention_fwd(q, k, v, bias, d ** -0.5)
    assert v_read is v                  # the plain version packs nothing
    assert stats.shape == (2, B, h, N) and stats.dtype == torch.float32
    s = torch.matmul(q, k.mT) * d ** -0.5 + bias[:, None, None]
    m, l = stats[0][..., None], stats[1][..., None]
    p = torch.exp(s - m) / l
    assert _rebuilds_softmax(p, s)
    assert torch.allclose(p[1], torch.full_like(p[1], 1.0 / M))
    lse = m + torch.log(l)
    assert not _rebuilds_softmax(torch.exp(s - lse), s)
    assert torch.equal(torch.exp(s - lse)[1].sum(-1),
                       torch.full((h, N), float(M)))


# ---------------------------------------------------------------------------
# geometry, loss, schedule
# ---------------------------------------------------------------------------

GH, GW = 48, 64


def _known_motion(B):
    K = np.tile(np.array([[60.0, 0, GW / 2], [0, 60.0, GH / 2], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    T01 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T01[:, 0, 3] = 0.05
    depth = np.full((B, GH, GW), 2.0, np.float32)
    depth[:, :3, :5] = 0.0   # an invalid corner: depth fallback and misses
    return K, T01, np.linalg.inv(T01).astype(np.float32), depth


def test_gt_matches_from_pose_depth_matches_jax(rng):
    """A known motion (60 px focal length, depth 2 m, a 5 cm x-shift: 1.5
    px of disparity): kp1 holds kp0's reprojections plus jitter and
    clutter, with duplicated keypoints (argmin ties) and points outside
    the image (all-inf rows)."""
    B, N = 2, 40
    K, T01, T10, depth = _known_motion(B)
    yx0 = rng.uniform([0, 0], [GH, GW], (B, N, 2)).astype(np.float32)
    yx1 = yx0.copy()
    yx1[..., 1] += 1.5
    yx1[:, :20] += rng.normal(0, 0.5, (B, 20, 2)).astype(np.float32)
    yx1[:, 30:] = rng.uniform([0, 0], [GH, GW], (B, 10, 2))
    yx1[:, 5] = yx1[:, 4]                      # a tie for every query
    yx0[:, 6] = [-5.0, 3.0]                    # outside the image
    mask1 = rng.uniform(size=(B, N)) > 0.1
    for masks in (False, True):
        jcam = JCamera.from_calibration_matrix(
            jnp.asarray(K), size=jnp.broadcast_to(
                jnp.asarray([GW, GH], jnp.float32), (B, 2)))
        want = jax_gt(jnp.asarray(yx0), jnp.asarray(yx1), jcam, jcam,
                      jnp.asarray(depth), jnp.asarray(depth),
                      JPose.from_4x4mat(jnp.asarray(T01)),
                      JPose.from_4x4mat(jnp.asarray(T10)),
                      mask1=jnp.asarray(mask1) if masks else None)
        cam = Camera.from_calibration_matrix(
            _t(K), size=torch.tensor([GW, GH], dtype=torch.float32))
        got = gt_matches_from_pose_depth(
            _t(yx0), _t(yx1), cam, cam, _t(depth), _t(depth),
            Pose.from_4x4mat(_t(T01)), Pose.from_4x4mat(_t(T10)),
            mask1=_t(mask1) if masks else None)
        assert set(got) == set(want)
        for key in want:
            a, b = got[key].numpy(), np.asarray(want[key])
            if a.dtype.kind in "bi":
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                np.testing.assert_allclose(a, b, atol=1e-4, err_msg=key)
        assert (got["matches0"] >= 0).sum() >= 10


@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_lightglue_loss_matches_jax(rng, gamma):
    B, L, N, M = 2, 3, 20, 24
    logits = rng.normal(size=(B, L, N + 1, M + 1)).astype(np.float32)
    la = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    conf0 = rng.normal(size=(B, L - 1, N)).astype(np.float32)
    conf1 = rng.normal(size=(B, L - 1, M)).astype(np.float32)
    m0 = rng.integers(-2, M, (B, N)).astype(np.int32)
    m1 = rng.integers(-2, N, (B, M)).astype(np.int32)
    assign = rng.uniform(size=(B, N, M)) > 0.95
    pred = {"all_log_assignments": la, "confidence_logits0": conf0,
            "confidence_logits1": conf1}
    gt = {"matches0": m0, "matches1": m1, "assignment": assign}
    jl, jinfo = jax_loss({k: jnp.asarray(v) for k, v in pred.items()},
                         {k: jnp.asarray(v) for k, v in gt.items()},
                         gamma=gamma)
    tl, tinfo = lightglue_loss({k: _t(v) for k, v in pred.items()},
                               {k: _t(v) for k, v in gt.items()},
                               gamma=gamma)
    assert set(tinfo) == set(jinfo)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jinfo:
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_cosine_schedule_matches_jax():
    cfg = {"type": "CosineAnnealingLR",
           "CosineAnnealingLR": {"T_max": 5, "eta_min": 1e-7}}
    js = jax_schedule(cfg, 1e-4, steps_per_epoch=3)
    ts = build_schedule(cfg, 1e-4, steps_per_epoch=3)
    for step in range(25):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   err_msg=str(step))
    assert ts(0) == pytest.approx(1e-4) and ts(15) == pytest.approx(1e-7)


# ---------------------------------------------------------------------------
# LightGlue training forward and gradients, with the random slot fill
# ---------------------------------------------------------------------------


def _feats(rng, B, N, D, H=32, W=48):
    pos = np.concatenate([rng.uniform(0, H, (B, N, 1)),
                          rng.uniform(0, W, (B, N, 1)),
                          rng.uniform(0, 1, (B, N, 1))], -1)
    desc = rng.normal(size=(B, N, D))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return {"sparse_positions": pos.astype(np.float32),
            "sparse_descriptors": desc.astype(np.float32),
            "sparse_valid": rng.uniform(size=(B, N)) > 0.3,
            "image_size": np.tile(np.float32([H, W]), (B, 1))}


def test_lightglue_training_matches_jax(rng):
    """The Matcher in training with pad_mode="random": JAX's output carries
    the filled slots (input_feats0/1), which the port is handed; every
    slot is then valid, so the JAX package's XLA training attention and
    the port's "pallas" setting compute the same function (at 24 slots and
    heads of 16, off the kernels' shape grid, both take the einsum path).
    Outputs, the loss and every parameter's gradient."""
    _training_parity(rng, dict(input_dim=32, descriptor_dim=64, n_layers=2,
                               num_heads=4), 24, 20, 24)


def test_lightglue_training_on_grid_matches_jax(rng, monkeypatch):
    """As above at 128 slots and heads of 64, on the kernels' shape grid:
    the port trains through kernels D/F (their plain versions here: four
    calls a layer), the JAX package through its XLA attention."""
    from ei_nexus_tpu_torch.models import lightglue as tlg
    calls, real = [], tlg.fused_attention

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(tlg, "fused_attention", counted)
    _training_parity(rng, dict(input_dim=32, descriptor_dim=128,
                               n_layers=2, num_heads=2), 128, 100, 128)
    assert len(calls) == 4 * 2


def _training_parity(rng, lg, slots, n0, n1):
    """The Matcher's training forward and backward, JAX against the port,
    with `slots` keypoint slots and n0, n1 valid keypoints."""
    jcfg = jeim.MatcherConfig(type="LightGlue", freeze=False,
                              max_points_num=slots,
                              lightglue=jeim.LightGlueConfig(**lg))
    tcfg = teim.MatcherConfig(type="LightGlue", freeze=False,
                              max_points_num=slots,
                              lightglue=teim.LightGlueConfig(
                                  attention_impl="pallas", **lg))
    f0, f1 = _feats(rng, 2, n0, 32), _feats(rng, 2, n1, 32)
    jf0 = {k: jnp.asarray(v) for k, v in f0.items()}
    jf1 = {k: jnp.asarray(v) for k, v in f1.items()}
    jm = jeim.Matcher(config=jcfg)
    keys = {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)}
    variables = _perturb(jm.init(keys, jf0, jf1, training=True))
    gt = {"matches0": rng.integers(-2, slots, (2, slots)).astype(np.int32),
          "matches1": rng.integers(-2, slots, (2, slots)).astype(np.int32),
          "assignment": rng.uniform(size=(2, slots, slots)) > 0.9}
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def jloss(params):
        out = jm.apply({"params": params}, jf0, jf1, training=True,
                       rngs={"pad": jax.random.PRNGKey(2)})
        return jax_loss(out, jgt)[0], out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])

    tm = teim.Matcher(tcfg, training_heads=True)
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    fill = tuple((_t(jout[f"input_feats{s}"]["sparse_positions"]),
                  _t(jout[f"input_feats{s}"]["sparse_descriptors"]))
                 for s in (0, 1))
    tout = tm({k: _t(v) for k, v in f0.items()},
              {k: _t(v) for k, v in f1.items()}, training=True, fill=fill)
    tl, _ = lightglue_loss(tout, {k: _t(v) for k, v in gt.items()})
    tl.backward()

    for s in (0, 1):
        for k in ("sparse_positions", "sparse_descriptors", "sparse_valid"):
            np.testing.assert_array_equal(
                tout[f"input_feats{s}"][k].numpy(),
                np.asarray(jout[f"input_feats{s}"][k]))
    assert tout["input_feats0"]["sparse_valid"].all()
    for k in ("all_log_assignments", "confidence_logits0",
              "confidence_logits1", "log_assignment"):
        assert tout[k].shape == jout[k].shape, k
        np.testing.assert_allclose(tout[k].detach().numpy(),
                                   np.asarray(jout[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = load_jax_variables({"params": jgrads})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        assert got[n] is not None, n
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=n)


def test_random_fill_follows_the_generator():
    """The fill draws from the generator it is given: one seed, one fill;
    positions lie in the image with a zero third column, descriptors are
    unit vectors times desc_scale_factor."""
    rng = np.random.default_rng(3)
    f = {k: _t(v) for k, v in _feats(rng, 2, 10, 8).items()}
    a = teim.random_fill(f, 16, 2.0, torch.Generator().manual_seed(7))
    b = teim.random_fill(f, 16, 2.0, torch.Generator().manual_seed(7))
    c = teim.random_fill(f, 16, 2.0, torch.Generator().manual_seed(8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    pos, desc = a
    assert pos.shape == (2, 16, 3) and desc.shape == (2, 16, 8)
    assert (pos[..., 2] == 0).all() and (pos[..., 0] < 32).all() \
        and (pos[..., 1] < 48).all() and (pos[..., :2] >= 0).all()
    np.testing.assert_allclose(desc.norm(dim=-1).numpy(), 2.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the whole stage-2 step
# ---------------------------------------------------------------------------


def test_stage2_step_matches_jax(monkeypatch):
    """`make_stage2_train_step` for 2 steps against the JAX step on the tiny
    flagship in float32, pad_mode="zeros" and attention_impl="xla" on both
    sides, the JAX voxel grid switched to its exact scatter (fast=False,
    the port's) through monkeypatch."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                    freeze_mask)
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.train.partition import frozen_roots_from_config
    from ei_nexus_tpu_torch.data.synth import stage2_batch
    from ei_nexus_tpu_torch.flagship import (STAGE2_OPTIMIZER, STAGE2_LR,
                                             STAGE2_SCHEDULER,
                                             stage2_config,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage2_train_step

    exact = jsteps.batch_representation
    monkeypatch.setattr(jsteps, "batch_representation",
                        lambda *a, **k: exact(*a, fast=False, **k))
    jm0, (H, W, bins) = _flagship(tiny=True)
    jc = jm0.config
    jcfg = dataclasses.replace(
        jc, event_extractor=dataclasses.replace(jc.event_extractor,
                                                freeze=True),
        matcher=dataclasses.replace(
            jc.matcher, pad_mode="zeros",
            lightglue=dataclasses.replace(jc.matcher.lightglue,
                                          attention_impl="xla")))
    jm = jeim.EIM(config=jcfg)
    # focal 61: a disparity of 1.525 px, so no keypoint pair on the
    # half-pixel grid sits exactly at the pos_th^2 = 9 or neg_th^2 = 25
    # boundary, where the rounding of a fused (jitted) distance decides
    batch = stage2_batch(np.random.default_rng(0), 2, 3000, 4096, H, W,
                         focal=61.0)
    rep, mask = exact(batch[0], "VoxelGrid", bins, H, W, fast=False)
    variables = _perturb(jm.init(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, batch[1]["image"], mask, None, True))
    tx = build_optimizer(STAGE2_OPTIMIZER,
                         jax_schedule(STAGE2_SCHEDULER, STAGE2_LR, 1))
    jstate = create_train_state(jm, variables, tx)
    jstep = jsteps.make_stage2_train_step(
        jm, freeze_mask(jstate.params, frozen_roots_from_config(jcfg)),
        "VoxelGrid", bins, H, W)

    tcfg, _ = stage2_config(tiny=True, dtype="float32", pad_mode="zeros")
    tcfg = dataclasses.replace(tcfg, matcher=dataclasses.replace(
        tcfg.matcher, lightglue=dataclasses.replace(
            tcfg.matcher.lightglue, attention_impl="xla")))
    model = teim.EIM(tcfg, training_heads=True)
    model.load_state_dict(load_jax_variables(variables), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = stage2_train_state(model)
    tstep = make_stage2_train_step("VoxelGrid", bins, H, W)

    for i in range(2):
        jstate, jinfo = jstep(jstate, batch, jax.random.PRNGKey(10 + i))
        tinfo = tstep(state, batch)
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
    moved = [k for k in start if k.startswith("matcher.lightglue.")
             and not torch.equal(start[k], model.state_dict()[k])]
    assert len(moved) > 0


def test_freeze_keeps_frozen_roots_out_of_training():
    """Stage 2 freezes both extractors: their parameters stop requiring
    grad and stay out of the optimizer, and `check_frozen` refuses a
    frozen parameter that is trainable or holds a gradient."""
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)
    from ei_nexus_tpu_torch.train.partition import check_frozen

    model, _ = build_stage2_flagship(tiny=True, dtype="float32",
                                     device="cpu")
    state = stage2_train_state(model)
    assert state.frozen_roots == {"event_extractor", "image_extractor"}
    names = {id(p): n for n, p in model.named_parameters()}
    assert {names[id(p)].split(".")[0] for p in state.trainable} \
        == {"matcher"}
    in_opt = {id(p) for g in state.optimizer.param_groups
              for p in g["params"]}
    assert in_opt == {id(p) for p in state.trainable}
    check_frozen(model, state.frozen_roots)
    frozen = next(model.event_extractor.parameters())
    frozen.grad = torch.zeros_like(frozen)
    with pytest.raises(RuntimeError, match="frozen parameter"):
        check_frozen(model, state.frozen_roots)
    frozen.grad = None
    frozen.requires_grad_(True)
    with pytest.raises(RuntimeError, match="frozen parameter"):
        check_frozen(model, state.frozen_roots)
