"""The port's stage-1 slice against the JAX package, on the CPU, in
float32: every extractor-loss mode, the loss factory, BatchNorm in
training mode (outputs and running statistics against flax's
`mutable=["batch_stats"]`), the extractors' stage-1 forward, keypoint
selection without gradients, and the whole stage-1 step for 2 steps.

Tolerances, each with its reason:
 - losses: rtol 1e-5, atol 1e-7 (float32 sums in another order);
 - BatchNorm training: outputs and running statistics atol 1e-5 (float32
   convolutions and reductions in another order); a layer at B*H*W = 48
   has an unbiased batch variance 48/47 of the biased one, which moves a
   running variance ~4 by ~8.5e-3, far outside it (the test also shows
   the unbiased update failing); the tiny event extractor's deepest
   layers sit at 2 * 4 * 6 = 48 too;
 - the stage-1 step: loss rtol 1e-5, each term rtol 1e-5 with atol 1e-7
   (the score term is ~3e-4, and the training-mode score maps of the two
   sides differ by ~5e-6, moving it by ~5e-8), grad_norm rtol 1e-4 at the
   first step and 1e-3 at the second (a ReLU input within float32 noise
   of zero, see the test); parameters atol
   4 * lr (Adam's first steps move a parameter by about lr whatever its
   gradient's size, so a near-zero gradient whose sign differs flips its
   step), running statistics atol 1e-5, frozen parameters bit-equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as fnn

from ei_nexus_tpu.losses import extractor_loss as jl
from ei_nexus_tpu.losses import matcher_loss as jml
from ei_nexus_tpu.losses.factory import build_losses as jax_build_losses
from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.models import extractor as jext
from ei_nexus_tpu_torch.losses import extractor_loss as tl
from ei_nexus_tpu_torch.losses import matcher_loss as tml
from ei_nexus_tpu_torch.losses.factory import build_losses
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models import extractor as text
from ei_nexus_tpu_torch.models.layers import BatchNorm
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables

LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
BN_TOL = dict(atol=1e-5, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(variables, seed=0):
    """Random biases, norm scales and BN statistics (numpy, seeded)."""
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
# the extractor losses, mode by mode
# ---------------------------------------------------------------------------

B, H, W, D = 2, 16, 24, 8


def _feats(rng):
    """A student's or teacher's dense maps at (B, H, W): the score and
    logits of a cell-8 extractor, the raw and coarse descriptors at full
    resolution as a cell-1 extractor gives them (the triplet leg of
    mae+triplet and desc_type raw or coarse take the full-resolution mask,
    which a cell-8 map cannot, on either side)."""
    score = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    score[rng.uniform(size=score.shape) < 0.3] = 0.0
    return {
        "score": score,
        "logits": rng.normal(size=(B, H // 8, W // 8, 65)).astype(np.float32),
        "normalized_descriptors": rng.normal(size=(B, H, W, D)).astype(
            np.float32),
        "raw_descriptors": rng.normal(size=(B, H, W, D)).astype(np.float32),
        "coarse_descriptors": rng.normal(size=(B, H, W, D)).astype(
            np.float32),
        "backbone_feats": rng.normal(size=(B, H // 8, W // 8, 16)).astype(
            np.float32),
    }


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    pred, gt = _feats(rng), _feats(rng)
    mask = rng.uniform(size=(B, H, W)) > 0.4
    return pred, gt, mask


def _torch(d):
    return {k: _t(v) for k, v in d.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _same(got, want):
    tloss, tinfo = got
    jloss, jinfo = want
    np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                   err_msg=k, **LOSS_TOL)


MASKED_CASES = (
    [("score", dict(mode=m)) for m in ("mse", "mae", "bce", "mse-whole")]
    + [("score", dict(mode="mse", use_mask=False, weight=2.0))]
    + [("logits", dict(cell_size=8, weight=0.5))]
    + [("descriptors", dict(mode=m)) for m in (
        "mse", "mae", "cosine_similarity", "dual-softmax", "triplet",
        "mae+triplet")]
    + [("descriptors", dict(mode="mae", desc_type="raw")),
       ("descriptors", dict(mode="mse", desc_type="coarse", weight=3.0)),
       ("descriptors", dict(mode="mae+triplet", mae_weight=0.5,
                            triplet_weight=10.0, triplet_margin=0.3))])
# the feature loss takes no mask
LOSS_CASES = ([c + (m,) for c in MASKED_CASES for m in (True, False)]
              + [("feature", dict(mode=m), False) for m in ("mse", "mae")])


def _case_id(case):
    kind, kwargs, masked = case
    return "-".join([kind] + [f"{k}={v}" for k, v in kwargs.items()]
                    + ["mask" if masked else "no-mask"])


@pytest.mark.parametrize("kind,kwargs,masked", LOSS_CASES,
                         ids=[_case_id(c) for c in LOSS_CASES])
def test_extractor_loss_matches_jax(kind, kwargs, masked):
    pred, gt, mask = _pair()
    fn = {"score": (tl.score_loss, jl.score_loss),
          "logits": (tl.logits_loss, jl.logits_loss),
          "descriptors": (tl.descriptors_loss, jl.descriptors_loss),
          "feature": (tl.feature_loss, jl.feature_loss)}[kind]
    args_t = (_torch(pred), _torch(gt))
    args_j = (_jax(pred), _jax(gt))
    if kind != "feature":
        args_t += (_t(mask) if masked else None,)
        args_j += (jnp.asarray(mask) if masked else None,)
    _same(fn[0](*args_t, **kwargs), fn[1](*args_j, **kwargs))


def test_masked_means_guard_an_empty_mask():
    """sum(x * m) / max(sum(m), 1): an all-False mask gives 0, not NaN."""
    pred, gt, mask = _pair()
    empty = np.zeros_like(mask)
    for fn_t, fn_j, kw in ((tl.score_loss, jl.score_loss, {}),
                           (tl.descriptors_loss, jl.descriptors_loss, {})):
        got = fn_t(_torch(pred), _torch(gt), _t(empty), **kw)
        want = fn_j(_jax(pred), _jax(gt), jnp.asarray(empty), **kw)
        assert float(got[0]) == 0.0
        _same(got, want)


def test_nll_matcher_loss_matches_jax(rng):
    N, M = 12, 10
    la = rng.normal(size=(B, N + 1, M + 1)).astype(np.float32)
    m0 = rng.integers(-2, M, (B, N))
    m1 = rng.integers(-2, N, (B, M))
    assign = rng.uniform(size=(B, N, M)) > 0.8
    for bal in (0.5, 1.0):
        got = tml.nll_matcher_loss(_t(la), _t(m0), _t(m1), _t(assign),
                                   weight=2.0, nll_balancing=bal)
        want = jml.nll_matcher_loss(jnp.asarray(la), jnp.asarray(m0),
                                    jnp.asarray(m1), jnp.asarray(assign),
                                    weight=2.0, nll_balancing=bal)
        _same(got, want)


def _stage1_loss_section():
    from ei_nexus_tpu.utils import load_config
    cfg = load_config("configs/train_EIM_stage1_EC_SP_MNN.yaml")
    return cfg.train.to_dict()["loss"]


FACTORY_VARIANTS = {
    "LogitsLoss": {"keypoints_loss": {"type": "LogitsLoss",
                                      "LogitsLoss": {"weight": 0.5}}},
    "mae+triplet": {"descriptors_loss": {
        "type": "DescriptorsLoss",
        "DescriptorsLoss": {"mode": "mae+triplet", "use_mask": True,
                            "mae+triplet": {"mae_weight": 2.0,
                                            "triplet_weight": 5.0}}}},
    "ScoreLoss-bce": {"keypoints_loss": {
        "type": "ScoreLoss", "ScoreLoss": {"mode": "bce",
                                           "use_mask": False}}},
    "FeatureLoss-mae": {"feature_loss": {
        "type": "FeatureLoss", "FeatureLoss": {"mode": "mae",
                                               "weight": 3.0}}},
    "MNNLoss": {"matcher_loss": {"type": "MNNLoss",
                                 "MNNLoss": {"weight": 2.0}}},
    "empty": {},
}


@pytest.mark.parametrize("variant", ["train_stage1.yaml"]
                         + list(FACTORY_VARIANTS))
def test_build_losses_matches_jax(variant):
    """`build_losses` on configs/train/train_stage1.yaml's `loss` section
    (ScoreLoss mse, DescriptorsLoss mae, FeatureLoss mse, NLLLoss with
    nll_balancing 1.0) and on each other type and option it reads; a loss
    the config does not name is the (0, {}) pass-through."""
    cfg = _stage1_loss_section() if variant == "train_stage1.yaml" \
        else FACTORY_VARIANTS[variant]
    tls, jls = build_losses(cfg), jax_build_losses(cfg)
    assert set(tls) == set(jls)
    pred, gt, mask = _pair(1)
    for name in ("keypoints_loss", "descriptors_loss"):
        _same(tls[name](_torch(pred), _torch(gt), _t(mask)),
              jls[name](_jax(pred), _jax(gt), jnp.asarray(mask)))
    _same(tls["feature_loss"](_torch(pred), _torch(gt)),
          jls["feature_loss"](_jax(pred), _jax(gt)))
    rng = np.random.default_rng(2)
    N, M = 12, 10
    if cfg.get("matcher_loss", {}).get("type") == "MNNLoss":
        sim = rng.uniform(-1, 1, (B, N, M)).astype(np.float32)
        assign = rng.uniform(size=(B, N, M)) > 0.8
        _same(tls["matcher_loss"]({"similarity": _t(sim)},
                                  {"assignment": _t(assign)}),
              jls["matcher_loss"]({"similarity": jnp.asarray(sim)},
                                  {"assignment": jnp.asarray(assign)}))
    else:
        la = rng.normal(size=(B, N + 1, M + 1)).astype(np.float32)
        m0 = rng.integers(-2, M, (B, N))
        m1 = rng.integers(-2, N, (B, M))
        assign = rng.uniform(size=(B, N, M)) > 0.8
        _same(tls["matcher_loss"](_t(la), _t(m0), _t(m1), _t(assign)),
              jls["matcher_loss"](jnp.asarray(la), jnp.asarray(m0),
                                  jnp.asarray(m1), jnp.asarray(assign)))
    if variant == "empty":
        loss, info = tls["feature_loss"](_torch(pred), _torch(gt))
        assert float(loss) == 0.0 and info == {}


# ---------------------------------------------------------------------------
# BatchNorm in training mode
# ---------------------------------------------------------------------------


def _bn_input(seed=0, shape=(3, 4, 4, 4)):
    """NCHW input with B*H*W = 48, mean ~1.5 and variance ~4."""
    rng = np.random.default_rng(seed)
    return (1.5 + 2.0 * rng.normal(size=shape)).astype(np.float32)


def test_batchnorm_training_matches_flax():
    """At B*H*W = 48: the output and the running statistics equal flax's;
    torch's F.batch_norm(training=True), whose running variance is the
    unbiased one, fails the same check."""
    x = _bn_input()
    C = x.shape[1]
    fbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))          # NHWC
    rng = np.random.default_rng(1)
    variables = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, C),
                                                 jnp.float32),
                            "bias": jnp.asarray(rng.normal(0, 0.1, C),
                                                jnp.float32)},
                 "batch_stats": {"mean": jnp.asarray(rng.normal(0, 0.1, C),
                                                     jnp.float32),
                                 "var": jnp.asarray(rng.uniform(0.5, 1.5, C),
                                                    jnp.float32)}}
    want, mutated = fbn.apply(variables, xj, use_running_average=False,
                              mutable=["batch_stats"])
    bn = BatchNorm(C)
    bn.load_state_dict(load_jax_variables(variables), strict=True)
    start = {k: v.clone() for k, v in bn.state_dict().items()}
    bn.train()
    got = bn(_t(x))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **BN_TOL)
    new = load_jax_variables(mutated)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(bn.state_dict()[k].numpy(),
                                   new[k].numpy(), err_msg=k, **BN_TOL)
    # the unbiased update misses flax's running variance by far more
    rv = start["running_var"].clone()
    torch.nn.functional.batch_norm(_t(x), start["running_mean"].clone(), rv,
                                   training=True, momentum=0.1, eps=1e-5)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(rv.numpy(), new["running_var"].numpy(),
                                   **BN_TOL)
    # eval(): the running statistics normalise and stay as they are
    bn.eval()
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with torch.no_grad():
        y = bn(_t(x))
    want_eval = fbn.apply({"params": variables["params"],
                           "batch_stats": mutated["batch_stats"]}, xj,
                          use_running_average=True)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_eval), **BN_TOL)
    assert all(torch.equal(before[k], v) for k, v in bn.state_dict().items())


def test_batchnorm_training_in_bfloat16_reduces_in_float32():
    """A bfloat16 input: statistics from its float32 values, the output
    cast back to bfloat16 (flax's float32 reductions)."""
    x = _t(_bn_input(3))
    bn = BatchNorm(x.shape[1]).train()
    ref = BatchNorm(x.shape[1]).train()
    y = bn(x.to(torch.bfloat16))
    want = ref(x.to(torch.bfloat16).float())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, want.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, ref.running_var, rtol=0,
                               atol=0)


def _tiny_vgg(rng, feat=16):
    """The tiny event extractor (B=2 at 32x48: its deepest BatchNorm
    layers normalise over 2*4*6 = 48 values) on both sides."""
    Bx, Hx, Wx, bins = 2, 32, 48, 4
    x = rng.normal(size=(Bx, Hx, Wx, bins)).astype(np.float32)
    mask = rng.uniform(size=(Bx, Hx, Wx)) > 0.4
    kcfg = jext.KeypointExtractorConfig(detection_top_k=32)
    jm = jext.VGGExtractor(config=kcfg, feat_channels=feat,
                           descriptor_dim=32, lat_channels=32)
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x), jnp.asarray(mask)))
    tm = text.VGGExtractor(text.KeypointExtractorConfig(detection_top_k=32),
                           in_channels=bins, feat_channels=feat,
                           descriptor_dim=32, lat_channels=32)
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    return jm, variables, tm, x, mask


DENSE_KEYS = ("image_size", "backbone_feats", "logits", "raw_descriptors",
              "probability", "score", "coarse_descriptors",
              "normalized_descriptors")


def test_event_extractor_training_matches_flax(rng):
    """The event extractor in train(): its stage-1 maps and its updated
    running statistics against flax's train=True with
    mutable=["batch_stats"], in float32. The running statistics agree to
    atol 1e-5; the maps to atol 1e-4, since through 12 batch-normalised
    layers at 48 values a channel float32 alone moves them: both sides
    were measured up to 1.5e-5 (the port) and 4.6e-5 (flax) from the
    port's float64 maps. The float64 test below holds the layers to
    1e-5."""
    jm, variables, tm, x, mask = _tiny_vgg(rng)
    want, mutated = jax.jit(lambda v, a, m: jm.apply(
        v, a, m, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), jnp.asarray(mask))
    tm.train()
    got = tm.dense_maps(_t(x), _t(mask))
    assert set(got) == set(DENSE_KEYS)
    for k in DENSE_KEYS:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k,
                                   atol=1e-4, rtol=0)
    new = load_jax_variables(mutated)
    state = tm.state_dict()
    assert len(new) == 2 * 12   # 12 BatchNorm layers, mean and var
    for k in new:
        np.testing.assert_allclose(state[k].numpy(), new[k].numpy(),
                                   err_msg=k, **BN_TOL)
    # the running statistics moved
    old = load_jax_variables({"batch_stats": variables["batch_stats"]})
    assert all(not torch.equal(old[k], state[k]) for k in new)


def test_event_backbone_training_matches_flax_in_float64(rng):
    """The event extractor's backbone and heads in train(), float64 on
    both sides (flax under jax.enable_x64): outputs and running statistics
    to atol 1e-5, where an unbiased running variance would miss by ~1e-3
    in the deepest layers (2 * 4 * 6 = 48 values a channel)."""
    from ei_nexus_tpu.models import vgg as jvgg
    from ei_nexus_tpu_torch.models import vgg as tvgg

    x = rng.normal(size=(2, 32, 48, 4))
    with jax.enable_x64(True):
        f64 = jnp.float64
        mods = (jvgg.VGGBackbone(feat_channels=16, dtype=f64),
                jvgg.VGGDetectorHead(lat_channels=32, out_channels=65,
                                     dtype=f64),
                jvgg.VGGDescriptorHead(out_channels=32, dtype=f64))
        outs, stats, params = [], [], []
        inp = jnp.asarray(x)
        for i, m in enumerate(mods):
            v = _perturb(jax.jit(m.init)(jax.random.PRNGKey(i), inp),
                         seed=i)
            v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f64), v)
            y, mut = jax.jit(lambda v, a, m=m: m.apply(
                v, a, train=True, mutable=["batch_stats"]))(v, inp)
            outs.append(np.asarray(y))
            stats.append(load_jax_variables(mut))
            params.append(v)
            if i == 0:
                inp = y
    t64 = torch.float64
    tmods = (tvgg.VGGBackbone(4, 16, dtype=t64),
             tvgg.VGGDetectorHead(16, 32, 65, dtype=t64),
             tvgg.VGGDescriptorHead(16, 32, dtype=t64))
    inp = _t(x).permute(0, 3, 1, 2)
    for i, (m, v) in enumerate(zip(tmods, params)):
        m.double().load_state_dict(
            {k: t.double() for k, t in load_jax_variables(v).items()},
            strict=True)
        m.train()
        y = m(inp)
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                                   outs[i], err_msg=str(i), **BN_TOL)
        sd = m.state_dict()
        for k, want in stats[i].items():
            np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                       err_msg=f"{i} {k}", **BN_TOL)
        if i == 0:
            inp = y


# ---------------------------------------------------------------------------
# keypoint selection carries no gradient; the stage-1 forward runs none
# ---------------------------------------------------------------------------


def test_keypoint_selection_carries_no_gradient(rng, monkeypatch):
    """An extractor in training mode with grad enabled: the NMS reads a
    detached map, and its output, the positions and the `nms` map carry no
    grad_fn, while the score and the descriptors do."""
    from ei_nexus_tpu_torch.models.layers import init_parameters
    tm = text.VGGExtractor(text.KeypointExtractorConfig(detection_top_k=32),
                           in_channels=4, feat_channels=16,
                           descriptor_dim=32, lat_channels=32)
    init_parameters(tm, torch.Generator().manual_seed(0))
    x = rng.normal(size=(2, 32, 48, 4)).astype(np.float32)
    mask = rng.uniform(size=(2, 32, 48)) > 0.4
    seen = []
    real = text.nms

    def spy(score, *a, **k):
        out = real(score, *a, **k)
        seen.append((score, out))
        return out
    monkeypatch.setattr(text, "nms", spy)
    tm.train()
    with torch.enable_grad():
        out = tm(_t(x), _t(mask))
    (score_in, nms_map), = seen
    assert not score_in.requires_grad and nms_map.grad_fn is None
    assert out["sparse_positions"].grad_fn is None
    assert out["nms"].grad_fn is None
    assert out["score"].grad_fn is not None
    assert out["sparse_descriptors"].grad_fn is not None


def _stage1_models(feat_channels=None, dtype="float32"):
    """The tiny stage-1 flagship on both sides (event extractor trainable,
    SuperPoint and MNN frozen), with `feat_channels` for the event
    backbone when FeatureLoss must meet SuperPoint's 128."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu_torch.flagship import stage1_config

    jm0, shape = _flagship(tiny=True)
    jc = jm0.config
    tcfg, _ = stage1_config(tiny=True, dtype=dtype)
    ev_j = dataclasses.replace(jc.event_extractor, freeze=False)
    ev_t = tcfg.event_extractor
    if feat_channels:
        ev_j = dataclasses.replace(ev_j, feat_channels=feat_channels,
                                   lat_channels=2 * feat_channels)
        ev_t = dataclasses.replace(ev_t, feat_channels=feat_channels,
                                   lat_channels=2 * feat_channels)
    jcfg = dataclasses.replace(
        jc, event_extractor=ev_j,
        matcher=jeim.MatcherConfig(type="MNN", freeze=True,
                                   max_points_num=jc.matcher.max_points_num))
    tcfg = dataclasses.replace(tcfg, event_extractor=ev_t)
    return jeim.EIM(config=jcfg), teim.EIM(tcfg), shape


def _stage1_batch(H, W, seed=0):
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    rng = np.random.default_rng(seed)
    view = bursty_event_batch(rng, 2, 3000, 4096, H, W)
    view["image"] = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    return (view,)


def test_eim_stage1_forward_returns_dense_maps(monkeypatch):
    """EIM.forward(training=True) with a trainable event extractor: both
    extractors' dense maps (the event side in train() with gradients, the
    frozen SuperPoint in eval() without), no matches, and no NMS, top-k or
    matcher call; a later inference forward puts both back in eval()."""
    from ei_nexus_tpu_torch.models.layers import init_parameters
    from ei_nexus_tpu_torch.train.steps import batch_representation

    _, model, (Hh, Ww, bins) = _stage1_models()
    init_parameters(model, torch.Generator().manual_seed(0))
    batch = _stage1_batch(Hh, Ww)
    rep, mask = batch_representation(batch[0], "VoxelGrid", bins, Hh, Ww,
                                     device="cpu")
    calls = []
    for name in ("nms", "select_topk_keypoints"):
        real = getattr(text, name)
        monkeypatch.setattr(text, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(model.matcher, "forward",
                        lambda *a, **k: calls.append("matcher"))
    ev, im, matches = model(rep, _t(batch[0]["image"]), mask, training=True)
    assert matches is None and calls == []
    assert set(ev) == set(DENSE_KEYS) and set(im) == set(DENSE_KEYS)
    assert model.event_extractor.training
    assert not model.image_extractor.training
    assert ev["score"].requires_grad and not im["score"].requires_grad
    model(rep, _t(batch[0]["image"]), mask)
    assert not model.event_extractor.training
    assert calls.count("nms") == 2 and calls.count("matcher") == 1


def test_image_image_matcher_trains_its_extractor():
    """ImageImageMatcher with a trainable SuperPoint: both frames' dense
    maps from the shared extractor, with gradients, and no matches; the
    maps equal the JAX module's."""
    from ei_nexus_tpu_torch.flagship import flagship_config

    cfg, (Hh, Ww, _) = flagship_config(tiny=True, dtype="float32")
    cfg = dataclasses.replace(
        cfg, image_extractor=dataclasses.replace(cfg.image_extractor,
                                                 freeze=False),
        matcher=teim.MatcherConfig(type="MNN"))
    from __graft_entry__ import _flagship
    jc = _flagship(tiny=True)[0].config
    jcfg = dataclasses.replace(
        jc, image_extractor=dataclasses.replace(jc.image_extractor,
                                                freeze=False),
        matcher=jeim.MatcherConfig(type="MNN"))
    rng = np.random.default_rng(4)
    im0, im1 = (rng.uniform(0, 255, (2, Hh, Ww, 1)).astype(np.float32)
                for _ in range(2))
    jm = jeim.ImageImageMatcher(config=jcfg)
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), im0, im1))
    jf0, jf1, _ = jax.jit(lambda v, a, b: jm.apply(v, a, b, training=True))(
        variables, im0, im1)
    tm = teim.ImageImageMatcher(cfg)
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    f0, f1, matches = tm(_t(im0), _t(im1), training=True)
    assert matches is None and tm.image_extractor.training
    for got, want in ((f0, jf0), (f1, jf1)):
        assert got["score"].requires_grad
        for k in DENSE_KEYS:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), err_msg=k,
                                       atol=1e-4, rtol=1e-4)


def test_build_model_refuses_the_cell1_extractors():
    """`build_model` builds the cell-1 extractors on the CPU: the tiny
    flagship with its event extractor made "vgg_np" and its image
    extractor "silk" (both 128-d, the MNN matcher), in train() as stage 1
    runs them; the dense maps and, at inference, the keypoints and matches
    equal the JAX model's."""
    from __graft_entry__ import _flagship
    from ei_nexus_tpu_torch.flagship import flagship_config
    from ei_nexus_tpu_torch.models.silk import SiLKVGG

    def cell1(cfg, module):
        return dataclasses.replace(
            cfg,
            event_extractor=dataclasses.replace(
                cfg.event_extractor, type="vgg_np", descriptor_dim=128,
                freeze=False),
            image_extractor=dataclasses.replace(cfg.image_extractor,
                                                type="silk"),
            matcher=module.MatcherConfig(type="MNN", freeze=True,
                                         max_points_num=32))

    cfg, (Hh, Ww, bins) = flagship_config(tiny=True, dtype="float32")
    tm = teim.build_model("EIM", cell1(cfg, teim), device="cpu")
    assert isinstance(tm.event_extractor, text.VGGExtractor)
    assert tm.event_extractor.cell == 1
    assert isinstance(tm.image_extractor, SiLKVGG)
    jm = jeim.build_model("EIM", cell1(_flagship(tiny=True)[0].config, jeim))
    batch = _stage1_batch(Hh, Ww)
    from ei_nexus_tpu_torch.train.steps import batch_representation
    rep, mask = batch_representation(batch[0], "VoxelGrid", bins, Hh, Ww,
                                     device="cpu")
    image = batch[0]["image"]
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          rep.numpy(), image, mask.numpy()))
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    (je, ji, _), _ = jax.jit(lambda v, r, i, m: jm.apply(
        v, r, i, m, None, True, mutable=["batch_stats"]))(
            variables, rep.numpy(), image, mask.numpy())
    te, ti, matches = tm(rep, _t(image), mask, training=True)
    assert matches is None
    for got, want in ((te, je), (ti, ji)):
        for k in DENSE_KEYS:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), err_msg=k,
                                       atol=1e-4, rtol=1e-4)
    je, ji, jmatch = jax.jit(jm.apply)(variables, rep.numpy(), image,
                                       mask.numpy())
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    with torch.no_grad():
        te, ti, tmatch = tm(rep, _t(image), mask)
    for got, want in ((te, je), (ti, ji)):
        np.testing.assert_array_equal(got["sparse_positions"][..., :2],
                                      np.asarray(want["sparse_positions"])
                                      [..., :2])
        np.testing.assert_array_equal(got["sparse_valid"],
                                      np.asarray(want["sparse_valid"]))
    np.testing.assert_array_equal(tmatch["matches0"],
                                  np.asarray(jmatch["matches0"]))


# ---------------------------------------------------------------------------
# the stage-1 step against the JAX step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_feature", [False, True],
                         ids=["score+descriptors", "with-feature-loss"])
def test_stage1_step_matches_jax(monkeypatch, with_feature):
    """`make_stage1_train_step` for 2 steps against the JAX step on the
    tiny stage-1 flagship in float32 (the JAX voxel grid pinned to its
    exact scatter, fast=False, the port's). FeatureLoss needs the event
    backbone at SuperPoint's width: its case runs feat_channels=128.

    The second step starts from the JAX state's parameters: BatchNorm
    leaves some weights with a gradient that is 0 in exact arithmetic, and
    Adam's first step moves each weight by about lr whatever the size of
    its gradient, so the few whose float32 noise takes opposite signs on
    the two sides (34 of 1.6M here) end 2 lr apart, and the next step's
    grad_norm moves by ~2% with them; from the same parameters it agrees
    to ~6e-5. The second step's grad_norm is held to rtol 1e-3, the
    first's to 1e-4: after one update a ReLU input can sit within the
    float32 noise of the two convolutions (~5e-6) of zero, and then its
    side decides whether the gradient passes; in the FeatureLoss case one
    of the detector head's 12288 inputs sits at 3.7e-6 (float64), the
    port's float32 puts it at -1.3e-6, and grad_norm moves by 4.8e-4 (the
    port's float64 gradient agrees with the JAX one to 2e-6)."""
    from ei_nexus_tpu.train import (build_optimizer, create_train_state,
                                    freeze_mask)
    from ei_nexus_tpu.train import steps as jsteps
    from ei_nexus_tpu.train.optim import build_schedule as jax_schedule
    from ei_nexus_tpu.train.partition import frozen_roots_from_config
    from ei_nexus_tpu_torch.flagship import (STAGE1_LOSSES, STAGE1_LR,
                                             STAGE1_OPTIMIZER,
                                             STAGE1_SCHEDULER,
                                             stage1_train_state)
    from ei_nexus_tpu_torch.train.steps import make_stage1_train_step

    exact = jsteps.batch_representation
    monkeypatch.setattr(jsteps, "batch_representation",
                        lambda *a, **k: exact(*a, fast=False, **k))
    jm, model, (Hh, Ww, bins) = _stage1_models(128 if with_feature else None)
    loss_cfg = dict(STAGE1_LOSSES)
    if not with_feature:
        del loss_cfg["feature_loss"]
    batch = _stage1_batch(Hh, Ww)
    rep, mask = exact(batch[0], "VoxelGrid", bins, Hh, Ww, fast=False)
    variables = _perturb(jax.jit(jm.init, static_argnums=(5,))(
        {"params": jax.random.PRNGKey(0), "pad": jax.random.PRNGKey(1)},
        rep, batch[0]["image"], mask, None, True))
    tx = build_optimizer(STAGE1_OPTIMIZER,
                         jax_schedule(STAGE1_SCHEDULER, STAGE1_LR, 1))
    jstate = create_train_state(jm, variables, tx)
    jstep = jsteps.make_stage1_train_step(
        jm, jax_build_losses(loss_cfg),
        freeze_mask(jstate.params, frozen_roots_from_config(jm.config)),
        "VoxelGrid", bins, Hh, Ww)

    model.load_state_dict(load_jax_variables(variables), strict=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = stage1_train_state(model)
    tstep = make_stage1_train_step(build_losses(loss_cfg), "VoxelGrid",
                                   bins, Hh, Ww)
    for i in range(2):
        jstate, jinfo = jstep(jstate, batch, jax.random.PRNGKey(10 + i))
        tinfo = tstep(state, batch)
        assert set(tinfo) == set(jinfo)
        assert ("feature_loss" in tinfo) == with_feature
        np.testing.assert_allclose(float(tinfo["loss"]),
                                   float(jinfo["loss"]), rtol=1e-5)
        for k in tinfo:
            if k.startswith(("extractor_", "feature")):
                np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                           rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]),
                                   rtol=1e-4 if i == 0 else 1e-3)
        assert float(tinfo["dropped_splat_weight"]) == 0.0
        want = load_jax_variables({"params": jstate.params,
                                   "batch_stats": jstate.batch_stats})
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            if k.startswith("event_extractor."):
                tol = (BN_TOL if k.endswith(("running_mean", "running_var"))
                       else dict(atol=4 * STAGE1_LR, rtol=0))
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           err_msg=k, **tol)
            else:   # frozen: bit-equal to the JAX state and to the start
                assert torch.equal(got[k], want[k]), k
                assert torch.equal(got[k], start[k]), k
        moved = [k for k in start if k.startswith("event_extractor.")
                 and not torch.equal(start[k], got[k])]
        assert len(moved) == sum(k.startswith("event_extractor.")
                                 for k in start)
        # the next step starts from the JAX state's parameters and
        # statistics (the optimizer keeps its own moments)
        with torch.no_grad():
            for k, v in got.items():
                v.copy_(want[k])
    assert state.step == 2
