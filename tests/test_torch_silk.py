"""The port's SiLK family against the JAX package, on the CPU, in float32:
the coordinate maps, the full-resolution descriptor gather, the cell-1
event extractor (`vgg_np`) and SiLK at padding 1 and 0, the SiLK weight
loader, the EIM and ImageImageMatcher of every SiLK model config at tiny
sizes, and the Flow engine.

Every module is initialised in JAX, its normalisation statistics and
biases perturbed (flax initialises them to identities), then loaded into
the port with `strict=True`. Tolerances: keypoint positions, validity and
matches exact (the same maps and the same tie-breaking); every map atol
1e-4 with rtol 1e-4 (float32 convolutions summing in another order
through ten layers at full resolution; observed differences ~1e-6).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.models import eim as jeim
from ei_nexus_tpu.models import extractor as jext
from ei_nexus_tpu.models import silk as jsilk
from ei_nexus_tpu.models.config_adapter import (
    eim_config_from_dict as jax_config_from_dict)
from ei_nexus_tpu.ops import coords as jcoords
from ei_nexus_tpu.ops import descriptor as jdesc
from ei_nexus_tpu_torch.flagship import (SILK_CONFIGS, silk_config,
                                         silk_model_dict)
from ei_nexus_tpu_torch.models import eim as teim
from ei_nexus_tpu_torch.models import extractor as text
from ei_nexus_tpu_torch.models import silk as tsilk
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.ops import coords as tcoords
from ei_nexus_tpu_torch.ops import descriptor as tdesc

TOL = dict(atol=1e-4, rtol=1e-4)


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


def _compare_feats(got, want, keys=None):
    for k in keys or want:
        a, b = got[k].detach().numpy(), np.asarray(want[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k == "sparse_positions":   # (y, x) exact, the score close
            np.testing.assert_array_equal(a[..., :2], b[..., :2], err_msg=k)
            np.testing.assert_allclose(a[..., 2], b[..., 2], err_msg=k, **TOL)
        elif a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# coordinate maps and the full-resolution gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("conv2d_mapping", (3,)), ("conv2d_mapping", (3, 2, 1)),
    ("conv2d_mapping", (1,)), ("pool2d_mapping", (2,)),
    ("pool2d_mapping", (3, 2)), ("vgg_np_padding0_mapping", ()),
    ("vgg_cell8_mapping", ()), ("vgg_cell8_mapping", (0,))])
def test_coordinate_maps_match_jax(name, args):
    got = getattr(tcoords, name)(*args)
    want = getattr(jcoords, name)(*args)
    assert (got.scale, got.offset) == (want.scale, want.offset)
    for v in (0.5, 3.5, 100.25):
        assert got.to_image(v) == want.to_image(v)
        assert got.to_feature(v) == want.to_feature(v)


def test_coordinate_maps_give_the_remaps():
    """padding 0: scale 1, +9 px (the cell-1 remap); cell 8: 8, 3.5."""
    m = tcoords.vgg_np_padding0_mapping()
    assert (m.scale, m.offset) == (1.0, 9.0)
    m = tcoords.vgg_cell8_mapping()
    assert (m.scale, m.offset) == (8.0, 3.5)
    layers = [tcoords.conv2d_mapping(3, 2, 1), tcoords.pool2d_mapping(2),
              tcoords.conv2d_mapping(5)]
    got = tcoords.stack_mapping(layers)
    want = jcoords.stack_mapping([jcoords.conv2d_mapping(3, 2, 1),
                                  jcoords.pool2d_mapping(2),
                                  jcoords.conv2d_mapping(5)])
    assert (got.scale, got.offset) == (want.scale, want.offset)
    a, b = tcoords.conv2d_mapping(3, 2), tcoords.pool2d_mapping(2)
    ja, jb = jcoords.conv2d_mapping(3, 2), jcoords.pool2d_mapping(2)
    assert a.compose(b) == tcoords.CoordinateMapping(
        **dataclasses.asdict(ja.compose(jb)))


@pytest.mark.parametrize("ordering", ["yx", "xy"])
@pytest.mark.parametrize("scale,normalize", [(1.0, True), (1.41, True),
                                             (2.0, False)])
def test_sample_descriptors_fullres_matches_jax(rng, ordering, scale,
                                                normalize):
    """The floor gather, positions inside, on and beyond the map's edges
    (clipped)."""
    raw = rng.normal(size=(2, 12, 20, 8)).astype(np.float32)
    pos = np.concatenate([rng.uniform(-3, 23, (2, 40, 2)),
                          rng.uniform(0, 1, (2, 40, 1))], -1)
    pos[:, :4, :2] = [[0.0, 0.0], [11.999, 19.5], [12.0, 20.0], [-0.5, 5]]
    pos = pos.astype(np.float32)
    want = jdesc.sample_descriptors_fullres(jnp.asarray(raw),
                                            jnp.asarray(pos), scale,
                                            normalize, ordering)
    got = tdesc.sample_descriptors_fullres(_t(raw), _t(pos), scale,
                                           normalize, ordering)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the cell-1 extractors
# ---------------------------------------------------------------------------


def _np_config(padding, **kw):
    return dict(cell_size=1, sparse_desc_from="fullres", detection_top_k=32,
                coord_offset=9.0 if padding == 0 else 0.0, **kw)


@pytest.mark.parametrize("padding,masked,hw", [
    (1, True, (32, 48)), (1, False, (32, 48)), (0, False, (40, 56))],
    ids=["padding1-mask", "padding1", "padding0"])
def test_vgg_np_extractor_matches_jax(rng, padding, masked, hw):
    """The cell-1 event extractor, every output key (the port's dense
    maps included): at padding 0 every map is 18 px smaller and positions
    carry the +9 px remap."""
    B, (H, W), bins = 2, hw, 4
    x = rng.normal(size=(B, H, W, bins)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.4
    conv = "VALID" if padding == 0 else "SAME"
    jm = jext.VGGExtractor(
        config=jext.KeypointExtractorConfig(**_np_config(padding)),
        feat_channels=16, descriptor_dim=32, lat_channels=32,
        use_max_pooling=False, conv_padding=conv)
    jmask = jnp.asarray(mask) if masked else None
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                          jnp.asarray(x), jmask))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x), jmask)
    tm = text.VGGExtractor(
        text.KeypointExtractorConfig(**_np_config(padding)),
        in_channels=bins, feat_channels=16, descriptor_dim=32,
        lat_channels=32, use_max_pooling=False, conv_padding=conv)
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(_t(x), _t(mask) if masked else None, dense=True)
    assert set(got) == set(want)
    assert got["score"].shape == (B, H - 18 * (1 - padding),
                                  W - 18 * (1 - padding))
    _compare_feats(got, want)
    assert got["sparse_valid"].any()
    if padding == 0:
        assert (got["sparse_positions"][..., :2] >= 9.5).all()
        with pytest.raises(AssertionError, match="VALID"):
            jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
        with pytest.raises(ValueError, match="VALID"):
            tm(_t(x), _t(mask))
        with pytest.raises(ValueError, match="VALID"):
            tm.dense_maps(_t(x), _t(mask))


def _silk_config(module, padding):
    return module.KeypointExtractorConfig(
        cell_size=1, descriptor_scale_factor=1.41, sparse_desc_from="fullres",
        detection_top_k=24, smooth_mask=False,
        coord_offset=9.0 if padding == 0 else 0.0)


@pytest.mark.parametrize("padding,masked", [(1, False), (1, True),
                                            (0, False)],
                         ids=["padding1", "padding1-mask", "padding0"])
def test_silk_matches_jax(rng, padding, masked):
    B, H, W = 2, 30, 44
    image = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) > 0.3
    conv = "VALID" if padding == 0 else "SAME"
    jm = jsilk.SiLKVGG(config=_silk_config(jext, padding), conv_padding=conv)
    jmask = jnp.asarray(mask) if masked else None
    variables = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(2),
                                          jnp.asarray(image), jmask))
    want = jax.jit(jm.apply)(variables, jnp.asarray(image), jmask)
    tm = tsilk.SiLKVGG(_silk_config(text, padding), conv_padding=conv)
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(_t(image), _t(mask) if masked else None, dense=True)
    assert set(got) == set(want)
    _compare_feats(got, want)
    assert got["sparse_valid"].any()
    assert got["sparse_descriptors"].shape == (B, 24, 128)


def _reference_silk_state_dict(seed, nested):
    """A SiLK checkpoint's state dict in the reference's layout, seeded:
    `_mods.model.backbone._backbone.layers...` and
    `backbone._heads._mods.{logits,raw_descriptors}...` (nested), or the
    flat ParametricVGG names with a `model.` prefix."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = torch.as_tensor(rng.normal(
            0, (cin * k * k) ** -0.5, (cout, cin, k, k)).astype(np.float32))
        sd[key + ".bias"] = torch.as_tensor(
            rng.normal(0, 0.1, cout).astype(np.float32))

    def bn(key, c):
        sd[key + ".weight"] = torch.as_tensor(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[key + ".bias"] = torch.as_tensor(
            rng.normal(0, 0.1, c).astype(np.float32))
        sd[key + ".running_mean"] = torch.as_tensor(
            rng.normal(0, 0.1, c).astype(np.float32))
        sd[key + ".running_var"] = torch.as_tensor(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[key + ".num_batches_tracked"] = torch.tensor(1000)

    pre = "_mods.model." if nested else "model."
    bb = pre + ("backbone._backbone.layers" if nested else "backbone.layers")
    cin = 1
    for s, width in enumerate((64, 64, 128, 128)):
        for c in range(2):
            conv(f"{bb}.{s}.{c}.0", width, cin, 3)
            bn(f"{bb}.{s}.{c}.2", width)
            cin = width
    for head, tag, out in (("logits", "det", 1),
                           ("raw_descriptors", "des", 128)):
        root = pre + (f"backbone._heads._mods.{head}." if nested else
                      ("detector_head." if tag == "det"
                       else "descriptor_head."))
        conv(f"{root}_{tag}H1.0", 128, 128, 3)
        bn(f"{root}_{tag}H1.2", 128)
        conv(f"{root}_{tag}H2.0", out, 128, 1)
        bn(f"{root}_{tag}H2.1", out)
    return sd


@pytest.mark.parametrize("nested", [True, False], ids=["nested", "flat"])
def test_load_silk_state_dict_matches_jax(rng, nested):
    """One synthetic reference-layout checkpoint through both loaders: the
    forwards are equal."""
    sd = _reference_silk_state_dict(5, nested)
    image = rng.uniform(0, 255, (2, 24, 32, 1)).astype(np.float32)
    jm = jsilk.SiLKVGG(config=_silk_config(jext, 1))
    want = jax.jit(jm.apply)(jsilk.load_silk_torch_weights(sd),
                             jnp.asarray(image))
    tm = tsilk.SiLKVGG(_silk_config(text, 1))
    tm.load_state_dict(tsilk.load_silk_state_dict(sd), strict=True)
    tm.eval()
    with torch.no_grad():
        got = tm(_t(image), dense=True)
    _compare_feats(got, want)
    # the weights arrive as they were: conv layouts are torch on both sides
    assert torch.equal(tm.backbone.l2_1.conv.weight,
                       next(v for k, v in sd.items()
                            if k.endswith("layers.1.1.0.weight")))


# ---------------------------------------------------------------------------
# the model configs
# ---------------------------------------------------------------------------


def _jax_model(name, model_dict):
    jcfg = jax_config_from_dict(model_dict)
    return jeim.build_model(SILK_CONFIGS[name][1], jcfg), jcfg


@pytest.mark.parametrize("name", sorted(SILK_CONFIGS))
def test_silk_config_matches_the_jax_adapter(name):
    """Each SiLK model config, full size and tiny, through both adapters
    and `_build_extractor`: the same extractor types, keypoint settings,
    padding, remap and matcher; the port builds it on the CPU."""
    for tiny in (False, True):
        model_dict, shape = silk_model_dict(tiny, "float32", name)
        cfg, _ = silk_config(tiny, "float32", name)
        jcfg = jax_config_from_dict(model_dict)
        for side in ("event_extractor", "image_extractor"):
            a, b = getattr(cfg, side), getattr(jcfg, side)
            assert (a.type, a.freeze, a.padding, a.feat_channels,
                    a.descriptor_dim, a.lat_channels) == (
                        b.type, b.freeze, b.padding, b.feat_channels,
                        b.descriptor_dim, b.lat_channels)
            assert dataclasses.asdict(a.keypoints) == dataclasses.asdict(
                b.keypoints)
        assert cfg.matcher.type == jcfg.matcher.type
        assert cfg.matcher.max_points_num == jcfg.matcher.max_points_num
        model = teim.build_model(SILK_CONFIGS[name][1], cfg, device="cpu")
        assert not model.training
        ex = model.image_extractor
        assert isinstance(ex, tsilk.SiLKVGG)
        assert ex.config.descriptor_scale_factor == 1.41
        assert ex.config.cell_size == 1
        assert shape == ((32, 48, 4) if tiny else (260, 346, 16))


@pytest.mark.parametrize("padding", [1, 0])
def test_build_extractor_takes_padding_as_jax(padding):
    """vgg_np and silk take padding 0 as VALID convolutions and the +9 px
    remap; "vgg" ignores the padding, as the JAX package's does."""
    cfg, _ = silk_config(True, "float32", "EI_SiLK_LG")
    for spec in (cfg.event_extractor, cfg.image_extractor):
        spec = dataclasses.replace(spec, padding=padding)
        m = teim._build_extractor(spec)
        assert m.config.coord_offset == (9.0 if padding == 0 else 0.0)
        assert m.backbone.l1_0.conv.padding == (padding, padding)
    vgg = dataclasses.replace(cfg.event_extractor, type="vgg", padding=0,
                              keypoints=text.KeypointExtractorConfig())
    m = teim._build_extractor(vgg)
    assert m.cell == 8 and m.backbone.l1_0.conv.padding == (1, 1)


def _silk_inputs(H, W, B=2, seed=0):
    from ei_nexus_tpu_torch.data.synth import bursty_event_batch
    rng = np.random.default_rng(seed)
    ev = bursty_event_batch(rng, B, 3000, 4096, H, W)
    image = rng.uniform(0, 255, (B, H, W, 1)).astype(np.float32)
    return ev, image


@pytest.mark.parametrize("name,padding", [
    ("EI_SiLK_LG", 1), ("EI_SiLK_MNN", 1), ("SiLK_MNN", 1),
    ("EIM_stage2_SiLK_LG", 1), ("EI_SiLK_MNN", 0)])
def test_tiny_silk_eim_matches_jax(name, padding, monkeypatch):
    """The EIM of each SiLK model config at its tiny sizes (voxel grid
    from bursty events, vgg_np, SiLK, LightGlue on the einsum path or
    MNN), built through `build_model`; at padding 0 both extractors run
    VALID and the event mask stays out (VALID takes none)."""
    from ei_nexus_tpu.train.steps import batch_representation as jax_rep
    from ei_nexus_tpu_torch.train.steps import batch_representation

    monkeypatch.setenv("EI_NEXUS_ATTN", "xla")
    model_dict, (H, W, bins) = silk_model_dict(True, "float32", name)
    for side in ("event_extractor", "image_extractor"):
        model_dict[side][model_dict[side]["type"]]["padding"] = padding
    jm, _ = _jax_model(name, model_dict)
    ev, image = _silk_inputs(H, W)
    rep, mask = jax_rep(ev, "VoxelGrid", bins, H, W, fast=False)
    if padding == 0:
        mask = None
    variables = _perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                                          rep, image, mask))
    je, ji, jmatch = jax.jit(jm.apply)(variables, rep, image, mask)

    cfg, _ = silk_config(True, "float32", name)
    cfg = dataclasses.replace(
        cfg,
        event_extractor=dataclasses.replace(cfg.event_extractor,
                                            padding=padding),
        image_extractor=dataclasses.replace(cfg.image_extractor,
                                            padding=padding),
        matcher=dataclasses.replace(cfg.matcher, lightglue=dataclasses.replace(
            cfg.matcher.lightglue, attention_impl="xla")))
    tm = teim.build_model("EIM", cfg, device="cpu")
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    trep, tmask = batch_representation(ev, "VoxelGrid", bins, H, W,
                                       device="cpu")
    with torch.no_grad():
        te, ti, tmatch = tm(trep, _t(image),
                            tmask if padding else None)
    for got, want in ((te, je), (ti, ji)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors", "score",
                                        "nms"))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tmatch[k].numpy(),
                                      np.asarray(jmatch[k]), err_msg=k)
    np.testing.assert_allclose(tmatch["matching_scores0"].numpy(),
                               np.asarray(jmatch["matching_scores0"]), **TOL)
    if padding == 0:
        assert te["score"].shape == (2, H - 18, W - 18)


def test_tiny_silk_matcher_matches_jax():
    """SiLKMatcher: one shared SiLK on two frames, then MNN."""
    model_dict, (H, W, _) = silk_model_dict(True, "float32", "SiLKMatcher")
    jm, _ = _jax_model("SiLKMatcher", model_dict)
    rng = np.random.default_rng(4)
    im0 = rng.uniform(0, 255, (2, H, W, 1)).astype(np.float32)
    im1 = np.clip(np.roll(im0, 2, axis=2)
                  + rng.normal(0, 5, im0.shape), 0, 255).astype(np.float32)
    variables = _perturb(jax.jit(jm.init)({"params": jax.random.PRNGKey(1)},
                                          im0, im1))
    jf0, jf1, jmatch = jax.jit(jm.apply)(variables, im0, im1)
    cfg, _ = silk_config(True, "float32", "SiLKMatcher")
    tm = teim.build_model("ImageImageMatcher", cfg, device="cpu")
    tm.load_state_dict(load_jax_variables(variables), strict=True)
    with torch.no_grad():
        tf0, tf1, tmatch = tm(_t(im0), _t(im1))
    for got, want in ((tf0, jf0), (tf1, jf1)):
        _compare_feats(got, want, keys=("sparse_positions", "sparse_valid",
                                        "sparse_descriptors"))
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(tmatch[k].numpy(),
                                      np.asarray(jmatch[k]), err_msg=k)
    assert (tmatch["matches0"] > -1).any()


# ---------------------------------------------------------------------------
# the Flow engine
# ---------------------------------------------------------------------------


def test_flow_lazy_evaluation_and_tape():
    from ei_nexus_tpu_torch.utils.flow import Flow
    calls = []
    flow = Flow("x")
    flow.define_transition("y", lambda x: calls.append("y") or x * 2, "x")
    flow.define_transition("z", lambda x, y: calls.append("z") or x + y,
                           "x", "y")
    flow.define_transition("unused", lambda x: calls.append("u") or -x, "x")
    assert flow("z", x=3) == 9
    assert calls == ["y", "z"]  # "unused" never ran
    assert flow.get_tape(["z"]) == ["y", "z"]
    assert flow.names == ("x", "y", "z", "unused")
    with pytest.raises(ValueError, match="already defined"):
        flow.define_transition("y", lambda x: x, "x")
    with pytest.raises(ValueError, match="missing flow inputs"):
        flow("z")


def test_flow_multi_output_on_tensors():
    from ei_nexus_tpu_torch.utils.flow import Flow
    flow = Flow("a", "b")
    flow.define_transition("s", lambda a, b: a + b, "a", "b")
    flow.define_transition("p", lambda s, a: s * a, "s", "a")
    s, p = flow(("s", "p"), a=torch.tensor(2.0), b=torch.tensor(3.0))
    assert float(s) == 5.0 and float(p) == 10.0


def test_flow_cycle_and_unknown():
    from ei_nexus_tpu_torch.utils.flow import Flow
    flow = Flow("x")
    flow.define_transition("a", lambda b: b, "b")
    flow.define_transition("b", lambda a: a, "a")
    with pytest.raises(ValueError, match="cycle"):
        flow("a", x=1)
    with pytest.raises(KeyError):
        flow("nope", x=1)


def test_auto_forward():
    from ei_nexus_tpu.utils.flow import AutoForward as JAutoForward
    from ei_nexus_tpu.utils.flow import Flow as JFlow
    from ei_nexus_tpu_torch.utils.flow import AutoForward, Flow
    outs = []
    for flow_cls, auto_cls in ((Flow, AutoForward), (JFlow, JAutoForward)):
        flow = flow_cls("x")
        flow.define_transition("y", lambda x: x + 1, "x")
        flow.define_transition("z", lambda y: y * 3, "y")
        m = auto_cls(flow, "y")
        assert m.flow is flow
        outs.append((m.forward_flow(x=4), m.forward_flow(("y", "z"), x=4)))
    assert outs[0] == outs[1] == (5, (5, 15))
