"""The port's host modules and PointNet++ blocks against the JAX package's,
on the same numpy inputs, on the CPU: `models/pointnet.py`,
`data/rectify.py`, `utils/image_io.py`, `utils/visualize.py`,
`utils/setup.py` and `utils/profiling.py`.

Tolerances: indices, masks, uint8 images and the host copies' arrays
exact (the same numpy and cv2 calls); PointNet++ distances and features
atol 1e-5 with rtol 1e-5 (float32 products summed in another order;
observed ~1e-7).
"""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.models import pointnet as jpn
from ei_nexus_tpu_torch.models import pointnet as tpn
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, n=96, grid=None):
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if grid:   # coordinates on a grid: equal distances, ties in the top-k
        pts = np.round(pts * grid) / grid
    return pts.astype(np.float32)


@pytest.mark.parametrize("grid", [None, 4])
def test_sampling_and_grouping_match_jax(rng, grid):
    pts = _cloud(rng, grid=grid)
    mask = rng.uniform(size=len(pts)) > 0.2
    mask[0] = False                       # the first valid point is not 0
    np.testing.assert_allclose(
        tpn.square_distance(_t(pts[:8]), _t(pts)).numpy(),
        np.asarray(jpn.square_distance(pts[:8], pts)), **TOL)
    for m in (None, mask):
        want = np.asarray(jpn.farthest_point_sample(
            jnp.asarray(pts), 24, None if m is None else jnp.asarray(m)))
        got = tpn.farthest_point_sample(_t(pts), 24,
                                        None if m is None else _t(m))
        np.testing.assert_array_equal(got.numpy(), want)
        centers = pts[want]
        jidx, jvalid = jpn.ball_query(jnp.asarray(pts), jnp.asarray(centers),
                                      0.3, 12,
                                      None if m is None else jnp.asarray(m))
        tidx, tvalid = tpn.ball_query(_t(pts), _t(centers), 0.3, 12,
                                      None if m is None else _t(m))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0, 0.3, x.shape), x.dtype)
        if x.ndim == 1 else x, variables)


@pytest.mark.parametrize("with_feats", [False, True])
def test_pointnet_modules_match_jax(rng, with_feats):
    """SA, SA-MSG and FP with the JAX modules' weights carried across
    (biases perturbed), with and without input features and a mask."""
    pts = _cloud(rng, 80)
    feats = rng.normal(size=(80, 5)).astype(np.float32) if with_feats \
        else None
    mask = rng.uniform(size=80) > 0.1
    C = 5 if with_feats else 0
    jf = None if feats is None else jnp.asarray(feats)
    tf = None if feats is None else _t(feats)

    jsa = jpn.PointNetSAModule(n_centers=16, radius=0.35, n_neighbors=8,
                               mlp=(16, 24))
    v = _perturbed(jsa.init(jax.random.PRNGKey(0), jnp.asarray(pts), jf,
                            jnp.asarray(mask)), 1)
    jc, jo = jsa.apply(v, jnp.asarray(pts), jf, jnp.asarray(mask))
    tsa = tpn.PointNetSAModule(16, 0.35, 8, (16, 24), in_channels=C)
    tsa.load_state_dict(load_jax_variables(v), strict=True)
    with torch.no_grad():
        tc, to = tsa(_t(pts), tf, _t(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)

    jmsg = jpn.PointNetSAModuleMSG(n_centers=12, radii=(0.2, 0.4),
                                   n_neighbors=(6, 10), mlps=((8,), (8, 12)))
    v = _perturbed(jmsg.init(jax.random.PRNGKey(1), jnp.asarray(pts), jf),
                   2)
    jc, jo = jmsg.apply(v, jnp.asarray(pts), jf)
    tmsg = tpn.PointNetSAModuleMSG(12, (0.2, 0.4), (6, 10), ((8,), (8, 12)),
                                   in_channels=C)
    tmsg.load_state_dict(load_jax_variables(v), strict=True)
    with torch.no_grad():
        tc, to = tmsg(_t(pts), tf)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)

    jfp = jpn.PointNetFPModule(mlp=(10, 6))
    v = _perturbed(jfp.init(jax.random.PRNGKey(2), jnp.asarray(pts), jc, jf,
                            jo), 3)
    want = jfp.apply(v, jnp.asarray(pts), jc, jf, jo)
    tfp = tpn.PointNetFPModule((10, 6), in_channels=C + 20)
    tfp.load_state_dict(load_jax_variables(v), strict=True)
    with torch.no_grad():
        got = tfp(_t(pts), tc, tf, to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rectify_matches_jax(rng):
    from ei_nexus_tpu.data import rectify as jr
    from ei_nexus_tpu_torch.data import rectify as tr
    H, W = 20, 30
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    x_map = xx + rng.uniform(-1.5, 1.5, (H, W)).astype(np.float32)
    y_map = yy + rng.uniform(-1.5, 1.5, (H, W)).astype(np.float32)
    images = rng.integers(0, 255, (3, H, W)).astype(np.uint8)
    np.testing.assert_array_equal(tr.rectify_images(images, x_map, y_map),
                                  jr.rectify_images(images, x_map, y_map))
    ev = np.stack([rng.uniform(-1, W, 200), rng.uniform(-1, H, 200),
                   rng.uniform(0, 1, 200),
                   rng.integers(0, 2, 200).astype(float)], 1)
    np.testing.assert_array_equal(
        tr.rectify_events(ev, x_map, y_map, (W, H)),
        jr.rectify_events(ev, x_map, y_map, (W, H)))
    K = np.array([[40.0, 0, 15], [0, 40.0, 10], [0, 0, 1]])
    dist = np.array([-0.2, 0.05, 1e-3, -1e-3])
    ev_ec = ev[:, [2, 0, 1, 3]]                       # (t, x, y, p)
    np.testing.assert_array_equal(
        tr.undistort_events_pinhole(ev_ec, K, dist, (W, H)),
        jr.undistort_events_pinhole(ev_ec, K, dist, (W, H)))
    np.testing.assert_array_equal(
        tr.undistort_images_pinhole(images, K, dist),
        jr.undistort_images_pinhole(images, K, dist))


def test_image_io_matches_jax(rng, tmp_path):
    import cv2
    from ei_nexus_tpu.utils import image_io as ji
    from ei_nexus_tpu_torch.utils import image_io as ti
    img = rng.integers(0, 255, (24, 40, 3), dtype=np.uint8)
    path = str(tmp_path / "frame.png")
    cv2.imwrite(path, img)
    for gray in (True, False):
        np.testing.assert_array_equal(ti.read_image(path, gray),
                                      ji.read_image(path, gray))
    np.testing.assert_array_equal(ti.load_image(path, resize=20),
                                  ji.load_image(path, resize=20))
    for scale in (True, False):
        np.testing.assert_array_equal(ti.image_to_array(img, scale),
                                      ji.image_to_array(img, scale))
    for size, fn, interp in ((16, "max", "area"), (10, "min", "linear"),
                             ((12, 18), "max", "cubic"),
                             ((30, 50), "max", "nearest")):
        a, sa = ti.resize_image(img, size, fn, interp)
        b, sb = ji.resize_image(img, size, fn, interp)
        np.testing.assert_array_equal(a, b)
        assert sa == sb
    for resize, side in ((None, "long"), (32, "long"), (12, "short")):
        a, sa = ti.ImagePreprocessor(resize, side)(img)
        b, sb = ji.ImagePreprocessor(resize, side)(img)
        np.testing.assert_array_equal(a, b)
        assert sa == sb
    with pytest.raises(FileNotFoundError):
        ti.read_image(str(tmp_path / "absent.png"))


def test_visualize_matches_jax(rng):
    from ei_nexus_tpu.utils import visualize as jv
    from ei_nexus_tpu_torch.utils import visualize as tv
    acc = rng.normal(size=(20, 30))
    np.testing.assert_array_equal(tv.accumulation_to_u8(acc),
                                  jv.accumulation_to_u8(acc))
    np.testing.assert_array_equal(tv.accumulation_to_u8(np.ones((3, 4))),
                                  jv.accumulation_to_u8(np.ones((3, 4))))
    depth = rng.uniform(1, 5, (20, 30))
    depth[0, :3] = np.nan
    np.testing.assert_array_equal(tv.depth_to_color(depth),
                                  jv.depth_to_color(depth))
    img = rng.uniform(0, 300, (20, 30, 1))
    kp = np.stack([rng.uniform(0, 20, 9), rng.uniform(0, 30, 9),
                   rng.uniform(size=9)], 1)
    for order in ("yx", "xy"):
        np.testing.assert_array_equal(tv.draw_keypoints(img, kp, order),
                                      jv.draw_keypoints(img, kp, order))
    inl = rng.uniform(size=9) > 0.5
    img1 = rng.integers(0, 255, (16, 25), dtype=np.uint8)
    for inliers in (None, inl):
        np.testing.assert_array_equal(
            tv.draw_matches(img, img1, kp, kp[::-1], "yx", inliers, 6),
            jv.draw_matches(img, img1, kp, kp[::-1], "yx", inliers, 6))
    np.testing.assert_array_equal(tv.overlay_events_on_image(img1, acc[:16,
                                                                       :25]),
                                  jv.overlay_events_on_image(img1, acc[:16,
                                                                       :25]))


def test_setup_matches_jax():
    """The same host generator states as the JAX package's setup; torch
    seeded, cuDNN deterministic, TF32 off; a seeded generator back. The
    global states are restored after the test."""
    from ei_nexus_tpu.utils.setup import setup as jax_setup
    from ei_nexus_tpu_torch.utils.setup import setup
    py, npy = random.getstate(), np.random.get_state()
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        with torch.random.fork_rng():
            key = jax_setup(11)
            want = (random.random(), np.random.rand(3))
            gen = setup(11)
            got = (random.random(), np.random.rand(3))
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            assert torch.equal(torch.rand(4),
                               torch.rand(4, generator=torch.Generator()
                                          .manual_seed(11)))
            assert torch.equal(torch.rand(4, generator=gen),
                               torch.rand(4, generator=torch.Generator()
                                          .manual_seed(11)))
            assert np.asarray(key).tolist() == [0, 11]
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        random.setstate(py)
        np.random.set_state(npy)
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def test_profiling_matches_jax(tmp_path):
    """StepTimer's statistics are the JAX package's over the same step
    times; `trace` writes a trace holding an `annotate` span."""
    from ei_nexus_tpu.utils.profiling import StepTimer as JaxTimer
    from ei_nexus_tpu_torch.utils.profiling import (StepTimer, annotate,
                                                    trace)
    t, j = StepTimer(window=4), JaxTimer(window=4)
    for _ in range(5):
        t.tic()
        x = torch.ones(8) * 2
        dt = t.toc({"x": x}, fetch=True)
        assert dt >= 0
        j.times.append(dt)
    assert t.stats() == j.stats() and len(t.times) == 4
    assert StepTimer().stats() == {}
    with trace(str(tmp_path / "prof")):
        with annotate("port_span"):
            torch.ones(16).sum()
    text = (tmp_path / "prof" / "trace.json").read_text()
    assert "port_span" in text
