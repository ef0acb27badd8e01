"""The port's ops (ei_nexus_tpu_torch.ops) against the JAX package's, on the
same numpy inputs, on the CPU.

Tolerances: exact where the port does the same float32 operations in the
same order (padding, pixel shuffle, masks, max-pool NMS, top-k selection);
1e-6 where it sums in another order (softmax, bilinear weights, norms).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.ops import descriptor as jdesc
from ei_nexus_tpu.ops import detector as jdet
from ei_nexus_tpu.ops.pad import Padder as JPadder
from ei_nexus_tpu.ops.pallas_nms import nms_pallas
from ei_nexus_tpu_torch.ops import descriptor as tdesc
from ei_nexus_tpu_torch.ops import detector as tdet
from ei_nexus_tpu_torch.ops.nms_kernel import nms_rounds, nms_rounds_plain
from ei_nexus_tpu_torch.ops.pad import Padder as TPadder
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _score_map(rng, shape, keep=0.6):
    """A sparse score map with exact zeros (ties) between peaks."""
    s = rng.uniform(0, 1, shape).astype(np.float32)
    s[s < keep] = 0
    return s


@pytest.mark.parametrize("hw,cell", [((32, 48), 8), ((30, 45), 8),
                                     ((260, 346), 8), ((7, 9), 4)])
def test_padder_pad_unpad(rng, hw, cell):
    H, W = hw
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    m = rng.uniform(size=(2, H, W)) > 0.5
    jp, tp = JPadder(H, W, cell), TPadder(H, W, cell)
    np.testing.assert_array_equal(tp.pad(_t(x)).numpy(),
                                  np.asarray(jp.pad(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tp.pad(_t(m), hw_axes=(-2, -1)).numpy(),
        np.asarray(jp.pad(jnp.asarray(m), hw_axes=(-2, -1))))
    padded = tp.pad(_t(x))
    np.testing.assert_array_equal(tp.unpad(padded).numpy(), x)
    pos = rng.uniform(0, 40, (2, 5, 3)).astype(np.float32)
    for order in ("yx", "xy"):
        np.testing.assert_array_equal(
            tp.unpad_positions(_t(pos), order).numpy(),
            np.asarray(jp.unpad_positions(jnp.asarray(pos), order)))


def test_logits_depth_to_space_border(rng):
    logits = rng.normal(size=(2, 4, 6, 65)).astype(np.float32)
    want = jdet.depth_to_space(jdet.logits_to_prob(jnp.asarray(logits)), 8)
    got = tdet.depth_to_space(tdet.logits_to_prob(_t(logits)), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        tdet.remove_border_scores(got, 4).numpy(),
        np.asarray(jdet.remove_border_scores(jnp.asarray(got.numpy()), 4)))
    one = rng.normal(size=(2, 5, 5, 1)).astype(np.float32)
    np.testing.assert_allclose(tdet.logits_to_prob(_t(one)).numpy(),
                               np.asarray(jdet.logits_to_prob(
                                   jnp.asarray(one))), atol=1e-6)


def test_smooth_score_mask(rng):
    m = rng.uniform(size=(2, 20, 30)) > 0.9
    np.testing.assert_array_equal(
        tdet.smooth_score_mask(_t(m)).numpy(),
        np.asarray(jdet.smooth_score_mask(jnp.asarray(m))))


@pytest.mark.parametrize("radius,keep", [(4, 0.6), (3, 0.0), (2, 0.9)])
def test_nms_converged_matches_jax(rng, radius, keep):
    s = _score_map(rng, (2, 40, 48), keep)
    want = np.asarray(jdet.nms(jnp.asarray(s), radius, impl="xla"))
    np.testing.assert_array_equal(
        tdet.nms(_t(s), radius, impl="xla").numpy(), want)
    # "auto" on a CPU tensor is the converged loop too, as in JAX on CPU
    np.testing.assert_array_equal(tdet.nms(_t(s), radius).numpy(), want)


@pytest.mark.parametrize("radius,n_iter,keep,plateau", [
    pytest.param(4, 4, 0.6, False, id="4-4-0.6"),
    pytest.param(3, 4, 0.01, False, id="3-4-0.01"),
    pytest.param(4, 2, 0.0, False, id="4-2-0.0"),
    pytest.param(1, 3, 0.5, False, id="1-3-0.5"),
    pytest.param(4, 4, 0.3, True, id="4-4-0.3-plateau"),
])
def test_nms_fixed_rounds_bit_exact_vs_pallas(rng, radius, n_iter, keep,
                                              plateau):
    """Kernel C's plain version against the Pallas kernel in interpret
    mode: bit-exact (max, compare and select only). The plateau map's
    scores are multiples of 1/8, so neighbouring positive peaks tie."""
    s = _score_map(rng, (2, 40, 48), keep)
    if plateau:
        s = np.round(s * 8) / 8
        s[s < keep] = 0
    want = np.asarray(nms_pallas(jnp.asarray(s), radius, n_iter=n_iter,
                                 interpret=True))
    got = nms_rounds_plain(_t(s), radius, n_iter)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(nms_rounds(_t(s), radius, n_iter).numpy(),
                                  want)
    np.testing.assert_array_equal(
        tdet.nms(_t(s), radius, max_iter=n_iter, impl="pallas").numpy(),
        want)


@pytest.mark.parametrize("k,min_distance", [(32, 0), (32, 5), (64, 5),
                                            (8, 3), (2000, 0)])
def test_select_topk_keypoints(rng, k, min_distance):
    """Both selection paths, on NMS'd maps full of exact-zero ties: the
    port breaks ties toward the lower index as lax.top_k does."""
    s = np.asarray(jdet.nms(jnp.asarray(_score_map(rng, (2, 40, 48), 0.5)),
                            4, impl="xla"))
    for order in ("yx", "xy"):
        jp, jv = jdet.select_topk_keypoints(jnp.asarray(s), k, 1.0, order,
                                            min_distance)
        tp, tv = tdet.select_topk_keypoints(_t(s), k, 1.0, order,
                                            min_distance)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dense_positions(rng):
    s = rng.uniform(size=(2, 6, 7)).astype(np.float32)
    for order in ("yx", "xy"):
        np.testing.assert_array_equal(
            tdet.dense_positions(_t(s), order).numpy(),
            np.asarray(jdet.dense_positions(jnp.asarray(s), order)))


@pytest.mark.parametrize("order", ["yx", "xy"])
def test_sample_descriptors_lowres(rng, order):
    raw = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    # positions inside, on and beyond the padded map's edges (zero padding)
    pos = rng.uniform(-4, 52, (2, 40, 3)).astype(np.float32)
    want = jdesc.sample_descriptors_lowres(jnp.asarray(raw),
                                           jnp.asarray(pos), (32, 48), 1.3,
                                           True, order)
    got = tdesc.sample_descriptors_lowres(_t(raw), _t(pos), (32, 48), 1.3,
                                          True, order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_upsample_and_dense_descriptors(rng):
    """jax.image.resize bilinear and F.interpolate(align_corners=False)
    agree on upsampling (half-pixel centres, no antialiasing)."""
    raw = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    want = jdesc.upsample_descriptors(jnp.asarray(raw), (32, 48), 1.5)
    got = tdesc.upsample_descriptors(_t(raw), (32, 48), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        tdesc.dense_descriptors(got).numpy(),
        np.asarray(jdesc.dense_descriptors(jnp.asarray(got.numpy()))))
    np.testing.assert_allclose(
        tdesc.normalize_descriptors(_t(raw), 2.0).numpy(),
        np.asarray(jdesc.normalize_descriptors(jnp.asarray(raw), 2.0)),
        atol=1e-6)
