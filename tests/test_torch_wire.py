"""The port's wire format (`train/steps.py`: compact_event_view,
bucket_event_view, _decode_event_view, compact_stage*_batch, and
batch_representation and the stage-2 step fed with it) against the JAX
package's, on the same numpy inputs, on the CPU.

The JAX package encodes with its C++ library where g++ builds it and with
numpy elsewhere; the two round differently at exact half quanta (C++ half
up, numpy half to even). Each comparison pins one encoder on both sides:
native against native, numpy against numpy (the JAX side's library is
hidden by monkeypatching `ei_nexus_tpu.native.compact_encode`).

Tolerances: the wire and the decode exact; the voxel grid from the wire
exactly equal to the one from the decoded float arrays, and within atol
1e-5, rtol 1e-5 of the JAX package's exact scatter
(tests/test_torch_representations.py); the stage-2 step fed the wire
exactly equal to the step fed the decoded arrays.
"""

import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu import native as jnative
from ei_nexus_tpu.train import steps as jsteps
from ei_nexus_tpu_torch import native as tnative
from ei_nexus_tpu_torch.data.synth import bursty_event_batch, stage2_batch
from ei_nexus_tpu_torch.train import steps as tsteps
from tests.test_torch_threads import one_torch_thread  # noqa: F401

def _events(seed, B=3, n=3000, L=40000, H=260, W=346, half=0):
    """Bursty padded events; `half` of each row's valid coordinates moved
    onto exact half quanta (k + 0.5) / 64."""
    rng = np.random.default_rng(seed)
    ev = bursty_event_batch(rng, B, n, L, H, W)
    if half:
        for key, hi in (("events_x", W - 1), ("events_y", H - 1)):
            k = rng.integers(0, hi * 64, (B, half))
            ev[key][:, :half] = ((k + 0.5) / 64).astype(np.float32)
    return ev


def _encoders(monkeypatch, native):
    """Pin the JAX side to the encoder the port is asked for."""
    if native:
        if jnative.lib() is None or tnative.lib() is None:
            pytest.skip("no C++ toolchain")
    else:
        monkeypatch.setattr(jnative, "compact_encode", lambda *a: None)
    return native


def _assert_wire_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("n,L,half", [
    (3000, 40000, 0),       # 16384 bucket
    (3000, 40000, 500),     # exact half quanta
    (20000, 40000, 0),      # 32768 bucket
    (40000, 40000, 0),      # full columns: no bucket shorter
    (0, 4096, 0),           # no events
], ids=["b16k", "half-quanta", "b32k", "full", "empty"])
def test_compact_event_view_matches_jax(monkeypatch, native, n, L, half):
    _encoders(monkeypatch, native)
    ev = _events(1, n=n, L=L, half=half)
    want = jsteps.compact_event_view(ev, keep=("image",))
    got = tsteps.compact_event_view(ev, keep=("image",), native=native)
    _assert_wire_equal(got, want)
    unbucketed = tsteps.compact_event_view(ev, bucket=False, native=native)
    _assert_wire_equal(unbucketed,
                       jsteps.compact_event_view(ev, bucket=False))
    assert unbucketed["events_xq"].shape[-1] == L


def test_float64_times_are_shifted_as_jax(monkeypatch):
    """Absolute float64 stamps are made relative before narrowing."""
    _encoders(monkeypatch, False)
    ev = _events(2, n=1000, L=2048)
    ev["events_t"] = ev["events_t"].astype(np.float64) + 1.5e9
    ev["events_t"][~ev["events_valid"]] = 0.0
    _assert_wire_equal(tsteps.compact_event_view(ev, native=False),
                       jsteps.compact_event_view(ev))


def test_encoders_differ_only_at_half_quanta():
    """The C++ encoder rounds exact half quanta up, numpy to even; the two
    agree everywhere else (the divergence inside the JAX package, which
    the port keeps)."""
    if tnative.lib() is None:
        pytest.skip("no C++ toolchain")
    ev = _events(3, n=3000, L=4096, half=400)
    a = tsteps.compact_event_view(ev, native=True)
    b = tsteps.compact_event_view(ev, native=False)
    for key, q in (("events_x", "events_xq"), ("events_y", "events_yq")):
        v = ev[key].astype(np.float64) * 64
        at_half = (v - np.floor(v)) == 0.5
        differ = a[q] != b[q]
        assert differ.any()
        assert not (differ & ~at_half).any()
        np.testing.assert_array_equal(a[q][at_half],
                                      np.floor(v[at_half]) + 1)
        np.testing.assert_array_equal(b[q][at_half],
                                      np.round(v[at_half]))


@pytest.mark.parametrize("n_max,want", [(0, 16384), (16384, 16384),
                                         (16385, 32768), (65536, 65536),
                                         (131073, 262144)])
def test_bucket_event_view_matches_jax(n_max, want):
    L = 262144
    enc = {"events_xq": np.zeros((2, L), np.uint16),
           "events_yq": np.zeros((2, L), np.uint16),
           "events_tr": np.zeros((2, L), np.float32),
           "events_pq": np.zeros((2, L), np.uint8),
           "events_n": np.array([n_max // 2, n_max], np.int32)}
    got = tsteps.bucket_event_view(enc)
    _assert_wire_equal(got, jsteps.bucket_event_view(enc))
    assert got["events_xq"].shape[-1] == want


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_decode_matches_jax(monkeypatch, native):
    _encoders(monkeypatch, native)
    ev = _events(4, n=5000, L=20000, half=300)
    enc = jsteps.compact_event_view(ev, keep=("image",))
    enc["image"] = np.zeros((3, 4, 5, 1), np.float32)
    want = jsteps._decode_event_view({k: jnp.asarray(v)
                                      for k, v in enc.items()})
    got = tsteps._decode_event_view(enc, "cpu")
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # x, y are round(v * 64) / 64 of the encoder that ran
    rounded = (np.floor(ev["events_x"].astype(np.float64) * 64 + 0.5)
               if native else np.round(ev["events_x"] * 64)) / 64
    L = got["events_x"].shape[-1]
    np.testing.assert_array_equal(got["events_x"].numpy(),
                                  rounded[:, :L].astype(np.float32))
    # a view without the compact keys passes through
    assert tsteps._decode_event_view(ev, "cpu").keys() == ev.keys()


@pytest.mark.parametrize("which", ["stage1", "stage2", "homography"])
def test_compact_stage_batches_match_jax(monkeypatch, which):
    _encoders(monkeypatch, False)
    batch = stage2_batch(np.random.default_rng(5), 2, 3000, 8192, 32, 48)
    batch[0]["image"] = batch[1]["image"]
    name = {"stage1": "compact_stage1_batch",
            "stage2": "compact_stage2_batch",
            "homography": "compact_stage2_homography_batch"}[which]
    want = getattr(jsteps, name)(batch)
    got = getattr(tsteps, name)(batch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            _assert_wire_equal(g, w)
        else:
            np.testing.assert_array_equal(g, w)


def _decoded_floats(enc):
    """The wire decoded on the host: round(v * 64) / 64 as float32 arrays
    and the tail-padded validity mask."""
    L = enc["events_xq"].shape[-1]
    out = {k: v for k, v in enc.items() if not k.startswith("events_")}
    out.update(
        events_x=enc["events_xq"].astype(np.float32) / 64,
        events_y=enc["events_yq"].astype(np.float32) / 64,
        events_t=enc["events_tr"].astype(np.float32),
        events_p=enc["events_pq"].astype(np.float32),
        events_valid=np.arange(L)[None, :] < enc["events_n"][:, None])
    return out


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("n,L,bins,hw", [(3000, 40000, 4, (32, 48)),
                                         (20000, 40000, 16, (30, 45)),
                                         (0, 2048, 5, (16, 24))])
def test_batch_representation_of_the_wire(monkeypatch, native, n, L, bins,
                                          hw):
    """The voxel grid from the wire equals the one from the decoded float
    arrays exactly, and the JAX package's exact scatter of the same wire
    within the representation test's tolerance."""
    _encoders(monkeypatch, native)
    H, W = hw
    ev = _events(6, B=2, n=n, L=L, H=H, W=W)
    enc = tsteps.compact_event_view(ev, native=native)
    rep, mask = tsteps.batch_representation(enc, "VoxelGrid", bins, H, W,
                                            device="cpu")
    rep_f, mask_f = tsteps.batch_representation(
        _decoded_floats(enc), "VoxelGrid", bins, H, W, device="cpu")
    assert torch.equal(rep, rep_f) and torch.equal(mask, mask_f)
    want_rep, want_mask = jsteps.batch_representation(
        jsteps.compact_event_view(ev), "VoxelGrid", bins, H, W, fast=False)
    np.testing.assert_allclose(rep.numpy(), np.asarray(want_rep), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_stage2_step_fed_the_wire():
    """The tiny stage-2 step fed `compact_stage2_batch` equals the same
    step (same weights and fill) fed the decoded float arrays, for two
    steps: loss, every info term and every parameter."""
    from ei_nexus_tpu_torch.flagship import (build_stage2_flagship,
                                             stage2_train_state)

    model, (H, W, bins) = build_stage2_flagship(
        tiny=True, dtype="float32", device="cpu",
        generator=torch.Generator().manual_seed(3))
    twin = copy.deepcopy(model)
    batch = stage2_batch(np.random.default_rng(7), 2, 3000, 8192, H, W,
                         focal=61.0)
    wire = tsteps.compact_stage2_batch(batch)
    floats = (_decoded_floats(wire[0]),) + tuple(wire[1:])
    step = tsteps.make_stage2_train_step("VoxelGrid", bins, H, W)
    states = [stage2_train_state(m) for m in (model, twin)]
    for i in range(2):
        infos = [step(s, b, generator=torch.Generator().manual_seed(i))
                 for s, b in zip(states, (wire, floats))]
        assert infos[0].keys() == infos[1].keys()
        for k in infos[0]:
            assert torch.equal(infos[0][k], infos[1][k]), k
    assert float(infos[0]["gt_matches"]) > 0
    a, b = model.state_dict(), twin.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
