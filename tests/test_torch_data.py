"""The port's data path (`ei_nexus_tpu_torch.data`: the MVSEC and EC
readers, the pose interpolator, the augmentations, the loader, collation
and the put to the device; `serve.py`) against the JAX package's, on
synthetic MVSEC HDF5 and EC directory fixtures in the layouts of
tests/test_data.py (frames cut to 26x34 to keep the files small).

Tolerances: samples, augmentations and batches exact, array for array; the
interpolators to 1e-12 (the same scipy calls; the inverse of the 4x4 pose
is the only float64 arithmetic that could round differently).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ei_nexus_tpu.data import augment as jaug
from ei_nexus_tpu.data import ec as jec
from ei_nexus_tpu.data import interpolator as jint
from ei_nexus_tpu.data import mvsec as jmvsec
from ei_nexus_tpu.data import pipeline as jpipe
from ei_nexus_tpu_torch.data import augment as taug
from ei_nexus_tpu_torch.data import ec as tec
from ei_nexus_tpu_torch.data import interpolator as tint
from ei_nexus_tpu_torch.data import mvsec as tmvsec
from ei_nexus_tpu_torch.data import pipeline as tpipe
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
H, W = 26, 34

# ---------------------------------------------------------------------------
# fixtures: synthetic datasets in the on-disk layouts of tests/test_data.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mvsec_root(tmp_path_factory):
    import h5py
    root = tmp_path_factory.mktemp("mvsec")
    rng = np.random.default_rng(0)
    n_frames, n_events = 400, 40000
    t0, t1 = 100.0, 120.0

    for seq, scene in [("indoor_flying1", "indoor_flying"),
                       ("indoor_flying2", "indoor_flying"),
                       ("indoor_flying4", "indoor_flying")]:
        d = root / scene
        d.mkdir(exist_ok=True)
        image_ts = np.linspace(t0, t1, n_frames)
        depth_ts = image_ts[::2] + 0.001
        ev_t = np.sort(rng.uniform(t0, t1, n_events))
        ev = np.stack([rng.uniform(0, W - 1, n_events),
                       rng.uniform(0, H - 1, n_events), ev_t,
                       rng.integers(0, 2, n_events).astype(float)], 1)
        pose_ts = np.linspace(t0 - 1, t1 + 1, 100)
        poses = np.tile(np.eye(4), (100, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 1, 100)
        poses[:, 1, 3] = np.sin(np.linspace(0, 3, 100))
        with h5py.File(d / f"{seq}_data.hdf5", "w") as f:
            f.create_dataset("davis/left/image_raw_ts", data=image_ts)
            f.create_dataset("davis/left/image_raw",
                             data=rng.integers(0, 255, (n_frames, H, W),
                                               dtype=np.uint8))
        with h5py.File(d / f"{seq}_gt.hdf5", "w") as f:
            depth = rng.uniform(1, 5, (len(depth_ts), H, W)).astype(
                np.float32)
            depth[:, :3] = np.nan  # invalid band
            f.create_dataset("davis/left/depth_image_rect", data=depth)
            f.create_dataset("davis/left/depth_image_rect_ts", data=depth_ts)
            f.create_dataset("davis/left/pose", data=poses)
            f.create_dataset("davis/left/pose_ts", data=pose_ts)
        with h5py.File(d / f"{seq}_rectified.h5", "w") as f:
            f.create_dataset("davis/left/events_rect", data=ev)
            f.create_dataset("davis/left/image_rect",
                             data=rng.integers(0, 255, (n_frames, H, W),
                                               dtype=np.uint8))

    calib = root / "indoor_flying_calib"
    calib.mkdir()
    with open(calib / "camchain-imucam-indoor_flying.yaml", "w") as f:
        f.write("cam0:\n  intrinsics: [199.0, 199.0, 173.0, 130.0]\n")
    for seq in ("indoor_flying1", "indoor_flying4"):
        np.savetxt(root / f"{seq}_final_indices.txt",
                   np.array([[0, 3], [1, 4], [5, 5], [7, 2]]))
    return str(root)


@pytest.fixture(scope="module")
def ec_root(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("ec")
    rng = np.random.default_rng(1)
    n_frames, n_events = 260, 20000
    t0, t1 = 0.0, 13.0
    for seq in ["shapes_translation", "boxes_rotation"]:
        d = root / seq
        (d / "images_corrected").mkdir(parents=True)
        frame_ts = np.linspace(t0, t1, n_frames)
        with open(d / "images.txt", "w") as f:
            for i, ts in enumerate(frame_ts):
                f.write(f"{ts} images/frame_{i:08d}.png\n")
        for i in range(n_frames):
            cv2.imwrite(str(d / "images_corrected" / f"frame_{i:08d}.png"),
                        rng.integers(0, 255, (H, W), dtype=np.uint8))
        ev = np.stack([np.sort(rng.uniform(t0, t1, n_events)),
                       rng.uniform(0, W - 1, n_events),
                       rng.uniform(0, H - 1, n_events),
                       rng.integers(0, 2, n_events).astype(float)], 1)
        np.save(d / "events_corrected.npy", ev)
        np.savetxt(d / "calib.txt",
                   np.array([199.0, 199.0, 120.0, 90.0, 0, 0, 0, 0]))
        pose_ts = np.linspace(t0 - 0.5, t1 + 0.5, 60)
        gt = np.zeros((60, 8))
        gt[:, 0] = pose_ts
        gt[:, 1] = np.linspace(0, 0.5, 60)
        q = rng.normal(size=(60, 4))
        gt[:, 4:] = q / np.linalg.norm(q, axis=1, keepdims=True)
        np.save(d / "groundtruth.npy", gt)
        np.savetxt(root / f"new_{seq}_val.txt",
                   np.array([[0, 5], [2, 8], [3, 3]]))
    return str(root)


def assert_same(got, want, path="sample"):
    """Equal nested structures, array for array: dtype, shape, values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def test_tables_match_jax():
    for name in ("RESOLUTION", "TRAIN_SEQUENCES", "VAL_SEQUENCES",
                 "SEQUENCE_CROPS", "SCENE_OF"):
        assert getattr(tmvsec, name) == getattr(jmvsec, name), name
    for name in ("RESOLUTION", "ALL_SEQUENCES", "TRAIN_SEQUENCES",
                 "VAL_SEQUENCES"):
        assert getattr(tec, name) == getattr(jec, name), name


def test_mvsec_archive_matches_jax(mvsec_root):
    a, b = tmvsec.MVSECArchive(mvsec_root), jmvsec.MVSECArchive(mvsec_root)
    seq = "indoor_flying1"
    assert_same(a.get_K(seq), b.get_K(seq))
    assert_same(a.get_images(seq), b.get_images(seq))
    assert_same(a.get_image_timestamps(seq), b.get_image_timestamps(seq))
    assert_same(a.get_depth(seq), b.get_depth(seq))
    assert_same(a.get_pose(seq), b.get_pose(seq))
    (ta, da), (tb, db) = a.get_event_datasets(seq), b.get_event_datasets(seq)
    assert_same(ta, tb)
    assert_same(da[:], db[:])


@pytest.mark.parametrize("seq", ["indoor_flying1", "indoor_flying4"])
def test_mvsec_sequence_views_match_jax(mvsec_root, seq):
    a = tmvsec.MVSECSequence(tmvsec.MVSECArchive(mvsec_root), seq)
    b = jmvsec.MVSECSequence(jmvsec.MVSECArchive(mvsec_root), seq)
    assert len(a) == len(b) > 0
    assert_same((a.depth_ts, a.image_ts, a.K), (b.depth_ts, b.image_ts, b.K))
    for i in (0, len(a) // 2, len(a) - 1):
        # max_events below and above the window's event count
        for max_events in (256, 4096):
            assert_same(a.view(i, 0.4, max_events), b.view(i, 0.4,
                                                           max_events))
    assert_same(a.events_window(110.0, 0.05), b.events_window(110.0, 0.05))


def _pair_datasets(module, root, mode, **kw):
    files = None
    if mode == "index_pairs":
        files = [str(Path(root) / f"{s}_final_indices.txt")
                 for s in ("indoor_flying1", "indoor_flying4")]
        seqs = ["indoor_flying1", "indoor_flying4"]
    else:
        seqs = ["indoor_flying1", "indoor_flying2"]
    return module.MVSECPairDataset(root, seqs, max_events=2048, mode=mode,
                                   index_files=files, seed=3, **kw)


@pytest.mark.parametrize("mode", ["single", "random_pair", "index_pairs",
                                  "single-augmented"])
def test_mvsec_pair_dataset_matches_jax(mvsec_root, mode):
    aug = {}
    if mode == "single-augmented":
        mode = "single"
        aug = {"t": taug.PairAugmentationEvents((20, 24), rotate_angle=8.0),
               "j": jaug.PairAugmentationEvents((20, 24), rotate_angle=8.0)}
    a = _pair_datasets(tmvsec, mvsec_root, mode, augment=aug.get("t"))
    b = _pair_datasets(jmvsec, mvsec_root, mode, augment=aug.get("j"))
    assert len(a) == len(b)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in sorted({0, 1, 2, len(a) // 2, len(a) - 1}):
            assert_same(a[i], b[i], f"{mode}[{i}]")


@pytest.mark.parametrize("split,cfg", [
    ("train", {"max_events": 1024, "train_sequences": ["indoor_flying1"]}),
    ("train", {"max_events": 1024, "select_matching_pair": True,
               "train_sequences": ["indoor_flying1", "indoor_flying2"]}),
    ("train", {"max_events": 1024, "train_sequences": ["indoor_flying2"],
               "train": {"pair_aug": {"crop_size": [16, 20]}}}),
    ("train", {"max_events": 1024, "train_on_rpe_data": True,
               "train_sequences": ["indoor_flying1"]}),
    ("val", {"max_events": 1024, "val_sequences": ["indoor_flying4"]}),
], ids=["single", "random-pair", "pair-aug", "rpe", "val"])
def test_fetch_mvsec_dataset_matches_jax(mvsec_root, split, cfg):
    cfg = dict(cfg, data_path=mvsec_root, indices_dir=mvsec_root)
    a = tmvsec.fetch_mvsec_dataset(cfg, split)
    b = jmvsec.fetch_mvsec_dataset(cfg, split)
    assert (a.mode, len(a)) == (b.mode, len(b))
    assert type(a.augment).__name__ == type(b.augment).__name__
    for i in (0, len(a) - 1):
        assert_same(a[i], b[i])


def test_relative_pose_matches_jax():
    rng = np.random.default_rng(4)
    p0, p1 = rng.normal(size=(2, 4, 4))
    assert_same(tmvsec.relative_pose(p0, p1), jmvsec.relative_pose(p0, p1))


def test_ec_sequence_matches_jax(ec_root):
    a = tec.ECSequence(tec.ECArchive(ec_root), "shapes_translation")
    b = jec.ECSequence(jec.ECArchive(ec_root), "shapes_translation")
    assert len(a) == len(b) > 0
    assert a.frame_paths == b.frame_paths
    assert_same((a.frame_ts, a.K), (b.frame_ts, b.K))
    for i in (0, len(a) - 1):
        assert_same(a.view(i, 0.04, 1024), b.view(i, 0.04, 1024))
    ar, br = tec.ECArchive(ec_root), jec.ECArchive(ec_root)
    assert_same(ar.get_calibration("boxes_rotation"),
                br.get_calibration("boxes_rotation"))
    assert_same(ar.get_events("boxes_rotation"),
                br.get_events("boxes_rotation"))


@pytest.mark.parametrize("mode", ["single", "single-augmented",
                                  "index_pairs"])
def test_ec_pair_dataset_matches_jax(ec_root, mode):
    seqs = ["shapes_translation", "boxes_rotation"]
    files = [str(Path(ec_root) / f"new_{s}_val.txt") for s in seqs]
    aug = {}
    if mode == "single-augmented":
        mode = "single"
        aug = {"t": taug.PairAugmentationEvents(crop_size=(16, 20)),
               "j": jaug.PairAugmentationEvents(crop_size=(16, 20))}
    a = tec.ECPairDataset(ec_root, seqs, max_events=1024, mode=mode,
                          index_files=files, augment=aug.get("t"), seed=5)
    b = jec.ECPairDataset(ec_root, seqs, max_events=1024, mode=mode,
                          index_files=files, augment=aug.get("j"), seed=5)
    assert len(a) == len(b)
    for i in sorted({0, 2, len(a) // 2, len(a) - 1}):
        assert_same(a[i], b[i], f"{mode}[{i}]")


@pytest.mark.parametrize("split", ["train", "val"])
def test_fetch_ec_dataset_matches_jax(ec_root, split, monkeypatch):
    # the EC split lists name sequences the fixture does not hold: both
    # packages read the lists from their own module, so both are cut alike
    for mod in (tec, jec):
        monkeypatch.setattr(mod, "TRAIN_SEQUENCES", ["shapes_translation"])
        monkeypatch.setattr(mod, "VAL_SEQUENCES", ["boxes_rotation"])
    cfg = {"data_path": ec_root, "max_events": 512,
           "train": {"pair_aug": {"crop_size": [16, 20]}}}
    a, b = tec.fetch_ec_dataset(cfg, split), jec.fetch_ec_dataset(cfg, split)
    assert (a.mode, len(a)) == (b.mode, len(b))
    for i in (0, len(a) - 1):
        assert_same(a[i], b[i])


# ---------------------------------------------------------------------------
# interpolator and augmentations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quat", [False, True])
def test_pose_interpolator_matches_jax(quat):
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(6)
    ts = np.sort(rng.uniform(0, 10, 12))
    t = rng.normal(size=(12, 3))
    rot = Rotation.random(12, rng=np.random.default_rng(7))
    R = rot.as_quat() if quat else rot.as_matrix()
    a = tint.PoseInterpolator(ts, t, R, quat_R=quat)
    b = jint.PoseInterpolator(ts, t, R, quat_R=quat)
    q = rng.uniform(ts[0], ts[-1], 20)
    np.testing.assert_allclose(a.interpolate_batch(q), b.interpolate_batch(q),
                               atol=1e-12, rtol=0)
    for qi in q[:5]:
        np.testing.assert_allclose(a.interpolate(qi), b.interpolate(qi),
                                   atol=1e-12, rtol=0)
    T = rng.normal(size=(5, 4, 4))
    assert_same(tint.T_to_Rt(T, batch=True), jint.T_to_Rt(T, batch=True))
    assert_same(tint.T_to_Rt(T[0]), jint.T_to_Rt(T[0]))
    assert_same(tint.Rt_to_T(T[0, :3, :3], T[0, :3, 3]),
                jint.Rt_to_T(T[0, :3, :3], T[0, :3, 3]))
    with pytest.raises(ValueError):
        a.interpolate(ts[-1] + 1.0)


def test_pair_augmentation_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 30, 40)).astype(np.float32)
    y = rng.normal(size=(1, 30, 40)).astype(np.float32)
    m = (rng.uniform(size=(1, 30, 40)) > 0.5).astype(np.float32)
    for seed in range(4):
        a = taug.PairAugmentation((16, 24), rng=np.random.default_rng(seed))
        b = jaug.PairAugmentation((16, 24), rng=np.random.default_rng(seed))
        assert_same(a(x, y, m), b(x, y, m))
        assert_same(a(x, y)[:2], b(x, y)[:2])
        assert a(x, y)[2] is None
    maps = [x, y]
    assert_same(taug._rotate_maps(maps, 7.5), jaug._rotate_maps(maps, 7.5))


def _aug_sample(rng, n=300, L=400):
    valid = np.zeros(L, bool)
    valid[:n] = True
    return {
        "events_x": np.where(valid, rng.uniform(0, W - 1, L), 0).astype(
            np.float32),
        "events_y": np.where(valid, rng.uniform(0, H - 1, L), 0).astype(
            np.float32),
        "events_t": np.linspace(0, 0.4, L).astype(np.float32),
        "events_p": rng.integers(0, 2, L).astype(np.float32),
        "events_valid": valid,
        "image": rng.uniform(0, 255, (H, W, 1)).astype(np.float32),
        "depth": rng.uniform(1, 3, (H, W)).astype(np.float32),
        "depth_mask": rng.uniform(size=(H, W)) > 0.1,
    }


@pytest.mark.parametrize("depth", [True, False])
def test_pair_augmentation_events_matches_jax(depth):
    rng = np.random.default_rng(9)
    sample = _aug_sample(rng)
    if not depth:
        del sample["depth"], sample["depth_mask"]
    a = taug.PairAugmentationEvents((18, 22), rotate_angle=12.0)
    b = jaug.PairAugmentationEvents((18, 22), rotate_angle=12.0)
    for seed in range(6):
        assert_same(a(sample, rng=np.random.default_rng(seed)),
                    b(sample, rng=np.random.default_rng(seed)))
    # the shared generator, when no per-sample one is given
    a.rng, b.rng = np.random.default_rng(1), np.random.default_rng(1)
    assert_same(a(sample), b(sample))


def test_point_and_image_augmentations_match_jax():
    rng = np.random.default_rng(10)
    ev = {"x": rng.uniform(0, W, 50), "y": rng.uniform(0, H, 50),
          "t": np.sort(rng.uniform(0, 1, 50)),
          "p": rng.integers(0, 2, 50).astype(float)}
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    # pass-through by default, as in the JAX package
    assert taug.EventPointsAugmentation()(ev) is ev
    assert taug.ImageArrayAugmentation()(img) is img
    for seed in range(4):
        a = taug.EventPointsAugmentation(enabled=True, flip_p=0.5,
                                         rng=np.random.default_rng(seed))
        b = jaug.EventPointsAugmentation(enabled=True, flip_p=0.5,
                                         rng=np.random.default_rng(seed))
        assert_same(a(ev), b(ev))
        a = taug.ImageArrayAugmentation(enabled=True,
                                        rng=np.random.default_rng(seed))
        b = jaug.ImageArrayAugmentation(enabled=True,
                                        rng=np.random.default_rng(seed))
        assert_same(a(img), b(img))


# ---------------------------------------------------------------------------
# loader, collation, prefetch and the put to the device
# ---------------------------------------------------------------------------


class FakeDataset:
    def __init__(self, n):
        self.n = n
        self.epochs = []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __getitem__(self, i):
        return ({"x": np.full((3,), i, np.float32), "i": np.int32(i)},
                np.arange(i, i + 2, dtype=np.int64))


def test_collate_matches_jax():
    s = [({"a": np.full(2, i), "b": [np.zeros(3), np.float32(i)]},
          np.int16(i)) for i in range(4)]
    assert_same(tpipe.collate(s), jpipe.collate(s))


@pytest.mark.parametrize("n,batch,shuffle,drop_last,epoch,skip,procs,"
                         "workers", [
                             (10, 4, False, True, 0, 0, 1, 4),
                             (10, 4, False, False, 0, 0, 1, 0),
                             (23, 4, True, True, 0, 0, 1, 2),
                             (23, 4, True, True, 3, 0, 1, 2),
                             (23, 4, True, False, 1, 2, 1, 0),
                             (24, 8, True, True, 2, 1, 2, 3),
                             (30, 6, True, False, 0, 0, 3, 0),
                         ], ids=["plain", "ragged", "shuffle", "epoch",
                                 "skip", "shards", "shards-ragged"])
def test_loader_matches_jax(n, batch, shuffle, drop_last, epoch, skip,
                            procs, workers):
    for p in range(procs):
        kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
                  seed=11, process_index=p, process_count=procs,
                  num_workers=workers, prefetch=2)
        a, b = tpipe.DataLoader(FakeDataset(n), **kw), \
            jpipe.DataLoader(FakeDataset(n), **kw)
        a.set_epoch(epoch, skip_batches=skip)
        b.set_epoch(epoch, skip_batches=skip)
        assert len(a) == len(b)
        assert a.dataset.epochs == b.dataset.epochs == [epoch]
        got, want = list(a), list(b)
        assert len(got) == len(want) > 0
        assert_same(got, want)


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_error_reaches_the_consumer(workers):
    class Bad(FakeDataset):
        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("boom")
            return super().__getitem__(i)

    it = iter(tpipe.DataLoader(Bad(12), batch_size=2, num_workers=workers))
    assert_same(next(it), tpipe.collate([FakeDataset(12)[i]
                                         for i in (0, 1)]))
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


@pytest.mark.parametrize("switch", ["0", "1"])
def test_device_prefetch_order_and_errors(monkeypatch, switch):
    monkeypatch.setenv("EI_NEXUS_DEVICE_PREFETCH", switch)
    items = list(range(7))
    assert list(tpipe.device_prefetch(iter(items), lambda x: x * 10)) == \
        [x * 10 for x in items]

    def bad_put(x):
        if x == 3:
            raise ValueError("put failed")
        return x

    with pytest.raises(ValueError, match="put failed"):
        list(tpipe.device_prefetch(iter(items), bad_put))


def test_pinned_put_on_the_cpu():
    """On a CPU device the put turns every array of a nested batch into a
    tensor of the same dtype and values, pins nothing and holds nothing."""
    put = tpipe.PinnedPut("cpu")
    batch = ({"xq": np.arange(6, dtype=np.uint16).reshape(2, 3),
              "n": np.array([3, 1], np.int32),
              "v": np.array([True, False]),
              "s": np.float32(2.5)},
             np.arange(8, dtype=np.float64)[::2])
    out = put(batch)
    assert isinstance(out, tuple) and set(out[0]) == set(batch[0])
    for got, want in ((out[0][k], batch[0][k]) for k in batch[0]):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(out[1].numpy(), batch[1])
    assert put.in_flight == 0


def test_importing_the_data_path_needs_no_optional_package():
    """`import ei_nexus_tpu_torch.data` (and the serving loop and the
    native loader) with h5py, yaml, cv2 and scipy hidden, and no JAX."""
    code = ("import sys\n"
            "for m in ('h5py', 'yaml', 'cv2', 'scipy'):\n"
            "    sys.modules[m] = None\n"
            "import ei_nexus_tpu_torch.data, ei_nexus_tpu_torch.serve, "
            "ei_nexus_tpu_torch.native, ei_nexus_tpu_torch.models.mnn\n"
            "from ei_nexus_tpu_torch.data import mvsec, ec, augment, "
            "interpolator, pipeline\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ei_nexus_tpu', 'h5py', 'yaml', "
            "'cv2', 'scipy') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# ---------------------------------------------------------------------------
# the loader-fed serving loop
# ---------------------------------------------------------------------------


class SyntheticPairs:
    """Single-mode samples of the readers' contract from (seed, index)."""

    def __init__(self, n, H, W, max_events=8192, seed=0):
        self.n, self.H, self.W = n, H, W
        self.max_events, self.seed = max_events, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from ei_nexus_tpu_torch.data.representations import pad_events
        from ei_nexus_tpu_torch.data.synth import bursty_events
        rng = np.random.default_rng([self.seed, i])
        x, y, t, p = bursty_events(rng, int(rng.integers(1000, 3000)),
                                   self.H, self.W)
        xp, yp, tp, pp, valid = pad_events(x, y, t, p, self.max_events)
        view = {"events_x": xp, "events_y": yp, "events_t": tp,
                "events_p": pp, "events_valid": valid,
                "image": rng.uniform(0, 255, (self.H, self.W, 1)).astype(
                    np.float32)}
        eye = np.eye(4, dtype=np.float32)
        return view, view, eye, eye


def test_serve_loader_on_the_cpu(monkeypatch):
    """`serve_loader` over a loader of synthetic pairs with the tiny
    flagship: every batch served (2 of 2, or `max_batches`), with the
    prefetch switch off and on; the host-only pass alike; without a
    device the card is asked for."""
    from ei_nexus_tpu_torch.flagship import build_flagship
    from ei_nexus_tpu_torch.serve import serve_host_only, serve_loader

    model, (H, W, bins) = build_flagship(tiny=True, dtype="float32",
                                         device="cpu")
    loader = tpipe.DataLoader(SyntheticPairs(5, H, W), batch_size=2,
                              num_workers=2)
    for switch in ("0", "1"):
        monkeypatch.setenv("EI_NEXUS_DEVICE_PREFETCH", switch)
        wall, pairs = serve_loader(model, loader, bins, H, W, device="cpu")
        assert pairs == 4 and wall > 0
    assert serve_loader(model, loader, bins, H, W, device="cpu",
                        max_batches=1)[1] == 2
    assert serve_host_only(loader)[1] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_loader(model, loader, bins, H, W)
