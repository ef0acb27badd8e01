"""MVSEC dataset: HDF5 readers and train/val pair datasets.

A copy of `ei_nexus_tpu/data/mvsec.py` (numpy on the host; h5py and yaml
imported where they are used) with its sample contract: the same sequence
splits and per-sequence crops, pose-timestamp clamping, nearest
image-depth pairing, (image_ts - dt, image_ts] event windows and relative
poses. Events stay on disk: only their timestamps are read up front, and
x/y/p are sliced per sample. Samples are fixed-size padded numpy arrays
(events to `max_events` with a validity mask); the voxel grid is built on
the device (`train/steps.py:batch_representation`).

Sample dict (per view): events_x/y/t/p (max_events,), events_valid,
image (H, W, 1) f32, depth (H, W) f32 (NaN->0), depth_mask (H, W) bool,
K (3, 3), pose (4, 4); pairs add T_0to1/T_1to0.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .interpolator import PoseInterpolator, T_to_Rt
from .augment import EventPointsAugmentation, ImageArrayAugmentation, \
    PairAugmentation, PairAugmentationEvents
from .representations import pad_events

RESOLUTION = (346, 260)  # (W, H)

TRAIN_SEQUENCES = ["indoor_flying1", "indoor_flying2", "indoor_flying3",
                   "outdoor_day2"]
VAL_SEQUENCES = ["indoor_flying4", "outdoor_day1"]

# per-sequence frame crops (reference MVSEC.py:612-623, 688-695)
SEQUENCE_CROPS = {
    "indoor_flying1": (80, -80),
    "indoor_flying2": (200, -100),
    "indoor_flying3": (120, -40),
    "indoor_flying4": (20, -40),
    "outdoor_day1": (20, -40),
    "outdoor_day2": (20, -40),
}

SCENE_OF = {
    "indoor_flying1": "indoor_flying", "indoor_flying2": "indoor_flying",
    "indoor_flying3": "indoor_flying", "indoor_flying4": "indoor_flying",
    "outdoor_day1": "outdoor_day", "outdoor_day2": "outdoor_day",
}


class MVSECArchive:
    """Raw MVSEC HDF5 access (reference MVSEC class, MVSEC.py:25).

    File layout: <root>/<scene>/<seq>_data.hdf5 (davis/left/image_raw[_ts]),
    <seq>_gt.hdf5 (davis/left/depth_image_rect[_ts], pose[_ts]),
    <seq>_rectified.h5 (davis/left/events_rect (N, 4) xytp,
    image_rect); calib yaml at <root>/<scene>_calib/.
    """

    def __init__(self, data_path: str):
        self.data_path = data_path
        self._open_files: Dict[str, Any] = {}

    def _h5(self, path: str):
        import h5py
        if path not in self._open_files:
            self._open_files[path] = h5py.File(path, "r")
        return self._open_files[path]

    def _seq_file(self, sequence: str, suffix: str):
        scene = SCENE_OF[sequence]
        return self._h5(os.path.join(self.data_path, scene,
                                     sequence + suffix))

    def get_event_datasets(self, sequence: str):
        """Lazy event access: (t (N,) in RAM, xyp h5 dataset handle)."""
        f = self._seq_file(sequence, "_rectified.h5")
        ds = f["davis"]["left"]["events_rect"]
        t = np.asarray(ds[:, 2])
        return t, ds

    def get_images(self, sequence: str) -> np.ndarray:
        f = self._seq_file(sequence, "_rectified.h5")
        return np.asarray(f["davis"]["left"]["image_rect"])

    def get_image_timestamps(self, sequence: str) -> np.ndarray:
        f = self._seq_file(sequence, "_data.hdf5")
        return np.asarray(f["davis"]["left"]["image_raw_ts"])

    def get_depth(self, sequence: str):
        f = self._seq_file(sequence, "_gt.hdf5")
        return (np.asarray(f["davis"]["left"]["depth_image_rect"]),
                np.asarray(f["davis"]["left"]["depth_image_rect_ts"]))

    def get_pose(self, sequence: str):
        f = self._seq_file(sequence, "_gt.hdf5")
        return (np.asarray(f["davis"]["left"]["pose"]),
                np.asarray(f["davis"]["left"]["pose_ts"]))

    def get_K(self, sequence: str) -> np.ndarray:
        import yaml
        scene = SCENE_OF[sequence]
        path = os.path.join(self.data_path, f"{scene}_calib",
                            f"camchain-imucam-{scene}.yaml")
        with open(path) as f:
            calib = yaml.safe_load(f)
        K = np.eye(3)
        K[[0, 1, 0, 1], [0, 1, 2, 2]] = calib["cam0"]["intrinsics"]
        return K

    def get_pose_interpolator(self, sequence: str) -> PoseInterpolator:
        pose, ts = self.get_pose(sequence)
        R, t = T_to_Rt(pose, batch=True)
        return PoseInterpolator(ts, t, R, quat_R=False)


class MVSECSequence:
    """One sequence's synchronized view: cropped depth/image pairs, lazy
    events, pose interpolator."""

    def __init__(self, archive: MVSECArchive, name: str):
        self.name = name
        self.K = archive.get_K(name)
        self.pose_interpolator = archive.get_pose_interpolator(name)
        _, pose_ts = archive.get_pose(name)
        lo, hi = float(np.min(pose_ts)), float(np.max(pose_ts))

        depth, depth_ts = archive.get_depth(name)
        images = archive.get_images(name)
        image_ts = archive.get_image_timestamps(name)
        # nearest-image pairing (reference get_paired_depth_and_image)
        nearest = np.abs(np.subtract.outer(image_ts, depth_ts)).argmin(axis=0)
        images = images[nearest]
        image_ts = image_ts[nearest]

        # clamp to pose time range, then sequence crop
        i0 = np.searchsorted(depth_ts, lo, side="right")
        i1 = np.searchsorted(depth_ts, hi, side="left")
        sl = slice(i0, i1)
        depth, depth_ts = depth[sl], depth_ts[sl]
        images, image_ts = images[sl], image_ts[sl]
        c0, c1 = SEQUENCE_CROPS.get(name, (0, None))
        sl2 = slice(c0, c1)
        if len(depth_ts[sl2]) == 0:
            # sequence shorter than its crop (e.g. truncated test data):
            # keep it uncropped instead of yielding an empty sequence
            sl2 = slice(None)
        self.depth, self.depth_ts = depth[sl2], depth_ts[sl2]
        self.images, self.image_ts = images[sl2], image_ts[sl2]

        self.events_t, self.events_xyp = archive.get_event_datasets(name)

    def __len__(self):
        return len(self.depth_ts)

    def events_window(self, timestamp: float, dt: float
                      ) -> Dict[str, np.ndarray]:
        """Events in (timestamp - dt, timestamp] (reference
        get_events_at_timestamp, MVSEC.py:723-758)."""
        i0 = np.searchsorted(self.events_t, timestamp - dt, side="left")
        i1 = np.searchsorted(self.events_t, timestamp, side="right")
        chunk = np.asarray(self.events_xyp[i0:i1])
        return {"x": chunk[:, 0], "y": chunk[:, 1],
                "t": self.events_t[i0:i1], "p": chunk[:, 3]}

    def view(self, index: int, event_dt: float,
             max_events: int) -> Dict[str, np.ndarray]:
        depth = self.depth[index].astype(np.float32)
        depth_mask = ~np.isnan(depth)
        ev = self.events_window(float(self.image_ts[index]), event_dt)
        # timestamps leave the host RELATIVE to the window's first event,
        # in f32: real MVSEC stamps are epoch-scale (~1.5e9 s) where f32
        # resolves only ~256 s, so absolute stamps would be truncated to
        # garbage by the float32 device arrays. Every representation
        # normalizes to the window, so the shift is semantics-free.
        t64 = ev["t"].astype(np.float64)
        t_rel = (t64 - (t64[0] if len(t64) else 0.0)).astype(np.float32)
        x, y, t, p, valid = pad_events(
            ev["x"].astype(np.float32), ev["y"].astype(np.float32),
            t_rel, ev["p"].astype(np.float32),
            max_events)
        pose = self.pose_interpolator.interpolate(
            float(self.depth_ts[index])).astype(np.float32)
        return {
            "events_x": x, "events_y": y, "events_t": t, "events_p": p,
            "events_valid": valid,
            "image": self.images[index].astype(np.float32)[..., None],
            "image_ts": np.float32(self.image_ts[index]),
            "depth": np.nan_to_num(depth),
            "depth_mask": depth_mask,
            "K": self.K.astype(np.float32),
            "pose": pose,
        }


def relative_pose(pose0: np.ndarray, pose1: np.ndarray) -> np.ndarray:
    """T_0to1 = pose1 @ inv(pose0) (reference get_relative_pose)."""
    return pose1 @ np.linalg.inv(pose0)


class MVSECPairDataset:
    """Unified pair dataset covering the reference's three variants:

    mode="single"      — same-time pair (data1 = data0, identity T); the
                         stage-1 distillation protocol
                         (select_matching_pair=False).
    mode="random_pair" — second view sampled <= 60 frames ahead
                         (select_matching_pair=True, MVSEC.py:897-904).
    mode="index_pairs" — (view0, view1) pairs from index files (the RPE
                         train/val protocol, MVSECDataset_RPE_*).
    """

    def __init__(self, data_path: str, sequences: Sequence[str],
                 event_dt: float = 0.4, max_events: int = 1 << 18,
                 mode: str = "single",
                 index_files: Optional[Sequence[str]] = None,
                 augment: Optional[PairAugmentationEvents] = None,
                 seed: int = 0):
        assert mode in ("single", "random_pair", "index_pairs")
        archive = MVSECArchive(data_path)
        self.sequences = [MVSECSequence(archive, s) for s in sequences]
        self.event_dt = event_dt
        self.max_events = max_events
        self.mode = mode
        self.augment = augment
        self.seed = seed
        self.epoch = 0

        if mode == "index_pairs":
            assert index_files is not None and \
                len(index_files) == len(sequences)
            self.pair_indices = [np.loadtxt(p).astype(np.int64).reshape(-1, 2)
                                 for p in index_files]
            self.lengths = np.array([len(p) for p in self.pair_indices])
        else:
            self.lengths = np.array([len(s) for s in self.sequences])
        self.cum = self.lengths.cumsum()

    def __len__(self):
        return int(self.lengths.sum())

    def set_epoch(self, epoch: int):
        """Keyed by the DataLoader each epoch: per-sample randomness is a
        pure function of (seed, epoch, index) — thread-safe and exactly
        reproducible across preemption/resume (no generator state to
        checkpoint)."""
        self.epoch = epoch

    def _sample_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, index])

    def _locate(self, index: int) -> Tuple[int, int]:
        seq_idx = int(np.searchsorted(self.cum, index, side="right"))
        if seq_idx > 0:
            index -= int(self.cum[seq_idx - 1])
        return seq_idx, index

    def __getitem__(self, index: int):
        seq_idx, local = self._locate(index)
        seq = self.sequences[seq_idx]
        if self.mode == "index_pairs":
            i0, i1 = self.pair_indices[seq_idx][local]
        elif self.mode == "random_pair":
            i0 = local
            hi = min(local + 60, len(seq))
            i1 = int(self._sample_rng(index).integers(local, hi))
        else:
            i0 = i1 = local
        data0 = seq.view(int(i0), self.event_dt, self.max_events)
        if self.mode == "single":
            if self.augment is not None:
                # pair augmentation applies only to same-time training
                # views (reference augment_pair=True path)
                data0 = self.augment(data0, rng=self._sample_rng(index))
            data1 = data0
            T01 = np.eye(4, dtype=np.float32)
            T10 = np.eye(4, dtype=np.float32)
        else:
            data1 = seq.view(int(i1), self.event_dt, self.max_events)
            T01 = relative_pose(data0["pose"], data1["pose"]).astype(
                np.float32)
            T10 = relative_pose(data1["pose"], data0["pose"]).astype(
                np.float32)
        return data0, data1, T01, T10


def fetch_mvsec_dataset(cfg: Dict[str, Any], split: str) -> MVSECPairDataset:
    """Config-driven construction (reference fetch_mvsec_dataloader).

    cfg keys: data_path, event_dt, select_matching_pair, train_on_rpe_data,
    max_events, train_sequences/val_sequences (extensions: override the
    reference's hardcoded splits, e.g. for the generated mini-MVSEC).
    """
    data_path = cfg["data_path"]
    event_dt = cfg.get("event_dt", 0.4)
    max_events = cfg.get("max_events", 1 << 18)
    train_seqs = cfg.get("train_sequences") or TRAIN_SEQUENCES
    val_seqs = cfg.get("val_sequences") or VAL_SEQUENCES
    if split == "train":
        if cfg.get("train_on_rpe_data"):
            files = [os.path.join(cfg.get("indices_dir", "."),
                                  f"{s}_final_indices.txt")
                     for s in train_seqs]
            return MVSECPairDataset(data_path, train_seqs, event_dt,
                                    max_events, mode="index_pairs",
                                    index_files=files)
        mode = ("random_pair" if cfg.get("select_matching_pair")
                else "single")
        aug = None
        pa = cfg.get("train", {}).get("pair_aug")
        if mode == "single" and pa and cfg.get("use_aug", True):
            aug = PairAugmentationEvents(
                crop_size=pa.get("crop_size", [256, 256]),
                flip_p_h=pa.get("flip_p_h", 0.5),
                flip_p_w=pa.get("flip_p_w", 0.5),
                rotate_angle=pa.get("rotate_angle", 10.0))
        return MVSECPairDataset(data_path, train_seqs, event_dt,
                                max_events, mode=mode, augment=aug)
    files = [os.path.join(cfg.get("indices_dir", "."),
                          f"{s}_final_indices.txt") for s in val_seqs]
    return MVSECPairDataset(data_path, val_seqs, event_dt, max_events,
                            mode="index_pairs", index_files=files)
