"""EC (Event-Camera) dataset: txt/npy/png readers and train/val pair
datasets.

A copy of `ei_nexus_tpu/data/ec.py` (numpy on the host; cv2 and scipy
imported where they are used): the same train/val sequence lists,
timestamp-validity filtering, fixed [100:-100] frame crop, 0.04 s event
windows and `new_<seq>_val.txt` pair protocol, with the sample contract of
`mvsec.py`.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .interpolator import PoseInterpolator
from .augment import PairAugmentation, PairAugmentationEvents
from .representations import pad_events
from .mvsec import relative_pose

RESOLUTION = (240, 180)  # (W, H)

ALL_SEQUENCES = [
    "boxes_6dof", "boxes_rotation", "boxes_translation", "hdr_boxes",
    "poster_6dof", "poster_rotation", "poster_translation", "shapes_6dof",
    "shapes_rotation", "shapes_translation", "calibration",
]
TRAIN_SEQUENCES = ["boxes_6dof", "hdr_boxes", "poster_6dof",
                   "poster_rotation", "poster_translation", "calibration"]
VAL_SEQUENCES = ["boxes_rotation", "boxes_translation", "shapes_6dof",
                 "shapes_rotation", "shapes_translation"]


class ECArchive:
    """Raw EC access (reference EC class, EC.py:25).

    Layout: <root>/<seq>/{events_corrected.npy (N,4 txyp),
    images_corrected/*.png, images.txt, calib.txt, groundtruth.npy (N,8
    t xyz qxyzw)}.
    """

    def __init__(self, data_path: str):
        self.data_path = data_path

    def get_frame_paths(self, sequence: str) -> List[str]:
        return sorted(glob(os.path.join(self.data_path, sequence,
                                        "images_corrected", "*.png")))

    def get_frame_timestamps(self, sequence: str) -> np.ndarray:
        return np.genfromtxt(os.path.join(self.data_path, sequence,
                                          "images.txt"), usecols=[0])

    def get_events(self, sequence: str) -> Dict[str, np.ndarray]:
        ev = np.load(os.path.join(self.data_path, sequence,
                                  "events_corrected.npy"))
        return {"t": ev[:, 0], "x": ev[:, 1], "y": ev[:, 2], "p": ev[:, 3]}

    def get_calibration(self, sequence: str):
        calib = np.genfromtxt(os.path.join(self.data_path, sequence,
                                           "calib.txt"))
        K = np.array([[calib[0], 0, calib[2]], [0, calib[1], calib[3]],
                      [0, 0, 1.0]])
        return K, calib[4:]

    def get_pose_interpolator(self, sequence: str) -> PoseInterpolator:
        from scipy.spatial.transform import Rotation
        pose = np.load(os.path.join(self.data_path, sequence,
                                    "groundtruth.npy"))
        ts = pose[:, 0]
        t = pose[:, 1:4]
        R = Rotation.from_quat(pose[:, 4:]).as_matrix()
        return PoseInterpolator(ts, t, R, quat_R=False)

    def get_pose_timestamps(self, sequence: str) -> np.ndarray:
        return np.load(os.path.join(self.data_path, sequence,
                                    "groundtruth.npy"))[:, 0]


class ECSequence:
    def __init__(self, archive: ECArchive, name: str,
                 crop: Tuple[int, int] = (100, -100)):
        self.name = name
        self.K, _ = archive.get_calibration(name)
        events = archive.get_events(name)
        frame_paths = archive.get_frame_paths(name)
        frame_ts = archive.get_frame_timestamps(name)
        pose_ts = archive.get_pose_timestamps(name)
        self.pose_interpolator = archive.get_pose_interpolator(name)

        lo = max(events["t"][0], frame_ts[0], pose_ts[0])
        hi = min(events["t"][-1], frame_ts[-1], pose_ts[-1])
        valid = np.where((frame_ts >= lo) & (frame_ts <= hi))[0]
        valid_ts = frame_ts[valid]
        valid_paths = [frame_paths[i] for i in valid]
        c0, c1 = crop
        self.frame_ts = valid_ts[c0:c1]
        self.frame_paths = valid_paths[c0:c1]
        self.events = events

    def __len__(self):
        return len(self.frame_paths)

    def view(self, index: int, event_dt: float,
             max_events: int) -> Dict[str, np.ndarray]:
        import cv2
        frame = cv2.imread(self.frame_paths[index], 0)
        ts = float(self.frame_ts[index])
        i0 = np.searchsorted(self.events["t"], ts - event_dt, side="left")
        i1 = np.searchsorted(self.events["t"], ts, side="right")
        # relative-f32 timestamps: see data/mvsec.py view() — epoch-scale
        # absolute stamps would be truncated by the f32 device boundary
        t64 = self.events["t"][i0:i1].astype(np.float64)
        t_rel = (t64 - (t64[0] if len(t64) else 0.0)).astype(np.float32)
        x, y, t, p, valid = pad_events(
            self.events["x"][i0:i1].astype(np.float32),
            self.events["y"][i0:i1].astype(np.float32),
            t_rel,
            self.events["p"][i0:i1].astype(np.float32), max_events)
        pose = self.pose_interpolator.interpolate(ts).astype(np.float32)
        return {
            "events_x": x, "events_y": y, "events_t": t, "events_p": p,
            "events_valid": valid,
            "image": frame.astype(np.float32)[..., None],
            "image_ts": np.float32(ts),
            "K": self.K.astype(np.float32),
            "pose": pose,
        }


class ECPairDataset:
    """mode="single" (train, same-time) | "index_pairs" (val protocol)."""

    def __init__(self, data_path: str, sequences: Sequence[str],
                 event_dt: float = 0.04, max_events: int = 1 << 17,
                 mode: str = "single",
                 index_files: Optional[Sequence[str]] = None,
                 augment: Optional[PairAugmentationEvents] = None,
                 seed: int = 0):
        assert mode in ("single", "index_pairs")
        self.augment = augment
        archive = ECArchive(data_path)
        self.sequences = [ECSequence(archive, s) for s in sequences]
        self.event_dt = event_dt
        self.max_events = max_events
        self.mode = mode
        self.seed = seed
        self.epoch = 0
        if mode == "index_pairs":
            assert index_files is not None
            self.pair_indices = [np.loadtxt(p).astype(np.int64).reshape(-1, 2)
                                 for p in index_files]
            self.lengths = np.array([len(p) for p in self.pair_indices])
        else:
            self.lengths = np.array([len(s) for s in self.sequences])
        self.cum = self.lengths.cumsum()

    def __len__(self):
        return int(self.lengths.sum())

    def set_epoch(self, epoch: int):
        """See MVSECPairDataset.set_epoch: (seed, epoch, index)-keyed
        per-sample randomness."""
        self.epoch = epoch

    def _sample_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, index])

    def __getitem__(self, index: int):
        seq_idx = int(np.searchsorted(self.cum, index, side="right"))
        local = index - (int(self.cum[seq_idx - 1]) if seq_idx else 0)
        seq = self.sequences[seq_idx]
        if self.mode == "index_pairs":
            i0, i1 = self.pair_indices[seq_idx][local]
        else:
            i0 = i1 = local
        data0 = seq.view(int(i0), self.event_dt, self.max_events)
        if i0 == i1:
            if self.augment is not None:
                # pair aug only on same-time training views (reference
                # EC.py:295-300 augment_pair=True path)
                data0 = self.augment(data0, rng=self._sample_rng(index))
            return (data0, data0, np.eye(4, dtype=np.float32),
                    np.eye(4, dtype=np.float32))
        data1 = seq.view(int(i1), self.event_dt, self.max_events)
        T01 = relative_pose(data0["pose"], data1["pose"]).astype(np.float32)
        T10 = relative_pose(data1["pose"], data0["pose"]).astype(np.float32)
        return data0, data1, T01, T10


def fetch_ec_dataset(cfg: Dict[str, Any], split: str) -> ECPairDataset:
    data_path = cfg["data_path"]
    event_dt = cfg.get("event_dt", 0.04)
    max_events = cfg.get("max_events", 1 << 17)
    if split == "train":
        aug = None
        pa = cfg.get("train", {}).get("pair_aug")
        if pa and cfg.get("use_aug", True):
            aug = PairAugmentationEvents(
                crop_size=pa.get("crop_size", [256, 256]),
                flip_p_h=pa.get("flip_p_h", 0.5),
                flip_p_w=pa.get("flip_p_w", 0.5),
                rotate_angle=pa.get("rotate_angle", 10.0))
        return ECPairDataset(data_path, TRAIN_SEQUENCES, event_dt,
                             max_events, mode="single", augment=aug)
    files = [os.path.join(data_path, f"new_{s}_val.txt")
             for s in VAL_SEQUENCES]
    return ECPairDataset(data_path, VAL_SEQUENCES, event_dt, max_events,
                         mode="index_pairs", index_files=files)
