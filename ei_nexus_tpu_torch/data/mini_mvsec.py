"""Render a geometrically consistent mini-MVSEC, from a seed.

The port's copy of `tools/make_mini_mvsec.py` (that tool imports the JAX
package): a camera flying over a textured plane at MVSEC's DAVIS346 scale
(346x260, 10 fps, focal 199 px), rendered images, exact depth,
world->camera poses and DVS contrast events between frames. The scene,
the trajectory and the renderer are `data/mini_ec.py`'s (the same
numbers); this module adds MVSEC's camera and file layout.

`render_sequence` returns one sequence's arrays in memory; `write_sequence`
writes them in the reference HDF5 layout (<scene>/<seq>_data.hdf5,
<seq>_gt.hdf5, <seq>_rectified.h5) and imports h5py inside, so rendering
needs no h5py. `RenderedArchive` serves rendered sequences through the
MVSEC reader's own code (`data/mvsec.py:MVSECSequence`, its event windows
and `view`) without a file, where h5py is missing.

    python -m ei_nexus_tpu_torch.data.mini_mvsec --root data/mini_mvsec \\
        [--train-frames 220] [--val-frames 120] [--sequences indoor_flying1]

cv2 and h5py are imported inside the functions that use them.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from .mini_ec import make_texture, pixel_rays, pose_at, render
from .mvsec import SEQUENCE_CROPS, MVSECArchive

__all__ = ["make_texture", "pose_at", "render", "render_sequence",
           "sequence_files", "write_sequence", "gen_sequence",
           "write_calib", "calibration_matrix", "RenderedArchive",
           "make_mini_mvsec", "SPECS"]

# MVSEC's DAVIS346
W, H = 346, 260
FX = FY = 199.0
CX, CY = 173.0, 130.0
FPS = 10.0
SUBSTEPS = 5       # event-render substeps per frame interval
C_THRESH = 0.18    # DVS contrast threshold (log units)
T0 = 100.0         # the first frame's stamp (s)
DEPTH_NAN_ROWS = 6  # invalid band at the top of every depth map

# (scene, sequence, frames beyond --train-frames / --val-frames, phase,
# seed), the tool's: indoor_flying4 and outdoor_day1 are the stock
# two-sequence RPE protocol; the training sequences' longer renders make
# up for their crops; a texture seed a sequence
SPECS = [("indoor_flying", "indoor_flying1", "train", 0, 0.0, 10),
         ("indoor_flying", "indoor_flying2", "train", 200, 1.3, 20),
         ("indoor_flying", "indoor_flying3", "train", 60, 3.1, 30),
         ("indoor_flying", "indoor_flying4", "val", 0, 2.1, 40),
         ("outdoor_day", "outdoor_day1", "val", 0, 4.2, 70),
         ("outdoor_day", "outdoor_day2", "train", 0, 5.3, 80)]


def calibration_matrix() -> np.ndarray:
    return np.array([[FX, 0.0, CX], [0.0, FY, CY], [0.0, 0.0, 1.0]])


def render_sequence(n_frames: int, phase: float, seed: int
                    ) -> Dict[str, np.ndarray]:
    """One sequence in memory: frame_ts (n,), images (n, H, W) uint8,
    depths (n, H, W) float32, events (N, 4) [x y t p] float64 in time
    order, pose_ts and the camera->world pose_mats (MVSEC's odometry; the
    reader's interpolator inverts them back to world->camera) sampled
    beyond the frame range."""
    rng = np.random.default_rng(seed)
    tex = make_texture(rng)
    rays = pixel_rays(W, H, FX, FY, CX, CY)

    frame_ts = T0 + np.arange(n_frames) / FPS
    images = np.empty((n_frames, H, W), np.uint8)
    depths = np.empty((n_frames, H, W), np.float32)

    ev_x, ev_y, ev_t, ev_p = [], [], [], []
    log_ref = None
    sub_dt = 1.0 / (FPS * SUBSTEPS)
    for i in range(n_frames):
        img, dep = render(tex, pose_at(frame_ts[i] - T0, phase), rays)
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
        depths[i] = dep
        if i == 0:
            log_ref = np.log(img + 1.0)
            continue
        for k in range(1, SUBSTEPS + 1):
            ts = frame_ts[i - 1] + k * sub_dt
            sub_img, _ = render(tex, pose_at(ts - T0, phase), rays)
            diff = np.log(sub_img + 1.0) - log_ref
            n_ev = np.minimum(
                np.floor(np.abs(diff) / C_THRESH).astype(np.int32), 3)
            ys, xs = np.nonzero(n_ev)
            if len(ys):
                counts = n_ev[ys, xs]
                pol = diff[ys, xs] > 0
                xs_r = np.repeat(xs, counts)
                ev_x.append(xs_r.astype(np.float64))
                ev_y.append(np.repeat(ys, counts).astype(np.float64))
                ev_t.append(ts - sub_dt * rng.random(len(xs_r)))
                ev_p.append(np.repeat(pol, counts).astype(np.float64))
                log_ref[ys, xs] += np.sign(diff[ys, xs]) * counts * C_THRESH

    x, y = np.concatenate(ev_x), np.concatenate(ev_y)
    tt, p = np.concatenate(ev_t), np.concatenate(ev_p)
    order = np.argsort(tt, kind="stable")
    events = np.stack([x[order], y[order], tt[order], p[order]], 1)

    pose_ts = T0 - 0.5 + np.arange(int((n_frames / FPS + 1.0) * 25)) / 25.0
    pose_mats = np.stack([np.linalg.inv(pose_at(ts - T0, phase))
                          for ts in pose_ts])
    return {"frame_ts": frame_ts, "images": images, "depths": depths,
            "events": events, "pose_ts": pose_ts, "pose_mats": pose_mats}


def sequence_files(arrays: Mapping[str, np.ndarray]
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """What each of a sequence's HDF5 files holds, by file suffix and
    dataset path: the depth maps carry the NaN band real ground truth has,
    and their stamps sit 0.1 ms after the frames'."""
    depth = arrays["depths"].copy()
    depth[:, :DEPTH_NAN_ROWS, :] = np.nan
    return {
        "_data.hdf5": {"davis/left/image_raw_ts": arrays["frame_ts"],
                       "davis/left/image_raw": arrays["images"]},
        "_gt.hdf5": {"davis/left/depth_image_rect": depth,
                     "davis/left/depth_image_rect_ts":
                         arrays["frame_ts"] + 1e-4,
                     "davis/left/pose": arrays["pose_mats"],
                     "davis/left/pose_ts": arrays["pose_ts"]},
        "_rectified.h5": {"davis/left/events_rect": arrays["events"],
                          "davis/left/image_rect": arrays["images"]},
    }


# the datasets the tool writes gzip-compressed (level 1)
_COMPRESSED = {"image_raw", "image_rect", "depth_image_rect", "events_rect"}


def write_sequence(root: str, scene: str, seq: str,
                   arrays: Mapping[str, np.ndarray]) -> None:
    """Write `render_sequence`'s arrays as <root>/<scene>/<seq>_*.h5[df5]."""
    import h5py
    d = os.path.join(root, scene)
    os.makedirs(d, exist_ok=True)
    for suffix, datasets in sequence_files(arrays).items():
        with h5py.File(os.path.join(d, seq + suffix), "w") as f:
            for path, data in datasets.items():
                kw = (dict(compression="gzip", compression_opts=1)
                      if path.rsplit("/", 1)[1] in _COMPRESSED else {})
                f.create_dataset(path, data=data, **kw)


def gen_sequence(root: str, scene: str, seq: str, n_frames: int,
                 phase: float, seed: int, pair_gap: int = 8):
    """Render and write one sequence; returns (its event count, the frame
    stamps). `pair_gap` is unused here, as in the tool: the RPE pairs
    depend on the crop and are written by the caller."""
    arrays = render_sequence(n_frames, phase, seed)
    write_sequence(root, scene, seq, arrays)
    return len(arrays["events"]), arrays["frame_ts"]


def write_calib(root: str, scene: str) -> None:
    os.makedirs(os.path.join(root, f"{scene}_calib"), exist_ok=True)
    with open(os.path.join(root, f"{scene}_calib",
                           f"camchain-imucam-{scene}.yaml"), "w") as f:
        f.write(f"cam0:\n  intrinsics: [{FX}, {FY}, {CX}, {CY}]\n")


class RenderedArchive(MVSECArchive):
    """The MVSEC reader's archive over sequences rendered in memory
    ({name: `render_sequence`'s arrays}): each file's datasets as
    `sequence_files` lays them out, the intrinsics as `write_calib` writes
    them. `MVSECSequence(RenderedArchive(...), name)` then reads events,
    images, depth and poses as from disk."""

    def __init__(self, sequences: Mapping[str, Mapping[str, np.ndarray]]):
        super().__init__("<rendered in memory>")
        self._files = {name: sequence_files(arrays)
                       for name, arrays in sequences.items()}

    def _seq_file(self, sequence: str, suffix: str):
        left = {path.rsplit("/", 1)[1]: data
                for path, data in self._files[sequence][suffix].items()}
        return {"davis": {"left": left}}

    def get_K(self, sequence: str) -> np.ndarray:
        return calibration_matrix()


def make_mini_mvsec(root: str, train_frames: int = 220,
                    val_frames: int = 120, pair_gap: int = 8,
                    sequences: Optional[Sequence[str]] = None
                    ) -> Dict[str, int]:
    """Render `sequences` (all six by default), the RPE pair files (i,
    i + pair_gap) over each sequence's cropped frames and the scenes'
    calibration; returns the event count of each sequence."""
    specs = [s for s in SPECS if sequences is None or s[1] in sequences]
    unknown = set(sequences or ()) - {s[1] for s in SPECS}
    if unknown:
        raise ValueError(f"unknown MVSEC sequences {sorted(unknown)}")
    counts = {}
    for scene, seq, split, extra, phase, seed in specs:
        n_frames = (train_frames if split == "train" else val_frames) + extra
        counts[seq], frame_ts = gen_sequence(root, scene, seq, n_frames,
                                             phase, seed)
        c0, c1 = SEQUENCE_CROPS[seq]
        n_cropped = len(frame_ts[slice(c0, c1)])
        idx = np.arange(0, max(n_cropped - pair_gap, 1))
        pairs = np.stack([idx, np.minimum(idx + pair_gap, n_cropped - 1)],
                         1)
        np.savetxt(os.path.join(root, f"{seq}_final_indices.txt"), pairs,
                   fmt="%d")
    for scene in sorted({s[0] for s in specs}):
        write_calib(root, scene)
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="data/mini_mvsec")
    ap.add_argument("--train-frames", type=int, default=220)
    ap.add_argument("--val-frames", type=int, default=120)
    ap.add_argument("--pair-gap", type=int, default=8)
    ap.add_argument("--sequences", default=None,
                    help="comma-separated subset, e.g. indoor_flying1")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    counts = make_mini_mvsec(
        args.root, args.train_frames, args.val_frames, args.pair_gap,
        args.sequences.split(",") if args.sequences else None)
    for seq, n in counts.items():
        print(f"{seq}: {n} events")
    print(f"rendered {len(counts)} sequences in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
