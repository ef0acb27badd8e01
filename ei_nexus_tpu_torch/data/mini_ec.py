"""Render a geometrically consistent mini-EC in the EC layout, from a seed.

The port's copy of `tools/make_mini_ec.py` with the parts of
`tools/make_mini_mvsec.py`'s renderer it uses (that tool imports the JAX
package, which the card's machine lacks). Same scene, same numbers: a
camera flying over a textured plane at EC scale (240x180, 25 fps, 0.04 s
event windows), DVS contrast events between frames. Per sequence a
directory with events_corrected.npy (N, 4 [t x y p]), images_corrected/
*.png + images.txt, calib.txt (fx fy cx cy + 5 zero distortion
coefficients) and groundtruth.npy (N, 8 [t x y z qx qy qz qw],
camera->world); plus the validation-pair files new_<seq>_val.txt for the
validation sequences rendered. `sequences` (`--sequences`) renders a
subset, e.g. the six training sequences alone.

    python -m ei_nexus_tpu_torch.data.mini_ec --root data/mini_ec \\
        [--frames 230] [--sequences boxes_6dof,hdr_boxes,...]

cv2 and scipy are imported inside the functions that use them.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .ec import TRAIN_SEQUENCES, VAL_SEQUENCES, ECArchive, ECSequence

# the EC camera
W, H = 240, 180
FX = FY = 150.0
CX, CY = 120.0, 90.0
FPS = 25.0
SUBSTEPS = 4       # event-render substeps per frame interval
C_THRESH = 0.22    # DVS contrast threshold (log units)
# the scene (tools/make_mini_mvsec.py)
Z0 = 3.0           # plane depth (m)
TEX = 1600         # texture side (px)
TEX_SCALE = 220.0  # texture px per world meter


def make_texture(rng: np.random.Generator) -> np.ndarray:
    """Multi-octave value noise with sharp blobs: corners at many scales."""
    import cv2
    tex = np.zeros((TEX, TEX), np.float32)
    for cells, amp in ((10, 0.9), (40, 0.65), (120, 0.45), (400, 0.25)):
        g = rng.random((cells, cells)).astype(np.float32)
        tex += amp * cv2.resize(g, (TEX, TEX),
                                interpolation=cv2.INTER_CUBIC)
    # sharp high-contrast squares -> strong corners for keypoints
    for _ in range(500):
        y, x = rng.integers(0, TEX - 24, 2)
        s = int(rng.integers(6, 22))
        tex[y:y + s, x:x + s] += rng.uniform(-1.0, 1.0)
    tex -= tex.min()
    tex /= tex.max()
    return (20.0 + 225.0 * tex).astype(np.float32)  # intensity in [20, 245]


def so3(aa: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(aa)
    if th < 1e-12:
        return np.eye(3)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def pose_at(t: float, phase: float) -> np.ndarray:
    """World->cam 4x4 at time t: smooth loops over the plane."""
    x = 0.55 * np.sin(0.55 * t + phase)
    y = 0.40 * np.cos(0.40 * t + 1.3 * phase)
    z = 0.12 * np.sin(0.23 * t + 0.4)
    rx = 0.050 * np.sin(0.33 * t + phase)
    ry = 0.050 * np.cos(0.27 * t)
    rz = 0.060 * np.sin(0.19 * t + 2 * phase)
    R = so3(np.array([rx, ry, rz]))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ np.array([x, y, z])  # t = -R c  (world->cam)
    return T


def pixel_rays(w: int = W, h: int = H, fx: float = FX, fy: float = FY,
               cx: float = CX, cy: float = CY) -> np.ndarray:
    """K^-1 (u + 0.5, v + 0.5, 1) for every pixel, (h, w, 3) float32 (the
    EC camera by default)."""
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([(u + 0.5 - cx) / fx, (v + 0.5 - cy) / fy,
                     np.ones_like(u, np.float32)], -1).astype(np.float32)


def render(tex: np.ndarray, T_w2c: np.ndarray, rays: np.ndarray):
    """(image (H, W) float32, depth (H, W) float32) at one pose."""
    import cv2
    R, t = T_w2c[:3, :3], T_w2c[:3, 3]
    d_w = rays @ R  # R^T d per pixel
    tz = float(R.T[2] @ t)
    s = (Z0 + tz) / d_w[..., 2]          # camera-frame depth (d_z = 1)
    p_w = d_w * s[..., None] - (R.T @ t)  # world hit points
    mx = (p_w[..., 0] * TEX_SCALE + TEX / 2).astype(np.float32)
    my = (p_w[..., 1] * TEX_SCALE + TEX / 2).astype(np.float32)
    img = cv2.remap(tex, mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_WRAP)
    return img, s.astype(np.float32)


def gen_sequence(root: str, seq: str, n_frames: int, phase: float,
                 seed: int) -> int:
    """Render one sequence into <root>/<seq>; returns its event count."""
    import cv2
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    tex = make_texture(rng)
    rays = pixel_rays()
    d = os.path.join(root, seq)
    os.makedirs(os.path.join(d, "images_corrected"), exist_ok=True)

    t0 = 10.0
    frame_ts = t0 + np.arange(n_frames) / FPS
    sub_dt = 1.0 / (FPS * SUBSTEPS)

    ev_x, ev_y, ev_t, ev_p = [], [], [], []
    log_ref = None
    lines = []
    for i in range(n_frames):
        img, _ = render(tex, pose_at(frame_ts[i] - t0, phase), rays)
        name = f"frame_{i:08d}.png"
        cv2.imwrite(os.path.join(d, "images_corrected", name),
                    np.clip(img, 0, 255).astype(np.uint8))
        lines.append(f"{frame_ts[i]:.9f} images_corrected/{name}")
        if i == 0:
            log_ref = np.log(img + 1.0)
            continue
        for k in range(1, SUBSTEPS + 1):
            ts = frame_ts[i - 1] + k * sub_dt
            sub_img, _ = render(tex, pose_at(ts - t0, phase), rays)
            diff = np.log(sub_img + 1.0) - log_ref
            n_ev = np.minimum(
                np.floor(np.abs(diff) / C_THRESH).astype(np.int32), 2)
            ys, xs = np.nonzero(n_ev)
            if len(ys):
                counts = n_ev[ys, xs]
                pol = diff[ys, xs] > 0
                xs_r = np.repeat(xs, counts)
                ev_x.append(xs_r)
                ev_y.append(np.repeat(ys, counts))
                ev_t.append(ts - sub_dt * rng.random(len(xs_r)))
                ev_p.append(np.repeat(pol, counts))
                log_ref[ys, xs] += np.sign(diff[ys, xs]) * counts * C_THRESH

    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    x = np.concatenate(ev_x).astype(np.float32)
    y = np.concatenate(ev_y).astype(np.float32)
    tt = np.concatenate(ev_t)
    p = np.concatenate(ev_p).astype(np.float32)
    order = np.argsort(tt, kind="stable")
    events = np.stack([tt[order].astype(np.float64), x[order], y[order],
                       p[order]], 1).astype(np.float32)
    np.save(os.path.join(d, "events_corrected.npy"), events)

    # cam->world samples beyond the frame range (the interpolator clamps);
    # the reader's PoseInterpolator inverts them back to world->cam
    pose_ts = t0 - 0.5 + np.arange(int((n_frames / FPS + 1.0) * 50)) / 50.0
    rows = []
    for ts in pose_ts:
        T_c2w = np.linalg.inv(pose_at(ts - t0, phase))
        q = Rotation.from_matrix(T_c2w[:3, :3]).as_quat()  # xyzw
        rows.append([ts, *T_c2w[:3, 3], *q])
    np.save(os.path.join(d, "groundtruth.npy"),
            np.asarray(rows, np.float64))

    with open(os.path.join(d, "calib.txt"), "w") as f:
        f.write(f"{FX} {FY} {CX} {CY} 0 0 0 0 0\n")
    return len(events)


def make_mini_ec(root: str, frames: int = 230, pair_gap: int = 6,
                 sequences: Optional[Sequence[str]] = None
                 ) -> Dict[str, int]:
    """Render `sequences` (all eleven by default; the [100:-100] crop
    leaves frames - 201 of each to the readers) and the pair files of the
    validation sequences among them. Returns the event count of each."""
    order = TRAIN_SEQUENCES + VAL_SEQUENCES
    wanted = order if sequences is None else list(sequences)
    unknown = set(wanted) - set(order)
    if unknown:
        raise ValueError(f"unknown EC sequences {sorted(unknown)}")
    counts = {}
    for si, seq in enumerate(order):   # phase and seed by position
        if seq in wanted:
            counts[seq] = gen_sequence(root, seq, frames, phase=0.7 * si,
                                       seed=100 + si)
    # pair indices address the reader's [100:-100]-cropped valid frame
    # list, measured through the reader itself
    archive = ECArchive(root)
    for seq in VAL_SEQUENCES:
        if seq not in counts:
            continue
        n_cropped = len(ECSequence(archive, seq))
        idx = np.arange(0, max(n_cropped - pair_gap, 1))
        pairs = np.stack(
            [idx, np.minimum(idx + pair_gap, n_cropped - 1)], 1)
        np.savetxt(os.path.join(root, f"new_{seq}_val.txt"), pairs,
                   fmt="%d")
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="data/mini_ec")
    ap.add_argument("--frames", type=int, default=230,
                    help="per sequence; the [100:-100] crop leaves "
                         "frames - 201")
    ap.add_argument("--pair-gap", type=int, default=6)
    ap.add_argument("--sequences", default=None,
                    help="comma-separated subset, e.g. the training "
                         "sequences: " + ",".join(TRAIN_SEQUENCES))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    counts = make_mini_ec(
        args.root, args.frames, args.pair_gap,
        args.sequences.split(",") if args.sequences else None)
    for seq, n in counts.items():
        print(f"{seq}: {args.frames} frames, {n} events")
    print(f"rendered {len(counts)} sequences in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
