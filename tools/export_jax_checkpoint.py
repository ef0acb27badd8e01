#!/usr/bin/env python
"""Export a JAX run's orbax checkpoint to an .npz that the PyTorch port
reads.

    python tools/export_jax_checkpoint.py runs/<run>/checkpoints/final \
        final.npz

Run it where JAX and orbax are installed (the checkpoint is restored on
the CPU). The .npz holds every leaf of the checkpoint's `params` and
`batch_stats` under its flattened flax path joined by "/"
("params/event_extractor/backbone/l1_0/conv/kernel"); the optimizer state,
step and epoch are left out. The port's `train/checkpoint.py:
restore_any_checkpoint` and the `--ckpt` of its tools read the file back
through `models/port_jax.py:load_jax_npz` and load it with `strict=True`.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections.abc import Mapping

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEP = "/"   # ei_nexus_tpu_torch/models/port_jax.py:NPZ_SEP


def flatten(tree, prefix: str = ""):
    """{flattened path: numpy leaf} of a nested dict of arrays."""
    out = {}
    for name, sub in tree.items():
        path = f"{prefix}{SEP}{name}" if prefix else str(name)
        if isinstance(sub, Mapping):
            out.update(flatten(sub, path))
        else:
            out[path] = np.asarray(sub)
    return out


def export(ckpt: str, out: str) -> dict:
    """Write `ckpt`'s params and batch_stats to `out`; returns the
    flattened leaves."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ei_nexus_tpu.train.checkpoint import _restore_raw

    raw = _restore_raw(ckpt)
    leaves = flatten({col: raw[col] for col in ("params", "batch_stats")
                      if raw.get(col)})
    np.savez(out, **leaves)
    return leaves


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt", help="an orbax checkpoint directory of a JAX run")
    p.add_argument("out", help="the .npz to write")
    args = p.parse_args(argv)
    leaves = export(args.ckpt, args.out)
    n = sum(v.size for v in leaves.values())
    print(f"wrote {len(leaves)} arrays ({n} values) to {args.out}")


if __name__ == "__main__":
    main()
