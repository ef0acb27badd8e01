"""Weights carried across from the JAX package.

Counterpart of `ei_nexus_tpu/models/port_torch.py`, in the other direction:
`load_jax_variables` takes flax variables ({"params", "batch_stats"}, as
numpy or JAX arrays, no JAX import needed) and returns the port's
state dict for the module with the same structure (the whole EIM, or any
submodule such as one extractor or LightGlue):
 - flax Dense kernels (in, out) become Linear weights (out, in);
 - conv kernels HWIO become OIHW;
 - BatchNorm scale/bias + batch_stats mean/var become weight, bias,
   running_mean, running_var; LayerNorm scale/bias become weight/bias;
 - module names carry over, with flax's numbered siblings
   (transformers_3, log_assignment_8, token_confidence_7) as torch list
   entries (transformers.3, log_assignment.8, token_confidence.7: the token
   head is a Dense named directly, not the reference's `.token.0`) and the
   FFN's ffn_0 / ffn_norm / ffn_3 as the Sequential's ffn.0 / ffn.1 /
   ffn.3. A training init's variables (every layer's assignment head and
   the token confidences) load into a model built with
   `training_heads=True`.
An `.npz` of a JAX run's checkpoint (`tools/export_jax_checkpoint.py`
writes one where JAX is installed: each leaf of `params` and
`batch_stats` under its flattened flax path, "params/event_extractor/
backbone/...") is read back into those variables by `read_jax_npz`, and
`load_jax_npz` gives its state dict.
A scanned LightGlue tree (the JAX package's `scan_layers=True`:
`layers/layer`, `log_assignment` and `token_confidence`, each leaf with a
leading (L,) axis) is unstacked onto `transformers.{i}`,
`log_assignment.{i}` and `token_confidence.{i}` first, so the port's
LightGlue built with `scan_layers=True` (or, with the token heads, with
`training_heads=True`) takes it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_NUMBERED = re.compile(r"^(transformers|log_assignment|token_confidence)_"
                       r"(\d+)$")
_FFN = {"ffn_0": "ffn.0", "ffn_norm": "ffn.1", "ffn_3": "ffn.3"}


def _walk(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _walk(sub, path + (name,))
        else:
            yield path + (name,), sub


def _module_name(name: str) -> str:
    return _FFN.get(name) or _NUMBERED.sub(r"\1.\2", name)


def _unstack(tree: Mapping[str, Any], n: int) -> list:
    """A subtree whose leaves carry a leading (n,) axis -> n subtrees."""
    parts: list = [{} for _ in range(n)]
    for k, v in tree.items():
        subs = _unstack(v, n) if isinstance(v, Mapping) else list(v[:n])
        for part, sub in zip(parts, subs):
            part[k] = sub
    return parts


def _unscan(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A scanned LightGlue's stacked subtrees as numbered siblings, at
    any depth (LightGlue may sit under matcher/lightglue)."""
    if "layers" in tree and "layer" in tree["layers"]:
        stacked = tree["layers"]["layer"]
        L = len(np.asarray(next(v for _, v in _walk(stacked))))
        out = {k: v for k, v in tree.items()
               if k not in ("layers", "log_assignment", "token_confidence")}
        for name, sub, n in (("transformers", stacked, L),
                             ("log_assignment", tree.get("log_assignment"),
                              L),
                             ("token_confidence",
                              tree.get("token_confidence"), L - 1)):
            if sub is not None:
                for i, one in enumerate(_unstack(sub, n)):
                    out[f"{name}_{i}"] = one
        return out
    return {k: _unscan(v) if isinstance(v, Mapping) else v
            for k, v in tree.items()}


def load_jax_variables(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """flax variables -> the port's state dict (float32 CPU tensors)."""
    state: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _walk(_unscan(variables.get(col, {}))):
            *mods, name = path
            arr = np.array(leaf, dtype=np.float32)  # a writable copy
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            key = ".".join([_module_name(m) for m in mods]
                           + [_LEAVES[(col, name)]])
            state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


NPZ_SEP = "/"   # joins a leaf's flax path in an exported .npz


def read_jax_npz(path: str) -> Dict[str, Any]:
    """An exported JAX checkpoint (.npz of flattened flax paths) -> its
    variables {"params": ..., "batch_stats": ...} as nested dicts of numpy
    arrays."""
    variables: Dict[str, Any] = {}
    with np.load(path) as f:
        for key in f.files:
            *mods, leaf = key.split(NPZ_SEP)
            node = variables
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = f[key]
    return variables


def load_jax_npz(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict of an exported JAX checkpoint."""
    return load_jax_variables(read_jax_npz(path))
