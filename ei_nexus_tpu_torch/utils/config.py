"""Hydra-class YAML config system: group composition + interpolation.

A copy of `ei_nexus_tpu/utils/config.py` (host code): configs/train_*.yaml
with `defaults: [dataset: x, model: y, train: z]` composition and
`${a.b.c}` interpolation, without the hydra dependency. yaml is imported
where it is used.

Features:
 - `Config`: dict wrapper with attribute access, deep merge, dot-path get;
 - `load_config(path, overrides)`: reads a root YAML, resolves its
   `defaults` list against sibling group directories (dataset/, model/,
   train/), applies `key=value` dotlist overrides, then resolves `${...}`
   interpolations recursively.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Mapping, Optional, Sequence

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Nested dict with attribute access (read) and deep utilities."""

    def __getattr__(self, key: str) -> Any:
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) \
            else v

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> Dict[str, Any]:
        def conv(v):
            if isinstance(v, Mapping):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v
        return conv(self)


def deep_merge(base: Dict, update: Mapping) -> Dict:
    """Recursively merge `update` into `base` (update wins)."""
    for k, v in update.items():
        if (k in base and isinstance(base[k], dict)
                and isinstance(v, Mapping)):
            deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _parse_value(text: str) -> Any:
    import yaml
    v = yaml.safe_load(text)
    if isinstance(v, str) and re.fullmatch(
            r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+", v):
        # YAML 1.1 only floats "5.0e-4", not "5e-4" — a CLI override like
        # train.optimizer.lr=5e-4 would silently become a STRING and blow
        # up deep inside the LR schedule. Coerce plain scientific notation
        # (and nothing else: "2024_01" must stay a string).
        return float(v)
    return v


def apply_overrides(cfg: Dict, overrides: Sequence[str]) -> Dict:
    """Apply `a.b.c=value` dotlist overrides (Hydra CLI style)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return cfg


def _resolve_interpolations(cfg: Dict) -> Dict:
    root = Config(cfg)

    def resolve(v, depth=0):
        if depth > 10:
            raise ValueError("interpolation depth exceeded (cycle?)")
        if isinstance(v, str):
            m = _INTERP.fullmatch(v)
            if m:  # whole-value interpolation keeps the referent's type
                ref = root.get_path(m.group(1))
                if ref is None:
                    raise KeyError(f"unresolvable interpolation {v!r}")
                return resolve(ref, depth + 1)
            def sub(match):
                ref = root.get_path(match.group(1))
                if ref is None:
                    raise KeyError(
                        f"unresolvable interpolation {match.group(0)!r}")
                return str(resolve(ref, depth + 1))
            return _INTERP.sub(sub, v)
        if isinstance(v, dict):
            return {k: resolve(x, depth) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve(x, depth) for x in v]
        return v

    return resolve(cfg)


def load_config(path: str, overrides: Optional[Sequence[str]] = None
                ) -> Config:
    """Load a root config YAML, composing its `defaults` group entries.

    `defaults:` entries are either `group: name` mappings (resolved to
    <config_dir>/<group>/<name>.yaml, merged under key <group>) or `_self_`.

    Hydra-class GROUP overrides are supported on the CLI: an override
    `group=name` whose key is a top-level defaults group and for which
    <config_dir>/<group>/<name>.yaml exists RE-SELECTS that group file
    (replacing the composed group contents), e.g. `model=SiLKMatcher`.
    Dotted `key=value` overrides apply afterwards as plain value edits.
    """
    import yaml
    path = os.path.abspath(path)
    cfg_dir = os.path.dirname(path)
    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    # split hydra-style group re-selections from plain dotlist overrides
    group_sel: Dict[str, str] = {}
    dot_overrides = []
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        if ("." not in key
                and os.path.isfile(os.path.join(cfg_dir, key,
                                                f"{val}.yaml"))):
            group_sel[key] = val
        else:
            dot_overrides.append(ov)

    cfg: Dict[str, Any] = {}
    defaults = raw.pop("defaults", [])
    for entry in defaults:
        if entry == "_self_":
            deep_merge(cfg, raw)
            raw = {}
            continue
        if isinstance(entry, str):
            sub_path = os.path.join(cfg_dir, entry + ".yaml")
            with open(sub_path) as f:
                deep_merge(cfg, yaml.safe_load(f) or {})
            continue
        for group, name in entry.items():
            name = group_sel.pop(group, name)
            sub_path = os.path.join(cfg_dir, group, f"{name}.yaml")
            with open(sub_path) as f:
                sub = yaml.safe_load(f) or {}
            cfg[group] = {}  # group re-selection replaces, never merges
            deep_merge(cfg[group], sub)
    # group overrides naming groups absent from defaults: load them fresh
    for group, name in group_sel.items():
        with open(os.path.join(cfg_dir, group, f"{name}.yaml")) as f:
            cfg[group] = yaml.safe_load(f) or {}
    deep_merge(cfg, raw)  # root file wins unless _self_ placed earlier

    if dot_overrides:
        apply_overrides(cfg, dot_overrides)
    return Config(_resolve_interpolations(cfg))


def save_config(cfg: Mapping, path: str) -> None:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(Config(cfg).to_dict() if isinstance(cfg, Config)
                       else dict(cfg), f, sort_keys=False)
