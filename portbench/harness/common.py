"""What every cell shares: the run's environment and caches, the device
check, TF32, the seeded weights and the registry that finds a cell's
configuration, traffic mix and metric readers by name."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent      # portbench/
ROOT = BENCH.parent                                  # the checkout
# module names whose presence after the window makes a run void: the JAX
# stack and the JAX package, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "ei_nexus_tpu")


def prepare_environment() -> None:
    """Keep every cache of the run inside the checkout, at fixed paths,
    and keep libraries from loading JAX. The port builds its kernels into
    `ei_nexus_tpu_torch/_build/` of the checkout by itself."""
    cache = BENCH / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def set_tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, config: Optional[str] = None) -> Dict[str, Any]:
    """A cell by name: its workload file with its configuration (or
    `config` in its place) and traffic mix resolved (`config`, `traffic`
    become the loaded files)."""
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    cell["name"] = name
    cell["config_name"] = config or cell["config"]
    cell["traffic_name"] = cell["traffic"]
    cell["config"] = load_json(BENCH / "configs"
                               / f"{cell['config_name']}.json")
    cell["traffic"] = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell


def load_module(path: Path, name: str):
    """Import one file of the benchmark by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of a per-layer metric: `metrics/<name>.py`'s `read`."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_")).read


def reference_module(config_name: str):
    """The plain reference of a configuration: `reference/<name>.py`."""
    return load_module(BENCH / "reference" / f"{config_name}.py",
                       "portbench_reference_" + config_name)


def apply_overrides(d: Dict[str, Any], overrides: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """A deep copy of `d` with dotted-key overrides applied."""
    out = json.loads(json.dumps(d))
    for key, value in overrides.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def init_weights(model, seed: int, device) -> Dict[str, Any]:
    """Seeded weights for `model`, drawn on `device` in one call: every
    convolution kernel He-normal (std sqrt(2 / fan_in): ReLU follows each),
    every linear kernel LeCun-normal (std sqrt(1 / fan_in)), the rotary
    projection `posenc.Wr` normal with std 1 (LightGlue's own init);
    biases 0, norm scales 1, BatchNorm running mean 0 and variance 1.
    Returns the state dict (the model's own tensors)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = model.state_dict()
    kernels = [(k, v) for k, v in sd.items()
               if k.endswith("weight") and v.ndim >= 2]
    total = sum(v.numel() for _, v in kernels)
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for k, v in kernels:
            n = v.numel()
            fan_in = v[0].numel()
            if k.endswith("posenc.Wr.weight"):
                std = 1.0
            elif v.ndim == 4:
                std = math.sqrt(2.0 / fan_in)
            else:
                std = math.sqrt(1.0 / fan_in)
            v.copy_(flat[off:off + n].view_as(v) * std)
            off += n
        for k, v in sd.items():
            if k.endswith("weight") and v.ndim >= 2:
                continue
            if k.endswith(("running_var", "weight")):
                v.fill_(1.0)
            elif v.is_floating_point():
                v.zero_()
    return sd


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams drawn from one run seed (any non-negative
    integer): the weights, the traffic pool, the random slot fill, the
    choice of outputs to check, and the host generators the port's
    `setup` seeds."""
    import numpy as np
    children = np.random.SeedSequence(seed).spawn(5)
    names = ("weights", "pool", "fill", "check", "host")
    return {n: int(c.generate_state(1)[0]) for n, c in zip(names, children)}


def tiny_cell(name: str, config: Optional[str] = None) -> Dict[str, Any]:
    """A cell at the CPU tests' size, optionally with another
    configuration in its place: the configuration's and traffic mix's
    `tiny` overrides applied (widths kept where the tests can hold them;
    never a benchmark size)."""
    cell = load_cell(name, config)
    cell["config"] = apply_overrides(cell["config"], cell["config"]["tiny"])
    cell["traffic"] = apply_overrides(cell["traffic"],
                                      cell["traffic"]["tiny"])
    return cell
