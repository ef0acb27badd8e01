"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` into a shared library with a plain C
interface, loaded with ctypes. The build happens at first use, on the
machine with the card, into `ei_nexus_tpu_torch/_build/` (listed in
.gitignore); a library's file name carries a digest of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
`build()` starts one `nvcc` per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# library -> its .cu source; every source includes the headers of csrc/
SOURCES = {
    "self_attention": "self_attention.cu",
    "cross_attention": "cross_attention.cu",
    "nms": "nms.cu",
    "attention_fwd": "attention_fwd.cu",
    "attention_bwd": "attention_bwd.cu",
    "qblock_attention": "qblock_attention.cu",
    "flash_segment": "flash_segment.cu",
    "linear_tf32": "linear_tf32.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures (argtypes, restype) of each library's entry points
SIGNATURES = {
    "self_attention": {
        "ei_self_attention_tf32": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P], _I),
        "ei_self_attention_sm90": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P], _I),
        "ei_attention_pack_tf32": ([_P, _I, _P, _P, _I, _I, _P], _I),
        "ei_sm90_smem_bytes": ([_I], ctypes.c_longlong),
        "ei_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
    "cross_attention": {
        "ei_cross_attention_tf32": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "ei_cross_attention_sm90": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "ei_attention_pack_tf32": ([_P, _I, _P, _P, _I, _I, _P], _I),
        "ei_sm90_smem_bytes": ([_I], ctypes.c_longlong),
        "ei_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
    "nms": {
        "ei_nms_rounds": ([_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           ctypes.POINTER(_I), _P], _I),
        "ei_nms_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
        "ei_nms_active_clusters": ([_I, _I], _I),
    },
    "attention_fwd": {
        "ei_attention_fwd_tf32": (
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
             _P], _I),
        "ei_attention_fwd_sm90": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P], _I),
        "ei_attention_pack_tf32": ([_P, _I, _P, _P, _I, _I, _P], _I),
        "ei_sm90_smem_bytes": ([_I], ctypes.c_longlong),
        "ei_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
    "attention_bwd": {
        "ei_attention_bwd_tf32": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
             _I, _P], _I),
        "ei_attention_bwd_sm90": (
            [_P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, ctypes.c_float, _I, _P], _I),
        "ei_attention_pack_tf32": ([_P, _I, _P, _P, _I, _I, _P], _I),
        "ei_bwd_sm90_smem_bytes": ([], ctypes.c_longlong),
        "ei_bwd_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
    "qblock_attention": {
        "ei_qblock_attention_tf32": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
            _I),
        "ei_qblock_attention_sm90": (
            [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
             _P], _I),
        "ei_attention_pack_tf32": ([_P, _I, _P, _P, _I, _I, _P], _I),
        "ei_sm90_smem_bytes": ([_I], ctypes.c_longlong),
        "ei_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
    "flash_segment": {
        "ei_flash_segment_tf32": (
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
            _I),
        "ei_flash_segment_sm90": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P], _I),
        "ei_attention_pack_tf32": ([_P, _I, _P, _P, _I, _I, _P], _I),
        "ei_sm90_smem_bytes": ([_I], ctypes.c_longlong),
        "ei_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
    "linear_tf32": {
        "ei_linear_tf32": (
            [_P, _L, _I, _P, _L, _I, _P, _P, _P, _L, _P, _L, _I, _I, _P], _I),
        "ei_linear_tf32_smem_bytes": ([], ctypes.c_longlong),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where library `name` is built: its file name carries a digest of
    every source and header of csrc/ and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the missing libraries, one nvcc each, all started together.
    Returns each compiled library's nvcc/ptxas log (registers, shared
    memory, spills); raises if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, with the argtypes
    and restype of its entry points declared."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def dtype_code(dtype) -> int:
    """The csrc/common.cuh DType code of a torch dtype the kernels take."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return codes[dtype]


def int64_array(values) -> ctypes.Array:
    """A C array of long long (strides) for a kernel entry point."""
    values = [int(v) for v in values]
    return (ctypes.c_longlong * len(values))(*values)


# the entry points' own codes besides CUDA's (csrc/flash_sm90.cuh and
# csrc/nms.cu kErr*)
_OWN_ERRORS = {
    -1: "the CUDA driver refused a TMA tensor map",
    -2: "the build's register count would leave setmaxnreg waiting",
    -3: "the CUDA driver has no cuTensorMapEncodeTiled",
    -4: "no thread-block cluster of kernel C fits on the card",
}


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned an error code."""
    if err in _OWN_ERRORS:
        raise RuntimeError(f"{what}: {_OWN_ERRORS[err]} (error {err})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
