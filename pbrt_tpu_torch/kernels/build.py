"""Build and load the hand-written CUDA sources in ``csrc/``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers: seconds to build, not minutes) and loaded
through ctypes.  A constant that both a source and its Python module
use is owned by the module: ``kernels/<name>.py`` lists it in
``NVCC_DEFINES`` and the source is compiled with it as a ``-D`` value.
A library is named after the hash of its source and the flags,
``build/pbrt_tpu_torch_kernels/lib<name>.<hash>.so`` at the repository
root, so a change to either rebuilds it; a build writes a
per-process temporary file and renames it into place, so concurrent
builders never load a partial file.  :func:`build` starts one ``nvcc``
per missing library, all together, and waits for them.  A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("bvh8_walk", "bvh2_walk", "bitonic", "anim_walk")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pbrt_tpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # every float op rounds on its own, as in the plain versions
    "-fmad=false", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]

build_logs: dict[str, str] = {}  # source name -> nvcc's output (ptxas lines)
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def flags(name: str) -> list[str]:
    """nvcc flags of ``csrc/<name>.cu``: NVCC_FLAGS and the ``-D`` values
    of its module's ``NVCC_DEFINES``."""
    defines = getattr(importlib.import_module(f"{__package__}.{name}"), "NVCC_DEFINES", {})
    return NVCC_FLAGS + [f"-D{k}={v}" for k, v in sorted(defines.items())]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}.{digest.hexdigest()[:8]}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is missing, all at once;
    returns the wall seconds.  Raises if any build fails."""
    t0 = time.time()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        build_logs[name], _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}.cu\n{build_logs[name]}" for name in failed))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _lock:
        if name not in _libs:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def launch_checked(lib, fn, *args) -> None:
    """Call a C launcher and raise on the CUDA error code it returns."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA launch failed: {lib.cuda_error_string(err).decode()} ({err})"
        )


def check_tensor(name, x, dtype, device, ndim) -> None:
    """Raise unless ``x`` has this dtype, device and rank and is contiguous."""
    import torch

    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")


def check_aligned(name, x) -> None:
    """Raise unless ``x`` starts on a 16-byte boundary (kernels that read
    it as 16-byte vectors need that)."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte vectors; got an unaligned tensor")
