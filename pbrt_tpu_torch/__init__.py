"""pbrt_tpu_torch — the pbrt_tpu path tracer on PyTorch and CUDA.

A second package beside ``pbrt_tpu`` (the JAX reference): the same scene
parser, scene build and wavefront path integrator, written as eager
PyTorch tensor code, with the BVH traversal kernels written by hand in
CUDA C++ for Hopper (``pbrt_tpu_torch/kernels``).  Nothing here imports
JAX; host code that the reference keeps in numpy is carried over as
copies, because importing any ``pbrt_tpu`` module imports JAX.

Every device table is created on the ``device`` handed to
``render.Renderer`` and threaded down from there.  Every entry point
takes ``device="cuda"`` unless the caller asks for the CPU, and raises
where there is no card.  On CPU tensors each kernel wrapper runs its
plain PyTorch version, on CUDA tensors it launches the kernel or raises.

Float policy: float32 throughout (the reference's ``PBRT_TPU_DOUBLE``
switch is not carried over yet: ROADMAP Queue 1).

Mesh-parallel rendering (``parallel/``): one process per mesh device in a
``torch.distributed`` group, a ``DeviceMesh`` with the reference's axes
dp, sp and tp; ``parallel.mesh.ShardedRenderer`` shards pixels and
samples, ``parallel.geomshard`` shards the triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__version__ = "0.1.0"

#: numpy / torch dtypes of every "Float" quantity
float_t = np.float32
torch_float = torch.float32
EPSILON = float(np.finfo(float_t).eps)
ONE_MINUS_EPSILON = float(np.nextafter(float_t(1.0), float_t(0.0)))

PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
SQRT_2 = 1.41421356237309504880

INFINITY = float("inf")
MACHINE_EPSILON = EPSILON * 0.5


@dataclasses.dataclass
class Options:
    """Renderer options, mostly fed from the CLI's flags (the fields of
    ``pbrt_tpu.Options`` but ``mesh_shape``, which nothing reads: a mesh
    is made by ``parallel.multihost.global_mesh`` and handed to its
    user; the reference reads ``sampled_spectrum`` from
    ``PBRT_TPU_SAMPLED_SPECTRUM``, the port from the caller or the CLI's
    ``--sampled-spectrum``)."""

    quick_render: bool = False  # quarter resolution (scene build) and quarter spp (render)
    verbose: bool = False
    image_file: str = ""  # overrides the film's filename when set
    ray_batch: int = 1 << 16  # lanes per wavefront chunk
    # when set, Renderer.render saves the film state and the sweep cursor to
    # <checkpoint_dir>/film.ckpt.npz every ``checkpoint_every`` chunks and
    # resumes from it
    checkpoint_dir: str | None = None
    checkpoint_every: int = 8
    # sampled-spectrum transport (render.render_scene_spectral): the bins
    # rendered, a multiple of 3 dividing 60, three per pass
    sampled_spectrum: bool = False
    n_spectral_bins: int = 15


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises where it names a CUDA card and
    ``torch.cuda.is_available()`` is false (the port never falls back to
    the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pbrt_tpu_torch runs on a CUDA card by default, and torch.cuda.is_available() "
            "is false here; pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def gamma_correct(value):
    """sRGB gamma curve on scalars and numpy arrays (reference lib.rs:93-99)."""
    v = np.asarray(value, dtype=float_t)
    lo = 12.92 * v
    hi = 1.055 * np.power(np.maximum(v, 1e-12), 1.0 / 2.4) - 0.055
    out = np.where(v <= 0.0031308, lo, hi).astype(float_t)
    return out if out.ndim else out.item()


def inverse_gamma_correct(value):
    """Inverse of :func:`gamma_correct` (pbrt-v3 InverseGammaCorrect)."""
    v = np.asarray(value, dtype=float_t)
    lo = v / 12.92
    hi = np.power((np.maximum(v, 0.0) + 0.055) / 1.055, 2.4)
    out = np.where(v <= 0.04045, lo, hi).astype(float_t)
    return out if out.ndim else out.item()


__all__ = [
    "Options",
    "float_t",
    "torch_float",
    "EPSILON",
    "ONE_MINUS_EPSILON",
    "PI",
    "INV_PI",
    "INV_2PI",
    "INV_4PI",
    "PI_OVER_2",
    "PI_OVER_4",
    "SQRT_2",
    "INFINITY",
    "gamma_correct",
    "inverse_gamma_correct",
    "require_device",
]
