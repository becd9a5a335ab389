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

Float policy: float32 by default; ``Options(double=True)`` (the CLI's
``--double``, the reference's ``PBRT_TPU_DOUBLE=1``) makes every "Float"
quantity float64: parsed parameters, host tessellation, the scene's
tables, the film and the gradients.  The policy is an argument, like the
device: ``float_type(double)`` gives the numpy type, which the API
hands to every ``ParamSet`` it makes and the builder to every table;
device code takes its dtype from the tables it reads.  Where the
reference keeps float32 under x64 the port keeps it too: the sample
values, the BVH walk tables and the rays handed to the walk kernels
(their t comes back float32).

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


def float_type(double: bool = False):
    """The numpy type of every "Float" quantity: float64 under the double
    policy (the reference's ``PBRT_TPU_DOUBLE=1``), else float32."""
    return np.float64 if double else np.float32


def torch_dtype(float_t) -> torch.dtype:
    """The torch dtype of the numpy float type ``float_t``."""
    return torch.float64 if np.dtype(float_t) == np.float64 else torch.float32


def epsilon(float_t=np.float32) -> float:
    """Machine epsilon of ``float_t``."""
    return float(np.finfo(float_t).eps)


def one_minus_epsilon(float_t=np.float32) -> float:
    """The largest ``float_t`` below 1."""
    return float(np.nextafter(float_t(1.0), float_t(0.0)))


def machine_epsilon(float_t=np.float32) -> float:
    """Half of ``epsilon``: the unit roundoff of pbrt's error bounds."""
    return epsilon(float_t) * 0.5


def gamma_n(n: int, float_t=np.float32) -> float:
    """pbrt's conservative floating-point error bound gamma(n) under the
    policy's float ``float_t`` (``pbrt_tpu/__init__.py:81-84``)."""
    eps = machine_epsilon(float_t)
    return (n * eps) / (1 - n * eps)


PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
SQRT_2 = 1.41421356237309504880

INFINITY = float("inf")


@dataclasses.dataclass
class Options:
    """Renderer options, mostly fed from the CLI's flags (the fields of
    ``pbrt_tpu.Options`` but ``mesh_shape``, which nothing reads: a mesh
    is made by ``parallel.multihost.global_mesh`` and handed to its
    user; the reference reads ``sampled_spectrum`` from
    ``PBRT_TPU_SAMPLED_SPECTRUM`` and the float policy from
    ``PBRT_TPU_DOUBLE``, the port both from the caller or the CLI's
    ``--sampled-spectrum`` and ``--double``)."""

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
    # the float64 policy (``float_type``): the reference's PBRT_TPU_DOUBLE=1
    double: bool = False


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
    """sRGB gamma curve on scalars and numpy arrays (reference lib.rs:93-99),
    in float32: it only feeds 8-bit output."""
    v = np.asarray(value, dtype=np.float32)
    lo = 12.92 * v
    hi = 1.055 * np.power(np.maximum(v, 1e-12), 1.0 / 2.4) - 0.055
    out = np.where(v <= 0.0031308, lo, hi).astype(np.float32)
    return out if out.ndim else out.item()


def inverse_gamma_correct(value, float_t=np.float32):
    """Inverse of :func:`gamma_correct` (pbrt-v3 InverseGammaCorrect), in
    the policy's float ``float_t``."""
    v = np.asarray(value, dtype=float_t)
    lo = v / 12.92
    hi = np.power((np.maximum(v, 0.0) + 0.055) / 1.055, 2.4)
    out = np.where(v <= 0.04045, lo, hi).astype(float_t)
    return out if out.ndim else out.item()


def clamp(val, low, high):
    """``val`` clamped to [low, high] (reference src/lib.rs:115-126)."""
    if val < low:
        return low
    if val > high:
        return high
    return val


def lerp(t, v1, v2):
    """Linear interpolation (reference src/lib.rs:139-141)."""
    return (1.0 - t) * v1 + t * v2


def quadratic(a, b, c, float_t=np.float32):
    """Roots of a x^2 + b x + c in float64 by the stable (Citardauq) form,
    each rounded to the policy's float ``float_t``: None, or (t0, t1)
    with t0 <= t1 (reference src/lib.rs:181-203)."""
    a, b, c = float(a), float(b), float(c)
    discrim = b * b - 4.0 * a * c
    if discrim < 0.0:
        return None
    root_discrim = discrim ** 0.5
    q = -0.5 * (b - root_discrim) if b < 0.0 else -0.5 * (b + root_discrim)
    t0 = float_t(q / a).item() if a != 0 else float("inf")
    t1 = float_t(c / q).item() if q != 0 else float("inf")
    if t0 > t1:
        t0, t1 = t1, t0
    return (t0, t1)


__all__ = [
    "Options",
    "float_type",
    "torch_dtype",
    "epsilon",
    "one_minus_epsilon",
    "machine_epsilon",
    "gamma_n",
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
    "clamp",
    "lerp",
    "quadratic",
    "require_device",
]
