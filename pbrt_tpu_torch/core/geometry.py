"""Geometry: host integer/float 2D bounds (copies of
``pbrt_tpu/core/geometry.py``) and batched vector math on ``[..., 3]``
tensors, with a square root and an arccos whose derivatives stay finite
at the ends of their domains, and a single-rounding multiply-add."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Bounds2i:
    """Integer 2D bounds [p_min, p_max); row-major pixel order."""

    p_min: Tuple[int, int]
    p_max: Tuple[int, int]

    def diagonal(self) -> Tuple[int, int]:
        return (self.p_max[0] - self.p_min[0], self.p_max[1] - self.p_min[1])

    def area(self) -> int:
        d = self.diagonal()
        return d[0] * d[1]

    @property
    def width(self) -> int:
        return self.p_max[0] - self.p_min[0]

    @property
    def height(self) -> int:
        return self.p_max[1] - self.p_min[1]

    def offsets(self) -> np.ndarray:
        """All pixel coordinates as an [N, 2] int array, row-major."""
        gx, gy = np.meshgrid(np.arange(self.p_min[0], self.p_max[0]),
                             np.arange(self.p_min[1], self.p_max[1]))
        return np.stack([gx.ravel(), gy.ravel()], axis=-1)


@dataclasses.dataclass(frozen=True)
class Bounds2f:
    p_min: Tuple[float, float]
    p_max: Tuple[float, float]

    @staticmethod
    def from_points(p0, p1) -> "Bounds2f":
        return Bounds2f(
            (min(p0[0], p1[0]), min(p0[1], p1[1])),
            (max(p0[0], p1[0]), max(p0[1], p1[1])),
        )


def fma(x, y, z):
    """x * y + z where the reference's compiled CPU code fuses it: on
    float32 tensors with one rounding (float64 holds the float32 product
    exactly); where an operand is float64 (the double policy) with two,
    for float64 has no wider type here (PyTorch has no fused multiply-add)."""
    if torch.float64 in (x.dtype, y.dtype, z.dtype):
        return x * y + z
    return (x.double() * y.double() + z.double()).float()


def vdot(a, b):
    return torch.sum(a * b, dim=-1)


def vface_forward(n, v):
    """Flip n to lie in the hemisphere of v."""
    return torch.where(vdot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1):
    """Orthonormal basis (v2, v3) around unit v1, branchless (Duff et al.
    2017), op for op as the reference."""
    sign = torch.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack(
        [1.0 + sign * v1[..., 0] * v1[..., 0] * a, sign * b, -sign * v1[..., 0]],
        dim=-1,
    )
    v3 = torch.stack([b, sign + v1[..., 1] * v1[..., 1] * a, -v1[..., 1]], dim=-1)
    return v2, v3


def shading_frame(si, wo):
    """Face-forwarded shading frame (ns, ss, ts).  Curve lanes (``si["tang"]``
    non-zero) align ss (local x) with the fiber tangent, the frame the hair
    BSDF needs; other lanes keep the default basis.  ``tang`` is present
    only in scenes with curves."""
    ns = vface_forward(si["ns"], wo)
    ss, ts = coordinate_system(ns)
    tang = si.get("tang")
    if tang is not None:
        t_perp = tang - torch.sum(tang * ns, dim=-1, keepdim=True) * ns
        t_len = torch.linalg.norm(t_perp, dim=-1, keepdim=True)
        use = ((torch.sum(tang * tang, dim=-1) > 1e-12) & (t_len[..., 0] > 1e-9))[..., None]
        ss = torch.where(use, t_perp / torch.clamp(t_len, min=1e-12), ss)
        ts = torch.where(use, torch.linalg.cross(ns, ss), ts)
    return ns, ss, ts


class _Sqrt0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(torch.clamp(x, min=0.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        pos = y > 0.0
        return torch.where(pos, g / (2.0 * torch.where(pos, y, 1.0)), 0.0)


class _Arccos0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = torch.clamp(x, -1.0, 1.0)
        ctx.save_for_backward(x)
        return torch.arccos(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inner = torch.abs(x) < 1.0
        return torch.where(inner, -g / torch.sqrt(torch.where(inner, 1.0 - x * x, 1.0)), 0.0)


def sqrt0(x):
    """sqrt(max(x, 0)) whose derivative is 0 where the root is 0 (and
    below), instead of infinite.  The value is torch's.  Lanes that a
    select masks out get a zero cotangent, and at a zero root torch's
    derivative turns it into 0 x inf = NaN; the reference's ``jnp.sqrt(
    jnp.maximum(0, x))`` does the same, and its gradient leaf is NaN."""
    return _Sqrt0.apply(x)


def arccos0(x):
    """arccos(clamp(x, -1, 1)) whose derivative is 0 at x = +-1 (and
    beyond), instead of infinite: as :func:`sqrt0`, for masked lanes."""
    return _Arccos0.apply(x)
