"""Procedural noise textures: fbm, wrinkled, windy, marble and dots
(counterpart of ``pbrt_tpu/textures/noise.py``).

The noise is the reference's hash-based gradient noise: lattice
gradients come from the pcg3d hash of the cell's integer corner (uint32
carried in int64, ``core/rng.py``) instead of pbrt's permutation table,
with pbrt-v3's gradient choice and smootherstep weights.  The
multiply-adds of the weights, the octave sums and marble's sine argument
are single roundings (``core/geometry.fma``), as the reference's compiled
CPU code fuses them; without that, one lane in 2048 of a 5-octave fbm
and 28 of marble's leave rtol 1e-5 / atol 1e-6 of the reference
(``scripts/noise_rounding.py``).  The trilinear lerps stay plain
float32, which moves no lane past that tolerance.  As in the
reference, ``fbm``, ``wrinkled`` and ``windy`` give [N] even where they
are declared spectrum textures.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.geometry import fma
from pbrt_tpu_torch.core.rng import MASK32, hash_u32, mul32, pcg3d, u32_to_float


def _grad(ix, iy, iz, dx, dy, dz):
    h = pcg3d(ix & MASK32, iy & MASK32, iz & MASK32)[0] & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1).bool(), -u, u)
    v = torch.where((h & 2).bool(), -v, v)
    return u + v


def _noise_weight(t):
    """6 t^5 - 15 t^4 + 10 t^3."""
    t3 = t * t * t
    t4 = t3 * t
    return fma(t3, torch.full_like(t, 10.0), fma(6.0 * t4, t, -15.0 * t4))


def _lerp(a, b, w):
    return a + w * (b - a)


def noise3(p):
    """Gradient noise at [..., 3] points; roughly in [-1, 1]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ix, iy, iz = torch.floor(x), torch.floor(y), torch.floor(z)
    dx, dy, dz = x - ix, y - iy, z - iz
    ixi, iyi, izi = (c.to(torch.int32).to(torch.int64) for c in (ix, iy, iz))

    def g(ox, oy, oz):
        return _grad(ixi + ox, iyi + oy, izi + oz, dx - ox, dy - oy, dz - oz)

    w000, w100, w010, w110 = g(0, 0, 0), g(1, 0, 0), g(0, 1, 0), g(1, 1, 0)
    w001, w101, w011, w111 = g(0, 0, 1), g(1, 0, 1), g(0, 1, 1), g(1, 1, 1)
    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    y0 = _lerp(_lerp(w000, w100, wx), _lerp(w010, w110, wx), wy)
    y1 = _lerp(_lerp(w001, w101, wx), _lerp(w011, w111, wx), wy)
    return _lerp(y0, y1, wz)


def _octaves(p, omega, octaves, scale, fn):
    """sum_k omega^k fn(noise3(p * scale * 1.99^k)).  The reference's
    compiled code folds the constant product scale * 1.99^k (rounded to
    float32) before it meets p, and fuses each octave's add."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(int(octaves)):
        n = fn(noise3(p * float(np.float32(np.float32(scale) * np.float32(lam)))))
        total = fma(n, torch.full_like(n, o), total)
        lam *= 1.99
        o *= omega
    return total


def fbm(p, omega=0.5, octaves=8, scale=1.0):
    """Fractional Brownian motion of the points ``p * scale``."""
    return _octaves(p, omega, octaves, scale, lambda n: n)


def turbulence(p, omega=0.5, octaves=8, scale=1.0):
    """A sum of absolute noise octaves of the points ``p * scale``."""
    return _octaves(p, omega, octaves, scale, torch.abs)


class FBmTexture:
    def __init__(self, mapping3d, octaves=8, roughness=0.5):
        self.mapping = mapping3d
        self.octaves = int(octaves)
        self.roughness = float(roughness)

    def eval(self, si):
        return fbm(self.mapping.map(si), self.roughness, self.octaves)


class WrinkledTexture(FBmTexture):
    def eval(self, si):
        return turbulence(self.mapping.map(si), self.roughness, self.octaves)


class WindyTexture:
    """Windy waves: |fbm(0.1 p)| * fbm(p)."""

    def __init__(self, mapping3d):
        self.mapping = mapping3d

    def eval(self, si):
        p = self.mapping.map(si)
        return torch.abs(fbm(p, 0.5, 3, scale=0.1)) * fbm(p, 0.5, 6)


class MarbleTexture:
    """Sine-perturbed fbm through the reference's spline palette."""

    _C = np.array([[0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
                   [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
                   [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6]])

    def __init__(self, mapping3d, octaves=8, roughness=0.5, scale=1.0, variation=0.2,
                 float_t=np.float32):
        self.mapping = mapping3d
        self.palette = self._C.astype(float_t)
        self.octaves = int(octaves)
        self.roughness = float(roughness)
        self.scale = float(scale)
        self.variation = float(variation)

    def eval(self, si):
        p = self.mapping.map(si)
        marble = self.variation * fbm(p, self.roughness, self.octaves, scale=self.scale)
        y = p[..., 1] * self.scale
        t = 0.5 + 0.5 * torch.sin(fma(y, torch.full_like(y, self.scale), marble))
        pal = torch.as_tensor(self.palette, device=p.device)
        nc = pal.shape[0]
        f = torch.clamp(t, 0.0, 1.0) * (nc - 3)
        i = torch.clamp(torch.floor(f).to(torch.int32), 0, nc - 4).long()
        u = (f - i)[..., None]
        c0, c1, c2, c3 = pal[i], pal[i + 1], pal[i + 2], pal[i + 3]
        s0 = (1 - u) * c1 + u * c2
        s1 = (1 - u) * ((1 - u) * c0 + u * c1) + u * ((1 - u) * c1 + u * c2)
        s2 = (1 - u) * ((1 - u) * c1 + u * c2) + u * ((1 - u) * c2 + u * c3)
        # the reference's expression, its zero term included (same bits)
        return 1.5 * ((1 - u) * s1 + u * s2) * 0.5 + 0.25 * s0 * 0.0


class DotsTexture:
    """Polka dots: ``inside`` where the hashed dot of the (s, t) cell
    covers the point, else ``outside``."""

    def __init__(self, mapping, inside_tex, outside_tex):
        self.mapping = mapping
        self.inside = inside_tex
        self.outside = outside_tex

    def eval(self, si):
        s, t = self.mapping.map(si)
        s_cell = torch.floor(s + 0.5).to(torch.int32).to(torch.int64)
        t_cell = torch.floor(t + 0.5).to(torch.int32).to(torch.int64)
        key = mul32(s_cell & MASK32, 9973) ^ (t_cell & MASK32)
        has_dot = u32_to_float(hash_u32(key)) < 0.5
        cs = s_cell + (u32_to_float(hash_u32((key + 1) & MASK32)) - 0.5) * 0.5
        ct = t_cell + (u32_to_float(hash_u32((key + 2) & MASK32)) - 0.5) * 0.5
        radius = 0.35
        ds, dt = s - cs, t - ct
        inside = has_dot & (ds * ds + dt * dt < radius * radius)
        vi = self.inside.eval(si)
        vo = self.outside.eval(si)
        if vi.dim() > inside.dim():
            inside = inside[..., None]
        return torch.where(inside, vi, vo)
