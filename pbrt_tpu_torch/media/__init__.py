"""Participating media (counterpart of ``pbrt_tpu/media/__init__.py``;
pbrt-v3 ch. 11 and 15).

* :class:`HomogeneousMedium`: sigma_a, sigma_s, g; closed-form
  transmittance, distance sampling on a channel picked from the sample.
* :class:`GridDensityMedium`: a trilinear density grid; distances by
  delta tracking and transmittance by ratio tracking (pbrt-v3's
  GridDensityMedium::Sample and ::Tr), each a fixed number of trips over
  every lane with alive masks, as the reference's ``lax.scan`` loops, so
  no lane's answer depends on the others in its batch.
* Henyey-Greenstein phase function values and samples.

The tracking loops draw from :func:`make_track_rng`, a stateless stream
of (pixel, sample index, slot): the same uniforms at any batch size, bit
for bit the reference's (uint32 arithmetic carried in int64,
``core/rng.py``).

Every lane carries a medium id (-1: vacuum); crossing a surface with a
MediumInterface switches it (``integrators/volpath.py``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pbrt_tpu_torch import INV_4PI
from pbrt_tpu_torch.core.geometry import coordinate_system, fma
from pbrt_tpu_torch.core.rng import MASK32, hash_u32, mul32, u32_to_float
from pbrt_tpu_torch.core.sampling import sincos_2pi
from pbrt_tpu_torch.core.transform import Transform, apply_point

log = logging.getLogger("pbrt_tpu_torch")

_PCG_M, _PCG_A = 1664525, 1013904223
# the grid's tracking trips, as the reference's; they also fix the slots
# each trip draws (delta tracking: 0 .. 2 MAX_STEPS - 2, ratio: 0 .. MAX_STEPS - 1)
MAX_STEPS = 64


def make_track_rng(pixel_xy, sample_index, salt: int, float_t=np.float32):
    """Stateless uniform stream ``rng(slot) -> [N] float32`` for the
    tracking loops: the first output of ``pcg3d(hash(pixel), sample_index
    ^ salt << 20, slot)``.  ``salt`` separates the per-bounce distance
    and shadow streams; ``slot`` is a Python int.  The uniforms are
    float32 under either policy, capped as ``u32_to_float`` caps them
    under ``float_t`` (1.0 is reachable under the double policy, as in
    the reference's)."""
    x = pixel_xy[..., 0].long() & MASK32
    y = pixel_xy[..., 1].long() & MASK32
    pc = hash_u32(mul32(x, 0x9E3779B1) ^ ((y + 0x85EBCA77) & MASK32))
    si = (sample_index.long() & MASK32) ^ ((int(salt) << 20) & MASK32)
    # pcg3d's first round on the two lane words, shared by every slot
    v0_in = (mul32(pc, _PCG_M) + _PCG_A) & MASK32
    v1_in = (mul32(si, _PCG_M) + _PCG_A) & MASK32

    def rng(slot):
        v2 = (((int(slot) & MASK32) * _PCG_M) + _PCG_A) & MASK32
        v0 = (v0_in + mul32(v1_in, v2)) & MASK32
        v1 = (v1_in + mul32(v0, v2)) & MASK32
        v2 = (v2 + mul32(v0, v1)) & MASK32
        v0 = v0 ^ (v0 >> 16)
        v1 = v1 ^ (v1 >> 16)
        v2 = v2 ^ (v2 >> 16)
        return u32_to_float((v0 + mul32(v1, v2)) & MASK32, float_t)

    return rng


class HomogeneousMedium:
    def __init__(self, sigma_a, sigma_s, g=0.0, scale=1.0, device="cuda", float_t=np.float32):
        self.sigma_a = np.asarray(sigma_a, dtype=float_t) * scale
        self.sigma_s = np.asarray(sigma_s, dtype=float_t) * scale
        self.sigma_t = self.sigma_a + self.sigma_s
        self.g = float(g)
        self._ss = torch.as_tensor(self.sigma_s, device=device)
        self._st = torch.as_tensor(self.sigma_t, device=device)

    def transmittance(self, dist):
        """Tr along segments of length dist [N] -> [N, 3]."""
        return torch.exp(-self._st * torch.clamp(dist, 0.0, 1e7)[..., None])

    def sample_distance(self, u, t_hit):
        """(t, scattered, beta scale): the channel is picked by u * 3 and
        the rest of u samples the distance (pbrt-v3 §15.2.1)."""
        channel = torch.clamp((u * 3.0).to(torch.int64), max=2)
        u2 = u * 3.0 - channel.to(u.dtype)
        sig = self._st[channel]
        t = -torch.log(torch.clamp(1.0 - u2, min=1e-10)) / torch.clamp(sig, min=1e-10)
        scattered = t < t_hit
        t_eff = torch.minimum(t, t_hit)
        tr = torch.exp(-self._st * t_eff[..., None])
        # pdf: scatter -> mean(sigma_t Tr); pass -> mean(Tr)
        density_scatter = torch.mean(self._st * tr, dim=-1)
        density_pass = torch.mean(tr, dim=-1)
        beta_scatter = tr * self._ss / torch.clamp(density_scatter, min=1e-20)[..., None]
        beta_pass = tr / torch.clamp(density_pass, min=1e-20)[..., None]
        return t_eff, scattered, torch.where(scattered[..., None], beta_scatter, beta_pass)

    def sample(self, o, d, u, t_hit, rng):
        """A medium interaction along o + t d, t in [0, t_hit): u drives
        the first flight, ``rng`` any further ones (none here)."""
        return self.sample_distance(u, t_hit)

    def tr(self, o, d, t_max, rng):
        """Transmittance over [0, t_max) of o + t d."""
        return self.transmittance(t_max)


class GridDensityMedium(HomogeneousMedium):
    """A density grid [nz, ny, nx] over the unit cube of the medium's
    space (``world_to_medium``, a host 4x4)."""

    def __init__(self, sigma_a, sigma_s, g, density, world_to_medium, scale=1.0,
                 device="cuda", float_t=np.float32):
        super().__init__(sigma_a, sigma_s, g, scale, device, float_t)
        density = np.asarray(density, dtype=float_t)
        self.density = torch.as_tensor(density, device=device)
        # the far corners' values, gathered straight into the fused lerps
        self._flat64 = self.density.reshape(-1).double()
        self.w2m = torch.as_tensor(np.asarray(world_to_medium).astype(float_t), device=device)
        self.max_density = max(float(np.max(density)), 1e-9)
        # delta tracking needs a gray majorant: pbrt-v3 builds the grid
        # medium with a scalar sigma_t; warn and take the channel mean
        self.sigma_t_gray = float(np.mean(self.sigma_t))
        if not np.allclose(self.sigma_t, self.sigma_t[0], rtol=1e-4):
            log.warning("GridDensityMedium requires gray sigma_t for delta tracking; "
                        "using channel mean %g", self.sigma_t_gray)

    def density_at(self, p_world):
        """Trilinear density at world points [..., 3]; 0 outside the cube.
        In the points' float: float32 under the default policy, float64
        under the double policy."""
        pm = apply_point(self.w2m, p_world)
        nz, ny, nx = self.density.shape
        gx = pm[..., 0] * nx - 0.5
        gy = pm[..., 1] * ny - 0.5
        gz = pm[..., 2] * nz - 0.5
        inside = ((pm >= 0) & (pm <= 1)).all(dim=-1)
        x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, nx - 1)
        y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, ny - 1)
        z0 = torch.clamp(torch.floor(gz).to(torch.int64), 0, nz - 1)
        x1 = torch.clamp(x0 + 1, max=nx - 1)
        y1 = torch.clamp(y0 + 1, max=ny - 1)
        z1 = torch.clamp(z0 + 1, max=nz - 1)
        fx = torch.clamp(gx - x0, 0, 1)
        fy = torch.clamp(gy - y0, 0, 1)
        fz = torch.clamp(gz - z0, 0, 1)
        flat = self.density.reshape(-1)

        # the reference's compiled code fuses one product of each lerp into
        # its add: the far corner's along x, the near one's along y and z
        if pm.dtype == torch.float64:  # core.geometry.fma: two roundings
            def lerp_x_f64(z, y):
                row = (z * ny + y) * nx
                return fma(flat[row + x1], fx, flat[row + x0] * (1 - fx))

            def lerp_yz_f64(a, b, f):
                return fma(a, 1 - f, b * f)

            c0 = lerp_yz_f64(lerp_x_f64(z0, y0), lerp_x_f64(z0, y1), fy)
            c1 = lerp_yz_f64(lerp_x_f64(z1, y0), lerp_x_f64(z1, y1), fy)
            return torch.where(inside, lerp_yz_f64(c0, c1, fz), 0.0)

        # float32: one rounding, as core.geometry.fma gives it (float64
        # holds the float32 product exactly), with each factor cast once
        omfx, fx64 = 1 - fx, fx.double()

        def lerp_x(z, y):
            row = (z * ny + y) * nx
            return torch.addcmul((flat[row + x0] * omfx).double(), self._flat64[row + x1],
                                 fx64).float()

        def lerp_yz(a, b, f, omf64):
            return torch.addcmul((b * f).double(), a.double(), omf64).float()

        omfy64 = (1 - fy).double()
        c0 = lerp_yz(lerp_x(z0, y0), lerp_x(z0, y1), fy, omfy64)
        c1 = lerp_yz(lerp_x(z1, y0), lerp_x(z1, y1), fy, omfy64)
        return torch.where(inside, lerp_yz(c0, c1, fz, (1 - fz).double()), 0.0)

    @staticmethod
    def _flight(u, t, sig_bar):
        """t plus an exponential step of rate sig_bar, in t's float.  The
        reference's compiled code divides the float32 log by the constant
        as a product with its float32 reciprocal: under float32 fused into
        the add (one rounding, as in lerps); under float64 the float32
        product rounds, then widens into the float64 add."""
        lg = torch.log(torch.clamp(1.0 - u, min=1e-10))
        step = -float(np.float32(1.0) / np.float32(sig_bar))
        if t.dtype == torch.float64:
            return t + (lg * step).double()
        return torch.add(t.double(), lg.double(), alpha=step).float()

    def sample(self, o, d, u, t_hit, rng):
        """Delta tracking: exponential flights under the gray majorant
        sigma_t * max_density, each collision real with probability
        density / max_density; ``MAX_STEPS`` trips over every lane (lanes
        still tracking at the cap pass through).  u drives the first
        flight, ``rng`` slots 0 .. 2 MAX_STEPS - 2 the rest.  Directions
        are unit length."""
        sig_bar = self.sigma_t_gray * self.max_density
        inv_max_d = 1.0 / self.max_density
        t = self._flight(u, torch.zeros_like(t_hit), sig_bar)
        esc = t >= t_hit
        real = self.density_at(o + d * t[..., None]) * inv_max_d > rng(0)
        scattered = ~esc & real
        active = ~esc & ~real
        t_scat = torch.where(scattered, t, t_hit)
        for step in range(MAX_STEPS - 1):
            t_new = self._flight(rng(2 * step + 1), t, sig_bar)
            esc = t_new >= t_hit
            real = self.density_at(o + d * t_new[..., None]) * inv_max_d > rng(2 * step + 2)
            hit_real = active & ~esc & real
            scattered = scattered | hit_real
            t_scat = torch.where(hit_real, t_new, t_scat)
            active = active & ~esc & ~real
            t = torch.where(active, t_new, t)
        # a real collision weighs sigma_s / sigma_t_gray; passing, Tr/pdf = 1
        beta = torch.where(scattered[..., None], self._ss / self.sigma_t_gray, 1.0)
        return torch.minimum(t_scat, t_hit), scattered, beta

    def tr(self, o, d, t_max, rng):
        """Ratio tracking: each tentative collision scales Tr by
        1 - density / max_density (gray); ``rng`` slots 0 .. MAX_STEPS - 1."""
        sig_bar = self.sigma_t_gray * self.max_density
        inv_max_d = 1.0 / self.max_density
        t = torch.zeros_like(t_max)
        tr = torch.ones_like(t_max)
        active = torch.ones(t_max.shape, dtype=torch.bool, device=t_max.device)
        for step in range(MAX_STEPS):
            t_new = self._flight(rng(step), t, sig_bar)
            esc = t_new >= t_max
            dens = self.density_at(o + d * t_new[..., None])
            live = active & ~esc
            tr = torch.where(live, tr * (1.0 - torch.clamp(dens * inv_max_d, min=0.0)), tr)
            active = live
            t = torch.where(active, t_new, t)
        return torch.clamp(tr, 0.0, 1.0)[..., None].expand(*tr.shape, 3)


def hg_phase(cos_theta, g):
    """Henyey-Greenstein phase function value."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def hg_sample(wo, u2, g):
    """wi sampled from HG around the propagation direction -wo (pbrt-v3
    §15.2.3) -> (wi, pdf); g is a float or an [N] tensor."""
    g = torch.broadcast_to(torch.as_tensor(g, dtype=u2.dtype, device=u2.device),
                           u2.shape[:-1])
    one = torch.ones_like(g)
    small = torch.abs(g) < 1e-3
    # single roundings where the reference's compiled code fuses a product
    # into its add: cos(theta) is then bit-equal to it
    sqr = fma(-g, g, one) / torch.clamp(fma(2.0 * g, u2[..., 0], 1.0 - g), min=1e-9)
    cos_theta_hg = fma(-sqr, sqr, fma(g, g, one)) / torch.clamp(2.0 * g, min=1e-9)
    cos_theta = torch.where(small, 1.0 - 2.0 * u2[..., 0], cos_theta_hg)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(fma(-cos_theta, cos_theta, one), min=0.0))
    sphi, cphi = sincos_2pi(u2[..., 1])
    fwd = -wo
    v1, v2 = coordinate_system(fwd)
    a = (sin_theta * cphi)[..., None].expand_as(v1)
    wi = fma(cos_theta[..., None].expand_as(fwd), fwd,
             fma(a, v1, (sin_theta * sphi)[..., None] * v2))
    return wi, hg_phase(cos_theta, g)


def make_medium(name, params, device="cuda"):
    """MakeNamedMedium: ``homogeneous`` or ``heterogeneous`` (a grid of
    nx x ny x nz ``density`` values over the box p0..p1); a missing
    density or an unknown type falls back to homogeneous, logged."""
    float_t = params.float_t
    sigma_a = params.find_one_spectrum("sigma_a", np.array([1.0, 1.0, 1.0], dtype=float_t))
    sigma_s = params.find_one_spectrum("sigma_s", np.array([2.55, 3.21, 3.77], dtype=float_t))
    scale = params.find_one_float("scale", 1.0)
    g = params.find_one_float("g", 0.0)
    if name == "homogeneous":
        return HomogeneousMedium(sigma_a, sigma_s, g, scale, device, float_t)
    if name == "heterogeneous":
        nx = params.find_one_int("nx", 1)
        ny = params.find_one_int("ny", 1)
        nz = params.find_one_int("nz", 1)
        density = params.find_float("density")
        if density is None:
            log.error("heterogeneous medium missing 'density'; using homogeneous")
            return HomogeneousMedium(sigma_a, sigma_s, g, scale, device, float_t)
        grid = np.asarray(density, dtype=float_t).reshape(nz, ny, nx)
        p0 = params.find_one_point3f("p0", np.zeros(3, dtype=float_t))
        p1 = params.find_one_point3f("p1", np.ones(3, dtype=float_t))
        m2w = Transform.translate(p0) * Transform.scale(*np.maximum(p1 - p0, 1e-9))
        return GridDensityMedium(sigma_a, sigma_s, g, grid, m2w.m_inv, scale, device=device,
                                 float_t=float_t)
    log.error("Medium '%s' unknown; using homogeneous.", name)
    return HomogeneousMedium(sigma_a, sigma_s, g, scale, device, float_t)
