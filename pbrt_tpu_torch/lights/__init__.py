"""Lights, batched over wavefronts (counterpart of
``pbrt_tpu/lights/__init__.py:37-76, 246-423, 438-498``).

Contract (SoA tensors):
  sample_li(p, u2) -> (wi, Li, pdf, dist): one NEE sample toward the light
  pdf_li(p, wi)    -> solid-angle pdf of sample_li, for MIS
  le_escaped(d)    -> radiance for rays leaving the scene (infinite only)

The infinite and area lights take ``l_override``: a [3] tensor that
replaces their radiance (``theta["env_l"]`` / ``theta["area_l"]`` rows),
so that gradients reach it.

Every light of the reference is ported: point, spot, goniometric
(an intensity map over the sphere of directions) and projection (an image
projected through a perspective frustum), all delta lights; distant;
diffuse area; infinite (constant, or image-mapped and importance-sampled
through a Distribution2D).  A goniometric or projection map that cannot
be read is logged as an error and the light keeps its plain intensity,
as in the reference.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pbrt_tpu_torch import INV_2PI, INV_PI, PI, torch_dtype
from pbrt_tpu_torch.core.geometry import arccos0
from pbrt_tpu_torch.core.imageio import read_image
from pbrt_tpu_torch.core.mipmap import MIPMap
from pbrt_tpu_torch.core.sampling import (
    Distribution1D,
    Distribution2D,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from pbrt_tpu_torch.core.spectrum import promote_rgb
from pbrt_tpu_torch.core.transform import Transform, apply_point, apply_vector
from pbrt_tpu_torch.ops.tables import select_rows

log = logging.getLogger("pbrt_tpu_torch")

BIG_DIST = 1e7  # NEE distance to an infinite light


class Light:
    is_delta = False
    is_infinite = False


class PointLight(Light):
    """An isotropic point light; the delta lights below scale its
    intensity by ``_scale(wi)``."""

    is_delta = True

    def __init__(self, light_to_world: Transform, intensity, device="cuda", float_t=np.float32):
        self.intensity = np.asarray(intensity, dtype=float_t)
        self._pd = torch.as_tensor(light_to_world.apply_p(np.zeros(3), float_t), device=device)
        self._id = torch.as_tensor(self.intensity, device=device)
        self._w2l = torch.as_tensor(light_to_world.m_inv.astype(float_t), device=device)

    def power(self):
        return 4 * PI * self.intensity

    def _light_dir(self, wi):
        """The unit direction from the light toward the shaded points, in
        the light's space."""
        wl = apply_vector(self._w2l, -wi)
        return wl / torch.clamp(torch.linalg.norm(wl, dim=-1, keepdim=True), min=1e-12)

    def sample_li(self, p, u2):
        to_l = self._pd - p
        d2 = torch.sum(to_l * to_l, dim=-1)
        dist = torch.sqrt(d2)
        wi = to_l / torch.clamp(dist[..., None], min=1e-12)
        scale = self._scale(wi)
        if scale is None:
            li = self._id / torch.clamp(d2, min=1e-12)[..., None]
        else:
            li = self._id * (scale / torch.clamp(d2, min=1e-12))[..., None]
        return wi, li, torch.ones_like(dist), dist

    def _scale(self, wi):
        """The intensity's scale toward the points at wi ([N]; None: 1)."""
        return None


class SpotLight(PointLight):
    """A point light inside a cone about the light's +z, with a smooth
    (fourth-power) falloff from ``cone_angle - cone_delta`` to
    ``cone_angle`` degrees."""

    def __init__(self, light_to_world: Transform, intensity, cone_angle_deg, cone_delta_deg,
                 device="cuda", float_t=np.float32):
        super().__init__(light_to_world, intensity, device, float_t)
        self.cos_total = float(np.cos(np.deg2rad(cone_angle_deg)))
        self.cos_falloff = float(np.cos(np.deg2rad(cone_angle_deg - cone_delta_deg)))

    def power(self):
        return self.intensity * 2 * PI * (1 - 0.5 * (self.cos_falloff + self.cos_total))

    def _scale(self, wi):
        ct = self._light_dir(wi)[..., 2]
        # the reference's compiled code divides by the constant as a product
        # with its float32 reciprocal
        inv = float(np.float32(1.0) / np.float32(max(self.cos_falloff - self.cos_total, 1e-8)))
        d = torch.clamp((ct - self.cos_total) * inv, 0.0, 1.0)
        return torch.where(ct < self.cos_total, 0.0,
                           torch.where(ct > self.cos_falloff, 1.0, (d * d) * (d * d)))


def _read_map(kind, mapname, raw):
    """(MIPMap of the tint x the image, promoted once, in the tint's float;
    (width, height)), or None where the file cannot be read (logged, as in
    the reference)."""
    try:
        img, size = read_image(mapname, raw.dtype.type)
        return MIPMap(promote_rgb(np.asarray(img) * raw, illuminant=True, float_t=raw.dtype.type),
                      float_t=raw.dtype.type), size
    except (OSError, ValueError) as e:
        log.error("%s: cannot read '%s': %s", kind, mapname, e)
        return None


class GonioPhotometricLight(PointLight):
    """A point light whose intensity is scaled by a lat-long map (phi
    along s, theta from the light's +z along t), averaged over RGB."""

    def __init__(self, light_to_world: Transform, intensity, mapname: str, device="cuda",
                 float_t=np.float32):
        raw = np.asarray(intensity, dtype=float_t)
        super().__init__(light_to_world, promote_rgb(raw, illuminant=True, float_t=float_t),
                         device, float_t)
        self.mipmap = None
        got = _read_map("goniometric", mapname, raw) if mapname else None
        if got is not None:
            # the map carries the tint: the intensity becomes 1
            self.mipmap = got[0]
            self._id = torch.ones(3, dtype=torch_dtype(float_t), device=device)

    def _scale(self, wi):
        if self.mipmap is None:
            return torch.ones_like(wi[..., 0])
        wl = self._light_dir(wi)
        theta = torch.arccos(torch.clamp(wl[..., 2], -1, 1))
        phi = torch.atan2(wl[..., 1], wl[..., 0])
        phi = torch.where(phi < 0, phi + 2 * PI, phi)
        return self.mipmap.lookup(phi * INV_2PI, theta * INV_PI).mean(dim=-1)


class ProjectionLight(PointLight):
    """A point light projecting an image through a ``fov``-degree
    perspective frustum along the light's +z; black outside the image's
    screen window."""

    def __init__(self, light_to_world: Transform, intensity, mapname: str, fov_deg=45.0,
                 device="cuda", float_t=np.float32):
        raw = np.asarray(intensity, dtype=float_t)
        super().__init__(light_to_world, promote_rgb(raw, illuminant=True, float_t=float_t),
                         device, float_t)
        self.mipmap = None
        aspect = 1.0
        got = _read_map("projection", mapname, raw) if mapname else None
        if got is not None:
            self.mipmap, (w, h) = got
            self._id = torch.ones(3, dtype=torch_dtype(float_t), device=device)
            aspect = w / h
        if aspect > 1:
            self.screen = (-aspect, aspect, -1.0, 1.0)
        else:
            self.screen = (-1.0, 1.0, -1 / aspect, 1 / aspect)
        proj = Transform.perspective(fov_deg, 1e-2, 1000.0)
        self._projm = torch.as_tensor(proj.m.astype(float_t), device=device)
        self.cos_total = float(
            np.cos(np.arctan(np.tan(np.deg2rad(fov_deg) / 2) * np.hypot(1, aspect))))

    def power(self):
        return 2 * PI * (1 - self.cos_total) * self.intensity

    def _scale(self, wi):
        wl = apply_vector(self._w2l, -wi)
        ps = apply_point(self._projm, wl)
        x0, x1, y0, y1 = self.screen
        inside = ((ps[..., 0] >= x0) & (ps[..., 0] <= x1) & (ps[..., 1] >= y0)
                  & (ps[..., 1] <= y1) & ~(wl[..., 2] < 1e-3))
        if self.mipmap is None:
            return inside.to(wi.dtype)
        s = torch.clamp((ps[..., 0] - x0) / (x1 - x0), 0, 1)
        t = torch.clamp((ps[..., 1] - y0) / (y1 - y0), 0, 1)
        return torch.where(inside, self.mipmap.lookup(s, t).mean(dim=-1), 0.0)


class DistantLight(Light):
    is_delta = True

    def __init__(self, light_to_world: Transform, radiance, from_p, to_p, device="cuda",
                 float_t=np.float32):
        w = light_to_world.apply_v(np.asarray(from_p, np.float64) - np.asarray(to_p, np.float64),
                                   float_t)
        self.w_light = (w / np.linalg.norm(w)).astype(float_t)  # toward the light
        self._wd = torch.as_tensor(self.w_light, device=device)
        self._ld = torch.as_tensor(np.asarray(radiance, dtype=float_t), device=device)

    def sample_li(self, p, u2):
        n = p.shape[0]
        dist = torch.full((n,), BIG_DIST, dtype=p.dtype, device=p.device)
        return (self._wd.expand(n, 3), self._ld.expand(n, 3),
                torch.ones((n,), dtype=p.dtype, device=p.device), dist)


class InfiniteAreaLight(Light):
    """Environment light: a constant tint, or the tint times a lat-long
    map (``mapname``).  A mapped light samples a Distribution2D over
    luminance x sin(theta) and ignores ``l_override`` (its ``env_l``
    theta row gets no gradient), as the reference does."""

    is_infinite = True

    def __init__(self, light_to_world: Transform, l_rgb, mapname: str = "", device="cuda",
                 float_t=np.float32):
        self._l2wm = torch.as_tensor(light_to_world.m.astype(float_t), device=device)
        self._w2lm = torch.as_tensor(light_to_world.m_inv.astype(float_t), device=device)
        raw = np.asarray(l_rgb, dtype=float_t)  # the raw RGB tint
        self.l_rgb = promote_rgb(raw, illuminant=True, float_t=float_t)
        self._ld = torch.as_tensor(np.asarray(self.l_rgb, dtype=float_t), device=device)
        self.mipmap = None
        self.distribution = None
        if mapname:
            # as in the reference, a map that cannot be read, or whose
            # pyramid cannot be built (MIPMap raises ValueError for a
            # non-square image), leaves a constant light of the tint
            try:
                img, (w, h) = read_image(mapname, float_t)
                # (tint x map) promoted once, illuminant basis
                img = np.asarray(promote_rgb(np.asarray(img, dtype=np.float64) * raw[None, None],
                                             illuminant=True, float_t=float_t), dtype=np.float64)
                self.mipmap = MIPMap(img.astype(float_t), float_t=float_t)
                lum = 0.212671 * img[..., 0] + 0.715160 * img[..., 1] + 0.072169 * img[..., 2]
                sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)
                self.distribution = Distribution2D(lum * sin_theta[:, None], device, float_t)
            except (OSError, ValueError) as e:
                log.error("infinite light: cannot read '%s': %s", mapname, e)

    def power(self):
        if self.mipmap is None:
            return PI * self.l_rgb
        return PI * self.mipmap._flat.numpy().mean(axis=0)

    def _uv(self, d_world):
        """World direction -> lat-long (phi / 2 pi, theta / pi) [..., 2]
        and sin(theta)."""
        w = apply_vector(self._w2lm, d_world)
        w = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-12)
        theta = arccos0(w[..., 2])
        # atan2(0, 1) = atan2(0, 0), with a finite derivative
        pole = (w[..., 0] == 0.0) & (w[..., 1] == 0.0)
        phi = torch.atan2(w[..., 1], torch.where(pole, 1.0, w[..., 0]))
        phi = torch.where(phi < 0, phi + 2 * PI, phi)
        return phi * INV_2PI, theta * INV_PI, theta

    def _le_dir(self, d_world, l_override=None):
        """Radiance along world direction d (leaving the scene)."""
        if self.mipmap is None:
            ld = self._ld if l_override is None else l_override
            return torch.broadcast_to(ld, d_world.shape[:-1] + (3,))
        s, t, _ = self._uv(d_world)
        return self.mipmap.lookup(s, t)

    def le_escaped(self, d, l_override=None):
        return self._le_dir(d, l_override)

    def sample_li(self, p, u2, l_override=None):
        n = p.shape[0]
        if self.distribution is None:
            wi = apply_vector(self._l2wm, uniform_sample_sphere(u2))
            li = torch.broadcast_to(self._ld if l_override is None else l_override, (n, 3))
            pdf = torch.full((n,), 1.0 / (4 * PI), dtype=p.dtype, device=p.device)
        else:
            uv, map_pdf = self.distribution.sample_continuous(u2)
            theta = uv[..., 1] * PI
            phi = uv[..., 0] * 2 * PI
            st, ct = torch.sin(theta), torch.cos(theta)
            d_l = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
            wi = apply_vector(self._l2wm, d_l)
            li = self.mipmap.lookup(uv[..., 0], uv[..., 1])
            pdf = torch.where(st > 1e-7,
                              map_pdf / (2 * PI * PI * torch.clamp(st, min=1e-7)), 0.0)
        dist = torch.full((n,), BIG_DIST, dtype=p.dtype, device=p.device)
        return wi, li, pdf, dist

    def pdf_li(self, p, wi):
        if self.distribution is None:
            return torch.full(p.shape[:-1], 1.0 / (4 * PI), dtype=p.dtype, device=p.device)
        s, t, theta = self._uv(wi)
        st = torch.sin(theta)
        pdf = self.distribution.pdf_at(torch.stack([s, t], dim=-1))
        return torch.where(st > 1e-7, pdf / (2 * PI * PI * torch.clamp(st, min=1e-7)), 0.0)


class DiffuseAreaLight(Light):
    """Emissive triangles; NEE samples area-uniformly through a
    Distribution1D over triangle areas."""

    def __init__(self, l_emit, two_sided, tri_p0, tri_p1, tri_p2, device="cuda",
                 float_t=np.float32):
        self.l_emit = np.asarray(l_emit, dtype=float_t)
        self._ld = torch.as_tensor(self.l_emit, device=device)
        self.two_sided = bool(two_sided)
        cr = np.cross(tri_p1 - tri_p0, tri_p2 - tri_p0)
        areas = 0.5 * np.linalg.norm(cr, axis=-1)
        self.total_area = float(areas.sum())
        self.area_dist = Distribution1D(areas, device, float_t)
        n = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-12)
        # packed [T, 12] p0|p1|p2|n rows
        self._tri_cols = torch.as_tensor(
            np.concatenate([tri_p0, tri_p1, tri_p2, n], axis=1).astype(float_t),
            device=device,
        )

    def l_emitted(self, n_hit, w_out, l_override=None):
        """Radiance leaving a point with normal n_hit toward w_out."""
        ok = torch.sum(n_hit * w_out, dim=-1) > 0
        if self.two_sided:
            ok = torch.ones_like(ok)
        return torch.where(ok[..., None], self._ld if l_override is None else l_override, 0.0)

    def sample_li(self, p, u2, l_override=None):
        x, _pdf_tri, tri_idx = self.area_dist.sample_continuous(u2[..., 0])
        # the fractional part of x serves as one fresh uniform
        frac = torch.clamp(x * self.area_dist.n - tri_idx, 0.0, 0.999999)
        b = uniform_sample_triangle(torch.stack([frac, u2[..., 1]], dim=-1))
        rows = select_rows(self._tri_cols, tri_idx)
        p0, p1, p2, n_l = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
        p_l = p0 + b[..., 0:1] * (p1 - p0) + b[..., 1:2] * (p2 - p0)
        to_l = p_l - p
        d2 = torch.sum(to_l * to_l, dim=-1)
        dist = torch.sqrt(d2)
        wi = to_l / torch.clamp(dist[..., None], min=1e-12)
        cos_l = torch.sum(n_l * (-wi), dim=-1)
        cos_term = torch.abs(cos_l) if self.two_sided else torch.clamp(cos_l, min=0.0)
        pdf = d2 / torch.clamp(cos_term * self.total_area, min=1e-9)
        lit = cos_term > 1e-7
        li = torch.where(lit[..., None], self._ld if l_override is None else l_override, 0.0)
        pdf = torch.where(lit, pdf, 0.0)
        return wi, li, pdf, dist * (1.0 - 1e-3)

    def pdf_li_at_hit(self, p_ref, p_hit, n_hit, wi):
        """Solid-angle pdf that sample_li would have produced p_hit."""
        to_l = p_hit - p_ref
        d2 = torch.sum(to_l * to_l, dim=-1)
        cos_l = torch.abs(torch.sum(n_hit * (-wi), dim=-1))
        return d2 / torch.clamp(cos_l * self.total_area, min=1e-9)


def make_light(record, device="cuda"):
    """LightRecord (core/api.py) -> Light."""
    name, params, l2w = record.name, record.params, record.light_to_world
    float_t = params.float_t
    one = np.ones(3, dtype=float_t)
    kw = dict(device=device, float_t=float_t)
    if name in ("infinite", "exinfinite"):
        l_rgb = params.find_one_spectrum_raw("L", one)
        scale = params.find_one_spectrum_raw("scale", one)
        mapname = params.find_one_filename("mapname", "")
        params.find_one_int("samples", params.find_one_int("nsamples", 1))
        # the raw tint: a mapped light promotes (tint x map) once
        return InfiniteAreaLight(l2w, l_rgb * scale, mapname, **kw)
    if name == "point":
        i = promote_rgb(
            params.find_one_spectrum_raw("I", one)
            * params.find_one_spectrum_raw("scale", one),
            illuminant=True, float_t=float_t,
        )
        from_p = params.find_one_point3f("from", np.zeros(3, dtype=float_t))
        return PointLight(l2w * Transform.translate(from_p), i, **kw)
    if name == "spot":
        i = promote_rgb(
            params.find_one_spectrum_raw("I", one)
            * params.find_one_spectrum_raw("scale", one),
            illuminant=True, float_t=float_t,
        )
        cone = params.find_one_float("coneangle", 30.0)
        delta = params.find_one_float("conedeltaangle", 5.0)
        from_p = params.find_one_point3f("from", np.zeros(3, dtype=float_t))
        to_p = params.find_one_point3f("to", np.array([0, 0, 1], dtype=float_t))
        dir_ = to_p - from_p
        nrm = np.linalg.norm(dir_)
        if nrm > 1e-9:
            # the light's frame: z along the cone, x from (0, 1, 0.001) x z
            z = dir_ / nrm
            x = np.cross(np.array([0.0, 1.0, 0.001]), z)
            x /= np.linalg.norm(x)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(z, x), z, from_p
            l2w = l2w * Transform(m)
        else:
            l2w = l2w * Transform.translate(from_p)
        return SpotLight(l2w, i, cone, delta, **kw)
    if name == "distant":
        l_rgb = promote_rgb(
            params.find_one_spectrum_raw("L", one)
            * params.find_one_spectrum_raw("scale", one),
            illuminant=True, float_t=float_t,
        )
        from_p = params.find_one_point3f("from", np.zeros(3, dtype=float_t))
        to_p = params.find_one_point3f("to", np.array([0, 0, 1], dtype=float_t))
        return DistantLight(l2w, l_rgb, from_p, to_p, **kw)
    if name == "goniometric":
        i = params.find_one_spectrum_raw("I", one) * params.find_one_spectrum_raw("scale", one)
        return GonioPhotometricLight(l2w, i, params.find_one_filename("mapname", ""), **kw)
    if name == "projection":
        i = params.find_one_spectrum_raw("I", one) * params.find_one_spectrum_raw("scale", one)
        fov = params.find_one_float("fov", 45.0)
        return ProjectionLight(l2w, i, params.find_one_filename("mapname", ""), fov, **kw)
    log.warning("Light '%s' unknown.", name)
    params.report_unused()
    return None
