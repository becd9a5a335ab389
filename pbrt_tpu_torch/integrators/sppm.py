"""Stochastic progressive photon mapping (counterpart of
``pbrt_tpu/integrators/sppm.py``; pbrt-v3 §16.2), in wavefront form.

Each iteration, eagerly (the reference jits one iteration):

1. the camera pass: camera paths follow specular chains to their first
   diffuse vertex, the visible point (position, shading frame, beta, kd,
   and on scenes with other than matte materials the whole material
   record), where the light sample of pbrt's sppm.cpp is taken; escaped
   and emitted radiance accumulate directly;
2. the photon pass: photons leave the lights (point, area, infinite and
   distant: the last two inward from a sphere around the scene), bounce
   ``max_depth`` times and deposit at every diffuse hit after the first;
3. the gather: photons are keyed by the hash of their grid cell (the
   cell is the initial radius), sorted by key (a stable sort: the cap of
   ``max_per_cell`` photons per cell makes the image depend on the order
   of equal keys, so K5, which is unstable, is not used), and each
   visible point scans the 27 cells around it, ``max_per_cell`` photons
   each, from ``searchsorted``, summing f(wo, wi) x power over the photons
   within its radius (f = kd / pi on scenes of matte materials only, the
   material's ``bsdf_eval`` otherwise);
4. the statistics: per-pixel radius and tau updates with alpha = 2/3.

Sample keys, as in the reference: the camera pass reads the pixel's key
with sample index = iteration; the photons read (lane, -7) for emission
and (lane, -9) for the bounces.  Cell keys are uint32 hashes carried in
int64 (``core/rng``).  On an animated scene both passes read a shutter
time per lane (dimension 4 of their keys) for every intersection; the
camera rays themselves take none, as in the reference.

``last_lanes`` counts the camera lanes of the last render (pixels x
iterations), with ``queries_per_sample`` the camera pass's sweeps per
lane; ``last_photon_sweeps`` counts the photon pass's.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from pbrt_tpu_torch import PI
from pbrt_tpu_torch.core.geometry import coordinate_system, shading_frame
from pbrt_tpu_torch.core.rng import MASK32, hash_u32, mul32
from pbrt_tpu_torch.core.sampling import (
    cosine_sample_hemisphere,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from pbrt_tpu_torch.integrators.path import (
    INF_T,
    SHADOW_EPS,
    PathIntegrator,
    _offset_origin,
    _to_local,
    _to_world,
)
from pbrt_tpu_torch.lights import DiffuseAreaLight, PointLight
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import eval_material_params
from pbrt_tpu_torch.ops.tables import select_rows
from pbrt_tpu_torch.scene.builder import compute_interaction

log = logging.getLogger("pbrt_tpu_torch")

EMIT_KEY = -7  # the photons' emission samples: key (lane, -7)
BOUNCE_KEY = -9  # their bounces: key (lane, -9)
INVALID_KEY = MASK32  # the cell key of a photon that deposited nothing
ALPHA = 2.0 / 3.0


def _photon_keys(n, dev, key):
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    return torch.stack([lane, torch.full_like(lane, key)], dim=-1)


class SPPMIntegrator(PathIntegrator):
    """Custom-loop integrator: ``render`` drives its own iterations."""

    custom_render = True

    def __init__(self, compiled, max_depth=5, n_iterations=16, photons_per_iteration=-1,
                 initial_radius=1.0, max_per_cell=8):
        super().__init__(compiled, max_depth)
        self.n_iterations = int(n_iterations)
        self.photons_per_iter = int(photons_per_iteration)
        self.initial_radius = float(initial_radius)
        self.max_per_cell = int(max_per_cell)
        # matte-only scenes take the exact kd / pi gather; any other
        # material evaluates the real BSDF per photon
        types = [t for e in compiled.materials
                 for t in ([c.type_id for c in e.mix_children] if e.mix_children is not None
                           else [e.type_id])]
        self._gather_full_bsdf = any(t != B.MATTE for t in types)
        self.last_lanes = self.last_evaluations = self.last_photon_sweeps = 0

    def queries_per_sample(self):
        """(closest, shadow) sweeps per camera lane of an iteration: a
        closest hit and, with lights, a light sample at every vertex."""
        return self.max_depth, self.max_depth if self.c.lights else 0

    @staticmethod
    def _is_diffuse(params, si):
        return ((params["type"] != B.MIRROR)
                & ~((params["type"] == B.GLASS)
                    & (params["roughness"] <= B.ROUGH_GLASS_MIN_ALPHA))
                & (si["mat"] >= 0) & (params["type"] != B.NONE))

    # -- camera pass -------------------------------------------------------

    def _camera_pass(self, sampler, pixel_xy, sidx, o, d, theta=None):
        """Follow specular chains to the first diffuse vertex -> (visible
        points: a dict of [N, ...] tensors, L_direct [N, 3])."""
        c = self.c
        n = o.shape[0]
        dev = o.device
        z3 = torch.zeros((n, 3), dtype=o.dtype, device=dev)
        L = z3
        beta = torch.ones((n, 3), dtype=o.dtype, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        time_ = self._time(sampler, pixel_xy, sidx)
        vp = {k: z3 for k in ("p", "ns", "beta", "kd", "ss", "ts", "wo")}
        vp_params = None
        for bounce in range(self.max_depth):
            base = 5 + 7 * bounce
            hit = self._intersect(o, d, torch.full((n,), INF_T, device=dev), sort=True,
                                  time=time_)
            esc = alive & ~hit["hit"]
            L = L + torch.where(esc[..., None], beta * self._env_radiance(d, theta), 0.0)
            alive = alive & hit["hit"]
            si = compute_interaction(c.tables, hit, o, d, None, time_)
            wo = si["wo"]
            if c.area_lights:
                L = L + torch.where(alive[..., None], beta * self._emitted(si, wo, theta), 0.0)
            ns, ss, ts = shading_frame(si, wo)
            params = eval_material_params(c.materials, si["mat"], si, theta)
            params["outside"] = torch.sum(si["ns"] * wo, dim=-1) > 0.0
            newly = alive & self._is_diffuse(params, si) & ~found
            m = newly[..., None]
            for k, v in (("p", si["p"]), ("ns", ns), ("beta", beta), ("kd", params["kd"]),
                         ("ss", ss), ("ts", ts), ("wo", wo)):
                vp[k] = torch.where(m, v, vp[k])
            if self._gather_full_bsdf:
                if vp_params is None:
                    vp_params = params
                else:
                    vp_params = {k: _merge(newly, params[k], vp_params[k]) for k in params}
            found = found | newly
            alive = alive & ~newly  # diffuse lanes stop; specular chains go on
            wo_l = _to_local(ns, ss, ts, wo)

            # the light sample at the visible point (photons carry indirect
            # light only)
            if c.lights:
                u_sel = sampler.get(pixel_xy, sidx, base + 0)
                u_l = sampler.get2(pixel_xy, sidx, base + 1)
                wi_w, li, l_pdf, l_dist, _ = self._sample_one_light(si["p"], u_sel, u_l, theta)
                wi_nee = _to_local(ns, ss, ts, wi_w)
                f_nee = B.bsdf_eval(params, wo_l, wi_nee)
                can = newly & (l_pdf > 0.0) & (f_nee.amax(dim=-1) > 0.0)
                occ = self._occluded(_offset_origin(si["p"], si["ng"], wi_w), wi_w,
                                     l_dist - 2 * SHADOW_EPS, time_)
                contrib = beta * f_nee * li * (
                    torch.abs(wi_nee[..., 2]) / torch.clamp(l_pdf, min=1e-12))[..., None]
                L = L + torch.where((can & ~occ)[..., None], contrib, 0.0)

            if bounce == self.max_depth - 1:
                break
            u_lobe = sampler.get(pixel_xy, sidx, base + 3)
            u_b = sampler.get2(pixel_xy, sidx, base + 4)
            wi_l, f, pdf, _ = B.bsdf_sample(params, wo_l, u_lobe, u_b)
            wi_w = _to_world(ns, ss, ts, wi_l)
            ok = alive & (pdf > 0.0) & (f.amax(dim=-1) > 0.0)
            beta = torch.where(
                ok[..., None],
                beta * f * (torch.abs(wi_l[..., 2]) / torch.clamp(pdf, min=1e-12))[..., None],
                beta)
            alive = ok
            o = _offset_origin(si["p"], si["ng"], wi_w)
            d = wi_w
        vp["valid"] = found
        vp["params"] = vp_params
        return vp, L

    # -- photon pass -------------------------------------------------------

    def _emit_photons(self, sampler, n_photons, iteration, dev):
        """Photon origins, directions and powers [N, 3] from the lights,
        one picked uniformly per photon (key (lane, -7))."""
        c = self.c
        pkey = _photon_keys(n_photons, dev, EMIT_KEY)
        sidx = torch.full((n_photons,), iteration, dtype=torch.int64, device=dev)
        n_lights = max(1, len(c.lights))
        u_sel = sampler.get(pkey, sidx, 0)
        pick = torch.clamp((u_sel * n_lights).to(torch.int32), max=n_lights - 1)
        u_pos = sampler.get2(pkey, sidx, 1)
        u_dir = sampler.get2(pkey, sidx, 3)
        o = torch.zeros((n_photons, 3), dtype=torch.float32, device=dev)
        d = uniform_sample_sphere(u_dir)
        power = torch.zeros((n_photons, 3), dtype=torch.float32, device=dev)
        for i, lt in enumerate(c.lights):
            mask = pick == i
            # the spot, goniometric and projection lights subclass PointLight
            # here; the reference's do not, and emit no photons
            if type(lt) is PointLight:
                oi = lt._pd.expand(n_photons, 3)
                di = uniform_sample_sphere(u_dir)
                pw = (lt._id * (4 * PI)).expand(n_photons, 3)
            elif isinstance(lt, DiffuseAreaLight):
                x, _, tri_idx = lt.area_dist.sample_continuous(u_pos[..., 0])
                frac = torch.clamp(x * lt.area_dist.n - tri_idx, 0.0, 0.999999)
                b = uniform_sample_triangle(torch.stack([frac, u_pos[..., 1]], dim=-1))
                rows = select_rows(lt._tri_cols, tri_idx)
                p0, p1, p2, n_l = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
                oi = p0 + b[..., 0:1] * (p1 - p0) + b[..., 1:2] * (p2 - p0)
                # cosine-distributed emission from the surface
                local = cosine_sample_hemisphere(u_dir)
                s1, s2 = coordinate_system(n_l)
                di = local[..., 0:1] * s1 + local[..., 1:2] * s2 + local[..., 2:3] * n_l
                oi = oi + n_l * SHADOW_EPS
                pw = (lt._ld * (PI * lt.total_area)).expand(n_photons, 3)
            else:
                # infinite and distant lights: inward from a bounding sphere
                mins, maxs = c.world_bounds
                center = torch.as_tensor(((mins + maxs) / 2).astype(np.float32), device=dev)
                radius = float(np.linalg.norm(maxs - mins) / 2 + 1e-3) * 1.5
                sp = uniform_sample_sphere(u_pos)
                oi = center + radius * sp
                di = -sp
                ld = getattr(lt, "_ld", None)
                le = (lt.le_escaped(-di) if lt.is_infinite
                      else (ld if ld is not None else torch.zeros(3, device=dev))
                      .expand(n_photons, 3))
                pw = le * (PI * PI * 4 * radius * radius)
            o = torch.where(mask[..., None], oi, o)
            d = torch.where(mask[..., None], di, d)
            power = torch.where(mask[..., None], pw * n_lights, power)
        return o, d, power / n_photons

    def _photon_pass(self, sampler, n_photons, iteration, dev, theta=None):
        """Trace the photons -> deposits (positions, powers, travel
        directions [max_depth N, 3], deposited [max_depth N]), bounce-major."""
        c = self.c
        o, d, power = self._emit_photons(sampler, n_photons, iteration, dev)
        pkey = _photon_keys(n_photons, dev, BOUNCE_KEY)
        sidx = torch.full((n_photons,), iteration, dtype=torch.int64, device=dev)
        alive = torch.ones(n_photons, dtype=torch.bool, device=dev)
        time_ = self._time(sampler, pkey, sidx)
        dep_p, dep_w, dep_d, dep_ok = [], [], [], []
        for bounce in range(self.max_depth):
            base = 5 + 7 * bounce
            hit = self._intersect(o, d, torch.full((n_photons,), INF_T, device=dev), sort=True,
                                  time=time_)
            alive = alive & hit["hit"]
            si = compute_interaction(c.tables, hit, o, d, None, time_)
            wo = si["wo"]
            ns, ss, ts = shading_frame(si, wo)
            params = eval_material_params(c.materials, si["mat"], si, theta)
            params["outside"] = torch.sum(si["ns"] * wo, dim=-1) > 0.0
            # the first hit's light is the camera pass's direct lighting
            deposit = alive & self._is_diffuse(params, si) & (bounce > 0)
            dep_p.append(si["p"])
            dep_w.append(torch.where(deposit[..., None], power, 0.0))
            dep_d.append(d)  # the photon's travel direction: wi at the vp = -d
            dep_ok.append(deposit)
            if bounce == self.max_depth - 1:
                break
            wo_l = _to_local(ns, ss, ts, wo)
            u_lobe = sampler.get(pkey, sidx, base + 3)
            u_b = sampler.get2(pkey, sidx, base + 4)
            wi_l, f, pdf, _ = B.bsdf_sample(params, wo_l, u_lobe, u_b)
            wi_w = _to_world(ns, ss, ts, wi_l)
            ok = alive & (pdf > 0.0) & (f.amax(dim=-1) > 0.0)
            power = torch.where(
                ok[..., None],
                power * f * (torch.abs(wi_l[..., 2]) / torch.clamp(pdf, min=1e-12))[..., None],
                power)
            alive = ok
            o = _offset_origin(si["p"], si["ng"], wi_w)
            d = wi_w
        return (torch.cat(dep_p), torch.cat(dep_w), torch.cat(dep_d), torch.cat(dep_ok))

    # -- gather ------------------------------------------------------------

    @staticmethod
    def cell_key(q):
        """[N, 3] integer cell coordinates -> [N] uint32 hash keys (int64)."""
        qx, qy, qz = (q[..., i].long() & MASK32 for i in range(3))
        return hash_u32(mul32(qx, 73856093) ^ mul32(qy, 19349663) ^ mul32(qz, 83492791))

    def sorted_photons(self, photon_p, photon_w, photon_d, photon_ok, cell_size):
        """The photon map: (keys, positions, powers, directions), sorted
        stably by cell key, photons that deposited nothing keyed last."""
        pq = torch.floor(photon_p * (1.0 / cell_size)).to(torch.int32)
        pkey = torch.where(photon_ok, self.cell_key(pq), INVALID_KEY)
        order = torch.argsort(pkey, stable=True)
        return pkey[order], photon_p[order], photon_w[order], photon_d[order]

    def _gather(self, vp, radius, photon_map, cell_size):
        """Flux at each visible point: the sum over the photons within its
        radius of f(wo, wi_photon) x power (pbrt's Phi)."""
        pkey_s, pp_s, pw_s, pd_s = photon_map
        inv_cs = 1.0 / cell_size
        n = vp["p"].shape[0]
        dev = vp["p"].device
        flux = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        r2 = radius * radius
        full = self._gather_full_bsdf and vp["params"] is not None
        if full:
            wo_l = _to_local(vp["ns"], vp["ss"], vp["ts"], vp["wo"])
        else:
            f_matte = vp["kd"] * np.float32(1.0 / np.pi)
        q0 = torch.floor(vp["p"] * inv_cs).to(torch.int32)
        last = pkey_s.shape[0] - 1
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    key = self.cell_key(q0 + torch.tensor([ox, oy, oz], dtype=torch.int32,
                                                          device=dev))
                    start = torch.searchsorted(pkey_s, key, side="left")
                    for j in range(self.max_per_cell):
                        idx = torch.clamp(start + j, max=last)
                        match = pkey_s[idx] == key
                        dp = pp_s[idx] - vp["p"]
                        ok = match & (torch.sum(dp * dp, dim=-1) <= r2) & vp["valid"]
                        if full:
                            wi_l = _to_local(vp["ns"], vp["ss"], vp["ts"], -pd_s[idx])
                            f = B.bsdf_eval(vp["params"], wo_l, wi_l)
                        else:
                            f = f_matte
                        flux = flux + torch.where(ok[..., None], pw_s[idx] * f, 0.0)
        return flux

    # -- the render ----------------------------------------------------------

    def render(self, renderer, spp=None, progress=True):
        """SPPM iterations on ``renderer``'s film -> its state (the image
        set whole); ``spp``, when given, replaces ``numiterations``."""
        c = self.c
        film = renderer.film
        sampler = renderer.sampler
        camera = renderer.camera
        dev = renderer.device
        b = film.cropped_pixel_bounds
        pix = torch.as_tensor(b.offsets().astype(np.int64), device=dev)
        n_pix = pix.shape[0]
        n_iters = self.n_iterations if spp is None else max(1, int(spp))
        n_photons = (self.photons_per_iter if self.photons_per_iter > 0
                     else max(4096, n_pix))
        mins, maxs = c.world_bounds
        diag = float(np.linalg.norm(maxs - mins))
        radius0 = self.initial_radius if self.initial_radius > 0 else diag * 0.01
        radius = torch.full((n_pix,), radius0, dtype=torch.float32, device=dev)
        n_acc = torch.zeros(n_pix, dtype=torch.float32, device=dev)
        tau = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        L_direct = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        t0 = time.time()
        for it in range(n_iters):
            sidx = torch.full((n_pix,), it, dtype=torch.int64, device=dev)
            p_film = pix.to(renderer.dtype) + sampler.get2(pix, sidx, 0)
            o, d, _ = camera.generate_rays(p_film, sampler.get2(pix, sidx, 2))
            vp, L_dir = self._camera_pass(sampler, pix, sidx, o, d)
            L_direct = L_direct + L_dir
            photons = self._photon_pass(sampler, n_photons, it, dev)
            # the grid's cell is the initial (largest) radius
            flux = self._gather(vp, radius, self.sorted_photons(*photons, float(radius0)),
                                float(radius0))
            phi = vp["beta"] * flux
            m_count = torch.where(torch.sum(torch.abs(flux), dim=-1) > 0, 1.0, 0.0)
            new_n = n_acc + ALPHA * m_count
            ratio = torch.where(n_acc + m_count > 0,
                                new_n / torch.clamp(n_acc + m_count, min=1e-6), 1.0)
            radius = radius * torch.sqrt(ratio)
            tau = (tau + phi) * ratio[..., None]
            n_acc = new_n
            if progress and (it == 0 or it == n_iters - 1):
                log.info("SPPM iteration %d/%d (%.1fs)", it + 1, n_iters, time.time() - t0)
        self.last_evaluations = n_iters
        self.last_lanes = n_iters * n_pix
        self.last_photon_sweeps = n_iters * n_photons * self.max_depth
        indirect = tau / torch.clamp(n_iters * n_photons * PI * (radius * radius)[..., None],
                                     min=1e-12)
        rgb = L_direct / n_iters + indirect
        return film.set_image(film.initial_state(), rgb.reshape(b.height, b.width, 3))


def _merge(newly, new, old):
    """A material record's entry from ``new`` on the lanes ``newly``,
    else from ``old`` (scalars and 0-d entries: ``new``)."""
    if not isinstance(new, torch.Tensor) or new.dim() == 0:
        return new
    return torch.where(newly.reshape(newly.shape + (1,) * (new.dim() - 1)), new, old)
