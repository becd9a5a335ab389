"""Wavefront path integrator with NEE + MIS (counterpart of
``pbrt_tpu/integrators/path.py``).

The bounce loop is unrolled max_depth times; every lane carries
(throughput, radiance, alive) and dead lanes are masked, not compacted.
Sample dimensions are allocated statically per bounce, so every sampler
value is a pure function of (pixel, sample index, dimension):

  0,1  film jitter     2,3  lens        4  time (motion blur)
  per bounce b, base = 5 + 7*b:
    +0 light select    +1,+2 light u2   +3 lobe select
    +4,+5 bsdf u2      +6 russian roulette

Rays that escape collect the infinite lights' radiance, weighted by MIS
against the lights' sampling pdf.

Sorted carry, where the reference takes it (an intersector with a sort
hint and triangles, i.e. the BVH) and ``sorted_carry`` is on (the
reference's ``PBRT_TPU_NO_SORTED_CARRY`` unset): at the end of every
bounce the whole wavefront is co-sorted into the next bounce's traversal
order (``sort_keys``; the intersector's ``co_sort`` network, 22 columns
as in the reference, with alive, specular_bounce and gather_only packed
into one flags column), the closest-hit sweeps run sort-free, and one
scatter restores lane order for the film.  ``shadow_sort`` picks the
shadow sweeps' order under sorted carry:

* ``"sorted"`` (default): each shadow sweep sorts its rays per call;
* ``"unsorted"`` (``PBRT_TPU_SC_NOSORT_SHADOW=1``): it walks them in
  carry order;
* ``"merged"`` (``PBRT_TPU_SC_MERGED=1``): the shadow columns (origin,
  direction, t, premasked contribution) ride the carry co-sort (32
  columns, which ``co_sort`` splits as the reference does) and the
  occlusion sweep runs sort-free in the next bounce's order.

All three give the same image: occlusion is per lane and the NEE add
commutes with the permutation.  Without sorted carry every shadow sweep
sorts.  The brute-force intersector keeps lanes in order throughout, and
so does an animated scene (motion blur), whose every query takes the
lane's shutter time from sampler dimension 4.

Derived integrators (``integrators/direct.py``) set two class knobs, as
the reference's do: ``direct_only`` (non-specular continuations trace
one more segment that only gathers emission, then stop: the BSDF-sampled
half of EstimateDirect's MIS pair) and ``nee_mis`` (False: the light
sample takes weight 1), and override ``_bsdf_sample``.

Gradients (path replay): ``li(..., theta=...)`` reads the scene
parameters from ``theta`` (``CompiledScene.initial_theta``), and
``torch.autograd`` differentiates the smooth factors (BSDF values, light
radiances, MIS weights) while every sampling decision stays as the
forward pass's random numbers made it.  Intersection queries run under
``torch.no_grad()`` (the reference's ``stop_gradient`` on the query
inputs): the walks are discrete lookups.  ``remat=True`` wraps each
bounce in ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``): the backward pass replays the bounce from its
inputs, walks included, instead of keeping its wavefront state, so the
memory kept per bounce is the carry alone.  Media take the volumetric
path integrator (``volpath.py``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from pbrt_tpu_torch.core.geometry import shading_frame
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.lights import DiffuseAreaLight, InfiniteAreaLight
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import eval_material_params
from pbrt_tpu_torch.ops.sortnet import co_sort
from pbrt_tpu_torch.scene.builder import compute_interaction

SHADOW_EPS = 1e-3
INF_T = 1e8
SHADOW_SORTS = ("sorted", "unsorted", "merged")


def _to_local(ns, ss, ts, v):
    return torch.stack(
        [torch.sum(v * ss, dim=-1), torch.sum(v * ts, dim=-1), torch.sum(v * ns, dim=-1)],
        dim=-1,
    )


def _to_world(ns, ss, ts, v):
    return v[..., 0:1] * ss + v[..., 1:2] * ts + v[..., 2:3] * ns


def _offset_origin(p, ng, w):
    """p pushed SHADOW_EPS along ng, to the side w leaves through."""
    return p + ng * SHADOW_EPS * torch.sign(torch.sum(w * ng, dim=-1, keepdim=True))


class PathIntegrator:
    direct_only = False
    nee_mis = True

    def __init__(self, compiled, max_depth=5, rr_threshold=1.0, remat=False,
                 sorted_carry=True, shadow_sort="sorted"):
        if shadow_sort not in SHADOW_SORTS:
            raise ValueError(f"unknown shadow_sort {shadow_sort!r}; expected one of "
                             f"{SHADOW_SORTS}")
        self.c = compiled
        self.max_depth = int(max_depth)
        self.rr_threshold = float(rr_threshold)
        self.remat = bool(remat)
        # an animated scene blends its keyframed geometry at each lane's
        # shutter time (sampler dimension 4) in every query
        self._animated = bool(compiled.tables["_flags"]["animated_keys"])
        # the reference's rule: keep the wavefront in traversal order across
        # bounces when the intersector takes a sort hint and has triangles,
        # and the scene does not move
        itx = compiled.intersector
        self._sc = (bool(sorted_carry) and bool(getattr(itx, "supports_sort_hint", False))
                    and itx.n_tri > 0 and not self._animated)
        self.shadow_sort = shadow_sort

    def queries_per_sample(self):
        """(closest, shadow) intersector queries per pixel-sample lane:
        one closest sweep per bounce, one shadow sweep per bounce except
        the last (the final vertex collects emission only)."""
        return self.max_depth, self.max_depth - 1

    def _bsdf_sample(self, params, wo_l, u_lobe, u_b):
        """The BSDF sample of a bounce (a hook for derived integrators)."""
        return B.bsdf_sample(params, wo_l, u_lobe, u_b)

    def _intersect(self, o, d, t_max, sort, time=None):
        """Closest hits; ``time``: the lanes' shutter times (animated
        scenes, whose intersector takes no sort hint)."""
        with torch.no_grad():
            if self._animated:
                return self.c.intersector.intersect(o, d, t_max, time=time)
            if getattr(self.c.intersector, "supports_sort_hint", False):
                return self.c.intersector.intersect(o, d, t_max, sort=sort)
            return self.c.intersector.intersect(o, d, t_max)

    def _occluded(self, o, d, t_max, time=None, sort=True):
        """Any-hit queries; ``sort``: sort the rays around a packed walk
        (only an intersector with a sort hint takes it)."""
        with torch.no_grad():
            if self._animated:
                return self.c.intersector.occluded(o, d, t_max, time=time)
            if not sort and getattr(self.c.intersector, "supports_sort_hint", False):
                return self.c.intersector.occluded(o, d, t_max, sort=False)
            return self.c.intersector.occluded(o, d, t_max)

    def _time(self, sampler, pixel_xy, sample_index):
        """The lanes' shutter times in an animated scene (the camera ray's
        dimension 4), else None."""
        return sampler.get(pixel_xy, sample_index, 4) if self._animated else None

    def _env_radiance(self, d, theta=None):
        le = torch.zeros_like(d)
        env_i = 0
        for lt in self.c.lights:
            if lt.is_infinite:
                le = le + lt.le_escaped(d, None if theta is None else theta["env_l"][env_i])
                env_i += 1
        return le

    def _env_pdf(self, p, d):
        """Combined light-strategy pdf that BSDF-sampled direction d escapes
        into an infinite light (for MIS)."""
        pdf = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
        for lt in self.c.lights:
            if lt.is_infinite:
                pdf = pdf + lt.pdf_li(p, d)
        return pdf / len(self.c.lights)

    def _emitted(self, si, wo, theta=None):
        """Area-light emission toward wo at hit points."""
        le = torch.zeros_like(wo)
        for i, al in enumerate(self.c.area_lights):
            ov = None if theta is None else theta["area_l"][i]
            le = torch.where((si["light"] == i)[..., None], al.l_emitted(si["ng"], wo, ov), le)
        return le

    def _area_light_pdf(self, prev_p, si, d):
        """pdf that NEE would have sampled this hit point, per lane."""
        pdf = torch.zeros(d.shape[0], dtype=d.dtype, device=d.device)
        for i, al in enumerate(self.c.area_lights):
            pv = al.pdf_li_at_hit(prev_p, si["p"], si["ng"], d)
            pdf = torch.where(si["light"] == i, pv, pdf)
        return pdf / len(self.c.lights)

    def _sample_one_light(self, p, u_sel, u2, theta=None):
        """Uniformly pick a light -> (wi, li, pdf, dist, is_delta)."""
        n_lights = len(self.c.lights)
        wi = torch.zeros_like(p)
        li = torch.zeros_like(p)
        pdf = torch.zeros(u_sel.shape, dtype=p.dtype, device=p.device)
        dist = torch.full(u_sel.shape, INF_T, dtype=p.dtype, device=p.device)
        delta = torch.zeros(u_sel.shape, dtype=torch.bool, device=p.device)
        pick = torch.clamp((u_sel * n_lights).to(torch.int32), max=n_lights - 1)
        env_i = area_i = 0
        for i, lt in enumerate(self.c.lights):
            mask = pick == i
            if theta is not None and isinstance(lt, InfiniteAreaLight):
                wi_i, li_i, pdf_i, dist_i = lt.sample_li(p, u2, theta["env_l"][env_i])
            elif theta is not None and isinstance(lt, DiffuseAreaLight):
                wi_i, li_i, pdf_i, dist_i = lt.sample_li(p, u2, theta["area_l"][area_i])
            else:
                wi_i, li_i, pdf_i, dist_i = lt.sample_li(p, u2)
            env_i += isinstance(lt, InfiniteAreaLight)
            area_i += isinstance(lt, DiffuseAreaLight)
            wi = torch.where(mask[..., None], wi_i, wi)
            li = torch.where(mask[..., None], li_i, li)
            pdf = torch.where(mask, pdf_i, pdf)
            dist = torch.where(mask, dist_i, dist)
            delta = torch.where(mask, lt.is_delta, delta)
        return wi, li, pdf / n_lights, dist, delta

    def li(self, sampler, pixel_xy, sample_index, o, d, theta=None):
        """Radiance for a wavefront of camera rays: pixel_xy [N, 2] int,
        sample_index [N] int64, o, d [N, 3] -> L [N, 3] in lane order.
        ``theta``: the scene parameters to read (and differentiate)."""
        n = o.shape[0]
        dev, dt = o.device, o.dtype
        carry = (
            torch.zeros((n, 3), dtype=dt, device=dev),  # L
            torch.ones((n, 3), dtype=dt, device=dev),  # beta
            torch.ones(n, dtype=torch.bool, device=dev),  # alive
            torch.ones(n, dtype=torch.bool, device=dev),  # specular_bounce
            torch.zeros(n, dtype=torch.bool, device=dev),  # gather_only (emission only)
            torch.ones(n, dtype=dt, device=dev),  # prev_bsdf_pdf
            o,  # prev_p
            o,
            d,
            pixel_xy,  # rides the permutation (samplers are pure in it)
            sample_index,
            torch.arange(n, device=dev),  # original lane id
        )
        for bounce in range(self.max_depth):
            body = functools.partial(self._bounce, bounce, sampler, theta)
            if self.remat:
                carry = checkpoint(body, carry, use_reentrant=False)
            else:
                carry = body(carry)
        L, lane = carry[0], carry[-1]
        if not self._sc:
            return L
        out = torch.zeros_like(L)
        out[lane] = L
        return out

    def _bounce(self, bounce, sampler, theta, carry):
        c = self.c
        (L, beta, alive, specular_bounce, gather_only, prev_bsdf_pdf, prev_p, o, d,
         pixel_xy, sample_index, lane) = carry
        base = 5 + 7 * bounce
        time = self._time(sampler, pixel_xy, sample_index)
        # dead lanes trace with t_max = 0 (they sort into trailing blocks)
        t_far = torch.where(alive, INF_T, 0.0)
        # camera rays arrive pixel-major; sorted-carry lanes were sorted at
        # the end of the previous bounce
        hit = self._intersect(o, d, t_far, sort=bounce > 0 and not self._sc, time=time)

        if any(lt.is_infinite for lt in c.lights):
            esc = alive & ~hit["hit"]
            env_le = self._env_radiance(d, theta)
            light_pdf = self._env_pdf(prev_p, d)
            w_env = torch.where(
                specular_bounce, 1.0, power_heuristic(1, prev_bsdf_pdf, 1, light_pdf)
            )
            L = L + torch.where(esc[..., None], beta * env_le * w_env[..., None], 0.0)
        alive = alive & hit["hit"]

        ray_diff = None
        if bounce == 0 and c.tables["_flags"]["tex_width"]:
            # camera ray differentials: regenerate the +1px neighbours from
            # the same film/lens samples
            p_film = pixel_xy.to(o.dtype) + sampler.get2(pixel_xy, sample_index, 0)
            u_lens = sampler.get2(pixel_xy, sample_index, 2)
            off_x = torch.tensor([1.0, 0.0], dtype=o.dtype, device=o.device)
            off_y = torch.tensor([0.0, 1.0], dtype=o.dtype, device=o.device)
            _, dxd, _ = c.camera.generate_rays(p_film + off_x, u_lens)
            _, dyd, _ = c.camera.generate_rays(p_film + off_y, u_lens)
            ray_diff = (dxd, dyd)
        si = compute_interaction(c.tables, hit, o, d, ray_diff, time)
        wo = si["wo"]

        if c.area_lights:
            le_hit = self._emitted(si, wo, theta)
            al_pdf = self._area_light_pdf(prev_p, si, d)
            w_le = torch.where(
                specular_bounce, 1.0, power_heuristic(1, prev_bsdf_pdf, 1, al_pdf)
            )
            L = L + torch.where(alive[..., None], beta * le_hit * w_le[..., None], 0.0)

        if bounce == self.max_depth - 1:
            return (L, beta, alive, specular_bounce, gather_only, prev_bsdf_pdf, prev_p, o,
                    d, pixel_xy, sample_index, lane)
        if self.direct_only:
            # emission-only lanes have collected their Le: they stop here
            alive = alive & ~gather_only

        ns, ss, ts = shading_frame(si, wo)
        wo_l = _to_local(ns, ss, ts, wo)
        params = eval_material_params(c.materials, si["mat"], si, theta)
        # the true side (before face-forwarding), for dielectrics
        params["outside"] = torch.sum(si["ns"] * wo, dim=-1) > 0.0
        alive = alive & (si["mat"] >= 0) & (params["type"] != B.NONE)

        # --- next-event estimation ----------------------------------------
        nee_cols = None
        if c.lights:
            u_sel = sampler.get(pixel_xy, sample_index, base + 0)
            u_l = sampler.get2(pixel_xy, sample_index, base + 1)
            wi_w, li, l_pdf, l_dist, l_delta = self._sample_one_light(si["p"], u_sel, u_l,
                                                                      theta)
            wi_l = _to_local(ns, ss, ts, wi_w)
            f = B.bsdf_eval(params, wo_l, wi_l)
            b_pdf = B.bsdf_pdf(params, wo_l, wi_l)
            can = alive & (l_pdf > 0.0) & (f.amax(dim=-1) > 0.0)
            shadow_o = _offset_origin(si["p"], si["ng"], wi_w)
            shadow_t = torch.where(can, l_dist - 2 * SHADOW_EPS, 0.0)
            if self.nee_mis:
                w_l = torch.where(l_delta, 1.0, power_heuristic(1, l_pdf, 1, b_pdf))
            else:  # light sampling is the only direct estimator
                w_l = torch.ones_like(l_pdf)
            contrib = beta * f * li * (
                torch.abs(wi_l[..., 2]) * w_l / torch.clamp(l_pdf, min=1e-12)
            )[..., None]
            if self._sc and self.shadow_sort == "merged":
                # the shadow columns ride the carry co-sort below
                nee_cols = (shadow_o, wi_w, shadow_t, torch.where(can[..., None], contrib, 0.0))
            else:
                # shadow wavefronts get their own sort unless told otherwise:
                # their directions diverge from the carry order
                sort_shadow = not self._sc or self.shadow_sort == "sorted"
                vis = can & ~self._occluded(shadow_o, wi_w, shadow_t, time, sort=sort_shadow)
                L = L + torch.where(vis[..., None], contrib, 0.0)

        # --- BSDF sampling -------------------------------------------------
        u_lobe = sampler.get(pixel_xy, sample_index, base + 3)
        u_b = sampler.get2(pixel_xy, sample_index, base + 4)
        wi_l, f, pdf, spec = self._bsdf_sample(params, wo_l, u_lobe, u_b)
        wi_w = _to_world(ns, ss, ts, wi_l)
        ok = alive & (pdf > 0.0) & (f.amax(dim=-1) > 0.0)
        if self.direct_only:
            # pbrt's DirectLightingIntegrator: a non-specular continuation
            # only gathers the BSDF-sampled direct light
            gather_only = ok & ~spec
            if bounce == self.max_depth - 2:
                # the deepest vertex: its gather-only ray traces, specular
                # recursion stops
                ok = ok & ~spec
        beta = torch.where(
            ok[..., None],
            beta * f * (torch.abs(wi_l[..., 2]) / torch.clamp(pdf, min=1e-12))[..., None],
            beta,
        )
        alive = ok
        prev_p = si["p"]
        prev_bsdf_pdf = pdf
        specular_bounce = spec
        o = _offset_origin(si["p"], si["ng"], wi_w)
        d = wi_w

        # --- russian roulette ----------------------------------------------
        if bounce > 3:
            q = torch.clamp(1.0 - beta.amax(dim=-1), min=0.05)
            survive = sampler.get(pixel_xy, sample_index, base + 6) >= q
            beta = torch.where(
                (alive & survive)[..., None],
                beta / torch.clamp(1.0 - q, min=1e-6)[..., None],
                beta,
            )
            alive = alive & survive

        if not self._sc:
            return (L, beta, alive, specular_bounce, gather_only, prev_bsdf_pdf, prev_p, o,
                    d, pixel_xy, sample_index, lane)

        # --- sorted carry: one co-sort into the next traversal order -------
        t_next = torch.where(alive, INF_T, 0.0)
        keys = c.intersector.sort_keys(o, d, t_next)
        flags = (alive.to(torch.int32) | (specular_bounce.to(torch.int32) << 1)
                 | (gather_only.to(torch.int32) << 2))
        carried = (keys, L, beta, prev_bsdf_pdf, prev_p, o, d, pixel_xy, sample_index, lane,
                   flags)
        srt = co_sort(carried + (nee_cols or ()), c.intersector.sort_network)
        (_, L, beta, prev_bsdf_pdf, prev_p, o, d, pixel_xy, sample_index, lane,
         flags) = srt[:len(carried)]
        alive = (flags & 1) != 0
        specular_bounce = (flags & 2) != 0
        gather_only = (flags & 4) != 0
        if nee_cols is not None:
            # the occlusion sweep in the next bounce's order, sort-free
            so, sw, st, pre = srt[len(carried):]
            occluded = self._occluded(so, sw, st, time, sort=False)
            L = L + torch.where(occluded[..., None], 0.0, pre)
        return (L, beta, alive, specular_bounce, gather_only, prev_bsdf_pdf, prev_p, o, d,
                pixel_xy, sample_index, lane)
