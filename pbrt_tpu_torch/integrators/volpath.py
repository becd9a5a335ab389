"""Volumetric path integrator (counterpart of
``pbrt_tpu/integrators/volpath.py``; pbrt-v3 §15.3 semantics in wavefront
form).

Every lane carries a medium id (-1: vacuum), starting in the camera's.
Each bounce samples a medium interaction against the surface hit
distance: lanes that scatter take a phase-function vertex (next-event
estimation with transmittance, then a Henyey-Greenstein direction), the
others shade the surface as the path integrator does.  Crossing a surface
whose shape declared a MediumInterface switches the lane's medium
(entering: inside, leaving: outside).

Null-material boundaries (shaped volumes: smoke in a ``Material ""``
box): when the scene has null-material surfaces, each bounce marches up
to ``PASSTHROUGH_STEPS`` boundary crossings (medium sampling per segment,
a medium switch at each crossing, no depth consumed; area lights on the
null surfaces crossed are collected with their MIS weight), and shadow
rays multiply the transmittance of up to ``SHADOW_SEGMENTS`` segments
through the boundaries with closest-hit sweeps (pbrt-v3
VisibilityTester::Tr).  A lane that spends the march's budget settles on
the null hit, whose NONE material ends it; a shadow ray that spends its
segments counts as occluded.  Without null materials the march is one
segment and the shadow ray one any-hit sweep.

Grid media track with the stateless stream of ``media.make_track_rng``:
salts 2048 + bounce * PASSTHROUGH_STEPS + step for the march (its first
segment's first flight takes the sampler's dimension base + 7, the later
segments' slot 100003 of their stream), 1024 + bounce * SHADOW_SEGMENTS
+ segment for the shadow rays (1024 + bounce on the one-sweep path).

Dimensions per bounce b, base = 5 + 10 b: the path integrator's seven
(+0 light select, +1,+2 light u2, +3 lobe, +4,+5 BSDF or phase u2, +6
russian roulette) and +7 the medium distance.  No sorted carry: every
closest sweep sorts its rays but the camera's first segment.

Gradients: ``theta`` is threaded as in the path integrator, and
``remat=True`` runs each bounce (``_bounce``, a function of its carry)
under ``torch.utils.checkpoint``: the backward pass replays the bounce,
its walks and tracking loops included, instead of keeping its state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from pbrt_tpu_torch.core.geometry import shading_frame
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.integrators.path import (
    INF_T,
    SHADOW_EPS,
    PathIntegrator,
    _offset_origin,
    _to_local,
    _to_world,
)
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import eval_material_params
from pbrt_tpu_torch.media import hg_phase, hg_sample, make_track_rng
from pbrt_tpu_torch.scene.builder import compute_interaction

N_DIMS_PER_BOUNCE = 10
# the reference's budgets; they also number the tracking streams' salts
PASSTHROUGH_STEPS = 3
SHADOW_SEGMENTS = 4


class VolPathIntegrator(PathIntegrator):
    def __init__(self, compiled, max_depth=5, rr_threshold=1.0):
        super().__init__(compiled, max_depth, rr_threshold)
        self.media = compiled.media
        self._mat_types = np.asarray([e.type_id for e in compiled.materials], dtype=np.int32)
        self._types = torch.as_tensor(self._mat_types, device=compiled.device)
        # null-material surfaces need the segmented march, media or not: a
        # null shape must not occlude shadow rays
        has_null = bool((self._mat_types == B.NONE).any())
        self.passthrough_steps = PASSTHROUGH_STEPS if has_null else 1
        self.shadow_segments = SHADOW_SEGMENTS if has_null else 1

    def queries_per_sample(self):
        """(closest, shadow) sweeps per pixel-sample lane: every bounce
        marches ``passthrough_steps`` closest sweeps, every bounce but the
        last traces ``shadow_segments`` shadow sweeps."""
        return (self.max_depth * self.passthrough_steps,
                (self.max_depth - 1) * self.shadow_segments)

    def _opaque_mask(self, hit_mask, mat_id):
        """Hits on a surface with a real BSDF (they block rays and end the
        march)."""
        if len(self._mat_types) == 0:
            return hit_mask
        t = self._types[torch.clamp(mat_id, 0, len(self._mat_types) - 1).long()]
        return hit_mask & (mat_id >= 0) & (t != B.NONE)

    def _shadow_tr(self, med, shadow_o, wi_w, l_dist, pixel_xy, sample_index, bounce,
                   time=None):
        """A shadow ray's transmittance through its media and null-material
        boundaries, and whether an opaque surface occludes it ->
        (tr [N, 3], occluded [N])."""
        c = self.c
        n = wi_w.shape[0]
        tr = torch.ones((n, 3), dtype=wi_w.dtype, device=wi_w.device)
        cur_o = shadow_o
        cur_med = med
        remaining = torch.clamp(torch.clamp(l_dist, max=1e6) - 2 * SHADOW_EPS, min=0.0)
        segs = self.shadow_segments
        if segs == 1:
            # no null-material boundaries: one any-hit sweep and one
            # full-length transmittance
            occ = self._occluded(cur_o, wi_w, remaining, time)
            if self.media:
                rng_seg = make_track_rng(pixel_xy, sample_index, 1024 + bounce, c.float_t)
                tr = self._medium_transmittance(cur_med, cur_o, wi_w, remaining, rng_seg)
            return tr, occ
        occ = torch.zeros(n, dtype=torch.bool, device=wi_w.device)
        for seg in range(segs):
            h = self._intersect(cur_o, wi_w, remaining, sort=True, time=time)
            seg_len = torch.where(h["hit"], h["t"], remaining)
            if self.media:
                rng_seg = make_track_rng(pixel_xy, sample_index, 1024 + bounce * segs + seg,
                                         c.float_t)
                tr = tr * self._medium_transmittance(cur_med, cur_o, wi_w, seg_len, rng_seg)
            if seg == segs - 1:
                return tr, occ | h["hit"]
            si = compute_interaction(c.tables, h, cur_o, wi_w, None, time)
            opaque = self._opaque_mask(h["hit"], si["mat"])
            occ = occ | opaque
            passing = h["hit"] & ~opaque
            entering = torch.sum(wi_w * si["ng_raw"], dim=-1) < 0.0
            new_med = torch.where(entering, si["med_in"], si["med_out"])
            cur_med = torch.where(passing, new_med, cur_med)
            adv = seg_len + SHADOW_EPS
            cur_o = torch.where(passing[..., None], cur_o + wi_w * adv[..., None], cur_o)
            # lanes done (no hit, or occluded) trace no further segments
            remaining = torch.where(passing, torch.clamp(remaining - adv, min=0.0), 0.0)
        return tr, occ

    # every medium over every lane, then a select by the lanes' ids

    def _medium_transmittance(self, med_id, o, d, dist, rng):
        tr = torch.ones(dist.shape + (3,), dtype=dist.dtype, device=dist.device)
        for i, m in enumerate(self.media):
            tr = torch.where((med_id == i)[..., None], m.tr(o, d, dist, rng), tr)
        return tr

    def _medium_sample(self, med_id, o, d, u, t_hit, rng):
        t = t_hit
        scattered = torch.zeros(t_hit.shape, dtype=torch.bool, device=t_hit.device)
        beta = torch.ones(t_hit.shape + (3,), dtype=t_hit.dtype, device=t_hit.device)
        for i, m in enumerate(self.media):
            ti, si, bi = m.sample(o, d, u, t_hit, rng)
            mask = med_id == i
            t = torch.where(mask, ti, t)
            scattered = torch.where(mask, si, scattered)
            beta = torch.where(mask[..., None], bi, beta)
        return t, scattered, beta

    def _g_of(self, med_id):
        g = torch.zeros(med_id.shape, dtype=torch.float32, device=med_id.device)
        for i, m in enumerate(self.media):
            g = torch.where(med_id == i, m.g, g)
        return g

    def li(self, sampler, pixel_xy, sample_index, o, d, theta=None):
        """Radiance for a wavefront of camera rays (lane order kept):
        pixel_xy [N, 2] int, sample_index [N] int64, o, d [N, 3] -> L [N, 3].
        With ``remat`` each bounce runs under ``torch.utils.checkpoint``."""
        n = o.shape[0]
        dev = o.device
        carry = (
            torch.zeros((n, 3), dtype=o.dtype, device=dev),  # L
            torch.ones((n, 3), dtype=o.dtype, device=dev),  # beta
            torch.ones(n, dtype=torch.bool, device=dev),  # alive
            torch.ones(n, dtype=torch.bool, device=dev),  # specular_bounce
            torch.ones(n, dtype=o.dtype, device=dev),  # prev_bsdf_pdf
            o,  # prev_p
            torch.full((n,), self.c.camera_medium, dtype=torch.int32, device=dev),  # medium
            o,
            d,
        )
        for bounce in range(self.max_depth):
            body = functools.partial(self._bounce, bounce, sampler, theta, pixel_xy,
                                     sample_index)
            if self.remat:
                carry = checkpoint(body, carry, use_reentrant=False)
            else:
                carry = body(carry)
        return carry[0]

    def _bounce(self, bounce, sampler, theta, pixel_xy, sample_index, carry):
        """One bounce: the march, emission, NEE and the continuation; a
        function of its carry, so that a checkpoint can replay it."""
        c = self.c
        L, beta, alive, specular_bounce, prev_bsdf_pdf, prev_p, med, o, d = carry
        n = o.shape[0]
        dev = o.device
        steps = self.passthrough_steps
        has_env = any(lt.is_infinite for lt in c.lights)
        base = 5 + N_DIMS_PER_BOUNCE * bounce
        time = self._time(sampler, pixel_xy, sample_index)

        # --- the march: closest hit and medium sample per segment,
        # passing null-material boundaries (a medium switch, no depth)
        marching = alive
        o_seg = o
        med_seg = med
        scattered = torch.zeros(n, dtype=torch.bool, device=dev)
        p_med = o
        hit = si = None
        o_fin = o
        med_fin = med
        for step in range(steps):
            # the camera's first segment is pixel-major: no ray sort
            h = self._intersect(o_seg, d, torch.full((n,), INF_T, device=dev),
                                sort=not (bounce == 0 and step == 0), time=time)
            t_hit = torch.where(h["hit"], h["t"], INF_T)
            if self.media:
                rng_track = make_track_rng(pixel_xy, sample_index,
                                           2048 + bounce * steps + step, c.float_t)
                if step == 0:
                    u_med = sampler.get(pixel_xy, sample_index, base + 7)
                else:
                    u_med = rng_track(100003)
                t_med_s, scat_s, med_beta = self._medium_sample(med_seg, o_seg, d, u_med,
                                                                t_hit, rng_track)
                in_medium = med_seg >= 0
                scat_s = scat_s & in_medium & marching
                beta = torch.where((marching & in_medium)[..., None], beta * med_beta, beta)
            else:
                scat_s = torch.zeros(n, dtype=torch.bool, device=dev)
                t_med_s = t_hit
            si_s = compute_interaction(c.tables, h, o_seg, d, None, time)
            opaque = self._opaque_mask(h["hit"], si_s["mat"])
            # a lane settles when it scatters, hits a real surface or
            # escapes; at the budget's end it settles on the null hit
            last = step == steps - 1
            settle = marching & (scat_s | opaque | ~h["hit"] | last)
            if hit is None:
                hit, si, o_fin, med_fin = h, si_s, o_seg, med_seg
            else:
                def sel(a, b):
                    if a is None:
                        return None
                    return torch.where(settle.reshape(settle.shape + (1,) * (a.dim() - 1)),
                                       a, b)

                hit = {k: sel(h[k], hit[k]) for k in hit}
                si = {k: sel(si_s[k], si[k]) for k in si}
                o_fin = sel(o_seg, o_fin)
                med_fin = sel(med_seg, med_fin)
            scattered = scattered | scat_s
            p_med = torch.where(scat_s[..., None], o_seg + d * t_med_s[..., None], p_med)
            if last:
                break
            passing = marching & h["hit"] & ~opaque & ~scat_s
            if c.area_lights:
                # an area light on a null surface: passing lanes never
                # settle on it, so its emission is taken here, with the
                # MIS weight the settled path would give it
                le_pass = self._emitted(si_s, -d, theta)
                al_pdf_pass = self._area_light_pdf(prev_p, si_s, d)
                w_le_pass = torch.where(specular_bounce, 1.0,
                                        power_heuristic(1, prev_bsdf_pdf, 1, al_pdf_pass))
                L = L + torch.where((passing & (si_s["light"] >= 0))[..., None],
                                    beta * le_pass * w_le_pass[..., None], 0.0)
            entering = torch.sum(d * si_s["ng_raw"], dim=-1) < 0.0
            new_med = torch.where(entering, si_s["med_in"], si_s["med_out"])
            med_seg = torch.where(passing, new_med, med_seg)
            o_seg = torch.where(passing[..., None],
                                o_seg + d * (t_hit + SHADOW_EPS)[..., None], o_seg)
            marching = passing
        med = med_fin
        o = o_fin

        # --- escaped rays ----------------------------------------------
        if has_env:
            esc = alive & ~hit["hit"] & ~scattered
            env_le = self._env_radiance(d, theta)
            w_env = torch.where(specular_bounce, 1.0, power_heuristic(
                1, prev_bsdf_pdf, 1, self._env_pdf(prev_p, d)))
            L = L + torch.where(esc[..., None], beta * env_le * w_env[..., None], 0.0)

        wo = si["wo"]

        # --- emission at surface hits (not at medium vertices) ---------
        if c.area_lights:
            le_hit = self._emitted(si, wo, theta)
            al_pdf = self._area_light_pdf(prev_p, si, d)
            w_le = torch.where(specular_bounce, 1.0,
                               power_heuristic(1, prev_bsdf_pdf, 1, al_pdf))
            surf = alive & hit["hit"] & ~scattered
            L = L + torch.where(surf[..., None], beta * le_hit * w_le[..., None], 0.0)

        alive = alive & (hit["hit"] | scattered)
        if bounce == self.max_depth - 1:
            return L, beta, alive, specular_bounce, prev_bsdf_pdf, prev_p, med, o, d

        p_vertex = torch.where(scattered[..., None], p_med, si["p"])

        # --- next-event estimation at surface and medium vertices ------
        ns, ss, ts = shading_frame(si, wo)
        wo_l = _to_local(ns, ss, ts, wo)
        params = eval_material_params(c.materials, si["mat"], si, theta)
        params["outside"] = torch.sum(si["ns"] * wo, dim=-1) > 0.0
        surf_ok = alive & ~scattered & (si["mat"] >= 0) & (params["type"] != B.NONE)
        g_med = self._g_of(med)

        if c.lights:
            u_sel = sampler.get(pixel_xy, sample_index, base + 0)
            u_l = sampler.get2(pixel_xy, sample_index, base + 1)
            wi_w, li, l_pdf, l_dist, l_delta = self._sample_one_light(p_vertex, u_sel, u_l,
                                                                      theta)
            wi_l = _to_local(ns, ss, ts, wi_w)
            f_surf = B.bsdf_eval(params, wo_l, wi_l) * torch.abs(wi_l[..., 2])[..., None]
            b_pdf_surf = B.bsdf_pdf(params, wo_l, wi_l)
            # a medium vertex: the phase value (its own sampling pdf)
            ph = hg_phase(torch.sum(d * wi_w, dim=-1), g_med)
            f = torch.where(scattered[..., None], ph[..., None].expand(n, 3), f_surf)
            b_pdf = torch.where(scattered, ph, b_pdf_surf)
            can = alive & (l_pdf > 0.0) & (f.amax(dim=-1) > 0.0) & (surf_ok | scattered)
            shadow_o = torch.where(scattered[..., None], p_med,
                                   _offset_origin(si["p"], si["ng"], wi_w))
            tr, occ = self._shadow_tr(med, shadow_o, wi_w, l_dist, pixel_xy, sample_index,
                                      bounce, time)
            w_l = torch.where(l_delta, 1.0, power_heuristic(1, l_pdf, 1, b_pdf))
            contrib = beta * f * li * tr * (w_l / torch.clamp(l_pdf, min=1e-12))[..., None]
            L = L + torch.where((can & ~occ)[..., None], contrib, 0.0)

        # --- continuation: the BSDF sample, or HG at medium vertices ---
        u_lobe = sampler.get(pixel_xy, sample_index, base + 3)
        u_b = sampler.get2(pixel_xy, sample_index, base + 4)
        wi_ls, f_s, pdf_s, spec = B.bsdf_sample(params, wo_l, u_lobe, u_b)
        wi_surf = _to_world(ns, ss, ts, wi_ls)
        w_surf_ok = surf_ok & (pdf_s > 0.0) & (f_s.amax(dim=-1) > 0.0)
        beta_surf = f_s * (torch.abs(wi_ls[..., 2]) / torch.clamp(pdf_s, min=1e-12))[..., None]
        # HG's value and pdf cancel
        wi_med, _ = hg_sample(-d, u_b, g_med)
        wi_w = torch.where(scattered[..., None], wi_med, wi_surf)
        ok = torch.where(scattered, alive, w_surf_ok)
        beta = torch.where((ok & ~scattered)[..., None], beta * beta_surf, beta)
        alive = ok

        # --- medium switch where the continuation crosses the surface --
        crossing = ~scattered & alive
        entering = torch.sum(wi_w * si["ng_raw"], dim=-1) < 0.0
        new_med = torch.where(entering, si["med_in"], si["med_out"])
        med = torch.where(crossing, new_med, med)

        prev_p = p_vertex
        prev_bsdf_pdf = torch.where(scattered, 1.0, pdf_s)
        specular_bounce = torch.where(scattered, False, spec)
        o = torch.where(scattered[..., None], p_med, _offset_origin(si["p"], si["ng"], wi_w))
        d = wi_w

        if bounce > 3:
            q = torch.clamp(1.0 - beta.amax(dim=-1), min=0.05)
            survive = sampler.get(pixel_xy, sample_index, base + 6) >= q
            beta = torch.where((alive & survive)[..., None],
                               beta / torch.clamp(1.0 - q, min=1e-6)[..., None], beta)
            alive = alive & survive
        return L, beta, alive, specular_bounce, prev_bsdf_pdf, prev_p, med, o, d
