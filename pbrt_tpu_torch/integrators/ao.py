"""Ambient-occlusion integrator (counterpart of
``pbrt_tpu/integrators/ao.py``; pbrt-v3 AOIntegrator).

``nsamples`` cosine-weighted occlusion rays per camera ray: L is the
unoccluded share of the hemisphere around the face-forwarded shading
normal, whatever the lights; rays that miss the scene see 1.  As in the
reference, ``cossample`` is read and ignored (the rays are always
cosine-weighted) and the occlusion rays are unbounded.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core.geometry import coordinate_system, vface_forward
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere
from pbrt_tpu_torch.integrators.path import INF_T, SHADOW_EPS
from pbrt_tpu_torch.scene.builder import compute_interaction


class AOIntegrator:
    def __init__(self, compiled, n_samples=1):
        self.c = compiled
        self.n_samples = max(1, int(n_samples))

    def queries_per_sample(self):
        """(closest, shadow) intersector queries per pixel-sample lane: one
        camera sweep and ``nsamples`` occlusion sweeps."""
        return 1, self.n_samples

    def li(self, sampler, pixel_xy, sample_index, o, d, theta=None):
        c = self.c
        n = o.shape[0]
        hit = c.intersector.intersect(o, d, torch.full((n,), INF_T, device=o.device))
        si = compute_interaction(c.tables, hit, o, d)
        ns = vface_forward(si["ns"], si["wo"])
        ss, ts = coordinate_system(ns)
        acc = torch.zeros((n,), dtype=o.dtype, device=o.device)
        for s in range(self.n_samples):
            w = cosine_sample_hemisphere(sampler.get2(pixel_xy, sample_index, 5 + 2 * s))
            wi = w[..., 0:1] * ss + w[..., 1:2] * ts + w[..., 2:3] * ns
            occ = c.intersector.occluded(si["p"] + ns * SHADOW_EPS, wi,
                                         torch.full((n,), INF_T, device=o.device))
            acc = acc + torch.where(hit["hit"] & ~occ, 1.0, 0.0)
        v = torch.where(hit["hit"], acc / self.n_samples, 1.0)
        return torch.stack([v, v, v], dim=-1)
