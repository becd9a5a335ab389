#!/usr/bin/env python3
"""How closely the port's brute-force sweep follows the reference's
compiled rounding, on the CPU.

The reference renders compiled by XLA, whose CPU code fuses a multiply
into the add that consumes it; ``pbrt_tpu_torch/ops/intersect_soa.py``
rounds the same sums the same way (``fma``).  This script prints, for
the Cornell box's 14 primitives (the unrolled path) and a 200-triangle
soup with a rotated partial sphere (the scan path), on 20,000 seeded
rays: hits, the share of hits whose t is bit-equal to the reference's
(spheres separately), and the hits beyond rtol 1e-6 with their t and
|dt|; then the Cornell sweep again and the Cornell image at 16x16, 2
spp, maxdepth 2 against the reference's, with the port's ``fma`` and
with plain float32 rounding in its place.

    JAX_PLATFORMS=cpu python3 scripts/xla_rounding.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rays(n, lo, hi, seed, aim):
    """n rays from [lo, hi)^3, half aimed at the ball ``aim``; t_max 1e8."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    c, r = aim
    d[: n // 2] = c + rng.uniform(-r, r, (n // 2, 3)) - o[: n // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e8, np.float32)


def compare_sweeps(label, ref, port, o, d, t_max):
    import jax
    import torch

    want = {k: np.asarray(v) for k, v in jax.jit(ref.intersect)(o, d, t_max).items()}
    got = {k: v.numpy() for k, v in port.intersect(
        *(torch.as_tensor(a) for a in (o, d, t_max))).items()}
    hit = want["hit"]
    sph = hit & (want["kind"] == 1)
    same = got["t"] == want["t"]
    rel = np.abs(got["t"] / np.where(hit, want["t"], 1.0) - 1.0)
    beyond = np.flatnonzero(hit & (rel > 1e-6))
    print(f"{label}: {hit.sum()} hits ({sph.sum()} spheres); kind equal "
          f"{(got['kind'] == want['kind']).all()}, prim equal on hits "
          f"{(got['prim'] == want['prim'])[hit].all()}; t bit-equal on "
          f"{same[hit].mean():.4f} of hits, {same[sph].mean():.4f} of sphere hits "
          f"(largest |dt| / t there {rel[sph].max():.3e}); {len(beyond)} hits beyond "
          "rtol 1e-6")
    for i in beyond:
        print(f"  lane {i}: kind {want['kind'][i]}, t {want['t'][i]!r} against "
              f"{got['t'][i]!r}, |dt| {abs(got['t'][i] - want['t'][i]):.3e}")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrt_tpu.core.transform import Transform
    from pbrt_tpu.ops.intersect_soa import SoABruteForceIntersector as RefSoA
    from pbrt_tpu.shapes import SphereData as RefSphereData
    from pbrt_tpu.shapes import TriangleData as RefTriangleData
    from pbrt_tpu.testscenes import cornell_renderer as ref_cornell_renderer
    from pbrt_tpu_torch.ops import intersect_soa
    from pbrt_tpu_torch.shapes import SphereData, TriangleData
    from pbrt_tpu_torch.testscenes import cornell_renderer

    n = 20000
    ref_c = ref_cornell_renderer(xres=8, yres=8, spp=1, maxdepth=1).compiled
    port_c = cornell_renderer(xres=8, yres=8, spp=1, maxdepth=1, device="cpu").compiled
    cornell_rays = rays(n, -50.0, 600.0, 1, ((278, 95, 260), 180))
    ref_sweep = RefSoA(ref_c.tri_data, ref_c.sph_data)
    compare_sweeps("Cornell, 14 primitives (unrolled)", ref_sweep, port_c.intersector,
                   *cornell_rays)

    rng = np.random.default_rng(3)
    c = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    p1 = (c + rng.uniform(-0.3, 0.3, (200, 3))).astype(np.float32)
    p2 = (c + rng.uniform(-0.3, 0.3, (200, 3))).astype(np.float32)
    uv = np.zeros((200, 2), np.float32)
    x = Transform.translate([0.2, -0.1, 0.3]) * Transform.rotate(35, [1, 2, 0.5])
    sph = dict(o2w=x.m[None], w2o=x.m_inv[None], radius=np.array([0.6], np.float32),
               z_min=np.array([-0.4], np.float32), z_max=np.array([0.5], np.float32),
               phi_max=np.array([np.deg2rad(270.0)], np.float32),
               reverse_orientation=np.array([False]))
    compare_sweeps("soup, 200 triangles and a rotated partial sphere (scan)",
                   RefSoA(RefTriangleData(c, p1, p2, uv, uv, uv), RefSphereData(**sph)),
                   intersect_soa.SoABruteForceIntersector(
                       TriangleData(c, p1, p2, uv, uv, uv), SphereData(**sph), device="cpu"),
                   *rays(n, -1.5, 1.5, 2, ((0.2, -0.1, 0.3), 0.7)))

    scene = dict(xres=16, yres=16, spp=2, maxdepth=2)
    ref = ref_cornell_renderer(**scene)
    want = np.asarray(ref.film.to_rgb(ref.render(progress=False)))
    fused = intersect_soa.fma
    for label, fma in (("fma", fused), ("plain float32", lambda a, b, c: a * b + c)):
        intersect_soa.fma = fma
        if fma is not fused:
            compare_sweeps(f"Cornell sweep, {label} rounding", ref_sweep, port_c.intersector,
                           *cornell_rays)
        port = cornell_renderer(**scene, device="cpu")
        got = port.image(port.render())
        close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
        print(f"Cornell 16x16, 2 spp, maxdepth 2, {label} rounding: mean rel diff "
              f"{abs(got.mean() - want.mean()) / want.mean():.3e}, {close:.4f} of pixels "
              "within rtol 1e-3 / atol 1e-4")
    intersect_soa.fma = fused


if __name__ == "__main__":
    main()
