#!/usr/bin/env python3
"""How closely the port's noise textures follow the reference's compiled
rounding, on the CPU.

The reference evaluates its textures compiled by XLA, whose CPU code
fuses a multiply into the add that consumes it;
``pbrt_tpu_torch/textures/noise.py`` rounds the noise weights, the octave
sums and marble's sine argument the same way (``core/geometry.fma``) and
leaves the trilinear lerps plain.  This script evaluates fbm (5 octaves),
wrinkled (6), windy and marble on 2048 seeded points (those of
``tests/test_torch_scenefile.py``), under a transform float32 applies
exactly and under a general one, and prints for each: the lanes beyond
rtol 1e-5 / atol 1e-6 of the jitted reference, the largest gap, and the
lanes not bit-equal; with the port's rounding, with plain float32 in
place of every fma, and with the lerps fused as well.

    JAX_PLATFORMS=cpu python3 scripts/noise_rounding.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M = np.array([[0.8, 0.2, 0.0, 1.0], [0.0, 1.5, 0.1, -2.0], [0.3, 0.0, 0.8, 0.5],
              [0.0, 0.0, 0.0, 1.0]])
M_EXACT = np.array([[2.0, 0.0, 0.0, 0.5], [0.0, 0.5, 0.0, -1.0], [0.0, 0.0, 4.0, 0.25],
                    [0.0, 0.0, 0.0, 1.0]])
CASES = [("fbm", False, [("int", "octaves", [5]), ("float", "roughness", [0.6])]),
         ("wrinkled", False, [("int", "octaves", [6])]),
         ("windy", True, []),
         ("marble", True, [("float", "scale", [2.5]), ("float", "variation", [0.4])])]


def build(P, TP, T, factories, m):
    out = []
    for name, spectral, items in CASES:
        ps = P()
        for kind, k, v in items:
            getattr(ps, f"add_{kind}")(k, v)
        out.append(factories[name](T(m), TP(ps, ps, {}, {}), spectral))
    return out


def main():
    import jax
    import jax.numpy as jnp
    import torch

    from pbrt_tpu.core.paramset import ParamSet as RefParamSet
    from pbrt_tpu.core.paramset import TextureParams as RefTextureParams
    from pbrt_tpu.core.transform import Transform as RefTransform
    from pbrt_tpu.textures.factories import FACTORIES as REF_FACTORIES
    from pbrt_tpu_torch.core.paramset import ParamSet, TextureParams
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.textures import noise
    from pbrt_tpu_torch.textures.factories import FACTORIES

    gen = np.random.default_rng(5)
    p = (gen.normal(size=(2048, 3)) * 3).astype(np.float32)
    si_ref, si = {"p": jnp.asarray(p)}, {"p": torch.as_tensor(p)}
    fused, lerp = noise.fma, noise._lerp
    variants = [("port", fused, lerp),
                ("plain float32", lambda x, y, z: x * y + z, lerp),
                ("lerps fused too", fused, lambda a, b, w: fused(w, b - a, a))]
    for label, m in (("exact transform", M_EXACT), ("general transform", M)):
        refs = build(RefParamSet, RefTextureParams, RefTransform, REF_FACTORIES, m)
        wants = jax.jit(lambda si: [r.eval(si) for r in refs])(si_ref)
        ports = build(ParamSet, TextureParams, Transform, FACTORIES, m)
        for vlabel, f, lp in variants:
            noise.fma, noise._lerp = f, lp
            cells = []
            for (name, _, _), want, port in zip(CASES, wants, ports):
                want = np.asarray(want)
                got = port.eval(si).numpy()
                past = int((~np.isclose(got, want, rtol=1e-5, atol=1e-6)).sum())
                cells.append(f"{name} {past}/{want.size} past, max {np.abs(got - want).max():.3g}, "
                             f"{int((got != want).sum())} not bit-equal")
            print(f"{label}, {vlabel}: " + "; ".join(cells))
        noise.fma, noise._lerp = fused, lerp


if __name__ == "__main__":
    main()
