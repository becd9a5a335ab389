#!/usr/bin/env python3
"""Config 4's gradient, lane by lane.

On a CUDA card (the default):

    python3 scripts/config4_lanes.py

1. for each of the 4 samples of ``chip_smoke.py`` phase 11's gradient
   step (256x256, maxdepth 5), the pixels whose one-sample gradient has
   a non-finite leaf (bisection over the pixels, at most 6 per sample),
   and for each the operation torch's anomaly mode names;
2. at 16x16, 2 spp, maxdepth 5: the lanes whose radiance differs between
   the card and the CPU by more than 1e-5 relative, and how many camera
   rays are bit-equal.

On the CPU, the reference's ``jax.grad`` of one pixel's one-sample loss
(sample 0) at full width, its roughness leaf printed beside the port's
(the reference compiles for minutes):

    JAX_PLATFORMS=cpu python3 scripts/config4_lanes.py --reference 97 93
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def one_sample_loss(r, s):
    import torch

    from pbrt_tpu_torch.diff.grad import make_radiance_fn

    rad = make_radiance_fn(r)

    def loss(theta, px):
        sidx = torch.full((px.shape[0],), s, dtype=torch.int64, device=px.device)
        return torch.mean((rad(theta, px, sidx) - 0.2) ** 2)

    return loss


def finite(tree):
    import torch

    return all(finite(v) if isinstance(v, dict) else bool(torch.isfinite(v).all())
               for v in tree.values())


def nan_sweep():
    import torch

    from pbrt_tpu_torch.diff.grad import value_and_grad
    from pbrt_tpu_torch.testscenes import config4_renderer

    env, tex = cs.config4_maps()
    r, _ = config4_renderer(env, tex, **cs.CONFIG4, device="cuda")
    theta = r.compiled.initial_theta()
    px_all = torch.as_tensor(r.film.cropped_pixel_bounds.offsets(), device="cuda")
    for s in range(cs.CONFIG4_GRAD_SPP):
        loss = one_sample_loss(r, s)
        found = []

        def find(px):
            if len(found) >= 6 or finite(value_and_grad(loss, theta, px)[1]):
                return
            if px.shape[0] == 1:
                found.append(px)
                return
            find(px[:px.shape[0] // 2])
            find(px[px.shape[0] // 2:])

        find(px_all)
        print(f"sample {s}: non-finite pixels {[p.tolist()[0] for p in found]}", flush=True)
        for p in found:
            with torch.autograd.detect_anomaly(check_nan=True):
                try:
                    value_and_grad(loss, theta, p)
                except RuntimeError as e:
                    print(f"  pixel {p.tolist()[0]}: {e}", flush=True)


def lane_diff():
    import torch

    from pbrt_tpu_torch.diff.grad import make_radiance_fn
    from pbrt_tpu_torch.testscenes import config4_renderer

    env, tex = cs.config4_maps()
    rs = {dev: config4_renderer(env, tex, xres=16, yres=16, spp=2, maxdepth=5, device=dev)[0]
          for dev in ("cuda", "cpu")}
    px = rs["cpu"].film.cropped_pixel_bounds.offsets()
    for s in range(2):
        out = {}
        for dev, r in rs.items():
            p = torch.as_tensor(px, device=dev)
            sidx = torch.full((p.shape[0],), s, device=dev)
            with torch.no_grad():
                out[dev] = make_radiance_fn(r)(r.compiled.initial_theta(), p, sidx).cpu().numpy()
                u_lens = r.sampler.get2(p, sidx, 2)
                p_film = p.to(torch.float32) + r.sampler.get2(p, sidx, 0)
                out[dev + " d"] = r.camera.generate_rays(p_film, u_lens)[1].cpu().numpy()
        rel = (np.abs(out["cuda"] - out["cpu"]).max(1)
               / np.maximum(np.abs(out["cpu"]).max(1), 1e-6))
        worst = np.argsort(-rel)[:4]
        print(f"sample {s}: {int((rel > 1e-5).sum())} of {len(rel)} lanes differ by more than "
              f"1e-5 relative, worst {[(px[i].tolist(), float(rel[i])) for i in worst]}; "
              f"camera rays bit-equal {int((out['cuda d'] == out['cpu d']).all(1).sum())} of "
              f"{len(px)}", flush=True)


def reference_pixel(x, y):
    import jax
    import jax.numpy as jnp
    import torch

    from pbrt_tpu import Options as RefOptions
    from pbrt_tpu.core.api import PbrtAPI as RefAPI
    from pbrt_tpu.diff.grad import make_loss_fn as ref_make_loss_fn
    from pbrt_tpu.render import Renderer as RefRenderer
    from pbrt_tpu.testscenes import _torus_mesh_params as ref_torus_params
    from pbrt_tpu_torch.diff.grad import value_and_grad
    from pbrt_tpu_torch.testscenes import config4_renderer, config4_text

    env, tex = cs.config4_maps()
    head, tail = config4_text(env, tex, **{k: cs.CONFIG4[k]
                                           for k in ("xres", "yres", "spp", "maxdepth")})
    api = RefAPI(RefOptions(ray_batch=cs.CONFIG4["ray_batch"]), render_on_world_end=False)
    api.init()
    api.parse_string(head)
    api.shape("trianglemesh", ref_torus_params(224, 112)[0])
    api.parse_string(tail)
    api.scene.film_params.add_int("xresolution", [cs.CONFIG4["xres"]])
    api.scene.film_params.add_int("yresolution", [cs.CONFIG4["yres"]])
    ref = RefRenderer(api.scene, api.opt, seed=0)
    target = np.full((cs.CONFIG4["yres"], cs.CONFIG4["xres"], 3), 0.2, np.float32)
    g = jax.jit(jax.grad(ref_make_loss_fn(ref, target, spp=1)))(
        ref.compiled.initial_theta(), jnp.asarray(np.array([[x, y]], np.int32)))
    r, _ = config4_renderer(env, tex, **cs.CONFIG4, device="cpu")
    _, mine = value_and_grad(one_sample_loss(r, 0), r.compiled.initial_theta(),
                             torch.tensor([[x, y]]))
    print(f"pixel ({x}, {y}), sample 0: roughness, reference {np.asarray(g['roughness'])}, "
          f"port {mine['roughness'].numpy()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference", nargs=2, type=int, metavar=("X", "Y"))
    args = ap.parse_args(argv)
    if args.reference:
        reference_pixel(*args.reference)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("config4_lanes: needs a CUDA card (or --reference X Y on the CPU)")
    from pbrt_tpu_torch.kernels import bitonic, build, bvh2_walk, bvh8_walk

    build.build()
    for mod in (bvh8_walk, bvh2_walk, bitonic):
        mod.load_library()
    nan_sweep()
    lane_diff()


if __name__ == "__main__":
    main()
