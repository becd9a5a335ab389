#!/usr/bin/env python3
"""How closely the port's participating media follow the reference's
compiled rounding on the CPU, and how many eager ops a volume chunk
dispatches.

The reference evaluates its media compiled by XLA, whose CPU code fuses
a multiply into the add that consumes it, divides by a constant as a
product with its float32 reciprocal, and takes ``log`` and ``exp`` from
polynomials of its own.  ``pbrt_tpu_torch/media`` follows the first two
where tracking decides (the flight, the density's lerps, HG's cosine)
and keeps torch's ``log``/``exp``.  On 4,096 seeded rays through an 8^3
grid (those of ``tests/test_torch_media.py``) this prints: the track
stream's bit-equality; the density's; delta tracking's masks, distances
and ratio tracking's transmittance against the jitted reference; the
share of float32 inputs on which XLA's ``log`` differs from torch's; HG's
cosine and direction; the spot light's radiance.  Then the eager aten
ops of one volpath chunk of the fog-and-smoke scene (a 24x24 torus, 8^3
grid, maxdepth 5; the walks' own ops excluded), counted by a
``TorchDispatchMode``: the launches a frame makes on the card, per
chunk, with the fused roundings and with plain float32 ones.

What the fused roundings buy and cost: ``--plain`` swaps them for plain
float32 ones (the lerps ``a (1 - f) + b f``, the flight ``t - log(1 - u) /
sig_bar``, HG's cosine op by op) and prints the share of tracking masks
that then differ from the reference's, and the 16x16 volume scene's
image gap to the reference's (the test's scene) both ways.  ``--card``
(on a CUDA card; no JAX) times the full-width fog-and-smoke frame (256x256,
8 spp, maxdepth 5, a 64^3 grid, 2 chunks) with the fused and the plain
roundings in ten pairs (fused, plain, plain, fused, ... after one warm
frame each).

    JAX_PLATFORMS=cpu python3 scripts/media_rounding.py [--plain]
    python3 scripts/media_rounding.py --card
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 4096
_FUSED = {}


def set_rounding(plain):
    """Plain float32 roundings in ``pbrt_tpu_torch.media`` (True) or its
    own fused ones (False)."""
    import torch

    from pbrt_tpu_torch import media as P

    G = P.GridDensityMedium
    if not _FUSED:
        _FUSED.update(fma=P.fma, flight=G.__dict__["_flight"], density_at=G.density_at)
    if plain:
        P.fma = lambda x, y, z: x * y + z
        G._flight = staticmethod(
            lambda u, t, sig_bar: t - torch.log(torch.clamp(1.0 - u, min=1e-10)) / sig_bar)
        G.density_at = _plain_density_at
    else:
        P.fma = _FUSED["fma"]
        G._flight, G.density_at = _FUSED["flight"], _FUSED["density_at"]


def _plain_density_at(self, p_world):
    """``GridDensityMedium.density_at`` with its lerps rounded op by op."""
    import torch

    from pbrt_tpu_torch.core.transform import apply_point

    pm = apply_point(self.w2m, p_world)
    nz, ny, nx = self.density.shape
    g = [pm[..., k] * n - 0.5 for k, n in enumerate((nx, ny, nz))]
    inside = ((pm >= 0) & (pm <= 1)).all(dim=-1)
    i0 = [torch.clamp(torch.floor(gk).to(torch.int64), 0, n - 1) for gk, n in zip(g, (nx, ny, nz))]
    i1 = [torch.clamp(ik + 1, max=n - 1) for ik, n in zip(i0, (nx, ny, nz))]
    fx, fy, fz = (torch.clamp(gk - ik, 0, 1) for gk, ik in zip(g, i0))
    flat = self.density.reshape(-1)

    def lerp_x(z, y):
        row = (z * ny + y) * nx
        return flat[row + i0[0]] * (1 - fx) + flat[row + i1[0]] * fx

    c0 = lerp_x(i0[2], i0[1]) * (1 - fy) + lerp_x(i0[2], i1[1]) * fy
    c1 = lerp_x(i1[2], i0[1]) * (1 - fy) + lerp_x(i1[2], i1[1]) * fy
    return torch.where(inside, c0 * (1 - fz) + c1 * fz, 0.0)


def rounding():
    import jax
    import jax.numpy as jnp
    import torch

    from pbrt_tpu import media as R
    from pbrt_tpu_torch import media as P

    rs = np.random.default_rng(0)
    pix = rs.integers(0, 1024, size=(N, 2)).astype(np.int32)
    sidx = rs.integers(0, 256, size=N).astype(np.int32)
    tp, ts = torch.as_tensor(pix).long(), torch.as_tensor(sidx).long()
    want = jax.jit(lambda: R.make_track_rng(jnp.asarray(pix), jnp.asarray(sidx), 77)(
        jnp.uint32(5)))()
    got = P.make_track_rng(tp, ts, 77)(5).numpy()
    print(f"track stream: {np.mean(got.view(np.uint32) == np.asarray(want).view(np.uint32)):.4f}"
          " of lanes bit-equal")
    o = rs.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    d = rs.uniform(-0.5, 0.5, size=(N, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    u = rs.uniform(size=N).astype(np.float32)
    t_hit = rs.uniform(0.2, 4.0, size=N).astype(np.float32)
    w2m = np.linalg.inv(np.array([[1.2, 0, 0, -0.6], [0, 1.2, 0, -0.5], [0, 0, 1.3, -0.7],
                                  [0, 0, 0, 1]]))
    grid = rs.uniform(0.0, 1.0, size=(8, 8, 8)).astype(np.float32)
    mr = R.GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, grid, w2m)
    mp = P.GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, grid, w2m, device="cpu")
    T = torch.as_tensor
    pts = (o + d * rs.uniform(0, 3, size=(N, 1))).astype(np.float32)
    dens_w = np.asarray(jax.jit(mr.density_at)(pts))
    print(f"density: {np.mean(mp.density_at(T(pts)).numpy() == dens_w):.4f} of lanes bit-equal")
    rng_w = lambda salt: R.make_track_rng(jnp.asarray(pix), jnp.asarray(sidx), salt)  # noqa: E731
    t_w, s_w, _ = (np.asarray(x) for x in jax.jit(
        lambda o, d, u, th: mr.sample(o, d, u, th, rng_w(77)))(o, d, u, t_hit))
    t_g, s_g, _ = (x.numpy() for x in mp.sample(T(o), T(d), T(u), T(t_hit),
                                                P.make_track_rng(tp, ts, 77)))
    print(f"delta tracking: masks equal on {np.mean(s_g == s_w):.4f} of lanes; t bit-equal on "
          f"{np.mean(t_g == t_w):.4f}, max rel diff {np.max(np.abs(t_g - t_w) / t_w):.3e}")
    tr_w = np.asarray(jax.jit(lambda o, d, th: mr.tr(o, d, th, rng_w(78)))(o, d, t_hit))
    tr_g = mp.tr(T(o), T(d), T(t_hit), P.make_track_rng(tp, ts, 78)).numpy()
    print(f"ratio tracking: bit-equal on {np.mean(tr_g == tr_w):.4f}, max abs diff "
          f"{np.abs(tr_g - tr_w).max():.3e}, smallest Tr {tr_w.min():.3e}")
    x = np.maximum(1 - rs.uniform(size=100000), 1e-10).astype(np.float32)
    lx = np.asarray(jax.jit(jnp.log)(x))
    lt = torch.log(T(x)).numpy()
    ulps = lx.view(np.int32).astype(np.int64) - lt.view(np.int32)
    print(f"log: XLA's differs from torch's on {np.mean(ulps != 0):.4f} of 100,000 inputs "
          f"(at most {np.abs(ulps).max()} ulp)")
    u2 = rs.uniform(size=(N, 2)).astype(np.float32)
    gs = rs.uniform(-0.9, 0.9, size=N).astype(np.float32)
    wi_w, pdf_w = (np.asarray(v) for v in jax.jit(R.hg_sample)(d, u2, gs))
    wi_g, pdf_g = (v.numpy() for v in P.hg_sample(T(d), T(u2), T(gs)))
    print(f"HG sample: pdf bit-equal on {np.mean(pdf_g == pdf_w):.4f}; wi max abs diff "
          f"{np.abs(wi_g - wi_w).max():.3e}")
    spot()


def spot():
    import jax
    import torch

    from pbrt_tpu import Options as RO
    from pbrt_tpu.core.api import PbrtAPI as RA
    from pbrt_tpu.lights import make_light as ref_make_light
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.lights import make_light

    text = """WorldBegin
AttributeBegin
  Translate 0.3 -0.2 0.5
  Rotate 25 1 0.5 0
  LightSource "spot" "rgb I" [3 2 1] "point from" [0 0 2] "point to" [0.2 0.1 0]
    "float coneangle" 35 "float conedeltaangle" 10
AttributeEnd
WorldEnd"""
    ra = RA(RO(), render_on_world_end=False)
    ra.init()
    ra.parse_string(text)
    pa = PbrtAPI(render_on_world_end=False, device="cpu")
    pa.init()
    pa.parse_string(text)
    rl, pl = ref_make_light(ra.scene.lights[0]), make_light(pa.scene.lights[0], device="cpu")
    p = np.random.default_rng(4).uniform(-2.0, 2.0, size=(N, 3)).astype(np.float32)
    li_w = np.asarray(jax.jit(rl.sample_li)(p, None)[1])
    li_g = pl.sample_li(torch.as_tensor(p), None)[1].numpy()
    lit = li_w > 0
    print(f"spot: li bit-equal on {np.mean(li_g == li_w):.4f}; max rel diff "
          f"{np.max(np.abs(li_g - li_w)[lit] / li_w[lit]):.3e}, max abs {np.abs(li_g - li_w).max():.3e}")


def plain_share():
    """The tracking masks and the 16x16 volume image against the
    reference's, with plain float32 roundings and with the fused ones."""
    import jax
    import jax.numpy as jnp
    import torch

    from pbrt_tpu import Options as RO
    from pbrt_tpu import media as R
    from pbrt_tpu.core.api import PbrtAPI as RA
    from pbrt_tpu.render import render_scene as ref_render
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch import media as P
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import render_scene
    from pbrt_tpu_torch.testscenes import volume_text, write_torus_ply

    rs = np.random.default_rng(0)
    pix = rs.integers(0, 1024, size=(N, 2)).astype(np.int32)
    sidx = rs.integers(0, 256, size=N).astype(np.int32)
    tp, ts = torch.as_tensor(pix).long(), torch.as_tensor(sidx).long()
    o = rs.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    d = rs.uniform(-0.5, 0.5, size=(N, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    u = rs.uniform(size=N).astype(np.float32)
    t_hit = rs.uniform(0.2, 4.0, size=N).astype(np.float32)
    w2m = np.linalg.inv(np.array([[1.2, 0, 0, -0.6], [0, 1.2, 0, -0.5], [0, 0, 1.3, -0.7],
                                  [0, 0, 0, 1]]))
    grid = rs.uniform(0.0, 1.0, size=(8, 8, 8)).astype(np.float32)
    mr = R.GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, grid, w2m)
    rng_w = lambda salt: R.make_track_rng(jnp.asarray(pix), jnp.asarray(sidx), salt)  # noqa: E731
    s_w = np.asarray(jax.jit(lambda o, d, u, th: mr.sample(o, d, u, th, rng_w(77)))(
        o, d, u, t_hit)[1])
    tr_w = np.asarray(jax.jit(lambda o, d, th: mr.tr(o, d, th, rng_w(78)))(o, d, t_hit))
    with tempfile.TemporaryDirectory() as tmp:
        write_torus_ply(f"{tmp}/t.ply", nu=24, nv=24)
        text = volume_text(f"{tmp}/t.ply", xres=16, yres=16, spp=2, maxdepth=3, grid=8)
        api = RA(RO(ray_batch=1 << 16), render_on_world_end=False)
        api.init()
        api.parse_string(text)
        want = ref_render(api.scene, api.opt, write=False)["image"]
        for plain in (False, True):
            set_rounding(plain)
            mp = P.GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, grid, w2m, device="cpu")
            T = torch.as_tensor
            s_g = mp.sample(T(o), T(d), T(u), T(t_hit), P.make_track_rng(tp, ts, 77))[1].numpy()
            tr_g = mp.tr(T(o), T(d), T(t_hit), P.make_track_rng(tp, ts, 78)).numpy()
            pa = PbrtAPI(Options(ray_batch=1 << 16), render_on_world_end=False, device="cpu")
            pa.init()
            pa.parse_string(text)
            got = render_scene(pa.scene, pa.opt, write=False, device="cpu")["image"]
            rel = abs(got.mean() - want.mean()) / want.mean()
            close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
            print(f"{'plain' if plain else 'fused'} roundings: delta-tracking masks differ on "
                  f"{np.mean(s_g != s_w):.4f} of {N} lanes; ratio tracking max abs diff "
                  f"{np.abs(tr_g - tr_w).max():.3e}; 16x16 volume image mean rel diff "
                  f"{rel:.3e}, {close:.4f} of pixels within rtol 1e-3 / atol 1e-4")
        set_rounding(False)


PAIRS = 10


def frame_cost():
    """The full-width fog-and-smoke frame on the card, fused against plain
    roundings: ``PAIRS`` pairs after one warm frame each, alternating which
    side runs first (F P P F ...)."""
    import subprocess
    import time

    import torch

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import write_volume_scene

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
    os.makedirs(out, exist_ok=True)
    write_volume_scene(f"{out}/volume.pbrt", f"{out}/volume_torus.ply", xres=256, yres=256,
                       spp=8, maxdepth=5, grid=64)
    api = PbrtAPI(Options(ray_batch=1 << 18), render_on_world_end=False, device="cuda")
    api.init()
    api.parse_file(f"{out}/volume.pbrt")
    r = Renderer(api.scene, api.opt, device="cuda")

    def frame():
        torch.cuda.synchronize()
        t0 = time.time()
        img = r.image(r.render(progress=False))
        torch.cuda.synchronize()
        return time.time() - t0, img

    imgs, times = {}, {False: [], True: []}
    for plain in (False, True):
        set_rounding(plain)
        imgs[plain] = frame()[1]
    for plain in (False, True, True, False) * (PAIRS // 2):
        set_rounding(plain)
        times[plain].append(frame()[0])
    set_rounding(False)
    a, b = imgs[False], imgs[True]
    print(f"card: {card}")
    f, p = np.asarray(times[False]), np.asarray(times[True])
    print(f"volume frame, fused roundings: {f.tolist()} s; plain: {p.tolist()} s; medians "
          f"{np.median(f):.4f} / {np.median(p):.4f} s, quartile spreads "
          f"{np.subtract(*np.percentile(f, [75, 25])):.4f} / "
          f"{np.subtract(*np.percentile(p, [75, 25])):.4f} s; plain faster in "
          f"{int(np.sum(p < f))} of {PAIRS} pairs; image "
          f"mean rel diff {abs(b.mean() - a.mean()) / a.mean():.3e}, "
          f"{np.isclose(b, a, rtol=1e-3, atol=1e-4).all(axis=-1).mean():.4f} of pixels close")


def op_count():
    from torch.utils._python_dispatch import TorchDispatchMode

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import write_volume_scene

    with tempfile.TemporaryDirectory() as tmp:
        write_volume_scene(f"{tmp}/v.pbrt", f"{tmp}/t.ply", nu=24, nv=24, xres=4, yres=4, spp=1,
                           maxdepth=5, grid=8)
        api = PbrtAPI(Options(), render_on_world_end=False, device="cpu")
        api.init()
        api.parse_file(f"{tmp}/v.pbrt")
        r = Renderer(api.scene, api.opt, device="cpu")
    itx = r.compiled.intersector
    on = [True]

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += on[0]
            return func(*args, **(kwargs or {}))

    def quiet(f):
        def g(*a, **k):
            on[0] = False
            try:
                return f(*a, **k)
            finally:
                on[0] = True
        return g

    itx.intersect, itx.occluded = quiet(itx.intersect), quiet(itx.occluded)
    for plain in (False, True):
        set_rounding(plain)
        Count.n = 0
        with Count():
            r.render(progress=False)
        print(f"volume scene, {'plain' if plain else 'fused'} roundings: {Count.n} eager ops "
              f"in one chunk, the walks' own excluded ({r.integrator.queries_per_sample()} "
              "sweeps per lane)")
    set_rounding(False)


if __name__ == "__main__":
    if "--card" in sys.argv[1:]:
        frame_cost()
    elif "--plain" in sys.argv[1:]:
        plain_share()
    else:
        rounding()
        op_count()
