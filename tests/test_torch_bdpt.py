"""Bidirectional path tracing in pbrt_tpu_torch against the JAX reference
on the CPU: tests/test_mlt.py's caustic (a glass sphere under a point
light: the light-tracing splats) and tests/test_sppm.py's box (an area
light), pinhole and thin-lens, at 24x24, maxdepth 3; the MIS ratio walks
of every strategy on one chunk; the sweeps BDPT issues; the camera's
importance; the film's splat channel; and the samplers on the keys BDPT
reads outside the film.

Images are held to the tolerance of the other scene tests (image-mean
relative difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol
1e-4), the filtered film and the splat channel each on its own.  The
reference renders under ``jax.jit``, as its renderer does; each scene is
rendered once per package.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.render import Renderer as RefRenderer

RES, SPP, MAXDEPTH = 24, 8, 3
LANES = RES * RES * SPP


def _same_image(label, got, want):
    assert np.isfinite(got).all() and got.max() > 0, label
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    print(f"{label}: mean {got.mean():.6f} (reference {want.mean():.6f}), mean rel diff "
          f"{rel_mean:.3e}, {close:.4f} of pixels close")
    assert rel_mean <= 1e-3, (label, rel_mean)
    assert close >= 0.99, (label, close)


def _renderers(text, ray_batch):
    """(reference Renderer, port Renderer on the CPU) of scene text."""
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    api = RefAPI(RefOptions(ray_batch=ray_batch), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    port_api = PbrtAPI(Options(ray_batch=ray_batch), render_on_world_end=False, device="cpu")
    port_api.init()
    port_api.parse_string(text)
    return (RefRenderer(api.scene, api.opt),
            Renderer(port_api.scene, port_api.opt, device="cpu"))


def _compare_renders(label, ref, port, splats=True):
    """Both renders: the filtered film and the splat channel, each held to
    the image tolerance; returns the port's film state."""
    want = ref.render(progress=False)
    got = port.render(progress=False)
    ref_film = {k: np.asarray(v) for k, v in want.items()}
    _same_image(f"{label} film", port.film.to_rgb(got, splat_scale=0.0).numpy(),
                np.asarray(ref.film.to_rgb(want, splat_scale=0.0)))
    splat = ref_film["splat_xyz"]
    if splats:
        assert splat.max() > 0, label
        _same_image(f"{label} splats", got["splat_xyz"].numpy(), splat)
    else:
        assert not splat.any() and not got["splat_xyz"].any(), label
    _same_image(f"{label} image", port.image(got), np.asarray(ref.film.to_rgb(want)))
    return got


def _capture_walks(integrator):
    """Record every output of the integrator's two MIS ratio walks."""
    got = []
    for name in ("_cam_side_sum", "_light_side_sum"):
        orig = getattr(type(integrator), name)

        def wrapped(self, *a, _orig=orig, **kw):
            got.append(_orig(self, *a, **kw))
            return got[-1]

        setattr(integrator, name, types.MethodType(wrapped, integrator))
    return got


def _count_sweeps(renderer):
    """Count the closest and any-hit sweeps the intersector sees."""
    itx = renderer.compiled.intersector
    counts = {"closest": 0, "shadow": 0}

    def counted(fn, key):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    itx.intersect = counted(itx.intersect, "closest")
    itx.occluded = counted(itx.occluded, "shadow")
    return counts


def test_bdpt_caustic_against_reference():
    """The caustic under bdpt at 24x24, 8 spp, maxdepth 3 with a 1000-lane
    ray batch (5 chunks, the last partial: the scatter film and the splats
    of padding lanes masked): both channels against the reference; on the
    first chunk, the radiance, the splats and every output of the two MIS
    ratio walks (every strategy's weight) within rtol 1e-5 (but for the
    grazing lanes below); the sweeps a counting intersector sees equal to
    ``queries_per_sample``."""
    import torch

    from pbrt_tpu_torch.integrators.bdpt import BDPTIntegrator
    from pbrt_tpu_torch.testscenes import caustic_text

    ref, port = _renderers(caustic_text("bdpt", RES, RES, SPP, MAXDEPTH), 1000)
    bd = port.integrator
    assert type(bd) is BDPTIntegrator and bd.enable_t0 and (bd.t_max, bd.s_max) == (4, 3)
    counts = _count_sweeps(port)
    _compare_renders("caustic", ref, port)
    chunks = -(-LANES // 1000)
    assert port.counters["chunks"] == chunks == 5
    # per lane: 4 + 3 closest; 4 NEE, and for s = 2, 3 one light-tracing
    # ray and 4 connections
    assert bd.queries_per_sample() == (7, 14)
    assert counts == {"closest": 7 * chunks, "shadow": 14 * chunks}
    assert port.counters["closest_queries"] == 7 * LANES

    pix = np.arange(1000) // SPP
    pixel_xy = np.stack([pix % RES, pix // RES], axis=-1).astype(np.int32)
    sidx = (np.arange(1000) % SPP).astype(np.uint32)
    ref_walks = _capture_walks(ref.integrator)

    def ref_chunk(pixel_xy, sidx):
        ref_walks.clear()
        sampler = ref.sampler.bounded(SPP)
        p_film = pixel_xy.astype(jnp.float32) + sampler.get2(pixel_xy, sidx, 0)
        o, d, _ = ref.camera.generate_rays(p_film, sampler.get2(pixel_xy, sidx, 2))
        L, splats = ref.integrator.li_splat(sampler, pixel_xy, sidx, o, d)
        return L, splats, list(ref_walks)

    want_L, want_splats, want_walks = jax.jit(ref_chunk)(pixel_xy, sidx)
    port_walks = _capture_walks(bd)
    sampler = port.sampler.bounded(SPP)
    t_pix = torch.as_tensor(pixel_xy.astype(np.int64))
    t_si = torch.as_tensor(sidx.astype(np.int64))
    with torch.no_grad():
        p_film = t_pix.to(torch.float32) + sampler.get2(t_pix, t_si, 0)
        o, d, _ = port.camera.generate_rays(p_film, sampler.get2(t_pix, t_si, 2))
        L, splats = bd.li_splat(sampler, t_pix, t_si, o, d)
    np.testing.assert_allclose(L.numpy(), np.asarray(want_L), rtol=1e-5, atol=1e-6)
    assert len(splats) == len(want_splats) == 2 and splats[0][2].any()
    for (ps, Ls, ms), (wp, wl, wm) in zip(splats, want_splats):
        np.testing.assert_array_equal(ms.numpy(), np.asarray(wm))
        np.testing.assert_allclose(ps.numpy()[ms.numpy()], np.asarray(wp)[ms.numpy()],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Ls.numpy()[ms.numpy()], np.asarray(wl)[ms.numpy()],
                                   rtol=1e-5, atol=1e-7)
    # the s = 1 camera walks (t = 1..4; no area light, so no s = 0 walk);
    # for s = 2, 3: t = 0's light walk, then each t's camera and light walks
    assert len(port_walks) == len(want_walks) == 4 + 2 * (1 + 2 * 4)
    # the weight 1 / (1 + sum) of each walk within rtol 1e-5, but on lanes
    # whose connection runs inside the floor's plane (|cos| ~ 3e-8 at both
    # ends, a geometry term ~ 1e-15): there a hemisphere test flips on the
    # last bit of a cosine, and at most 2 of the 1000 lanes may differ
    worst, flipped = 0.0, 0
    for i, (g, w) in enumerate(zip(port_walks, want_walks)):
        gw = 1.0 / (1.0 + g.numpy().astype(np.float64))
        ww = 1.0 / (1.0 + np.asarray(w, np.float64))
        same = np.isclose(gw, ww, rtol=1e-5, atol=1e-7, equal_nan=True)
        assert (~same).sum() <= 2, (i, np.where(~same)[0], g.numpy()[~same], np.asarray(w)[~same])
        flipped += int((~same).sum())
        fin = same & np.isfinite(ww)
        worst = max(worst, float(np.abs(gw - ww)[fin].max(initial=0.0)))
    print(f"MIS ratio walks: {len(port_walks)} outputs of 1000 lanes, largest weight gap "
          f"{worst:.3e}, {flipped} lane weights flipped by a grazing hemisphere test")


def test_bdpt_box_and_partial_chunks_against_reference():
    """tests/test_sppm.py's box (an area light: light subpaths from its
    triangles, the s = 0 walk) under bdpt at 24x24, 8 spp, maxdepth 3 in one
    chunk; then under path with a 90-lane ray batch (88-lane chunks of 11
    pixels, the 53rd partial: the dense film)."""
    from pbrt_tpu_torch.testscenes import gi_box_text

    ref, port = _renderers(gi_box_text("bdpt", RES, RES, SPP, MAXDEPTH), LANES)
    _compare_renders("box", ref, port)
    assert port.counters["chunks"] == 1
    ref, port = _renderers(gi_box_text("path", RES, RES, SPP, MAXDEPTH), 90)
    _compare_renders("box, path, ray_batch 90", ref, port, splats=False)
    assert port.counters["chunks"] == 53


def test_bdpt_thin_lens_against_reference():
    """The box through a thin lens (``lensradius`` 0.05, focal distance
    3.5): no light tracing (``supports_light_tracing`` false), so no
    splat and no t = 0 partition in any MIS denominator, and fewer sweeps."""
    from pbrt_tpu_torch.testscenes import gi_box_text

    text = gi_box_text("bdpt", RES, RES, SPP, MAXDEPTH,
                       camera='"float lensradius" 0.05 "float focaldistance" 3.5')
    ref, port = _renderers(text, LANES)
    assert not port.camera.supports_light_tracing and not port.integrator.enable_t0
    assert port.integrator.queries_per_sample() == (7, 12)
    _compare_renders("thin-lens box", ref, port, splats=False)


def test_camera_importance_film_splats_and_samplers_against_reference(tmp_path):
    """``pdf_we_dir`` and ``project`` on 4096 seeded directions and points
    (a 32x20 film: the frustum's edges) within rtol 1e-5; ``add_splats``
    on a cropped film with splats left of, above, inside, right of and
    below the crop, against the reference's scatter (its NumPy-style wrap
    of negative offsets), and ``to_rgb``'s splat scale; a checkpoint
    carries the splat channel; every sampler on the keys BDPT reads
    outside the film (the light subpath's offset pixels, the origin's
    (lane, -13)) at every dimension BDPT and MLT use, and on SPPM's photon
    keys ((lane, -7) and (lane, -9), sample index = iteration), bit-equal."""
    import torch

    from pbrt_tpu.core.paramset import ParamSet as RefParamSet
    from pbrt_tpu.samplers import make_sampler as ref_make_sampler
    from pbrt_tpu_torch.core.paramset import ParamSet
    from pbrt_tpu_torch.samplers import make_sampler
    from pbrt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from pbrt_tpu_torch.testscenes import caustic_text

    text = caustic_text("path", 32, 20, 2, 2).replace(
        'Film "image"', 'Film "image" "float cropwindow" [0.25 0.75 0.2 0.8]')
    ref, port = _renderers(text, 1 << 12)
    rs = np.random.default_rng(11)
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:2048] = np.asarray(ref.camera.generate_rays(
        rs.uniform([-2, -2], [34, 22], size=(2048, 2)).astype(np.float32))[1])
    want = np.asarray(jax.jit(ref.camera.pdf_we_dir)(d))
    got = port.camera.pdf_we_dir(torch.as_tensor(d)).numpy()
    assert 0.3 < (want > 0).mean() < 0.7
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert port.camera.film_area == pytest.approx(ref.camera.film_area, rel=1e-7)
    np.testing.assert_array_equal(port.camera.cam_pos_world, ref.camera.cam_pos_world)
    p = rs.uniform(-3, 3, size=(4096, 3)).astype(np.float32)
    want = [np.asarray(x) for x in jax.jit(ref.camera.project)(p)]
    got = [x.numpy() for x in port.camera.project(torch.as_tensor(p))]
    np.testing.assert_array_equal(got[1], want[1])
    assert 0.1 < want[1].mean() < 0.9
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g[want[1]], w[want[1]], rtol=1e-5, atol=1e-5)

    # the crop is pixels [8, 24) x [5, 17); splats from (-12, -8) to (36, 28)
    film, ref_film = port.film, ref.film
    b = film.cropped_pixel_bounds
    assert (b.p_min, b.p_max) == (ref_film.cropped_pixel_bounds.p_min,
                                  ref_film.cropped_pixel_bounds.p_max) == ((8, 5), (24, 17))
    pf = rs.uniform([-12, -8], [36, 28], size=(4096, 2)).astype(np.float32)
    L = rs.uniform(0, 1, size=(4096, 3)).astype(np.float32)
    mask = rs.uniform(size=4096) < 0.8
    want = ref_film.add_splats(ref_film.initial_state(), pf, L, mask)
    got = film.add_splats(film.initial_state(), torch.as_tensor(pf), torch.as_tensor(L),
                          torch.as_tensor(mask))
    np.testing.assert_allclose(got["splat_xyz"].numpy(), np.asarray(want["splat_xyz"]),
                               rtol=1e-6, atol=1e-6)
    assert not got["xyz"].any() and not got["weight"].any()
    np.testing.assert_allclose(film.to_rgb(got, splat_scale=0.25).numpy(),
                               np.asarray(ref_film.to_rgb(want, splat_scale=0.25)),
                               rtol=1e-6, atol=1e-6)
    save_checkpoint(tmp_path / "c.npz", got, 3, {"k": 1})
    back, cursor, meta = load_checkpoint(tmp_path / "c.npz", "cpu")
    assert cursor == 3 and torch.equal(back["splat_xyz"], got["splat_xyz"])

    # samplers, bounded as the renderer calls them: dims 0-39 of the light
    # subpath's keys, dims 0-73 of the origin's (MLT's table takes 73 + 5);
    # and unbounded, as SPPM calls them, SPPM's photon keys (lane, -7) and
    # (lane, -9) with the iteration as sample index
    pix = rs.integers(0, 256, size=(1024, 2)).astype(np.int32)
    lane = np.arange(1024)
    si = rs.integers(0, 8, size=1024).astype(np.uint32)
    iteration = np.full(1024, 13, np.uint32)
    keys = {"light": (pix + np.asarray([7919, 104729], np.int32), si, True),
            "origin": (np.stack([lane, np.full(1024, -13)], -1).astype(np.int32), si, True),
            "photon_emit": (np.stack([lane, np.full(1024, -7)], -1).astype(np.int32),
                            iteration, False),
            "photon_bounce": (np.stack([lane, np.full(1024, -9)], -1).astype(np.int32),
                              iteration, False)}
    ps, rps = ParamSet(), RefParamSet()
    ps.add_int("pixelsamples", [8])
    rps.add_int("pixelsamples", [8])
    for name in ("random", "stratified", "halton", "sobol", "02sequence", "maxmindist"):
        want_s = {False: ref_make_sampler(name, rps)}
        want_s[True] = want_s[False].bounded(8)
        got_s = {False: make_sampler(name, ps)}
        got_s[True] = got_s[False].bounded(8)
        dims = {"light": list(range(40)), "origin": list(range(0, 79, 3)),
                # emission: select, position, direction; bounces: time, lobe, u2
                "photon_emit": list(range(5)),
                "photon_bounce": [4] + [5 + 7 * b + j for b in range(4) for j in (3, 4, 5)]}
        # one reference program per sampler, every key and dimension in it
        want_all = jax.jit(lambda: {
            kname: jnp.stack([want_s[bounded].get(key, si, dim) for dim in dims[kname]])
            for kname, (key, si, bounded) in keys.items()})()
        for kname, (key, si, bounded) in keys.items():
            want = np.asarray(want_all[kname])
            got = torch.stack([got_s[bounded].get(torch.as_tensor(key.astype(np.int64)),
                                                  torch.as_tensor(si.astype(np.int64)), dim)
                               for dim in dims[kname]]).numpy()
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"{name} {kname}")
