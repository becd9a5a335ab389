"""Stochastic progressive photon mapping in pbrt_tpu_torch against the JAX
reference on the CPU: tests/test_sppm.py's open box (matte only: the kd /
pi gather; an area light) and the same box with a glossy plastic wall
and a point light (the full-BSDF gather; photons from both lights).

Per scene, one iteration's pieces on the same sample streams: the
visible points of the camera pass and its direct light, the deposited
photons (positions, powers, directions, masks) within rtol 1e-5 (of
each array's largest magnitude, so that coordinates near 0 are held to
their points' rounding); on the reference's photons and visible points,
the photon map's cell keys in sorted order bit-equal and the gathered
flux within rtol 1e-5; then the matte box's whole render (16x16, 2
iterations, 2048 photons) to the image tolerance of the other scene
tests (image-mean relative difference <= 1e-3, >= 99% of pixels within
rtol 1e-3 / atol 1e-4).  The reference runs each pass under ``jax.jit``,
as its render does; its full-BSDF gather unrolls 27 x ``max_per_cell``
BSDF evaluations into one program (at 8 photons a cell, ~2 minutes and
~15 GB to compile here), so the glossy scene gathers 1 photon a cell in
both packages and is not rendered whole.  The moving quad's SPPM render
(an infinite light's photons) is in tests/test_torch_motion.py.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.render import Renderer as RefRenderer

RES, ITERS, PHOTONS = 16, 2, 2048
SPPM = f'"integer numiterations" {ITERS} "integer photonsperiteration" {PHOTONS}'
GLOSSY_WALL = ('Material "plastic" "rgb Kd" [0.4 0.3 0.2] "rgb Ks" [0.5 0.5 0.5] '
               '"float roughness" 0.15\nShape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
               '  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 2.5 -2.5')


def _scene(name):
    from pbrt_tpu_torch.testscenes import gi_box_text

    text = gi_box_text("sppm", RES, RES, 1, 3, extra=SPPM)
    if name == "glossy":
        wall = 'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 2.5 -2.5'
        assert text.count(wall) == 1
        text = text.replace(wall, GLOSSY_WALL).replace(
            "WorldBegin\n", 'WorldBegin\nLightSource "point" "rgb I" [3 3 3] "point from" [1 1.5 1]\n')
    return text


def _renderers(text):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    api = RefAPI(RefOptions(ray_batch=1 << 14), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    port_api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False, device="cpu")
    port_api.init()
    port_api.parse_string(text)
    return (RefRenderer(api.scene, api.opt),
            Renderer(port_api.scene, port_api.opt, device="cpu"))


def _close(got, want, err_msg=""):
    """rtol 1e-5, and 1e-5 of the largest magnitude of ``want``."""
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


def _same_image(label, got, want):
    assert np.isfinite(got).all() and got.max() > 0, label
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    print(f"{label}: mean {got.mean():.6f} (reference {want.mean():.6f}), mean rel diff "
          f"{rel_mean:.3e}, {close:.4f} of pixels close")
    assert rel_mean <= 1e-3, (label, rel_mean)
    assert close >= 0.99, (label, close)


@pytest.mark.parametrize("name", ["matte", "glossy"])
def test_sppm_passes_and_render_against_reference(name):
    """One iteration's visible points, direct light, deposits, sorted cell
    keys and flux, then the whole render."""
    import torch

    ref, port = _renderers(_scene(name))
    ri, pi = ref.integrator, port.integrator
    if name != "matte":
        # the reference's full-BSDF gather unrolls 27 x max_per_cell BSDF
        # evaluations into one XLA program: 1 photon a cell keeps its
        # compile small
        ri.max_per_cell = pi.max_per_cell = 1
    assert type(pi).__name__ == "SPPMIntegrator"
    assert (pi.n_iterations, pi.photons_per_iter, pi.max_depth) == (ITERS, PHOTONS, 3)
    assert pi._gather_full_bsdf == ri._gather_full_bsdf == (name != "matte")
    it = 1
    pix = ref.film.cropped_pixel_bounds.offsets().astype(np.int32)
    n_pix = len(pix)

    radius0 = float(np.linalg.norm(np.subtract(*port.compiled.world_bounds[::-1])) * 0.01)

    def ref_pass(pix_, sidx, photons):
        """The camera pass, and the gather of ``photons`` at its points."""
        sampler, camera = ref.sampler, ref.camera
        p_film = pix_.astype(jnp.float32) + sampler.get2(pix_, sidx, 0)
        o, d, _ = camera.generate_rays(p_film, sampler.get2(pix_, sidx, 2))
        vp, L = ri._camera_pass(sampler, pix_, sidx, o, d)
        flux = ri._gather(vp, jnp.full((n_pix,), radius0), *photons, radius0)
        return {k: v for k, v in vp.items() if k != "params"}, L, flux

    ph_w = jax.jit(lambda: ri._photon_pass(ref.sampler, PHOTONS, jnp.uint32(it)))()
    vp_w, l_w, flux_w = jax.jit(ref_pass)(pix, jnp.full((n_pix,), it, jnp.uint32), ph_w)
    tp = torch.as_tensor(pix.astype(np.int64))
    sidx = torch.full((n_pix,), it, dtype=torch.int64)
    p_film = tp.float() + port.sampler.get2(tp, sidx, 0)
    o, d, _ = port.camera.generate_rays(p_film, port.sampler.get2(tp, sidx, 2))
    vp_g, l_g = pi._camera_pass(port.sampler, tp, sidx, o, d)
    valid = np.asarray(vp_w["valid"])
    np.testing.assert_array_equal(vp_g["valid"].numpy(), valid)
    assert 0.3 < valid.mean()
    for k in ("p", "ns", "beta", "kd", "wo"):
        _close(vp_g[k].numpy()[valid], np.asarray(vp_w[k])[valid], k)
    _close(l_g.numpy(), np.asarray(l_w), "L_direct")

    ph_g = pi._photon_pass(port.sampler, PHOTONS, it, torch.device("cpu"))
    ok = np.asarray(ph_w[3])
    np.testing.assert_array_equal(ph_g[3].numpy(), ok)
    assert ok.sum() > 100
    for i, k in enumerate(("p", "w", "d")):
        _close(ph_g[i].numpy()[ok], np.asarray(ph_w[i])[ok], k)

    # the photon map and the gather on the reference's photons and visible
    # points (points on the floor, y = 0, sit on a cell boundary: a last-bit
    # difference in y moves them to the next cell)
    pq = jnp.floor(ph_w[0] * (1.0 / radius0)).astype(jnp.int32)
    key_w = jnp.where(ph_w[3], ri._cell_key(pq, None), jnp.uint32(0xFFFFFFFF))
    key_w = np.asarray(key_w)[np.asarray(jnp.argsort(key_w))]
    ph_t = [torch.as_tensor(np.array(x)) for x in ph_w]
    pmap = pi.sorted_photons(*ph_t, radius0)
    np.testing.assert_array_equal(pmap[0].numpy().astype(np.uint32), key_w)
    assert (key_w != 0xFFFFFFFF).sum() == ok.sum()
    vp_t = {k: torch.as_tensor(np.array(v)) for k, v in vp_w.items()}
    vp_t["params"] = vp_g["params"]  # the port's record (None on matte scenes)
    flux_g = pi._gather(vp_t, torch.full((n_pix,), radius0), pmap, radius0)
    assert float(flux_g.abs().sum()) > 0
    _close(flux_g.numpy(), np.asarray(flux_w), "flux")

    if name != "matte":
        return
    img_w = np.asarray(ref.film.to_rgb(ref.render(progress=False)))
    got = port.render(progress=False)
    _same_image(f"sppm {name}", port.image(got), img_w)
    assert port.counters["camera_samples"] == ITERS * n_pix
    assert pi.last_photon_sweeps == ITERS * PHOTONS * 3
