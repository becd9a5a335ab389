"""Participating media in pbrt_tpu_torch against the JAX reference: the
tracking stream, homogeneous and grid media, the phase function and the
subsurface coefficients; the spot, goniometric and projection lights; the
volumetric path integrator on the fog-and-smoke scene file and on a
null-material shape in vacuum.

The reference is evaluated under ``jax.jit``, as its renders evaluate it.
Its compiled code rounds a few steps otherwise than float32 op by op:
the port follows it where that decides tracking (the flight's division
by a constant becomes a fused product with its reciprocal; the density's
trilinear lerps fuse one product each, ``media.GridDensityMedium``), so
every tracking mask is equal.  What stays is XLA's own ``log`` and
``exp`` (polynomials that differ from torch's by one ulp on 14% of
inputs) and its order inside the ratio-tracking loop: distances are held
to rtol 1e-6 (largest gap 1.5e-7), ratio-tracked transmittance to rtol
1e-6 / atol 1e-6 (largest gap 5.4e-7, at values down to 8e-6); the gaps
are those ``scripts/media_rounding.py`` prints for these inputs.
Images are held to the tolerance of the other scene tests (image-mean
relative difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol
1e-4).

torch and pbrt_tpu_torch are imported inside the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu import media as ref_media
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.lights import make_light as ref_make_light
from pbrt_tpu.media import scattering as ref_scattering
from pbrt_tpu.render import render_scene as ref_render_scene

N = 4096


def _same_image(got, want):
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close


def _ref_render(text):
    api = RefAPI(RefOptions(ray_batch=1 << 16), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    return ref_render_scene(api.scene, api.opt, write=False)


def _port_render(text):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import render_scene

    api = PbrtAPI(Options(ray_batch=1 << 16), render_on_world_end=False, device="cpu")
    api.init()
    api.parse_string(text)
    return render_scene(api.scene, api.opt, write=False, device="cpu")


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """The fog-and-smoke scene at 16x16, 2 spp, maxdepth 3 with a 24x24
    torus and an 8^3 grid: (scene text, the reference's render)."""
    from pbrt_tpu_torch.testscenes import volume_text, write_torus_ply

    ply = tmp_path_factory.mktemp("volume") / "torus.ply"
    write_torus_ply(ply, nu=24, nv=24)
    text = volume_text(str(ply), xres=16, yres=16, spp=2, maxdepth=3, grid=8)
    return text, _ref_render(text)


def _rays(rs, n):
    o = rs.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d = rs.uniform(-0.5, 0.5, size=(n, 3)) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_media_against_reference():
    """make_track_rng bit-equal; homogeneous sample / tr; grid delta and
    ratio tracking on 4096 seeded rays through an 8^3 grid over a box
    (masks equal on every lane; the density bit-equal); HG value and
    sample; the
    scattering presets, the dipole inversion and the subsurface medium."""
    import torch

    from pbrt_tpu_torch import media
    from pbrt_tpu_torch.core.paramset import ParamSet
    from pbrt_tpu_torch.media import scattering

    rs = np.random.default_rng(0)
    pix = rs.integers(0, 1024, size=(N, 2)).astype(np.int32)
    sidx = rs.integers(0, 256, size=N).astype(np.int32)
    t_pix, t_si = torch.as_tensor(pix).long(), torch.as_tensor(sidx).long()

    def ref_rng(salt):
        return ref_media.make_track_rng(jnp.asarray(pix), jnp.asarray(sidx), salt)

    for salt in (0, 1024 + 13, 2048 + 7):
        want = jax.jit(lambda salt=salt: jnp.stack(
            [ref_rng(salt)(jnp.uint32(k)) for k in (0, 1, 126, 100003)]))()
        port = media.make_track_rng(t_pix, t_si, salt)
        got = torch.stack([port(k) for k in (0, 1, 126, 100003)]).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want).view(np.uint32))

    o, d = _rays(rs, N)
    u = rs.uniform(size=N).astype(np.float32)
    t_hit = rs.uniform(0.2, 4.0, size=N).astype(np.float32)
    T = torch.as_tensor
    # the box p0 = (-0.6, -0.5, -0.7), p1 = (0.6, 0.7, 0.6), as make_medium maps it
    w2m = np.linalg.inv(np.array([[1.2, 0, 0, -0.6], [0, 1.2, 0, -0.5], [0, 0, 1.3, -0.7],
                                  [0, 0, 0, 1]]))
    grid = rs.uniform(0.0, 1.0, size=(8, 8, 8)).astype(np.float32)
    pairs = [
        (ref_media.HomogeneousMedium([0.1, 0.2, 0.3], [0.4, 0.5, 0.6], 0.3, 1.5),
         media.HomogeneousMedium([0.1, 0.2, 0.3], [0.4, 0.5, 0.6], 0.3, 1.5, device="cpu")),
        (ref_media.GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, grid, w2m),
         media.GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, grid, w2m, device="cpu")),
    ]
    for ref_m, port_m in pairs:
        t_w, s_w, b_w = (np.asarray(x) for x in jax.jit(
            lambda o, d, u, th: ref_m.sample(o, d, u, th, ref_rng(77)))(o, d, u, t_hit))
        t_g, s_g, b_g = (x.numpy() for x in port_m.sample(
            T(o), T(d), T(u), T(t_hit), media.make_track_rng(t_pix, t_si, 77)))
        np.testing.assert_array_equal(s_g, s_w)
        assert 0.05 < s_w.mean() < 0.95
        np.testing.assert_allclose(t_g, t_w, rtol=1e-6)
        np.testing.assert_allclose(b_g, b_w, rtol=1e-6)
        tr_w = np.asarray(jax.jit(lambda o, d, th: ref_m.tr(o, d, th, ref_rng(78)))(o, d, t_hit))
        tr_g = port_m.tr(T(o), T(d), T(t_hit), media.make_track_rng(t_pix, t_si, 78)).numpy()
        np.testing.assert_allclose(tr_g, tr_w, rtol=1e-6, atol=1e-6)
    grid_ref, grid_port = pairs[1]
    pts = (o + d * rs.uniform(0, 3, size=(N, 1))).astype(np.float32)
    np.testing.assert_array_equal(grid_port.density_at(T(pts)).numpy(),
                                  np.asarray(jax.jit(grid_ref.density_at)(pts)))

    cos = rs.uniform(-1, 1, size=N).astype(np.float32)
    u2 = rs.uniform(size=(N, 2)).astype(np.float32)
    gs = rs.uniform(-0.9, 0.9, size=N).astype(np.float32)
    gs[:64] = 0.0  # the isotropic branch
    np.testing.assert_allclose(media.hg_phase(T(cos), T(gs)).numpy(),
                               np.asarray(jax.jit(ref_media.hg_phase)(cos, gs)), rtol=1e-5)
    wi_w, pdf_w = jax.jit(ref_media.hg_sample)(d, u2, gs)
    wi_g, pdf_g = media.hg_sample(T(d), T(u2), T(gs))
    # cos(theta) is as the reference rounds it; near the poles sin(theta) =
    # sqrt(1 - cos^2) turns the last bits of the frame and of the sine
    # polynomial into up to 5.7e-6 of wi here (scripts/media_rounding.py)
    np.testing.assert_allclose(wi_g.numpy(), np.asarray(wi_w), rtol=1e-5, atol=3e-5)
    np.testing.assert_allclose(pdf_g.numpy(), np.asarray(pdf_w), rtol=1e-5)

    for name in list(ref_scattering.MEDIUM_SCATTERING_PROPERTIES) + ["Skin1", "nope"]:
        want = ref_scattering.get_medium_scattering_properties(name)
        got = scattering.get_medium_scattering_properties(name)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=1e-12)
    for kd, mfp, eta, g in (([0.1, 0.35, 0.8], 0.5, 1.33, 0.0), ([0.7, 0.4, 0.2], 0.2, 1.5, 0.4)):
        np.testing.assert_allclose(
            np.stack(scattering.subsurface_from_diffuse(kd, mfp, eta, g)),
            np.stack(ref_scattering.subsurface_from_diffuse(kd, mfp, eta, g)), rtol=1e-12)
    # MakeNamedMedium's parameter surface, and its fallbacks
    from pbrt_tpu.core.paramset import ParamSet as RefParamSet

    for kind, items in (("homogeneous", [("rgb_spectrum", "sigma_a", [0.1, 0.2, 0.3]),
                                         ("float", "scale", [2.0]), ("float", "g", [0.5])]),
                        ("heterogeneous", [("int", "nx", [2]), ("int", "ny", [1]),
                                           ("int", "nz", [1]), ("float", "density", [0.3, 0.9]),
                                           ("point3f", "p1", [2.0, 1.0, 1.0])]),
                        ("heterogeneous", []), ("nonsense", [])):
        ps, rps = ParamSet(), RefParamSet()
        for typ, key, val in items:
            for p in (ps, rps):
                getattr(p, f"add_{typ}")(key, val)
        got, want = media.make_medium(kind, ps, device="cpu"), ref_media.make_medium(kind, rps)
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_allclose(got.sigma_t, want.sigma_t, rtol=1e-7)
        assert got.g == want.g
        if hasattr(want, "density"):
            np.testing.assert_allclose(got.w2m.numpy(), np.asarray(want.w2m), rtol=1e-7)


LIGHTS = """
WorldBegin
AttributeBegin
  Translate 0.3 -0.2 0.5
  Rotate 25 1 0.5 0
  LightSource "spot" "rgb I" [3 2 1] "point from" [0 0 2] "point to" [0.2 0.1 0]
    "float coneangle" 35 "float conedeltaangle" 10
  LightSource "spot" "rgb I" [1 1 1] "point from" [0 0 1] "point to" [0 0 1]
  LightSource "goniometric" "rgb I" [2 3 4] "string mapname" "{tex}"
  LightSource "projection" "rgb I" [5 4 3] "float fov" 60 "string mapname" "{tex}"
  LightSource "goniometric" "rgb I" [1 2 3]
  LightSource "projection" "rgb I" [1 1 1] "string mapname" "{missing}"
AttributeEnd
WorldEnd
"""


def test_delta_lights_against_reference(tmp_path):
    """spot (and the degenerate from == to frame), goniometric and
    projection lights through make_light, with a seeded PFM map and with
    no map or an unreadable one: sample_li and power."""
    import torch

    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.lights import make_light
    from pbrt_tpu_torch.testscenes import write_texture_map

    write_texture_map(tmp_path / "map.pfm", size=32, seed=3)
    text = LIGHTS.format(tex=tmp_path / "map.pfm", missing=tmp_path / "missing.pfm")
    ref_api = RefAPI(RefOptions(), render_on_world_end=False)
    ref_api.init()
    ref_api.parse_string(text)
    api = PbrtAPI(render_on_world_end=False, device="cpu")
    api.init()
    api.parse_string(text)
    rs = np.random.default_rng(4)
    p = rs.uniform(-2.0, 2.0, size=(N, 3)).astype(np.float32)
    u2 = rs.uniform(size=(N, 2)).astype(np.float32)
    assert len(api.scene.lights) == len(ref_api.scene.lights) == 6
    for rec, ref_rec in zip(api.scene.lights, ref_api.scene.lights):
        got_l, want_l = make_light(rec, device="cpu"), ref_make_light(ref_rec)
        assert type(got_l).__name__ == type(want_l).__name__ and got_l.is_delta
        want = jax.jit(want_l.sample_li)(p, u2)
        got = got_l.sample_li(torch.as_tensor(p), torch.as_tensor(u2))
        for k, (g, w) in enumerate(zip(got, want)):
            # li: the light-space direction is a product by the light's matrix,
            # which XLA sums in its own order (one ulp), and the spot's
            # falloff ((cos - cos_total) / delta)^4 amplifies that near the
            # cone's edge (largest gap 6e-6: scripts/media_rounding.py)
            tol = dict(rtol=1e-5, atol=1e-5) if k == 1 else dict(rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
        assert np.asarray(want[1]).max() > 0
        np.testing.assert_allclose(got_l.power(), want_l.power(), rtol=1e-6)


def test_volume_scene_against_reference(volume):
    """The fog-and-smoke scene file (camera in fog, a heterogeneous grid in a
    null-material box, a subsurface torus, the spot light) at 16x16, 2 spp,
    maxdepth 3: the medium tables equal the reference's, volpath issues
    (3 x 3, 2 x 4) sweeps, ``path`` on it routes to volpath, and the image
    meets the reference's."""
    from pbrt_tpu_torch.integrators import make_integrator
    from pbrt_tpu_torch.integrators.volpath import VolPathIntegrator

    text, want = volume
    got = _port_render(text)
    r, ref_r = got["renderer"], want["renderer"]
    c, ref_c = r.compiled, ref_r.compiled
    assert len(c.media) == len(ref_c.media) == 3
    assert c.media_names == ref_c.media_names and c.camera_medium == ref_c.camera_medium == 0
    for k in ("med_in", "med_out", "mat"):
        np.testing.assert_array_equal(c.tables["tri"][k].numpy(),
                                      np.asarray(ref_c.tables["tri"][k]))
    assert isinstance(r.integrator, VolPathIntegrator)
    assert r.integrator.queries_per_sample() == (9, 8)
    assert r.counters["closest_queries"] == 16 * 16 * 2 * 9
    c.integrator_name = "path"
    assert isinstance(make_integrator(c), VolPathIntegrator)
    _same_image(got["image"], want["image"])


NULL_SPHERE = """
LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" 8
Integrator "{integrator}" "integer maxdepth" 2
Film "image" "integer xresolution" [24] "integer yresolution" [24]
WorldBegin
LightSource "point" "rgb I" [60 60 60] "point from" [0 5 0]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
AttributeBegin
  Material ""
  Translate 0 2.5 0
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""


SMOKE_ROOM = """
MakeNamedMedium "smoke" "string type" "heterogeneous"
    "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.2 0.2 0.2] "float g" 0.3
    "integer nx" 2 "integer ny" 2 "integer nz" 2 "point p0" [-5 -1 -7] "point p1" [5 6 5]
    "float density" [0.2 1 0.5 0.1 0.8 0.3 1 0.6]
MediumInterface "" "smoke"
LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" 8
Integrator "volpath" "integer maxdepth" 3
Film "image" "integer xresolution" [24] "integer yresolution" [24]
WorldBegin
LightSource "point" "rgb I" [60 60 60] "point from" [0 5 0]
MediumInterface "smoke" "smoke"
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
AttributeBegin
  Translate 0 2.5 0
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""


def test_null_sphere_in_vacuum_against_reference():
    """tests/test_media.py's null-material sphere over a lit floor with no
    medium: under volpath it casts no shadow (the segmented shadow march);
    under path, which a scene without media keeps, it shadows and stops
    camera rays, as in the reference.  Then the same room filled with a
    grid medium and the sphere matte: no null material, so each shadow ray
    is one any-hit sweep whose ratio tracking draws on salt 1024 + bounce."""
    from pbrt_tpu_torch.integrators.path import PathIntegrator
    from pbrt_tpu_torch.integrators.volpath import VolPathIntegrator

    center = (slice(10, 14), slice(10, 14))
    for name, cls in (("volpath", VolPathIntegrator), ("path", PathIntegrator)):
        text = NULL_SPHERE.format(integrator=name)
        got = _port_render(text)
        assert type(got["renderer"].integrator) is cls
        _same_image(got["image"], _ref_render(text)["image"])
        if name == "volpath":
            assert got["renderer"].integrator.queries_per_sample() == (6, 4)
            assert got["image"][center].mean() > 0.1
        else:
            assert got["image"][center].mean() < 0.02

    got = _port_render(SMOKE_ROOM)
    vp = got["renderer"].integrator
    assert type(vp) is VolPathIntegrator and len(got["renderer"].compiled.media) == 1
    assert (vp.passthrough_steps, vp.shadow_segments) == (1, 1)
    assert vp.queries_per_sample() == (3, 2)
    _same_image(got["image"], _ref_render(SMOKE_ROOM)["image"])
