"""Slice 1 end to end: BASELINE scene 2 (the Cornell box) and the main
path's other pieces, rendered by the JAX reference and by pbrt_tpu_torch
on the CPU.

Both draw the same samples (pure functions of pixel, sample, dimension)
through the same scene, so the images agree up to float rounding.  Gate
of every image (``tests/test_torch_slice.py``'s): image-mean relative
difference <= 1e-3 and >= 99% of pixels within rtol 1e-3, atol 1e-4.

The reference renders compiled by XLA, whose CPU code fuses multiplies
into the adds that consume them; the port's brute-force sweep rounds the
sphere quadratic and the triangle test as that code does
(``ops/intersect_soa.py``).  Where XLA merges equal products of the
unrolled sweep, the last bits can still differ: on 20,000 seeded rays
per path (``scripts/xla_rounding.py``), one Cornell triangle hit of
16,138 (t 0.1913, |dt| 2.8e-7) and no soup hit of 9,843 lay beyond rtol
1e-6.

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import jax
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.core.transform import Transform as RefTransform
from pbrt_tpu.ops.intersect_soa import SoABruteForceIntersector as RefSoA
from pbrt_tpu.render import Renderer as RefRenderer
from pbrt_tpu.scene.builder import _sph_cols as ref_sph_cols
from pbrt_tpu.scene.builder import _tessellate_emitting_sphere as ref_tessellate
from pbrt_tpu.shapes import SphereData as RefSphereData
from pbrt_tpu.shapes import TriangleData as RefTriangleData
from pbrt_tpu.testscenes import _torus_mesh_params as ref_torus_params
from pbrt_tpu.testscenes import cornell_renderer as ref_cornell_renderer

_RES = dict(xres=16, yres=16, spp=2)


def _ref_render(r):
    return np.asarray(r.film.to_rgb(r.render(progress=False)))


def _ref_from_text(text, mesh=None, res=None):
    """The reference's Renderer for scene text (plus a torus mesh after it
    and more text: ``mesh = (nu, nv, text)``)."""
    api = RefAPI(RefOptions(ray_batch=1 << 16), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    if mesh is not None:
        nu, nv, more = mesh
        api.shape("trianglemesh", ref_torus_params(nu, nv)[0])
        api.parse_string(more)
        api.scene.film_params.add_int("xresolution", [res[0]])
        api.scene.film_params.add_int("yresolution", [res[1]])
    return RefRenderer(api.scene, api.opt)


@pytest.fixture(scope="module")
def cornell_reference():
    ref = ref_cornell_renderer(**_RES, maxdepth=3)
    return ref, _ref_render(ref)


def _check_image(got, want, port, maxdepth):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.max() > 0
    lanes = port.film.get_sample_bounds().area() * port.sampler.samples_per_pixel
    assert port.counters["closest_queries"] == lanes * maxdepth
    assert port.counters["shadow_queries"] == lanes * (maxdepth - 1)
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    err = np.abs(got - want).max(axis=-1)
    worst = np.unravel_index(np.argmax(err), err.shape)
    print(f"mean rel diff {rel_mean:.3e}; {close.mean():.4f} of pixels close; worst "
          f"pixel {worst}: ref {want[worst]} port {got[worst]}")
    assert rel_mean <= 1e-3
    assert close.mean() >= 0.99


def test_cornell_image_matches_reference(cornell_reference):
    """16x16, 2 spp, maxdepth 3: camera -> mirror -> wall with NEE to the
    ceiling light, through the brute-force intersector."""
    from pbrt_tpu_torch.ops.intersect_soa import SoABruteForceIntersector
    from pbrt_tpu_torch.testscenes import cornell_renderer

    port = cornell_renderer(**_RES, maxdepth=3, device="cpu")
    assert isinstance(port.compiled.intersector, SoABruteForceIntersector)
    assert (port.compiled.tri_data.count, port.compiled.sph_data.count) == (12, 2)
    _check_image(port.image(port.render()), cornell_reference[1], port, 3)


def _rays(n, lo, hi, seed, aim=None):
    """n seeded rays from [lo, hi)^3; with ``aim = (center, radius)`` half
    of them point at that ball.  t_max finite on most lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    if aim is not None:
        c, r = aim
        d[: n // 2] = c + rng.uniform(-r, r, (n // 2, 3)) - o[: n // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rng.uniform(0.0, 2.0 * (hi - lo), n).astype(np.float32)
    t_max[::7] = 1e8
    return o, d, t_max


def _check_intersector(ref, port, o, d, t_max, min_sphere_hits):
    import torch

    want = {k: np.asarray(v) for k, v in jax.jit(ref.intersect)(o, d, t_max).items()}
    occ_want = np.asarray(jax.jit(ref.occluded)(o, d, t_max))
    args = tuple(torch.as_tensor(a) for a in (o, d, t_max))
    got = {k: v.numpy() for k, v in port.intersect(*args).items()}
    occ_got = port.occluded(*args).numpy()
    hit = want["hit"]
    tri = hit & (want["kind"] == 0)
    print(f"{hit.sum()} hits ({(want['kind'] == 1).sum()} spheres), t bit-equal on "
          f"{(got['t'] == want['t'])[hit].mean():.4f} of them")
    assert (want["kind"] == 1).sum() >= min_sphere_hits and tri.sum() >= 50
    np.testing.assert_array_equal(got["hit"], hit)
    np.testing.assert_array_equal(got["kind"], want["kind"])
    np.testing.assert_array_equal(got["prim"][hit], want["prim"][hit])
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["b0"][tri], want["b0"][tri], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["b1"][tri], want["b1"][tri], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(occ_got, occ_want)
    return want, got


def test_brute_force_intersector_matches_reference(cornell_reference):
    """Closest and any hit against the reference's sweep: Cornell's 14
    primitives (the unrolled path) and a 200-triangle soup with a rotated
    partial sphere (the scan path) whose triangles 20/21 and 10/150
    coincide (ties go to the lower index, within and across blocks); and
    the scene's host tables: the packed sphere table byte for byte, the
    world bounds, an emitting sphere's tessellation."""
    import torch

    from pbrt_tpu_torch.ops.intersect_soa import BLOCK, SoABruteForceIntersector
    from pbrt_tpu_torch.scene.builder import _tessellate_emitting_sphere as port_tessellate
    from pbrt_tpu_torch.shapes import SphereData, TriangleData
    from pbrt_tpu_torch.testscenes import cornell_renderer

    ref_c = cornell_reference[0].compiled
    port_c = cornell_renderer(**_RES, maxdepth=3, device="cpu").compiled
    want_cols = np.asarray(ref_sph_cols(ref_c.tables["sph"]))
    got_cols = port_c.tables["sph_cols"].numpy()
    assert got_cols.dtype == want_cols.dtype and got_cols.tobytes() == want_cols.tobytes()
    for got_b, want_b in zip(port_c.world_bounds, ref_c.world_bounds):
        np.testing.assert_array_equal(got_b, want_b)
    want_mesh = ref_tessellate(ref_c.sph_data)
    got_mesh = port_tessellate(port_c.sph_data)
    for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2"):
        np.testing.assert_array_equal(getattr(got_mesh, k), getattr(want_mesh, k))

    ref = RefSoA(ref_c.tri_data, ref_c.sph_data)
    port = port_c.intersector
    assert ref.unroll and port.unroll
    _check_intersector(ref, port, *_rays(1024, -50.0, 600.0, 1, aim=((278, 95, 260), 180)),
                       min_sphere_hits=100)

    rng = np.random.default_rng(3)
    c = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    p1 = (c + rng.uniform(-0.3, 0.3, (200, 3))).astype(np.float32)
    p2 = (c + rng.uniform(-0.3, 0.3, (200, 3))).astype(np.float32)
    for a, b in ((20, 21), (10, 150)):
        c[b], p1[b], p2[b] = c[a], p1[a], p2[a]
    uv = np.zeros((200, 2), np.float32)
    x = RefTransform.translate([0.2, -0.1, 0.3]) * RefTransform.rotate(35, [1, 2, 0.5])
    sph = dict(o2w=x.m[None], w2o=x.m_inv[None], radius=np.array([0.6], np.float32),
               z_min=np.array([-0.4], np.float32), z_max=np.array([0.5], np.float32),
               phi_max=np.array([np.deg2rad(270.0)], np.float32),
               reverse_orientation=np.array([False]))
    ref = RefSoA(RefTriangleData(c, p1, p2, uv, uv, uv), RefSphereData(**sph))
    port = SoABruteForceIntersector(TriangleData(c, p1, p2, uv, uv, uv), SphereData(**sph),
                                    device="cpu")
    assert not ref.unroll and not port.unroll and 10 < BLOCK <= 150
    _check_intersector(ref, port, *_rays(1024, -1.5, 1.5, 2, aim=((0.2, -0.1, 0.3), 0.7)),
                       min_sphere_hits=50)
    # rays straight down at the coincident pairs: both sweeps take the
    # lower index
    o = np.stack([(c[a] + p1[a] + p2[a]) / 3 + np.float32([0, 0, 3]) for a in (20, 10)])
    d = np.tile(np.float32([0, 0, -1]), (2, 1))
    t_max = np.full(2, 1e8, np.float32)
    want = jax.jit(ref.intersect)(o, d, t_max)
    got = port.intersect(*(torch.as_tensor(v) for v in (o, d, t_max)))
    hits = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["prim"].numpy()[hits], np.asarray(want["prim"])[hits])
    assert set(np.asarray(want["prim"])[hits]) <= {10, 20}


def test_torus_sphere_walks_match_reference():
    """The 24x24 torus (1,156 triangles: the whole-tree walks) with a
    mirror sphere swept beside the BVH, under the 8-wide and the skip-link
    walk."""
    from pbrt_tpu_torch.accel.bvh import BVHIntersector
    from pbrt_tpu_torch.testscenes import FLOOR, MESH_SCENE, MIRROR_SPHERE, mesh_scene_renderer

    text = MESH_SCENE.format(**_RES, maxdepth=3)
    ref = _ref_from_text(text, (24, 24, FLOOR + MIRROR_SPHERE), (16, 16))
    assert ref.compiled.sph_data.count == 1
    want = _ref_render(ref)
    for walk in ("bvh8", "skip"):
        port, _ = mesh_scene_renderer(**_RES, maxdepth=3, nu=24, nv=24, device="cpu",
                                      walk=walk, sphere=True)
        itx = port.compiled.intersector
        assert isinstance(itx, BVHIntersector) and (itx.n_tri, itx.n_sph) == (1156, 1)
        _check_image(port.image(port.render()), want, port, 3)


def test_cornell_environment_filter_crop_matches_reference():
    """Cornell with a constant infinite light (escaped camera and
    first-bounce rays, MIS against the light's pdf), a gaussian pixel
    filter and a crop window (the scatter film), at maxdepth 2."""
    from pbrt_tpu_torch.testscenes import cornell_renderer, cornell_text

    want = _ref_render(_ref_from_text(cornell_text(**_RES, maxdepth=2, environment=True)))
    port = cornell_renderer(**_RES, maxdepth=2, device="cpu", environment=True)
    assert any(lt.is_infinite for lt in port.compiled.lights)
    assert port.film.filter.radius == (2.0, 2.0)
    got = port.image(port.render())
    assert got.shape == (10, 9, 3)
    _check_image(got, want, port, 2)
