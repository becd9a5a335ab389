"""The float64 policy (``Options(double=True)``, the reference's
``PBRT_TPU_DOUBLE=1``) against the JAX reference on the CPU.

The reference reads its policy from the environment at import, so it runs
in double once, in one subprocess (``PBRT_TPU_DOUBLE=1
JAX_PLATFORMS=cpu``, a module-scoped fixture), which saves its images,
its gradient and K7's inputs and outputs to an ``.npz``; the port runs in
this process with the ``double`` argument.

* The math core: ``tests/test_float_double.py``'s golden values, and
  ``clamp``, ``lerp``, ``quadratic`` and ``gamma_n`` under both policies
  (``tests/test_mathcore.py``'s cases), and the end point of
  ``core/rng.u32_to_float`` in each policy.
* Cornell (16x16, 2 spp, maxdepth 3: the brute-force sweep) and the 48x48
  torus (16x16, 2 spp, maxdepth 3: the K2 tables through the plain walk):
  float64 images (every float table float64 but the walk's), every pixel
  within rtol 1e-6 of the reference's, and per scene a bound on the
  image-mean relative difference and on the share of pixels within rtol
  1e-7 that the port's own float32 image fails (``IMAGE_BOUNDS``).
  Measured: mean relative differences 7.5e-10 (Cornell) and 1.5e-8
  (torus); 98.0% and 96.5% of pixels within rtol 1e-7 (float32: 9.4% and
  61.3%).  Two things keep the rest from the last bits of a double: the
  port's walks cast their rays to float32 and return a float32 t, as the
  reference's TPU kernels do, while the reference's CPU route walks in
  float64 (``pbrt_tpu/accel/bvh.py:193``); and the reference's compiled
  code fuses float64 products into sums, which the port (PyTorch has no
  fused multiply-add) rounds twice.
* One gradient step on Cornell (8x8, 1 spp, maxdepth 2) against
  ``jax.grad`` under x64: loss within rtol 1e-9, every leaf within 1e-6 of
  the largest leaf (measured: the loss bit-equal, leaves within 1e-16).
* K7's float64 plain walk against the reference's ``_bvh_walk`` on 4,096
  seeded rays over a 3-key rotating soup of 100 triangles: hit masks and
  prims equal, t within rtol 1e-12 (measured 1.9e-15), b0 and b1 within
  1e-9 (``anim_walk.B_ATOL``), occlusion equal.
* A grid medium filling a room under volpath (16x16, 2 spp, maxdepth 3):
  the density, the tracking's t and the transmittance float64, the image
  within ``IMAGE_BOUNDS``; the geometry-sharded matte harness (render and
  gradient step) in a 2-rank gloo world against the reference's harness,
  which the same subprocess runs on the conftest's virtual CPU devices.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r"""
import sys, types
import jax, jax.numpy as jnp, numpy as np
import pbrt_tpu
from pbrt_tpu.core.rng import u32_to_float
from pbrt_tpu.diff.grad import make_loss_fn
from pbrt_tpu.ops.animated_intersect import AnimatedTriIntersector
from pbrt_tpu.testscenes import cornell_renderer, mesh_scene_renderer

assert pbrt_tpu.float_t == np.float64
out = {}


def image(r):
    return np.asarray(r.film.to_rgb(r.render(progress=False)))


out["cornell"] = image(cornell_renderer(xres=16, yres=16, spp=2, maxdepth=3))
out["torus"] = image(mesh_scene_renderer(xres=16, yres=16, spp=2, maxdepth=3, nu=48,
                                         nv=48)[0])
g = cornell_renderer(xres=8, yres=8, spp=1, maxdepth=2)
theta = g.compiled.initial_theta()
pixels = jnp.asarray(g.film.cropped_pixel_bounds.offsets().astype(np.int32))
loss, grad = jax.jit(jax.value_and_grad(make_loss_fn(g, np.full((8, 8, 3), 0.25),
                                                     spp=1)))(theta, pixels)
out["loss"] = np.asarray(loss)
for k, v in theta.items():
    if not isinstance(v, dict):  # tex_images: none in this scene
        out["theta/" + k] = np.asarray(v)
        out["grad/" + k] = np.asarray(grad[k])
bits = np.array([0, 12345, 2**32 - 129, 2**32 - 128, 2**32 - 1], np.uint32)
out["u32"] = np.asarray(u32_to_float(jnp.asarray(bits)))
rng = np.random.default_rng(11)
n_tri, keys = 100, []
tri = [rng.uniform(-1, 1, (n_tri, 3)) for _ in range(3)]
tri = [tri[0], tri[0] + 0.3 * tri[1], tri[0] + 0.3 * tri[2]]
for a in np.radians([0.0, 20.0, 40.0]):
    m = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    p = [v @ m.T + [0.1 * a, 0, 0] for v in tri]
    keys.append(types.SimpleNamespace(p0=p[0], p1=p[1], p2=p[2], count=n_tri))
n = 4096
o = rng.uniform(-2.5, 2.5, (n, 3))
d = rng.uniform(-1, 1, (n, 3)) * 0.6 - o / np.linalg.norm(o, axis=1, keepdims=True)
d = d / np.linalg.norm(d, axis=1, keepdims=True)
t_max = rng.uniform(0.5, 6.0, n)
t_max[::97] = 0.0
time = rng.uniform(0, 1, n).astype(np.float32)
ref = AnimatedTriIntersector(keys)
assert ref._bvh is not None
hit = ref.intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(time))
out.update({"k7/keys": np.stack([np.stack([k.p0, k.p1, k.p2], 1) for k in keys]),
            "k7/o": o, "k7/d": d, "k7/t_max": t_max, "k7/time": time})
for k in ("t", "hit", "prim", "b0", "b1"):
    out["k7/" + k] = np.asarray(hit[k])

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.render import render_scene

api = PbrtAPI(Options(ray_batch=1 << 16), render_on_world_end=False)
api.init()
api.parse_string(sys.argv[2])
out["smoke"] = np.asarray(render_scene(api.scene, api.opt, write=False)["image"])
sys.path.insert(0, "tests")  # the reference's own harness (its virtual CPU devices)
from test_geomshard import _grad_with, render_with

# skip-link shards: its brute-force shards fail to trace under x64 (an
# int32 scan carry meets an int64 index)
out["sharded/image"] = render_with(dp=1, tp=2, bvh=True)
out["sharded/loss"], grads = _grad_with(dp=1, tp=2)
for k, v in grads.items():
    out["sharded/grad/" + k] = v
np.savez(sys.argv[1], **out)
"""

# a grid medium filling a room (tests/test_torch_media.py's smoke room),
# 16x16, 2 spp, maxdepth 3: every camera and shadow ray tracks through it
SMOKE_ROOM = """
MakeNamedMedium "smoke" "string type" "heterogeneous"
    "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.2 0.2 0.2] "float g" 0.3
    "integer nx" 2 "integer ny" 2 "integer nz" 2 "point p0" [-5 -1 -7] "point p1" [5 6 5]
    "float density" [0.2 1 0.5 0.1 0.8 0.3 1 0.6]
MediumInterface "" "smoke"
LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" 2
Integrator "volpath" "integer maxdepth" 3
Film "image" "integer xresolution" [16] "integer yresolution" [16]
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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's double-policy outputs (one subprocess, ~70 s: its
    XLA compiles)."""
    path = tmp_path_factory.mktemp("double") / "reference.npz"
    env = dict(os.environ, PBRT_TPU_DOUBLE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(path), SMOKE_ROOM], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return dict(np.load(path))


def test_math_core_in_both_policies(reference):
    """tests/test_float_double.py's golden values under the double policy,
    tests/test_mathcore.py's clamp / lerp / quadratic cases and gamma_n
    under both, and u32_to_float's end point in each: under float32 the
    cap is 0.99999994, under double 1 - 2^-53 rounds to 1 in float32, so
    the top 128 bit patterns give 1.0, as the reference's (run in double)
    give."""
    import torch

    from pbrt_tpu_torch import (clamp, epsilon, float_type, gamma_n, lerp,
                                machine_epsilon, one_minus_epsilon, quadratic, torch_dtype)
    from pbrt_tpu_torch.core import spectrum as spec
    from pbrt_tpu_torch.core.film import Film
    from pbrt_tpu_torch.core.filters import BoxFilter
    from pbrt_tpu_torch.core.rng import Rng, u32_to_float

    f64 = float_type(True)
    assert f64 is np.float64 and float_type(False) is np.float32
    assert torch_dtype(f64) == torch.float64 and torch_dtype(np.float32) == torch.float32
    assert Rng().uniform_u32() == 355248013  # width-independent golden value
    xyz = spec.rgb_to_xyz(np.array([1.0, 0.0, 0.0]), f64)
    assert xyz.dtype == np.float64
    np.testing.assert_allclose(xyz, [0.412453, 0.212671, 0.019334], atol=1e-9)
    assert quadratic(1.0, -6.0, -16.0, f64) == (-2.0, 8.0)
    f = Film((1920, 1080), ((0.25, 0.25), (0.75, 0.75)), BoxFilter((8.0, 8.0)), device="cpu",
             float_t=f64)
    b = f.get_sample_bounds()
    assert b.p_min == (472, 262) and b.p_max == (1448, 818)
    assert f.initial_state()["xyz"].dtype == torch.float64

    for float_t in (np.float32, np.float64):
        assert clamp(-1.0, 0.0, 1.0) == 0.0 and clamp(0.5, 0.0, 1.0) == 0.5
        assert clamp(2.0, 0.0, 1.0) == 1.0 and clamp(-1, 0, 2) == 0 and clamp(3, 0, 2) == 2
        assert [lerp(t, 0.0, 1.0) for t in (0.0, 0.5, 1.0)] == [0.0, 0.5, 1.0]
        assert lerp(0.75, 0.0, 2.0) == 1.5
        assert quadratic(1.0, 1.0, 1.0, float_t) is None
        assert quadratic(1.0, -6.0, -16.0, float_t) == (-2.0, 8.0)
        assert quadratic(1.0, 6.0, 5.0, float_t) == (-5.0, -1.0)
        assert quadratic(1.0, 0.0, -16.0, float_t) == (-4.0, 4.0)
        assert quadratic(1.0, 6.0, 0.0, float_t) == (-6.0, 0.0)
        t0, t1 = quadratic(1.0, 2.0, -2.0, float_t)
        np.testing.assert_allclose([t0, t1], [-1 - 3**0.5, -1 + 3**0.5], atol=1e-6)
        assert (t0, t1) == (float(float_t(t0)), float(float_t(t1)))  # policy's floats
        eps = float(np.finfo(float_t).eps) * 0.5
        assert machine_epsilon(float_t) == eps == epsilon(float_t) / 2
        assert gamma_n(3, float_t) == 3 * eps / (1 - 3 * eps)
        assert one_minus_epsilon(float_t) == float(np.nextafter(float_t(1), float_t(0)))
    assert gamma_n(3) == gamma_n(3, np.float32) > gamma_n(3, np.float64)

    bits = torch.tensor([0, 12345, 2**32 - 129, 2**32 - 128, 2**32 - 1], dtype=torch.int64)
    single = u32_to_float(bits).numpy()
    double = u32_to_float(bits, f64).numpy()
    assert single.dtype == double.dtype == np.float32
    np.testing.assert_array_equal(double, reference["u32"])
    assert single[-1] == np.float32(0.99999994) and double[-1] == 1.0
    assert single[-2] == np.float32(0.99999994) and double[-2] == 1.0
    np.testing.assert_array_equal(single[:3], double[:3])


# per scene: (bound on the image-mean relative difference from the
# reference's double image, least share of pixels within rtol 1e-7 of it);
# measured: Cornell 7.5e-10 and 98.0%, the torus 1.5e-8 and 96.5%, the
# smoke room 3.5e-9 and 93.0%; the port's float32 images: 7.5e-4 and
# 9.4%, 3.1e-8 and 61.3%, 2.2e-8 and 13.3%.  The smoke room's tracking
# takes its logs in float32, where XLA's and torch's differ by an ulp on
# 14% of inputs; with its density and flights in float32 (before) it
# measured 3.7e-9 and 89.8%
IMAGE_BOUNDS = {"cornell": (1e-8, 0.97), "torus": (1e-7, 0.95), "smoke": (1e-8, 0.92)}


def _float_leaves(obj, path="r", seen=None):
    """(path, dtype) of every floating tensor or array reachable from
    ``obj`` through the port's objects, dicts, lists and tuples."""
    import torch

    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [(path, obj.dtype)] if obj.is_floating_point() else []
    if isinstance(obj, np.ndarray):
        return [(path, obj.dtype)] if obj.dtype.kind == "f" else []
    if isinstance(obj, dict):
        items = [(f"{path}[{k!r}]", v) for k, v in obj.items()]
    elif isinstance(obj, (list, tuple)):
        items = [(f"{path}[{i}]", v) for i, v in enumerate(obj)]
    elif type(obj).__module__.startswith("pbrt_tpu_torch") and hasattr(obj, "__dict__"):
        items = [(f"{path}.{k}", v) for k, v in vars(obj).items()]
    else:
        return []
    return [leaf for p, v in items for leaf in _float_leaves(v, p, seen)]


@pytest.mark.parametrize("scene", ["cornell", "torus"])
def test_double_images_against_reference(reference, scene):
    """The port's double image within IMAGE_BOUNDS of the reference's and
    every pixel within rtol 1e-6; its float32 image fails the share
    bound, so the bound tells the policies apart.  Every float table of
    the double renderer is float64 but the walk's (and the sort keys'
    scene box, read from it), which stay float32 as the reference's do."""
    import torch

    from pbrt_tpu_torch.testscenes import cornell_renderer, mesh_scene_renderer

    def render(double):
        if scene == "cornell":
            r = cornell_renderer(xres=16, yres=16, spp=2, maxdepth=3, device="cpu",
                                 double=double)
        else:
            r, _ = mesh_scene_renderer(xres=16, yres=16, spp=2, maxdepth=3, nu=48, nv=48,
                                       device="cpu", double=double)
        return r.image(r.render(progress=False)), r

    def closeness(img):
        rel = np.abs(img.astype(np.float64) - want) / np.abs(want).clip(min=1e-300)
        return (abs(img.mean(dtype=np.float64) - want.mean()) / want.mean(),
                {rtol: float((rel <= rtol).all(axis=-1).mean()) for rtol in (1e-7, 1e-6)})

    want = reference[scene]
    got, r = render(True)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert np.isfinite(got).all() and got.max() > 0
    leaves = _float_leaves(r)
    assert len(leaves) > 20
    kept = [p for p, dt in leaves if dt not in (torch.float64, np.float64)]
    assert all(".intersector.walk." in p or p.endswith(("._scene_min", "._scene_extent"))
               for p in kept), kept
    mean_bound, share_bound = IMAGE_BOUNDS[scene]
    rel_mean, within = closeness(got)
    single = render(False)[0]
    assert single.dtype == np.float32
    rel_mean_single, within_single = closeness(single)
    print(f"{scene}: mean rel diff {rel_mean:.3e} (float32 {rel_mean_single:.3e}); share of "
          f"pixels within rtol: {within} (float32 {within_single})")
    assert rel_mean <= mean_bound
    assert within[1e-6] == 1.0
    assert within[1e-7] >= share_bound > within_single[1e-7]
    assert not np.array_equal(single.astype(np.float64), got)


def test_double_gradient_and_keyframed_walk_against_reference(reference):
    """The Cornell gradient step (make_loss_fn / value_and_grad against the
    reference's jax.grad under x64), then K7's float64 plain walk through
    ``ops/animated_intersect.AnimatedTriIntersector`` against the
    reference's ``_bvh_walk`` on the fixture's keyframed rays."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.kernels.anim_walk import anim_disagreement, max_b_diff
    from pbrt_tpu_torch.ops.animated_intersect import AnimatedTriIntersector
    from pbrt_tpu_torch.scene.convert import theta_from_numpy
    from pbrt_tpu_torch.testscenes import cornell_renderer

    r = cornell_renderer(xres=8, yres=8, spp=1, maxdepth=2, device="cpu", double=True)
    own = r.compiled.initial_theta()
    assert own.pop("tex_images") == {}
    ref_theta = {k[6:]: v for k, v in reference.items() if k.startswith("theta/")}
    assert set(own) == set(ref_theta)
    for k, v in own.items():
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), ref_theta[k])
    theta = theta_from_numpy(dict(ref_theta, tex_images={}), r.compiled, "cpu")
    pixels = torch.as_tensor(r.film.cropped_pixel_bounds.offsets().astype(np.int64))
    loss, grad = value_and_grad(make_loss_fn(r, np.full((8, 8, 3), 0.25), spp=1), theta,
                                pixels)
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss), float(reference["loss"]), rtol=1e-9)
    want = {k[5:]: v for k, v in reference.items() if k.startswith("grad/")}
    atol = 1e-6 * max(np.abs(v).max(initial=0.0) for v in want.values())
    assert atol > 0
    assert set(grad) == set(want) | {"tex_images"}
    for k, w in want.items():
        assert grad[k].dtype == torch.float64
        np.testing.assert_allclose(grad[k].numpy(), w, rtol=0, atol=atol, err_msg=k)

    keys = reference["k7/keys"]  # [K, T, 3 vertices, 3]
    port = AnimatedTriIntersector(
        [types.SimpleNamespace(p0=k[:, 0], p1=k[:, 1], p2=k[:, 2], count=k.shape[0])
         for k in keys], device="cpu")
    assert port.bvh is not None and port.cols.dtype == torch.float64
    o, d, t_max, time = (reference[f"k7/{k}"] for k in ("o", "d", "t_max", "time"))
    args = [torch.as_tensor(x) for x in (o, d, t_max, time)]
    got = port.intersect(*args)
    hit = reference["k7/hit"]
    assert 0.1 < hit.mean() < 0.9
    assert got["t"].dtype == torch.float64
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    inv = np.argsort(port.bvh["perm"].numpy())
    res = [(got["t"].numpy(), np.where(hit, inv[got["prim"].numpy()], -1),
            got["b0"].numpy(), got["b1"].numpy()),
           (reference["k7/t"], np.where(hit, inv[reference["k7/prim"]], -1),
            reference["k7/b0"], reference["k7/b1"])]
    problem = anim_disagreement(*res, port.cols.numpy(), o, d, time, any_hit=False,
                                rtol=1e-12)
    assert problem is None, problem
    print(f"K7 plain in double against the reference: max |db| {max_b_diff(*res):.3e}")
    np.testing.assert_array_equal(port.occluded(*args).numpy(), hit)


def test_double_grid_medium_and_sharded_harness_against_reference(reference):
    """The grid medium and the sharded matte harness in double.  The smoke
    room under volpath: the density and every tracking t float64 (they
    rounded to float32 before), the image within IMAGE_BOUNDS of the
    reference's and every pixel within rtol 1e-6.  Then
    ``make_sharded_path_fn`` on brute-force shards and
    ``make_sharded_grad_fn`` on skip-link shards of the heightfield at
    (dp, tp) = (1, 2), on a double harness in one gloo world of 2 ranks
    (the brute-force shards failed in double before): the film float64
    and within 1e-12 of the reference's (``render_with(dp=1, tp=2,
    bvh=True)``: its brute-force shards do not trace under x64), the loss
    within rtol 1e-9 and the gradients, in the leaves' float32, within
    rtol 1e-6 of its ``_grad_with(1, 2)`` divided by its device count
    (its ``shard_map`` psum transposes to a psum:
    tests/test_torch_geomshard.py).  Measured: image and loss within
    2.2e-16 and 6.7e-16, the gradients equal."""
    import torch

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.media import GridDensityMedium, make_track_rng
    from pbrt_tpu_torch.parallel.multihost import run_local_world
    from pbrt_tpu_torch.parallel.worlds import rank_geomshard, rank_tasks
    from pbrt_tpu_torch.render import render_scene

    api = PbrtAPI(Options(ray_batch=1 << 16, double=True), render_on_world_end=False,
                  device="cpu")
    api.init()
    api.parse_string(SMOKE_ROOM)
    got = render_scene(api.scene, api.opt, write=False, device="cpu")
    (grid,) = [m for m in got["renderer"].compiled.media if isinstance(m, GridDensityMedium)]
    rs = np.random.default_rng(5)
    o = torch.as_tensor(rs.uniform(-2, 2, (64, 3)))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(64, 3))), dim=1)
    t_max = torch.as_tensor(rs.uniform(1, 8, 64))
    rng = make_track_rng(torch.zeros((64, 2), dtype=torch.int64),
                         torch.arange(64), 9, np.float64)
    t, _, beta = grid.sample(o, d, rng(0), t_max, rng)
    assert grid.density_at(o).dtype == t.dtype == beta.dtype == torch.float64
    assert grid.tr(o, d, t_max, rng).dtype == torch.float64
    assert not torch.equal(t, t.float().double())  # t is not a float32 value
    img, want = got["image"], reference["smoke"]
    assert img.dtype == want.dtype == np.float64 and np.isfinite(img).all() and img.max() > 0
    rel = np.abs(img - want) / np.abs(want).clip(min=1e-300)
    rel_mean = abs(img.mean() - want.mean()) / want.mean()
    within = float((rel <= 1e-7).all(axis=-1).mean())
    print(f"smoke room: mean rel diff {rel_mean:.3e}, {within:.4f} of pixels within rtol 1e-7")
    mean_bound, share_bound = IMAGE_BOUNDS["smoke"]
    assert (rel <= 1e-6).all() and rel_mean <= mean_bound and within >= share_bound

    world = run_local_world(rank_tasks, 2, backend="gloo", device="cpu", timeout_s=120,
                            args=([(rank_geomshard, dict(
                                cases=[(1, 2, "brute", "allreduce")],
                                grad_cases=[(1, 2, "skip", False)],
                                float_t=np.float64))],))
    (a,), (b,) = world
    image = a["images"][(1, 2, "brute", "allreduce")]
    step = a["grads"][(1, 2, "skip", False)]
    np.testing.assert_array_equal(b["images"][(1, 2, "brute", "allreduce")], image)
    assert image.dtype == np.float64 and image.max() > 0.05
    np.testing.assert_allclose(image, reference["sharded/image"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(step["loss"], float(reference["sharded/loss"]), rtol=1e-9)
    for k in ("kd", "env_l"):
        g, w = step["grads"][k], reference[f"sharded/grad/{k}"] / 2
        assert g.dtype == w.dtype == np.float32 and np.abs(g).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-6)
