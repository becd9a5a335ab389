"""Rank functions for :func:`multihost.run_local_world`, and the scenes
they render: the sharded paths driven in a spawned world by the CPU
tests and ``chip_smoke.py``.  Each function runs on every rank as
``fn(rank, world_size, device, *args)`` and returns host values
(numpy arrays, floats) to the parent.

* :func:`rank_sharding`: ``ShardedRenderer`` over (dp, sp) meshes, its
  gradient step, and a render killed and resumed from its checkpoint;
* :func:`rank_geomshard`: ``make_sharded_path_fn`` and
  ``make_sharded_grad_fn`` over (dp, tp) meshes on brute, skip-link or
  packed shard tables of a scene, with the kernels' launch counts.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# the sphere scene of the reference's tests/test_sharding.py
SPHERE_SCENE = """
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 2
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [.3 .5 .7]
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "sphere" "float radius" 1
WorldEnd
"""


def sphere_renderer(device, ray_batch=256):
    from pbrt_tpu_torch.testscenes import text_renderer

    return text_renderer(SPHERE_SCENE, ray_batch=ray_batch, device=device)


def scene_renderer(device, **kw):
    """``testscenes.mesh_scene_renderer(**kw)``'s Renderer on ``device``
    (picklable with ``functools.partial`` for a spawned rank)."""
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    return mesh_scene_renderer(device=device, **kw)[0]


def config5_scene(nu=1000, nv=500):
    """BASELINE config 5's triangles (the displaced torus of 2 nu nv
    triangles, then the light quad and the floor: 1,000,004 at full
    width) -> (TriangleData, materials (torus 0, light quad 1, floor 2),
    lights (-1: the harness lights the scene by its environment))."""
    from pbrt_tpu_torch.shapes import TriangleData, concat_triangle_data
    from pbrt_tpu_torch.testscenes import torus_triangle_data

    def quad(z, half):
        p = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                     np.float32)
        uv = np.zeros((2, 2), np.float32)
        return TriangleData(p0=p[[0, 0]], p1=p[[1, 2]], p2=p[[2, 3]], uv0=uv, uv1=uv, uv2=uv)

    torus = torus_triangle_data(nu, nv)
    td = concat_triangle_data([torus, quad(3.5, 1.0), quad(-0.7, 8.0)])
    mats = np.concatenate([np.zeros(torus.count, np.int32), np.ones(2, np.int32),
                           np.full(2, 2, np.int32)])
    return td, mats, np.full(td.count, -1, np.int32)


def heightfield(n=40):
    """The reference's test heightfield (tests/test_geomshard.py): an n x n
    grid of z = 0.3 sin(2x) cos(2y) over [-2, 2]^2, two triangles a cell
    -> TriangleData with geometric normals."""
    from pbrt_tpu_torch.shapes import TriangleData, concat_triangle_data

    xs = np.linspace(-2, 2, n)
    gx, gy = np.meshgrid(xs, xs)
    pts = np.stack([gx, gy, 0.3 * np.sin(gx * 2) * np.cos(gy * 2)], axis=-1)
    a, b = pts[:-1, :-1].reshape(-1, 3), pts[1:, :-1].reshape(-1, 3)
    c, d = pts[1:, 1:].reshape(-1, 3), pts[:-1, 1:].reshape(-1, 3)
    p0 = np.stack([a, a], 1).reshape(-1, 3)
    p1 = np.stack([b, c], 1).reshape(-1, 3)
    p2 = np.stack([c, d], 1).reshape(-1, 3)
    uv = np.zeros((len(p0), 2), dtype=np.float32)
    return concat_triangle_data([TriangleData(
        p0=p0.astype(np.float32), p1=p1.astype(np.float32), p2=p2.astype(np.float32),
        uv0=uv, uv1=uv, uv2=uv)])


def harness(res, spp, device, eye=(0.0, 0.0, -4.0), look=(0.0, 0.0, 0.0), up=(0, 1, 0),
            fov=50.0, float_t=np.float32):
    """(camera, sampler, film) of the geometry-sharded harness: the
    reference test's perspective camera, Halton sampler, box-filtered
    film at ``res`` x ``res``, under the policy's float ``float_t``."""
    from pbrt_tpu_torch.cameras import PerspectiveCamera
    from pbrt_tpu_torch.core.film import Film
    from pbrt_tpu_torch.core.filters import BoxFilter
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.samplers import HaltonSampler

    film = Film((res, res), ((0, 0), (1, 1)), BoxFilter((0.5, 0.5)), device=device,
                float_t=float_t)
    cam = PerspectiveCamera(Transform.look_at(list(eye), list(look), list(up)).inverse(),
                            fov, (res, res), device=device, float_t=float_t)
    return cam, HaltonSampler(spp, float_t=float_t), film


def lanes(film, spp, ray_shards):
    """Pixel-major lanes (pixels [N, 2] int64, sample indices [N] int64),
    cut to a multiple of ``ray_shards`` as the reference's test does."""
    pixels = film.cropped_pixel_bounds.offsets().astype(np.int64)
    lane_pix = np.repeat(pixels, spp, axis=0)
    lane_sidx = np.tile(np.arange(spp, dtype=np.int64), len(pixels))
    n = (len(lane_pix) // ray_shards) * ray_shards
    return lane_pix[:n], lane_sidx[:n]


def save_shards(tables, directory):
    """One npz per shard of :func:`geomshard.shard_triangle_arrays`' tables
    (leading dim 1), so that each rank loads only its own -> paths."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    n_shards = len(tables["p0"])
    paths = []
    for s in range(n_shards):
        path = directory / f"shard{s}.npz"
        np.savez(path, **{k: v[s:s + 1] for k, v in tables.items()})
        paths.append(str(path))
    return paths


def _launch_counts():
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk

    return {"stream_walk8": bvh8_walk.LAUNCHES["stream_walk8"],
            "skip_walk": bvh2_walk.LAUNCHES["skip_walk"]}


def _reset_launch_counts():
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk

    bvh8_walk.reset_launch_counts()
    bvh2_walk.reset_launch_counts()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flat_leaves(tree, pre=""):
    """{"a/b": numpy leaf} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v.detach().cpu().numpy()
    return out


def rank_tasks(rank, world_size, device, tasks):
    """Several rank functions of this module in one world, in order:
    ``tasks`` = [(fn, kwargs)] -> [fn(rank, world_size, device, **kwargs)]."""
    return [fn(rank, world_size, device, **kw) for fn, kw in tasks]


# ---------------------------------------------------------------------------
# ShardedRenderer
# ---------------------------------------------------------------------------


def rank_sharding(rank, world_size, device, ckpt_dir=None, renderer_fn=None, spp=4,
                  grad_samples=2, grad_pixels=None, grad_target=None, meshes=((1,), (2,))):
    """``ShardedRenderer`` on this rank: the image of each (sp,) in
    ``meshes`` at ``spp`` (dp = world / sp) with its seconds and this
    rank's kernel launches; the gradient step on the (world / 2, 2) mesh
    (one rank: (1, 1)): ``grad_samples`` samples a pixel over sp, lr 1,
    ``grad_target`` (zeros unless given), the first ``grad_pixels`` pixels
    (all unless given) -> its loss, every leaf's gradient, seconds and
    launches; and, with ``ckpt_dir``, Cornell rendered through checkpoints,
    killed after two steps and resumed.  The scene is
    ``renderer_fn(device)`` (default: the sphere scene)."""
    from pbrt_tpu_torch.parallel.mesh import ShardedRenderer, default_mesh
    from pbrt_tpu_torch.parallel.multihost import global_mesh, process_local_slice

    r = (renderer_fn or sphere_renderer)(device)
    out = {"images": {}, "seconds": {}, "launches": {}}
    for (sp,) in meshes:
        mesh = default_mesh(world_size, sp=sp)
        sr = ShardedRenderer(r, mesh)
        _reset_launch_counts()
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        state = sr.render(spp=spp)
        _sync(device)
        out["seconds"][sp] = time.perf_counter() - t0
        out["launches"][sp] = _launch_counts()
        out["images"][sp] = r.image(state)
    sp = 2 if world_size % 2 == 0 else 1
    sr = ShardedRenderer(r, default_mesh(world_size, sp=sp))
    film_res = r.film.cropped_pixel_bounds
    target = (grad_target if grad_target is not None
              else np.zeros((film_res.height, film_res.width, 3), np.float32))
    theta = r.compiled.initial_theta()
    pixels = torch.as_tensor(film_res.offsets().astype(np.int64)[:grad_pixels], device=r.device)
    value_and_grad = sr.build_value_and_grad(target, spp=grad_samples // sp)
    _reset_launch_counts()
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    loss, grad = value_and_grad(theta, pixels)
    _sync(device)
    out["grad_seconds"] = time.perf_counter() - t0
    out["grad_launches"] = _launch_counts()
    out["loss"] = float(loss)
    out["grads"] = flat_leaves(grad)
    # the step applies that gradient: theta - 1 x grad
    _, new_theta = sr.build_grad_step(target, spp=grad_samples // sp, lr=1.0)(theta, pixels)
    out["step_kd"] = (theta["kd"] - new_theta["kd"]).cpu().numpy()
    m = global_mesh(sp=sp)
    out["mesh"] = (tuple(m.mesh_dim_names), tuple(m.shape), m.device_type)
    s = process_local_slice(4096)
    out["slice"] = (s.start, s.stop)
    if ckpt_dir is not None:
        out["resume"] = _kill_and_resume(device, ckpt_dir, world_size)
    return out


class _Preempted(Exception):
    pass


def _kill_and_resume(device, ckpt_dir, world_size):
    """Cornell at 16x16, 2 spp, maxdepth 2, 64-lane chunks, checkpointed
    every step: (uninterrupted image, resumed image, whether the
    interrupted render left its checkpoint)."""
    from pbrt_tpu_torch.parallel.mesh import CHECKPOINT_NAME, ShardedRenderer, default_mesh
    from pbrt_tpu_torch.testscenes import cornell_renderer

    def make(sub):
        r = cornell_renderer(xres=16, yres=16, spp=2, maxdepth=2, ray_batch=64, device=device)
        r.options.checkpoint_dir = str(Path(ckpt_dir) / sub)
        r.options.checkpoint_every = 1
        return ShardedRenderer(r, default_mesh(world_size, sp=2))

    sr_ref = make("ref")
    img_ref = sr_ref.r.image(sr_ref.render(spp=2))
    sr1 = make("kill")
    calls = {"n": 0}
    orig = sr1._sharded_step

    def dying(*a, **kw):
        if calls["n"] >= 2:
            raise _Preempted
        calls["n"] += 1
        return orig(*a, **kw)

    sr1._sharded_step = dying
    try:
        sr1.render(spp=2)
        raise RuntimeError("the interrupted render ran to its end")
    except _Preempted:
        pass
    dist.barrier()
    left = (Path(ckpt_dir) / "kill" / CHECKPOINT_NAME).exists()
    sr2 = make("kill")
    img2 = sr2.r.image(sr2.render(spp=2))
    return img_ref, img2, left


# ---------------------------------------------------------------------------
# Geometry sharding
# ---------------------------------------------------------------------------


def heightfield_scene(n=40):
    """(TriangleData, materials, lights) of the reference test's scene."""
    td = heightfield(n)
    return td, np.zeros(td.count, np.int32), np.full(td.count, -1, np.int32)


def rank_geomshard(rank, world_size, device, cases, grad_cases=(), scene=None, res=16, spp=2,
                   max_depth=3, shard_files=None, repeats=1, record_rank=None, camera=None,
                   n_mats=1, float_t=np.float32):
    """The geometry-sharded harness on this rank.

    ``cases``: (dp, tp, kind, formulation) with dp * tp = world size, kind
    in "brute", "skip", "packed" -> the image of each, its seconds (the
    best of ``repeats``) and this rank's kernel launches (of the last
    repeat).  ``grad_cases``: (dp, tp, kind, remat) -> loss, gradients,
    seconds, launches and peak memory on the card.  ``scene``:
    (TriangleData, mats, lights) or a function that makes it, the
    heightfield unless given, lit by the harness's environment with kd
    (0.6, 0.5, 0.4) on each of its ``n_mats`` materials;
    ``camera``: keyword arguments of :func:`harness`; ``shard_files``:
    {(tp, kind): per-shard npz paths from :func:`save_shards`} in place of
    building the tables here.  On rank ``record_rank``, the rays of every
    shard sweep of the first case of each walked kind are recorded and
    returned under ``sweeps`` ({kind: [(o, d, t_max) numpy]}), so that
    the parent can hold that shard's kernel against its plain version
    and time it once the world has exited.  ``float_t``: the harness's
    policy (its camera, sampler and film)."""
    from pbrt_tpu_torch.parallel import geomshard as G
    from pbrt_tpu_torch.parallel.multihost import axis, global_mesh

    cam, sampler, film = harness(res, spp, device, **(camera or {}), float_t=float_t)
    kd = np.tile(np.array([[0.6, 0.5, 0.4]], dtype=np.float32), (n_mats, 1))
    env = np.array([0.8, 0.9, 1.0], dtype=np.float32)
    shards = {}

    def shard_for(tp, kind, tp_index):
        key = (tp, kind)
        if key not in shards:
            if shard_files and key in shard_files:
                with np.load(shard_files[key][tp_index]) as z:
                    tables = {k: z[k] for k in z.files}
                shards[key] = G.local_shard(tables, 0, device)
            else:
                made = (scene() if callable(scene) else scene) or heightfield_scene()
                tables = G.shard_triangle_arrays(*made, tp, bvh=kind != "brute",
                                                 packed=kind == "packed")
                shards[key] = G.local_shard(tables, tp_index, device)
        return shards[key]

    out = {"images": {}, "seconds": {}, "launches": {}, "grads": {}, "sweeps": {}}
    for case in cases:
        dp, tp, kind, formulation = case
        mesh = global_mesh(dp=dp, sp=1, tp=tp)
        shard = shard_for(tp, kind, axis(mesh, "tp")[2])
        fn = G.make_sharded_path_fn(mesh, cam, sampler, film, kd, env, max_depth=max_depth,
                                    formulation=formulation)
        pix, sidx = lanes(film, spp, dp * tp if formulation == "ring" else dp)
        pix = torch.as_tensor(pix, device=device)
        sidx = torch.as_tensor(sidx, device=device)
        best = None
        for _ in range(repeats):
            _reset_launch_counts()
            dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            state = fn(film.initial_state(), shard, pix, sidx)
            _sync(device)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        out["seconds"][case] = best
        out["launches"][case] = _launch_counts()
        out["images"][case] = film.to_rgb(state).cpu().numpy()
        if record_rank is not None and kind != "brute" and kind not in out["sweeps"]:
            # every rank renders (the render is collective); one keeps its rays
            sweeps = _record(G, lambda: fn(film.initial_state(), shard, pix, sidx))
            out["sweeps"][kind] = ([tuple(x.cpu().numpy() for x in sw) for sw in sweeps]
                                   if rank == record_rank else None)
    out["transport"] = dict(G.TRANSPORT)
    target = np.full((res, res, 3), 0.25, dtype=np.float32)
    for case in grad_cases:
        dp, tp, kind, remat = case
        mesh = global_mesh(dp=dp, sp=1, tp=tp)
        shard = shard_for(tp, kind, axis(mesh, "tp")[2])
        fn = G.make_sharded_grad_fn(mesh, cam, sampler, film, target, max_depth=max_depth,
                                    remat=remat)
        pixels = film.cropped_pixel_bounds.offsets().astype(np.int64)
        pixels = pixels[:(len(pixels) // dp) * dp]
        theta = {"kd": torch.as_tensor(kd, device=device),
                 "env_l": torch.as_tensor(env, device=device)}
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        dist.barrier()
        t0 = time.perf_counter()
        loss, grads = fn(theta, shard, torch.as_tensor(pixels, device=device),
                         torch.zeros(len(pixels), dtype=torch.int64, device=device))
        _sync(device)
        out["grads"][case] = {
            "loss": float(loss), "grads": {k: v.cpu().numpy() for k, v in grads.items()},
            "seconds": time.perf_counter() - t0, "launches": _launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    return out


def _record(G, run):
    """Run ``run()`` with ``geomshard.local_closest_hit`` recording its
    rays -> [(o, d, t_max)], one a sweep of this rank's shard."""
    sweeps = []
    orig = G.local_closest_hit

    def recording(shard, o, d, t_max, *a, **kw):
        n = o.shape[0]
        sweeps.append((o.clone(), d.clone(), torch.broadcast_to(
            torch.as_tensor(t_max, dtype=o.dtype, device=o.device), (n,)).clone()))
        return orig(shard, o, d, t_max, *a, **kw)

    G.local_closest_hit = recording
    try:
        run()
    finally:
        G.local_closest_hit = orig
    return sweeps


__all__ = ["SPHERE_SCENE", "config5_scene", "flat_leaves", "harness", "heightfield",
           "heightfield_scene", "lanes", "rank_geomshard", "rank_sharding", "rank_tasks",
           "save_shards", "scene_renderer", "sphere_renderer"]
