"""Mesh-sharded rendering in pbrt_tpu_torch against the reference, on the CPU.

The port's ranks are one spawned world of 4 gloo processes (a module
fixture, ``parallel/multihost.run_local_world``, with a deadline); the
reference runs on the conftest's virtual CPU devices on the same mesh
shapes (``default_mesh(4, sp)``).  The scene is the reference test's
sphere (tests/test_sharding.py: 16x16, 4 spp, maxdepth 2, 256-lane
chunks).  dp sharding is held to 2e-6 and sp sharding to 2e-5 of the
image, as the reference holds its own.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from pbrt_tpu_torch.parallel.multihost import run_local_world
    from pbrt_tpu_torch.parallel.worlds import rank_sharding

    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    return run_local_world(rank_sharding, 4, backend="gloo", device="cpu", timeout_s=120,
                           args=(str(ckpt),))


def _reference(sp, ray_batch=256):
    from pbrt_tpu import Options as RefOptions
    from pbrt_tpu.core.api import PbrtAPI as RefAPI
    from pbrt_tpu.parallel.mesh import ShardedRenderer, default_mesh
    from pbrt_tpu.render import Renderer as RefRenderer
    from pbrt_tpu_torch.parallel.worlds import SPHERE_SCENE

    api = RefAPI(RefOptions(ray_batch=ray_batch), render_on_world_end=False)
    api.init()
    api.parse_string(SPHERE_SCENE)
    r = RefRenderer(api.scene, api.opt, seed=0)
    return r, ShardedRenderer(r, default_mesh(4, sp=sp))


@pytest.mark.parametrize("sp", [1, 2])
def test_sharded_render_matches_reference(world, sp):
    """``ShardedRenderer`` at dp=4 (sp=1) and dp=2 sp=2: every rank holds
    the same film, equal to the reference's ShardedRenderer on the same
    mesh and to the port's single render, to 2e-6 (dp) / 2e-5 (sp)."""
    from pbrt_tpu_torch.parallel.worlds import sphere_renderer

    atol = 2e-6 if sp == 1 else 2e-5
    got = world[0]["images"][sp]
    for r in world[1:]:
        np.testing.assert_array_equal(r["images"][sp], got)
    ref, sr = _reference(sp)
    want = np.asarray(ref.film.to_rgb(sr.render(spp=4)))
    np.testing.assert_allclose(got, want, atol=atol)
    single = sphere_renderer("cpu")
    np.testing.assert_allclose(got, single.image(single.render(spp=4)), atol=atol)
    assert got.max() > 0.1


def test_grad_step_matches_reference(world):
    """``build_grad_step`` on the (2, 2) mesh, 1 sample a rank (2 a
    pixel), lr 1, a zero target: the loss and the kd gradient (theta -
    new theta) equal the reference's step on the same mesh and the port's
    single-process ``make_loss_fn`` gradient, rtol 1e-4 and 1e-3."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.parallel.worlds import sphere_renderer

    ref, sr = _reference(2)
    target = np.zeros((16, 16, 3), dtype=np.float32)
    theta = ref.compiled.initial_theta()
    pixels = ref.film.cropped_pixel_bounds.offsets().astype(np.int32)
    step = sr.build_grad_step(target, spp=1, lr=1.0)
    loss, new_theta = step(theta, jnp.asarray(pixels))
    ref_g = np.asarray(theta["kd"] - new_theta["kd"])
    for r in world:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(r["grads"]["kd"], ref_g, rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(r["step_kd"], ref_g, rtol=1e-3, atol=1e-7)
    single = sphere_renderer("cpu")
    value, g = value_and_grad(make_loss_fn(single, target, spp=2),
                              single.compiled.initial_theta(),
                              torch.as_tensor(pixels.astype(np.int64)))
    np.testing.assert_allclose(world[0]["loss"], float(value), rtol=1e-4)
    for k, v in world[0]["grads"].items():
        np.testing.assert_allclose(v, g[k].numpy(), rtol=1e-3, atol=1e-7, err_msg=k)
    assert np.abs(ref_g).max() > 0 and jax.device_count() >= 4


def test_sharded_kill_and_resume_bit_identical(world):
    """Cornell checkpointed every step over the (2, 2) mesh, killed after
    two steps and resumed by a fresh ShardedRenderer: the resumed image
    equals the uninterrupted one exactly, on every rank."""
    for r in world:
        img_ref, img_resumed, left = r["resume"]
        assert left
        assert img_ref.max() > 0
        np.testing.assert_array_equal(img_resumed, img_ref)


def test_mesh_helpers(world, monkeypatch):
    """``global_mesh`` spans the world with the reference's axis names on
    the device the world was spawned with, ``process_local_slice`` hands
    rank p lanes [p n / 4, (p + 1) n / 4), a single process's
    ``initialize_multihost`` makes no group, and a world asked for no
    device is one on the card: without a card it raises before spawning."""
    import torch
    import torch.distributed as dist

    from pbrt_tpu_torch.parallel.multihost import (default_backend, initialize_multihost,
                                                   process_local_slice, run_local_world)
    from pbrt_tpu_torch.parallel.worlds import rank_tasks

    for rank, r in enumerate(world):
        assert r["mesh"] == (("dp", "sp"), (2, 2), "cpu")
        assert r["slice"] == (rank * 1024, (rank + 1) * 1024)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_multihost() is False
    assert not dist.is_initialized()
    assert process_local_slice(4096) == slice(0, 4096)
    assert (default_backend(), default_backend("cpu")) == ("nccl", "gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            run_local_world(rank_tasks, 2, timeout_s=5, args=([],))
