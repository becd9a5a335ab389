"""pbrt_tpu_torch device math against the JAX reference: hashes, Halton
samples, ray sort keys and camera rays on seeded grids.

Integer results (hashes, sort keys) and Halton samples must be
bit-equal: the port carries uint32 in int64 and repeats the reference's
float32 digit arithmetic.  Camera rays go through 4x4 matrix products
whose summation order may differ: rtol 1e-6.

The file keeps to four tests: pytest-xdist queues files with more tests
first, and this one must not run ahead of the suite's longest file.

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu.core import rng as ref_rng
from pbrt_tpu.samplers import HaltonSampler as RefHalton
from pbrt_tpu.testscenes import mesh_scene_renderer as ref_mesh_scene

_SCENE = dict(xres=16, yres=16, spp=2, maxdepth=3, nu=48, nv=48)


def _u32_grid(n=4096, seed=7):
    r = np.random.default_rng(seed)
    x = r.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    x[:8] = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF, 0x9E3779B9]
    return x


def _to_torch(x):
    import torch

    return torch.as_tensor(x.astype(np.int64))


def test_hashes_bit_equal():
    """hash_u32, pcg3d and u32_to_float on a seeded uint32 grid."""
    from pbrt_tpu_torch.core import rng

    x, y, z = _u32_grid(seed=1), _u32_grid(seed=2), _u32_grid(seed=3)
    want = np.asarray(ref_rng.hash_u32(jnp.asarray(x)))
    np.testing.assert_array_equal(rng.hash_u32(_to_torch(x)).numpy(), want.astype(np.int64))
    want = ref_rng.pcg3d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    got = rng.pcg3d(_to_torch(x), _to_torch(y), _to_torch(z))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    want = np.asarray(ref_rng.u32_to_float(jnp.asarray(x)))
    got = rng.u32_to_float(_to_torch(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _pixel_sample_grid():
    """16x16 pixels x 8 samples, pixel-major lanes (as the dense film)."""
    ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    pix = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.int32)
    pix = np.repeat(pix, 8, axis=0)
    sidx = np.tile(np.arange(8, dtype=np.uint32), 256)
    return pix, sidx


def test_halton_bit_equal():
    import torch

    from pbrt_tpu_torch.samplers import HaltonSampler

    pix, sidx = _pixel_sample_grid()
    ref = RefHalton(8, seed=3).bounded(8)
    port = HaltonSampler(8, seed=3).bounded(8)
    jp, js = jnp.asarray(pix), jnp.asarray(sidx)
    tp, ts = torch.as_tensor(pix), torch.as_tensor(sidx.astype(np.int64))
    for dim in (0, 1, 2, 3, 4, 5, 20):
        want = np.asarray(ref.get(jp, js, dim))
        got = port.get(tp, ts, dim).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=f"dim {dim}")
        want2 = np.asarray(ref.get2(jp, js, dim))
        got2 = port.get2(tp, ts, dim).numpy()
        np.testing.assert_array_equal(got2.view(np.uint32), want2.view(np.uint32),
                                      err_msg=f"get2 dim {dim}")


@pytest.fixture(scope="module")
def renderers():
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    ref, _ = ref_mesh_scene(**_SCENE)
    port, _ = mesh_scene_renderer(**_SCENE, device="cpu")
    return ref, port


def test_ray_order_bit_equal(renderers):
    """sort_keys equal the reference's _sort_keys, and co_sort (stable sort
    + gathers) gives lax.sort's permutation, duplicate and dead-bit keys
    included."""
    import torch

    from pbrt_tpu_torch.ops.sortnet import co_sort

    ref, port = renderers
    r = np.random.default_rng(11)
    n = 4096
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:1024] = [2.8, 2.2, 2.8]  # a shared-origin (camera) wavefront
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(r.uniform(size=n) < 0.2, 0.0, 1e8).astype(np.float32)
    want = np.asarray(ref.compiled.intersector.sort_keys(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    got = port.compiled.intersector.sort_keys(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # dead lanes carry bit 31 and sort last (int64 keys stay positive)
    assert (got[t_max == 0] >= 2**31).all() and (got[t_max > 0] < 2**31).all()

    keys = r.integers(0, 64, 8192).astype(np.uint32)
    keys[::5] |= np.uint32(1 << 31)
    payload = r.normal(size=8192).astype(np.float32)
    lane = np.arange(8192, dtype=np.int32)
    want = jax.lax.sort((jnp.asarray(keys), jnp.asarray(lane), jnp.asarray(payload)),
                        num_keys=1)
    got = co_sort((torch.as_tensor(keys.astype(np.int64)), torch.as_tensor(lane),
                   torch.as_tensor(payload)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_camera_rays_match(renderers):
    import torch

    ref, port = renderers
    r = np.random.default_rng(5)
    p_film = r.uniform(0, 16, (2048, 2)).astype(np.float32)
    o_r, d_r, w_r = ref.camera.generate_rays(jnp.asarray(p_film))
    o_p, d_p, w_p = port.camera.generate_rays(torch.as_tensor(p_film))
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_r), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_r))
