"""The reference's sort and key switches as arguments of pbrt_tpu_torch.

The reference reads them from environment variables
(``PBRT_TPU_NO_SORTED_CARRY``, ``PBRT_TPU_SC_MERGED``,
``PBRT_TPU_SC_NOSORT_SHADOW``, ``PBRT_TPU_STREAM_MIN_TRIS``,
``PBRT_TPU_KEY_OBITS``, ``PBRT_TPU_NO_DEADBIT``); the port takes
``Renderer(..., sorted_carry=, shadow_sort=, stream_min_tris=, key_obits=,
deadbit=)``.  Each image is held against the reference rendered under the
matching variable, at ``tests/test_torch_slice.py``'s tolerance (the
port's packed walk against the reference's skip-link walk on the CPU):
image-mean relative difference <= 1e-3 and >= 99% of pixels within rtol
1e-3 / atol 1e-4.  Sort keys and the wide co_sort are bit-equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp

# the 24x24 torus (1,156 triangles), below the default streaming threshold
_SCENE = dict(xres=16, yres=16, spp=2, maxdepth=4, nu=24, nv=24)

# port arguments -> the reference's variables
_MODES = {
    "sorted": ({}, {}),
    "unsorted": ({"shadow_sort": "unsorted"}, {"PBRT_TPU_SC_NOSORT_SHADOW": "1"}),
    "merged": ({"shadow_sort": "merged"}, {"PBRT_TPU_SC_MERGED": "1"}),
    "no_sorted_carry": ({"sorted_carry": False}, {"PBRT_TPU_NO_SORTED_CARRY": "1"}),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_shadow_modes_match_reference(mode, monkeypatch):
    """Each shadow mode and ``sorted_carry=False`` under
    ``stream_min_tris=512``: the 1,156-triangle torus takes the streaming
    BVH8 tables (K2's walk) instead of the whole tree (K1's), and the
    image equals the reference's under the same variables."""
    import torch
    from test_torch_slice import _compare

    from pbrt_tpu.testscenes import mesh_scene_renderer as ref_mesh_scene
    from pbrt_tpu_torch.integrators.path import PathIntegrator
    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.ops.stream_bvh import StreamBVH
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    port_args, ref_env = _MODES[mode]
    monkeypatch.setenv("PBRT_TPU_STREAM_MIN_TRIS", "512")
    for k, v in ref_env.items():
        monkeypatch.setenv(k, v)
    ref, _ = ref_mesh_scene(**_SCENE)
    want = np.asarray(ref.film.to_rgb(ref.render(progress=False)))

    calls = {"stream": 0, "wide": 0}
    for name, key in (("stream_walk8_plain", "stream"), ("wide_walk8_plain", "wide")):
        orig = getattr(bvh8_walk, name)

        def counting(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(bvh8_walk, name, counting)
    port, _ = mesh_scene_renderer(**_SCENE, device="cpu", stream_min_tris=512, **port_args)
    assert isinstance(port.compiled.intersector.walk, StreamBVH)
    assert isinstance(port.integrator, PathIntegrator)
    assert port.integrator._sc == (mode != "no_sorted_carry")
    with torch.no_grad():
        got = port.image(port.render())
    # 2 chunks x (4 closest + 3 shadow) sweeps, every one through the
    # streaming walk and none through the whole tree
    assert calls == {"stream": 7, "wide": 0}
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean, close = _compare(got, want, 1e-3, 1e-4)
    assert rel_mean <= 1e-3
    assert close >= 0.99


@pytest.mark.parametrize("switch", ["key_obits=4", "deadbit=False"])
def test_sort_keys_match_reference(switch, monkeypatch):
    """``sort_keys`` under ``key_obits=4`` / ``deadbit=False`` equals the
    reference's under ``PBRT_TPU_KEY_OBITS=4`` / ``PBRT_TPU_NO_DEADBIT=1``,
    bit for bit."""
    import torch

    from pbrt_tpu.testscenes import mesh_scene_renderer as ref_mesh_scene
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    name = switch.split("=")[0]
    env = {"key_obits": ("PBRT_TPU_KEY_OBITS", "4"),
           "deadbit": ("PBRT_TPU_NO_DEADBIT", "1")}[name]
    monkeypatch.setenv(*env)
    arg = {"key_obits": 4} if name == "key_obits" else {"deadbit": False}
    ref, _ = ref_mesh_scene(**_SCENE)
    port, _ = mesh_scene_renderer(**_SCENE, device="cpu", **arg)
    r = np.random.default_rng(12)
    n = 4096
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:1024] = [2.8, 2.2, 2.8]
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(r.uniform(size=n) < 0.2, 0.0, 1e8).astype(np.float32)
    want = np.asarray(ref.compiled.intersector.sort_keys(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))).astype(np.int64)
    got = port.compiled.intersector.sort_keys(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)).numpy()
    np.testing.assert_array_equal(got, want)
    default, _ = mesh_scene_renderer(**_SCENE, device="cpu")
    base = default.compiled.intersector.sort_keys(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)).numpy()
    assert not np.array_equal(got, base)  # the switch changed the keys


def test_wide_co_sort_matches_reference():
    """A 30-column co_sort at 32,768 lanes under ``network="bitonic"``
    takes the reference's split (groups of 20 payload columns sorted by
    (key, lane)): every column equals the reference's ``co_sort``, bit for
    bit, duplicate and dead-bit keys included."""
    import torch

    from pbrt_tpu.ops.sortnet import co_sort as ref_co_sort
    from pbrt_tpu_torch.ops.sortnet import co_sort

    r = np.random.default_rng(30)
    n = 1 << 15
    keys = r.integers(0, 4096, n).astype(np.uint32)
    keys[::7] |= np.uint32(1 << 31)
    cols = [r.normal(size=n).astype(np.float32) for _ in range(25)]
    cols += [r.integers(-1000, 1000, n).astype(np.int32) for _ in range(4)]
    want = ref_co_sort(tuple(jnp.asarray(x) for x in [keys] + cols))
    got = co_sort(tuple(torch.as_tensor(x) for x in [keys.astype(np.int64)] + cols),
                  "bitonic")
    assert len(got) == 30
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
