"""Geometry sharding in pbrt_tpu_torch against the reference, on the CPU.

The port's ranks are one spawned world of 4 gloo processes (a module
fixture, ``parallel/multihost.run_local_world``, with a deadline); the
reference runs on the conftest's virtual CPU devices.  The scene is the
reference test's heightfield (tests/test_geomshard.py: 3,042 triangles,
16x16, 2 spp, maxdepth 3).  The reference's images are the same on
every mesh and formulation (its own tests hold them to 2e-6), and its
packed tables take its slow XLA walk on the CPU, so to stay in time it
renders one (dp, tp, formulation) per table kind, on the mesh shape the
port's world also renders; every port image of that kind is held to it.
"""

import numpy as np
import pytest

_CASES = [(dp, tp, kind, f) for kind in ("brute", "skip", "packed")
          for dp, tp in ((1, 4), (2, 2)) for f in ("allreduce", "ring")]
_GRADS = [(1, 4, "skip", True), (2, 2, "packed", False)]
_REF_CASE = {"brute": (1, 4, "ring"), "skip": (2, 2, "ring"), "packed": (2, 2, "allreduce")}


@pytest.fixture(scope="module")
def world():
    from pbrt_tpu_torch.parallel.multihost import run_local_world
    from pbrt_tpu_torch.parallel.worlds import rank_geomshard

    return run_local_world(rank_geomshard, 4, backend="gloo", device="cpu", timeout_s=120,
                           args=(_CASES, _GRADS))


@pytest.mark.parametrize("kind", ["brute", "skip", "packed"])
def test_sharded_path_matches_reference(world, kind):
    """``make_sharded_path_fn`` at (dp, tp) = (1, 4) and (2, 2), allreduce
    and ring, on brute, skip-link (K6's plain version) and packed (K2's
    plain version) shard tables: every rank ends with the same film, and
    every image equals the reference's to 2e-6."""
    from test_geomshard import render_with

    dp, tp, formulation = _REF_CASE[kind]
    want = render_with(dp=dp, tp=tp, formulation=formulation, bvh=kind != "brute",
                       pallas=kind == "packed")
    assert want.max() > 0.05
    for case in _CASES:
        if case[2] != kind:
            continue
        got = world[0]["images"][case]
        for r in world[1:]:
            np.testing.assert_array_equal(r["images"][case], got)
        np.testing.assert_allclose(got, want, atol=2e-6, err_msg=str(case))
    transport = world[0]["transport"]
    assert transport["ring"] == transport["all_reduce_min"] == "gloo (cpu tensors)"


def test_sharded_gradients_match_reference(world):
    """``make_sharded_grad_fn`` (remat on skip-link tables at (1, 4), off on
    packed ones at (2, 2)) against the reference's on the same mesh: loss
    rtol 1e-4, gradients rtol 1e-3.  The port's gradient is the loss's;
    the reference's ``shard_map`` transposes its loss psum to a psum, so
    its gradient is the number of devices times that, and is divided by
    dp * tp here (on one device the reference gives the port's)."""
    from test_geomshard import _grad_with

    for case in _GRADS:
        dp, tp = case[:2]
        ref_loss, ref_g = _grad_with(dp=dp, tp=tp)
        got = world[0]["grads"][case]
        for r in world[1:]:
            assert r["grads"][case]["loss"] == got["loss"]
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-4)
        for k in ("kd", "env_l"):
            assert np.abs(got["grads"][k]).max() > 0
            np.testing.assert_allclose(got["grads"][k], ref_g[k] / (dp * tp), rtol=1e-3)


@pytest.mark.parametrize("kind", ["bvh", "packed"])
def test_shard_tables_match_reference(kind):
    """The host shard tables equal the reference's byte for byte (its
    ``pallas=True`` is the port's ``packed=True``), and ``local_shard``'s
    sweep on them finds the reference test's hit and miss."""
    import torch

    from pbrt_tpu.parallel.geomshard import shard_triangle_arrays as ref_shard
    from pbrt_tpu_torch.parallel.geomshard import local_closest_hit, local_shard
    from pbrt_tpu_torch.parallel.geomshard import shard_triangle_arrays
    from pbrt_tpu_torch.parallel.worlds import heightfield_scene

    scene = heightfield_scene()
    port_kw = {"bvh": True} if kind == "bvh" else {"packed": True}
    ref_kw = {"bvh": True} if kind == "bvh" else {"pallas": True}
    got = shard_triangle_arrays(*scene, 4, **port_kw)
    want = ref_shard(*scene, 4, **ref_kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    o = torch.tensor([[0.0, 0.0, -3.0], [5.0, 5.0, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    hits = [local_closest_hit(local_shard(got, s, "cpu"), o, d, 1e8)[1] for s in range(4)]
    assert max(int(h[0]) for h in hits) >= 0  # the centre ray hits one slice
    assert all(int(h[1]) < 0 for h in hits)  # the ray beside the grid misses them all
