"""pbrt_tpu_torch host layer against the JAX reference: scene parsing and
build, the SAH BVH, and the packed BVH8 / streaming tables.

All of these are exact: the port's host code is a copy of the
reference's numpy code, so every table must be equal (np.array_equal).
The scene is BASELINE config 3 with a small torus (48 x 48 -> 4608
triangles, still >= 4096, so the streaming tables are built).

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pbrt_tpu.accel.bvh import build_bvh as ref_build_bvh
from pbrt_tpu.ops.bvh8 import pack_tree8 as ref_pack_tree8
from pbrt_tpu.ops.stream_bvh import pack_stream_tables as ref_pack_stream_tables
from pbrt_tpu.testscenes import mesh_scene_renderer as ref_mesh_scene

_SCENE = dict(xres=16, yres=16, spp=2, maxdepth=3, nu=48, nv=48)


@pytest.fixture(scope="module")
def scenes():
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    ref, n_ref = ref_mesh_scene(**_SCENE)
    port, n_port = mesh_scene_renderer(**_SCENE, device="cpu")
    assert n_ref == n_port == 4608
    return ref.compiled, port.compiled


def _assert_tables_equal(got, want, path="tables"):
    import torch

    assert type(got) is type(want) or isinstance(got, torch.Tensor), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tables_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_scene_tables_match_reference(scenes):
    from pbrt_tpu_torch.ops.stream_bvh import StreamBVH
    from pbrt_tpu_torch.scene.convert import tables_from_numpy

    ref, port = scenes
    ref_np = {
        "tri": {k: np.asarray(v) for k, v in ref.tables["tri"].items()},
        "_flags": dict(ref.tables["_flags"]),
    }
    _assert_tables_equal(port.tables, tables_from_numpy(ref_np, "cpu"))
    assert port.tables["_flags"] == {
        "uv": True, "tri_flat": True, "tex_width": True, "animated_keys": 0}
    for f in ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2"):
        np.testing.assert_array_equal(getattr(port.tri_data, f), getattr(ref.tri_data, f))
    assert [type(lt).__name__ for lt in port.lights] == [
        type(lt).__name__ for lt in ref.lights]
    assert [e.type_id for e in port.materials] == [e.type_id for e in ref.materials]
    assert isinstance(port.intersector.walk, StreamBVH)


def test_bvh_build_and_stream_tables_match_reference(scenes):
    import torch

    from pbrt_tpu_torch.accel.bvh import build_bvh

    ref, port = scenes
    td = ref.tri_data
    want = ref_build_bvh(td.p0, td.p1, td.p2, 32)
    got = build_bvh(td.p0, td.p1, td.p2, 32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    m, x, s, f, c, perm = want
    tp = (td.p0[perm], td.p1[perm], td.p2[perm])
    ref_t = ref_pack_stream_tables(m, x, s, f, c, *tp, leaf_slots=32, wide=True)
    port_t = port.intersector.walk.tables
    assert set(port_t) == set(ref_t)
    for k in ref_t:
        np.testing.assert_array_equal(port_t[k], ref_t[k], err_msg=k)
    # the device tables are exactly the packed host tables
    assert torch.equal(port.intersector.walk.nodes, torch.as_tensor(ref_t["nodes"]))
    assert torch.equal(port.intersector.walk.roots, torch.as_tensor(ref_t["roots"]))


def test_pack_tree8_matches_reference(scenes):
    import torch

    from pbrt_tpu_torch.ops.bvh8 import WideBVH8, pack_tree8

    ref, _ = scenes
    td = ref.tri_data
    m, x, s, f, c, perm = ref_build_bvh(td.p0, td.p1, td.p2, 16)
    tp = (td.p0[perm], td.p1[perm], td.p2[perm])
    want = ref_pack_tree8(m, x, s, f, c, *tp, leaf_slots=16)
    got = pack_tree8(m, x, s, f, c, *tp, leaf_slots=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    wide = WideBVH8(m, x, s, f, c, *tp, leaf_slots=16, device="cpu")
    assert torch.equal(wide.nodes, torch.as_tensor(want[0]))
    assert torch.equal(wide.tris, torch.as_tensor(want[1]))
    assert int(wide.root[0]) == int(want[2])


def test_port_never_imports_jax():
    """Neither the package nor any of its modules imports JAX, and no
    module reads a ``PBRT_TPU_*`` environment switch (the port takes
    arguments instead)."""
    import pathlib
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = pathlib.Path(repo) / "pbrt_tpu_torch"
    modules = sorted(
        ".".join(p.relative_to(repo).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )
    assert {"pbrt_tpu_torch.kernels.bvh2_walk", "pbrt_tpu_torch.kernels.bitonic",
            "pbrt_tpu_torch.ops.pallas_bvh", "pbrt_tpu_torch.ops.sortnet",
            "pbrt_tpu_torch.ops.intersect_soa", "pbrt_tpu_torch.diff.grad",
            "pbrt_tpu_torch.core.imageio", "pbrt_tpu_torch.core.mipmap",
            "pbrt_tpu_torch.textures.imagemap", "pbrt_tpu_torch.core.animated",
            "pbrt_tpu_torch.ops.animated_intersect", "pbrt_tpu_torch.kernels.anim_walk",
            "pbrt_tpu_torch.cameras.realistic", "pbrt_tpu_torch.integrators.sppm"} <= set(modules)
    for p in pkg.rglob("*.py"):
        assert not re.search(r"(environ|getenv)\W*\(?\W*[\"']PBRT_TPU_", p.read_text()), p
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {modules!r}]; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
