"""The BVH8 walk kernels' plain PyTorch versions against the reference
Pallas kernels (run in interpret mode, as tests/test_bvh8.py runs them).

The reference's own packed tables reach the port's wrappers through
``scene.convert.tables_from_numpy``.  Tolerances: hit masks equal; t
within rtol 1e-6; slot ids equal wherever no second candidate lies
within 1e-6 of t (the two walks visit children in different orders, so
only exact t ties may resolve differently).  Any-hit: masks equal.
Every ray set includes dead lanes (t_max = 0): the streaming walk keeps
their t_max, the whole-tree walk makes them inert at -1e30.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.  The file keeps to
four tests or fewer: pytest-xdist queues files with more tests first, and
this one must not run ahead of the suite's longest file.

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu.accel.bvh import build_bvh
from pbrt_tpu.ops.bvh8 import PallasBVH8
from pbrt_tpu.ops.stream_bvh import StreamBVH as RefStreamBVH
from pbrt_tpu.ops.stream_bvh import stream_traverse as ref_stream_traverse


def _soup(n, seed=0, scale=0.08):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def _rays(n, seed=2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((n,), 1e9, np.float32)
    t_max[::97] = 0.0  # dead lanes
    return o, d, t_max


def assert_walks_agree(t_a, slot_a, t_b, slot_b, any_hit, tris, o, d):
    from pbrt_tpu_torch.kernels import bvh8_walk

    problem = bvh8_walk.walk_disagreement(t_a, slot_a, t_b, slot_b, any_hit, tris, o, d)
    assert problem is None, problem


def test_stream_walk_matches_reference():
    import torch

    from pbrt_tpu_torch.ops.stream_bvh import stream_traverse
    from pbrt_tpu_torch.scene.convert import tables_from_numpy

    p0, p1, p2 = _soup(5000, seed=1)
    m, x, s, f, c, perm = build_bvh(p0, p1, p2, leaf_size=16)
    ref = RefStreamBVH(m, x, s, f, c, p0[perm], p1[perm], p2[perm],
                       target_tris=2048, interpret=True, leaf_slots=16, wide=True)
    tab = tables_from_numpy(
        {k: np.asarray(getattr(ref, k)) for k in ("nodes", "tris", "roots", "cl_min", "cl_max")},
        "cpu",
    )
    assert tab["nodes"].shape[0] >= 3  # several clusters
    o, d, t_max = _rays(1024, seed=3)
    dead = t_max == 0
    for any_hit in (False, True):
        t_r, slot_r = ref_stream_traverse(
            ref.nodes, ref.tris, ref.roots, ref.cl_min, ref.cl_max,
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            any_hit=any_hit, leaf_slots=16, interpret=True,
        )
        t_p, slot_p = stream_traverse(
            tab["nodes"], tab["tris"], tab["roots"], tab["cl_min"], tab["cl_max"],
            torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max), any_hit=any_hit,
        )
        t_r, slot_r = np.asarray(t_r), np.asarray(slot_r)
        t_p, slot_p = t_p.numpy(), slot_p.numpy()
        assert (slot_r >= 0).sum() > 50
        assert_walks_agree(t_r, slot_r, t_p, slot_p, any_hit, np.asarray(ref.tris), o, d)
        assert (slot_p[dead] == -1).all()
        if not any_hit:
            assert (t_p[dead] == 0.0).all()  # streaming keeps the entry t_max


def test_wide_walk_matches_reference():
    import torch

    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.ops.stream_bvh import split_pad_rays
    from pbrt_tpu_torch.scene.convert import tables_from_numpy

    p0, p1, p2 = _soup(1500)
    m, x, s, f, c, perm = build_bvh(p0, p1, p2, leaf_size=16)
    ref = PallasBVH8(m, x, s, f, c, p0[perm], p1[perm], p2[perm],
                     interpret=True, leaf_slots=16)
    tab = tables_from_numpy(
        {"nodes": np.asarray(ref.nodes_f), "tris": np.asarray(ref.tris),
         "root": np.asarray(ref.root_arr)}, "cpu")
    o, d, t_max = _rays(1024)
    dead = t_max == 0
    comps = split_pad_rays(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max), 1024)
    for any_hit in (False, True):
        t_r, slot_r = ref.traverse(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                   any_hit=any_hit, remap=False)
        launches = dict(bvh8_walk.LAUNCHES)
        t_p, slot_p = bvh8_walk.wide_walk8(tab["nodes"], tab["tris"], tab["root"], comps,
                                           any_hit=any_hit)
        assert bvh8_walk.LAUNCHES == launches  # CPU tensors: plain version, no launch
        t_r, slot_r = np.asarray(t_r), np.asarray(slot_r)
        t_p, slot_p = t_p.numpy(), slot_p.numpy()
        assert (slot_r >= 0).sum() > 20
        assert_walks_agree(t_r, slot_r, t_p, slot_p, any_hit, np.asarray(ref.tris), o, d)
        assert (slot_p[dead] == -1).all()
        assert (t_p[dead] == np.float32(-1e30)).all()  # whole tree: dead lanes inert


def test_wrappers_reject_unsupported_devices():
    import torch

    from pbrt_tpu_torch.kernels import bvh8_walk

    meta = dict(device="meta")
    comps = tuple(torch.empty(1024, **meta) for _ in range(7))
    with pytest.raises(ValueError, match="unsupported device"):
        bvh8_walk.wide_walk8(torch.empty(8, 64, **meta), torch.empty(8, 128, **meta),
                             torch.empty(1, dtype=torch.int32, **meta), comps)
    with pytest.raises(ValueError, match="unsupported device"):
        bvh8_walk.stream_walk8(
            torch.empty(2, 8, 64, **meta), torch.empty(2, 8, 128, **meta),
            torch.empty(2, dtype=torch.int32, **meta),
            torch.empty(1, 2, dtype=torch.int32, **meta),
            torch.empty(1, dtype=torch.int32, **meta), comps)

    from pbrt_tpu_torch.kernels import bitonic, bvh2_walk

    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        bvh2_walk.ordered_walk2(torch.empty(8, 16, **meta), torch.empty(8, 128, **meta),
                                torch.empty(1, **i32), comps, depth=8)
    with pytest.raises(ValueError, match="unsupported device"):
        bvh2_walk.stream_walk2(torch.empty(2, 8, 16, **meta), torch.empty(2, 8, 128, **meta),
                               torch.empty(2, **i32), torch.empty(1, 2, **i32),
                               torch.empty(1, **i32), comps, fused=True, depth=8)
    with pytest.raises(ValueError, match="unsupported device"):
        bvh2_walk.skip_walk(torch.empty(8, 8, **meta), torch.empty(8, 4, **i32),
                            torch.empty(8, 16, **meta), comps)
    packed = torch.empty(1 << 15, dtype=torch.int64, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.bitonic_tile(packed, 2, 8192)
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.bitonic_merge(packed, 1 << 15, 13, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.gather_rows(packed, [packed], [packed])
    with pytest.raises(ValueError, match="unsupported device"):
        bitonic.bitonic_co_sort(packed, [packed])


def test_stream_walk2_stack_fits_tree_depth():
    """The streaming binary walk's stack template comes from the host's
    tree depth (``stream_bvh.tree_depth``, ``bvh2_walk.stack_capacity``):
    the plain walk's deepest stack stays within it on small stream
    tables, so a template of that many entries never clamps, and a tree
    deeper than 95 takes the reference's 96 entries, whose writes clamp
    as the reference's do."""
    import torch

    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.stream_bvh import (
        StreamBVH,
        _stream_candidates,
        split_pad_rays,
        tree_depth,
    )
    from pbrt_tpu_torch.testscenes import comb_tree

    def deepest_stack(sb, o, d, fused):
        comps = split_pad_rays(torch.as_tensor(o), torch.as_tensor(d),
                               torch.full((len(o),), 1e9), len(o))
        clist, cnt = _stream_candidates(sb.cl_min, sb.cl_max, comps)
        counters = {}
        bvh2_walk.stream_walk2_plain(sb.nodes, sb.tris, sb.roots, clist, cnt, comps,
                                     fused=fused, counters=counters, depth=sb.depth)
        return counters["stack_max"]

    assert [bvh2_walk.stack_capacity(k) for k in (0, 16, 17, 33, 64, 65, 95, 96, 500)] == [
        16, 16, 32, 64, 64, 96, 96, 96, 96]
    p0, p1, p2 = _soup(1500, seed=1)
    m, x, s, f, c, perm = build_bvh(p0, p1, p2, leaf_size=16)
    sb = StreamBVH(m, x, s, f, c, p0[perm], p1[perm], p2[perm], target_tris=512,
                   leaf_slots=16, wide=False, device="cpu")
    depths = [tree_depth(nf, int(r)) for nf, r in zip(sb.tables["nodes"], sb.tables["roots"])]
    assert len(depths) > 1 and sb.depth == max(depths)
    o, d, _ = _rays(2048, seed=9)
    for fused in (False, True):
        assert 0 < deepest_stack(sb, o, d, fused) <= sb.depth

    comb = StreamBVH(*comb_tree(99), target_tris=4096, leaf_slots=8, wide=False, device="cpu")
    assert comb.depth == 100 and bvh2_walk.stack_capacity(comb.depth) == 96
    rng = np.random.default_rng(10)
    o = np.stack([rng.uniform(-1, 0.9, 256), np.full(256, -0.2), np.full(256, -0.2)], 1)
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (256, 1))
    for fused in (False, True):  # both walks outgrow 96 entries here
        assert 96 < deepest_stack(comb, o.astype(np.float32), d, fused) <= comb.depth
