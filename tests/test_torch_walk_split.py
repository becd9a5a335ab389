"""Invariants of the split whole-tree walks of
``pbrt_tpu_torch/kernels/csrc/bvh2_walk.cu``, held on the plain PyTorch
walks, which the kernels match bit for bit on the card
(tests/test_torch_cuda_walks3.py, chip_smoke.py); the plain walks are held
against the reference in tests/test_torch_walks.py:

* K6 ``skip_walk``: each ray's walk cut into S DFS node ranges, each
  walked from its first node with t = t_max and merged by the minimum of
  (t bits << 32) | triangle id, with (b0, b1) recomputed for the winner,
  is the sequential walk, bit for bit;
* K4 ``ordered_walk2``: each ray's walk cut into 2^L subtree tasks, each
  walked from where ``subtree_root_plain`` puts it and merged by the
  minimum of (t bits << 32) | (j << (32 - SPLIT_LOG2_MAX)) | slot, is the
  sequential walk, bit for bit; its stack stays within the template the
  tree's depth picks;
* ``SkipLinkBVH`` refuses leaf firsts that do not grow in DFS order (the
  merge key's tie rule rests on it).

Both merges are held on a 300-triangle soup and on its twin in which every
triangle appears twice, where exact t ties are everywhere.  The file keeps
to four tests (see tests/test_torch_walks.py) and imports torch and the
port inside the tests.
"""

import numpy as np
import pytest


def _soups():
    """{name: (p0, p1, p2)}: a 300-triangle soup and its duplicated twin."""
    rng = np.random.default_rng(21)
    c = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    soup = tuple(c + rng.uniform(-0.35, 0.35, (300, 3)).astype(np.float32) for _ in range(3))
    return {"soup": soup, "twin": tuple(np.concatenate([p, p]) for p in soup)}


def _comps(n=512, seed=22):
    """Rays from inside the soup's cube, t_max in [0.5, 4), every 97th
    lane dead, as the ray columns the walks take."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.5, 4.0, n).astype(np.float32)
    t_max[::97] = 0.0
    cols = [torch.as_tensor(np.ascontiguousarray(a)) for a in (*o.T, *d.T, t_max)]
    return tuple(cols)


def _build(soup, leaf_size):
    from pbrt_tpu_torch.accel.bvh import build_bvh

    m, x, s, f, c, perm = build_bvh(*soup, leaf_size=leaf_size)
    return (m, x, s, f, c) + tuple(p[perm] for p in soup)


def _t_bits(t):
    import torch

    return t.view(torch.int32).long()  # t > RAY_EPS > 0: the bits order as integers


def test_skip_range_merge_is_the_sequential_walk():
    """S = 1, 2, 5 and M ranges of the skip walk, merged as the kernel
    merges them: t, triangle, b0 and b1 bit-equal to the sequential walk;
    any hit (S = 5): the same hit mask."""
    import torch

    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import SkipLinkBVH

    comps = _comps()
    t_max = comps[6]
    live = t_max > bvh2_walk.RAY_EPS
    o, d = torch.stack(comps[0:3], 1), torch.stack(comps[3:6], 1)
    no_hit = torch.iinfo(torch.int64).max
    for name, soup in _soups().items():
        sk = SkipLinkBVH(*_build(soup, 4), device="cpu")
        tables = (sk.nodes_f, sk.nodes_i, sk.tris)
        m = sk.nodes_f.shape[0]
        t_seq, prim_seq, b0_seq, b1_seq = bvh2_walk.skip_walk_plain(*tables, comps)
        hit_any = bvh2_walk.skip_walk_plain(*tables, comps, any_hit=True)[1] >= 0
        assert (prim_seq >= 0).sum() > 100
        for seg_n in (1, 2, 5, m):
            key = torch.full(t_max.shape, no_hit, dtype=torch.int64)
            occluded = torch.zeros_like(live)
            for seg in range(seg_n):
                a, b = seg * m // seg_n, (seg + 1) * m // seg_n
                t, prim, _, _ = bvh2_walk.skip_walk_plain(*tables, comps, start=a, end=b)
                hit = prim >= 0
                key = torch.where(hit, torch.minimum(key, (_t_bits(t) << 32) | prim.long()), key)
                if seg_n == 5:
                    occluded |= bvh2_walk.skip_walk_plain(*tables, comps, any_hit=True,
                                                          start=a, end=b)[1] >= 0
            hit = key != no_hit
            pid = torch.where(hit, key & 0xFFFFFFFF, 0)
            _, _, b0, b1 = bvh2_walk._tri_test(sk.tris[pid], o, d, t_max)
            t_m = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32),
                              torch.where(live, t_max, bvh2_walk.INERT_T))
            got = (t_m, torch.where(hit, pid, -1).to(torch.int32),
                   torch.where(hit, b0, 0.0), torch.where(hit, b1, 0.0))
            for g, w, what in zip(got, (t_seq, prim_seq, b0_seq, b1_seq),
                                  ("t", "prim", "b0", "b1")):
                assert torch.equal(g, w), f"{name}, S = {seg_n}: {what} differs"
            if seg_n == 5:
                assert torch.equal(occluded, hit_any), f"{name}, S = {seg_n}: any hit differs"


def test_ordered_subtree_merge_is_the_sequential_walk():
    """2^L subtree tasks of the whole-tree ordered walk, L = 0..3, merged
    as the kernel merges them: t and slot bit-equal to the sequential
    walk."""
    import torch

    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2

    comps = _comps(seed=23)
    t_max = comps[6]
    n = t_max.shape[0]
    live = t_max > bvh2_walk.RAY_EPS
    no_hit = torch.iinfo(torch.int64).max
    slot_bits = 32 - bvh2_walk.SPLIT_LOG2_MAX
    for name, soup in _soups().items():
        ob = OrderedBVH2(*_build(soup, 8), device="cpu")
        assert ob.depth > 3
        t_seq, slot_seq = bvh2_walk.ordered_walk2_plain(ob.nodes, ob.tris, ob.root, comps,
                                                        depth=ob.depth)
        assert (slot_seq >= 0).sum() > 100
        for levels in range(4):
            key = torch.full((n,), no_hit, dtype=torch.int64)
            for j in range(1 << levels):
                ref, active = bvh2_walk.subtree_root_plain(ob.nodes, ob.root, comps, j, levels)
                t, slot = bvh2_walk.walk2_plain(
                    ob.nodes, ob.tris, ref, torch.arange(n)[:, None], active.long(), 0, 0,
                    comps[:6], t_max.clone(), False, False, None,
                    bvh2_walk.stack_capacity(ob.depth))
                hit = slot >= 0
                low = (j << slot_bits) | slot.long()
                key = torch.where(hit, torch.minimum(key, (_t_bits(t) << 32) | low), key)
            hit = key != no_hit
            t_m = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32),
                              torch.where(live, t_max, bvh2_walk.INERT_T))
            slot_m = torch.where(hit, key & ((1 << slot_bits) - 1), -1).to(torch.int32)
            assert torch.equal(t_m, t_seq), f"{name}, L = {levels}: t differs"
            assert torch.equal(slot_m, slot_seq), f"{name}, L = {levels}: slots differ"


def test_ordered_walk2_stack_fits_its_depth():
    """The whole-tree ordered walk's deepest stack stays within the tree's
    depth (``stream_bvh.tree_depth``), so the template the kernel takes
    never clamps; a comb deeper than 95 takes the reference's 96 entries,
    whose writes clamp."""
    import torch

    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2
    from pbrt_tpu_torch.testscenes import comb_tree

    comps = _comps(seed=24)
    for soup in _soups().values():
        ob = OrderedBVH2(*_build(soup, 8), device="cpu")
        counters = {}
        bvh2_walk.ordered_walk2_plain(ob.nodes, ob.tris, ob.root, comps, counters=counters,
                                      depth=ob.depth)
        assert 2 < counters["stack_max"] <= ob.depth <= bvh2_walk.stack_capacity(ob.depth)
        assert bvh2_walk.stack_capacity(ob.depth) < 96
    comb = OrderedBVH2(*comb_tree(99), device="cpu")
    assert comb.depth == 100 and bvh2_walk.stack_capacity(comb.depth) == 96
    rng = np.random.default_rng(25)
    n = 256
    o = np.stack([rng.uniform(-1, 0.9, n), np.full(n, -0.2), np.full(n, -0.2)], 1)
    cols = [torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32)) for a in o.T]
    cols += [torch.ones(n), torch.zeros(n), torch.zeros(n), torch.full((n,), 1e9)]
    counters = {}
    _, slot = bvh2_walk.ordered_walk2_plain(comb.nodes, comb.tris, comb.root, tuple(cols),
                                            counters=counters, depth=comb.depth)
    assert (slot >= 0).all() and counters["stack_max"] > 96


def test_skip_link_bvh_refuses_leaves_out_of_dfs_order():
    """The native build's leaf firsts grow in DFS order; swapping two
    leaves' triangles breaks that, and ``SkipLinkBVH`` raises."""
    from pbrt_tpu_torch.ops.pallas_bvh import SkipLinkBVH

    m, x, s, f, c, *tris = _build(_soups()["soup"], 4)
    SkipLinkBVH(m, x, s, f, c, *tris, device="cpu")
    leaves = np.nonzero(c > 0)[0]
    f = f.copy()
    f[leaves[0]], f[leaves[-1]] = f[leaves[-1]], f[leaves[0]]
    with pytest.raises(ValueError, match="DFS order"):
        SkipLinkBVH(m, x, s, f, c, *tris, device="cpu")
