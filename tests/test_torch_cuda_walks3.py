"""The split whole-tree walks against their plain PyTorch versions on the
card: K6 ``skip_walk`` (live rays listed, node-range segments) and the
whole-tree K4 ``ordered_walk2`` (shared-memory stack, subtree segments).
Every test is marked ``cuda`` and skips without a card; the file imports
no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_walks3.py -m cuda -q

torch and the port are imported only once a test knows it has a card.
The file keeps to four tests or fewer (see tests/test_torch_cuda.py).
"""

import numpy as np
import pytest


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


def _soup(n, seed, twin=False):
    """n random triangles in [-1, 1]^3 (``twin``: each of them twice, so
    every hit is an exact t tie between two triangle ids)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    soup = (c, c + rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32),
            c + rng.uniform(-0.08, 0.08, (n, 3)).astype(np.float32))
    return tuple(np.concatenate([p, p]) for p in soup) if twin else soup


def _tables(soup, leaf_size):
    from pbrt_tpu_torch.accel.bvh import build_bvh

    m, x, s, f, c, perm = build_bvh(*soup, leaf_size=leaf_size)
    return (m, x, s, f, c) + tuple(p[perm] for p in soup)


def _sweep(n, live, seed, t_lo=0.5, t_hi=4.0):
    """n rays from [-2, 2]^3 (ray columns on the card): t_max uniform in
    [t_lo, t_hi) on the lanes ``live`` (an index array, or None: all but
    every 97th), 0 elsewhere."""
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.zeros(n, np.float32)
    if live is None:
        t_max[:] = rng.uniform(t_lo, t_hi, n)
        t_max[::97] = 0.0
    else:
        t_max[live] = rng.uniform(t_lo, t_hi, len(live))
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                 for a in (*o.T, *d.T, t_max))


@pytest.mark.cuda
def test_skip_walk_matches_plain():
    """K6 on a dense sweep (262,144 rays: one segment), on 1000 live lanes
    packed at the front of 262,144 and on 1000 scattered among them
    (several segments), on a soup and on its twin: closest hit t, triangle,
    b0 and b1 bit-equal to the plain walk; any hit: masks equal, t equal
    where no hit."""
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import SkipLinkBVH

    n = 262144
    rng = np.random.default_rng(31)
    sweeps = {"dense": (_sweep(n, None, 32, 0.05, 0.5), 1),
              "packed": (_sweep(n, np.arange(1000), 33), 2),
              "scattered": (_sweep(n, rng.choice(n, 1000, replace=False), 34), 2)}
    for soup_name, twin in (("soup", False), ("twin", True)):
        sk = SkipLinkBVH(*_tables(_soup(20000, 35, twin), 4), device="cuda")
        tables = (sk.nodes_f, sk.nodes_i, sk.tris)
        cpu = tuple(x.cpu() for x in tables)
        for label, (comps, min_segments) in sweeps.items():
            if twin and label != "scattered":
                continue
            for any_hit in (False, True):
                kern = bvh2_walk.skip_walk(*tables, comps, any_hit=any_hit)
                torch.cuda.synchronize()
                segments = bvh2_walk.segment_stats()["segments"]
                assert (segments == 1) == (min_segments == 1), (label, segments)
                plain = bvh2_walk.skip_walk_plain(*cpu, tuple(c.cpu() for c in comps),
                                                  any_hit=any_hit)
                kern = [x.cpu() for x in kern]
                what = f"{soup_name} {label} any_hit={any_hit} (S = {segments})"
                assert (plain[1] >= 0).sum() > 20, what
                if any_hit:
                    hit = plain[1] >= 0
                    assert torch.equal(kern[1] >= 0, hit), what
                    assert torch.equal(kern[0][~hit], plain[0][~hit]), what
                else:
                    for k, p in zip(kern, plain):
                        assert torch.equal(k, p), what


@pytest.mark.cuda
def test_ordered_walk2_matches_plain():
    """Whole-tree K4 on a 16,384-ray sweep with 2000 live rays (several
    subtree tasks per ray), on 262,144 dense rays (one) and on a 100-level
    comb, which it walks unsplit with the 96-entry stack's clamped writes;
    a soup and its twin: t and slots bit-equal to the plain walk, closest
    and any hit."""
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2
    from pbrt_tpu_torch.testscenes import comb_tree

    rng = np.random.default_rng(36)
    n = 4096
    o = np.stack([rng.uniform(-1, 0.9, n), rng.uniform(-0.45, 0.0, n),
                  rng.uniform(-0.45, -0.05, n)], 1).astype(np.float32)
    comb_rays = tuple(torch.as_tensor(np.ascontiguousarray(a), device="cuda") for a in (
        *o.T, np.ones(n, np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32),
        np.full(n, 1e4, np.float32)))
    sparse = _sweep(16384, rng.choice(16384, 2000, replace=False), 38)
    cases = [("soup", OrderedBVH2(*_tables(_soup(3000, 37), 8), device="cuda"),
              {"sparse": sparse, "dense": _sweep(262144, None, 39, 0.05, 0.5)}),
             ("twin", OrderedBVH2(*_tables(_soup(3000, 37, True), 8), device="cuda"),
              {"sparse": sparse}),
             ("comb", OrderedBVH2(*comb_tree(99), device="cuda"), {"comb": comb_rays})]
    for name, ob, sweeps in cases:
        tables = (ob.nodes, ob.tris, ob.root)
        cpu = tuple(x.cpu() for x in tables)
        for label, comps in sweeps.items():
            for any_hit in (False, True):
                kern = bvh2_walk.ordered_walk2(*tables, comps, any_hit=any_hit, depth=ob.depth)
                torch.cuda.synchronize()
                segments = bvh2_walk.segment_stats()["segments"]
                assert (segments > 1) == (label == "sparse"), (name, label, segments)
                counters = {}
                plain = bvh2_walk.ordered_walk2_plain(*cpu, tuple(c.cpu() for c in comps),
                                                      any_hit=any_hit, counters=counters,
                                                      depth=ob.depth)
                what = f"{name} {label} any_hit={any_hit} (S = {segments})"
                assert (plain[1] >= 0).sum() > 20, what
                t_k, s_k = (x.cpu() for x in kern)
                assert torch.equal(t_k, plain[0]), what
                if any_hit:
                    assert torch.equal(s_k >= 0, plain[1] >= 0), what
                else:
                    assert torch.equal(s_k, plain[1]), what
                if name == "comb":
                    assert ob.depth > 96 and counters["stack_max"] > 96  # clamped


@pytest.mark.cuda
def test_whole_tree_wrappers_refuse_what_they_cannot_run():
    """``ordered_walk2`` needs the tree's depth and a slot count that fits
    the subtree merge key's slot field; ``skip_walk`` needs 16-byte
    aligned tables (it reads 16-byte vectors)."""
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2, SkipLinkBVH

    comps = _sweep(1024, None, 40)
    ob = OrderedBVH2(*_tables(_soup(500, 41), 8), device="cuda")
    with pytest.raises(TypeError, match="depth"):
        bvh2_walk.ordered_walk2(ob.nodes, ob.tris, ob.root, comps)
    rows = (1 << (32 - bvh2_walk.SPLIT_LOG2_MAX)) // bvh2_walk.LEAF_SLOTS + 1
    too_many = torch.zeros(rows, 128, device="cuda")
    with pytest.raises(ValueError, match="slot field"):
        bvh2_walk.ordered_walk2(ob.nodes, too_many, ob.root, comps, depth=ob.depth)
    del too_many
    sk = SkipLinkBVH(*_tables(_soup(500, 41), 4), device="cuda")
    flat = torch.zeros(sk.tris.numel() + 1, device="cuda")
    unaligned = flat[1:].view(sk.tris.shape)
    unaligned.copy_(sk.tris)
    with pytest.raises(ValueError, match="16-byte"):
        bvh2_walk.skip_walk(sk.nodes_f, sk.nodes_i, unaligned, comps)
