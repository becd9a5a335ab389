"""The redesigned kernels against their plain PyTorch versions on the card:
the bitonic co-sort (tile, merge and gather kernels in one library call),
the streaming binary walks with shared-memory stacks, and the 8-wide walks
with shared-memory stacks and, streaming, segments on sparse sweeps.
Every test is marked ``cuda`` and skips without a card; the file imports
no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_kernels2.py -m cuda -q

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


def _keys(n, seed):
    """Heavy duplicates (64 distinct low parts), bit 31 set on about half."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, n).astype(np.int64) * 977) | (
        rng.integers(0, 2, n).astype(np.int64) << 31)


def _payloads(n, columns, seed):
    """Payload operands of a shadow sort (8 columns) or a carry sort (21)
    in the integrator's dtypes and shapes."""
    rng = np.random.default_rng(seed)
    f3 = lambda: rng.normal(size=(n, 3)).astype(np.float32)  # noqa: E731
    lane = np.arange(n, dtype=np.int64)
    if columns == 8:
        ops = [lane, f3(), f3(), rng.uniform(0, 4, n).astype(np.float32)]
    else:
        ops = [f3(), f3(), rng.uniform(0, 1, n).astype(np.float32), f3(), f3(), f3(),
               rng.integers(0, 256, (n, 2)).astype(np.int32),
               rng.integers(0, 8, n).astype(np.int64), lane,
               rng.integers(0, 4, n).astype(np.int32)]
    assert sum(int(np.prod(x.shape[1:])) for x in ops) == columns
    return ops


@pytest.mark.cuda
def test_bitonic_co_sort_matches_plain():
    """Keys and every payload column bit-equal to the plain network, one
    library call per sort, 32768 .. 262144 lanes (50000 padded), 9 and 22
    columns; at 262144 lanes each launch of the schedule is held against
    its plain step as well."""
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bitonic
    from pbrt_tpu_torch.ops.sortnet import co_sort

    for n, columns in ((32768, 9), (50000, 22), (262144, 22), (262144, 9)):
        keys = torch.as_tensor(_keys(n, n))
        ops = [torch.as_tensor(x) for x in _payloads(n, columns - 1, n + 1)]
        bitonic.reset_launch_counts()
        got = co_sort((keys.cuda(), *(x.cuda() for x in ops)), network="bitonic")
        torch.cuda.synchronize()
        steps = bitonic.schedule(bitonic.padded_size(n))
        assert bitonic.HOST_CALLS["launch_co_sort"] == sum(bitonic.HOST_CALLS.values()) == 1
        assert bitonic.LAUNCHES == {
            "bitonic_tile": sum(s[0] == "tile" for s in steps),
            "bitonic_merge": sum(s[0] == "merge" for s in steps), "gather_rows": 1}
        want = co_sort((keys, *ops), network="bitonic")
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g.cpu(), w), f"n={n}: operand {i} differs"

    n = 262144
    keys = torch.as_tensor(_keys(n, 5))
    packed_k = torch.empty(n, dtype=torch.int64, device="cuda")
    packed_p = torch.empty(n, dtype=torch.int64)
    steps = bitonic.schedule(n)
    for i, (kind, *args) in enumerate(steps):
        if kind == "merge":
            bitonic.bitonic_merge(packed_k, *args)
            bitonic.bitonic_merge_plain(packed_p, *args)
        elif i < len(steps) - 1:
            first = dict(keys=keys.cuda()) if i == 0 else {}
            bitonic.bitonic_tile(packed_k, *args, **first)
            bitonic.bitonic_tile_plain(packed_p, *args, keys=keys if i == 0 else None)
        else:
            out_k = tuple(torch.empty(n, dtype=torch.int64, device="cuda") for _ in range(2))
            out_p = tuple(torch.empty(n, dtype=torch.int64) for _ in range(2))
            bitonic.bitonic_tile(packed_k, *args, out=out_k)
            bitonic.bitonic_tile_plain(packed_p, *args, out=out_p)
            packed_k, packed_p = torch.stack(out_k), torch.stack(out_p)
        torch.cuda.synchronize()
        assert torch.equal(packed_k.cpu(), packed_p), f"launch {i} {kind} {args} differs"
    perm = packed_p[1]
    ops = [torch.as_tensor(x) for x in _payloads(n, 21, 6)]
    dst_k = [torch.empty_like(x, device="cuda") for x in ops]
    dst_p = [torch.empty_like(x) for x in ops]
    bitonic.gather_rows(perm.cuda(), [x.cuda() for x in ops], dst_k)
    bitonic.gather_rows_plain(perm, ops, dst_p)
    for g, w in zip(dst_k, dst_p):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_staged_stream_walk2_matches_plain():
    """K4 and K4b (shared-memory stacks) against the plain walk:
    20,000-triangle soup clusters (a small stack template) and a
    100-level comb, whose walks outgrow 96 entries and clamp, on random
    rays, closest and any hit."""
    torch = _need_card()
    from pbrt_tpu_torch.accel import bvh
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk
    from pbrt_tpu_torch.ops import stream_bvh
    from pbrt_tpu_torch.testscenes import comb_tree

    rng = np.random.default_rng(12)
    c = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    soup = (c, c + rng.uniform(-0.08, 0.08, (20000, 3)).astype(np.float32),
            c + rng.uniform(-0.08, 0.08, (20000, 3)).astype(np.float32))
    m, x, s, f, cc, perm = bvh.build_bvh(*soup, leaf_size=32)
    tables = {"soup": stream_bvh.StreamBVH(m, x, s, f, cc, *(p[perm] for p in soup),
                                           target_tris=4096, wide=False, device="cuda"),
              "comb": stream_bvh.StreamBVH(*comb_tree(99), target_tris=4096, leaf_slots=8,
                                           wide=False, device="cuda")}
    assert bvh2_walk.stack_capacity(tables["soup"].depth) < 96
    assert bvh2_walk.stack_capacity(tables["comb"].depth) == 96
    n = 16384
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    comb_o = np.stack([rng.uniform(-1, 0.9, n), rng.uniform(-0.45, 0.0, n),
                       rng.uniform(-0.45, -0.05, n)], 1).astype(np.float32)
    comb_d = np.tile(np.float32([1, 0, 0]), (n, 1)) + rng.normal(
        scale=1e-3, size=(n, 3)).astype(np.float32)
    comb_d /= np.linalg.norm(comb_d, axis=1, keepdims=True)
    rays = {"soup": (o, d), "comb": (comb_o, comb_d)}
    t_max = rng.uniform(0.05, 4.0, n).astype(np.float32)
    t_max[::97] = 0.0
    for name, sb in tables.items():
        ro, rd = rays[name]
        comps = stream_bvh.split_pad_rays(
            *(torch.as_tensor(a, device="cuda") for a in (ro, rd, t_max * 40)), n)
        clist, cnt = stream_bvh._stream_candidates(sb.cl_min, sb.cl_max, comps)
        args = (sb.nodes, sb.tris, sb.roots, clist, cnt)
        cpu = tuple(a.cpu() for a in args) + (tuple(a.cpu() for a in comps),)
        for fused in (False, True):
            for any_hit in (False, True):
                kern = bvh2_walk.stream_walk2(*args, comps, any_hit=any_hit, fused=fused,
                                              depth=sb.depth)
                torch.cuda.synchronize()
                counters = {}
                plain = bvh2_walk.stream_walk2_plain(*cpu, any_hit=any_hit, fused=fused,
                                                     counters=counters, depth=sb.depth)
                t_k, s_k = (a.cpu().numpy() for a in kern)
                t_p, s_p = (a.numpy() for a in plain)
                problem = bvh8_walk.walk_disagreement(t_p, s_p, t_k, s_k, any_hit,
                                                      sb.tris.cpu().numpy(), ro, rd)
                assert problem is None, f"{name} fused={fused} any_hit={any_hit}: {problem}"
                assert np.array_equal(t_k, t_p) and (s_p >= 0).any()
                if name == "comb":
                    assert counters["stack_max"] > 96  # the clamped writes were taken


@pytest.mark.cuda
def test_redesigned_wrappers_refuse_what_they_cannot_run():
    """A binary comb of one cluster of more than 1024 node rows (which an
    earlier, staging design refused) walks on the card, bit-equal to the
    plain walk; the bitonic wrappers raise on bad shapes."""
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bitonic, bvh2_walk
    from pbrt_tpu_torch.ops import stream_bvh
    from pbrt_tpu_torch.testscenes import comb_tree

    comb = stream_bvh.StreamBVH(*comb_tree(520), target_tris=1 << 20, leaf_slots=8,
                                wide=False, device="cuda")
    assert comb.nodes.shape[0] == 1 and comb.nodes.shape[1] > 1024
    rng = np.random.default_rng(14)
    n = 4096
    o = np.stack([rng.uniform(-1, 0.9, n), rng.uniform(-0.45, 0.0, n),
                  rng.uniform(-0.45, -0.05, n)], 1).astype(np.float32)
    d = np.tile(np.float32([1, 0, 0]), (n, 1))
    comps = stream_bvh.split_pad_rays(torch.as_tensor(o, device="cuda"),
                                      torch.as_tensor(d, device="cuda"),
                                      torch.full((n,), 1e4, device="cuda"), n)
    clist, cnt = stream_bvh._stream_candidates(comb.cl_min, comb.cl_max, comps)
    args = (comb.nodes, comb.tris, comb.roots, clist, cnt, comps)
    cpu = tuple(tuple(c.cpu() for c in a) if isinstance(a, tuple) else a.cpu() for a in args)
    for fused in (False, True):
        for any_hit in (False, True):
            kern = bvh2_walk.stream_walk2(*args, any_hit=any_hit, fused=fused, depth=comb.depth)
            torch.cuda.synchronize()
            plain = bvh2_walk.stream_walk2_plain(*cpu, any_hit=any_hit, fused=fused,
                                                 depth=comb.depth)
            assert (plain[1] >= 0).all()
            for k, p in zip(kern, plain):
                assert torch.equal(k.cpu(), p), f"fused={fused} any_hit={any_hit}"
    packed = torch.zeros(3 * 8192, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic.bitonic_tile(packed, 2, 8192)
    with pytest.raises(ValueError, match="bad stages"):
        bitonic.bitonic_merge(packed[:16384], 16384, 12, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        bitonic.bitonic_co_sort(torch.zeros(32768, dtype=torch.int64, device="cuda"),
                                [torch.zeros(32768, dtype=torch.bool, device="cuda")])


@pytest.mark.cuda
def test_walk8_kernels_match_plain():
    """K2 on a sparse sweep (3000 live rays scattered over the first 8192
    of 262,144: several segments per ray) and a dense one (all but every
    97th live: one segment), K1 on an 8-wide comb whose walk outgrows the
    96-entry stack and clamps; closest hit bit-equal to the plain walk,
    any hit: masks and t equal."""
    torch = _need_card()
    from pbrt_tpu_torch.accel import bvh
    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.ops import stream_bvh
    from pbrt_tpu_torch.ops.bvh8 import WideBVH8
    from pbrt_tpu_torch.testscenes import comb_tree

    def check(kern, plain, any_hit):
        t_k, s_k = (a.cpu() for a in kern)
        t_p, s_p = plain
        assert torch.equal(t_k, t_p) and (s_p >= 0).any()
        assert torch.equal(s_k >= 0, s_p >= 0)
        if not any_hit:
            assert torch.equal(s_k, s_p)

    rng = np.random.default_rng(15)
    c = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    soup = (c, c + rng.uniform(-0.08, 0.08, (20000, 3)).astype(np.float32),
            c + rng.uniform(-0.08, 0.08, (20000, 3)).astype(np.float32))
    m, x, s, f, cc, perm = bvh.build_bvh(*soup, leaf_size=32)
    sb = stream_bvh.StreamBVH(m, x, s, f, cc, *(p[perm] for p in soup), target_tris=4096,
                              device="cuda")
    n = 262144
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_dense = rng.uniform(0.05, 0.5, n).astype(np.float32)
    t_dense[::97] = 0.0
    t_sparse = np.zeros(n, np.float32)
    live = rng.choice(8192, 3000, replace=False)
    t_sparse[live] = rng.uniform(0.5, 4.0, 3000)
    for label, t_max in (("sparse", t_sparse), ("dense", t_dense)):
        comps = stream_bvh.split_pad_rays(
            *(torch.as_tensor(a, device="cuda") for a in (o, d, t_max)), n)
        clist, cnt = stream_bvh._stream_candidates(sb.cl_min, sb.cl_max, comps)
        args = (sb.nodes, sb.tris, sb.roots, clist, cnt, comps)
        cpu = tuple(tuple(a.cpu() for a in x) if isinstance(x, tuple) else x.cpu()
                    for x in args)
        for any_hit in (False, True):
            kern = bvh8_walk.stream_walk8(*args, any_hit=any_hit, depth=sb.depth)
            torch.cuda.synchronize()
            stats = bvh8_walk.segment_stats()
            assert (stats["segments"] > 1) == (label == "sparse"), (label, stats)
            check(kern, bvh8_walk.stream_walk8_plain(*cpu, any_hit=any_hit), any_hit)

    comb = WideBVH8(*comb_tree(99), leaf_slots=8, device="cuda")
    assert bvh8_walk.stack_capacity(comb.depth) == 96
    n = 4096
    o = np.stack([rng.uniform(-1, 0.9, n), rng.uniform(-0.45, 0.0, n),
                  rng.uniform(-0.45, -0.05, n)], 1).astype(np.float32)
    d = np.tile(np.float32([1, 0, 0]), (n, 1))
    comps = stream_bvh.split_pad_rays(torch.as_tensor(o, device="cuda"),
                                      torch.as_tensor(d, device="cuda"),
                                      torch.full((n,), 1e4, device="cuda"), n)
    cpu = tuple(a.cpu() for a in comps)
    for any_hit in (False, True):
        kern = bvh8_walk.wide_walk8(comb.nodes, comb.tris, comb.root, comps, any_hit=any_hit,
                                    depth=comb.depth)
        torch.cuda.synchronize()
        counters = {}
        plain = bvh8_walk.wide_walk8_plain(comb.nodes.cpu(), comb.tris.cpu(), comb.root.cpu(),
                                           cpu, any_hit=any_hit, counters=counters)
        check(kern, plain, any_hit)
        if not any_hit:
            assert counters["stack_max"] > 96  # the clamped writes were taken
