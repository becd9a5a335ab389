"""Invariants of the Hopper design of the 8-wide walk (K2 ``stream_walk8``,
K1 ``wide_walk8``, ``pbrt_tpu_torch/kernels/csrc/bvh8_walk.cu``), held on
the plain PyTorch walk, which the kernels match bit for bit on the card
(tests/test_torch_cuda*.py, chip_smoke.py):

* the stack: an 8-wide walk pops one entry and pushes at most 8 per
  step, so a tree of ``depth`` interior levels needs at most 7 depth + 1
  entries; the kernels take the smallest template that holds that, and
  96 entries with clamped writes beyond;
* the segment merge: the streaming kernel cuts each ray's candidate list
  into S segments on sparse sweeps, walks each from the ray's t_max and
  merges them by a 64-bit key (t bits, candidate position, slot in the
  tree); the merged result must be the sequential walk's, bit for bit.

The file keeps to four tests or fewer (see tests/test_torch_walks.py) and
imports torch and the port inside the tests.
"""

import numpy as np


def _soup(n, seed=0, scale=0.08):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def _stream_tables(n, target, seed):
    from pbrt_tpu_torch.accel.bvh import build_bvh
    from pbrt_tpu_torch.ops.stream_bvh import StreamBVH

    p = _soup(n, seed)
    m, x, s, f, c, perm = build_bvh(*p, leaf_size=16)
    return StreamBVH(m, x, s, f, c, *(q[perm] for q in p), target_tris=target,
                     leaf_slots=16, device="cpu")


def _rays(n, seed):
    """Random rays from inside the soup's cube: t_max in [0.05, 4), every
    97th lane dead, as chip_smoke.py's random sweeps."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.05, 4.0, n).astype(np.float32)
    t_max[::97] = 0.0
    return o, d, t_max


def test_walk8_stack_fits_its_depth_bound():
    """The plain walk's deepest stack stays within 7 depth + 1 on small
    stream tables (so the template the kernel takes never clamps) and
    outgrows 96 entries on an 8-wide comb, where the clamped writes of
    the reference's 96-entry stack are taken."""
    import torch

    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.ops.bvh8 import WideBVH8
    from pbrt_tpu_torch.ops.stream_bvh import _stream_candidates, split_pad_rays, tree_depth
    from pbrt_tpu_torch.testscenes import comb_tree

    assert [bvh8_walk.stack_capacity(k) for k in (None, 0, 1, 2, 3, 4, 9, 13, 14, 99)] == [
        96, 8, 8, 16, 32, 32, 64, 96, 96, 96]
    sb = _stream_tables(5000, 1024, seed=1)
    depths = [tree_depth(nf, int(r)) for nf, r in zip(sb.tables["nodes"], sb.tables["roots"])]
    assert len(depths) > 1 and sb.depth == max(depths)
    o, d, t_max = _rays(2048, seed=2)
    comps = split_pad_rays(*(torch.as_tensor(a) for a in (o, d, t_max * 100)), 2048)
    clist, cnt = _stream_candidates(sb.cl_min, sb.cl_max, comps)
    counters = {}
    bvh8_walk.stream_walk8_plain(sb.nodes, sb.tris, sb.roots, clist, cnt, comps,
                                 counters=counters, depth=sb.depth)
    assert 8 < counters["stack_max"] <= 7 * sb.depth + 1 <= bvh8_walk.stack_capacity(sb.depth)

    comb = WideBVH8(*comb_tree(99), leaf_slots=8, device="cpu")
    assert 7 * comb.depth + 1 > 96 and bvh8_walk.stack_capacity(comb.depth) == 96
    rng = np.random.default_rng(10)
    o = np.stack([rng.uniform(-1, 0.9, 256), np.full(256, -0.2), np.full(256, -0.2)], 1)
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (256, 1))
    comps = split_pad_rays(torch.as_tensor(o.astype(np.float32)), torch.as_tensor(d),
                           torch.full((256,), 1e9), 256)
    counters = {}
    _, slot = bvh8_walk.wide_walk8_plain(comb.nodes, comb.tris, comb.root, comps,
                                         counters=counters, depth=comb.depth)
    assert (slot[:256] >= 0).all()
    assert 96 < counters["stack_max"] <= 7 * comb.depth + 1


def test_segment_merge_is_the_sequential_walk():
    """A plain emulation of the streaming kernel's segments: each lane's
    candidate list cut as the kernel cuts it (segment s of S holds
    positions s nc / S .. (s + 1) nc / S - 1), each segment walked by
    ``walk8_plain`` from t_max, the results merged by the minimum of
    (t bits << 32) | (k * slots + slot).  At S = 1, 2 and the list width,
    t and slots are bit-equal to the sequential closest-hit walk."""
    import torch

    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.ops.stream_bvh import _stream_candidates, split_pad_rays

    sb = _stream_tables(3000, 512, seed=3)
    n = 2048
    o, d, t_max = _rays(n, seed=4)
    comps = split_pad_rays(*(torch.as_tensor(a) for a in (o, d, t_max)), n)
    clist, cnt = _stream_candidates(sb.cl_min, sb.cl_max, comps)
    c, n_cand = clist.shape
    assert n_cand > 4 and int(cnt.min()) > 2
    t_seq, slot_seq = bvh8_walk.stream_walk8_plain(sb.nodes, sb.tris, sb.roots, clist, cnt,
                                                   comps)
    assert (slot_seq >= 0).sum() > 200

    slots = sb.tris.shape[1] * bvh8_walk.LEAF_SLOTS
    block = torch.arange(n) // bvh8_walk.BLOCK
    nc = torch.where(comps[6] > bvh8_walk.RAY_EPS, cnt.long()[block], 0)
    lists = clist.long()[block]  # [n, n_cand]
    position = torch.full((c, sb.nodes.shape[0]), -1, dtype=torch.int64)  # cid -> k per block
    for b in range(c):
        position[b, clist[b, :cnt[b]].long()] = torch.arange(int(cnt[b]))
    position = position[block]
    no_hit = torch.iinfo(torch.int64).max
    for seg_n in (1, 2, n_cand):
        key = torch.full((n,), no_hit, dtype=torch.int64)
        for seg in range(seg_n):
            k0, k1 = seg * nc // seg_n, (seg + 1) * nc // seg_n
            take = (k0[:, None] + torch.arange(n_cand)).clamp(max=n_cand - 1)
            t, slot = bvh8_walk.walk8_plain(
                sb.nodes.reshape(-1, 64), sb.tris.reshape(-1, 128), sb.roots.long(),
                lists.gather(1, take), k1 - k0, sb.nodes.shape[1], sb.tris.shape[1],
                comps[:6], comps[6].clone(), False)
            hit = slot >= 0
            cid, local = slot.long() // slots, slot.long() % slots
            k = position.gather(1, cid.clamp(min=0)[:, None])[:, 0]
            bits = t.view(torch.int32).long()  # t > 0: its bits order as integers
            key = torch.where(hit, torch.minimum(key, (bits << 32) | (k * slots + local)), key)
        hit = key != no_hit
        low = key & 0xFFFFFFFF
        t_m = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32), comps[6])
        slot_m = torch.where(hit, lists.gather(1, (low // slots).clamp(max=n_cand - 1)[:, None])
                             [:, 0] * slots + low % slots, -1)
        assert torch.equal(t_m, t_seq), f"S = {seg_n}: t differs"
        assert torch.equal(slot_m.to(torch.int32), slot_seq), f"S = {seg_n}: slots differ"
