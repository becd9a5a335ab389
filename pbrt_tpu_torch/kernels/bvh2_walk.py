"""The binary BVH walks: CUDA kernels and their plain PyTorch versions.

Three wrappers over the hand-written kernels in ``csrc/bvh2_walk.cu``:

* :func:`ordered_walk2` replaces ``pbrt_tpu/ops/pallas_bvh.py::_ordered_kernel``
  (K4: the ordered near-first stack walk over one whole binary tree), with
  a per-thread stack of ``stack_capacity(depth)`` entries in shared
  memory, ``depth`` the tree's (``ops/stream_bvh.tree_depth``); with
  fewer live rays than resident warps each ray's walk is cut into 2^L
  subtree tasks (:func:`subtree_root_plain` says where task j starts);
* :func:`stream_walk2` replaces ``pbrt_tpu/ops/stream_bvh.py::_stream_kernel``
  with the binary walk ``_walk_tree`` (K4) or, with ``fused=True``,
  ``_walk_tree_fused`` (K4b: leaf children tested at their parent) over
  clusters of any size, with the same stack, ``depth`` being the deepest
  cluster tree;
* :func:`skip_walk` replaces ``pbrt_tpu/ops/pallas_bvh.py::_traverse_kernel``
  (K6: the skip-link walk over 4-triangle leaves, returning barycentrics);
  with fewer live rays than resident warps each ray's walk is cut into S
  DFS node ranges (:func:`skip_walk_plain`'s ``start`` and ``end``).

The two whole-tree kernels walk only live rays (a prepass lists them),
fewer of them per warp on a sparse sweep, and choose their segments per
ray on the device; the tasks of a ray merge exactly into the sequential
walk's result (see the note at the top of the CUDA source);
:func:`segment_stats` reads what the last launch chose.

A wrapper runs its plain version (:func:`walk2_plain`,
:func:`skip_walk_plain`) only because its tensors lie on the CPU; on CUDA
tensors it launches its kernel or raises.  Kernel and plain version walk
each ray in the same order with the same float operations, so their
results are bit-equal (any hit on a split ray: the same hit mask); both
take each ray's own direction octant where the TPU took one lane's per
packet, so they may differ from the reference only on exact t ties
(``bvh8_walk.walk_disagreement``).  ``LAUNCHES`` counts wrapper calls
that launched (the fused streaming walk apart from the plain one; a
whole-tree call is one prepass and one walk kernel).
"""

from __future__ import annotations

import ctypes

import torch

from pbrt_tpu_torch.kernels import build
from pbrt_tpu_torch.kernels.bvh8_walk import (
    BLOCK,
    INERT_T,
    LEAF_COUNT_BITS,
    LEAF_SLOTS,
    RAY_EPS,
    STACK_DEPTH,
    check_rays,
    count_leaves,
    init_counters,
    safe_inv,
)

NODE2_COLS = 16
STACK_CAPACITIES = (16, 32, 64, STACK_DEPTH)  # the stack walks' stack templates
# the most subtree levels a whole-tree ordered walk splits a ray into: the
# merge key's low word holds (task << (32 - SPLIT_LOG2_MAX)) | slot
SPLIT_LOG2_MAX = 8
NVCC_DEFINES = {"SPLIT_LOG2_MAX": SPLIT_LOG2_MAX}

LAUNCHES = {"ordered_walk2": 0, "stream_walk2": 0, "stream_walk2_fused": 0,
            "skip_walk": 0}

_lib = None
_last_scratch = None  # (scratch, rays) of the last whole-tree launch (segment_stats)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is None:
        lib = build.load("bvh2_walk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.launch_ordered_walk2.argtypes = [p] * 13 + [i] * 4 + [p]
        lib.launch_ordered_walk2.restype = i
        lib.launch_stream_walk2.argtypes = [p] * 14 + [i] * 7 + [p]
        lib.launch_stream_walk2.restype = i
        lib.launch_skip_walk.argtypes = [p] * 15 + [i] * 4 + [p]
        lib.launch_skip_walk.restype = i
        _lib = lib
    return _lib


def segment_stats():
    """What the last :func:`ordered_walk2` or :func:`skip_walk` launch
    found on the card: live rays, and the rays per task and segments per
    ray it chose (synchronises)."""
    scratch, n = _last_scratch
    header = scratch[n:].view(torch.int32)[2 * n:2 * n + 4].tolist()
    return {"live_rays": header[0], "segments": header[2], "rays_per_task": header[3]}


def _whole_scratch(n, dev):
    """The scratch of a whole-tree launch of n rays (int64 words): n merge
    keys, then n listed lanes, n finished-task counts and a 4-int header
    (live rays, next task, segments per ray, rays per task)."""
    return torch.empty(2 * n + 2, dtype=torch.int64, device=dev)


def stack_capacity(depth: int) -> int:
    """Stack entries for trees of ``depth`` levels below the root: the
    smallest template of at least ``depth`` (a binary walk holds at most
    one entry per level above its node, so it never clamps), else the
    reference's 96 with clamped writes."""
    return next((c for c in STACK_CAPACITIES if depth <= c), STACK_DEPTH)


def _cuda_device(name, x):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def ordered_walk2(nodes, tris, root, comps, any_hit=False, *, depth):
    """Whole-tree ordered walk (K4): nodes [ni, 16] f32, tris [rows, 128]
    f32, root [1] i32, comps = 7 [N] f32 ray columns (ox oy oz dx dy dz
    t_max), ``depth`` the tree's (picks the stack).  Returns (t [N] f32,
    slot [N] i32, -1 = miss); lanes with t_max <= RAY_EPS come back inert
    (t = -1e30), as do any-hit lanes that found a hit."""
    global _last_scratch
    if nodes.device.type == "cpu":
        return ordered_walk2_plain(nodes, tris, root, comps, any_hit, depth=depth)
    dev = _cuda_device("ordered_walk2", nodes)
    build.check_tensor("nodes", nodes, torch.float32, dev, 2)
    build.check_tensor("tris", tris, torch.float32, dev, 2)
    build.check_tensor("root", root, torch.int32, dev, 1)
    n = check_rays(comps, dev)
    if nodes.shape[1] != NODE2_COLS or tris.shape[1] != 128:
        raise ValueError("ordered_walk2: expected [ni,16] nodes and [rows,128] tris")
    if tris.shape[0] * LEAF_SLOTS > 1 << (32 - SPLIT_LOG2_MAX):
        raise ValueError(f"ordered_walk2: {tris.shape[0] * LEAF_SLOTS} slots overflow the "
                         f"{32 - SPLIT_LOG2_MAX}-bit slot field of the subtree merge key")
    build.check_aligned("tris", tris)
    lib = load_library()
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = _whole_scratch(n, dev)
    build.launch_checked(
        lib, lib.launch_ordered_walk2,
        nodes.data_ptr(), tris.data_ptr(), root.data_ptr(),
        *[c.data_ptr() for c in comps], t_out.data_ptr(), prim_out.data_ptr(),
        scratch.data_ptr(), n, int(depth), int(any_hit), stack_capacity(int(depth)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["ordered_walk2"] += 1
    _last_scratch = (scratch, n)
    return t_out, prim_out


def stream_walk2(nodes, tris, roots, clist, cnt, comps, any_hit=False, fused=False, *,
                 depth):
    """Phase B of the binary streaming traversal (K4, K4b with ``fused``).

    nodes [C, NP, 16] f32, tris [C, LP, 128] f32, roots [C] i32, clist
    [B, K] i32 and cnt [B] i32 from phase A, comps = 7 [N] f32 ray
    columns with N = B * 1024, ``depth`` the deepest cluster tree (picks
    the stack).  Returns (t [N] f32 starting at each ray's t_max, slot [N]
    i32 = ``cid * LP * 8 + slot``, -1 = miss)."""
    if nodes.device.type == "cpu":
        return stream_walk2_plain(nodes, tris, roots, clist, cnt, comps, any_hit, fused,
                                  depth=depth)
    dev = _cuda_device("stream_walk2", nodes)
    build.check_tensor("nodes", nodes, torch.float32, dev, 3)
    build.check_tensor("tris", tris, torch.float32, dev, 3)
    build.check_tensor("roots", roots, torch.int32, dev, 1)
    build.check_tensor("clist", clist, torch.int32, dev, 2)
    build.check_tensor("cnt", cnt, torch.int32, dev, 1)
    n = check_rays(comps, dev)
    if nodes.shape[2] != NODE2_COLS or tris.shape[2] != 128:
        raise ValueError("stream_walk2: expected [C,NP,16] nodes and [C,LP,128] tris")
    if n != clist.shape[0] * BLOCK or cnt.shape[0] != clist.shape[0]:
        raise ValueError("stream_walk2: rays must fill whole 1024-ray blocks")
    build.check_aligned("tris", tris)
    lib = load_library()
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    build.launch_checked(
        lib, lib.launch_stream_walk2,
        nodes.data_ptr(), tris.data_ptr(), roots.data_ptr(), clist.data_ptr(),
        cnt.data_ptr(), *[c.data_ptr() for c in comps],
        t_out.data_ptr(), prim_out.data_ptr(),
        n, clist.shape[1], nodes.shape[1], tris.shape[1], int(any_hit), int(fused),
        stack_capacity(int(depth)), torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["stream_walk2_fused" if fused else "stream_walk2"] += 1
    return t_out, prim_out


def skip_walk(nodes_f, nodes_i, tris, comps, any_hit=False):
    """Skip-link walk (K6): nodes_f [M, 8] f32 (box), nodes_i [M, 4] i32
    (skip, first, count; leaf firsts growing in DFS order), tris [T, 16]
    f32, comps = 7 [N] f32 ray columns.  Returns (t, prim, b0, b1) [N];
    prim is the DFS triangle index, -1 = miss.  Lanes with t_max <=
    RAY_EPS come back inert (t = -1e30); the reference's per-lane walk
    (``BVHIntersector._traverse_xla``) keeps their t_max instead, and
    consumers read t only where prim >= 0, so the two agree."""
    global _last_scratch
    if nodes_f.device.type == "cpu":
        return skip_walk_plain(nodes_f, nodes_i, tris, comps, any_hit)
    dev = _cuda_device("skip_walk", nodes_f)
    build.check_tensor("nodes_f", nodes_f, torch.float32, dev, 2)
    build.check_tensor("nodes_i", nodes_i, torch.int32, dev, 2)
    build.check_tensor("tris", tris, torch.float32, dev, 2)
    n = check_rays(comps, dev)
    m = nodes_f.shape[0]
    if (nodes_f.shape[1] != 8 or nodes_i.shape != (m, 4) or tris.shape[1] != 16
            or tris.shape[0] == 0):
        raise ValueError("skip_walk: expected [M,8] nodes_f, [M,4] nodes_i, [T,16] tris")
    for name, x in (("nodes_f", nodes_f), ("nodes_i", nodes_i), ("tris", tris)):
        build.check_aligned(name, x)
    lib = load_library()
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    b0_out = torch.empty(n, dtype=torch.float32, device=dev)
    b1_out = torch.empty(n, dtype=torch.float32, device=dev)
    scratch = _whole_scratch(n, dev)
    build.launch_checked(
        lib, lib.launch_skip_walk,
        nodes_f.data_ptr(), nodes_i.data_ptr(), tris.data_ptr(),
        *[c.data_ptr() for c in comps], t_out.data_ptr(), prim_out.data_ptr(),
        b0_out.data_ptr(), b1_out.data_ptr(), scratch.data_ptr(), n, m, tris.shape[0],
        int(any_hit), torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["skip_walk"] += 1
    _last_scratch = (scratch, n)
    return t_out, prim_out, b0_out, b1_out


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def ordered_walk2_plain(nodes, tris, root, comps, any_hit=False, counters=None, *, depth):
    """Plain version of :func:`ordered_walk2` (same arguments, any device;
    its stack has the kernel's ``stack_capacity(depth)`` entries;
    ``counters``: see ``bvh8_walk.init_counters``)."""
    n = comps[0].shape[0]
    t_max = comps[6]
    live = t_max > RAY_EPS
    best_t = torch.where(live, t_max, INERT_T)
    cand = torch.zeros((n, 1), dtype=torch.int64, device=t_max.device)
    return walk2_plain(nodes, tris, root.long(), cand, live.long(), 0, 0, comps[:6],
                       best_t, any_hit, False, counters, stack_capacity(int(depth)))


def subtree_root_plain(nodes, root, comps, j, levels):
    """Where task ``j`` of the ``2**levels`` subtree tasks of each ray
    starts its walk in :func:`ordered_walk2`'s kernel: from the root,
    ``levels`` steps down in the ray's own near-first order, to the near
    child on a 0 bit of j and the far child on a 1 bit (most significant
    first), each child's box tested at t_max.  A task whose box test on the
    way fails, or that meets a leaf above the last level while a lower bit
    of j is set (the leaf belongs to the task whose remaining bits are 0),
    walks nothing.  Returns (ref [N] int64 to walk from, active [N] bool);
    live lanes only (t_max > RAY_EPS)."""
    ox, oy, oz, dx, dy, dz, t_max = comps
    o = torch.stack([ox, oy, oz], dim=1)
    inv = torch.stack([safe_inv(dx), safe_inv(dy), safe_inv(dz)], dim=1)
    octant = (dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long()
    ref = torch.full_like(octant, int(root[0]))
    active = t_max > RAY_EPS
    going = active.clone()  # still descending
    for lvl in range(levels):
        leaf = going & (ref < 0)
        active &= ~leaf | ((j & ((1 << (levels - lvl)) - 1)) == 0)
        going &= ~leaf
        nf = nodes[torch.where(going, ref, 0)]
        left_first = ((nf[:, 14].long() >> octant) & 1) == 1
        take_left = left_first == (((j >> (levels - 1 - lvl)) & 1) == 0)
        box = torch.where(take_left[:, None], nf[:, 0:6], nf[:, 6:12])
        hit = _slab(box, o, inv, t_max)
        active &= ~going | hit
        going &= hit
        ref = torch.where(going, torch.where(take_left, nf[:, 12], nf[:, 13]).long(), ref)
    return ref, active


def stream_walk2_plain(nodes, tris, roots, clist, cnt, comps, any_hit=False,
                       fused=False, counters=None, *, depth):
    """Plain version of :func:`stream_walk2` (same arguments, any device;
    its stack has the kernel's ``stack_capacity(depth)`` entries)."""
    n = comps[0].shape[0]
    t_max = comps[6]
    block = torch.arange(n, device=t_max.device) // BLOCK
    ncand = torch.where(t_max > RAY_EPS, cnt.long()[block], 0)
    return walk2_plain(
        nodes.reshape(-1, NODE2_COLS), tris.reshape(-1, 128), roots.long(),
        clist.long()[block], ncand, nodes.shape[1], tris.shape[1], comps[:6],
        t_max.clone(), any_hit, fused, counters, stack_capacity(int(depth)),
    )


def _slab(box, o, inv, best_t):
    """[L, 6] boxes against [L, 3] rays -> bool [L] (the kernel's slab)."""
    t_lo = (box[:, 0:3] - o) * inv
    t_hi = (box[:, 3:6] - o) * inv
    mn, mx = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
    t_near = torch.maximum(torch.maximum(mn[:, 0], mn[:, 1]), mn[:, 2])
    t_far = torch.minimum(torch.minimum(mx[:, 0], mx[:, 1]), mx[:, 2])
    return (t_near <= t_far) & (t_far > RAY_EPS) & (t_near < best_t)


def _tri_test(tri, o, d, best_t):
    """Moller-Trumbore of [L, 9+] triangles against [L, 3] rays, in the
    kernel's operation order -> (ok, t, b0, b1)."""
    p0 = tri[:, 0:3]
    e1 = tri[:, 3:6] - p0
    e2 = tri[:, 6:9] - p0
    pvx = d[:, 1] * e2[:, 2] - d[:, 2] * e2[:, 1]
    pvy = d[:, 2] * e2[:, 0] - d[:, 0] * e2[:, 2]
    pvz = d[:, 0] * e2[:, 1] - d[:, 1] * e2[:, 0]
    det = e1[:, 0] * pvx + e1[:, 1] * pvy + e1[:, 2] * pvz
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tv = o - p0
    b0 = (tv[:, 0] * pvx + tv[:, 1] * pvy + tv[:, 2] * pvz) * inv_det
    qvx = tv[:, 1] * e1[:, 2] - tv[:, 2] * e1[:, 1]
    qvy = tv[:, 2] * e1[:, 0] - tv[:, 0] * e1[:, 2]
    qvz = tv[:, 0] * e1[:, 1] - tv[:, 1] * e1[:, 0]
    b1 = (d[:, 0] * qvx + d[:, 1] * qvy + d[:, 2] * qvz) * inv_det
    tt = (e2[:, 0] * qvx + e2[:, 1] * qvy + e2[:, 2] * qvz) * inv_det
    ok = (det_ok & (b0 >= 0.0) & (b1 >= 0.0) & (b0 + b1 <= 1.0)
          & (tt > RAY_EPS) & (tt < best_t))
    return ok, tt, b0, b1


def _leaf_tests(tris, leaves_pad, lanes, ref, cid, o, d, best_t, best_prim, slots,
                counters):
    """Test the leaves ``ref`` (< 0) of trees ``cid`` for ``lanes``, slot
    by slot as the kernel does; folds hits into best_t / best_prim."""
    code = -ref - 1
    first = (code >> LEAF_COUNT_BITS) << 3
    count = code & ((1 << LEAF_COUNT_BITS) - 1)
    row0 = cid * leaves_pad + (first >> 3)
    count_leaves(counters, row0, count)
    lo, ld = o[lanes], d[lanes]
    bt, bp = best_t[lanes], best_prim[lanes]
    base = cid * slots + first
    for s in range(int(count.max())):
        row = (row0 + s // LEAF_SLOTS).clamp(max=tris.shape[0] - 1)
        col = 16 * (s % LEAF_SLOTS)
        ok, tt, _, _ = _tri_test(tris[row, col:col + 9], lo, ld, bt)
        ok = ok & (s < count)
        bp = torch.where(ok, base + s, bp)
        bt = torch.where(ok, tt, bt)
    best_t[lanes] = bt
    best_prim[lanes] = bp


def walk2_plain(nodes, tris, roots, cand, ncand, nodes_pad, leaves_pad, rays,
                best_t, any_hit, fused, counters=None, stack_cap=STACK_DEPTH):
    """Lane-vectorised ordered binary walk over candidate trees.

    nodes [R, 16] and tris [S, 128] hold every tree's rows back to back
    (tree ``cid`` starts at node row ``cid * nodes_pad`` and leaf row
    ``cid * leaves_pad``); lane i walks trees ``cand[i, :ncand[i]]`` in
    order from ``roots[cid]``, carrying (best_t, slot), with its own stack
    of ``stack_cap`` entries (writes clamped to the last) and its own
    direction octant, step for step as a CUDA thread does (``fused``: the
    fused-leaf walk).  ``counters`` also records ``stack_max``, the most
    entries a lane's stack held.  Returns (best_t [N] f32, slot [N] i32).
    """
    ox, oy, oz, dx, dy, dz = rays
    dev = best_t.device
    n = best_t.shape[0]
    if counters is not None:
        init_counters(counters, nodes.shape[0], tris.shape[0], dev)
        counters.setdefault("stack_max", 0)
    o = torch.stack([ox, oy, oz], dim=1)
    d = torch.stack([dx, dy, dz], dim=1)
    inv = torch.stack([safe_inv(dx), safe_inv(dy), safe_inv(dz)], dim=1)
    octant = (dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long()
    slots = leaves_pad * LEAF_SLOTS
    n_cand = cand.shape[1]
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, stack_cap), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    k = torch.zeros(n, dtype=torch.int64, device=dev)
    cid = cand[:, 0].clone()
    ref = roots[cid]
    live = ncand > 0
    # a lane is at a tree's start: the fused walk resolves a leaf root
    # before its loop
    fresh = live.clone()
    while True:
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        r = ref[idx]
        c = cid[idx]
        pop = torch.ones(len(idx), dtype=torch.bool, device=dev)
        done = torch.zeros(len(idx), dtype=torch.bool, device=dev)  # tree finished
        if fused:
            # leaf roots: test, then the tree is done
            lr = fresh[idx] & (r < 0)
            if lr.any():
                _leaf_tests(tris, leaves_pad, idx[lr], r[lr], c[lr], o, d, best_t,
                            best_prim, slots, counters)
            done = lr
            inner = ~lr
        else:
            is_leaf = r < 0
            if is_leaf.any():
                li = idx[is_leaf]
                _leaf_tests(tris, leaves_pad, li, r[is_leaf], c[is_leaf], o, d, best_t,
                            best_prim, slots, counters)
                if any_hit:
                    best_t[li] = torch.where(best_prim[li] >= 0, INERT_T, best_t[li])
            inner = ~is_leaf
        fresh[idx] = False

        ii = idx[inner]
        if ii.numel():
            node_row = c[inner] * nodes_pad + r[inner]
            nf = nodes[node_row]
            if counters is not None:
                counters["slab_tests"] += 2 * len(ii)
                counters["node_seen"][node_row] = True
            bt = best_t[ii]
            hl = _slab(nf[:, 0:6], o[ii], inv[ii], bt)
            hr = _slab(nf[:, 6:12], o[ii], inv[ii], bt)
            lref = nf[:, 12].long()
            rref = nf[:, 13].long()
            lf = ((nf[:, 14].long() >> octant[ii]) & 1) == 1
            if fused:
                for hit, cref in ((hl, lref), (hr, rref)):
                    m = hit & (cref < 0)
                    if m.any():
                        _leaf_tests(tris, leaves_pad, ii[m], cref[m], c[inner][m], o, d,
                                    best_t, best_prim, slots, counters)
                hl = hl & (lref >= 0)
                hr = hr & (rref >= 0)
            near = torch.where(lf, lref, rref)
            far = torch.where(lf, rref, lref)
            both = hl & hr
            if both.any():
                bi = ii[both]
                stack[bi, torch.clamp(sp[bi], max=stack_cap - 1)] = far[both]
                sp[bi] += 1
                if counters is not None:
                    counters["stack_max"] = max(counters["stack_max"], int(sp[bi].max()))
            ref[ii] = torch.where(both, near, torch.where(hl, lref, rref))
            pop[inner] = ~(hl | hr)

        # pop; a lane whose stack ran dry has finished its tree
        pi = idx[pop]
        s = sp[pi]
        empty = s <= 0
        ref[pi] = stack[pi, torch.clamp(s - 1, 0, stack_cap - 1)]
        sp[pi] = torch.clamp(s - 1, min=0)
        emptied = torch.zeros_like(pop)
        emptied[pop] = empty
        done = done | emptied
        # an any-hit lane stops at the step that found its hit; lanes that
        # finished a tree otherwise move to their next candidate
        found = (best_prim[idx] >= 0) if any_hit else torch.zeros_like(pop)
        e = idx[done & ~found]
        if e.numel():
            k[e] += 1
            more = k[e] < ncand[e]
            nxt = cand[e, torch.clamp(k[e], max=n_cand - 1)]
            cid[e] = nxt
            ref[e] = roots[nxt]
            sp[e] = 0
            fresh[e] = True
            live[e[~more]] = False
        live[idx[found]] = False
    return best_t, best_prim.to(torch.int32)


def skip_walk_plain(nodes_f, nodes_i, tris, comps, any_hit=False, counters=None, start=0,
                    end=None):
    """Plain version of :func:`skip_walk` (same arguments, any device):
    per lane, descend to ``node + 1`` on a box hit at an interior node,
    else jump to ``skip``; leaves test their triangles, triangle ids
    clamped to T - 1 (``pallas_bvh.py:114``).  ``counters`` counts node
    rows as skip nodes and leaf rows as triangles.  ``start`` and ``end``:
    walk the DFS node range [start, end) only, from ``start`` with t =
    t_max, stopping at the first node >= end, as the kernel's range tasks
    do (the defaults walk the whole tree)."""
    ox, oy, oz, dx, dy, dz, t_max = comps
    dev = t_max.device
    n = t_max.shape[0]
    m, n_tris = nodes_f.shape[0], tris.shape[0]
    end = m if end is None else end
    if counters is not None:
        init_counters(counters, m, n_tris, dev)
    o = torch.stack([ox, oy, oz], dim=1)
    d = torch.stack([dx, dy, dz], dim=1)
    inv = torch.stack([safe_inv(dx), safe_inv(dy), safe_inv(dz)], dim=1)
    live = t_max > RAY_EPS
    best_t = torch.where(live, t_max, INERT_T)
    live &= start < end
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b0a = torch.zeros(n, dtype=torch.float32, device=dev)
    b1a = torch.zeros(n, dtype=torch.float32, device=dev)
    node = torch.full((n,), start, dtype=torch.int64, device=dev)
    ni_all = nodes_i.long()
    while True:
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        nd = node[idx]
        ni = ni_all[nd]
        skip, first, count = ni[:, 0], ni[:, 1], ni[:, 2]
        box = _slab(nodes_f[nd, 0:6], o[idx], inv[idx], best_t[idx])
        if counters is not None:
            counters["slab_tests"] += len(idx)
            counters["node_seen"][nd] = True
        leaf = box & (count > 0)
        if leaf.any():
            li = idx[leaf]
            lo, ld = o[li], d[li]
            bt, bp = best_t[li], best_prim[li]
            b0l, b1l = b0a[li], b1a[li]
            lf, lc = first[leaf], count[leaf]
            for kk in range(int(lc.max())):
                pid = torch.clamp(lf + kk, max=n_tris - 1)
                ok, tt, b0, b1 = _tri_test(tris[pid], lo, ld, bt)
                ok = ok & (kk < lc)
                if counters is not None:
                    counters["tri_tests"] += int((kk < lc).sum())
                    counters["leaf_seen"][pid[kk < lc]] = True
                bp = torch.where(ok, pid, bp)
                b0l = torch.where(ok, b0, b0l)
                b1l = torch.where(ok, b1, b1l)
                bt = torch.where(ok, tt, bt)
            best_t[li], best_prim[li], b0a[li], b1a[li] = bt, bp, b0l, b1l
        nxt = torch.where(box & (count == 0), nd + 1, skip)
        node[idx] = nxt
        stop = nxt >= end
        if any_hit:
            stop = stop | (best_prim[idx] >= 0)
        live[idx[stop]] = False
    return best_t, best_prim.to(torch.int32), b0a, b1a
