"""The ordered 8-wide BVH walk: CUDA kernels and their plain PyTorch version.

Two wrappers, one per hand-written kernel in ``csrc/bvh8_walk.cu``:

* :func:`stream_walk8` replaces ``pbrt_tpu/ops/stream_bvh.py::_stream_kernel``
  (the two-level streaming traversal, K2);
* :func:`wide_walk8` replaces ``pbrt_tpu/ops/bvh8.py::_wide_kernel`` (the
  whole-tree walk, K1).

Both walk ``pbrt_tpu/ops/bvh8.py::_walk8``'s tables, one thread per ray
and tree, with a per-thread stack of :func:`stack_capacity` entries in
shared memory; the streaming kernel cuts each live ray's candidate list
into segments on sparse sweeps and merges them exactly (see the note at
the top of the CUDA source).

A wrapper runs :func:`walk8_plain`, the lane-vectorised PyTorch version
of the same walk, only because its tensors lie on the CPU; on CUDA
tensors it launches its kernel or raises.  The two visit nodes in the
same per-ray order with the same float operations, so their closest-hit
results are bit-equal.  ``LAUNCHES`` counts wrapper calls that launched
(a streaming call is one prepass and one walk kernel).

The kernels are built at first use by ``kernels/build.py`` (``nvcc`` into a
shared library with a plain C interface, loaded through ctypes).
"""

from __future__ import annotations

import ctypes

import torch

from pbrt_tpu_torch.kernels import build

STACK_DEPTH = 96  # per-ray stack entries (pbrt_tpu/ops/pallas_bvh.py)
STACK_CAPACITIES = (8, 16, 32, 64, STACK_DEPTH)  # the walk kernels' stack templates
LEAF_COUNT_BITS = 6
LEAF_SLOTS = 8  # triangles per 128-float leaf row
NODE_COLS = 64
BLOCK = 1024  # rays per candidate-list block (phase A granularity)
RAY_EPS = 1e-4
INERT_T = -1e30

LAUNCHES = {"stream_walk8": 0, "wide_walk8": 0}

_lib = None
_last_header = None  # the device header of the last stream_walk8 launch (segment_stats)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is None:
        lib = build.load("bvh8_walk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.launch_stream_walk8.argtypes = [p] * 15 + [i] * 6 + [p]
        lib.launch_stream_walk8.restype = i
        lib.launch_wide_walk8.argtypes = [p] * 12 + [i] * 3 + [p]
        lib.launch_wide_walk8.restype = i
        _lib = lib
    return _lib


def stack_capacity(depth) -> int:
    """Stack entries for 8-wide trees of ``depth`` interior levels
    (``ops/stream_bvh.tree_depth``): a walk pops one entry and pushes at
    most 8 per step, so it holds at most 7 depth + 1; the smallest
    template of at least that, else (or for ``depth`` None: not known)
    the reference's 96 with clamped writes."""
    if depth is None:
        return STACK_DEPTH
    return next((c for c in STACK_CAPACITIES if 7 * int(depth) + 1 <= c), STACK_DEPTH)


def segment_stats():
    """What the last :func:`stream_walk8` launch found on the card: live
    rays, 32-ray groups holding one, and the segments per group it chose
    (synchronises)."""
    header = _last_header.view(torch.int32).tolist()
    return {"live_rays": header[0], "live_groups": header[1], "segments": header[3]}


def check_rays(comps, device, dtype=torch.float32):
    n = comps[0].shape[0]
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_max"), comps):
        build.check_tensor(name, c, dtype, device, 1)
        if c.shape[0] != n:
            raise ValueError(f"{name}: expected {n} lanes, got {c.shape[0]}")
    return n


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def stream_walk8(nodes, tris, roots, clist, cnt, comps, any_hit=False, depth=None):
    """Phase B of the streaming traversal (K2).

    nodes [C, NP, 64] f32, tris [C, LP, 128] f32, roots [C] i32, clist
    [B, K] i32 and cnt [B] i32 from phase A, comps = 7 [N] f32 ray
    columns (ox oy oz dx dy dz t_max) with N = B * 1024, ``depth`` the
    deepest cluster tree (sizes the stack: :func:`stack_capacity`).
    Returns (t [N] f32 starting at each ray's t_max, packed slot [N] i32,
    -1 = miss); slot ids are ``cid * LP * 8 + slot``.  Any hit: t is
    -1e30 on hits and the slot one of the ray's hits.
    """
    global _last_header
    dev = nodes.device
    if dev.type == "cpu":
        return stream_walk8_plain(nodes, tris, roots, clist, cnt, comps, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"stream_walk8: unsupported device {dev}")
    build.check_tensor("nodes", nodes, torch.float32, dev, 3)
    build.check_tensor("tris", tris, torch.float32, dev, 3)
    build.check_tensor("roots", roots, torch.int32, dev, 1)
    build.check_tensor("clist", clist, torch.int32, dev, 2)
    build.check_tensor("cnt", cnt, torch.int32, dev, 1)
    n = check_rays(comps, dev)
    if nodes.shape[2] != NODE_COLS or tris.shape[2] != 128:
        raise ValueError("stream_walk8: expected [C,NP,64] nodes and [C,LP,128] tris")
    if n != clist.shape[0] * BLOCK or cnt.shape[0] != clist.shape[0]:
        raise ValueError("stream_walk8: rays must fill whole 1024-ray blocks")
    n_cand, leaves_pad = clist.shape[1], tris.shape[1]
    if n_cand * leaves_pad * LEAF_SLOTS >= 1 << 31:
        raise ValueError(f"stream_walk8: {n_cand} candidates x {leaves_pad * LEAF_SLOTS} "
                         "slots per cluster overflow the 31-bit (position, slot) merge key")
    build.check_aligned("nodes", nodes)
    build.check_aligned("tris", tris)
    lib = load_library()
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    # merge keys, group list, finished-task counts and a 4-int header
    scratch = torch.empty(n + n // 32 + 2, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launch_checked(
        lib, lib.launch_stream_walk8,
        nodes.data_ptr(), tris.data_ptr(), roots.data_ptr(), clist.data_ptr(),
        cnt.data_ptr(), *[c.data_ptr() for c in comps],
        t_out.data_ptr(), prim_out.data_ptr(), scratch.data_ptr(),
        n, n_cand, nodes.shape[1], leaves_pad, int(any_hit), stack_capacity(depth), stream,
    )
    LAUNCHES["stream_walk8"] += 1
    _last_header = scratch[n + n // 32:]  # after the keys and the two group arrays
    return t_out, prim_out


def wide_walk8(nodes, tris, root, comps, any_hit=False, depth=None):
    """Whole-tree walk (K1): nodes [W, 64] f32, tris [rows, 128] f32, root
    [1] i32, comps = 7 [N] f32 ray columns, ``depth`` the tree's (sizes
    the stack).  Lanes with t_max <= RAY_EPS come back inert (t = -1e30,
    slot -1)."""
    dev = nodes.device
    if dev.type == "cpu":
        return wide_walk8_plain(nodes, tris, root, comps, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"wide_walk8: unsupported device {dev}")
    build.check_tensor("nodes", nodes, torch.float32, dev, 2)
    build.check_tensor("tris", tris, torch.float32, dev, 2)
    build.check_tensor("root", root, torch.int32, dev, 1)
    n = check_rays(comps, dev)
    if nodes.shape[1] != NODE_COLS or tris.shape[1] != 128:
        raise ValueError("wide_walk8: expected [W,64] nodes and [rows,128] tris")
    build.check_aligned("nodes", nodes)
    build.check_aligned("tris", tris)
    lib = load_library()
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launch_checked(
        lib, lib.launch_wide_walk8,
        nodes.data_ptr(), tris.data_ptr(), root.data_ptr(),
        *[c.data_ptr() for c in comps], t_out.data_ptr(), prim_out.data_ptr(),
        n, int(any_hit), stack_capacity(depth), stream,
    )
    LAUNCHES["wide_walk8"] += 1
    return t_out, prim_out


def walk_disagreement(t_a, slot_a, t_b, slot_b, any_hit, tris, o, d):
    """How two walks of one table set may differ, as numpy arrays.

    Hit masks must be equal (any hit: nothing else is compared); t within
    rtol 1e-6 on hits and equal on misses; slot ids equal wherever no
    second candidate lies within 1e-6 of t, since walks that visit in
    another order may resolve exact t ties differently.  ``tris`` is the
    triangle table the slots index (leaf rows of 128 f32 = 8 slots of 16,
    or one [T, 16] row per triangle), ``o``/``d`` the [N, 3] rays.
    Returns None when they agree, else a description.
    """
    import numpy as np

    hit = slot_a >= 0
    if not np.array_equal(hit, slot_b >= 0):
        return f"hit masks differ on {int((hit != (slot_b >= 0)).sum())} lanes"
    if any_hit:
        return None
    if not np.allclose(t_b[hit], t_a[hit], rtol=1e-6, atol=0.0):
        return "t differs beyond rtol 1e-6"
    if not np.array_equal(t_b[~hit], t_a[~hit]):
        return "t of missing lanes differs"
    diff = hit & (slot_a != slot_b)

    def plane_t(slot, o, d):
        tri = tris.reshape(-1, 16)[slot, :9].astype(np.float64)
        n = np.cross(tri[:, 3:6] - tri[:, 0:3], tri[:, 6:9] - tri[:, 0:3])
        return np.sum((tri[:, 0:3] - o) * n, 1) / np.sum(d * n, 1)

    if not np.allclose(plane_t(slot_a[diff], o[diff], d[diff]),
                       plane_t(slot_b[diff], o[diff], d[diff]), rtol=1e-6, atol=1e-6):
        return "slots differ where t is not a tie"
    return None


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def safe_inv(v):
    sign = torch.where(v < 0.0, -1.0, 1.0)
    return torch.clamp(sign / torch.clamp(torch.abs(v), min=1e-20), -1e30, 1e30)


def stream_walk8_plain(nodes, tris, roots, clist, cnt, comps, any_hit=False,
                       counters=None, depth=None):
    """Plain version of :func:`stream_walk8` (same arguments, any device;
    ``counters``: see :func:`init_counters`).  Its 96-entry stack gives
    the kernel's results at every template the kernel takes: one of at
    least 7 ``depth`` + 1 entries never clamps."""
    n = comps[0].shape[0]
    t_max = comps[6]
    block = torch.arange(n, device=t_max.device) // BLOCK
    ncand = torch.where(t_max > RAY_EPS, cnt.long()[block], 0)
    return walk8_plain(
        nodes.reshape(-1, NODE_COLS), tris.reshape(-1, 128), roots.long(),
        clist.long()[block], ncand, nodes.shape[1], tris.shape[1], comps[:6],
        t_max.clone(), any_hit, counters,
    )


def wide_walk8_plain(nodes, tris, root, comps, any_hit=False, counters=None, depth=None):
    """Plain version of :func:`wide_walk8` (same arguments, any device;
    ``counters`` and ``depth``: see :func:`stream_walk8_plain`)."""
    n = comps[0].shape[0]
    t_max = comps[6]
    live = t_max > RAY_EPS
    best_t = torch.where(live, t_max, INERT_T)
    cand = torch.zeros((n, 1), dtype=torch.int64, device=t_max.device)
    return walk8_plain(
        nodes, tris, root.long(), cand, live.long(), 0, 0, comps[:6], best_t, any_hit,
        counters,
    )


def init_counters(counters, n_node_rows, n_leaf_rows, device):
    """Work counters a plain walk fills when handed a dict (only bounds
    reporting does): box (slab) tests, triangle tests, and masks of the
    node and leaf rows it read (:func:`counted` sums them)."""
    counters.setdefault("slab_tests", 0)
    counters.setdefault("tri_tests", 0)
    counters.setdefault("node_seen", torch.zeros(n_node_rows, dtype=torch.bool,
                                                 device=device))
    counters.setdefault("leaf_seen", torch.zeros(n_leaf_rows, dtype=torch.bool,
                                                 device=device))


def counted(counters):
    """-> {slab_tests, tri_tests, node_rows, leaf_rows} as ints."""
    return {"slab_tests": int(counters["slab_tests"]),
            "tri_tests": int(counters["tri_tests"]),
            "node_rows": int(counters["node_seen"].sum()),
            "leaf_rows": int(counters["leaf_seen"].sum())}


def count_leaves(counters, row0, count):
    """Record leaf visits: lanes reading ``ceil(count / 8)`` rows from
    ``row0`` and testing ``count`` triangles."""
    if counters is None:
        return
    counters["tri_tests"] += int(count.sum())
    n_rows = (count + LEAF_SLOTS - 1) // LEAF_SLOTS
    for r in range(int(n_rows.max())):
        counters["leaf_seen"][(row0 + r)[n_rows > r]] = True


def walk8_plain(nodes, tris, roots, cand, ncand, nodes_pad, leaves_pad, rays,
                best_t, any_hit, counters=None):
    """Lane-vectorised ordered 8-wide walk over candidate trees.

    nodes [R, 64] and tris [S, 128] hold every tree's rows back to back
    (tree ``cid`` starts at node row ``cid * nodes_pad`` and leaf row
    ``cid * leaves_pad``); lane i walks trees ``cand[i, :ncand[i]]`` in
    order, from ``roots[cid]``, carrying (best_t, slot).  Each lane keeps
    its own stack of 96 entries (writes clamped to the last; column 96
    takes the non-hits' writes) and orders pushes by its own direction
    signs, as the CUDA threads do.  ``counters`` also records
    ``stack_max``, the most entries a lane's stack held.  Returns (best_t
    [N] f32, slot [N] i32).
    """
    ox, oy, oz, dx, dy, dz = rays
    dev = best_t.device
    n = best_t.shape[0]
    if counters is not None:
        init_counters(counters, nodes.shape[0], tris.shape[0], dev)
        counters.setdefault("stack_max", 0)
    o = torch.stack([ox, oy, oz], dim=1)
    inv = torch.stack([safe_inv(dx), safe_inv(dy), safe_inv(dz)], dim=1)
    neg = torch.stack([dx < 0, dy < 0, dz < 0], dim=1).long()
    slots_per_tree = leaves_pad * LEAF_SLOTS
    n_cand = cand.shape[1]
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH + 1), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    k = torch.zeros(n, dtype=torch.int64, device=dev)
    cid = cand[:, 0].clone()
    ref = roots[cid]
    live = ncand > 0
    while True:
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        r = ref[idx]
        c = cid[idx]
        is_leaf = r < 0
        found = None

        # --- leaves: Moller-Trumbore over the leaf's slots, in slot order
        li = idx[is_leaf]
        if li.numel():
            code = -r[is_leaf] - 1
            first = (code >> LEAF_COUNT_BITS) << 3
            count = code & ((1 << LEAF_COUNT_BITS) - 1)
            n_rows = int((count.max() + LEAF_SLOTS - 1) // LEAF_SLOTS)
            row0 = c[is_leaf] * leaves_pad + (first >> 3)
            rows = row0[:, None] + torch.arange(n_rows, device=dev)[None]
            tri = tris[rows.clamp(max=tris.shape[0] - 1)].reshape(len(li), -1, 16)
            count_leaves(counters, row0, count)
            lo, ld = o[li], torch.stack([dx[li], dy[li], dz[li]], dim=1)
            bt, bp = best_t[li], best_prim[li]
            base = c[is_leaf] * slots_per_tree + first
            # every slot at once ([L, S]; each product and sum rounds as
            # it would slot by slot), then the slot-order pass's result:
            # the first slot of least t among the hits, if it beats best_t
            p0 = tri[:, :, 0:3]
            e1 = tri[:, :, 3:6] - p0
            e2 = tri[:, :, 6:9] - p0
            ldx, ldy, ldz = ld[:, 0:1], ld[:, 1:2], ld[:, 2:3]
            pvx = ldy * e2[..., 2] - ldz * e2[..., 1]
            pvy = ldz * e2[..., 0] - ldx * e2[..., 2]
            pvz = ldx * e2[..., 1] - ldy * e2[..., 0]
            det = e1[..., 0] * pvx + e1[..., 1] * pvy + e1[..., 2] * pvz
            det_ok = torch.abs(det) > 1e-12
            inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
            tv = lo[:, None, :] - p0
            b0 = (tv[..., 0] * pvx + tv[..., 1] * pvy + tv[..., 2] * pvz) * inv_det
            qvx = tv[..., 1] * e1[..., 2] - tv[..., 2] * e1[..., 1]
            qvy = tv[..., 2] * e1[..., 0] - tv[..., 0] * e1[..., 2]
            qvz = tv[..., 0] * e1[..., 1] - tv[..., 1] * e1[..., 0]
            b1 = (ldx * qvx + ldy * qvy + ldz * qvz) * inv_det
            tt = (e2[..., 0] * qvx + e2[..., 1] * qvy + e2[..., 2] * qvz) * inv_det
            slot = torch.arange(tri.shape[1], device=dev)
            ok = ((slot < count[:, None]) & det_ok & (b0 >= 0.0) & (b1 >= 0.0)
                  & (b0 + b1 <= 1.0) & (tt > RAY_EPS))
            tt = torch.where(ok, tt, torch.inf)
            t_min = tt.amin(dim=1)
            s_min = torch.where(tt == t_min[:, None], slot, tri.shape[1]).amin(dim=1)
            better = t_min < bt
            bp = torch.where(better, base + s_min, bp)
            bt = torch.where(better, t_min, bt)
            if any_hit:
                hit = bp >= 0
                bt = torch.where(hit, INERT_T, bt)
                found = li[hit]
            best_t[li] = bt
            best_prim[li] = bp

        # --- interior nodes: 8 slab tests, ordered pushes
        ii = idx[~is_leaf]
        if ii.numel():
            node_row = c[~is_leaf] * nodes_pad + r[~is_leaf]
            nf = nodes[node_row]
            if counters is not None:
                counters["slab_tests"] += 8 * len(ii)
                counters["node_seen"][node_row] = True
            box = nf[:, :48].reshape(-1, 8, 6)
            oi, vi = o[ii][:, None, :], inv[ii][:, None, :]
            t_lo = (box[:, :, 0:3] - oi) * vi
            t_hi = (box[:, :, 3:6] - oi) * vi
            mn, mx = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
            t_near = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
            t_far = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
            bits = ((t_near <= t_far) & (t_far > RAY_EPS)
                    & (t_near < best_t[ii][:, None])).long()
            h = bits.sum(dim=1)
            pre = torch.cumsum(bits, dim=1) - bits
            suf = h[:, None] - pre - bits
            ax = nf[:, 56].long()
            rev = neg[ii].gather(1, ax[:, None])
            rank = torch.where(rev == 0, pre, suf)
            s0 = sp[ii]
            addr = torch.clamp(s0[:, None] + h[:, None] - 1 - rank, max=STACK_DEPTH - 1)
            addr = torch.where(bits > 0, addr, STACK_DEPTH)  # non-hits: unused slot
            vals = nf[:, 48:56].long()
            rows = ii[:, None].expand(-1, 8)
            for cc in range(8):
                stack[rows[:, cc], addr[:, cc]] = vals[:, cc]
            sp[ii] = s0 + h
            if counters is not None:
                counters["stack_max"] = max(counters["stack_max"], int((s0 + h).max()))

        # --- pop; lanes whose stack ran dry move to their next candidate
        s = sp[idx]
        empty = s <= 0
        ref[idx] = stack[idx, torch.clamp(s - 1, 0, STACK_DEPTH - 1)]
        sp[idx] = torch.clamp(s - 1, min=0)
        e = idx[empty]
        if e.numel():
            k[e] += 1
            more = k[e] < ncand[e]
            nxt = cand[e, torch.clamp(k[e], max=n_cand - 1)]
            cid[e] = nxt
            ref[e] = roots[nxt]
            sp[e] = 0
            live[e[~more]] = False
        if found is not None and found.numel():
            live[found] = False
    return best_t, best_prim.to(torch.int32)
