"""Two-level streaming BVH: cluster tables and traversal (counterpart of
``pbrt_tpu/ops/stream_bvh.py``).

The SAH tree is cut at subtree boundaries into clusters of at most
``target_tris`` triangles; each cluster is packed as an 8-wide tree
(``ops/bvh8.py``, ``wide=True``) or as a binary tree of ordered node rows
(``ops/pallas_bvh.py``, ``wide=False``: the reference's
``PBRT_TPU_WIDE=0``).  A wavefront intersection is two phases:

  A (plain PyTorch, :func:`_stream_candidates`): every 1024-ray block
     slab-tests the C cluster bounds -> a per-block candidate list
     sorted by the block's entry distance (near clusters first).
  B (hand-written CUDA kernels replacing ``_stream_kernel``): each ray
     walks its block's candidates in order, carrying (t, slot) --
     ``kernels.bvh8_walk.stream_walk8`` on 64-column node rows,
     ``kernels.bvh2_walk.stream_walk2`` on 16-column ones (``fused``:
     the fused-leaf walk, the reference's ``PBRT_TPU_FUSED_LEAF=1``).

The host packers below are numpy copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.kernels.bvh2_walk import NODE2_COLS, stream_walk2
from pbrt_tpu_torch.kernels.bvh8_walk import (
    BLOCK,
    LEAF_COUNT_BITS,
    LEAF_SLOTS,
    RAY_EPS,
    safe_inv,
    stream_walk8,
)


def split_clusters(skips, firsts, counts, n_prims, target):
    """Cut the DFS skip-link tree into subtree clusters of <= target prims.

    Returns a list of (root_node, prim_lo, prim_hi); DFS order makes every
    subtree's primitives a contiguous slice of the permuted array.
    """
    skips = np.asarray(skips)
    firsts = np.asarray(firsts)
    counts = np.asarray(counts)
    m = len(skips)
    vals = np.where(counts > 0, firsts.astype(np.int64), -1)
    brev = vals[::-1]
    pos = np.maximum.accumulate(np.where(brev >= 0, np.arange(m), -1))
    prim_lo = np.empty(m + 1, dtype=np.int64)
    prim_lo[:m] = brev[pos][::-1]
    prim_lo[m] = n_prims

    out = []
    stack = [0]
    while stack:
        i = stack.pop()
        lo, hi = prim_lo[i], prim_lo[skips[i]]
        if counts[i] > 0 or hi - lo <= target:
            out.append((int(i), int(lo), int(hi)))
        else:
            left = i + 1
            stack.append(int(skips[left]))  # right child (popped second)
            stack.append(int(left))
    return out


def pack_leaf_rows(firsts, counts, p0, p1, p2, leaf_slots=8):
    """Pack a skip-link tree's leaves into 128-lane triangle rows.

    Returns (tris [n_rows, 128] f32, slot_to_prim [n_leaves*leaf_slots]
    i64 — local prim index per packed slot, 0 for empty slots,
    padded_firsts [M] — per-node leaf_slots-aligned packed first slot).
    """
    counts = np.asarray(counts)
    firsts = np.asarray(firsts)
    if leaf_slots % LEAF_SLOTS or not (
        counts.max(initial=0) <= leaf_slots <= (1 << LEAF_COUNT_BITS) - 1
    ):
        raise ValueError(f"bad leaf_slots {leaf_slots} for leaves of {counts.max()}")
    leaf_nodes = np.nonzero(counts > 0)[0]
    n_leaves = max(len(leaf_nodes), 1)
    tris = np.zeros((n_leaves * (leaf_slots // LEAF_SLOTS), 128), dtype=np.float32)
    slot_to_prim = np.zeros((n_leaves * leaf_slots,), dtype=np.int64)
    padded_firsts = np.zeros_like(firsts)
    if len(leaf_nodes):
        lrow = np.arange(len(leaf_nodes))
        padded_firsts[leaf_nodes] = lrow * leaf_slots
        f = firsts[leaf_nodes].astype(np.int64)
        cnt = counts[leaf_nodes].astype(np.int64)
        l_ids = np.repeat(lrow, leaf_slots)
        s_ids = np.tile(np.arange(leaf_slots), len(leaf_nodes))
        valid = s_ids < cnt[l_ids]
        prim = f[l_ids] + s_ids
        slot_to_prim[l_ids * leaf_slots + s_ids] = np.where(valid, prim, 0)
        lv, sv, pv = l_ids[valid], s_ids[valid], prim[valid]
        rv = lv * (leaf_slots // LEAF_SLOTS) + sv // LEAF_SLOTS
        cv = 16 * (sv % LEAF_SLOTS)
        for c in range(3):
            tris[rv, cv + 0 + c] = p0[pv, c]
            tris[rv, cv + 3 + c] = p1[pv, c]
            tris[rv, cv + 6 + c] = p2[pv, c]
    return tris, slot_to_prim, padded_firsts


def pack_tree(mins, maxs, skips, firsts, counts, p0, p1, p2, leaf_slots=8):
    """Binary skip-link (sub)tree -> ordered binary tables (the reference's
    ``_pack_tree``): (nodes [ni, 16] f32, tris [n_rows, 128] f32, root
    i32, slot_to_prim [n_leaves*leaf_slots] i64); a leaf spans
    ``leaf_slots / 8`` consecutive rows."""
    from pbrt_tpu_torch.ops.pallas_bvh import leaf_root, ordered_node_rows

    counts = np.asarray(counts)
    tris, slot_to_prim, padded_firsts = pack_leaf_rows(
        firsts, counts, p0, p1, p2, leaf_slots
    )
    if counts[0] > 0:  # whole (sub)tree is a single leaf
        nodes = np.zeros((1, NODE2_COLS), dtype=np.float32)
        return nodes, tris, leaf_root(padded_firsts[0], counts[0]), slot_to_prim
    nodes = ordered_node_rows(mins, maxs, np.asarray(skips), padded_firsts, counts)
    return nodes, tris, np.int32(0), slot_to_prim


def pack_stream_tables(mins, maxs, skips, firsts, counts,
                       tri_p0, tri_p1, tri_p2,
                       target_tris: int | None = None, leaf_slots: int = 32,
                       wide: bool = True):
    """Host cluster cut + packing for the streaming walk: BVH8 clusters
    (``wide``) or ordered binary ones.

    Returns numpy arrays {nodes [C, NP, 64 or 16], tris [C, LP, 128],
    roots [C], cl_min/cl_max [C, 3], slot_to_prim [C*slots] (DFS prim per
    packed slot), slots_per_cluster} — equal to the reference's
    ``pack_stream_tables(..., wide=wide)``.
    """
    from pbrt_tpu_torch.ops.bvh8 import pack_tree8

    n_prims = len(tri_p0)
    if target_tris is None:
        target_tris = int(min(32768, max(4096, n_prims // 32)))
    clusters = split_clusters(skips, firsts, counts, n_prims, target_tris)
    skips = np.asarray(skips)
    firsts = np.asarray(firsts)
    counts = np.asarray(counts)
    packs = []
    for (i, lo, hi) in clusters:
        sl = slice(i, int(skips[i]))
        packs.append(
            (pack_tree8 if wide else pack_tree)(
                mins[sl], maxs[sl], skips[sl] - i, firsts[sl] - lo,
                counts[sl], tri_p0[lo:hi], tri_p1[lo:hi], tri_p2[lo:hi],
                leaf_slots=leaf_slots,
            )
        )
    c = len(packs)
    nodes_pad = max(8, -(-max(p[0].shape[0] for p in packs) // 8) * 8)
    leaves_pad = max(8, -(-max(p[1].shape[0] for p in packs) // 8) * 8)
    all_nodes = np.zeros((c, nodes_pad, packs[0][0].shape[1]), dtype=np.float32)
    all_tris = np.zeros((c, leaves_pad, 128), dtype=np.float32)
    roots = np.zeros((c,), dtype=np.int32)
    slots_per_cluster = leaves_pad * LEAF_SLOTS
    slot_to_prim = np.zeros((c * slots_per_cluster,), dtype=np.int64)
    for ci, ((i, lo, hi), (nf, tr, root, s2p)) in enumerate(zip(clusters, packs)):
        all_nodes[ci, : nf.shape[0]] = nf
        all_tris[ci, : tr.shape[0]] = tr
        roots[ci] = root
        base = ci * slots_per_cluster
        slot_to_prim[base : base + len(s2p)] = s2p + lo
    return {
        "nodes": all_nodes,
        "tris": all_tris,
        "roots": roots,
        "cl_min": np.stack([mins[i] for (i, _, _) in clusters]).astype(np.float32),
        "cl_max": np.stack([maxs[i] for (i, _, _) in clusters]).astype(np.float32),
        "slot_to_prim": slot_to_prim,
        "slots_per_cluster": slots_per_cluster,
    }


def tree_depth(nodes, root):
    """Interior levels of one packed tree, ordered binary (nodes [NP, 16],
    child refs in cols 12..13) or 8-wide (nodes [NP, 64], refs in cols
    48..55); a ref < 0 is a leaf or an empty child, a single-leaf tree has
    depth 0.  It bounds the stack a walk of the tree needs."""
    refs = slice(12, 14) if nodes.shape[1] == NODE2_COLS else slice(48, 56)
    depth = 0
    frontier = np.array([root] if root >= 0 else [], dtype=np.int64)
    while frontier.size:
        depth += 1
        kids = nodes[frontier, refs].astype(np.int64).ravel()
        frontier = kids[kids >= 0]
    return depth


def split_pad_rays(o, d, t_max, n):
    """Rays -> 7 contiguous [N'] f32 columns (ox oy oz dx dy dz t_max),
    padded to whole 1024-ray blocks with dead lanes (t_max = 0).  Under the
    double policy this is where the float64 rays become float32, as the
    reference casts them at its kernels (``pbrt_tpu/ops/stream_bvh.py:702``):
    every walk (K1, K2, K4, K4b, K6) takes and returns float32.
    ``o``/``d`` may be [N, 3] tensors or 3-tuples of [N] columns."""
    if isinstance(o, (tuple, list)):
        ox, oy, oz = o
        dx, dy, dz = d
    else:
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    t_max = torch.broadcast_to(torch.as_tensor(t_max, device=ox.device), (n,))
    pad = (-n) % BLOCK
    cols = [ox, oy, oz, dx, dy, dz, t_max]
    fill = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]
    if pad:
        cols = [torch.cat([c, torch.full((pad,), f, dtype=c.dtype, device=c.device)])
                for c, f in zip(cols, fill)]
    return tuple(c.to(torch.float32).contiguous() for c in cols)


def _stream_candidates(cl_min, cl_max, comps):
    """Phase A: per-1024-ray-block candidate clusters, nearest entry first.

    Padded clusters must use cl_min = cl_max = +inf (t_near = +inf never
    passes ``t_near < t_max``).  Returns (clist [B, C] i32, cnt [B] i32).
    """
    ox, oy, oz, dx, dy, dz, t_max = comps
    n = ox.shape[0]
    b = n // BLOCK
    n_clusters = cl_min.shape[0]
    o = torch.stack([ox, oy, oz], dim=1)[:, None, :]
    inv = torch.stack([safe_inv(dx), safe_inv(dy), safe_inv(dz)], dim=1)[:, None, :]
    lo = (cl_min[None] - o) * inv  # [N, C, 3]
    hi = (cl_max[None] - o) * inv
    mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
    tn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tf = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    hit = (tn <= tf) & (tf > RAY_EPS) & (tn < t_max[:, None])  # [N, C]
    hit_b = hit.reshape(b, BLOCK, n_clusters)
    hits = hit_b.any(dim=1)  # [B, C]
    t_ent = torch.where(hit_b, tn.reshape(b, BLOCK, n_clusters), torch.inf).amin(dim=1)
    key = torch.where(hits, t_ent, torch.inf)
    order = torch.argsort(key, dim=1, stable=True)
    cnt = hits.sum(dim=1)
    kk = torch.arange(n_clusters, device=ox.device)[None]
    clamped = torch.minimum(kk, torch.clamp(cnt[:, None] - 1, min=0))
    clist = torch.gather(order, 1, clamped)
    return clist.to(torch.int32).contiguous(), cnt.to(torch.int32).contiguous()


def stream_traverse(nodes, tris, roots, cl_min, cl_max, o, d, t_max, any_hit=False,
                    fused=False, depth=None):
    """Functional streaming traversal over explicit tables.

    nodes [C, NP, 64] (BVH8) or [C, NP, 16] (binary; the walk follows the
    node width, as the reference's does), tris [C, LP, 128], roots [C]
    i32, cl_min/cl_max [C, 3]; o, d [N, 3] (or 3-tuples of [N]); t_max
    [N]; ``fused`` picks the fused-leaf binary walk, ``depth`` is the
    deepest tree (:func:`tree_depth`; required for binary tables, and
    for 8-wide ones it lets the kernel take a stack smaller than 96).  Returns (t [N], packed slot id [N], -1 =
    miss); callers resolve slots through their own slot_to_prim map.
    """
    n = (o[0] if isinstance(o, (tuple, list)) else o).shape[0]
    comps = split_pad_rays(o, d, t_max, n)
    clist, cnt = _stream_candidates(cl_min, cl_max, comps)
    if nodes.shape[2] == NODE2_COLS:
        if depth is None:
            raise ValueError("stream_traverse: binary tables need their tree depth")
        t, prim = stream_walk2(nodes, tris, roots, clist, cnt, comps, any_hit=any_hit,
                               fused=fused, depth=depth)
    else:
        t, prim = stream_walk8(nodes, tris, roots, clist, cnt, comps, any_hit=any_hit,
                               depth=depth)
    return t[:n], prim[:n]


class StreamBVH:
    """Streaming intersector for scenes of 4096 triangles or more; holds
    the cluster tables (BVH8 when ``wide``, else binary walked with the
    plain or, with ``fused``, the fused-leaf walk) on ``device``;
    ``depth`` is their deepest tree (it sizes the walk's stack)."""

    def __init__(self, mins, maxs, skips, firsts, counts,
                 tri_p0, tri_p1, tri_p2, target_tris: int | None = None,
                 leaf_slots: int = 32, wide: bool = True, fused: bool = False,
                 device="cuda"):
        t = pack_stream_tables(
            mins, maxs, skips, firsts, counts, tri_p0, tri_p1, tri_p2,
            target_tris=target_tris, leaf_slots=int(leaf_slots), wide=wide,
        )
        self.tables = t  # host copies (tests compare them to the reference)
        self.fused = fused
        self.depth = max(tree_depth(nf, int(r)) for nf, r in zip(t["nodes"], t["roots"]))
        self.nodes = torch.as_tensor(t["nodes"], device=device)
        self.tris = torch.as_tensor(t["tris"], device=device)
        self.roots = torch.as_tensor(t["roots"], device=device)
        self.cl_min = torch.as_tensor(t["cl_min"], device=device)
        self.cl_max = torch.as_tensor(t["cl_max"], device=device)
        self.slot_to_prim = t["slot_to_prim"]

    def traverse(self, o, d, t_max):
        """Closest-hit walk -> (t, raw slot id)."""
        return stream_traverse(self.nodes, self.tris, self.roots, self.cl_min,
                               self.cl_max, o, d, t_max, fused=self.fused, depth=self.depth)

    def occluded_slots(self, o, d, t_max):
        """Any-hit walk -> (t, raw slot id >= 0 where occluded)."""
        return stream_traverse(self.nodes, self.tris, self.roots, self.cl_min,
                               self.cl_max, o, d, t_max, any_hit=True, fused=self.fused,
                               depth=self.depth)
