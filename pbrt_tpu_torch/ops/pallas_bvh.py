"""Binary BVH tables and their whole-tree intersectors (counterpart of
``pbrt_tpu/ops/pallas_bvh.py``; the file name is kept so the pair is easy
to find, though nothing here is Pallas).

Host packers (numpy copies of the reference's):

* :func:`encode_children` (``_encode_children``) and
  :func:`pack_ordered_tables` (``PallasBVH2.__init__``): interior nodes
  as [ni, 16] f32 rows -- left box cols 0..5, right box 6..11, child refs
  12..13 as exact f32 integers (leaf ref ``-((first/8)*64 + count + 1)``),
  per-octant near-first mask in col 14 -- and leaves as 8-slot rows of
  [128] f32;
* :func:`pack_skip_tables` (``PallasBVH.__init__``): the skip-link tree
  as nodes_f [M, 8] f32 (box), nodes_i [M, 4] i32 (skip, first, count)
  and tris [T, 16] f32.

:class:`OrderedBVH2` (counterpart of ``PallasBVH2``) walks the ordered
tables with ``kernels/bvh2_walk.ordered_walk2``; :class:`SkipLinkBVH`
(counterpart of ``PallasBVH``) walks the skip-link tables with
``kernels/bvh2_walk.skip_walk``, whose range segments need leaf firsts
that grow in DFS order (the native build emits them so; the class
checks).
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.kernels.bvh2_walk import ordered_walk2, skip_walk
from pbrt_tpu_torch.kernels.bvh8_walk import LEAF_COUNT_BITS, LEAF_SLOTS
from pbrt_tpu_torch.ops.stream_bvh import tree_depth


def encode_children(skips, firsts, counts):
    """DFS skip-link arrays -> (interior DFS ids, left refs, right refs,
    left DFS ids, right DFS ids), indexed by interior rank.  For interior
    node i: left = i + 1, right = skip[i + 1]."""
    is_interior = counts == 0
    rank = np.cumsum(is_interior) - 1  # DFS idx -> interior rank
    idx = np.nonzero(is_interior)[0]
    left = idx + 1
    right = skips[left]

    def ref(child):
        out = np.where(
            counts[child] > 0,
            -((firsts[child].astype(np.int64) >> 3) * (1 << LEAF_COUNT_BITS)
              + counts[child] + 1),
            rank[child],
        )
        return out.astype(np.int32)

    return idx, ref(left), ref(right), left, right


def ordered_node_rows(mins, maxs, skips, padded_firsts, counts):
    """Interior nodes of a (sub)tree whose root is interior -> [ni, 16]
    f32 rows (both children's boxes and refs, near-first mask)."""
    idx, l_ref, r_ref, left, right = encode_children(skips, padded_firsts, counts)
    ni = len(idx)
    nodes_f = np.zeros((ni, 16), dtype=np.float32)
    nodes_f[:, 0:3] = mins[left]
    nodes_f[:, 3:6] = maxs[left]
    nodes_f[:, 6:9] = mins[right]
    nodes_f[:, 9:12] = maxs[right]
    nodes_f[:, 12] = l_ref.astype(np.float32)
    nodes_f[:, 13] = r_ref.astype(np.float32)
    if max(np.abs(l_ref).max(), np.abs(r_ref).max()) >= (1 << 24):
        raise ValueError("binary child ref exceeds the exact-f32 range")
    # per-octant near-first bits: along the axis where the children
    # separate most, the lower-side child goes first iff the ray travels
    # toward +axis (octant bit set = that component of d is negative)
    cl = 0.5 * (mins[left] + maxs[left])
    cr = 0.5 * (mins[right] + maxs[right])
    axis = np.argmax(np.abs(cr - cl), axis=1)
    l_lower = (np.take_along_axis(cl, axis[:, None], 1)[:, 0]
               <= np.take_along_axis(cr, axis[:, None], 1)[:, 0])
    mask = np.zeros(ni, dtype=np.int32)
    for o in range(8):
        d_neg = (np.array([o >> 2, o >> 1, o]) & 1).astype(bool)[axis]
        mask |= (l_lower != d_neg).astype(np.int32) << o
    nodes_f[:, 14] = mask.astype(np.float32)
    return nodes_f


def leaf_root(padded_first, count):
    """The ref of a (sub)tree that is a single leaf."""
    return np.int32(-((int(padded_first) >> 3) * (1 << LEAF_COUNT_BITS) + int(count) + 1))


def pack_ordered_tables(mins, maxs, skips, firsts, counts, tri_p0, tri_p1, tri_p2):
    """``PallasBVH2``'s packing: (nodes [ni, 16] f32, tris [n_leaves, 128]
    f32, root i32, slot_to_prim [n_leaves * 8] i32).  Leaves must hold at
    most 8 triangles (one row each)."""
    counts = np.asarray(counts)
    skips = np.asarray(skips)
    firsts = np.asarray(firsts)
    if counts.max(initial=0) > LEAF_SLOTS:
        raise ValueError(f"leaves of {counts.max()} triangles: the whole-tree binary "
                         f"walk takes at most {LEAF_SLOTS}")
    leaf_mask = counts > 0
    leaf_ids = np.cumsum(leaf_mask) - 1  # DFS idx -> leaf row
    n_leaves = max(int(leaf_mask.sum()), 1)
    tris = np.zeros((n_leaves, 128), dtype=np.float32)
    slot_to_prim = np.zeros((n_leaves * LEAF_SLOTS,), dtype=np.int32)
    padded_firsts = np.zeros_like(firsts)
    for i in np.nonzero(leaf_mask)[0]:
        row = leaf_ids[i]
        f, cnt = int(firsts[i]), int(counts[i])
        padded_firsts[i] = row * LEAF_SLOTS
        for k in range(cnt):
            c = 16 * k
            tris[row, c + 0: c + 3] = tri_p0[f + k]
            tris[row, c + 3: c + 6] = tri_p1[f + k]
            tris[row, c + 6: c + 9] = tri_p2[f + k]
            slot_to_prim[row * LEAF_SLOTS + k] = f + k
    if counts[0] > 0:  # whole tree is one leaf
        return (np.zeros((1, 16), dtype=np.float32), tris,
                leaf_root(padded_firsts[0], counts[0]), slot_to_prim)
    nodes = ordered_node_rows(mins, maxs, skips, padded_firsts, counts)
    return nodes, tris, np.int32(0), slot_to_prim


def pack_skip_tables(mins, maxs, skips, firsts, counts, tri_p0, tri_p1, tri_p2):
    """``PallasBVH``'s packing: (nodes_f [M, 8] f32, nodes_i [M, 4] i32,
    tris [T, 16] f32)."""
    m, t = len(mins), len(tri_p0)
    nodes_f = np.zeros((m, 8), dtype=np.float32)
    nodes_f[:, 0:3] = mins
    nodes_f[:, 3:6] = maxs
    nodes_i = np.zeros((m, 4), dtype=np.int32)
    nodes_i[:, 0] = skips
    nodes_i[:, 1] = firsts
    nodes_i[:, 2] = counts
    tris = np.zeros((t, 16), dtype=np.float32)
    tris[:, 0:3] = tri_p0
    tris[:, 3:6] = tri_p1
    tris[:, 6:9] = tri_p2
    return nodes_f, nodes_i, tris


class OrderedBVH2:
    """Whole-tree ordered binary walk; counterpart of the reference's
    ``PallasBVH2`` (leaves of at most 8 triangles)."""

    def __init__(self, mins, maxs, skips, firsts, counts, tri_p0, tri_p1, tri_p2,
                 device="cuda"):
        nodes, tris, root, slot_to_prim = pack_ordered_tables(
            mins, maxs, skips, firsts, counts,
            np.asarray(tri_p0), np.asarray(tri_p1), np.asarray(tri_p2),
        )
        self.nodes = torch.as_tensor(nodes, device=device)
        self.tris = torch.as_tensor(tris, device=device)
        self.root = torch.as_tensor(np.asarray([root], dtype=np.int32), device=device)
        self.slot_to_prim = slot_to_prim.astype(np.int64)
        self.depth = tree_depth(nodes, int(root))  # sizes the walk's stack

    def traverse(self, o, d, t_max):
        """Closest-hit walk: o, d [N, 3] or 3-tuples of [N]; t_max [N].
        Returns (t, raw slot id, -1 = miss)."""
        return self._walk(o, d, t_max, any_hit=False)

    def occluded_slots(self, o, d, t_max):
        """Any-hit walk; slot >= 0 where a hit was found."""
        return self._walk(o, d, t_max, any_hit=True)

    def _walk(self, o, d, t_max, any_hit):
        from pbrt_tpu_torch.ops.stream_bvh import split_pad_rays

        n = (o[0] if isinstance(o, (tuple, list)) else o).shape[0]
        comps = split_pad_rays(o, d, t_max, n)
        t, prim = ordered_walk2(self.nodes, self.tris, self.root, comps, any_hit=any_hit,
                                depth=self.depth)
        return t[:n], prim[:n]


class SkipLinkBVH:
    """Skip-link walk over the DFS tree that also returns barycentrics;
    counterpart of the reference's ``PallasBVH`` (and of the per-lane walk
    ``BVHIntersector._traverse_xla`` that the reference takes on the CPU).
    Raises unless leaf firsts grow in DFS order (each leaf's triangles
    after the previous leaf's): the kernel merges its node-range segments
    by triangle id, which must then be the sequential walk's visiting
    order."""

    def __init__(self, mins, maxs, skips, firsts, counts, tri_p0, tri_p1, tri_p2,
                 device="cuda"):
        leaves = np.asarray(counts) > 0
        lf, lc = np.asarray(firsts)[leaves], np.asarray(counts)[leaves]
        if (np.diff(lf.astype(np.int64)) < lc[:-1]).any():
            raise ValueError("SkipLinkBVH: leaf firsts must grow in DFS order (each "
                             "leaf's triangles after the previous leaf's)")
        nodes_f, nodes_i, tris = pack_skip_tables(
            mins, maxs, skips, firsts, counts,
            np.asarray(tri_p0), np.asarray(tri_p1), np.asarray(tri_p2),
        )
        self.nodes_f = torch.as_tensor(nodes_f, device=device)
        self.nodes_i = torch.as_tensor(nodes_i, device=device)
        self.tris = torch.as_tensor(tris, device=device)

    def traverse(self, o, d, t_max):
        """Closest-hit walk: o, d [N, 3] or 3-tuples of [N]; t_max [N].
        Returns (t, DFS triangle index, -1 = miss, b0, b1)."""
        return self._walk(o, d, t_max, any_hit=False)

    def occluded_slots(self, o, d, t_max):
        """Any-hit walk -> (t, index >= 0 where a hit was found, b0, b1)."""
        return self._walk(o, d, t_max, any_hit=True)

    def _walk(self, o, d, t_max, any_hit):
        from pbrt_tpu_torch.ops.stream_bvh import split_pad_rays

        n = (o[0] if isinstance(o, (tuple, list)) else o).shape[0]
        comps = split_pad_rays(o, d, t_max, n)
        out = skip_walk(self.nodes_f, self.nodes_i, self.tris, comps, any_hit=any_hit)
        return tuple(x[:n] for x in out)
