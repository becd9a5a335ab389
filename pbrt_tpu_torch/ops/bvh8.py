"""8-wide (BVH8) tables: host packer (numpy copy of
``pbrt_tpu/ops/bvh8.py:85-172``) and the whole-tree intersector.

Node row layout ([64] f32 per wide node):
  cols 6c..6c+5   child c box: minx miny minz maxx maxy maxz
  cols 48+c       child c ref as exact f32 int (|ref| < 2^24):
                  interior -> wide-node rank; leaf ->
                  -((first/8)*64+count+1) with ``first`` leaf-row aligned;
                  empty slot -> -1 with a +inf box (never slab-hit)
  col 56          sort axis (0/1/2); children sorted by centroid along it
Leaf rows are [128] f32: 8 triangle slots x 16 cols (p0 p1 p2 in 0..8).

:class:`WideBVH8` is the counterpart of the reference's ``PallasBVH8``:
its ``traverse`` runs the whole-tree walk (``kernels/bvh8_walk.py::
wide_walk8``, the hand-written CUDA kernel that replaces ``_wide_kernel``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pbrt_tpu_torch.kernels.bvh8_walk import LEAF_COUNT_BITS, NODE_COLS, wide_walk8

WIDTH = 8  # children per wide node


def collapse8(mins, maxs, skips, firsts, counts, padded_firsts):
    """Collapse a binary SAH tree into 8-wide nodes (greedy by area).

    From each subtree root, repeatedly expand the largest-area binary
    interior slot into its two children until 8 slots are filled or all
    are leaves; interior slots left at cutoff become child wide nodes.
    Children are sorted ascending by centroid along the max-spread axis.
    Returns wnodes [W, 64] f32.
    """
    mins = np.asarray(mins)
    maxs = np.asarray(maxs)
    skips = np.asarray(skips)
    counts = np.asarray(counts)
    interior = counts == 0
    ext = np.maximum(maxs - mins, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2]

    def leaf_ref(s):
        return -((int(padded_firsts[s]) >> 3) * (1 << LEAF_COUNT_BITS)
                 + int(counts[s]) + 1)

    rows = []  # reserved in DFS order, filled post-order

    def emit(i):
        rank = len(rows)
        rows.append(None)
        slots = [i]
        while len(slots) < WIDTH:
            k_best, a_best = -1, -1.0
            for k, s in enumerate(slots):
                if interior[s] and area[s] > a_best:
                    k_best, a_best = k, float(area[s])
            if k_best < 0:
                break
            s = slots.pop(k_best)
            slots.extend([s + 1, int(skips[s + 1])])
        cen = 0.5 * (mins[slots] + maxs[slots])
        ax = int(np.argmax(cen.max(axis=0) - cen.min(axis=0))) if len(slots) > 1 else 0
        order = np.argsort(cen[:, ax], kind="stable")
        slots = [slots[k] for k in order]
        row = np.zeros((NODE_COLS,), dtype=np.float32)
        row[0:48] = np.inf  # empty-slot boxes: min = max = +inf
        refs = np.full((WIDTH,), -1.0, dtype=np.float64)
        for c, s in enumerate(slots):
            row[6 * c: 6 * c + 3] = mins[s]
            row[6 * c + 3: 6 * c + 6] = maxs[s]
            refs[c] = emit(s) if interior[s] else leaf_ref(s)
        if np.abs(refs).max() >= (1 << 24):
            raise ValueError("BVH8 child ref exceeds the exact-f32 range")
        row[48:56] = refs.astype(np.float32)
        row[56] = float(ax)
        rows[rank] = row
        return rank

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(old_limit + 8 * len(skips) + 10000)
    try:
        emit(0)
    finally:
        sys.setrecursionlimit(old_limit)
    return np.stack(rows)


def pack_tree8(mins, maxs, skips, firsts, counts, p0, p1, p2, leaf_slots=16):
    """Binary skip-link (sub)tree -> BVH8 tables: (wnodes [W, 64] f32,
    tris [rows, 128] f32, root i32, slot_to_prim [n_leaves*leaf_slots] i64)."""
    from pbrt_tpu_torch.ops.stream_bvh import pack_leaf_rows

    counts = np.asarray(counts)
    tris, slot_to_prim, padded_firsts = pack_leaf_rows(
        firsts, counts, p0, p1, p2, leaf_slots
    )
    if counts[0] > 0:  # whole (sub)tree is a single leaf
        root = np.int32(
            -((int(padded_firsts[0]) >> 3) * (1 << LEAF_COUNT_BITS)
              + int(counts[0]) + 1)
        )
        return np.zeros((1, NODE_COLS), dtype=np.float32), tris, root, slot_to_prim
    wnodes = collapse8(mins, maxs, skips, firsts, counts, padded_firsts)
    return wnodes, tris, np.int32(0), slot_to_prim


class WideBVH8:
    """Whole-tree BVH8 intersector (scenes of 512-4095 triangles)."""

    def __init__(self, mins, maxs, skips, firsts, counts, tri_p0, tri_p1, tri_p2,
                 leaf_slots: int = 16, device="cuda"):
        from pbrt_tpu_torch.ops.stream_bvh import tree_depth

        wnodes, tris, root, slot_to_prim = pack_tree8(
            mins, maxs, skips, firsts, counts,
            np.asarray(tri_p0), np.asarray(tri_p1), np.asarray(tri_p2),
            leaf_slots=int(leaf_slots),
        )
        self.nodes = torch.as_tensor(wnodes, device=device)
        self.tris = torch.as_tensor(tris, device=device)
        self.root = torch.as_tensor(np.asarray([root], dtype=np.int32), device=device)
        self.slot_to_prim = slot_to_prim.astype(np.int64)
        self.depth = tree_depth(wnodes, int(root))  # sizes the walk's stack

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
        t, prim = wide_walk8(self.nodes, self.tris, self.root, comps, any_hit=any_hit,
                             depth=self.depth)
        return t[:n], prim[:n]
