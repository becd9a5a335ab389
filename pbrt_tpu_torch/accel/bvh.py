"""BVH accelerator: host SAH build and packed-table traversal
(counterpart of ``pbrt_tpu/accel/bvh.py``).

Build (host, numpy): binned SAH through the native builder
(``native.py``); nodes in depth-first order with skip links.

The walk is chosen by an argument where the reference reads environment
switches (``walk``):

* ``"bvh8"`` (default; the reference on the TPU): streaming BVH8
  cluster tables (32-triangle leaves) for ``stream_min_tris`` (4096)
  triangles or more, one whole BVH8 tree (16-triangle leaves) below;
* ``"binary"`` (``PBRT_TPU_WIDE=0``): streaming binary cluster tables
  (32-triangle leaves) for ``stream_min_tris`` or more, one whole
  ordered binary tree below.  That tree takes 8-triangle leaves: the reference builds
  16-triangle leaves there, which its ``PallasBVH2`` refuses, and runs
  only with ``PBRT_TPU_LEAF_SLOTS=8``;
* ``"binary_fused"`` (``PBRT_TPU_FUSED_LEAF=1`` as well): as ``binary``
  with the fused-leaf streaming walk (the whole tree has no fused walk);
* ``"skip"`` (the reference's per-lane walk ``_traverse_xla`` on the
  CPU, and ``PallasBVH``): the skip-link tree with 4-triangle leaves,
  whose walk also returns barycentrics.

Whether a walk runs its CUDA kernel or its plain PyTorch version depends
only on the device of the tables.  The packed walks sort rays by
``sort_keys`` before each query and scatter the results back to lane
order (``_traverse_sorted``); the skip walk, as in the reference, does
not.  ``sort`` picks the ``co_sort`` network of those sorts and of the
integrator's sorted carry ("stable" or "bitonic", ``ops/sortnet.py``).

Three more arguments stand where the reference reads environment
variables, with the same meanings and defaults: ``stream_min_tris``
(``PBRT_TPU_STREAM_MIN_TRIS``, 4096: the triangle count from which the
packed walks take the streaming cluster tables), ``key_obits``
(``PBRT_TPU_KEY_OBITS``, 5: origin Morton bits per axis in the sort key;
the direction takes ``min(4, (28 - 3 * key_obits) // 3)``) and
``deadbit`` (``PBRT_TPU_NO_DEADBIT`` unset, True: spent lanes get key bit
31 and sort last).

Spheres take the reference's brute-force sweep
(``ops/intersect_soa.py``) after every walk, in the rays' lane order: a
sphere replaces a triangle hit only when strictly nearer, and any hit is
either kind's.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.rng import MASK32
from pbrt_tpu_torch.ops.intersect import KIND_NONE, KIND_SPHERE, KIND_TRI, RAY_EPS
from pbrt_tpu_torch.ops.intersect_soa import SoABruteForceIntersector

# at or above this triangle count the streaming (cluster) walk is used
STREAM_MIN_TRIS = 4096
STREAM_LEAF_SLOTS = 32
WIDE_LEAF_SLOTS = 16
BINARY_LEAF_SLOTS = 8  # one 128-float row: the whole-tree binary walk's limit
SKIP_LEAF_SIZE = 4  # the reference's LEAF_SIZE
WALKS = ("bvh8", "binary", "binary_fused", "skip")
KEY_OBITS = 5  # origin Morton bits per axis in the sort key


def build_bvh(p0, p1, p2, leaf_size=4):
    """Binned-SAH BVH build through the native builder -> (mins [M,3], maxs
    [M,3], skip [M], first [M], count [M] (0 for interior nodes), perm [T]:
    BVH prim slot -> triangle index)."""
    from pbrt_tpu_torch.native import bvh_build_native

    return bvh_build_native(np.asarray(p0), np.asarray(p1), np.asarray(p2), leaf_size)


def _part1by2(v):
    """Spread 10 bits to every third bit (Morton helper; int64 lanes)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


class BVHIntersector:
    """BVH over the scene's triangles, walked by ``walk`` (see the module
    docstring), and a brute-force sweep over its spheres (``sph_data``, or
    None); ``sort`` is the ``co_sort`` network ("stable" or "bitonic")."""

    # the integrator may keep its wavefront in sort_keys order
    supports_sort_hint = True

    def __init__(self, tri_data, sph_data=None, device="cuda", walk="bvh8", sort="stable",
                 stream_min_tris=STREAM_MIN_TRIS, key_obits=KEY_OBITS, deadbit=True):
        if walk not in WALKS:
            raise ValueError(f"unknown walk {walk!r}; expected one of {WALKS}")
        if sort not in ("stable", "bitonic"):
            raise ValueError(f"unknown sort {sort!r}; expected 'stable' or 'bitonic'")
        self.n_tri = tri_data.count
        self.n_sph = sph_data.count if sph_data is not None else 0
        self._sph_brute = (SoABruteForceIntersector(None, sph_data, device=device)
                           if self.n_sph else None)
        if not 0 <= int(key_obits) <= 9:
            raise ValueError(f"key_obits {key_obits} outside 0..9 (3 x obits + 3 key bits)")
        self.walk_name = walk
        self.sort_network = sort
        self.key_obits = int(key_obits)
        self.deadbit = bool(deadbit)
        use_stream = self.n_tri >= int(stream_min_tris) and walk != "skip"
        if walk == "skip":
            leaf_size = SKIP_LEAF_SIZE
        elif use_stream:
            leaf_size = STREAM_LEAF_SLOTS
        else:
            leaf_size = WIDE_LEAF_SLOTS if walk == "bvh8" else BINARY_LEAF_SLOTS
        mins, maxs, skips, firsts, counts, perm = build_bvh(
            tri_data.p0, tri_data.p1, tri_data.p2, leaf_size
        )
        tp = (tri_data.p0[perm], tri_data.p1[perm], tri_data.p2[perm])
        tree = (mins, maxs, skips, firsts, counts, *tp)
        if walk == "skip":
            from pbrt_tpu_torch.ops.pallas_bvh import SkipLinkBVH

            self.walk = SkipLinkBVH(*tree, device=device)
            slot_to_prim = np.arange(self.n_tri)  # the walk returns DFS prims
        else:
            if use_stream:
                from pbrt_tpu_torch.ops.stream_bvh import StreamBVH

                self.walk = StreamBVH(*tree, leaf_slots=leaf_size, wide=walk == "bvh8",
                                      fused=walk == "binary_fused", device=device)
            elif walk == "bvh8":
                from pbrt_tpu_torch.ops.bvh8 import WideBVH8

                self.walk = WideBVH8(*tree, leaf_slots=leaf_size, device=device)
            else:
                from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2

                self.walk = OrderedBVH2(*tree, device=device)
            slot_to_prim = self.walk.slot_to_prim
        # fold packed slot -> original triangle id into one map
        self.perm = torch.as_tensor(
            perm.astype(np.int64)[slot_to_prim], device=device
        )
        self._scene_min = torch.as_tensor(mins[0], device=device)
        self._scene_extent = torch.as_tensor(
            np.maximum(maxs[0] - mins[0], 1e-6), device=device
        )

    def sort_keys(self, o, d, t_max):
        """Traversal-order keys (int64 holding the reference's uint32):
        dead bit 31 | origin Morton | direction octant | direction Morton.

        Coincident-origin wavefronts (camera, point-light shadows) share
        the high bits and fall through to the direction bits; lanes whose
        t_max is spent sort into trailing blocks (unless ``deadbit`` is
        off).
        """
        obits = self.key_obits
        dbits = min(4, (28 - 3 * obits) // 3)
        octant = (
            (d[..., 0] < 0).long() * 4 + (d[..., 1] < 0).long() * 2 + (d[..., 2] < 0).long()
        )
        ad = torch.abs(d)
        qd = torch.clamp(
            ad / torch.clamp(ad.amax(dim=-1, keepdim=True), min=1e-12), 0.0, 0.999999
        )
        qdi = (qd * float(1 << dbits)).long()
        dir_m = (
            _part1by2(qdi[..., 0]) | (_part1by2(qdi[..., 1]) << 1)
            | (_part1by2(qdi[..., 2]) << 2)
        ) & ((1 << (3 * dbits)) - 1)
        q = torch.clamp((o - self._scene_min) / self._scene_extent, 0.0, 0.999999)
        qi = (q * float(1 << obits)).long()
        morton = (
            _part1by2(qi[..., 0]) | (_part1by2(qi[..., 1]) << 1)
            | (_part1by2(qi[..., 2]) << 2)
        ) & ((1 << (3 * obits)) - 1)
        key = ((morton << (3 + 3 * dbits)) | (octant << (3 * dbits)) | dir_m) & MASK32
        if not self.deadbit:
            return key
        return key | ((t_max <= RAY_EPS).long() << 31)

    def _traverse_sorted(self, o, d, t_max, any_hit):
        """Sort rays by ``sort_keys``, walk, and scatter (t, slot) back to
        lane order.  The sort is stable, so lane order matches the
        reference's ``lax.sort`` co-sort exactly."""
        from pbrt_tpu_torch.ops.sortnet import co_sort

        n = o.shape[0]
        lane = torch.arange(n, device=o.device)
        _, lane_s, o_s, d_s, t_s = co_sort((self.sort_keys(o, d, t_max), lane, o, d, t_max),
                                           self.sort_network)
        cols_o = (o_s[:, 0], o_s[:, 1], o_s[:, 2])
        cols_d = (d_s[:, 0], d_s[:, 1], d_s[:, 2])
        walk = self.walk.occluded_slots if any_hit else self.walk.traverse
        t, prim = walk(cols_o, cols_d, t_s)
        prim_out = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        prim_out[lane_s] = prim
        if any_hit:
            return torch.zeros((n,), dtype=o.dtype, device=o.device), prim_out
        t_out = torch.zeros((n,), dtype=t.dtype, device=o.device)
        t_out[lane_s] = t
        return t_out, prim_out

    def _traverse(self, o, d, t_max, any_hit, sort):
        if sort:
            return self._traverse_sorted(o, d, t_max, any_hit)
        walk = self.walk.occluded_slots if any_hit else self.walk.traverse
        return walk(o, d, t_max)

    def intersect(self, o, d, t_max, sort=True):
        """Closest hits; ``sort``: sort the rays around a packed walk (the
        skip walk never sorts)."""
        n = o.shape[0]
        best_t = torch.broadcast_to(t_max, (n,)).to(o.dtype)
        if self.walk_name == "skip":
            t, prim, b0, b1 = self.walk.traverse(o, d, best_t)
        else:
            t, prim = self._traverse(o, d, best_t, any_hit=False, sort=sort)
            # None: compute_interaction re-derives barycentrics from the
            # hit triangle (the packed walks carry only (t, slot))
            b0 = b1 = None
        got = prim >= 0
        best_t = torch.where(got, t, best_t)
        kind = torch.where(got, KIND_TRI, KIND_NONE).to(torch.int32)
        prim = torch.where(got, self.perm[prim.clamp(min=0).long()], 0).to(torch.int32)
        if self.n_sph:
            sph = self._sph_brute.intersect(o, d, best_t)
            closer = sph["hit"] & (sph["t"] < best_t)
            best_t = torch.where(closer, sph["t"], best_t)
            kind = torch.where(closer, KIND_SPHERE, kind)
            prim = torch.where(closer, sph["prim"], prim)
        return {
            "t": best_t,
            "hit": kind != KIND_NONE,
            "kind": kind,
            "prim": prim,
            "b0": None if b0 is None else torch.where(got, b0, 0.0),
            "b1": None if b1 is None else torch.where(got, b1, 0.0),
        }

    def occluded(self, o, d, t_max, sort=True):
        n = o.shape[0]
        t_max = torch.broadcast_to(t_max, (n,)).to(o.dtype)
        if self.walk_name == "skip":
            prim = self.walk.occluded_slots(o, d, t_max)[1]
        else:
            _, prim = self._traverse(o, d, t_max, any_hit=True, sort=sort)
        found = prim >= 0
        if self.n_sph:
            found = found | self._sph_brute.occluded(o, d, t_max)
        return found
