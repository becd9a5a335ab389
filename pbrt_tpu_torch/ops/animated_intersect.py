"""Keyframed-triangle intersection for motion blur (counterpart of
``pbrt_tpu/ops/animated_intersect.py``).

The host bakes K world-space vertex keyframes per animated shape
(``core/animated.py``: decompose + slerp, K adapted to the rotation
angle), and every query blends each triangle's vertices with per-lane
hat weights ``w_k(t) = max(0, 1 - |t (K-1) - k|)`` of the lane's
normalized shutter time (``time``: [N] in [0, 1]; None = shutter open).

Two arithmetic paths, as in the reference:

* below ``BVH_MIN_TRIS`` triangles, the brute-force sweep: a loop over
  the triangles (at most 63), each blended by the sequential sum
  ``acc + w_k * c_k`` and tested on every lane;
* from ``BVH_MIN_TRIS`` up, the skip-link walk over a BVH of
  shutter-union boxes (each triangle's box the union of its boxes at every
  keyframe), built by ``build_bvh(bb_min, bb_max, bb_max, leaf_size=4)``
  with the box corners as the three "vertices", as the reference builds
  it, so the tree and its permutation are the reference's.  The walk is
  ``kernels/anim_walk.anim_walk`` (K7, CUDA on the card, which reads the
  keyframe rows packed once here by ``pack_keys``; its plain version on
  CPU tensors).

Both blend and test with ``kernels/anim_walk``'s ``blend`` and
``tri_test``, whose products fuse into their sums as the reference's
compiled code fuses them.  ``AnimatedIntersector`` merges the static analytic spheres (the
brute-force sphere sweep) with the keyframed triangles.

The keyframe rows take the policy's float (that of the host keyframes:
float64 under the double policy, where K7 runs its double instance); the
shutter-union boxes stay float32, as the reference's BVH build gives them.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.kernels.anim_walk import (anim_walk, blend, pack_keys, time_weights,
                                              tri_test)
from pbrt_tpu_torch.ops.intersect import KIND_NONE, KIND_SPHERE, KIND_TRI
from pbrt_tpu_torch.ops.intersect_soa import SoABruteForceIntersector

__all__ = ["AnimatedIntersector", "AnimatedTriIntersector", "time_weights"]


class AnimatedTriIntersector:
    """K-keyframed triangles (``key_tris``: K TriangleData of one topology;
    key k holds the world-space vertices at shutter time k / (K - 1))."""

    BVH_MIN_TRIS = 64  # from this count on, the shutter-union BVH walk

    def __init__(self, key_tris, device="cuda"):
        from pbrt_tpu_torch.accel.bvh import build_bvh

        self.n_keys = len(key_tris)
        self.n_tri = key_tris[0].count
        # [T, K, 9] per-triangle, per-key vertex scalars in the policy's float
        float_t = key_tris[0].p0.dtype
        cols = np.stack([np.concatenate([kt.p0.astype(float_t), kt.p1.astype(float_t),
                                         kt.p2.astype(float_t)], axis=1)
                         for kt in key_tris], axis=1)
        self.bvh = None
        if self.n_tri >= self.BVH_MIN_TRIS:
            v = cols.reshape(self.n_tri, self.n_keys, 3, 3)
            bb_min, bb_max = v.min(axis=(1, 2)), v.max(axis=(1, 2))
            mins, maxs, skips, firsts, counts, perm = build_bvh(bb_min, bb_max, bb_max,
                                                                leaf_size=4)
            cols = cols[perm]
            nodes_f = np.zeros((len(mins), 8), dtype=np.float32)
            nodes_f[:, 0:3], nodes_f[:, 3:6] = mins, maxs
            nodes_i = np.zeros((len(mins), 4), dtype=np.int32)
            nodes_i[:, 0], nodes_i[:, 1], nodes_i[:, 2] = skips, firsts, counts
            self.bvh = {"nodes_f": torch.as_tensor(nodes_f, device=device),
                        "nodes_i": torch.as_tensor(nodes_i, device=device),
                        "perm": torch.as_tensor(perm.astype(np.int64), device=device)}
        self.cols = torch.as_tensor(np.ascontiguousarray(cols), device=device)
        # K7's table: each key's row padded to whole 16-byte vectors
        self.packed = pack_keys(self.cols) if self.bvh is not None else None

    def _weights(self, time, n, dt, dev):
        """Hat weights of the lanes' times, in the rays' float ``dt`` (the
        reference casts the times to it)."""
        if time is None:
            time = torch.zeros(n, dtype=dt, device=dev)
        return time_weights(torch.broadcast_to(time, (n,)).to(dt), self.n_keys)

    def walk(self, o, d, t_max, time, any_hit=False):
        """The shutter-union BVH walk (K7) -> (t, prim in the tree's order,
        -1 = miss, b0, b1)."""
        n = o.shape[0]
        dt = self.cols.dtype
        if time is None:
            time = torch.zeros(n, dtype=dt, device=o.device)
        comps = tuple(c.to(dt).contiguous()
                      for c in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max))
        time = torch.broadcast_to(time, (n,)).to(dt).contiguous()
        return anim_walk(self.bvh["nodes_f"], self.bvh["nodes_i"], self.cols, self.packed, comps,
                         time, any_hit)

    def intersect(self, o, d, t_max, time=None):
        n = o.shape[0]
        dev = o.device
        t_max = torch.broadcast_to(t_max, (n,)).to(o.dtype)
        if self.bvh is not None:
            bt, bp, b0a, b1a = self.walk(o, d, t_max, time)
            got = bp >= 0
            prim = torch.where(got, self.bvh["perm"][bp.clamp(min=0).long()], 0)
            return {"t": bt, "hit": got,
                    "kind": torch.where(got, KIND_TRI, KIND_NONE).to(torch.int32),
                    "prim": prim.to(torch.int32), "b0": b0a, "b1": b1a}
        w = self._weights(time, n, o.dtype, dev)
        bt = t_max.clone()
        bp = torch.full((n,), -1, dtype=torch.int32, device=dev)
        b0a = torch.zeros(n, dtype=o.dtype, device=dev)
        b1a = torch.zeros(n, dtype=o.dtype, device=dev)
        for k in range(self.n_tri):
            v = blend(self.cols[k].expand(n, self.n_keys, 9), w)
            ok, tt, b0, b1 = tri_test(v, o, d, bt)
            bt = torch.where(ok, tt, bt)
            bp = torch.where(ok, k, bp)
            b0a = torch.where(ok, b0, b0a)
            b1a = torch.where(ok, b1, b1a)
        got = bp >= 0
        return {"t": bt, "hit": got,
                "kind": torch.where(got, KIND_TRI, KIND_NONE).to(torch.int32),
                "prim": bp.clamp(min=0), "b0": b0a, "b1": b1a}

    def occluded(self, o, d, t_max, time=None):
        if self.bvh is not None:
            n = o.shape[0]
            t_max = torch.broadcast_to(t_max, (n,)).to(o.dtype)
            return self.walk(o, d, t_max, time, any_hit=True)[1] >= 0
        return self.intersect(o, d, t_max, time)["hit"]


class AnimatedIntersector:
    """Animated triangles and static analytic spheres, hit records merged
    (the sphere wins where strictly nearer)."""

    def __init__(self, key_tris, sph_data, device="cuda"):
        self.n_tri = key_tris[0].count
        self.n_sph = sph_data.count if sph_data is not None else 0
        self.tris = AnimatedTriIntersector(key_tris, device) if self.n_tri else None
        self._sph = (SoABruteForceIntersector(None, sph_data, device=device)
                     if self.n_sph else None)

    def intersect(self, o, d, t_max, time=None):
        n = o.shape[0]
        dev = o.device
        if self.tris is not None:
            out = self.tris.intersect(o, d, t_max, time)
        else:
            out = {"t": torch.broadcast_to(t_max, (n,)).to(o.dtype),
                   "hit": torch.zeros(n, dtype=torch.bool, device=dev),
                   "kind": torch.full((n,), KIND_NONE, dtype=torch.int32, device=dev),
                   "prim": torch.zeros(n, dtype=torch.int32, device=dev),
                   "b0": torch.zeros(n, dtype=o.dtype, device=dev),
                   "b1": torch.zeros(n, dtype=o.dtype, device=dev)}
        if self._sph is not None:
            sph = self._sph.intersect(o, d, out["t"])
            closer = sph["hit"] & (sph["t"] < out["t"])
            out = {"t": torch.where(closer, sph["t"], out["t"]),
                   "hit": out["hit"] | closer,
                   "kind": torch.where(closer, KIND_SPHERE, out["kind"]).to(torch.int32),
                   "prim": torch.where(closer, sph["prim"], out["prim"]),
                   "b0": torch.where(closer, 0.0, out["b0"]),
                   "b1": torch.where(closer, 0.0, out["b1"])}
        return out

    def occluded(self, o, d, t_max, time=None):
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        if self.tris is not None:
            occ = self.tris.occluded(o, d, t_max, time)
        if self._sph is not None:
            occ = occ | self._sph.occluded(o, d, t_max)
        return occ
