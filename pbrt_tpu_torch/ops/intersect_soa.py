"""Brute-force intersection of every ray with every primitive (counterpart
of ``pbrt_tpu/ops/intersect_soa.py::SoABruteForceIntersector``).

The reference sweeps primitives one at a time, keeping a running closest
hit per ray.  Here a block of primitives is swept at once as [N, P]
broadcasts, so the number of eager tensor operations per sweep does not
grow with the primitive count: the first minimum over a block (ties to
the lowest index) and a strict ``<`` against the running best across
blocks give the sequential sweep's answer exactly.

Two arithmetic paths, as in the reference:

* at most ``UNROLL_MAX`` primitives (the reference bakes them into the
  trace as float64 host constants): triangle edges are differenced in
  float64 and rounded once to the policy's float; a sphere's
  ``radius * radius``, ``z_min - 1e-6``, ``z_max + 1e-6`` and
  ``phi_max + 1e-6`` are float64 and rounded once; translate-only
  spheres skip the rotation and full spheres skip the z and phi clip
  (its ``atan2`` is not evaluated for them);
* above it (the reference's ``lax.scan`` over columns of the policy's
  float): edges are differences in that float, the sphere constants its
  arithmetic, and every sphere takes the rotation and the clip.

The policy's float is that of the host tables (``float_t`` of the
scene: float32, or float64 under the double policy).

Triangles are swept first; a sphere replaces a triangle hit only when
strictly nearer.  Any-hit sweeps test against ``t_max``.

The reference's renders run compiled by XLA, whose CPU code fuses a
multiply that feeds an add or subtract into one fused multiply-add: in
``a*b - c*d`` the first product, in ``x0*y0 + x1*y1 + x2*y2`` the first
two terms and then the third, except that where x0 and x1 are trace
constants with x0 < 0 <= x1 the second product is fused first (LLVM
turns the sum into x1*y1 - |x0|*y0).  A sphere's quadratic cancels badly
at scene scale (under plain float32 rounding the Cornell box's sphere
hit distances move by up to 1.4e-4 relative), and which side of the
surface a hit lands on decides whether its shadow ray leaves or hits the
sphere again; so these sums are
rounded as the reference's compiled code rounds them (:func:`fma`,
float64 holding the float32 product exactly).  Under the double policy
the same sums round twice, for float64 has no wider type here: there
the port's images differ from the reference's in the last bits
(``tests/test_torch_double.py`` bounds by how much).  Where XLA merges equal
products of the unrolled sweep (repeated coordinates), its code fuses
other products and last bits can still differ
(``scripts/xla_rounding.py`` measures how often).
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.geometry import fma
from pbrt_tpu_torch.ops.intersect import KIND_NONE, KIND_SPHERE, KIND_TRI, RAY_EPS

UNROLL_MAX = 96  # the reference's trace-constant threshold
BLOCK = 64  # primitives per [N, P] broadcast
TWO_PI = 2 * np.pi


def _dot3(x0, x1, x2, y0, y1, y2, swap=None):
    """x . y summed as the reference's compiled code sums it.  ``swap``
    ([1, P] bool, or None for none) marks the primitives whose x0, x1 are
    trace constants with x0 < 0 <= x1: LLVM rewrites x0*y0 + x1*y1 as
    x1*y1 - |x0|*y0 there and fuses the second product instead."""
    if swap is not None:
        x0, x1 = torch.where(swap, x1, x0), torch.where(swap, x0, x1)
        y0, y1 = torch.where(swap, y1, y0), torch.where(swap, y0, y1)
    return fma(x2, y2, fma(x0, y0, x1 * y1))


def _swap_mask(c0, c1, dev):
    """``_dot3``'s swap for host constant columns c0, c1 [P] (None where
    no primitive swaps)."""
    swap = (np.asarray(c0, np.float32) < 0) & (np.asarray(c1, np.float32) >= 0)
    return torch.as_tensor(swap[None], device=dev) if swap.any() else None


def _diff_of_products(a, b, c, d):
    """a*b - c*d as the reference's compiled code rounds it."""
    return fma(a, b, -(c * d))


def _first_min(tt, ok):
    """Per row: (the least tt among ok columns, inf where none; the lowest
    column index holding it, 0 where none)."""
    tt = torch.where(ok, tt, torch.inf)
    t_min = tt.amin(dim=1)
    col = torch.arange(tt.shape[1], device=tt.device)
    first = torch.where(ok & (tt == t_min[:, None]), col, tt.shape[1]).amin(dim=1)
    return t_min, torch.clamp(first, max=tt.shape[1] - 1)


class SoABruteForceIntersector:
    """Closest and any hit over the scene's triangles and spheres, with the
    reference's hit contract: t, hit, kind, prim, b0, b1."""

    def __init__(self, tri_data, sph_data, device="cuda"):
        self.n_tri = tri_data.count if tri_data is not None else 0
        self.n_sph = sph_data.count if sph_data is not None else 0
        self.unroll = (self.n_tri + self.n_sph) <= UNROLL_MAX
        dev = torch.device(device)
        # the policy's float, from the host tables
        self.float_t = float_t = (tri_data.p0 if self.n_tri else
                                  sph_data.radius if self.n_sph else np.zeros(0, np.float32)
                                  ).dtype.type

        def col(v):
            return torch.as_tensor(np.asarray(v, dtype=float_t)[None], device=dev)

        self._tri = []
        for lo in range(0, self.n_tri, BLOCK):
            sl = slice(lo, lo + BLOCK)
            p0, p1, p2 = (np.asarray(p[sl], np.float64 if self.unroll else float_t)
                          for p in (tri_data.p0, tri_data.p1, tri_data.p2))
            e1, e2 = p1 - p0, p2 - p0
            # det = e1 . pv and t = e2 . qv take trace-constant edges when
            # unrolled; the scan's edges are run-time values
            swaps = ((_swap_mask(e1[:, 0], e1[:, 1], dev), _swap_mask(e2[:, 0], e2[:, 1], dev))
                     if self.unroll else (None, None))
            self._tri.append((lo, tuple(col(a[:, i]) for a in (p0, e1, e2)
                                        for i in range(3)) + swaps))
        self._sph = []
        for lo in range(0, self.n_sph, BLOCK):
            self._sph.append((lo, self._sphere_block(sph_data, slice(lo, lo + BLOCK), col,
                                                     dev)))

    def _sphere_block(self, sd, sl, col, dev):
        """Constants of one block of spheres: rotation rows and each row's
        ``_dot3`` swap (None where every sphere of the block is
        translate-only on the unrolled path), translation, r^2, the clip
        bounds and which spheres clip (None where none does)."""
        w2o = np.asarray(sd.w2o[sl], np.float64)
        radius, z_min, z_max, phi_max = (np.asarray(v[sl], self.float_t)
                                         for v in (sd.radius, sd.z_min, sd.z_max, sd.phi_max))
        if self.unroll:
            r64, zmin64, zmax64, phi64 = (v.astype(np.float64)
                                          for v in (radius, z_min, z_max, phi_max))
            translate_only = np.array([np.allclose(m[:3, :3], np.eye(3), atol=1e-12)
                                       for m in w2o])
            full = ((phi64 >= TWO_PI - 1e-5) & (zmin64 <= -r64 * (1 - 1e-6))
                    & (zmax64 >= r64 * (1 - 1e-6)))
            rot = np.where(translate_only[:, None, None], np.eye(3), w2o[:, :3, :3])
            consts = (r64 * r64, zmin64 - 1e-6, zmax64 + 1e-6, phi64 + 1e-6)
            rotate = not translate_only.all()
            clip = ~full
        else:
            rot = w2o[:, :3, :3]
            eps = self.float_t(1e-6)
            consts = (radius * radius, z_min - eps, z_max + eps, phi_max + eps)
            rotate = True
            clip = np.ones(len(radius), bool)
        m = None
        if rotate:
            # the rows are trace constants when unrolled, and in the scan
            # when it has one sphere (XLA inlines a one-trip loop)
            const = self.unroll or self.n_sph == 1
            m = ([col(rot[:, i, j]) for i in range(3) for j in range(3)],
                 [_swap_mask(rot[:, i, 0], rot[:, i, 1], dev) if const else None
                  for i in range(3)])
        trans = tuple(col(w2o[:, i, 3]) for i in range(3))
        clip_mask = torch.as_tensor(clip[None], device=trans[0].device) if clip.any() else None
        return m, trans, tuple(col(c) for c in consts), clip_mask

    # -- triangles --------------------------------------------------------

    @staticmethod
    def _tri_terms(o, d, cols):
        """Moller-Trumbore for every (ray, triangle) of a block: (ok but for
        the t_max test, t, b0, b1), each [N, P]."""
        ox, oy, oz = (o[:, i:i + 1] for i in range(3))
        dx, dy, dz = (d[:, i:i + 1] for i in range(3))
        p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, det_swap, t_swap = cols
        pvx = _diff_of_products(dy, e2z, dz, e2y)
        pvy = _diff_of_products(dz, e2x, dx, e2z)
        pvz = _diff_of_products(dx, e2y, dy, e2x)
        det = _dot3(e1x, e1y, e1z, pvx, pvy, pvz, det_swap)
        nz = torch.abs(det) > 1e-12
        inv_det = torch.where(nz, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        b0 = _dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv_det
        qvx = _diff_of_products(tvy, e1z, tvz, e1y)
        qvy = _diff_of_products(tvz, e1x, tvx, e1z)
        qvz = _diff_of_products(tvx, e1y, tvy, e1x)
        b1 = _dot3(dx, dy, dz, qvx, qvy, qvz) * inv_det
        tt = _dot3(e2x, e2y, e2z, qvx, qvy, qvz, t_swap) * inv_det
        ok = nz & (b0 >= 0.0) & (b1 >= 0.0) & (b0 + b1 <= 1.0) & (tt > RAY_EPS)
        return ok, tt, b0, b1

    # -- spheres ----------------------------------------------------------

    @staticmethod
    def _sph_terms(o, d, block):
        """Per (ray, sphere) of a block: (has, t_near, t_far, clip_near,
        clip_far); the clips are None where no sphere of the block clips."""
        m, (tx, ty, tz), (r2, zlo, zhi, phi_hi), clip_mask = block
        ox, oy, oz = (o[:, i:i + 1] for i in range(3))
        dx, dy, dz = (d[:, i:i + 1] for i in range(3))
        if m is None:
            oox, ooy, ooz = ox + tx, oy + ty, oz + tz
            odx, ody, odz = dx, dy, dz
        else:
            (m0, m1, m2, m3, m4, m5, m6, m7, m8), (s0, s1, s2) = m
            oox = _dot3(m0, m1, m2, ox, oy, oz, s0) + tx
            ooy = _dot3(m3, m4, m5, ox, oy, oz, s1) + ty
            ooz = _dot3(m6, m7, m8, ox, oy, oz, s2) + tz
            odx = _dot3(m0, m1, m2, dx, dy, dz, s0)
            ody = _dot3(m3, m4, m5, dx, dy, dz, s1)
            odz = _dot3(m6, m7, m8, dx, dy, dz, s2)
        a = _dot3(odx, ody, odz, odx, ody, odz)
        b = 2.0 * _dot3(oox, ooy, ooz, odx, ody, odz)
        c = _dot3(oox, ooy, ooz, oox, ooy, ooz) - r2
        disc = _diff_of_products(b, b, 4 * a, c)
        has = disc >= 0.0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        t0 = q / torch.where(a == 0, 1.0, a)
        t1 = c / torch.where(q == 0, 1.0, q)
        t_near = torch.minimum(t0, t1)
        t_far = torch.maximum(t0, t1)
        if clip_mask is None:
            return has, t_near, t_far, None, None

        def clip_ok(t):
            pz = fma(odz, t, ooz)
            z_ok = (pz >= zlo) & (pz <= zhi)
            phi = torch.atan2(fma(ody, t, ooy), fma(odx, t, oox))
            phi = torch.where(phi < 0, phi + TWO_PI, phi)
            return ~clip_mask | (z_ok & (phi <= phi_hi))

        return has, t_near, t_far, clip_ok(t_near), clip_ok(t_far)

    @staticmethod
    def _sph_candidate(terms):
        """The sphere's first hit beyond RAY_EPS that survives the clip, inf
        where none (the reference's near-else-far choice; against a running
        best or t_max this equals its ``t < best`` tests, since t_near <=
        t_far)."""
        has, t_near, t_far, clip_near, clip_far = terms
        near = has & (t_near > RAY_EPS)
        far = has & (t_far > RAY_EPS)
        if clip_near is not None:
            near, far = near & clip_near, far & clip_far
        return torch.where(near, t_near, torch.where(far, t_far, torch.inf))

    # -- queries ----------------------------------------------------------

    def intersect(self, o, d, t_max):
        n = o.shape[0]
        dev = o.device
        best_t = torch.broadcast_to(t_max, (n,)).to(o.dtype)
        best_kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=dev)
        best_prim = torch.zeros((n,), dtype=torch.int32, device=dev)
        best_b0 = torch.zeros((n,), dtype=o.dtype, device=dev)
        best_b1 = torch.zeros((n,), dtype=o.dtype, device=dev)
        for lo, cols in self._tri:
            ok, tt, b0, b1 = self._tri_terms(o, d, cols)
            t_blk, k = _first_min(tt, ok)
            got = t_blk < best_t
            k = k[:, None]
            best_t = torch.where(got, t_blk, best_t)
            best_kind = torch.where(got, KIND_TRI, best_kind)
            best_prim = torch.where(got, (k[:, 0] + lo).to(torch.int32), best_prim)
            best_b0 = torch.where(got, b0.gather(1, k)[:, 0], best_b0)
            best_b1 = torch.where(got, b1.gather(1, k)[:, 0], best_b1)
        for lo, block in self._sph:
            cand = self._sph_candidate(self._sph_terms(o, d, block))
            t_blk, k = _first_min(cand, cand < torch.inf)
            got = t_blk < best_t
            best_t = torch.where(got, t_blk, best_t)
            best_kind = torch.where(got, KIND_SPHERE, best_kind)
            best_prim = torch.where(got, (k + lo).to(torch.int32), best_prim)
        return {"t": best_t, "hit": best_kind != KIND_NONE, "kind": best_kind,
                "prim": best_prim, "b0": best_b0, "b1": best_b1}

    def occluded(self, o, d, t_max):
        n = o.shape[0]
        tmax = torch.broadcast_to(t_max, (n,)).to(o.dtype)[:, None]
        hit = torch.zeros((n,), dtype=torch.bool, device=o.device)
        for _, cols in self._tri:
            ok, tt, _, _ = self._tri_terms(o, d, cols)
            hit = hit | (ok & (tt < tmax)).any(dim=1)
        for _, block in self._sph:
            # the candidate is under t_max exactly where the reference's
            # near or far test against t_max passes (t_near <= t_far)
            cand = self._sph_candidate(self._sph_terms(o, d, block))
            hit = hit | (cand < tmax).any(dim=1)
        return hit
