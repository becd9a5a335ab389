"""Curve shape: Bezier and B-spline hair and fur, tessellated to triangles
at build time (copy of ``pbrt_tpu/shapes/curve.py``).

pbrt-v3 intersects ``Shape "curve"`` by recursive ray/Bezier splitting;
here, as in the reference, each curve becomes triangles with analytic
attributes and the one triangle intersector handles them.

Curve types:
- ``cylinder``: a tube swept along the spine with a rotation-minimizing
  frame (the double-reflection method, Wang et al. 2008), so the cross
  section never twists;
- ``ribbon``: a flat strip whose orientation interpolates the normals
  ``N``;
- ``flat``: pbrt turns the ribbon toward the ray at intersection time; a
  tube of diameter w shows the same width from every direction, so flat
  curves tessellate as cylinders.

Per-corner tangents (the curve direction) are stored beside the normals
(``TriangleData.tan0..2``) so the hair BSDF can recover the azimuthal
offset ``h`` at shading time.  uv: u is the global curve parameter in
[0, 1], v the azimuth fraction around the tube (across the ribbon).
"""

from __future__ import annotations

import logging

import numpy as np


log = logging.getLogger("pbrt_tpu_torch")


def bezier_eval(cp: np.ndarray, u: np.ndarray):
    """de Casteljau on control points cp [S, D+1, 3] at params u [U].

    Returns (points [S, U, 3], tangents [S, U, 3], unnormalized).
    """
    deg = cp.shape[1] - 1
    u = u.reshape(1, -1, 1)  # [1,U,1]
    pts = [cp[:, i : i + 1, :] for i in range(deg + 1)]  # each [S,1,3]
    # derivative control points
    dcp = [deg * (pts[i + 1] - pts[i]) for i in range(deg)]
    while len(pts) > 1:
        pts = [(1 - u) * pts[i] + u * pts[i + 1] for i in range(len(pts) - 1)]
    while len(dcp) > 1:
        dcp = [(1 - u) * dcp[i] + u * dcp[i + 1] for i in range(len(dcp) - 1)]
    return pts[0], dcp[0]


def _bspline_to_bezier(P: np.ndarray, degree: int) -> np.ndarray:
    """Uniform B-spline control points [N,3] -> Bezier segments [S,D+1,3]."""
    n = len(P)
    nseg = n - degree
    segs = np.empty((nseg, degree + 1, 3), dtype=np.float64)
    for s in range(nseg):
        if degree == 3:
            p0, p1, p2, p3 = P[s : s + 4]
            segs[s, 0] = (p0 + 4 * p1 + p2) / 6.0
            segs[s, 1] = (2 * p1 + p2) / 3.0
            segs[s, 2] = (p1 + 2 * p2) / 3.0
            segs[s, 3] = (p1 + 4 * p2 + p3) / 6.0
        else:  # degree 2
            p0, p1, p2 = P[s : s + 3]
            segs[s, 0] = (p0 + p1) / 2.0
            segs[s, 1] = p1
            segs[s, 2] = (p1 + p2) / 2.0
    return segs


def _rmf_frames(centers: np.ndarray, tangents: np.ndarray, n0: np.ndarray):
    """Rotation-minimizing frames via the double-reflection method.

    centers/tangents: [M,3] along the spine; n0: initial normal [3].
    Returns normals [M,3] (unit, perpendicular to tangents).
    """
    m = len(centers)
    t = tangents / np.maximum(np.linalg.norm(tangents, axis=-1, keepdims=True), 1e-12)
    r = np.empty((m, 3))
    # project n0 off t[0]
    r0 = n0 - np.dot(n0, t[0]) * t[0]
    nrm = np.linalg.norm(r0)
    if nrm < 1e-9:
        # pick any perpendicular
        a = np.array([1.0, 0.0, 0.0]) if abs(t[0][0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        r0 = np.cross(t[0], a)
        nrm = np.linalg.norm(r0)
    r[0] = r0 / nrm
    for i in range(m - 1):
        v1 = centers[i + 1] - centers[i]
        c1 = np.dot(v1, v1)
        if c1 < 1e-18:
            r[i + 1] = r[i]
            continue
        rl = r[i] - (2.0 / c1) * np.dot(v1, r[i]) * v1
        tl = t[i] - (2.0 / c1) * np.dot(v1, t[i]) * v1
        v2 = t[i + 1] - tl
        c2 = np.dot(v2, v2)
        rn = rl if c2 < 1e-18 else rl - (2.0 / c2) * np.dot(v2, rl) * v2
        rn = rn - np.dot(rn, t[i + 1]) * t[i + 1]
        r[i + 1] = rn / np.maximum(np.linalg.norm(rn), 1e-12)
    return r


def make_curve(params, o2w, reverse: bool):
    """``Shape "curve"`` -> TriangleData (pbrt-v3 param surface)."""
    from pbrt_tpu_torch.shapes import TriangleData

    P = params.find_point3f("P")
    if P is None:
        log.error("curve missing 'P'; skipping")
        return None
    P = np.asarray(P, dtype=np.float64).reshape(-1, 3)
    degree = params.find_one_int("degree", 3)
    if degree not in (2, 3):
        log.error("curve degree must be 2 or 3, got %d", degree)
        return None
    basis = params.find_one_string("basis", "bezier")
    ctype = params.find_one_string("type", "flat")
    w0 = params.find_one_float("width", 1.0)
    width0 = params.find_one_float("width0", w0)
    width1 = params.find_one_float("width1", w0)

    if basis == "bezier":
        if (len(P) - 1) % degree != 0:
            log.error("curve: bezier needs #P = n*degree + 1 (got %d)", len(P))
            return None
        nseg = (len(P) - 1) // degree
        segs = np.stack(
            [P[s * degree : s * degree + degree + 1] for s in range(nseg)]
        )
    elif basis == "bspline":
        if len(P) < degree + 1:
            log.error("curve: bspline needs at least degree+1 points")
            return None
        segs = _bspline_to_bezier(P, degree)
        nseg = len(segs)
    else:
        log.error("curve: unknown basis '%s'", basis)
        return None

    norms = params.find_normal3f("N")
    if ctype == "ribbon":
        if norms is None:
            log.error("curve type 'ribbon' requires 'N' normals")
            return None
        norms = np.asarray(norms, dtype=np.float64).reshape(-1, 3)
        if len(norms) != nseg + 1:
            log.error("curve: ribbon needs %d normals, got %d", nseg + 1, len(norms))
            return None

    # spine samples: nu per segment
    nu = max(2, params.find_one_int("tessellation", 8))
    us = np.linspace(0.0, 1.0, nu + 1)
    pts, tans = bezier_eval(segs, us)  # [S, nu+1, 3] each
    # chain segments into one [M,3] spine (dedupe shared endpoints)
    centers = [pts[0]]
    tangents = [tans[0]]
    for s in range(1, nseg):
        centers.append(pts[s, 1:])
        tangents.append(tans[s, 1:])
    centers = np.concatenate(centers)  # [M,3]
    tangents = np.concatenate(tangents)
    m = len(centers)
    u_glob = np.linspace(0.0, 1.0, m)
    widths = 0.5 * (width0 * (1 - u_glob) + width1 * u_glob)  # radius

    tl = np.linalg.norm(tangents, axis=-1, keepdims=True)
    # degenerate tangents (repeated control points): reuse neighbors
    for i in range(m):
        if tl[i] < 1e-12:
            tangents[i] = tangents[i - 1] if i > 0 else tangents[i + 1]
    tn = tangents / np.maximum(np.linalg.norm(tangents, axis=-1, keepdims=True), 1e-12)

    if ctype == "ribbon":
        # interpolate user normals along the spine, re-orthogonalized
        seg_of = np.clip((u_glob * nseg).astype(int), 0, nseg - 1)
        frac = u_glob * nseg - seg_of
        nrm = norms[seg_of] * (1 - frac[:, None]) + norms[seg_of + 1] * frac[:, None]
        nrm = nrm - np.sum(nrm * tn, axis=-1, keepdims=True) * tn
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        side = np.cross(tn, nrm)  # across the ribbon width
        # two triangles per spine step; both sides shaded (two-sided strip)
        v0 = centers - side * widths[:, None]
        v1 = centers + side * widths[:, None]
        p0s, p1s, p2s, n0s, n1s, n2s, uv0s, uv1s, uv2s = ([] for _ in range(9))
        t0s, t1s, t2s = [], [], []
        for i in range(m - 1):
            quad = [(v0[i], nrm[i], tn[i], u_glob[i], 0.0),
                    (v1[i], nrm[i], tn[i], u_glob[i], 1.0),
                    (v1[i + 1], nrm[i + 1], tn[i + 1], u_glob[i + 1], 1.0),
                    (v0[i + 1], nrm[i + 1], tn[i + 1], u_glob[i + 1], 0.0)]
            for tri in ((0, 1, 2), (0, 2, 3)):
                for dst_p, dst_n, dst_t, dst_uv, k in (
                    (p0s, n0s, t0s, uv0s, tri[0]),
                    (p1s, n1s, t1s, uv1s, tri[1]),
                    (p2s, n2s, t2s, uv2s, tri[2]),
                ):
                    pt, nn, tt, uu, vv = quad[k]
                    dst_p.append(pt); dst_n.append(nn); dst_t.append(tt)
                    dst_uv.append((uu, vv))
    else:
        # tube (cylinder, and flat-as-tube): RMF cross sections
        n_init = np.array([0.0, 0.0, 1.0])
        frames_n = _rmf_frames(centers, tn, n_init)
        frames_b = np.cross(tn, frames_n)
        nv = max(3, params.find_one_int("tessellation_v", 6))
        phis = np.linspace(0.0, 2 * np.pi, nv + 1)
        # ring vertices [M, nv+1, 3]
        cosp = np.cos(phis)[None, :, None]
        sinp = np.sin(phis)[None, :, None]
        ring_n = frames_n[:, None, :] * cosp + frames_b[:, None, :] * sinp
        ring_p = centers[:, None, :] + ring_n * widths[:, None, None]
        p0s, p1s, p2s, n0s, n1s, n2s, uv0s, uv1s, uv2s = ([] for _ in range(9))
        t0s, t1s, t2s = [], [], []
        for i in range(m - 1):
            for j in range(nv):
                quad = [(i, j), (i, j + 1), (i + 1, j + 1), (i + 1, j)]
                for tri in ((0, 1, 2), (0, 2, 3)):
                    for dst_p, dst_n, dst_t, dst_uv, k in (
                        (p0s, n0s, t0s, uv0s, tri[0]),
                        (p1s, n1s, t1s, uv1s, tri[1]),
                        (p2s, n2s, t2s, uv2s, tri[2]),
                    ):
                        a, b = quad[k]
                        dst_p.append(ring_p[a, b]); dst_n.append(ring_n[a, b])
                        dst_t.append(tn[a])
                        dst_uv.append((u_glob[a], b / nv))

    float_t = params.float_t
    p0 = o2w.apply_p(np.asarray(p0s), float_t)
    p1 = o2w.apply_p(np.asarray(p1s), float_t)
    p2 = o2w.apply_p(np.asarray(p2s), float_t)

    def xform_n(ns):
        nw = o2w.apply_n(np.asarray(ns), float_t)
        nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
        return -nw if reverse else nw

    def xform_t(ts):
        tw = o2w.apply_v(np.asarray(ts), float_t)
        tw /= np.maximum(np.linalg.norm(tw, axis=-1, keepdims=True), 1e-12)
        return tw

    td = TriangleData(
        p0=p0.astype(float_t), p1=p1.astype(float_t), p2=p2.astype(float_t),
        uv0=np.asarray(uv0s, dtype=float_t), uv1=np.asarray(uv1s, dtype=float_t),
        uv2=np.asarray(uv2s, dtype=float_t),
        n0=xform_n(n0s).astype(float_t), n1=xform_n(n1s).astype(float_t),
        n2=xform_n(n2s).astype(float_t),
        tan0=xform_t(t0s).astype(float_t), tan1=xform_t(t1s).astype(float_t),
        tan2=xform_t(t2s).astype(float_t),
    )
    keep = td.areas() > 1e-14
    if not keep.all():
        fields = ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2",
                  "tan0", "tan1", "tan2")
        td = TriangleData(*(getattr(td, f)[keep] for f in fields))
    return td
