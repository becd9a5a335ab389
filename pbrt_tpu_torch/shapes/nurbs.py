"""NURBS surface shape, evaluated and diced to triangles at build time
(copy of ``pbrt_tpu/shapes/nurbs.py``).

pbrt-v3's ``Shape "nurbs"`` itself tessellates the surface into a
triangle mesh at creation time (its nurbs.cpp dices a 30x30 grid and
emits a trianglemesh); doing the same here is exact parity, not an
approximation.  Evaluation is the standard Cox–de Boor recursion over
arbitrary knot vectors with rational (homogeneous ``Pw``) support; normals
come from the analytic cross product of the parametric derivatives.

Parameters (pbrt-v3): nu/nv, uorder/vorder, uknots/vknots, u0/u1/v0/v1,
and "P" (3-float) or "Pw" (homogeneous 4-float) control points.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("pbrt_tpu_torch")

DICE_U = 30  # pbrt-v3 nurbs.cpp dices 30x30
DICE_V = 30


def _find_span(knots: np.ndarray, order: int, n_ctrl: int, t: float) -> int:
    """Index i with knots[i] <= t < knots[i+1], clamped to valid spans."""
    lo, hi = order - 1, n_ctrl  # valid parameter range indices
    if t >= knots[hi]:
        return hi - 1
    i = int(np.searchsorted(knots, t, side="right") - 1)
    return min(max(i, lo), hi - 1)


def _basis_funs(knots: np.ndarray, order: int, span: int, t: float):
    """Nonzero basis functions N_{span-deg..span,deg}(t) + first derivatives.

    Cox–de Boor recursion by degree level; level q holds N_{span-q+r, q}
    for r = 0..q.  Derivatives use the standard formula
    N'_{i,p} = p/(k[i+p]-k[i]) N_{i,p-1} - p/(k[i+p+1]-k[i+1]) N_{i+1,p-1}.
    Returns (N [order], dN [order]).
    """
    deg = order - 1
    levels = [np.array([1.0])]
    for q in range(1, order):
        prev = levels[q - 1]
        cur = np.zeros(q + 1)
        for r in range(q + 1):
            i = span - q + r
            acc = 0.0
            if r > 0:
                denom = knots[i + q] - knots[i]
                if denom != 0:
                    acc += (t - knots[i]) / denom * prev[r - 1]
            if r < q:
                denom = knots[i + q + 1] - knots[i + 1]
                if denom != 0:
                    acc += (knots[i + q + 1] - t) / denom * prev[r]
            cur[r] = acc
        levels.append(cur)
    N = levels[deg]
    dN = np.zeros(order)
    if deg > 0:
        nm1 = levels[deg - 1]
        for r in range(order):
            i = span - deg + r
            d = 0.0
            if r > 0:
                denom = knots[i + deg] - knots[i]
                if denom != 0:
                    d += deg / denom * nm1[r - 1]
            if r < deg:
                denom = knots[i + deg + 1] - knots[i + 1]
                if denom != 0:
                    d -= deg / denom * nm1[r]
            dN[r] = d
    return N, dN


def nurbs_eval(uknots, vknots, uorder, vorder, Pw, u, v):
    """Evaluate a rational surface point + derivatives at (u, v).

    Pw: [nu, nv, 4] homogeneous control points.
    Returns (p [3], dpdu [3], dpdv [3]).
    """
    nu, nv = Pw.shape[0], Pw.shape[1]
    us = _find_span(uknots, uorder, nu, u)
    vs = _find_span(vknots, vorder, nv, v)
    Nu, dNu = _basis_funs(uknots, uorder, us, u)
    Nv, dNv = _basis_funs(vknots, vorder, vs, v)
    iu = us - (uorder - 1)
    iv = vs - (vorder - 1)
    ctrl = Pw[iu : iu + uorder, iv : iv + vorder]  # [uorder, vorder, 4]
    Sw = np.einsum("i,j,ijk->k", Nu, Nv, ctrl)
    dSw_du = np.einsum("i,j,ijk->k", dNu, Nv, ctrl)
    dSw_dv = np.einsum("i,j,ijk->k", Nu, dNv, ctrl)
    w = Sw[3] if abs(Sw[3]) > 1e-12 else 1e-12
    p = Sw[:3] / w
    dpdu = (dSw_du[:3] - p * dSw_du[3]) / w
    dpdv = (dSw_dv[:3] - p * dSw_dv[3]) / w
    return p, dpdu, dpdv


def make_nurbs(params, o2w, reverse: bool):
    """``Shape "nurbs"`` -> TriangleData."""
    from pbrt_tpu_torch.shapes import _grid_triangles

    nu = params.find_one_int("nu", -1)
    nv = params.find_one_int("nv", -1)
    uorder = params.find_one_int("uorder", -1)
    vorder = params.find_one_int("vorder", -1)
    uknots = params.find_float("uknots")
    vknots = params.find_float("vknots")
    if min(nu, nv, uorder, vorder) <= 0 or uknots is None or vknots is None:
        log.error("nurbs missing nu/nv/uorder/vorder/uknots/vknots")
        return None
    uknots = np.asarray(uknots, dtype=np.float64)
    vknots = np.asarray(vknots, dtype=np.float64)
    if len(uknots) != nu + uorder or len(vknots) != nv + vorder:
        log.error(
            "nurbs: need %d uknots / %d vknots, got %d / %d",
            nu + uorder, nv + vorder, len(uknots), len(vknots),
        )
        return None
    u0 = params.find_one_float("u0", float(uknots[uorder - 1]))
    u1 = params.find_one_float("u1", float(uknots[nu]))
    v0 = params.find_one_float("v0", float(vknots[vorder - 1]))
    v1 = params.find_one_float("v1", float(vknots[nv]))

    P = params.find_point3f("P")
    Pw_raw = params.find_float("Pw")
    if P is not None:
        P = np.asarray(P, dtype=np.float64).reshape(-1, 3)
        if len(P) != nu * nv:
            log.error("nurbs: need %d control points, got %d", nu * nv, len(P))
            return None
        Pw = np.concatenate([P, np.ones((len(P), 1))], axis=-1)
    elif Pw_raw is not None:
        Pw = np.asarray(Pw_raw, dtype=np.float64).reshape(-1, 4)
        if len(Pw) != nu * nv:
            log.error("nurbs: need %d Pw points, got %d", nu * nv, len(Pw))
            return None
        # already homogeneous: (x w, y w, z w, w), as pbrt-v3 reads it
    else:
        log.error("nurbs: missing 'P' or 'Pw'")
        return None
    # control points are v rows of nu (P[v * nu + u]): -> [nu, nv]
    Pw = Pw.reshape(nv, nu, 4).transpose(1, 0, 2)

    us = np.linspace(u0, u1, DICE_U + 1)
    vs = np.linspace(v0, v1, DICE_V + 1)
    pts = np.empty((DICE_U + 1, DICE_V + 1, 3))
    nrm = np.empty_like(pts)
    for i, uu in enumerate(us):
        for j, vv in enumerate(vs):
            p, du, dv = nurbs_eval(uknots, vknots, uorder, vorder, Pw, uu, vv)
            pts[i, j] = p
            n = np.cross(du, dv)
            ln = np.linalg.norm(n)
            nrm[i, j] = n / ln if ln > 1e-12 else np.array([0.0, 0.0, 1.0])

    pts_w = o2w.apply_p(pts.reshape(-1, 3), params.float_t).reshape(pts.shape)
    nrm_w = o2w.apply_n(nrm.reshape(-1, 3), params.float_t).reshape(nrm.shape)
    nn = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
    nrm_w = nrm_w / np.where(nn == 0, 1.0, nn)
    if reverse:
        nrm_w = -nrm_w
    u01 = (us - u0) / max(u1 - u0, 1e-12)
    v01 = (vs - v0) / max(v1 - v0, 1e-12)
    uvc = np.stack(np.meshgrid(u01, v01, indexing="ij"), axis=-1)

    return _grid_triangles(pts_w, nrm_w, uvc, 1e-14, params.float_t)
