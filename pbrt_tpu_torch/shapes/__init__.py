"""Shapes: host-side construction into flat triangle tables and analytic
sphere records (numpy copy of ``pbrt_tpu/shapes/__init__.py``).

The device intersector knows two primitive kinds, spheres and
triangles; every other pbrt-v3 shape (disk, cylinder, cone, paraboloid,
hyperboloid, heightfield, plymesh, loopsubdiv, nurbs) becomes triangles
with analytic vertex normals at scene-build time, as in the reference.
Curves (``shapes/curve.py``) also carry per-corner tangents for the hair
BSDF.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

log = logging.getLogger("pbrt_tpu_torch")


@dataclass
class TriangleData:
    """Host SoA for a batch of triangles (world space)."""

    p0: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    n0: Optional[np.ndarray] = None  # shading normals (world), or None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None
    tan0: Optional[np.ndarray] = None  # curve tangents (world), hair shading
    tan1: Optional[np.ndarray] = None
    tan2: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        return len(self.p0)

    def areas(self) -> np.ndarray:
        c = np.cross(self.p1 - self.p0, self.p2 - self.p0)
        return 0.5 * np.linalg.norm(c, axis=-1)


@dataclass
class SphereData:
    """Host SoA for analytic spheres (object space plus transforms)."""

    o2w: np.ndarray  # [S, 4, 4] float64
    w2o: np.ndarray
    radius: np.ndarray
    z_min: np.ndarray
    z_max: np.ndarray
    phi_max: np.ndarray  # radians
    reverse_orientation: np.ndarray  # bool

    @property
    def count(self) -> int:
        return len(self.radius)


def concat_sphere_data(parts):
    """Concatenate SphereData batches (None when there are none)."""
    if not parts:
        return None
    return SphereData(*(np.concatenate([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(SphereData)))


def _mesh_from_params(params, o2w, reverse):
    """Triangle mesh from ``Shape "trianglemesh"`` params (pbrt-v3 §3.6)."""
    float_t = params.float_t
    indices = params.find_int("indices")
    pts = params.find_point3f("P")
    if indices is None or pts is None:
        log.error("trianglemesh missing 'indices' or 'P'; skipping")
        return None
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    pts_w = o2w.apply_p(pts, float_t)
    uv = params.find_point2f("uv")
    if uv is None:
        uv = params.find_point2f("st")
        if uv is None:
            fl = params.find_float("uv")
            if fl is None:
                fl = params.find_float("st")
            if fl is not None:
                uv = np.asarray(fl, dtype=float_t).reshape(-1, 2)
    normals = params.find_normal3f("N")
    if normals is not None:
        normals = o2w.apply_n(normals, float_t)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.where(norm == 0, 1.0, norm)
        if reverse:
            normals = -normals
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    if uv is not None:
        uv = np.asarray(uv, dtype=float_t)
        uv0, uv1, uv2 = uv[i0], uv[i1], uv[i2]
    else:
        t = len(idx)
        uv0 = np.tile(np.array([[0.0, 0.0]], dtype=float_t), (t, 1))
        uv1 = np.tile(np.array([[1.0, 0.0]], dtype=float_t), (t, 1))
        uv2 = np.tile(np.array([[1.0, 1.0]], dtype=float_t), (t, 1))
    return TriangleData(
        p0=pts_w[i0].astype(float_t),
        p1=pts_w[i1].astype(float_t),
        p2=pts_w[i2].astype(float_t),
        uv0=uv0,
        uv1=uv1,
        uv2=uv2,
        n0=normals[i0] if normals is not None else None,
        n1=normals[i1] if normals is not None else None,
        n2=normals[i2] if normals is not None else None,
    )


def _grid_triangles(pts_w, nrm_w, uvc, min_area, float_t):
    """Two triangles per grid cell, (i, j) row-major, corners (a, b, c)
    and (a, c, d) of the cell's quad a = (i, j), b = (i + 1, j),
    c = (i + 1, j + 1), d = (i, j + 1) (the reference's loop order);
    triangles of area <= ``min_area`` dropped."""
    nu, nv = pts_w.shape[0] - 1, pts_w.shape[1] - 1
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    quad = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
    corners = [[quad[k] for k in tri] for tri in ((0, 1, 2), (0, 2, 3))]

    def per_corner(arr, c):  # [nu, nv, 2 triangles, ...] -> [2 nu nv, ...]
        return np.stack([arr[tri[c]] for tri in corners], axis=2).reshape(
            -1, arr.shape[-1]).astype(float_t)

    td = TriangleData(**{f"{k}{c}": per_corner(arr, c)
                         for k, arr in (("p", pts_w), ("uv", uvc), ("n", nrm_w))
                         for c in range(3)})
    keep = td.areas() > min_area
    if not keep.all():
        td = TriangleData(**{f.name: getattr(td, f.name)[keep]
                             for f in dataclasses.fields(TriangleData)
                             if getattr(td, f.name) is not None})
    return td


def _grid_mesh(o2w, reverse, pz_fn, nrm_fn, nu, nv, u_range, v_range, float_t):
    """Tessellate a parametric surface (u, v) -> (point, normal) on an
    nu x nv grid of cells, in the policy's float ``float_t``."""
    us = np.linspace(u_range[0], u_range[1], nu + 1)
    vs = np.linspace(v_range[0], v_range[1], nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")  # [nu + 1, nv + 1]
    pts = pz_fn(uu, vv)
    nrm = nrm_fn(uu, vv)
    pts_w = o2w.apply_p(pts.reshape(-1, 3), float_t).reshape(nu + 1, nv + 1, 3)
    nrm_w = o2w.apply_n(nrm.reshape(-1, 3), float_t).reshape(nu + 1, nv + 1, 3)
    nn = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
    nrm_w = nrm_w / np.where(nn == 0, 1.0, nn)
    if reverse:
        nrm_w = -nrm_w
    u01 = (uu - u_range[0]) / (u_range[1] - u_range[0])
    v01 = (vv - v_range[0]) / (v_range[1] - v_range[0])
    return _grid_triangles(pts_w, nrm_w, np.stack([u01, v01], axis=-1), 1e-12, float_t)


TESS_U = 64
TESS_V = 32


def _heightfield(params, o2w, reverse):
    float_t = params.float_t
    nu = params.find_one_int("nu", 0)
    nv = params.find_one_int("nv", 0)
    pz = params.find_float("Pz")
    if nu <= 0 or nv <= 0 or pz is None:
        log.error("heightfield missing nu/nv/Pz")
        return None
    z = np.asarray(pz, dtype=float_t).reshape(nv, nu)

    def pfn(uu, vv):
        iu = np.clip((uu * (nu - 1)).astype(int), 0, nu - 1)
        iv = np.clip((vv * (nv - 1)).astype(int), 0, nv - 1)
        return np.stack([uu, vv, z[iv, iu]], axis=-1)

    def nfn(uu, vv):
        iu = np.clip((uu * (nu - 1)).astype(int), 0, nu - 2)
        iv = np.clip((vv * (nv - 1)).astype(int), 0, nv - 2)
        dzdu = (z[iv, iu + 1] - z[iv, iu]) * (nu - 1)
        dzdv = (z[iv + 1, iu] - z[iv, iu]) * (nv - 1)
        return np.stack([-dzdu, -dzdv, np.ones_like(dzdu)], axis=-1)

    return _grid_mesh(o2w, reverse, pfn, nfn, nu - 1, nv - 1, (0, 1), (0, 1), float_t)


def _quadric(name, params, o2w, reverse):
    """disk, cylinder, cone, paraboloid, hyperboloid -> TESS_U x TESS_V
    cells (the disk: TESS_U x 2) with their exact normals."""
    phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))
    v_range = (0, 1)
    if name == "disk":
        h = params.find_one_float("height", 0.0)
        radius = params.find_one_float("radius", 1.0)
        inner = params.find_one_float("innerradius", 0.0)

        def pfn(uu, vv):  # u: phi; v: radius from outer (0) to inner (1)
            r = radius + (inner - radius) * vv
            return np.stack([r * np.cos(uu), r * np.sin(uu), np.full_like(uu, h)], axis=-1)

        def nfn(uu, vv):
            return np.broadcast_to(np.array([0.0, 0.0, 1.0]), uu.shape + (3,)).copy()

        return _grid_mesh(o2w, reverse, pfn, nfn, TESS_U, 2, (0, phi_max), v_range,
                          params.float_t)
    if name == "cylinder":
        radius = params.find_one_float("radius", 1.0)
        z_min = params.find_one_float("zmin", -1.0)
        z_max = params.find_one_float("zmax", 1.0)

        def pfn(uu, vv):
            return np.stack([radius * np.cos(uu), radius * np.sin(uu),
                             z_min + vv * (z_max - z_min)], axis=-1)

        def nfn(uu, vv):
            return np.stack([np.cos(uu), np.sin(uu), np.zeros_like(uu)], axis=-1)
    elif name == "cone":
        radius = params.find_one_float("radius", 1.0)
        height = params.find_one_float("height", 1.0)
        v_range = (0, 1 - 1e-4)

        def pfn(uu, vv):
            r = radius * (1 - vv)
            return np.stack([r * np.cos(uu), r * np.sin(uu), vv * height], axis=-1)

        def nfn(uu, vv):  # normal of x^2 + y^2 = (r (1 - z / h))^2
            return np.stack([height * np.cos(uu), height * np.sin(uu),
                             np.full_like(uu, radius)], axis=-1)
    elif name == "paraboloid":
        radius = params.find_one_float("radius", 1.0)
        z_min = params.find_one_float("zmin", 0.0)
        z_max = params.find_one_float("zmax", 1.0)
        k = z_max / (radius * radius)
        v_range = (1e-4, 1)

        def pfn(uu, vv):
            z = z_min + vv * (z_max - z_min)
            r = np.sqrt(np.maximum(z / k, 0.0))
            return np.stack([r * np.cos(uu), r * np.sin(uu), z], axis=-1)

        def nfn(uu, vv):  # gradient of x^2 + y^2 - z / k
            z = z_min + vv * (z_max - z_min)
            r = np.sqrt(np.maximum(z / k, 1e-12))
            return np.stack([2 * r * np.cos(uu), 2 * r * np.sin(uu),
                             -np.full_like(uu, 1.0 / k)], axis=-1)
    else:  # hyperboloid: the line p1 -> p2 revolved around z
        p1 = params.find_one_point3f("p1", np.array([0.0, 0.0, 0.0]))
        p2 = params.find_one_point3f("p2", np.array([1.0, 1.0, 1.0]))

        def pfn(uu, vv):
            pr = p1[None, None] * (1 - vv[..., None]) + p2[None, None] * vv[..., None]
            x = pr[..., 0] * np.cos(uu) - pr[..., 1] * np.sin(uu)
            y = pr[..., 0] * np.sin(uu) + pr[..., 1] * np.cos(uu)
            return np.stack([x, y, pr[..., 2]], axis=-1)

        def nfn(uu, vv):
            eps = 1e-4
            p = pfn(uu, vv)
            return np.cross(pfn(uu + eps, vv) - p, pfn(uu, np.minimum(vv + eps, 1.0)) - p)

    return _grid_mesh(o2w, reverse, pfn, nfn, TESS_U, TESS_V, (0, phi_max), v_range,
                      params.float_t)


def make_shape(name: str, params, o2w, reverse: bool):
    """Build a shape -> TriangleData | SphereData | None (unknown names
    log an error and give None, as in the reference)."""
    if name == "trianglemesh":
        return _mesh_from_params(params, o2w, reverse)
    if name == "sphere":
        float_t = params.float_t
        radius = params.find_one_float("radius", 1.0)
        z_min = params.find_one_float("zmin", -radius)
        z_max = params.find_one_float("zmax", radius)
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))
        return SphereData(
            o2w=o2w.m[None].astype(np.float64),
            w2o=o2w.m_inv[None].astype(np.float64),
            radius=np.array([radius], dtype=float_t),
            z_min=np.array([np.clip(min(z_min, z_max), -radius, radius)], dtype=float_t),
            z_max=np.array([np.clip(max(z_min, z_max), -radius, radius)], dtype=float_t),
            phi_max=np.array([np.clip(phi_max, 0.0, 2.0 * np.pi)], dtype=float_t),
            reverse_orientation=np.array([reverse]),
        )
    if name == "plymesh":
        from pbrt_tpu_torch.shapes.plyread import mesh_from_ply

        return mesh_from_ply(params, o2w, reverse)
    if name == "heightfield":
        return _heightfield(params, o2w, reverse)
    if name in ("disk", "cylinder", "cone", "paraboloid", "hyperboloid"):
        return _quadric(name, params, o2w, reverse)
    if name == "loopsubdiv":
        from pbrt_tpu_torch.shapes.loopsubdiv import loop_subdivide

        return loop_subdivide(params, o2w, reverse)
    if name == "nurbs":
        from pbrt_tpu_torch.shapes.nurbs import make_nurbs

        return make_nurbs(params, o2w, reverse)
    if name == "curve":
        from pbrt_tpu_torch.shapes.curve import make_curve

        return make_curve(params, o2w, reverse)
    log.error("Shape '%s' unknown.", name)
    return None


def concat_triangle_data(parts):
    """Concatenate TriangleData batches, densifying missing normals."""
    parts = [p for p in parts if p is not None and p.count > 0]
    if not parts:
        return None

    def normals_of(td):
        if td.n0 is not None:
            return td.n0, td.n1, td.n2
        ng = np.cross(td.p1 - td.p0, td.p2 - td.p0)
        n = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.where(n == 0, 1.0, n)
        return ng, ng, ng

    n0s, n1s, n2s = zip(*(normals_of(p) for p in parts))

    def tangents_of(td):
        # a zero tangent marks "not a curve"; hair lanes never read these
        if td.tan0 is not None:
            return td.tan0, td.tan1, td.tan2
        z = np.zeros_like(td.p0)
        return z, z, z

    has_tan = any(p.tan0 is not None for p in parts)
    t0s = t1s = t2s = None
    if has_tan:
        t0s, t1s, t2s = zip(*(tangents_of(p) for p in parts))
    return TriangleData(
        p0=np.concatenate([p.p0 for p in parts]),
        p1=np.concatenate([p.p1 for p in parts]),
        p2=np.concatenate([p.p2 for p in parts]),
        uv0=np.concatenate([p.uv0 for p in parts]),
        uv1=np.concatenate([p.uv1 for p in parts]),
        uv2=np.concatenate([p.uv2 for p in parts]),
        n0=np.concatenate(n0s),
        n1=np.concatenate(n1s),
        n2=np.concatenate(n2s),
        tan0=np.concatenate(t0s) if has_tan else None,
        tan1=np.concatenate(t1s) if has_tan else None,
        tan2=np.concatenate(t2s) if has_tan else None,
    )
