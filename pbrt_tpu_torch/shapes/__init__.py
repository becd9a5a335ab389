"""Shapes: host-side construction into flat triangle tables and analytic
sphere records (numpy copy of the triangle-mesh and sphere parts of
``pbrt_tpu/shapes/__init__.py``).

``trianglemesh`` and ``sphere`` are ported.  The tessellated quadrics,
PLY, Loop subdivision, curves and NURBS wait for ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

from pbrt_tpu_torch import float_t

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
    indices = params.find_int("indices")
    pts = params.find_point3f("P")
    if indices is None or pts is None:
        log.error("trianglemesh missing 'indices' or 'P'; skipping")
        return None
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    pts_w = o2w.apply_p(pts)
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
        normals = o2w.apply_n(normals)
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


def make_shape(name: str, params, o2w, reverse: bool):
    """Build a shape -> TriangleData | SphereData | None."""
    if name == "trianglemesh":
        return _mesh_from_params(params, o2w, reverse)
    if name == "sphere":
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
    raise NotImplementedError(
        f"Shape '{name}' is not ported yet (ROADMAP.md Queue 1 item 2); "
        "only 'trianglemesh' and 'sphere' are"
    )


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
    )
