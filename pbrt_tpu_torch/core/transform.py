"""4x4 transforms: host construction (numpy copy of
``pbrt_tpu/core/transform.py``) plus batched application to tensors.

Host matrices are float64 numpy with a cached inverse; composition is
``(A*B)^-1 = B^-1 * A^-1`` (pbrt-v3, not the Rust reference's inverted
order).  :func:`apply_point` and :func:`apply_vector` apply one (4, 4)
tensor to ``[..., 3]`` tensors on its device.
"""

from __future__ import annotations

import numpy as np
import torch



class Transform:
    """A 4x4 matrix and its cached inverse (host)."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float64)
        m = np.asarray(m, dtype=np.float64).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m)
        else:
            m_inv = np.asarray(m_inv, dtype=np.float64).reshape(4, 4)
        self.m = m
        self.m_inv = m_inv

    @staticmethod
    def identity() -> "Transform":
        e = np.eye(4, dtype=np.float64)
        return Transform(e, e.copy())

    @staticmethod
    def translate(delta) -> "Transform":
        dx, dy, dz = (float(v) for v in delta)
        m = np.eye(4)
        m[0, 3], m[1, 3], m[2, 3] = dx, dy, dz
        mi = np.eye(4)
        mi[0, 3], mi[1, 3], mi[2, 3] = -dx, -dy, -dz
        return Transform(m, mi)

    @staticmethod
    def scale(sx, sy, sz) -> "Transform":
        m = np.diag([float(sx), float(sy), float(sz), 1.0])
        mi = np.diag([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0])
        return Transform(m, mi)

    @staticmethod
    def rotate(deg, axis) -> "Transform":
        """Axis-angle rotation, angle in degrees."""
        a = np.asarray(axis, dtype=np.float64)
        a = a / np.linalg.norm(a)
        theta = np.deg2rad(float(deg))
        s, c = np.sin(theta), np.cos(theta)
        m = np.eye(4)
        x, y, z = a
        m[0, 0] = x * x + (1 - x * x) * c
        m[0, 1] = x * y * (1 - c) - z * s
        m[0, 2] = x * z * (1 - c) + y * s
        m[1, 0] = x * y * (1 - c) + z * s
        m[1, 1] = y * y + (1 - y * y) * c
        m[1, 2] = y * z * (1 - c) - x * s
        m[2, 0] = x * z * (1 - c) - y * s
        m[2, 1] = y * z * (1 - c) + x * s
        m[2, 2] = z * z + (1 - z * z) * c
        return Transform(m, m.T.copy())

    @staticmethod
    def look_at(pos, look, up) -> "Transform":
        """World-to-camera from eye/target/up (pbrt-v3 LookAt)."""
        pos = np.asarray(pos, dtype=np.float64)
        look = np.asarray(look, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        dir_ = look - pos
        dir_ = dir_ / np.linalg.norm(dir_)
        upn = up / np.linalg.norm(up)
        right = np.cross(upn, dir_)
        nr = np.linalg.norm(right)
        if nr < 1e-12:
            raise ValueError("look_at: up vector parallel to viewing direction")
        right = right / nr
        new_up = np.cross(dir_, right)
        c2w = np.eye(4)
        c2w[0:3, 0] = right
        c2w[0:3, 1] = new_up
        c2w[0:3, 2] = dir_
        c2w[0:3, 3] = pos
        return Transform(np.linalg.inv(c2w), c2w)

    @staticmethod
    def orthographic(z_near, z_far) -> "Transform":
        """Orthographic projection (pbrt-v3 §6.2.1)."""
        return Transform.scale(1.0, 1.0, 1.0 / (z_far - z_near)) * Transform.translate(
            [0.0, 0.0, -z_near])

    @staticmethod
    def perspective(fov_deg, n, f) -> "Transform":
        """Perspective projection (pbrt-v3 §6.2.2)."""
        persp = np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, f / (f - n), -f * n / (f - n)],
                [0.0, 0.0, 1.0, 0.0],
            ]
        )
        inv_tan = 1.0 / np.tan(np.deg2rad(float(fov_deg)) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) * Transform(persp)

    @staticmethod
    def from_flat(vals) -> "Transform":
        """From 16 scene-file values (column-major, as pbrt-v3 reads them)."""
        return Transform(np.asarray(vals, dtype=np.float64).reshape(4, 4).T)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv.copy(), self.m.copy())

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def __eq__(self, other) -> bool:
        return isinstance(other, Transform) and np.allclose(self.m, other.m, atol=1e-10)

    def __repr__(self) -> str:
        return f"Transform({self.m.tolist()})"

    def apply_p(self, pts, float_t=np.float32):
        """Apply to host points [..., 3] (with homogeneous divide), in
        float64, rounded to the policy's float ``float_t``."""
        pts = np.asarray(pts, dtype=np.float64)
        xyz = pts @ self.m[:3, :3].T + self.m[:3, 3]
        w = pts @ self.m[3, :3].T + self.m[3, 3]
        w = np.where(w == 0.0, 1.0, w)
        return (xyz / w[..., None]).astype(float_t)

    def apply_v(self, vecs, float_t=np.float32):
        vecs = np.asarray(vecs, dtype=np.float64)
        return (vecs @ self.m[:3, :3].T).astype(float_t)

    def apply_n(self, normals, float_t=np.float32):
        normals = np.asarray(normals, dtype=np.float64)
        return (normals @ self.m_inv[:3, :3]).astype(float_t)


def _common(m, x):
    """m and x in their promoted float (a float32 sample direction meets a
    float64 matrix under the double policy, as the reference promotes)."""
    dt = torch.promote_types(m.dtype, x.dtype)
    return m.to(dt), x.to(dt)


def apply_point(m, p):
    """m: (4, 4) tensor; p: [..., 3] points."""
    m, p = _common(m, p)
    xyz = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    w = torch.where(w == 0.0, torch.ones_like(w), w)
    return xyz / w[..., None]


def apply_vector(m, v):
    m, v = _common(m, v)
    return v @ m[:3, :3].T

