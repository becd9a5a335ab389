"""Texture coordinate mappings (counterpart of
``pbrt_tpu/textures/mapping.py``): each 2D mapping takes the SoA
interaction dict to (s, t) tensors [N]; ``TransformMapping3D`` gives
texture-space points [N, 3].  Matrices are kept on the host in the policy's float
and copied to a lane's device once."""

from __future__ import annotations

import logging

import numpy as np
import torch

from pbrt_tpu_torch import INV_2PI, INV_PI
from pbrt_tpu_torch.core.transform import apply_point

log = logging.getLogger("pbrt_tpu_torch")


class _OnDevice:
    """Host arrays in the policy's float ``float_t`` handed out as tensors,
    one copy per device."""

    def __init__(self, float_t, **arrays):
        self._host = {k: np.asarray(v, dtype=float_t) for k, v in arrays.items()}
        self._dev = {}

    def on(self, name, device):
        key = (name, device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self._host[name], device=device)
        return self._dev[key]


class UVMapping2D:
    """(u,v) scaled/offset: s = su*u + du, t = sv*v + dv."""

    def __init__(self, su=1.0, sv=1.0, du=0.0, dv=0.0):
        self.su, self.sv, self.du, self.dv = float(su), float(sv), float(du), float(dv)
        # scale of uv-space ray-differential footprints
        self.width_scale = max(abs(self.su), abs(self.sv))
        self.width_vec = (self.su, self.sv)

    def map(self, si):
        uv = si["uv"]
        return self.su * uv[..., 0] + self.du, self.sv * uv[..., 1] + self.dv


class TransformMapping3D:
    """World point -> texture-space point through ``world_to_texture``."""

    def __init__(self, world_to_texture, float_t=np.float32):
        self._m = _OnDevice(float_t, w2t=world_to_texture.m)

    def map(self, si):
        p = si["p"]
        return apply_point(self._m.on("w2t", p.device), p)


class SphericalMapping2D(TransformMapping3D):
    """(theta / pi, phi / 2pi) of the texture-space point's direction."""

    def map(self, si):
        p = super().map(si)
        vec = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-12)
        theta = torch.arccos(torch.clamp(vec[..., 2], -1.0, 1.0))
        phi = torch.atan2(vec[..., 1], vec[..., 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        return theta * INV_PI, phi * INV_2PI


class CylindricalMapping2D(TransformMapping3D):
    """(phi / 2pi, z) of the texture-space point."""

    def map(self, si):
        p = super().map(si)
        phi = torch.atan2(p[..., 1], p[..., 0])
        phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
        return phi * INV_2PI, p[..., 2]


class PlanarMapping2D:
    """(ds + p . vs, dt + p . vt) of the world point."""

    def __init__(self, vs, vt, ds=0.0, dt=0.0, float_t=np.float32):
        self._v = _OnDevice(float_t, vs=vs, vt=vt)
        self.ds, self.dt = float(ds), float(dt)

    def map(self, si):
        p = si["p"]
        return (self.ds + torch.sum(p * self._v.on("vs", p.device), dim=-1),
                self.dt + torch.sum(p * self._v.on("vt", p.device), dim=-1))


def mapping_from_params(tp, tex2world):
    """The 2D mapping named by the 'mapping' parameter (unknown names log
    an error and take uv, as in the reference)."""
    map_type = tp.find_string("mapping", "uv")
    if map_type == "uv":
        return UVMapping2D(
            tp.find_float("uscale", 1.0),
            tp.find_float("vscale", 1.0),
            tp.find_float("udelta", 0.0),
            tp.find_float("vdelta", 0.0),
        )
    if map_type == "spherical":
        return SphericalMapping2D(tex2world.inverse(), tp.float_t)
    if map_type == "cylindrical":
        return CylindricalMapping2D(tex2world.inverse(), tp.float_t)
    if map_type == "planar":
        return PlanarMapping2D(
            tp.find_vector3f("v1", np.array([1.0, 0.0, 0.0])),
            tp.find_vector3f("v2", np.array([0.0, 1.0, 0.0])),
            tp.find_float("udelta", 0.0),
            tp.find_float("vdelta", 0.0),
            tp.float_t,
        )
    log.error("2D texture mapping '%s' unknown", map_type)
    return UVMapping2D()
