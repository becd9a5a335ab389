"""Texture coordinate mappings (counterpart of
``pbrt_tpu/textures/mapping.py``).  Only the (u, v) mapping is ported;
spherical, cylindrical and planar wait for ROADMAP Queue 1 item 8."""

from __future__ import annotations


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


def mapping_from_params(tp, tex2world):
    map_type = tp.find_string("mapping", "uv")
    if map_type == "uv":
        return UVMapping2D(
            tp.find_float("uscale", 1.0),
            tp.find_float("vscale", 1.0),
            tp.find_float("udelta", 0.0),
            tp.find_float("vdelta", 0.0),
        )
    raise NotImplementedError(
        f"texture mapping '{map_type}' is not ported yet (ROADMAP.md Queue 1 "
        "item 8); only 'uv' is"
    )
