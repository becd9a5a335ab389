"""Checkerboard textures (counterpart of
``pbrt_tpu/textures/checkerboard.py``): the 2D one with pbrt's
closed-form box filter, and the 3D one over a texture-space point."""

from __future__ import annotations

import torch


def _bumpint(x):
    h = x * 0.5
    return torch.floor(h) + 2.0 * torch.clamp(h - torch.floor(h) - 0.5, min=0.0)


class CheckerboardTexture:
    """tex1 where floor(s) + floor(t) is even, else tex2; box-filtered
    over the ray-differential footprint ``si["tex_width"]`` when present."""

    def __init__(self, mapping, tex1, tex2):
        self.mapping = mapping
        self.tex1 = tex1
        self.tex2 = tex2

    def eval(self, si):
        s, t = self.mapping.map(si)
        v1 = self.tex1.eval(si)
        v2 = self.tex2.eval(si)
        width = si.get("tex_width")
        parity = (torch.floor(s) + torch.floor(t)).to(torch.int32) % 2
        mask = parity == 0
        if v1.dim() > mask.dim():
            mask = mask[..., None]
        point = torch.where(mask, v1, v2)
        if width is None:
            return point
        w = width * getattr(self.mapping, "width_scale", 1.0)
        s0, s1 = s - w, s + w
        t0, t1 = t - w, t + w
        two_w = torch.clamp(2.0 * w, min=1e-12)
        sint = (_bumpint(s1) - _bumpint(s0)) / two_w
        tint = (_bumpint(t1) - _bumpint(t0)) / two_w
        area2 = sint + tint - 2.0 * sint * tint  # fraction of odd checks
        area2 = torch.clamp(torch.where(w > 1.0, 0.5, area2), 0.0, 1.0)
        if v1.dim() > area2.dim():
            area2 = area2[..., None]
        filtered = (1.0 - area2) * v1 + area2 * v2
        use_filtered = w > 1e-9
        if v1.dim() > use_filtered.dim():
            use_filtered = use_filtered[..., None]
        return torch.where(use_filtered, filtered, point)


class Checkerboard3DTexture:
    """tex1 where floor(x) + floor(y) + floor(z) of the texture-space
    point is even, else tex2 (point-sampled)."""

    def __init__(self, mapping3d, tex1, tex2):
        self.mapping = mapping3d
        self.tex1 = tex1
        self.tex2 = tex2

    def eval(self, si):
        p = self.mapping.map(si)
        parity = (torch.floor(p[..., 0]) + torch.floor(p[..., 1])
                  + torch.floor(p[..., 2])).to(torch.int32) % 2
        v1 = self.tex1.eval(si)
        v2 = self.tex2.eval(si)
        mask = parity == 0
        if v1.dim() > mask.dim():
            mask = mask[..., None]
        return torch.where(mask, v1, v2)
