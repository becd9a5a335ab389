"""UV debug texture: rgb = (s mod 1, t mod 1, 0) (counterpart of
``pbrt_tpu/textures/uv.py``)."""

from __future__ import annotations

import torch


class UVTexture:
    def __init__(self, mapping):
        self.mapping = mapping

    def eval(self, si):
        s, t = self.mapping.map(si)
        return torch.stack([s - torch.floor(s), t - torch.floor(t), torch.zeros_like(s)],
                           dim=-1)
