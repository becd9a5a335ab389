"""Constant texture (counterpart of ``pbrt_tpu/textures/constant.py``)."""

from __future__ import annotations

import numpy as np
import torch


class ConstantTexture:
    """Returns its value (in the policy's float ``float_t``) for every lane;
    value may be scalar or RGB."""

    def __init__(self, value, float_t=np.float32):
        self.value = np.asarray(value, dtype=float_t)

    @property
    def spectral(self) -> bool:
        return self.value.ndim > 0 and self.value.shape[-1] == 3

    def eval(self, si):
        ref = si["uv"] if "uv" in si else si["p"]
        v = torch.as_tensor(self.value, device=ref.device)
        if self.spectral:
            return v.reshape(-1)[:3].expand(ref.shape[0], 3)
        return v.reshape(()).expand(ref.shape[0])
