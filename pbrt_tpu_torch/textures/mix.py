"""Mix and bilerp textures (counterpart of ``pbrt_tpu/textures/mix.py``)."""

from __future__ import annotations

import numpy as np
import torch



class MixTexture:
    """lerp(amount, tex1, tex2).  As in the reference, only ``amount`` is
    lifted to a spectrum's shape: children of different shapes (a
    spectrum ``fbm``, which is [N], beside a [N, 3] one) do not
    broadcast (ROADMAP.md Queue 3)."""

    def __init__(self, tex1, tex2, amount):
        self.tex1 = tex1
        self.tex2 = tex2
        self.amount = amount

    def eval(self, si):
        t1 = self.tex1.eval(si)
        t2 = self.tex2.eval(si)
        amt = self.amount.eval(si)
        if t1.dim() > amt.dim():
            amt = amt[..., None]
        return (1.0 - amt) * t1 + amt * t2


class BilerpTexture:
    """Bilinear blend of four corner values (floats or RGB) over (s, t)."""

    def __init__(self, mapping, v00, v01, v10, v11, float_t=np.float32):
        self.mapping = mapping
        self.v = np.stack([np.asarray(x, dtype=float_t) for x in (v00, v01, v10, v11)])

    def eval(self, si):
        s, t = self.mapping.map(si)
        v00, v01, v10, v11 = torch.as_tensor(self.v, device=s.device)
        if v00.dim() > 0:
            s = s[..., None]
            t = t[..., None]
        return ((1 - s) * (1 - t) * v00 + (1 - s) * t * v01
                + s * (1 - t) * v10 + s * t * v11)
