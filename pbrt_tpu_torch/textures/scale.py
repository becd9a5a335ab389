"""Scale texture: tex1 * tex2 (counterpart of
``pbrt_tpu/textures/scale.py``)."""

from __future__ import annotations


class ScaleTexture:
    def __init__(self, tex1, tex2):
        self.tex1 = tex1
        self.tex2 = tex2

    def eval(self, si):
        a = self.tex1.eval(si)
        b = self.tex2.eval(si)
        if a.dim() < b.dim():  # a float against a spectrum
            a = a[..., None]
        elif b.dim() < a.dim():
            b = b[..., None]
        return a * b
