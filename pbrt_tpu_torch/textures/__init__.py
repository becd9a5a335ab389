"""Textures evaluated over a whole wavefront (counterpart of
``pbrt_tpu/textures``).

``eval(si)`` takes the SoA interaction dict of tensors and returns [N]
floats or [N, 3] spectra.  The factory knows the constant, (2D)
checkerboard and imagemap kinds; the other nine wait for ROADMAP Queue 1
item 8.
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch import float_t
from pbrt_tpu_torch.textures.checkerboard import CheckerboardTexture
from pbrt_tpu_torch.textures.constant import ConstantTexture
from pbrt_tpu_torch.textures.imagemap import ImageTexture
from pbrt_tpu_torch.textures.mapping import mapping_from_params


def _get_tex(tp, name, default, spectral):
    if spectral:
        return tp.get_spectrum_texture(name, np.full(3, default, dtype=float_t))
    return tp.get_float_texture(name, float(default))


def _make_texture(name, tex2world, tp, spectral: bool):
    if name == "constant":
        if spectral:
            return ConstantTexture(tp.find_spectrum("value", np.ones(3, dtype=float_t)))
        return ConstantTexture(tp.find_float("value", 1.0))
    if name == "checkerboard" and tp.find_int("dimension", 2) == 2:
        tex1 = _get_tex(tp, "tex1", 1.0, spectral)
        tex2 = _get_tex(tp, "tex2", 0.0, spectral)
        tp.find_string("aamode", "closedform")
        return CheckerboardTexture(mapping_from_params(tp, tex2world), tex1, tex2)
    if name == "imagemap":
        filename = tp.find_filename("filename", "")
        return ImageTexture(
            mapping_from_params(tp, tex2world), filename,
            do_trilinear=tp.find_bool("trilinear", False),
            max_aniso=tp.find_float("maxanisotropy", 8.0),
            wrap=tp.find_string("wrap", "repeat"),
            scale=tp.find_float("scale", 1.0),
            gamma=tp.find_bool("gamma", filename.lower().endswith((".png", ".tga"))),
            spectral=spectral,
        )
    raise NotImplementedError(
        f"texture '{name}' is not ported yet (ROADMAP.md Queue 1 item 8); "
        "only 'constant', 2D 'checkerboard' and 'imagemap' are"
    )


def make_float_texture(name, tex2world, tp):
    return _make_texture(name, tex2world, tp, spectral=False)


def make_spectrum_texture(name, tex2world, tp):
    return _make_texture(name, tex2world, tp, spectral=True)
