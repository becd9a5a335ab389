"""Texture factories: parameter decoding per pbrt-v3 CreateXxxTexture
(counterpart of ``pbrt_tpu/textures/factories.py``).

Each factory takes (tex2world: Transform, tp: TextureParams, spectral)
and returns a texture object with a batched ``eval(si)``.
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.textures.checkerboard import Checkerboard3DTexture, CheckerboardTexture
from pbrt_tpu_torch.textures.constant import ConstantTexture
from pbrt_tpu_torch.textures.imagemap import ImageTexture
from pbrt_tpu_torch.textures.mapping import TransformMapping3D, mapping_from_params
from pbrt_tpu_torch.textures.mix import BilerpTexture, MixTexture
from pbrt_tpu_torch.textures.noise import (
    DotsTexture,
    FBmTexture,
    MarbleTexture,
    WindyTexture,
    WrinkledTexture,
)
from pbrt_tpu_torch.textures.scale import ScaleTexture
from pbrt_tpu_torch.textures.uv import UVTexture


def _get_tex(tp, name, default, spectral):
    if spectral:
        return tp.get_spectrum_texture(name, np.full(3, default, dtype=tp.float_t))
    return tp.get_float_texture(name, float(default))


def _constant(t2w, tp, spectral):
    if spectral:
        return ConstantTexture(tp.find_spectrum("value", np.ones(3, dtype=tp.float_t)), tp.float_t)
    return ConstantTexture(tp.find_float("value", 1.0), tp.float_t)


def _scale(t2w, tp, spectral):
    return ScaleTexture(_get_tex(tp, "tex1", 1.0, spectral), _get_tex(tp, "tex2", 1.0, False))


def _mix(t2w, tp, spectral):
    return MixTexture(_get_tex(tp, "tex1", 0.0, spectral), _get_tex(tp, "tex2", 1.0, spectral),
                      tp.get_float_texture("amount", 0.5))


def _bilerp(t2w, tp, spectral):
    mapping = mapping_from_params(tp, t2w)
    if spectral:
        corners = [tp.find_spectrum(n, np.zeros(3, dtype=tp.float_t))
                   for n in ("v00", "v01", "v10", "v11")]
    else:
        corners = [tp.find_float(n, 0.0) for n in ("v00", "v01", "v10", "v11")]
    return BilerpTexture(mapping, *corners, float_t=tp.float_t)


def _checkerboard(t2w, tp, spectral):
    dim = tp.find_int("dimension", 2)
    tex1 = _get_tex(tp, "tex1", 1.0, spectral)
    tex2 = _get_tex(tp, "tex2", 0.0, spectral)
    if dim == 3:
        return Checkerboard3DTexture(TransformMapping3D(t2w.inverse(), tp.float_t), tex1, tex2)
    tp.find_string("aamode", "closedform")  # the closed form is the only filter
    return CheckerboardTexture(mapping_from_params(tp, t2w), tex1, tex2)


def _dots(t2w, tp, spectral):
    return DotsTexture(mapping_from_params(tp, t2w), _get_tex(tp, "inside", 1.0, spectral),
                       _get_tex(tp, "outside", 0.0, spectral))


def _uv(t2w, tp, spectral):
    return UVTexture(mapping_from_params(tp, t2w))


def _imagemap(t2w, tp, spectral):
    filename = tp.find_filename("filename", "")
    return ImageTexture(
        mapping_from_params(tp, t2w), filename,
        do_trilinear=tp.find_bool("trilinear", False),
        max_aniso=tp.find_float("maxanisotropy", 8.0),
        wrap=tp.find_string("wrap", "repeat"),
        scale=tp.find_float("scale", 1.0),
        gamma=tp.find_bool("gamma", filename.lower().endswith((".png", ".tga"))),
        spectral=spectral, float_t=tp.float_t,
    )


def _fbm(t2w, tp, spectral):
    return FBmTexture(TransformMapping3D(t2w.inverse(), tp.float_t), tp.find_int("octaves", 8),
                      tp.find_float("roughness", 0.5))


def _wrinkled(t2w, tp, spectral):
    return WrinkledTexture(TransformMapping3D(t2w.inverse(), tp.float_t),
                           tp.find_int("octaves", 8),
                           tp.find_float("roughness", 0.5))


def _windy(t2w, tp, spectral):
    return WindyTexture(TransformMapping3D(t2w.inverse(), tp.float_t))


def _marble(t2w, tp, spectral):
    return MarbleTexture(TransformMapping3D(t2w.inverse(), tp.float_t), tp.find_int("octaves", 8),
                         tp.find_float("roughness", 0.5), tp.find_float("scale", 1.0),
                         tp.find_float("variation", 0.2), tp.float_t)


FACTORIES = {
    "constant": _constant,
    "scale": _scale,
    "mix": _mix,
    "bilerp": _bilerp,
    "imagemap": _imagemap,
    "uv": _uv,
    "checkerboard": _checkerboard,
    "dots": _dots,
    "fbm": _fbm,
    "wrinkled": _wrinkled,
    "marble": _marble,
    "windy": _windy,
}
