"""Textures evaluated over a whole wavefront (counterpart of
``pbrt_tpu/textures``).

``eval(si)`` takes the SoA interaction dict of tensors and returns [N]
floats or [N, 3] spectra.  All twelve pbrt-v3 texture kinds are ported
(``factories.FACTORIES``); an unknown kind logs a warning and makes no
texture, as in the reference.
"""

from __future__ import annotations

import logging

log = logging.getLogger("pbrt_tpu_torch")


def _make_texture(name, tex2world, tp, spectral: bool):
    from pbrt_tpu_torch.textures.factories import FACTORIES

    fn = FACTORIES.get(name)
    if fn is None:
        log.warning("%s texture '%s' is unknown", "Spectrum" if spectral else "Float", name)
        return None
    return fn(tex2world, tp, spectral)


def make_float_texture(name, tex2world, tp):
    return _make_texture(name, tex2world, tp, spectral=False)


def make_spectrum_texture(name, tex2world, tp):
    return _make_texture(name, tex2world, tp, spectral=True)
