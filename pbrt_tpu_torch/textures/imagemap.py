"""Image texture backed by a MIPMap (counterpart of
``pbrt_tpu/textures/imagemap.py``).

The image is read and converted on the host when the texture is made
(inverse gamma for 8-bit formats, the scale, v flipped so that texture
t = 0 is the image's bottom row); lookups gather from the packed pyramid
over the wavefront.  In a spectral pass the texels' RGB becomes the
pass's three bins.  ``si["_tex"]`` (set by ``eval_material_params``
from ``theta["tex_images"]``) may replace the pyramid by a tensor keyed
by this texture's ``tex_id``: its texels are then gradient targets.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pbrt_tpu_torch import inverse_gamma_correct, torch_dtype
from pbrt_tpu_torch.core.imageio import read_image
from pbrt_tpu_torch.core.mipmap import WRAP_NAMES, WRAP_REPEAT, MIPMap
from pbrt_tpu_torch.core.spectrum import get_spectral_bins, promote_rgb

log = logging.getLogger("pbrt_tpu_torch")

# process-global ids, as in the reference (keys of theta["tex_images"])
_TEX_ID_COUNTER = [0]


class ImageTexture:
    def __init__(self, mapping, filename: str, do_trilinear=True, max_aniso=8.0,
                 wrap="repeat", scale=1.0, gamma=None, spectral=True, float_t=np.float32):
        self.mapping = mapping
        self.spectral = spectral
        self.tex_id = _TEX_ID_COUNTER[0]
        _TEX_ID_COUNTER[0] += 1
        try:
            img, _ = read_image(filename, float_t)
        except (OSError, ValueError) as e:
            log.error("Couldn't read image '%s' (%s); using constant 0.5", filename, e)
            img = np.full((1, 1, 3), 0.5, dtype=float_t)
        if gamma is None:
            gamma = filename.lower().endswith((".png", ".tga"))
        img = np.asarray(img, dtype=np.float64)
        if gamma:
            img = inverse_gamma_correct(img.astype(float_t), float_t).astype(np.float64)
        img = img * float(scale)
        if not spectral:
            img = img.mean(axis=-1, keepdims=True)
        elif get_spectral_bins() is not None:
            # a spectral pass: the linear texel RGB becomes the pass's bins
            img = promote_rgb(img, float_t=float_t).astype(np.float64)
        self.mipmap = MIPMap(img[::-1].astype(float_t), wrap=WRAP_NAMES.get(wrap, WRAP_REPEAT),
                             do_trilinear=do_trilinear, max_anisotropy=max_aniso, float_t=float_t)

    def eval(self, si):
        s, t = self.mapping.map(si)
        if self.mipmap.wrap == WRAP_REPEAT:
            s = s - torch.floor(s)
            t = t - torch.floor(t)
        flat = si.get("_tex", {}).get(self.tex_id)
        width = si.get("tex_width")
        if width is None:
            return self.mipmap.lookup(s, t, None, flat=flat)
        if not self.mipmap.do_trilinear and si.get("duvdx") is not None:
            wvec = torch.tensor(getattr(self.mapping, "width_vec", (1.0, 1.0)),
                                dtype=torch_dtype(self.mipmap.float_t), device=s.device)
            return self.mipmap.lookup_aniso(s, t, si["duvdx"] * wvec, si["duvdy"] * wvec,
                                            flat=flat)
        return self.mipmap.lookup(s, t, width * getattr(self.mapping, "width_scale", 1.0),
                                  flat=flat)
