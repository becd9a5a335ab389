"""Material table: pbrt material records -> per-lane BSDF parameters
(counterpart of ``pbrt_tpu/materials/__init__.py``).

Scene build produces a list of :class:`MaterialEntry`; at shading time
:func:`eval_material_params` evaluates each entry's textures across the
wavefront and mask-selects into SoA parameter tensors.  ``matte``,
``mirror`` and the emitter-only ``none`` are ported; every other material
raises (ROADMAP Queue 1 item 8).  The differentiable ``theta`` override waits
for the gradient slice (Queue 1 item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from pbrt_tpu_torch import float_t
from pbrt_tpu_torch.core.paramset import TextureParams
from pbrt_tpu_torch.materials import bsdf as B


@dataclass
class MaterialEntry:
    type_id: int
    textures: Dict[str, object] = field(default_factory=dict)  # slot -> Texture


def build_material(record) -> MaterialEntry:
    """MaterialRecord (core/api.py) -> MaterialEntry."""
    tp = TextureParams(
        record.params, record.params, record.float_textures, record.spectrum_textures
    )
    name = record.name
    if name in ("", "none"):
        return MaterialEntry(B.NONE)
    if name == "matte":
        return MaterialEntry(
            B.MATTE,
            {
                "kd": tp.get_spectrum_texture("Kd", np.full(3, 0.5, dtype=float_t)),
                "sigma": tp.get_float_texture("sigma", 0.0),
            },
        )
    if name == "mirror":
        return MaterialEntry(
            B.MIRROR, {"kr": tp.get_spectrum_texture("Kr", np.full(3, 0.9, dtype=float_t))}
        )
    raise NotImplementedError(
        f"Material '{name}' is not ported yet (ROADMAP.md Queue 1 item 8); "
        "only 'matte' and 'mirror' are"
    )


def eval_material_params(entries, mat_id, si):
    """Evaluate all material entries over the wavefront -> SoA params
    (the slots the ported lobes read: type, kd, kr, sigma).

    mat_id: [N] int32 indices into ``entries`` (-1 = background/none).
    """
    n = mat_id.shape[0]
    dev = mat_id.device
    params = {
        "type": torch.full((n,), B.NONE, dtype=torch.int32, device=dev),
        "kd": torch.zeros((n, 3), dtype=torch.float32, device=dev),
        "kr": torch.zeros((n, 3), dtype=torch.float32, device=dev),
        "sigma": torch.zeros((n,), dtype=torch.float32, device=dev),
        # static set of present material types: lobe code for absent
        # types is skipped
        "_active": frozenset(e.type_id for e in entries),
    }

    def put(slot, mask, val):
        m = mask[..., None] if params[slot].dim() == 2 else mask
        params[slot] = torch.where(m, val, params[slot])

    for k, e in enumerate(entries):
        mask = mat_id == k
        put("type", mask, torch.tensor(e.type_id, dtype=torch.int32, device=dev))
        for slot in ("kd", "kr"):
            tex = e.textures.get(slot)
            if tex is not None:
                v = tex.eval(si)
                if v.dim() == 1:
                    v = v[..., None] * torch.ones((1, 3), dtype=v.dtype, device=dev)
                put(slot, mask, v)
        stex = e.textures.get("sigma")
        if stex is not None:
            s = stex.eval(si)
            if s.dim() > 1:
                s = s.mean(dim=-1)
            put("sigma", mask, s)
    return params
