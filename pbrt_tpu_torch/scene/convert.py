"""Carry device tables and scene parameters across from the reference.

A renderer has no weights, but it has device tables (``CompiledScene.
tables``, the packed BVH tables, light and material parameters).  The
reference's tables reach the port as numpy arrays (``np.asarray`` of
each JAX leaf) and become tensors here, so tests can check that the
port's own scene build produces the same tables and feed the reference's
tables straight into the port's kernel wrappers.
"""

from __future__ import annotations

import numpy as np
import torch


def tables_from_numpy(tables, device):
    """Nested dicts / lists of numpy arrays -> the same structure of
    tensors on ``device``; other leaves (flags, ints) pass through."""
    if isinstance(tables, dict):
        return {k: tables_from_numpy(v, device) for k, v in tables.items()}
    if isinstance(tables, (list, tuple)):
        return type(tables)(tables_from_numpy(v, device) for v in tables)
    if isinstance(tables, np.ndarray):
        return torch.tensor(tables, device=device)  # copies (JAX views are read-only)
    return tables


def theta_from_numpy(ref_theta, compiled, device):
    """The reference's theta (``CompiledScene.initial_theta()`` of
    ``pbrt_tpu``, its leaves as numpy arrays) -> the port's, on ``device``.

    Both packages key ``tex_images`` by a process-global counter, and the
    two counters drift apart in one process; textures are therefore
    matched by order: both parsers make a scene's textures in the same
    order, so the reference's keys in ascending order map to the ids of
    the port's image textures (``iter_entries_deep`` over ``compiled``'s
    materials) in ascending order."""
    from pbrt_tpu_torch.scene.builder import image_textures
    from pbrt_tpu_torch.textures.imagemap import ImageTexture

    out = {}
    for k, v in ref_theta.items():
        if k == "tex_images":
            ids = sorted({t.tex_id for t in image_textures(compiled.materials)
                          if isinstance(t, ImageTexture)})
            ref = [v[key] for key in sorted(v)]
            if len(ref) != len(ids):
                raise ValueError(f"theta_from_numpy: {len(ref)} reference textures, "
                                 f"{len(ids)} in the port's scene")
            out[k] = {i: torch.tensor(np.asarray(x), device=device) for i, x in zip(ids, ref)}
        elif isinstance(v, dict):
            out[k] = theta_from_numpy(v, compiled, device)
        else:
            out[k] = torch.tensor(np.asarray(v), device=device)
    return out
