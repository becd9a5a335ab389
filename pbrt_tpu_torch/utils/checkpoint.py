"""Checkpoint / resume for long renders (counterpart of
``pbrt_tpu/utils/checkpoint.py``).

A checkpoint is the film accumulation state plus the sweep cursor (the
next lane chunk) and the render's meta.  Samplers are pure functions of
(pixel, sample, dim), so a resumed render continues with the sample
values the interrupted one would have drawn.
"""

from __future__ import annotations

import json
import os
import zipfile
from pathlib import Path

import numpy as np
import torch


def save_checkpoint(path, film_state, cursor: int, meta: dict | None = None) -> None:
    """Write the film state (as numpy arrays), the cursor and the meta to
    the npz ``path``, replacing it atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp,
        **{k: v.detach().cpu().numpy() for k, v in film_state.items()},
        cursor=np.int64(cursor),
        meta=json.dumps(meta or {}),
    )
    os.replace(tmp, path)


def load_checkpoint(path, device="cuda"):
    """(film state on ``device``, cursor, meta), or None where the file
    is missing or corrupt."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            state = {k: torch.as_tensor(z[k], device=device) for k in ("xyz", "weight")}
            cursor = int(z["cursor"])
            meta = json.loads(str(z["meta"]))
        return state, cursor, meta
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
