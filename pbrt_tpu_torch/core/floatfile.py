"""Whitespace/#-comment float-per-token file reader.

Copy of ``pbrt_tpu/core/floatfile.py`` (the Rust reference's
src/core/floatfile.rs:38-57, used for spectrum data files), without the
leftover debug prints (floatfile.rs:49-51).
"""

from __future__ import annotations

from typing import List

import numpy as np


class FloatFileError(ValueError):
    pass


def read_float_file(name: str, float_t=np.float32) -> List[float]:
    """The numbers of a text file (``#`` starts a comment), each rounded to
    the policy's float ``float_t``."""
    values: List[float] = []
    with open(name, "r") as f:
        for line_no, line in enumerate(f, start=1):
            hash_pos = line.find("#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            for tok in line.split():
                try:
                    # f32 overflow to inf is expected (floatfile.rs big.floats)
                    with np.errstate(over="ignore"):
                        values.append(float(float_t(tok)))
                except ValueError as e:
                    raise FloatFileError(
                        f"{name}:{line_no}: invalid float '{tok}'"
                    ) from e
    return values
