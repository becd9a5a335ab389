"""PCG32 pseudo-random numbers and counter-based integer hashes
(counterpart of ``pbrt_tpu/core/rng.py``).

* :class:`Rng`: the stateful host PCG32 on numpy uint64, bit-exact with
  the reference's (and pbrt-v3's golden vectors, ``tests/test_rng.py``);
  it draws the Sobol' generator's free parameters.
* The hashes the samplers and the noise textures draw from.

PyTorch has no usable uint32 arithmetic (add, multiply, shift, compare
and remainder are missing on the CPU), so every uint32 quantity is
carried in an ``int64`` tensor holding a value in [0, 2^32) and masked
with ``& MASK32`` after each wrapping step.  Products go through
:func:`mul32`, which splits the multiplier into 16-bit halves so that
no intermediate leaves the int64 range; results are bit-equal to the
reference's uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch import one_minus_epsilon

MASK32 = 0xFFFFFFFF


def mul32(a, b):
    """(a * b) mod 2^32 for uint32 values carried in int64 (either may be
    a Python int)."""
    b_lo = b & 0xFFFF
    b_hi = (b >> 16) & 0xFFFF
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & MASK32


PCG32_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
PCG32_DEFAULT_STREAM = np.uint64(0xDA3E39CB94B95BDB)
PCG32_MULT = np.uint64(0x5851F42D4C957F2D)


class Rng:
    """Stateful host PCG32 generator (the reference's ``Rng``)."""

    def __init__(self, sequence_index: int | None = None):
        self.state = PCG32_DEFAULT_STATE
        self.inc = PCG32_DEFAULT_STREAM
        if sequence_index is not None:
            self.set_sequence(sequence_index)

    def set_sequence(self, sequence_index: int) -> None:
        """Reset the state for stream ``sequence_index``."""
        with np.errstate(over="ignore"):
            self.state = np.uint64(0)
            self.inc = np.uint64(((int(sequence_index) << 1) | 1) & 0xFFFFFFFFFFFFFFFF)
            self.uniform_u32()
            self.state = np.uint64(self.state + PCG32_DEFAULT_STATE)
            self.uniform_u32()

    def uniform_u32(self) -> int:
        """Next uint32, uniform over [0, 2^32)."""
        with np.errstate(over="ignore"):
            old = self.state
            self.state = np.uint64(old * PCG32_MULT + self.inc)
            xorshifted = int(np.uint32(((old >> np.uint64(18)) ^ old) >> np.uint64(27)))
            rot = int(old >> np.uint64(59))
            return ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & MASK32

    def uniform_u32_threshold(self, b: int) -> int:
        """Debiased bounded sample over [0, b)."""
        threshold = ((~b + 1) & MASK32) % b
        while True:
            r = self.uniform_u32()
            if r >= threshold:
                return r % b


def u32_to_float(bits, float_t=np.float32):
    """uint32 (in int64) -> float32 in [0, 1), as ``rng.rs:89-93``, capped
    at the policy's ``one_minus_epsilon(float_t)`` rounded to float32
    (``pbrt_tpu/core/rng.py:191-192``): under the double policy that cap
    is 1 - 2^-53, which rounds to 1, so the top 128 bit patterns give 1.0
    there and 0.99999994 under float32."""
    f = bits.to(torch.float32) * 2.3283064365386963e-10
    return torch.clamp(f, max=float(np.float32(one_minus_epsilon(float_t))))


def hash_u32(x):
    """lowbias32 finalizer hash."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_combine(*xs):
    """Hash uint32 keys (int64 tensors or Python ints) into one uint32.

    The reference's ``h ^ x + C + (h << 6) + (h >> 2)`` parses as
    ``h ^ (x + C + (h << 6) + (h >> 2))``, each term wrapping mod 2^32.
    """
    h = 0x9E3779B9
    for x in xs:
        s = (x + 0x9E3779B9 + ((h << 6) & MASK32) + (h >> 2)) & MASK32
        h = hash_u32(torch.as_tensor(h ^ s, dtype=torch.int64))
    return h


def pcg3d(x, y, z):
    """pcg3d hash (Jarzynski & Olano 2020): 3 uint32 in, 3 uint32 out."""
    m, a = 1664525, 1013904223
    v0 = (mul32(x, m) + a) & MASK32
    v1 = (mul32(y, m) + a) & MASK32
    v2 = (mul32(z, m) + a) & MASK32
    v0 = (v0 + mul32(v1, v2)) & MASK32
    v1 = (v1 + mul32(v2, v0)) & MASK32
    v2 = (v2 + mul32(v0, v1)) & MASK32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v0 = (v0 + mul32(v1, v2)) & MASK32
    v1 = (v1 + mul32(v2, v0)) & MASK32
    v2 = (v2 + mul32(v0, v1)) & MASK32
    return v0, v1, v2
