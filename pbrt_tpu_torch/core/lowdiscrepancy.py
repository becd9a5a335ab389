"""Low-discrepancy sequences (counterpart of
``pbrt_tpu/core/lowdiscrepancy.py``): radical inverses for the Halton
sampler and base-2 Sobol' with Owen scrambling for the Sobol', (0,2) and
maxmindist samplers.

Pure functions of (index, base or dimension); indices are uint32 values
carried in int64 tensors (see ``core/rng.py``).  The digit loop
reproduces the reference's arithmetic step for step — ``scale`` is a
float32 running product and each digit is added as one fused
``val + digit * scale`` — so values are bit-equal.

The Sobol' direction numbers are generated, not read: the reference
derives primitive polynomials over GF(2) and draws the free odd initial
values from a seeded PCG32, and caches the table under
``pbrt_tpu/data/``.  This module runs its own copy of that generator
(about half a second, once per process) and keeps the [1024, 32] table
in memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pbrt_tpu_torch.core.rng import MASK32, Rng, mul32


def _sieve(n: int) -> np.ndarray:
    is_p = np.ones(n, dtype=bool)
    is_p[:2] = False
    for i in range(2, int(n**0.5) + 1):
        if is_p[i]:
            is_p[i * i :: i] = False
    return np.nonzero(is_p)[0]


PRIMES = _sieve(8200)[:1024].astype(np.int64)  # >= 1024 prime bases


def _max_digits(base: int) -> int:
    """Digits needed to exhaust a 32-bit index in ``base``."""
    return int(math.ceil(32.0 / math.log2(base))) + 1


def _reverse_bits32(v):
    v = ((v >> 16) | (v << 16)) & 0xFFFFFFFF
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    return ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)


def radical_inverse(base_index: int, n, index_bound: int | None = None):
    """Radical inverse of uint32 ``n`` (int64 tensor) in the
    ``base_index``-th prime base -> float32 tensor."""
    base = int(PRIMES[base_index])
    if base == 2:
        return _reverse_bits32(n).to(torch.float32) * 2.3283064365386963e-10
    inv_base = np.float32(1.0 / base)
    digits = _max_digits(base)
    if index_bound is not None and index_bound >= 1:
        # n < index_bound has only ceil(log_base(bound)) nonzero digits:
        # the value is identical, the loop shorter
        k, p = 1, base
        while p < index_bound and k < digits:
            p *= base
            k += 1
        digits = k
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    scale = np.float32(1.0)
    rem = n
    for _ in range(digits):
        # XLA's CPU code fuses ``val + digit * scale`` into one fma; the
        # float64 sum of the exact product, rounded once, gives its bits
        digit = (rem % base).to(torch.float64)
        scale = np.float32(scale * inv_base)
        val = (val.to(torch.float64) + digit * float(scale)).to(torch.float32)
        rem = rem // base
    return torch.clamp(val, max=0.99999994)


def scrambled_radical_inverse(base_index: int, n, rotation, index_bound=None):
    """Cranley-Patterson rotated radical inverse; rotation in [0, 1)."""
    u = radical_inverse(base_index, n, index_bound) + rotation
    return torch.where(u >= 1.0, u - 1.0, u)


# --- Sobol' -------------------------------------------------------------

N_SOBOL_DIMENSIONS = 1024
SOBOL_BITS = 32


def _primitive_polynomials(count: int):
    """The first ``count`` primitive polynomials over GF(2), by degree, as
    (degree, low bits with the leading term implicit).  A degree-d
    polynomial is primitive iff x has order 2^d - 1 modulo it."""

    def polymul_mod(a, b, p, d):
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> d & 1:
                a ^= p | (1 << d)
        return r

    def prime_factors(n):
        fs, f = set(), 2
        while f * f <= n:
            while n % f == 0:
                fs.add(f)
                n //= f
            f += 1
        if n > 1:
            fs.add(n)
        return fs

    def x_pow(e, p, d):
        result, base = 1, 2  # 'x'
        while e:
            if e & 1:
                result = polymul_mod(result, base, p, d)
            base = polymul_mod(base, base, p, d)
            e >>= 1
        return result

    out = []
    degree = 1
    while len(out) < count:
        order = (1 << degree) - 1
        factors = prime_factors(order) if order > 1 else set()
        for low in range(1, 1 << degree, 2):  # the constant term is 1
            if degree > 1 and (x_pow(order, low, degree) != 1 or any(
                    x_pow(order // q, low, degree) == 1 for q in factors)):
                continue
            out.append((degree, low))
            if len(out) == count:
                break
        degree += 1
    return out


def _generate_sobol_matrices(n_dims: int = N_SOBOL_DIMENSIONS) -> np.ndarray:
    """[n_dims, 32] uint32 direction vectors (MSB-aligned), the
    reference's generator: dimension 0 is van der Corput, then one
    primitive polynomial per dimension with odd initial m_i drawn from
    ``Rng(0x5B01)``."""
    v = np.zeros((n_dims, SOBOL_BITS), dtype=np.uint64)
    for i in range(SOBOL_BITS):
        v[0, i] = 1 << (31 - i)
    rng = Rng(0x5B01)
    for j, (d, low_bits) in enumerate(_primitive_polynomials(n_dims - 1), start=1):
        m = [0] * (SOBOL_BITS + 1)
        for i in range(1, d + 1):
            m[i] = 2 * rng.uniform_u32_threshold(max(1, 1 << (i - 1))) + 1
        a = [(low_bits >> (d - 1 - k)) & 1 for k in range(d - 1)]
        for i in range(d + 1, SOBOL_BITS + 1):
            val = m[i - d] ^ ((1 << d) * m[i - d])
            for k in range(1, d):
                if a[k - 1]:
                    val ^= (1 << k) * m[i - k]
            m[i] = val
        for i in range(1, SOBOL_BITS + 1):
            v[j, i - 1] = m[i] << (32 - i)
    return v.astype(np.uint32)


_SOBOL_V = None


def sobol_matrices() -> np.ndarray:
    """Direction vectors [1024, 32] uint32, generated once per process."""
    global _SOBOL_V
    if _SOBOL_V is None:
        _SOBOL_V = _generate_sobol_matrices()
    return _SOBOL_V


def sobol_sample_u32(index, dim_matrix):
    """Sobol' sample bits: the XOR of the direction vectors ``dim_matrix``
    ([32] uint32, host) at the set bits of ``index`` ([N] uint32 in
    int64)."""
    acc = torch.zeros_like(index)
    for i in range(SOBOL_BITS):
        bit = ((index >> i) & 1).bool()
        acc = acc ^ torch.where(bit, int(dim_matrix[i]), 0)
    return acc


def owen_scramble_u32(x, seed):
    """Laine-Karras-style Owen scrambling of MSB-aligned sample bits ``x``
    with the per-lane uint32 ``seed`` (the reference's hash constants)."""
    v = _reverse_bits32(x)
    v = (v + seed) & MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        v = v ^ mul32(v, c)
    return _reverse_bits32(v)


def u32_to_unit_float(bits):
    """uint32 (in int64) -> [0, 1) float32."""
    return torch.clamp(bits.to(torch.float32) * 2.3283064365386963e-10, max=0.99999994)
