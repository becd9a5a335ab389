"""Samplers: deterministic, stateless sample generators (counterpart of
``pbrt_tpu/samplers/__init__.py``).

Every value is a pure function of (pixel, sample index, dimension), so a
port and the reference draw bit-equal samples for the same lanes:
``random`` (counter hashes), ``stratified`` (jittered strata, a hashed
permutation per dimension past the film's two), ``halton``
(Cranley-Patterson rotated radical inverses), ``sobol`` /
``lowdiscrepancy`` (Owen-scrambled Sobol'), ``02sequence`` (Sobol'
dimensions 0 and 1 reused per 2D pair) and ``maxmindist`` (the (0,2)
sampler, as in the reference).
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import torch

from pbrt_tpu_torch.core.lowdiscrepancy import (
    owen_scramble_u32,
    scrambled_radical_inverse,
    sobol_matrices,
    sobol_sample_u32,
    u32_to_unit_float,
)
from pbrt_tpu_torch.core.rng import MASK32, hash_combine, hash_u32, mul32, pcg3d, u32_to_float

log = logging.getLogger("pbrt_tpu_torch")


def _pixel_code(pixel_xy):
    """Mix pixel (x, y) into one uint32 key (held in int64)."""
    x = pixel_xy[..., 0].to(torch.int64) & MASK32
    y = pixel_xy[..., 1].to(torch.int64) & MASK32
    return hash_u32(mul32(x, 0x9E3779B1) ^ ((y + 0x85EBCA77) & MASK32))


class Sampler:
    """get(pixel_xy [N, 2] int, sample_index [N] int, dim) -> [N] float32
    under either float policy (``float_t``, which sets only the cap of
    ``core/rng.u32_to_float``), as in the reference."""

    # static promise that every sample index passed in is < index_bound
    index_bound: int | None = None

    def __init__(self, samples_per_pixel: int, seed: int = 0, float_t=np.float32):
        self.samples_per_pixel = int(samples_per_pixel)
        self.seed = int(seed)
        self.float_t = float_t

    def bounded(self, index_bound: int):
        """View whose callers promise ``sample_index < index_bound``:
        values are unchanged, dead radical-inverse digits are skipped."""
        s = copy.copy(self)
        s.index_bound = int(index_bound)
        return s

    def _hash_u(self, pixel_xy, idx, dim: int):
        """Uniform [0, 1) from the pcg3d hash of (pixel, sample, dim)."""
        a, _, _ = pcg3d(_pixel_code(pixel_xy) ^ (self.seed & MASK32), idx,
                        torch.full_like(idx, dim))
        return u32_to_float(a, self.float_t)

    def get(self, pixel_xy, sample_index, dim: int):
        raise NotImplementedError

    def get2(self, pixel_xy, sample_index, dim: int):
        return torch.stack(
            [self.get(pixel_xy, sample_index, dim), self.get(pixel_xy, sample_index, dim + 1)],
            dim=-1,
        )


class RandomSampler(Sampler):
    """Counter-based uniform randoms (pcg3d of pixel, sample and dim)."""

    def get(self, pixel_xy, sample_index, dim: int):
        return self._hash_u(pixel_xy, sample_index.to(torch.int64) & MASK32, dim)


class StratifiedSampler(Sampler):
    """Jittered strata: an xsamples x ysamples grid over the film's two
    dimensions, 1D strata under a hashed per-(pixel, dim) permutation of
    the sample index past them."""

    def __init__(self, xsamples=4, ysamples=4, jitter=True, seed: int = 0,
                 float_t=np.float32):
        super().__init__(xsamples * ysamples, seed, float_t)
        self.nx, self.ny = int(xsamples), int(ysamples)
        self.jitter = bool(jitter)

    def _permuted_index(self, pixel_xy, idx, dim):
        """Odd multiplier plus offset modulo n (a bijection for n a power
        of two), else an offset rotation."""
        n = self.samples_per_pixel
        h = hash_combine(_pixel_code(pixel_xy), dim + 0x51, self.seed & MASK32)
        if n & (n - 1) == 0 and n > 0:
            mult = ((h | 1) & (n - 1)) | 1
            return ((mul32(idx, mult) + (h >> 8)) & MASK32) % n
        return ((idx + h) & MASK32) % max(n, 1)

    def get(self, pixel_xy, sample_index, dim: int):
        idx = sample_index.to(torch.int64) & MASK32
        u = self._hash_u(pixel_xy, idx, dim) if self.jitter else 0.5
        if dim in (0, 1):
            if dim == 0:
                return torch.clamp(((idx % self.nx).to(torch.float32) + u) / self.nx,
                                   max=0.99999994)
            sy = ((idx // self.nx) % self.ny).to(torch.float32)
            return torch.clamp((sy + u) / self.ny, max=0.99999994)
        s = self._permuted_index(pixel_xy, idx, dim).to(torch.float32)
        return torch.clamp((s + u) / self.samples_per_pixel, max=0.99999994)


class HaltonSampler(Sampler):
    """Randomized-QMC Halton: dimension d uses the d-th prime base with a
    per-(pixel, dim) Cranley-Patterson rotation; dimensions past
    ``QMC_DIM_LIMIT`` use counter hashes (see the reference's notes)."""

    QMC_DIM_LIMIT = 20

    def get(self, pixel_xy, sample_index, dim: int):
        idx = sample_index.to(torch.int64) & MASK32
        if dim >= self.QMC_DIM_LIMIT:
            return self._hash_u(pixel_xy, idx, dim)
        d = dim % 1024
        rot = u32_to_float(hash_combine(_pixel_code(pixel_xy), d, self.seed & MASK32),
                           self.float_t)
        return scrambled_radical_inverse(d, idx, rot, self.index_bound)


class SobolSampler(Sampler):
    """Owen-scrambled Sobol' with a per-(pixel, dim) scramble seed."""

    def __init__(self, samples_per_pixel: int, seed: int = 0, float_t=np.float32):
        super().__init__(samples_per_pixel, seed, float_t)
        self._v = sobol_matrices()

    def _scrambled(self, pixel_xy, sample_index, row: int, key: int):
        idx = sample_index.to(torch.int64) & MASK32
        bits = sobol_sample_u32(idx, self._v[row])
        seed = hash_combine(_pixel_code(pixel_xy), key, self.seed & MASK32)
        return u32_to_unit_float(owen_scramble_u32(bits, seed))

    def get(self, pixel_xy, sample_index, dim: int):
        d = dim % self._v.shape[0]
        return self._scrambled(pixel_xy, sample_index, d, d + 1)


class ZeroTwoSequenceSampler(SobolSampler):
    """(0,2)-sequence: Sobol' dimensions 0 and 1 reused for every 2D pair,
    each pair under scrambles of its own."""

    def get(self, pixel_xy, sample_index, dim: int):
        pair_dim, pair_id = dim % 2, dim // 2
        return self._scrambled(pixel_xy, sample_index, pair_dim, pair_id * 2 + pair_dim + 7)


class MaxMinDistSampler(ZeroTwoSequenceSampler):
    """pbrt's maxmindist matrices are chosen (0,2) variants; as in the
    reference, this is the Owen-scrambled (0,2) sampler."""


def make_sampler(name: str, params, seed: int = 0) -> Sampler:
    """Factory per pbrt-v3 MakeSampler names; unknown names take Halton,
    as the reference does.  The parameters' float is the sampler's policy."""
    spp = params.find_one_int("pixelsamples", 16)
    ft = params.float_t
    if name == "random":
        return RandomSampler(spp, seed, ft)
    if name == "stratified":
        return StratifiedSampler(params.find_one_int("xsamples", 4),
                                 params.find_one_int("ysamples", 4),
                                 params.find_one_bool("jitter", True), seed, ft)
    if name == "halton":
        return HaltonSampler(spp, seed, ft)
    if name in ("sobol", "lowdiscrepancy"):
        return SobolSampler(spp, seed, ft)
    if name == "02sequence":
        return ZeroTwoSequenceSampler(spp, seed, ft)
    if name == "maxmindist":
        return MaxMinDistSampler(spp, seed, ft)
    log.warning("Sampler '%s' unknown; using halton.", name)
    return HaltonSampler(spp, seed, ft)
