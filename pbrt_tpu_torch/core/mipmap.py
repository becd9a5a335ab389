"""MIPMap: an image pyramid with filtered lookups over a wavefront
(counterpart of ``pbrt_tpu/core/mipmap.py``).

The pyramid is built on the host (power-of-two resample with a tent
filter, 2x2 box downsampling) and packed into one flat [texels, C] table
with per-level (offset, width, height), so one gather serves every
level.  The tables are copied to a device the first time a lookup runs
there.

Every lookup takes ``flat``: a tensor of the packed table's shape that
replaces it.  Passing one that requires grad makes the texels gradient
targets (``CompiledScene.initial_theta()["tex_images"]``); the gather's
backward is a scatter-add.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch import torch_dtype

WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2

WRAP_NAMES = {"repeat": WRAP_REPEAT, "black": WRAP_BLACK, "clamp": WRAP_CLAMP}

EWA_LUT_SIZE = 128
_EWA_ALPHA = 2.0
# alpha = 2 Gaussian weights of the anisotropic taps (rounded to the
# pyramid's float at use)
EWA_WEIGHT_LUT = (np.exp(-_EWA_ALPHA * (np.arange(EWA_LUT_SIZE, dtype=np.float64)
                                       / (EWA_LUT_SIZE - 1)))
                  - np.exp(-_EWA_ALPHA))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _resample_pow2(img: np.ndarray) -> np.ndarray:
    """Resize [H, W, C] to power-of-two sides by linear interpolation at
    the new sample centres."""
    h, w, _ = img.shape
    nw, nh = _next_pow2(w), _next_pow2(h)

    def resample_axis(a, new_n, axis):
        old_n = a.shape[axis]
        if old_n == new_n:
            return a
        x = (np.arange(new_n) + 0.5) * old_n / new_n - 0.5
        x0 = np.clip(np.floor(x).astype(int), 0, old_n - 1)
        x1 = np.clip(x0 + 1, 0, old_n - 1)
        shape = [1] * a.ndim
        shape[axis] = new_n
        t = np.clip(x - x0, 0.0, 1.0).reshape(shape)
        return (1 - t) * np.take(a, x0, axis=axis) + t * np.take(a, x1, axis=axis)

    return resample_axis(resample_axis(img, nh, 0), nw, 1)


class MIPMap:
    """Image pyramid of 1 (float texture) or 3 (spectrum texture) channels,
    its texels in the policy's float ``float_t``."""

    def __init__(self, image: np.ndarray, wrap: int = WRAP_REPEAT,
                 do_trilinear: bool = True, max_anisotropy: float = 8.0, float_t=np.float32):
        img = np.asarray(image, dtype=np.float64)
        if img.ndim == 2:
            img = img[..., None]
        img = _resample_pow2(img)
        self.wrap = wrap
        self.do_trilinear = do_trilinear
        self.max_anisotropy = max_anisotropy
        self.channels = img.shape[-1]
        self.float_t = float_t
        levels = [img]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            prev = levels[-1]
            h, w = prev.shape[:2]
            nh, nw = max(1, h // 2), max(1, w // 2)
            levels.append(prev[:nh * 2, :nw * 2].reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3)))
        self.n_levels = len(levels)
        self.sizes = [(lv.shape[1], lv.shape[0]) for lv in levels]  # (w, h)
        offsets = np.cumsum([0] + [w * h for w, h in self.sizes[:-1]])
        #: the packed pyramid [texels, C] on the host
        self._flat = torch.as_tensor(np.concatenate(
            [lv.reshape(-1, self.channels) for lv in levels]).astype(float_t))
        self._host = {
            "offsets": torch.as_tensor(offsets.astype(np.int64)),
            "widths": torch.as_tensor(np.array([s[0] for s in self.sizes], np.int64)),
            "heights": torch.as_tensor(np.array([s[1] for s in self.sizes], np.int64)),
        }
        self._on = {}  # device -> the tables there

    def flat_on(self, device):
        """The packed pyramid on ``device``."""
        return self._tables(torch.device(device))["flat"]

    def _tables(self, device):
        if device not in self._on:
            self._on[device] = {k: v.to(device) for k, v in
                                dict(self._host, flat=self._flat).items()}
        return self._on[device]

    def _wrap_coords(self, i, n):
        if self.wrap == WRAP_REPEAT:
            return torch.remainder(i, n), None
        if self.wrap == WRAP_CLAMP:
            return torch.minimum(torch.clamp(i, min=0), n - 1), None
        valid = (i >= 0) & (i < n)
        return torch.minimum(torch.clamp(i, min=0), n - 1), valid

    def _texel(self, tb, level, s_idx, t_idx, src):
        """Texels at integer coordinates of per-lane levels [N]."""
        w = tb["widths"][level]
        h = tb["heights"][level]
        si, s_ok = self._wrap_coords(s_idx, w)
        ti, t_ok = self._wrap_coords(t_idx, h)
        tex = src[tb["offsets"][level] + ti * w + si]
        if s_ok is None:
            return tex
        return torch.where((s_ok & t_ok)[..., None], tex, 0.0)

    def _bilerp(self, tb, level, s, t, src):
        """Bilinear lookup at continuous (s, t) in [0, 1] of levels [N]."""
        fs = s * tb["widths"][level].to(torch_dtype(self.float_t)) - 0.5
        ft = t * tb["heights"][level].to(torch_dtype(self.float_t)) - 0.5
        s0 = torch.floor(fs)
        t0 = torch.floor(ft)
        ds = (fs - s0)[..., None]
        dt = (ft - t0)[..., None]
        s0 = s0.to(torch.int64)
        t0 = t0.to(torch.int64)
        return ((1 - ds) * (1 - dt) * self._texel(tb, level, s0, t0, src)
                + (1 - ds) * dt * self._texel(tb, level, s0, t0 + 1, src)
                + ds * (1 - dt) * self._texel(tb, level, s0 + 1, t0, src)
                + ds * dt * self._texel(tb, level, s0 + 1, t0 + 1, src))

    def _level(self, width):
        level = self.n_levels - 1 + torch.log2(torch.clamp(width, min=1e-8))
        level = torch.clamp(level, 0.0, self.n_levels - 1 - 1e-4)
        l0 = torch.floor(level)
        return l0.to(torch.int64), (level - l0)[..., None]

    def lookup(self, s, t, width=None, flat=None):
        """Trilinear lookup; ``width`` is the per-lane filter footprint in
        [0, 1] texture space (None: the finest level)."""
        tb = self._tables(s.device)
        src = tb["flat"] if flat is None else flat
        if width is None:
            out = self._bilerp(tb, torch.zeros(s.shape, dtype=torch.int64, device=s.device),
                               s, t, src)
        else:
            l0, dl = self._level(width)
            l1 = torch.clamp(l0 + 1, max=self.n_levels - 1)
            out = (1 - dl) * self._bilerp(tb, l0, s, t, src) + dl * self._bilerp(
                tb, l1, s, t, src)
        return out[..., 0] if self.channels == 1 else out

    def lookup_aniso(self, s, t, duvdx, duvdy, flat=None, taps=4):
        """Anisotropic lookup: ``taps`` trilinear samples along the major
        axis of the footprint (duvdx, duvdy [N, 2]) weighted by the EWA
        table, the level chosen from the minor axis (clamped by
        ``max_anisotropy``)."""
        tb = self._tables(s.device)
        src = tb["flat"] if flat is None else flat
        lx = torch.linalg.norm(duvdx, dim=-1)
        ly = torch.linalg.norm(duvdy, dim=-1)
        major = torch.where((lx >= ly)[..., None], duvdx, duvdy)
        major_len = torch.maximum(lx, ly)
        minor_len = torch.maximum(torch.minimum(lx, ly), major_len / self.max_anisotropy)
        l0, dl = self._level(minor_len)
        l1 = torch.clamp(l0 + 1, max=self.n_levels - 1)
        acc = 0.0
        wsum = 0.0
        for i in range(taps):
            f = (i + 0.5) / taps - 0.5  # fixed offsets in [-0.5, 0.5)
            r2 = min((2.0 * f) ** 2, 1.0)
            w = float(self.float_t(EWA_WEIGHT_LUT[int(r2 * (EWA_LUT_SIZE - 1))]))
            ss = s + major[..., 0] * f
            tt = t + major[..., 1] * f
            val = (1 - dl) * self._bilerp(tb, l0, ss, tt, src) + dl * self._bilerp(
                tb, l1, ss, tt, src)
            acc = acc + w * val
            wsum = wsum + w
        out = acc / wsum
        return out[..., 0] if self.channels == 1 else out
