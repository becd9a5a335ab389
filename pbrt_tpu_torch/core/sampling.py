"""Monte-Carlo warps, the power heuristic and Distribution1D (counterpart
of ``pbrt_tpu/core/sampling.py``), batched over tensors.

The warps keep the reference's polynomial sin/cos (``fast_sincos``) so
that sampled directions agree with it to float32 rounding.
Distribution2D (image-mapped environment lights) waits for ROADMAP Queue 1
item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch import PI, PI_OVER_2, PI_OVER_4, float_t

# Cephes sinf/cosf quarter-wave kernels (|r| <= pi/4, abs err ~1e-7)
_S3, _S5, _S7 = -1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4
_C4, _C6, _C8 = 4.166664568298827e-2, -1.388731625493765e-3, 2.443315711809948e-5


def fast_sincos(t):
    """(sin t, cos t) for |t| <= ~pi by quadrant folding."""
    q = torch.round(t * (2.0 / PI))
    r = t - q * (PI / 2)
    z = r * r
    sin_r = r * (1.0 + z * (_S3 + z * (_S5 + z * _S7)))
    cos_r = 1.0 + z * (-0.5 + z * (_C4 + z * (_C6 + z * _C8)))
    qi = q.to(torch.int32) & 3
    swap = (qi & 1) == 1
    s = torch.where(swap, cos_r, sin_r)
    c = torch.where(swap, sin_r, cos_r)
    s = torch.where((qi == 2) | (qi == 3), -s, s)
    c = torch.where((qi == 1) | (qi == 2), -c, c)
    return s, c


def concentric_sample_disk(u):
    """Shirley-Chiu concentric disk warp, branchless (pbrt-v3 §13.6.2)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    one = torch.ones_like(ox)
    theta = torch.where(
        use_x,
        PI_OVER_4 * (oy / torch.where(ox == 0.0, one, ox)),
        PI_OVER_2 - PI_OVER_4 * (ox / torch.where(oy == 0.0, one, oy)),
    )
    sth, cth = fast_sincos(theta)
    xy = torch.stack([r * cth, r * sth], dim=-1)
    return torch.where(zero[..., None], torch.zeros_like(xy), xy)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)


def sincos_2pi(u):
    """(sin 2 pi u, cos 2 pi u) for u in [0, 1) (periodic fold to [-pi, pi])."""
    return fast_sincos((u - torch.round(u)) * (2.0 * PI))


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    s, c = sincos_2pi(u[..., 1])
    return torch.stack([r * c, r * s, z], dim=-1)


def uniform_sample_triangle(u):
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Beta=2 power heuristic for MIS (pbrt-v3 §13.10.1).

    Where the squares overflow float32 (an area-light sample taken from a
    lane that escaped to t = 1e8 has a pdf near 1e22) the weight comes
    from the pdfs' ratio, where the reference's arithmetic gives inf / inf
    = NaN.  Such lanes are masked out of the radiance, but a NaN factor
    turns the zero gradient that reaches them into NaN."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    w = torch.where(denom > 0.0, f * f / safe, torch.zeros_like(denom))
    big = torch.isinf(denom)
    ratio = g / torch.where(big, f, torch.ones_like(f))
    return torch.where(big, 1.0 / (1.0 + ratio * ratio), w)


class Distribution1D:
    """Piecewise-constant 1D distribution over [0, 1]; the CDF table lives
    on ``device``."""

    def __init__(self, func, device):
        f = np.maximum(np.asarray(func, dtype=np.float64), 0.0)
        n = len(f)
        cdf = np.concatenate([[0.0], np.cumsum(f)])
        total = cdf[-1]
        if total == 0.0:
            cdf = np.linspace(0.0, 1.0, n + 1)
            f = np.full(n, 1.0 / n)
            self.func_int = 1.0 / n
        else:
            cdf = cdf / total
            self.func_int = total / n
        self.n = n
        self.func = torch.as_tensor(f.astype(float_t), device=device)
        self.cdf = torch.as_tensor(cdf.astype(float_t), device=device)

    def sample_continuous(self, u):
        """Returns (x in [0, 1], pdf, offset)."""
        offset = torch.clamp(
            torch.searchsorted(self.cdf, u.contiguous(), right=True) - 1, 0, self.n - 1
        )
        c0 = self.cdf[offset]
        c1 = self.cdf[offset + 1]
        pdf = self.func[offset] / max(self.func_int, 1e-20)
        width = torch.where(c1 == c0, torch.ones_like(c0), c1 - c0)
        du = torch.where(c1 > c0, (u - c0) / width, torch.zeros_like(u))
        x = (offset.to(torch.float32) + du) / self.n
        return x, pdf, offset
