"""Monte-Carlo warps, the power heuristic, Distribution1D and
Distribution2D (counterpart of ``pbrt_tpu/core/sampling.py``), batched
over tensors.

The warps keep the reference's polynomial sin/cos (``fast_sincos``) so
that sampled directions agree with it to float32 rounding.  The
distributions' tables are built on the host in float64 and live on the
device in the policy's float (``float_t``), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch import PI, PI_OVER_2, PI_OVER_4

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

    def __init__(self, func, device, float_t=np.float32):
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
        x = (offset.to(self.cdf.dtype) + du) / self.n
        return x, pdf, offset


class Distribution2D:
    """Piecewise-constant 2D distribution over [0, 1]^2 of an [H, W]
    function: a marginal over rows and a conditional CDF per row (rows of
    zero sum fall back to a uniform CDF)."""

    def __init__(self, func2d, device, float_t=np.float32):
        f = np.maximum(np.asarray(func2d, dtype=np.float64), 0.0)
        h, w = f.shape
        self.h, self.w = h, w
        row_int = f.sum(axis=1) / w
        cond_cdf = np.concatenate([np.zeros((h, 1)), np.cumsum(f, axis=1)], axis=1)
        row_tot = cond_cdf[:, -1:].copy()
        cond_cdf = cond_cdf / np.where(row_tot == 0.0, 1.0, row_tot)
        cond_cdf[row_tot[:, 0] == 0.0] = np.linspace(0.0, 1.0, w + 1)
        marg = row_int
        marg_cdf = np.concatenate([[0.0], np.cumsum(marg)])
        tot = marg_cdf[-1]
        if tot == 0.0:
            marg_cdf = np.linspace(0.0, 1.0, h + 1)
            marg = np.full(h, 1.0 / h)
            self.func_int = 1e-20
        else:
            marg_cdf = marg_cdf / tot
            self.func_int = tot / h

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a).astype(float_t), device=device)

        self.func = dev(f.reshape(-1))  # row-major [H * W]
        self.row_int = dev(np.maximum(row_int, 0.0))
        self.cond_cdf = dev(cond_cdf.reshape(-1))  # row-major [H * (W + 1)]
        self.marg_cdf = dev(marg_cdf)
        self.marg_func = dev(marg)
        # the reference's fixed bisection depth into a row CDF
        self.n_steps = max(1, int(np.ceil(np.log2(w + 1))) + 1)

    def sample_continuous(self, u):
        """u [..., 2] -> ((u, v) in [0, 1]^2 [..., 2], pdf [...])."""
        u0 = u[..., 0]
        u1 = u[..., 1]
        row = torch.clamp(
            torch.searchsorted(self.marg_cdf, u1.contiguous(), right=True) - 1, 0, self.h - 1
        )
        mc0 = self.marg_cdf[row]
        mc1 = self.marg_cdf[row + 1]
        dv = torch.where(mc1 > mc0, (u1 - mc0) / torch.where(mc1 == mc0, 1.0, mc1 - mc0), 0.0)
        pdf_v = self.marg_func[row] / max(self.func_int, 1e-20)
        v = (row.to(self.marg_cdf.dtype) + dv) / self.h
        # per-lane bisection into the lane's row CDF: [N] gathers per
        # step, never an [N, W] matrix
        base = row * (self.w + 1)
        lo = torch.zeros_like(row)
        hi = torch.full_like(row, self.w)
        for _ in range(self.n_steps):
            mid = (lo + hi) // 2
            below = self.cond_cdf[base + mid] <= u0
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        col = torch.clamp(lo, 0, self.w - 1)
        cc0 = self.cond_cdf[base + col]
        cc1 = self.cond_cdf[base + col + 1]
        du = torch.where(cc1 > cc0, (u0 - cc0) / torch.where(cc1 == cc0, 1.0, cc1 - cc0), 0.0)
        pdf_u = self.func[row * self.w + col] / torch.clamp(self.row_int[row], min=1e-20)
        uu = (col.to(self.marg_cdf.dtype) + du) / self.w
        return torch.stack([uu, v], dim=-1), pdf_u * pdf_v

    def pdf_at(self, uv):
        col = torch.clamp((uv[..., 0] * self.w).to(torch.int32), 0, self.w - 1).long()
        row = torch.clamp((uv[..., 1] * self.h).to(torch.int32), 0, self.h - 1).long()
        return self.func[row * self.w + col] / max(self.func_int, 1e-20)
