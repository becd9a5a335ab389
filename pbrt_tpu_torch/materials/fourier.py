"""Fourier-basis measured or layered BSDF (pbrt-v3's ``fourier`` material;
counterpart of ``pbrt_tpu/materials/fourier.py``).

f(mu_i, mu_o, phi) = (1 / |mu_i|) sum_k a_k(mu_i, mu_o) cos(k phi), with
the coefficient vectors a_k stored per pair of zenith knots and blended
by a 4 x 4 Catmull-Rom stencil.

The host :class:`FourierTable` (numpy, a copy of the reference's) reads
and writes pbrt-v3's layerlab ``.bsdf`` files byte for byte (8-byte magic
"SCATFUN\\x01", int32 flags, nMu, nCoeffs, mMax, nChannels, nBases, 3
unused, float eta, 4 unused int32, then mu[nMu], cdf[nMu*nMu],
offset_and_length[2*nMu*nMu] int32 and a[nCoeffs] float32, little
endian), pads the ragged coefficient runs once into a dense
[nMu, nMu, nChannels, M] array (M = min(mMax, the order cap)), and
tabulates the zenith sampling density p(mu_i | mu_o) ~ a0_y on a fine
grid whose piecewise-linear CDF inverts in closed form.

The device functions evaluate a wavefront: two ``searchsorted``, a 4 x 4
weighted gather and one [N, M] contraction with cos(k phi); sampling
draws mu_i by a stochastic choice between two table rows (so the pdf,
an explicit two-row blend, is the density sampled) and phi from the
Fourier series by 16 trips of bisection-guarded Newton (pbrt's
SampleFourier without data-dependent exits).
"""

from __future__ import annotations

import logging
import struct

import numpy as np
import torch

from pbrt_tpu_torch import INV_PI, PI

log = logging.getLogger("pbrt_tpu_torch")

MAGIC = b"SCATFUN\x01"
DEFAULT_ORDER_CAP = 256


class FourierTable:
    """Host-side table: raw knot/coefficient storage + dense padded arrays."""

    def __init__(self, eta, mu, offset_and_length, a, m_max, n_channels,
                 order_cap=DEFAULT_ORDER_CAP):
        self.eta = float(eta)
        self.mu = np.asarray(mu, dtype=np.float64)
        self.n_mu = len(self.mu)
        self.m_max = int(m_max)
        self.n_channels = int(n_channels)
        m_used = min(self.m_max, order_cap)
        n = self.n_mu
        dense = np.zeros((n, n, self.n_channels, m_used), dtype=np.float32)
        dropped = 0.0
        total = 0.0
        oal = np.asarray(offset_and_length, dtype=np.int64).reshape(n * n, 2)
        for idx in range(n * n):
            off, m = oal[idx]
            if m == 0:
                continue
            run = np.asarray(a[off : off + m * self.n_channels], dtype=np.float64)
            run = run.reshape(self.n_channels, m)
            keep = min(m, m_used)
            dense[idx // n, idx % n, :, :keep] = run[:, :keep]
            total += np.abs(run).sum()
            dropped += np.abs(run[:, keep:]).sum()
        if total > 0 and dropped > 0:
            log.info(
                "fourier table: order capped at %d (%.3g%% coefficient mass dropped)",
                m_used, 100.0 * dropped / total,
            )
        self.a_dense = dense  # [nMu, nMu, C, M]
        self.m_used = m_used
        self._device_cache = {}
        self._build_sampling_tables()

    def _build_sampling_tables(self, n_o=128, n_i=512):
        """Tabulate the zenith sampling density p(mu_i | mu_o) ~ a0_y.

        a0_y (the k=0 luminance coefficient, which carries the azimuthal
        integral: int_0^{2pi} sum_k a_k cos(k phi) dphi = 2 pi a_0) is
        Catmull-Rom-resampled onto a fine uniform (mu_o, mu_i) grid; the
        trapezoid CDF over mu_i makes each row an exactly invertible
        piecewise-linear density.
        """
        a0 = self.a_dense[:, :, 0, 0].astype(np.float64)  # [i_knot, o_knot]
        g_i = np.linspace(-1.0, 1.0, n_i)
        g_o = np.linspace(-1.0, 1.0, n_o)
        w_i = _cr_weight_matrix_np(self.mu, g_i)  # [n_i, nMu]
        w_o = _cr_weight_matrix_np(self.mu, g_o)  # [n_o, nMu]
        A = (w_o @ a0.T @ w_i.T)  # [n_o, n_i]
        A = np.maximum(A, 0.0)
        # floor so no row is identically zero (sampling stays defined; the
        # pdf uses the same floored table, so f/pdf stays exact)
        A = np.maximum(A, 1e-7 * max(A.max(), 1e-12))
        dx = g_i[1] - g_i[0]
        cdf = np.zeros_like(A)
        cdf[:, 1:] = np.cumsum(0.5 * (A[:, :-1] + A[:, 1:]) * dx, axis=1)
        self.i_grid = g_i.astype(np.float32)
        self.o_grid = g_o.astype(np.float32)
        self.pdf_mu = A.astype(np.float32)
        self.cdf_mu = cdf.astype(np.float32)

    # -- I/O -----------------------------------------------------------------

    @classmethod
    def read(cls, filename: str, order_cap=DEFAULT_ORDER_CAP):
        with open(filename, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"{filename}: not a SCATFUN v1 .bsdf file")
            flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack(
                "<6i", f.read(24)
            )
            f.read(12)  # 3 unused int32
            (eta,) = struct.unpack("<f", f.read(4))
            f.read(16)  # 4 unused int32
            if flags != 1:
                raise ValueError(f"{filename}: unsupported flags {flags}")
            if n_bases != 1:
                raise ValueError(f"{filename}: nBases {n_bases} != 1 unsupported")
            if n_channels not in (1, 3):
                raise ValueError(f"{filename}: nChannels {n_channels}")
            mu = np.frombuffer(f.read(4 * n_mu), dtype="<f4")
            _cdf = np.frombuffer(f.read(4 * n_mu * n_mu), dtype="<f4")
            oal = np.frombuffer(f.read(8 * n_mu * n_mu), dtype="<i4")
            a = np.frombuffer(f.read(4 * n_coeffs), dtype="<f4")
        return cls(eta, mu, oal, a, m_max, n_channels, order_cap)

    def write(self, filename: str):
        """Serialize in the same layout (for synthetic tables and tests)."""
        n = self.n_mu
        runs = []
        oal = np.zeros((n * n, 2), dtype="<i4")
        off = 0
        for idx in range(n * n):
            coef = self.a_dense[idx // n, idx % n]  # [C, M]
            used = np.nonzero(np.abs(coef).sum(axis=0) > 0)[0]
            m = int(used.max()) + 1 if used.size else 0
            oal[idx] = (off, m)
            if m:
                runs.append(coef[:, :m].astype("<f4").reshape(-1))
                off += m * self.n_channels
        a = np.concatenate(runs) if runs else np.zeros(0, dtype="<f4")
        with open(filename, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<6i", 1, n, len(a), self.m_used, self.n_channels, 1))
            f.write(struct.pack("<3i", 0, 0, 0))
            f.write(struct.pack("<f", self.eta))
            f.write(struct.pack("<4i", 0, 0, 0, 0))
            f.write(self.mu.astype("<f4").tobytes())
            f.write(np.zeros(n * n, dtype="<f4").tobytes())  # cdf (unused here)
            f.write(oal.tobytes())
            f.write(a.astype("<f4").tobytes())

    @classmethod
    def lambertian(cls, rho=(0.5, 0.5, 0.5), n_mu=16):
        """Synthetic table for f = rho/pi, reflection only (test anchor).

        The stored a0(mu_i, mu_o) includes the |mu_i| factor that eval
        divides back out (pbrt's convention), and is zero unless mu_i and
        mu_o lie on opposite sides of the surface (mu_i measured along -wi).
        """
        rho = np.asarray(rho, dtype=np.float64)
        # pbrt channel order for nChannels=3 tables: (luminance Y, R, B);
        # G is reconstructed at eval time from the luminance identity
        y = 0.212671 * rho[0] + 0.715160 * rho[1] + 0.072169 * rho[2]
        chans = np.array([y, rho[0], rho[2]])
        mu = np.concatenate([-np.cos(np.linspace(0, PI / 2, n_mu // 2)),
                             np.cos(np.linspace(PI / 2, 0, n_mu // 2))])
        mu = np.unique(np.clip(mu, -1, 1))
        n = len(mu)
        oal = np.zeros((n * n, 2), dtype=np.int64)
        coeffs = []
        off = 0
        for i in range(n):
            for j in range(n):
                # reflection: wi on the opposite side of wo (mu_i = cos(-wi))
                if mu[i] * mu[j] < 0:
                    a0 = chans * INV_PI * abs(mu[i])
                    oal[i * n + j] = (off, 1)
                    coeffs.append(np.asarray(a0, dtype=np.float32).reshape(3, 1))
                    off += 3
        a = np.concatenate([c.reshape(-1) for c in coeffs]) if coeffs else np.zeros(0)
        return cls(1.0, mu, oal, a, m_max=1, n_channels=3)

    # -- device bundle --------------------------------------------------------

    def device_arrays(self, device, float_t=np.float32):
        """The table's tensors on ``device`` (made once per device and
        policy; the knots ``mu`` in the policy's float ``float_t``, the rest
        float32, as in the reference)."""
        device = torch.device(device)
        key = (str(device), np.dtype(float_t).name)
        if key not in self._device_cache:
            dense = self.a_dense
            if self.n_channels == 1:
                dense = np.repeat(dense, 3, axis=2)
            arrays = {
                "mu": self.mu.astype(float_t),
                "a": dense,  # [nMu, nMu, 3, M]
                "i_grid": self.i_grid,
                "o_grid": self.o_grid,
                "pdf_mu": self.pdf_mu,  # [n_o, n_i]
                "cdf_mu": self.cdf_mu,  # [n_o, n_i]
            }
            bundle = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                      for k, v in arrays.items()}
            bundle["is_y_rb"] = self.n_channels == 3
            self._device_cache[key] = bundle
        return self._device_cache[key]


# -- Catmull-Rom interpolation over the zenith knots ---------------------------


def _cr_weights(knots, x):
    """The 4-point Catmull-Rom stencil (pbrt-v3 CatmullRomWeights) over
    x [N]: (offset [N] = i - 1, possibly -1, and w [N, 4]); weights of
    stencil entries outside the knots are exactly zero, so gathers may
    clamp the index."""
    n = knots.shape[0]
    x = torch.clamp(x, knots[0], knots[n - 1])
    i = torch.clamp(torch.searchsorted(knots, x, right=True) - 1, 0, n - 2)
    x0 = knots[i]
    x1 = knots[i + 1]
    t = (x - x0) / torch.clamp(x1 - x0, min=1e-12)
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    d0 = t3 - 2.0 * t2 + t
    d1 = t3 - t2
    has_m1 = i > 0
    has_p2 = i + 2 < n
    km1 = knots[torch.clamp(i - 1, min=0)]
    kp2 = knots[torch.clamp(i + 2, max=n - 1)]
    w0a = d0 * (x1 - x0) / torch.clamp(x1 - km1, min=1e-12)
    w3a = d1 * (x1 - x0) / torch.clamp(kp2 - x0, min=1e-12)
    w0 = torch.where(has_m1, -w0a, 0.0)
    w3 = torch.where(has_p2, w3a, 0.0)
    w1 = w1 - torch.where(has_m1, 0.0, d0) - torch.where(has_p2, w3a, d1)
    w2 = w2 + torch.where(has_m1, w0a, d0) + torch.where(has_p2, 0.0, d1)
    return i - 1, torch.stack([w0, w1, w2, w3], dim=-1)


def _cr_weight_matrix_np(knots, xs):
    """Dense host-side Catmull-Rom weight matrix W [len(xs), len(knots)]:
    W @ knot_values = interpolated values at xs (numpy mirror of
    :func:`_cr_weights`, used once at table-load time)."""
    knots = np.asarray(knots, np.float64)
    n = len(knots)
    xs = np.clip(np.asarray(xs, np.float64), knots[0], knots[-1])
    i = np.clip(np.searchsorted(knots, xs, side="right") - 1, 0, n - 2)
    x0 = knots[i]
    x1 = knots[i + 1]
    t = (xs - x0) / np.maximum(x1 - x0, 1e-12)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    d0 = t3 - 2 * t2 + t
    d1 = t3 - t2
    has_m1 = i > 0
    has_p2 = i + 2 < n
    km1 = knots[np.maximum(i - 1, 0)]
    kp2 = knots[np.minimum(i + 2, n - 1)]
    w0a = d0 * (x1 - x0) / np.maximum(x1 - km1, 1e-12)
    w3a = d1 * (x1 - x0) / np.maximum(kp2 - x0, 1e-12)
    w0 = np.where(has_m1, -w0a, 0.0)
    w3 = np.where(has_p2, w3a, 0.0)
    w1 = w1 - np.where(has_m1, 0.0, d0) - np.where(has_p2, w3a, d1)
    w2 = w2 + np.where(has_m1, w0a, d0) + np.where(has_p2, 0.0, d1)
    W = np.zeros((len(xs), n))
    rows = np.arange(len(xs))
    for col, wv in zip((i - 1, i, i + 1, i + 2), (w0, w1, w2, w3)):
        np.add.at(W, (rows, np.clip(col, 0, n - 1)), wv)
    return W


def _gather_coeffs(tbl, mu_i, mu_o):
    """The weighted 4 x 4 gather of coefficient vectors -> ak [N, 3, M]."""
    n = tbl["mu"].shape[0]
    bi, wi = _cr_weights(tbl["mu"], mu_i)
    bj, wj = _cr_weights(tbl["mu"], mu_o)
    a = tbl["a"]  # [nMu, nMu, 3, M]
    out = 0.0
    for r in range(4):
        ii = torch.clamp(bi + r, 0, n - 1)
        for c in range(4):
            jj = torch.clamp(bj + c, 0, n - 1)
            out = out + (wi[:, r] * wj[:, c])[:, None, None] * a[ii, jj]
    return out


def _mu_phi(wo, wi):
    """pbrt's angles: mu_i = cos(-wi), mu_o = cos(wo), phi = the azimuth
    between -wi and wo (unsigned: the series is even)."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    si2 = torch.clamp(1.0 - mu_i * mu_i, min=0.0)
    so2 = torch.clamp(1.0 - mu_o * mu_o, min=0.0)
    denom = torch.sqrt(torch.clamp(si2 * so2, min=1e-14))
    cos_dphi = ((-wi[..., 0]) * wo[..., 0] + (-wi[..., 1]) * wo[..., 1]) / denom
    cos_dphi = torch.where(denom < 1e-7, 1.0, torch.clamp(cos_dphi, -1.0, 1.0))
    return mu_i, mu_o, torch.arccos(cos_dphi)


def _cos_series(a, phi):
    """sum_k a[..., k] cos(k phi) over the last axis of a [N, (C,) M]."""
    ks = torch.arange(a.shape[-1], dtype=phi.dtype, device=phi.device)
    cosk = torch.cos(ks[None, :] * phi[:, None])  # [N, M]
    if a.dim() == 3:
        return torch.einsum("ncm,nm->nc", a, cosk)
    return torch.sum(a * cosk, dim=-1)


def fourier_f(tbl, wo, wi):
    """f(wo, wi) [N, 3] from a device table bundle."""
    mu_i, mu_o, phi = _mu_phi(wo, wi)
    vals = _cos_series(_gather_coeffs(tbl, mu_i, mu_o), phi)  # [N, 3]
    y = torch.clamp(vals[:, 0], min=0.0)
    scale = 1.0 / torch.clamp(torch.abs(mu_i), min=1e-6)
    if tbl["is_y_rb"]:
        r = torch.clamp(vals[:, 1], min=0.0)
        b = torch.clamp(vals[:, 2], min=0.0)
        g = torch.clamp(1.39829 * y - 0.100913 * b - 0.297375 * r, min=0.0)
        rgb = torch.stack([r, g, b], dim=-1)
    else:
        rgb = y[:, None].expand(-1, 3)
    return rgb * scale[:, None]


# -- importance sampling ---------------------------------------------------------


def _row_pos(grid, x):
    """The continuous index of x in a uniform grid: (lower cell, fraction)."""
    n = grid.shape[0]
    pos = (x - grid[0]) / (grid[-1] - grid[0]) * (n - 1)
    pos = torch.clamp(pos, 0.0, n - 1.0)
    k = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    return k, pos - k


def _row_density(tbl, row, mu_i):
    """The normalised piecewise-linear density of one mu_o row at mu_i [N]."""
    k, t = _row_pos(tbl["i_grid"], mu_i)
    a = tbl["pdf_mu"][row, k]
    b = tbl["pdf_mu"][row, k + 1]
    norm = tbl["cdf_mu"][row, -1]
    return (a + (b - a) * t) / torch.clamp(norm, min=1e-20)


def _zenith_pdf(tbl, mu_o, mu_i):
    """p(mu_i | mu_o): the two-row mixture that the sampler draws from."""
    o0, frac = _row_pos(tbl["o_grid"], mu_o)
    return (1.0 - frac) * _row_density(tbl, o0, mu_i) + frac * _row_density(tbl, o0 + 1, mu_i)


def _sample_mu(tbl, mu_o, u_row, u):
    """Invert the zenith CDF: a row chosen with the bilinear mu_o fraction
    (so the marginal sampled is :func:`_zenith_pdf`'s mixture), then the
    closed-form piecewise-linear inversion."""
    o0, frac = _row_pos(tbl["o_grid"], mu_o)
    row = torch.where(u_row < frac, o0 + 1, o0)
    cdf = tbl["cdf_mu"][row]  # [N, n_i]
    target = u * cdf[:, -1]
    k = torch.clamp(torch.sum(cdf <= target[:, None], dim=-1) - 1, 0, cdf.shape[-1] - 2)
    g = tbl["i_grid"]
    a = tbl["pdf_mu"][row, k]
    b = tbl["pdf_mu"][row, k + 1]
    dx = g[k + 1] - g[k]
    y = torch.clamp(target - torch.gather(cdf, 1, k[:, None])[:, 0], min=0.0)
    s = (b - a) / torch.clamp(dx, min=1e-12)
    # 0.5 s t^2 + a t = y  ->  t = 2 y / (a + sqrt(a^2 + 2 s y)), stable as s -> 0
    disc = torch.sqrt(torch.clamp(a * a + 2.0 * s * y, min=0.0))
    t = 2.0 * y / torch.clamp(a + disc, min=1e-20)
    return g[k] + torch.minimum(torch.clamp(t, min=0.0), dx)


def _sample_phi(a_y, u):
    """Draw phi in (-pi, pi] from p(phi) = f_y(phi) / (2 pi a0): invert
    F(phi) = a0 phi + sum_k a_k sin(k phi) / k on [0, pi] by 16 trips of
    bisection-guarded Newton.  Returns (phi, f_y(phi))."""
    m = a_y.shape[-1]
    a0 = a_y[:, 0]
    flip = u >= 0.5
    u = torch.where(flip, 2.0 * (1.0 - u), 2.0 * u)
    target = u * a0 * PI
    lo = torch.zeros_like(u)
    hi = torch.full_like(u, PI)
    phi = 0.5 * (lo + hi)
    ks = torch.arange(1, m, dtype=a_y.dtype, device=a_y.device)
    fval = a0
    for _ in range(16):
        kphi = ks[None, :] * phi[:, None]
        F = a0 * phi + torch.sum(a_y[:, 1:] * torch.sin(kphi) / ks[None, :], dim=-1)
        fval = a0 + torch.sum(a_y[:, 1:] * torch.cos(kphi), dim=-1)
        err = F - target
        lo = torch.where(err < 0, phi, lo)
        hi = torch.where(err > 0, phi, hi)
        newton = phi - err / torch.clamp(fval, min=1e-7)
        ok = (newton > lo) & (newton < hi) & (fval > 1e-7)
        phi = torch.where(ok, newton, 0.5 * (lo + hi))
    return torch.where(flip, -phi, phi), fval


def fourier_pdf_tbl(tbl, wo, wi):
    """The solid-angle pdf of :func:`fourier_sample_wi_tbl`:
    p(mu_i | mu_o) f_y(phi) / (2 pi a0_y)  (dw = dmu dphi)."""
    mu_i, mu_o, phi = _mu_phi(wo, wi)
    p_mu = _zenith_pdf(tbl, mu_o, mu_i)
    a_y = _gather_coeffs(tbl, mu_i, mu_o)[:, 0, :]  # the luminance channel
    f_y = _cos_series(a_y, phi)
    p_phi = torch.clamp(f_y, min=0.0) / (2.0 * PI * torch.clamp(a_y[:, 0], min=1e-9))
    return torch.clamp(p_mu * p_phi, min=0.0)


def fourier_sample_wi_tbl(tbl, wo, u_lobe, u2):
    """Importance-sample wi: mu_i from the tabulated zenith marginal
    (u_lobe picks the mixture row, u2[..., 0] the distance), phi from the
    luminance series (u2[..., 1]); -wi has zenith cosine mu_i and azimuth
    phi_o + phi."""
    mu_o = wo[..., 2]
    mu_i = _sample_mu(tbl, mu_o, u_lobe, u2[..., 0])
    a_y = _gather_coeffs(tbl, mu_i, mu_o)[:, 0, :]
    phi, _ = _sample_phi(a_y, u2[..., 1])
    v = torch.atan2(wo[..., 1], wo[..., 0]) + phi
    sin_i = torch.sqrt(torch.clamp(1.0 - mu_i * mu_i, min=0.0))
    return -torch.stack([sin_i * torch.cos(v), sin_i * torch.sin(v), mu_i], dim=-1)
