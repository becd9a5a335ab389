"""Hair BSDF (Chiang et al. 2016, pbrt-v3's ``hair`` material) over a
wavefront (counterpart of ``pbrt_tpu/materials/hair.py``).

Every term (the longitudinal Mp, the azimuthal trimmed-logistic Np, the
attenuation Ap) is closed-form elementwise math, evaluated on every lane
and selected by the caller; lanes that are not hair stay finite.

Frame: local x = the curve tangent (``si["tang"]``, see
``core.geometry.shading_frame``), z = the face-forwarded radial normal.
Curves are tessellated tubes (``shapes/curve.py``), so the azimuthal
offset follows from the hit geometry,

    h = -wo.y / sqrt(wo.y^2 + wo.z^2),

with the sign of pbrt's Phi(p) = 2 p gamma_t - 2 gamma_o + p pi: the R
lobe peaks at the mirror direction about the tube normal.  pMax = 3.

Integer powers are computed as the reference's compiled code does
(binary exponentiation, :func:`_ipow`), and ``jnp.mod`` as an exact
``fmod`` moved to the divisor's sign (:func:`_mod`).
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch import PI
from pbrt_tpu_torch.core.geometry import fma

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069

# CIE Y weights of pbrt's RGBSpectrum::y()
_Y_WEIGHT = (0.212671, 0.715160, 0.072169)

EUMELANIN_SIGMA_A = np.array([0.419, 0.697, 1.37])
PHEOMELANIN_SIGMA_A = np.array([0.187, 0.4, 1.05])


# -- small numerics -------------------------------------------------------------


def _ipow(x, n: int):
    """x ** n for a positive integer n by binary exponentiation, the
    product order of the reference's ``integer_pow``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _mod(x, y: float):
    """``jnp.mod``: the exact remainder, moved to the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def _cos_of_sin(x):
    """sqrt(max(1 - x^2, 0)) with 1 - x^2 rounded once, as the
    reference's compiled code fuses it."""
    return _safe_sqrt(fma(-x, x, torch.ones_like(x)))


def _i0(x):
    """Modified Bessel I0 by its 10-term power series (pbrt-v3 I0)."""
    x2 = x * x
    val = torch.ones_like(x)
    term = torch.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    small = torch.log(_i0(torch.clamp(x, max=12.0)))
    xb = torch.clamp(x, min=12.0)
    big = x + 0.5 * (-float(np.log(np.float32(2.0 * PI))) + torch.log(1.0 / xb)
                     + 1.0 / (8.0 * xb))
    return torch.where(x > 12.0, big, small)


def _mp(cos_i, cos_o, sin_i, sin_o, v):
    """Longitudinal scattering Mp (pbrt-v3 hair.cpp Mp)."""
    v = torch.clamp(v, min=1e-7)
    a = cos_i * cos_o / v
    b = sin_i * sin_o / v
    # the log-space form, stable for small v
    mp_log = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + torch.log(1.0 / (2.0 * v)))
    # the direct form for v > 0.1, at a clamped v so that the lanes it does
    # not serve cannot reach inf / inf
    vs = torch.clamp(v, min=0.1)
    a_s = cos_i * cos_o / vs
    b_s = sin_i * sin_o / vs
    mp_dir = torch.exp(-b_s) * _i0(a_s) / (torch.sinh(1.0 / vs) * 2.0 * vs)
    return torch.where(v <= 0.1, mp_log, mp_dir)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * ((1.0 + e) * (1.0 + e)))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    denom = torch.clamp(u * k + _logistic_cdf(a, s), min=1e-9)
    x = -s * torch.log(torch.clamp(1.0 / denom - 1.0, min=1e-9))
    return torch.clamp(x, a, b)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def _np_term(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = _mod(dphi + PI, 2.0 * PI) - PI  # wrapped to [-pi, pi]
    return _trimmed_logistic(dphi, s, -PI, PI)


def _compact_1by1(x):
    """Drop the odd bits of a uint32 Morton code (pbrt-v3 Compact1By1);
    uint32 carried in int64."""
    x = x & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF
    return x


def demux_float(u):
    """One uniform float -> two (pbrt-v3 DemuxFloat), a Morton
    deinterleave of its 32 fixed-point bits."""
    v = (torch.clamp(u, 0.0, 0.99999994) * 4294967296.0).to(torch.int64)
    ux = _compact_1by1(v).to(u.dtype) * (1.0 / 65536.0)
    uy = _compact_1by1(v >> 1).to(u.dtype) * (1.0 / 65536.0)
    return ux, uy


# -- per-lane geometry and attenuation --------------------------------------------


def _fresnel_dielectric(cos_i, eta):
    from pbrt_tpu_torch.materials.bsdf import fresnel_dielectric

    return fresnel_dielectric(cos_i, torch.ones_like(eta), eta)


def _common(params, wo):
    """The quantities that depend on the material and wo only."""
    beta_m = params["beta_m"]
    beta_n = params["beta_n"]
    eta = params["eta"]
    sigma_a = params["sigma_a"]

    v0 = 0.726 * beta_m + 0.812 * (beta_m * beta_m) + 3.7 * _ipow(beta_m, 20)
    v0 = v0 * v0
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]  # v[3] = v[2] (pMax = 3)
    s = SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * (beta_n * beta_n)
                          + 5.372 * _ipow(beta_n, 22))

    # the scales' tilts: sin and cos of 2^k alpha
    alpha_rad = params["hair_alpha"] * (PI / 180.0)
    sin2k = [torch.sin(alpha_rad)]
    cos2k = [_cos_of_sin(sin2k[0])]
    for _ in range(2):
        sin2k.append(2.0 * cos2k[-1] * sin2k[-1])
        cos2k.append(cos2k[-1] * cos2k[-1] - sin2k[-1] * sin2k[-1])

    sin_theta_o = wo[..., 0]
    cos_theta_o = _cos_of_sin(sin_theta_o)
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])

    perp = _safe_sqrt(fma(wo[..., 2], wo[..., 2], wo[..., 1] * wo[..., 1]))
    h = torch.clamp(-wo[..., 1] / torch.clamp(perp, min=1e-7), -1.0, 1.0)
    gamma_o = torch.arcsin(h)

    # the refracted path through the fiber
    sin_theta_t = sin_theta_o / eta
    cos_theta_t = _cos_of_sin(sin_theta_t)
    etap = _safe_sqrt(eta * eta - sin_theta_o * sin_theta_o) / torch.clamp(cos_theta_o, min=1e-7)
    sin_gamma_t = torch.clamp(h / torch.clamp(etap, min=1e-7), -1.0, 1.0)
    cos_gamma_t = _cos_of_sin(sin_gamma_t)
    gamma_t = torch.arcsin(sin_gamma_t)

    # the transmittance of one pass
    tr = torch.exp(-sigma_a * (2.0 * cos_gamma_t / torch.clamp(cos_theta_t, min=1e-7))[..., None])

    # the attenuation of each lobe (pbrt-v3 hair.cpp Ap)
    cos_gamma_o = _cos_of_sin(h)
    f = _fresnel_dielectric(cos_theta_o * cos_gamma_o, eta)[..., None]
    ap0 = torch.broadcast_to(f, tr.shape)
    ap1 = ((1.0 - f) * (1.0 - f)) * tr
    ap2 = ap1 * tr * f
    ap3 = ap2 * f * tr / torch.clamp(1.0 - tr * f, min=1e-5)

    return {
        "v": v, "s": s, "sin2k": sin2k, "cos2k": cos2k,
        "sin_theta_o": sin_theta_o, "cos_theta_o": cos_theta_o, "phi_o": phi_o,
        "gamma_o": gamma_o, "gamma_t": gamma_t, "ap": [ap0, ap1, ap2, ap3],
    }


def _tilted_theta_o(c, p):
    """theta_o tilted by the cuticle scales for lobe p (pbrt-v3 f())."""
    so, co = c["sin_theta_o"], c["cos_theta_o"]
    s2k, c2k = c["sin2k"], c["cos2k"]
    if p == 0:
        sin_op = so * c2k[1] - co * s2k[1]
        cos_op = co * c2k[1] + so * s2k[1]
    elif p == 1:
        sin_op = so * c2k[0] + co * s2k[0]
        cos_op = co * c2k[0] - so * s2k[0]
    elif p == 2:
        sin_op = so * c2k[2] + co * s2k[2]
        cos_op = co * c2k[2] - so * s2k[2]
    else:
        return so, co
    return sin_op, torch.abs(cos_op)


def _ap_pdf(c):
    """Lobe selection probabilities from the luminance of Ap."""
    ap = c["ap"]
    w = ap[0].new_tensor(_Y_WEIGHT)
    ys = [torch.sum(a * w, dim=-1) for a in ap]
    total = torch.clamp(ys[0] + ys[1] + ys[2] + ys[3], min=1e-9)
    return [y / total for y in ys]


def _theta_phi_i(c, wi):
    sin_theta_i = wi[..., 0]
    cos_theta_i = _cos_of_sin(sin_theta_i)
    phi = torch.atan2(wi[..., 2], wi[..., 1]) - c["phi_o"]
    return sin_theta_i, cos_theta_i, phi


# -- f, pdf, sample ---------------------------------------------------------------


def hair_f(params, wo, wi):
    """f(wo, wi) [N, 3], with pbrt's 1 / |cos theta_i| factor."""
    c = _common(params, wo)
    sin_theta_i, cos_theta_i, phi = _theta_phi_i(c, wi)
    fsum = torch.zeros_like(params["sigma_a"])
    for p in range(P_MAX):
        sin_op, cos_op = _tilted_theta_o(c, p)
        mp = _mp(cos_theta_i, cos_op, sin_theta_i, sin_op, c["v"][p])
        np_t = _np_term(phi, p, c["s"], c["gamma_o"], c["gamma_t"])
        fsum = fsum + (mp * np_t)[..., None] * c["ap"][p]
    mp_last = _mp(cos_theta_i, c["cos_theta_o"], sin_theta_i, c["sin_theta_o"], c["v"][P_MAX])
    fsum = fsum + (mp_last / (2.0 * PI))[..., None] * c["ap"][P_MAX]
    return fsum / torch.clamp(torch.abs(wi[..., 2]), min=1e-7)[..., None]


def hair_pdf(params, wo, wi):
    """The solid-angle pdf of :func:`hair_sample_wi` [N]."""
    c = _common(params, wo)
    sin_theta_i, cos_theta_i, phi = _theta_phi_i(c, wi)
    apdf = _ap_pdf(c)
    pdf = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    for p in range(P_MAX):
        sin_op, cos_op = _tilted_theta_o(c, p)
        mp = _mp(cos_theta_i, cos_op, sin_theta_i, sin_op, c["v"][p])
        np_t = _np_term(phi, p, c["s"], c["gamma_o"], c["gamma_t"])
        pdf = pdf + mp * apdf[p] * np_t
    mp_last = _mp(cos_theta_i, c["cos_theta_o"], sin_theta_i, c["sin_theta_o"], c["v"][P_MAX])
    return pdf + mp_last * apdf[P_MAX] / (2.0 * PI)


def hair_sample_wi(params, wo, u_lobe, u2):
    """Sample wi on hair lanes (pbrt-v3 HairBSDF::Sample_f's direction).

    u_lobe is demuxed into the lobe choice and the azimuth sample, u2
    drives the longitudinal sample.  Returns wi [N, 3]; f and pdf follow
    from :func:`hair_f` and :func:`hair_pdf`, as pbrt recomputes them."""
    c = _common(params, wo)
    u_p, u_np = demux_float(u_lobe)
    apdf = _ap_pdf(c)

    # the lobe p in {0, 1, 2, 3}
    c0 = apdf[0]
    c1 = c0 + apdf[1]
    c2 = c1 + apdf[2]
    p_idx = (u_p >= c0).to(torch.int32) + (u_p >= c1).to(torch.int32) + (u_p >= c2).to(torch.int32)

    def select(vals):
        out = vals[0]
        for k in range(1, 4):
            out = torch.where(p_idx == k, vals[k], out)
        return out

    sin_ops, cos_ops = zip(*[_tilted_theta_o(c, p) for p in range(4)])
    sin_op = select(list(sin_ops))
    cos_op = select(list(cos_ops))
    v_p = select(c["v"])

    # longitudinal: sample Mp
    u10 = torch.clamp(u2[..., 0], min=1e-5)
    e = torch.exp(-2.0 / torch.clamp(v_p, min=1e-7))
    cos_theta = 1.0 + v_p * torch.log(u10 + (1.0 - u10) * e)
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi_l = torch.cos(2.0 * PI * u2[..., 1])
    sin_theta_i = -cos_theta * sin_op + sin_theta * cos_phi_l * cos_op
    cos_theta_i = _safe_sqrt(1.0 - sin_theta_i * sin_theta_i)

    # azimuthal: the trimmed logistic about Phi(p); uniform for p = 3
    dphi_lobe = (_phi_fn(p_idx.to(wo.dtype), c["gamma_o"], c["gamma_t"])
                 + _sample_trimmed_logistic(u_np, c["s"], -PI, PI))
    dphi = torch.where(p_idx == P_MAX, 2.0 * PI * u_np, dphi_lobe)

    phi_i = c["phi_o"] + dphi
    return torch.stack([sin_theta_i, cos_theta_i * torch.cos(phi_i),
                        cos_theta_i * torch.sin(phi_i)], dim=-1)


# -- pigments (pbrt-v3 hair.cpp; host numpy or device tensors) --------------------


def sigma_a_from_concentration(ce: float, cp: float) -> np.ndarray:
    return ce * EUMELANIN_SIGMA_A + cp * PHEOMELANIN_SIGMA_A


def sigma_a_from_reflectance(c, beta_n):
    """Invert the multiple-scattering albedo fit (pbrt-v3 hair.cpp)."""
    denom = (5.969 - 0.215 * beta_n + 2.532 * _ipow(beta_n, 2) - 10.73 * _ipow(beta_n, 3)
             + 5.574 * _ipow(beta_n, 4) + 0.245 * _ipow(beta_n, 5))
    if isinstance(c, torch.Tensor):
        ln = torch.log(torch.clamp(c, min=1e-4))
    else:
        ln = np.log(np.maximum(c, 1e-4))
    r = ln / denom
    return r * r
