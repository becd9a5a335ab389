"""RGB spectra and color-space conversions (host numpy).

Copy of ``pbrt_tpu/core/spectrum.py``: the sRGB <-> XYZ matrices, the
CIE fits that parameter decoding (``xyz``, ``blackbody``, sampled
``spectrum`` values) needs, and the sampled-spectrum render mode's pass
state.  Spectral transport is diagonal in wavelength, so a render of
N bins decomposes into N / 3 passes of the unchanged RGB pipeline, whose
three channels are three wavelength bins (``render.render_scene_spectral``).
While a pass is active (:func:`set_spectral_bins`), every point where
host RGB enters the scene build (the ParamSet's spectrum getters, image
texels, light emission and maps) calls :func:`promote_rgb`: RGB -> a
Smits spectrum -> the pass's three bins, by the illuminant basis for
emission and the reflectance basis otherwise.
"""

from __future__ import annotations

import numpy as np


# sRGB <-> CIE XYZ matrices (identical to pbrt-v3 and the reference).
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float64,
)

RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)


def xyz_to_rgb(xyz, float_t=np.float32):
    """XYZ -> sRGB-linear over the trailing axis of size 3, in ``float_t``."""
    xyz = np.asarray(xyz, dtype=float_t)
    return (xyz @ np.asarray(XYZ_TO_RGB, dtype=float_t).T).astype(float_t)


def rgb_to_xyz(rgb, float_t=np.float32):
    """sRGB-linear -> XYZ over the trailing axis of size 3, in ``float_t``."""
    rgb = np.asarray(rgb, dtype=float_t)
    return (rgb @ np.asarray(RGB_TO_XYZ, dtype=float_t).T).astype(float_t)


N_SPECTRAL_SAMPLES = 60
SAMPLED_LAMBDA_START = 400.0
SAMPLED_LAMBDA_END = 700.0


def _lobe(x, mu, s1, s2):
    t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
    return np.exp(-0.5 * t * t)


def _cie_x(wl):
    """Analytic CIE x-bar fit (Wyman, Sloan & Shirley 2013)."""
    wl = np.asarray(wl, dtype=np.float64)
    return (
        1.056 * _lobe(wl, 599.8, 37.9, 31.0)
        + 0.362 * _lobe(wl, 442.0, 16.0, 26.7)
        - 0.065 * _lobe(wl, 501.1, 20.4, 26.2)
    )


def _cie_y(wl):
    wl = np.asarray(wl, dtype=np.float64)
    return 0.821 * _lobe(wl, 568.8, 46.9, 40.5) + 0.286 * _lobe(wl, 530.9, 16.3, 31.1)


def _cie_z(wl):
    wl = np.asarray(wl, dtype=np.float64)
    return 1.217 * _lobe(wl, 437.0, 11.8, 36.0) + 0.681 * _lobe(wl, 459.0, 26.0, 13.8)


def _bucket_wavelengths():
    i = np.arange(N_SPECTRAL_SAMPLES, dtype=np.float64)
    span = SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START
    lo = SAMPLED_LAMBDA_START + span * i / N_SPECTRAL_SAMPLES
    hi = SAMPLED_LAMBDA_START + span * (i + 1) / N_SPECTRAL_SAMPLES
    return 0.5 * (lo + hi)


_WL = _bucket_wavelengths()
_CIE_X = _cie_x(_WL)
_CIE_Y = _cie_y(_WL)
_CIE_Z = _cie_z(_WL)
_CIE_Y_INTEGRAL = float(np.sum(_CIE_Y))


def sampled_to_xyz(samples, float_t=np.float32):
    """Integrate a sampled spectrum [..., 60] against the CIE fits -> XYZ."""
    s = np.asarray(samples, dtype=np.float64)
    scale = 1.0 / _CIE_Y_INTEGRAL
    x = np.sum(s * _CIE_X, axis=-1) * scale
    y = np.sum(s * _CIE_Y, axis=-1) * scale
    z = np.sum(s * _CIE_Z, axis=-1) * scale
    return np.stack([x, y, z], axis=-1).astype(float_t)


def sampled_to_rgb(samples, float_t=np.float32):
    return xyz_to_rgb(sampled_to_xyz(samples, float_t), float_t)


def _smits_basis(reflectance: bool = False):
    """Smits-style smooth basis spectra for white/c/m/y/r/g/b.

    Computed (not tabulated from pbrt): minimum-curvature spectra whose
    projections reproduce the corners of the sRGB cube, in the spirit of
    pbrt-v3's separate RGBIllum2Spect/RGBRefl2Spect tables (spectrum.cpp).

    * illuminant basis (default): CMF . S = XYZ(rgb) — a light with this
      spectrum *is* that color.
    * reflectance basis: (CMF . diag(W)) . S = XYZ(rgb), where W is the
      illuminant white — a surface with this spectrum *looks* like that
      color under the white light.  The white-reflectance constraint is
      satisfied by the flat spectrum S == 1, which has zero curvature, so
      the KKT solution makes white exactly flat: gray transport composes
      exactly (0.5^n stays 0.5^n), and every single reflection is
      XYZ-exact by linearity of the Smits case mixing.
    """
    # Solve for each basis: minimize curvature subject to matching XYZ.
    n = N_SPECTRAL_SAMPLES
    # Second-difference smoothness matrix
    d = np.zeros((n - 2, n))
    for i in range(n - 2):
        d[i, i] = 1.0
        d[i, i + 1] = -2.0
        d[i, i + 2] = 1.0
    a_smooth = d.T @ d + 1e-6 * np.eye(n)
    cmf = np.stack([_CIE_X, _CIE_Y, _CIE_Z], axis=0) / _CIE_Y_INTEGRAL  # 3 x n
    if reflectance:
        cmf = cmf * _smits_basis(reflectance=False)["white"][None, :]
    targets = {
        "white": (1.0, 1.0, 1.0),
        "red": (1.0, 0.0, 0.0),
        "green": (0.0, 1.0, 0.0),
        "blue": (0.0, 0.0, 1.0),
        "cyan": (0.0, 1.0, 1.0),
        "magenta": (1.0, 0.0, 1.0),
        "yellow": (1.0, 1.0, 0.0),
    }
    basis = {}
    for name, rgb in targets.items():
        xyz = RGB_TO_XYZ @ np.asarray(rgb)
        # KKT system: [A C^T; C 0] [s; mu] = [0; xyz]
        kkt = np.zeros((n + 3, n + 3))
        kkt[:n, :n] = a_smooth
        kkt[:n, n:] = cmf.T
        kkt[n:, :n] = cmf
        rhs = np.zeros(n + 3)
        rhs[n:] = xyz
        sol = np.linalg.solve(kkt, rhs)
        basis[name] = sol[:n]
    return basis


_SMITS = {}

_SPECTRAL_BINS = None  # None, or an int ndarray of 3 bin indices into _WL


def set_spectral_bins(bins):
    """Activate (or with None, end) a 3-bin spectral render pass."""
    global _SPECTRAL_BINS
    if bins is None:
        _SPECTRAL_BINS = None
    else:
        b = np.asarray(bins, dtype=np.int64)
        if b.shape != (3,):
            raise ValueError("spectral pass needs exactly 3 bin indices")
        _SPECTRAL_BINS = b


def get_spectral_bins():
    return _SPECTRAL_BINS


def promote_rgb(rgb, illuminant: bool = False, float_t=np.float32):
    """RGB [..., 3] -> the active pass's 3 spectral-bin samples in
    ``float_t`` (RGB unchanged when no pass is active)."""
    if _SPECTRAL_BINS is None:
        return np.asarray(rgb, dtype=float_t)
    s = rgb_to_sampled(rgb, illuminant=illuminant, float_t=float_t)
    return np.ascontiguousarray(s[..., _SPECTRAL_BINS]).astype(float_t)


def rgb_to_sampled(rgb, illuminant: bool = False, float_t=np.float32):
    """Promote RGB [..., 3] to a sampled spectrum [..., 60] (Smits 1999).

    Vectorized over leading axes; the six min/mid/max cases of Smits'
    algorithm expressed with ``np.where`` masks.  Illuminants are exact in
    XYZ; reflectances are exact in XYZ as viewed under the illuminant
    white (see :func:`_smits_basis`).
    """
    key = bool(illuminant)
    if key not in _SMITS:
        # illuminant basis = plain CMF constraint; reflectance weights the
        # CMF by the illuminant white
        _SMITS[key] = _smits_basis(reflectance=not key)
    bs = _SMITS[key]
    rgb = np.asarray(rgb, dtype=np.float64)
    r = rgb[..., 0:1]
    g = rgb[..., 1:2]
    b = rgb[..., 2:3]

    def case(lo, mid, hi, secondary, tertiary):
        return lo * bs["white"] + (mid - lo) * bs[secondary] + (hi - mid) * bs[tertiary]

    out = np.zeros(rgb.shape[:-1] + (N_SPECTRAL_SAMPLES,))
    conds = [
        (r <= g) & (g <= b),
        (r <= b) & (b < g),
        (g < r) & (r <= b),
        (g <= b) & (b < r),
        (b < r) & (r <= g),
        (b < g) & (g < r),
    ]
    vals = [
        case(r, g, b, "cyan", "blue"),
        case(r, b, g, "cyan", "green"),
        case(g, r, b, "magenta", "blue"),
        case(g, b, r, "magenta", "red"),
        case(b, r, g, "yellow", "green"),
        case(b, g, r, "yellow", "red"),
    ]
    taken = np.zeros(rgb.shape[:-1] + (1,), dtype=bool)
    for c, v in zip(conds, vals):
        use = c & ~taken
        out = np.where(use, v, out)
        taken = taken | c
    return out.astype(float_t)


def blackbody(wavelengths_nm, temperature_k):
    """Planck's law: spectral radiance at the given wavelengths."""
    wl = np.asarray(wavelengths_nm, dtype=np.float64) * 1e-9
    t = float(temperature_k)
    if t <= 0:
        return np.zeros_like(wl)
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    return 2.0 * h * c * c / (wl ** 5 * np.expm1(h * c / (wl * kb * t)))


def blackbody_to_rgb(temperature_k, scale=1.0, float_t=np.float32):
    """RGB of a peak-normalized blackbody emitter (``"blackbody L" [T s]``)."""
    lambda_max = 2.8977721e-3 / max(float(temperature_k), 1e-6)
    max_l = blackbody(np.array([lambda_max * 1e9]), temperature_k)[0]
    return sampled_to_rgb(blackbody(_WL, temperature_k) / max_l * scale, float_t)
