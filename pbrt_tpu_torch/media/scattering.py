"""Measured subsurface-scattering coefficients + diffuse-albedo inversion
(host numpy; a copy of ``pbrt_tpu/media/scattering.py``).

pbrt-v3 ships these in core/medium.cpp (GetMediumScatteringProperties) and
uses a tabulated BSSRDF inversion (SubsurfaceFromDiffuse).  The reference
has neither (its Medium layer is a stub, medium.rs:24-33).  This framework
renders subsurface materials TPU-natively as *volumetric transport*: a
dielectric interface plus an interior homogeneous medium traced by the
volpath integrator — no BSSRDF tables, no importance-sampled dipole probes
(pointer-chasing probe rays would be hostile to the wavefront design), just
the same physics the BSSRDF approximates.

Coefficient values are the published measurements of Jensen, Marschner,
Levoy & Hanrahan, "A Practical Model for Subsurface Light Transport"
(SIGGRAPH 2001), Table 1 — reduced scattering sigma_s' and absorption
sigma_a in mm^-1 — the same source pbrt's table cites.

``subsurface_from_diffuse`` inverts the classical dipole diffuse-reflectance
approximation (same paper, eq. 5) by bisection to recover (sigma_a,
sigma_s) from a target diffuse color and mean free path — the role pbrt's
table-based SubsurfaceFromDiffuse plays for the ``kdsubsurface`` material.
"""

from __future__ import annotations

import numpy as np

# name -> (sigma_s_prime [mm^-1], sigma_a [mm^-1]); Jensen et al. 2001 Table 1
MEDIUM_SCATTERING_PROPERTIES = {
    "apple": ((2.29, 2.39, 1.97), (0.0030, 0.0034, 0.046)),
    "chicken1": ((0.15, 0.21, 0.38), (0.015, 0.077, 0.19)),
    "chicken2": ((0.19, 0.25, 0.32), (0.018, 0.088, 0.20)),
    "cream": ((7.38, 5.47, 3.15), (0.0002, 0.0028, 0.0163)),
    "ketchup": ((0.18, 0.07, 0.03), (0.061, 0.97, 1.45)),
    "marble": ((2.19, 2.62, 3.00), (0.0021, 0.0041, 0.0071)),
    "potato": ((0.68, 0.70, 0.55), (0.0024, 0.0090, 0.12)),
    "skimmilk": ((0.70, 1.22, 1.90), (0.0014, 0.0025, 0.0142)),
    "skin1": ((0.74, 0.88, 1.01), (0.032, 0.17, 0.48)),
    "skin2": ((1.09, 1.59, 1.79), (0.013, 0.070, 0.145)),
    "spectralon": ((11.6, 20.4, 14.9), (0.0, 0.0, 0.0)),
    "wholemilk": ((2.55, 3.21, 3.77), (0.0011, 0.0024, 0.014)),
}


def get_medium_scattering_properties(name: str):
    """Returns (sigma_a, sigma_s_prime) RGB arrays or None if unknown."""
    entry = MEDIUM_SCATTERING_PROPERTIES.get(name.lower())
    if entry is None:
        return None
    ss, sa = entry
    return np.asarray(sa, dtype=np.float64), np.asarray(ss, dtype=np.float64)


def _fresnel_moment_a(eta: float) -> float:
    """Internal-reflection parameter A(eta) of the dipole model
    (Jensen et al. 2001 eq. 6, Fdr fit by Egan & Hilgeman)."""
    fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    return (1.0 + fdr) / (1.0 - fdr)


def _dipole_rd(alpha_prime: np.ndarray, a: float) -> np.ndarray:
    """Diffuse reflectance of a semi-infinite slab (Jensen 2001 eq. 5)."""
    s = np.sqrt(3.0 * (1.0 - alpha_prime))
    return (
        0.5
        * alpha_prime
        * (1.0 + np.exp(-4.0 / 3.0 * a * s))
        * np.exp(-s)
    )


def subsurface_from_diffuse(kd, mfp, eta: float = 1.33, g: float = 0.0):
    """(diffuse color, mean free path) -> (sigma_a, sigma_s) per channel.

    Bisection on the reduced albedo alpha' (Rd is monotone in alpha'), then
    sigma_t' = 1/mfp, sigma_s' = alpha' sigma_t', un-reduced by (1-g).
    """
    kd = np.clip(np.asarray(kd, dtype=np.float64).reshape(-1), 0.0, 0.999)
    mfp = np.asarray(mfp, dtype=np.float64).reshape(-1)
    if mfp.size == 1:
        mfp = np.repeat(mfp, kd.size)
    a = _fresnel_moment_a(eta)
    alpha = np.empty_like(kd)
    for i, rd in enumerate(kd):
        lo, hi = 0.0, 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if _dipole_rd(mid, a) < rd:
                lo = mid
            else:
                hi = mid
        alpha[i] = 0.5 * (lo + hi)
    sigma_tp = 1.0 / np.maximum(mfp, 1e-8)
    sigma_sp = alpha * sigma_tp
    sigma_a = sigma_tp - sigma_sp
    sigma_s = sigma_sp / max(1.0 - g, 1e-3)
    return sigma_a, sigma_s


def make_subsurface_medium(record, device="cuda"):
    """MaterialRecord (subsurface/kdsubsurface) -> interior HomogeneousMedium.

    pbrt-v3 parameter surface: SubsurfaceMaterial (materials/subsurface.cpp)
    takes sigma_a/sigma_s (defaults = wholemilk), an optional measured
    preset ``name``, and ``scale``; KdSubsurfaceMaterial
    (materials/kdsubsurface.cpp) takes Kd + mfp and inverts.
    """
    from pbrt_tpu_torch.media import HomogeneousMedium

    p = record.params
    g = p.find_one_float("g", 0.0)
    scale = p.find_one_float("scale", 1.0)
    eta = p.find_one_float("eta", 1.33)
    if record.name == "subsurface":
        sigma_a = np.asarray(
            p.find_one_spectrum("sigma_a", np.array([0.0011, 0.0024, 0.014])),
            dtype=np.float64,
        )
        sigma_s = np.asarray(
            p.find_one_spectrum("sigma_s", np.array([2.55, 3.21, 3.77])),
            dtype=np.float64,
        )
        preset = p.find_one_string("name", "")
        if preset:
            got = get_medium_scattering_properties(preset)
            if got is None:
                import logging

                logging.getLogger("pbrt_tpu_torch").error(
                    "Unknown scattering preset '%s'; using defaults", preset
                )
            else:
                sigma_a, sigma_sp = got
                sigma_s = sigma_sp / max(1.0 - g, 1e-3)
    else:  # kdsubsurface
        kd = np.asarray(
            p.find_one_spectrum("Kd", np.array([0.5, 0.5, 0.5])), dtype=np.float64
        )
        mfp = p.find_one_float("mfp", 1.0)
        sigma_a, sigma_s = subsurface_from_diffuse(kd, mfp, eta=eta, g=g)
    return HomogeneousMedium(sigma_a, sigma_s, g=g, scale=scale, device=device,
                             float_t=p.float_t)
