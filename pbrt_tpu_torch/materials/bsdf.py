"""BSDF evaluation and sampling over a wavefront (counterpart of
``pbrt_tpu/materials/bsdf.py``).

Every lane carries a material type id and SoA parameters; lobes are
evaluated with masked selects, and the lobes of types absent from the
parameter set's static type set (``params["_active"]``) are skipped.
Ported: diffuse (Lambert and Oren-Nayar), the perfect mirror, smooth and
rough glass, plastic, metal (conductor Fresnel), substrate (Ashikhmin-
Shirley FresnelBlend), uber and translucent, with GGX (Trowbridge-Reitz)
microfacets, and their blends (``mix``); hair (``materials/hair.py``)
and the fourier tables (``materials/fourier.py``), which are present
only when the scene has them (``params["sigma_a"]``, ``params["fourier"]``).

Mix (pbrt-v3 MixMaterial): ``eval_material_params`` gives a second
parameter set under ``params["mix_b"]`` with the blend ``mix_amt`` and
the selection probability ``mix_pa``.  f and pdf blend linearly;
sampling picks a child by ``mix_pa`` and rescales the lobe sample.  A
child that is itself a mix carries its own ``mix_b``, and the public
functions below recurse into it, handing ``params["outside"]`` down.

Local shading frame: z = shading normal; wo/wi in local coordinates.  The
frame is face-forwarded (wo.z > 0), so dielectrics read the true side
from ``params["outside"]`` (the integrator sets it).  For specular lobes
f already includes 1/|cos| (pdf 1), so the path weight f |cos| / pdf is
the same expression for every lobe.

Integer powers are written as the reference's XLA code computes them
(``x ** 5`` = x (x^2)^2), so that float32 values agree to rounding.
Every square root of a clamped value is ``core.geometry.sqrt0``: the
same values, and a zero derivative where the root is zero.  Every lobe
is evaluated on every lane and masked, so a lane of another lobe (or at
normal incidence, where Fresnel's sin_t is 0) would otherwise turn its
zero cotangent into NaN; the reference's gradient is NaN there.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch import INV_PI, PI
from pbrt_tpu_torch.core.geometry import sqrt0
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere, sincos_2pi

# Material type ids (table order kept in sync with the reference)
MATTE = 0
MIRROR = 1
GLASS = 2
PLASTIC = 3
METAL = 4
SUBSTRATE = 5
UBER = 6
TRANSLUCENT = 7
DISNEY = 8
HAIR = 9
FOURIER = 10
NONE = 15  # pure emitter

# glass with alpha above this takes the rough dielectric lobes
ROUGH_GLASS_MIN_ALPHA = 5e-3

# the reference's literal (``pbrt_tpu/materials/bsdf.py:37``) under either policy
ONE_MINUS_EPS = 0.99999994


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def _dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def _normalize(v, eps):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps), n[..., 0]


def reflect(wo, n):
    return -wo + 2.0 * _dot(wo, n, keepdim=True) * n


def refract(wi, n, eta_ratio):
    """(wt, total internal reflection mask); eta_ratio = eta_i / eta_t."""
    cos_i = _dot(wi, n)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    tir = sin2_t >= 1.0
    cos_t = sqrt0(1.0 - sin2_t)
    wt = eta_ratio[..., None] * (-wi) + (eta_ratio * cos_i - cos_t)[..., None] * n
    return wt, tir


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Dielectric Fresnel reflectance, the side taken from cos_i's sign."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_t = ei / et * sqrt0(1.0 - ci * ci)
    tir = sin_t >= 1.0
    ct = sqrt0(1.0 - sin_t * sin_t)
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-8)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """RGB conductor Fresnel (pbrt-v3 §8.2.1); eta and k are [..., 3]."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = sqrt0(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = sqrt0(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-8)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-8)
    return 0.5 * (rp + rs)


def fresnel_schlick_rgb(cos_i, r0):
    c = torch.clamp(1.0 - torch.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))


def roughness_to_alpha(roughness):
    """pbrt-v3 TrowbridgeReitzDistribution::RoughnessToAlpha."""
    x = torch.log(torch.clamp(roughness, min=1e-3))
    x2 = x * x
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * (x * x2)
            + 0.000640711 * (x2 * x2))


# -- GGX / Trowbridge-Reitz (isotropic) -------------------------------------


def ggx_d(wh, alpha):
    c2 = wh[..., 2] * wh[..., 2]
    a2 = alpha * alpha
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * denom * denom, min=1e-12)


def ggx_lambda(w, alpha):
    c = torch.abs(w[..., 2])
    s2 = torch.clamp(1.0 - c * c, min=0.0)
    tan2 = s2 / torch.clamp(c * c, min=1e-12)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def ggx_g(wo, wi, alpha):
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_sample_wh(u, alpha):
    """Sample the GGX distribution D (not the visible normals), as pbrt-v3's
    TrowbridgeReitzDistribution::Sample_wh without sampleVisibleArea."""
    c2 = (1.0 - u[..., 0]) / torch.clamp(1.0 + (alpha * alpha - 1.0) * u[..., 0], min=1e-12)
    cos_t = sqrt0(c2)
    sin_t = sqrt0(1.0 - c2)
    sp, cp = sincos_2pi(u[..., 1])
    return torch.stack([sin_t * cp, sin_t * sp, cos_t], dim=-1)


def ggx_pdf_wh(wh, alpha):
    return ggx_d(wh, alpha) * torch.abs(wh[..., 2])


# -- lobe terms ---------------------------------------------------------------


def oren_nayar_ab(sigma_deg):
    s = sigma_deg * (PI / 180.0)
    s2 = s * s
    return 1.0 - s2 / (2.0 * (s2 + 0.33)), 0.45 * s2 / (s2 + 0.09)


def _diffuse_f(params, wo, wi):
    """Lambert or Oren-Nayar (sigma > 0) diffuse term [N, 3]."""
    a, b = oren_nayar_ab(params["sigma"])
    sin_theta_i = sqrt0(1.0 - wi[..., 2] ** 2)
    sin_theta_o = sqrt0(1.0 - wo[..., 2] ** 2)
    denom_i = torch.clamp(sin_theta_i, min=1e-7)
    denom_o = torch.clamp(sin_theta_o, min=1e-7)
    cos_dphi = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / (denom_i * denom_o)
    max_cos = torch.where(
        (sin_theta_i > 1e-4) & (sin_theta_o > 1e-4),
        torch.clamp(cos_dphi, min=0.0),
        torch.zeros_like(cos_dphi),
    )
    abs_ci = torch.abs(wi[..., 2])
    abs_co = torch.abs(wo[..., 2])
    sin_alpha = torch.where(abs_ci > abs_co, sin_theta_o, sin_theta_i)
    tan_beta = torch.where(
        abs_ci > abs_co,
        sin_theta_i / torch.clamp(abs_ci, min=1e-7),
        sin_theta_o / torch.clamp(abs_co, min=1e-7),
    )
    on = a + b * max_cos * sin_alpha * tan_beta
    return params["kd"] * (INV_PI * on)[..., None]


def _microfacet_reflection_f(wo, wi, alpha, fresnel_fn, scale):
    """Torrance-Sparrow D G F / (4 cos_o cos_i) [N, 3]."""
    co = torch.abs(wo[..., 2])
    ci = torch.abs(wi[..., 2])
    wh_n, wh_len = _normalize(wi + wo, 1e-12)
    ok = (co > 1e-7) & (ci > 1e-7) & (wh_len > 1e-12) & same_hemisphere(wo, wi)
    f = fresnel_fn(_dot(wi, wh_n))
    val = scale * f * (ggx_d(wh_n, alpha) * ggx_g(wo, wi, alpha)
                       / torch.clamp(4 * co * ci, min=1e-7))[..., None]
    return torch.where(ok[..., None], val, 0.0)


def _microfacet_pdf(wo, wi, alpha):
    wh_n, _ = _normalize(wi + wo, 1e-12)
    pdf = ggx_pdf_wh(wh_n, alpha) / torch.clamp(4.0 * torch.abs(_dot(wo, wh_n)), min=1e-7)
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _substrate_f(params, wo, wi):
    """Ashikhmin-Shirley FresnelBlend (pbrt-v3 §8.5)."""
    rd = params["kd"]
    rs = params["ks"]
    alpha = params["roughness"]
    co = torch.abs(wo[..., 2])
    ci = torch.abs(wi[..., 2])

    def pow5(v):
        return (v * v) * (v * v) * v

    diffuse = ((28.0 / (23.0 * PI)) * rd * (1.0 - rs)
               * (1.0 - pow5(1.0 - 0.5 * ci))[..., None]
               * (1.0 - pow5(1.0 - 0.5 * co))[..., None])
    wh_n, wh_len = _normalize(wi + wo, 1e-12)
    d = ggx_d(wh_n, alpha)
    cos_wi_wh = _dot(wi, wh_n)
    schlick = fresnel_schlick_rgb(cos_wi_wh, rs)
    spec = (d / torch.clamp(4.0 * torch.abs(cos_wi_wh) * torch.maximum(ci, co),
                            min=1e-7))[..., None] * schlick
    ok = (wh_len > 1e-12) & same_hemisphere(wo, wi)
    return torch.where(ok[..., None], diffuse + spec, 0.0)


def _eta_side(params, wo):
    """eta' of the transmission half-vector: eta from outside, 1/eta from
    inside (the true side, ``params["outside"]``)."""
    eta = params["eta"]
    outside = params.get("outside", wo[..., 2] > 0)
    return torch.where(outside, eta, 1.0 / eta)


def _transmission_half(wo, wi, eta_p):
    """The transmission half-vector wo + eta' wi, normalised and turned to
    +z, and its length before normalising."""
    wh_n, wh_len = _normalize(wo + wi * eta_p[..., None], 1e-12)
    return wh_n * torch.sign(wh_n[..., 2:3]), wh_len


def _microfacet_transmission_f(params, wo, wi):
    """Rough dielectric transmission (pbrt-v3 §8.4.4, radiance transport)."""
    alpha = params["roughness"]
    eta = params["eta"]
    co = wo[..., 2]
    ci = wi[..., 2]
    eta_p = _eta_side(params, wo)
    wh_n, wh_len = _transmission_half(wo, wi, eta_p)
    f_d = fresnel_dielectric(_dot(wo, wh_n), torch.ones_like(eta), eta)
    sqrt_denom = _dot(wo, wh_n) + eta_p * _dot(wi, wh_n)
    factor = 1.0 / torch.clamp(eta_p, min=1e-6)
    val = ((1.0 - f_d) * ggx_d(wh_n, alpha) * ggx_g(wo, wi, alpha)
           * torch.abs(_dot(wi, wh_n) * _dot(wo, wh_n) * factor * factor
                       / torch.clamp(torch.abs(ci) * torch.abs(co) * sqrt_denom * sqrt_denom,
                                     min=1e-9)))
    ok = (~same_hemisphere(wo, wi)) & (torch.abs(co) > 1e-6) & (torch.abs(ci) > 1e-6) & (
        wh_len > 1e-9)
    return torch.where(ok[..., None], params["kt"] * val[..., None], 0.0)


def _dielectric_fresnel(eta):
    return lambda ci: fresnel_dielectric(ci, torch.ones_like(eta), eta)[..., None]


# -- one parameter set ----------------------------------------------------------


def _bsdf_eval_one(params, wo, wi):
    """f(wo, wi) [N, 3] of one parameter set (specular lobes contribute 0)."""
    mtype = params["type"]
    active = params["_active"]

    def has(*types):
        return any(t in active for t in types)

    f = torch.zeros_like(params["kd"])
    hemi = same_hemisphere(wo, wi)[..., None]
    if has(MATTE, PLASTIC, UBER):
        diffuse = _diffuse_f(params, wo, wi)
    if has(PLASTIC, UBER):
        alpha, eta = params["roughness"], params["eta"]
        refl_dielectric = _microfacet_reflection_f(wo, wi, alpha, _dielectric_fresnel(eta),
                                                   params["ks"])
    if has(MATTE):
        f = torch.where((mtype == MATTE)[..., None], torch.where(hemi, diffuse, 0.0), f)
    for t in (PLASTIC, UBER):
        if has(t):
            f = torch.where((mtype == t)[..., None],
                            torch.where(hemi, diffuse + refl_dielectric, 0.0), f)
    if has(METAL):
        refl_conductor = _microfacet_reflection_f(
            wo, wi, params["roughness"],
            lambda ci: fresnel_conductor(ci, params["metal_eta"], params["metal_k"]),
            torch.ones_like(params["ks"]),
        )
        f = torch.where((mtype == METAL)[..., None], refl_conductor, f)
    if has(SUBSTRATE):
        f = torch.where((mtype == SUBSTRATE)[..., None], _substrate_f(params, wo, wi), f)
    if has(TRANSLUCENT):
        translucent_f = torch.where(hemi, params["kd"], params["kt"]) * INV_PI
        f = torch.where((mtype == TRANSLUCENT)[..., None], translucent_f, f)
    if has(GLASS):
        alpha, eta = params["roughness"], params["eta"]
        rough_glass = (mtype == GLASS) & (alpha > ROUGH_GLASS_MIN_ALPHA)
        rg_refl = _microfacet_reflection_f(wo, wi, alpha, _dielectric_fresnel(eta),
                                           params["kr"])
        rg_trans = _microfacet_transmission_f(params, wo, wi)
        f = torch.where(rough_glass[..., None], rg_refl + rg_trans, f)
    if has(HAIR) and "sigma_a" in params:
        from pbrt_tpu_torch.materials.hair import hair_f

        f = torch.where((mtype == HAIR)[..., None], hair_f(params, wo, wi), f)
    if has(FOURIER) and "fourier" in params:
        from pbrt_tpu_torch.materials.fourier import fourier_f

        for tbl in params["fourier"]:
            f = torch.where(tbl["mask"][..., None], fourier_f(tbl, wo, wi), f)
    return f


def _bsdf_pdf_one(params, wo, wi):
    """Solid-angle pdf of :func:`_bsdf_sample_one` (0 on specular lanes)."""
    mtype = params["type"]
    active = params["_active"]

    def has(*types):
        return any(t in active for t in types)

    cos_pdf = torch.where(same_hemisphere(wo, wi), torch.abs(wi[..., 2]) * INV_PI, 0.0)
    pdf = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    if has(PLASTIC, UBER, SUBSTRATE, METAL, GLASS):
        mf_pdf = _microfacet_pdf(wo, wi, params["roughness"])
    if has(MATTE):
        pdf = torch.where(mtype == MATTE, cos_pdf, pdf)
    if has(PLASTIC, UBER, SUBSTRATE):
        pdf = torch.where((mtype == PLASTIC) | (mtype == UBER) | (mtype == SUBSTRATE),
                          0.5 * (cos_pdf + mf_pdf), pdf)
    if has(METAL):
        pdf = torch.where(mtype == METAL, mf_pdf, pdf)
    if has(TRANSLUCENT):
        pdf = torch.where(mtype == TRANSLUCENT, 0.5 * torch.abs(wi[..., 2]) * INV_PI, pdf)
    if has(GLASS):
        # rough dielectric: half of each lobe's pdf
        alpha = params["roughness"]
        eta_p = _eta_side(params, wo)
        wh_tn, wh_t_len = _transmission_half(wo, wi, eta_p)
        sqrt_denom = _dot(wo, wh_tn) + eta_p * _dot(wi, wh_tn)
        dwh_dwi = torch.abs((eta_p * eta_p * _dot(wi, wh_tn))
                            / torch.clamp(sqrt_denom * sqrt_denom, min=1e-9))
        trans_pdf = torch.where((~same_hemisphere(wo, wi)) & (wh_t_len > 1e-9),
                                ggx_pdf_wh(wh_tn, alpha) * dwh_dwi, 0.0)
        rough_glass = (mtype == GLASS) & (alpha > ROUGH_GLASS_MIN_ALPHA)
        pdf = torch.where(rough_glass, 0.5 * (mf_pdf + trans_pdf), pdf)
    if has(HAIR) and "sigma_a" in params:
        from pbrt_tpu_torch.materials.hair import hair_pdf

        pdf = torch.where(mtype == HAIR, hair_pdf(params, wo, wi), pdf)
    if has(FOURIER) and "fourier" in params:
        from pbrt_tpu_torch.materials.fourier import fourier_pdf_tbl

        for tbl in params["fourier"]:
            pdf = torch.where(tbl["mask"] & (mtype == FOURIER), fourier_pdf_tbl(tbl, wo, wi),
                              pdf)
    return pdf


def _bsdf_sample_one(params, wo, u_lobe, u2):
    """Sample an outgoing direction from one parameter set.

    Returns (wi [N, 3], f [N, 3], pdf [N], specular [N] bool); on specular
    lanes (mirror, smooth glass) f includes 1/|cos| and pdf is 1.
    """
    mtype = params["type"]
    alpha = params["roughness"]
    eta = params["eta"]
    active = params["_active"]

    def has(*types):
        return any(t in active for t in types)

    sign_o = torch.sign(torch.where(wo[..., 2] == 0.0, 1.0, wo[..., 2]))
    ones = torch.ones_like(sign_o)

    # candidate 1: the cosine-weighted hemisphere on wo's side
    wi_diff = cosine_sample_hemisphere(u2) * torch.stack([ones, ones, sign_o], dim=-1)
    wi = wi_diff

    if has(PLASTIC, UBER, SUBSTRATE, METAL, GLASS):
        # candidate 2: reflection about a GGX half-vector on wo's side
        wh = ggx_sample_wh(u2, alpha) * sign_o[..., None]
        use_mf = (((mtype == PLASTIC) | (mtype == UBER) | (mtype == SUBSTRATE))
                  & (u_lobe >= 0.5)) | (mtype == METAL)
        wi = torch.where(use_mf[..., None], reflect(wo, wh), wi)

    # candidate 3: the perfect mirror
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    if has(MIRROR):
        wi = torch.where((mtype == MIRROR)[..., None], wi_mirror, wi)

    rough_glass = torch.zeros(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    if has(GLASS):
        # candidate 4: smooth glass, reflect or refract by Fresnel, on the
        # true side
        outside = params.get("outside", wo[..., 2] > 0)
        cos_signed = torch.where(outside, torch.abs(wo[..., 2]), -torch.abs(wo[..., 2]))
        f_diel = fresnel_dielectric(cos_signed, torch.ones_like(eta), eta)
        n_oriented = wo.new_tensor([0.0, 0.0, 1.0]) * sign_o[..., None]
        eta_ratio = torch.where(outside, 1.0 / eta, eta)
        wt, tir = refract(wo, n_oriented, eta_ratio)
        wt_norm, _ = _normalize(wt, 1e-12)
        choose_reflect = (u_lobe < f_diel) | tir
        wi_glass = torch.where(choose_reflect[..., None], wi_mirror, wt_norm)

        # candidate 5: rough glass, reflect or refract about the GGX
        # half-vector
        refl_about_wh = reflect(wo, wh)
        wt_wh, tir_wh = refract(wo, wh * torch.sign(_dot(wo, wh, keepdim=True)), eta_ratio)
        wt_wh, _ = _normalize(wt_wh, 1e-12)
        rough_reflect = (u_lobe < 0.5) | tir_wh
        wi_rough_glass = torch.where(rough_reflect[..., None], refl_about_wh, wt_wh)

        rough_glass = (mtype == GLASS) & (alpha > ROUGH_GLASS_MIN_ALPHA)
        wi = torch.where((mtype == GLASS)[..., None], wi_glass, wi)
        wi = torch.where(rough_glass[..., None], wi_rough_glass, wi)

    if has(TRANSLUCENT):
        # translucent: the other side with probability 1/2
        flip = (mtype == TRANSLUCENT) & (u_lobe >= 0.5)
        wi = torch.where(flip[..., None], wi_diff * torch.stack([ones, ones, -ones], dim=-1),
                         wi)

    if has(HAIR) and "sigma_a" in params:
        from pbrt_tpu_torch.materials.hair import hair_sample_wi

        wi = torch.where((mtype == HAIR)[..., None], hair_sample_wi(params, wo, u_lobe, u2), wi)

    if has(FOURIER) and "fourier" in params:
        from pbrt_tpu_torch.materials.fourier import fourier_sample_wi_tbl

        for tbl in params["fourier"]:
            wi = torch.where((tbl["mask"] & (mtype == FOURIER))[..., None],
                             fourier_sample_wi_tbl(tbl, wo, u_lobe, u2), wi)

    specular = (mtype == MIRROR) | ((mtype == GLASS) & ~rough_glass)
    f = _bsdf_eval_one(params, wo, wi)
    pdf = _bsdf_pdf_one(params, wo, wi)
    if has(MIRROR, GLASS):
        abs_ci = torch.clamp(torch.abs(wi[..., 2]), min=1e-7)
        # mirror: FresnelNoOp (pbrt's MirrorMaterial), f = kr / |cos|, pdf 1
        f_spec = params["kr"] / abs_ci[..., None]
        if has(GLASS):
            # reflect with probability F (weight kr), refract with 1 - F and
            # the radiance-transport (eta_i / eta_t)^2 scale (pbrt-v3
            # SpecularTransmission::Sample_f); the branch pdf folds into f
            glass_refl_f = (params["kr"] * (f_diel / torch.clamp(f_diel, min=1e-7))[..., None]
                            / abs_ci[..., None])
            scale_t = eta_ratio * eta_ratio
            glass_trans_f = params["kt"] * scale_t[..., None] / abs_ci[..., None]
            f_glass = torch.where(choose_reflect[..., None], glass_refl_f, glass_trans_f)
            f_spec = torch.where((mtype == GLASS)[..., None], f_glass, f_spec)
        f = torch.where(specular[..., None], f_spec, f)
        pdf = torch.where(specular, 1.0, pdf)
    return wi, f, pdf, specular


# -- the public, mix-aware functions -------------------------------------------


def _mix_b(params):
    """The second child's parameter set, with the true side handed down."""
    pb = params.get("mix_b")
    if pb is not None and "outside" in params:
        pb = {**pb, "outside": params["outside"]}
    return pb


def bsdf_eval(params, wo, wi):
    """f(wo, wi) [N, 3] (specular lobes contribute 0)."""
    f = _bsdf_eval_one(params, wo, wi)
    pb = _mix_b(params)
    if pb is not None:
        amt = params["mix_amt"]
        f = amt * f + (1.0 - amt) * bsdf_eval(pb, wo, wi)
    return f


def bsdf_pdf(params, wo, wi):
    """Solid-angle pdf of :func:`bsdf_sample` on non-specular lanes."""
    pdf = _bsdf_pdf_one(params, wo, wi)
    pb = _mix_b(params)
    if pb is not None:
        pa = params["mix_pa"]
        pdf = pa * pdf + (1.0 - pa) * bsdf_pdf(pb, wo, wi)
    return pdf


def bsdf_sample(params, wo, u_lobe, u2):
    """Sample an outgoing direction -> (wi [N, 3], f [N, 3], pdf [N],
    specular [N] bool).  On specular lanes f includes 1/|cos| and, under a
    mix, the child's blend weight over its selection probability; pdf 1."""
    pb = _mix_b(params)
    if pb is None:
        return _bsdf_sample_one(params, wo, u_lobe, u2)
    pa = params["mix_pa"]
    choose_a = u_lobe < pa
    u_a = torch.clamp(u_lobe / torch.clamp(pa, min=1e-6), 0.0, ONE_MINUS_EPS)
    u_b = torch.clamp((u_lobe - pa) / torch.clamp(1.0 - pa, min=1e-6), 0.0, ONE_MINUS_EPS)
    wi_a, f_a, _, spec_a = _bsdf_sample_one(params, wo, u_a, u2)
    wi_b, f_b, _, spec_b = bsdf_sample(pb, wo, u_b, u2)
    wi = torch.where(choose_a[..., None], wi_a, wi_b)
    spec = torch.where(choose_a, spec_a, spec_b)
    f = bsdf_eval(params, wo, wi)
    pdf = bsdf_pdf(params, wo, wi)
    # a sampled specular child keeps its own delta f, scaled by the blend
    # amount over the selection probability
    amt = params["mix_amt"]
    f_spec = torch.where(
        choose_a[..., None],
        amt * f_a / torch.clamp(pa, min=1e-6)[..., None],
        (1.0 - amt) * f_b / torch.clamp(1.0 - pa, min=1e-6)[..., None],
    )
    f = torch.where(spec[..., None], f_spec, f)
    pdf = torch.where(spec, 1.0, pdf)
    return wi, f, pdf, spec
