"""BSDF evaluation and sampling over a wavefront (counterpart of
``pbrt_tpu/materials/bsdf.py:173-197, 308-639``).

Every lane carries a material type id and SoA parameters; lobes are
evaluated with masked selects.  The diffuse lobe (Lambert and
Oren-Nayar, material ``matte``), the perfect mirror (``mirror``) and
their blends (``mix``) are ported: a parameter set whose static type set
(``params["_active"]``) names any other lobe raises.  Glass, plastic,
metal, substrate, uber, translucent, hair and fourier wait for ROADMAP
Queue 1 item 8.

Mix (pbrt-v3 MixMaterial): ``eval_material_params`` gives a second
parameter set under ``params["mix_b"]`` with the blend ``mix_amt`` and
the selection probability ``mix_pa``.  f and pdf blend linearly;
sampling picks a child by ``mix_pa`` and rescales the lobe sample.  A
child that is itself a mix carries its own ``mix_b``, and the public
functions below recurse into it.

Local shading frame: z = shading normal; wo/wi in local coordinates.  For
specular lobes f already includes 1/|cos| (pdf 1), so the path weight
f |cos| / pdf is the same expression for every lobe.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch import INV_PI, ONE_MINUS_EPSILON, PI
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere

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

PORTED = frozenset({MATTE, MIRROR, NONE})


def _check_ported(params):
    missing = set(params["_active"]) - PORTED
    if missing:
        raise NotImplementedError(
            f"BSDF lobe types {sorted(missing)} are not ported yet "
            "(ROADMAP.md Queue 1 item 8); only the diffuse (matte) and mirror lobes are"
        )


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def oren_nayar_ab(sigma_deg):
    s = sigma_deg * (PI / 180.0)
    s2 = s * s
    return 1.0 - s2 / (2.0 * (s2 + 0.33)), 0.45 * s2 / (s2 + 0.09)


def _diffuse_f(params, wo, wi):
    """Lambert or Oren-Nayar (sigma > 0) diffuse term [N, 3]."""
    a, b = oren_nayar_ab(params["sigma"])
    sin_theta_i = torch.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=0.0))
    sin_theta_o = torch.sqrt(torch.clamp(1.0 - wo[..., 2] ** 2, min=0.0))
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


def _bsdf_eval_one(params, wo, wi):
    """f(wo, wi) [N, 3] of one parameter set (specular lobes contribute 0)."""
    _check_ported(params)
    f = torch.zeros_like(params["kd"])
    if MATTE in params["_active"]:
        hemi = same_hemisphere(wo, wi)[..., None]
        diffuse = torch.where(hemi, _diffuse_f(params, wo, wi), 0.0)
        f = torch.where((params["type"] == MATTE)[..., None], diffuse, f)
    return f


def _bsdf_pdf_one(params, wo, wi):
    """Solid-angle pdf of :func:`_bsdf_sample_one` (0 on specular lanes)."""
    _check_ported(params)
    pdf = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    if MATTE in params["_active"]:
        cos_pdf = torch.where(
            same_hemisphere(wo, wi), torch.abs(wi[..., 2]) * INV_PI, 0.0
        )
        pdf = torch.where(params["type"] == MATTE, cos_pdf, pdf)
    return pdf


def _bsdf_sample_one(params, wo, u_lobe, u2):
    """Sample an outgoing direction from one parameter set.

    Returns (wi [N, 3], f [N, 3], pdf [N], specular [N] bool): the
    cosine-weighted hemisphere on wo's side with f and pdf by evaluation;
    on mirror lanes the reflection of wo with f = kr / |cos| and pdf 1.
    """
    del u_lobe  # no lobe of a ported material chooses between lobes
    _check_ported(params)
    sign_o = torch.sign(torch.where(wo[..., 2] == 0.0, 1.0, wo[..., 2]))
    wi = cosine_sample_hemisphere(u2)
    wi = wi * torch.stack([torch.ones_like(sign_o), torch.ones_like(sign_o), sign_o], dim=-1)
    specular = params["type"] == MIRROR
    if MIRROR in params["_active"]:
        wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
        wi = torch.where(specular[..., None], wi_mirror, wi)
    f = _bsdf_eval_one(params, wo, wi)
    pdf = _bsdf_pdf_one(params, wo, wi)
    if MIRROR in params["_active"]:
        # FresnelNoOp (pbrt's MirrorMaterial): f = kr / |cos|, pdf = 1
        abs_ci = torch.clamp(torch.abs(wi[..., 2]), min=1e-7)
        f = torch.where(specular[..., None], params["kr"] / abs_ci[..., None], f)
        pdf = torch.where(specular, 1.0, pdf)
    return wi, f, pdf, specular


def bsdf_eval(params, wo, wi):
    """f(wo, wi) [N, 3] (specular lobes contribute 0)."""
    f = _bsdf_eval_one(params, wo, wi)
    pb = params.get("mix_b")
    if pb is not None:
        amt = params["mix_amt"]
        f = amt * f + (1.0 - amt) * bsdf_eval(pb, wo, wi)
    return f


def bsdf_pdf(params, wo, wi):
    """Solid-angle pdf of :func:`bsdf_sample` on non-specular lanes."""
    pdf = _bsdf_pdf_one(params, wo, wi)
    pb = params.get("mix_b")
    if pb is not None:
        pa = params["mix_pa"]
        pdf = pa * pdf + (1.0 - pa) * bsdf_pdf(pb, wo, wi)
    return pdf


def bsdf_sample(params, wo, u_lobe, u2):
    """Sample an outgoing direction -> (wi [N, 3], f [N, 3], pdf [N],
    specular [N] bool).  On specular lanes f includes 1/|cos| and, under a
    mix, the child's blend weight over its selection probability; pdf 1."""
    pb = params.get("mix_b")
    if pb is None:
        return _bsdf_sample_one(params, wo, u_lobe, u2)
    pa = params["mix_pa"]
    choose_a = u_lobe < pa
    u_a = torch.clamp(u_lobe / torch.clamp(pa, min=1e-6), 0.0, ONE_MINUS_EPSILON)
    u_b = torch.clamp((u_lobe - pa) / torch.clamp(1.0 - pa, min=1e-6), 0.0, ONE_MINUS_EPSILON)
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
