"""Material table: pbrt material records -> per-lane BSDF parameters
(counterpart of ``pbrt_tpu/materials/__init__.py``).

Scene build produces a list of :class:`MaterialEntry`; at shading time
:func:`eval_material_params` evaluates each entry's textures across the
wavefront and mask-selects into SoA parameter tensors (kd, ks, kr, kt,
roughness as a GGX alpha, eta, metal_eta, metal_k, sigma).  Ported:
``matte``, ``mirror``, ``glass``, ``plastic``, ``metal`` (copper by
default), ``substrate``, ``uber``, ``translucent``, ``disney`` (as the
reference approximates it, by substrate lobes), ``mix`` (nested mixes
included) and the emitter-only ``none``; an unknown name renders as
matte, as in the reference.  ``subsurface`` and ``kdsubsurface`` are a
dielectric interface whose interior medium the scene builder attaches
(``media/scattering.py``).  ``hair`` (Chiang et al., ``materials/hair.py``:
pigment from sigma_a, color or melanin, in that priority) and ``fourier``
(a ``.bsdf`` table, ``materials/fourier.py``; an unreadable file logs an
error and renders as matte) complete pbrt-v3's set.

``theta`` (:func:`material_theta`, ``CompiledScene.initial_theta``) is
the differentiable override: constant-texture slots read their rows from
it, so gradients reach them.  Scenes with mix materials get a split
``{"a": ..., "b": ...}`` theta, one half per child.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core.paramset import TextureParams
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.textures.constant import ConstantTexture

log = logging.getLogger("pbrt_tpu_torch")

_SPECTRUM_SLOTS = ("kd", "ks", "kr", "kt")

# copper (pbrt-v3's metal default) in RGB
COPPER_ETA = np.array([0.200438, 0.924033, 1.10221], dtype=np.float64)
COPPER_K = np.array([3.91295, 2.44763, 2.14219], dtype=np.float64)


@dataclass
class MaterialEntry:
    type_id: int
    textures: Dict[str, object] = field(default_factory=dict)  # slot -> Texture
    remap_roughness: bool = True
    metal_eta: np.ndarray = None  # metal only, [3] float64
    metal_k: np.ndarray = None
    eta_const: float = 1.5
    # hair only (pbrt-v3 HairMaterial): the pigment source and the scales' tilt
    hair_mode: str = ""  # "sigma_a" | "color" | "melanin"
    hair_sigma_a: np.ndarray = None  # melanin mode: the RGB absorption
    hair_alpha: float = 2.0  # degrees
    # mix only (pbrt-v3 MixMaterial): two child entries and the blend texture
    mix_children: Optional[tuple] = None
    mix_amount: object = None
    # fourier only: the loaded .bsdf table (materials/fourier.py)
    fourier_table: object = None


def build_material(record) -> MaterialEntry:
    """MaterialRecord (core/api.py) -> MaterialEntry."""
    tp = TextureParams(
        record.params, record.params, record.float_textures, record.spectrum_textures
    )
    name = record.name

    float_t = tp.float_t

    def spec_tex(pname, default):
        return tp.get_spectrum_texture(pname, np.full(3, default, dtype=float_t))

    def float_tex(pname, default):
        return tp.get_float_texture(pname, default)

    def remap():
        return tp.find_bool("remaproughness", True)

    if name in ("", "none"):
        return MaterialEntry(B.NONE)
    if name == "matte":
        return MaterialEntry(
            B.MATTE, {"kd": spec_tex("Kd", 0.5), "sigma": float_tex("sigma", 0.0)}
        )
    if name == "mirror":
        return MaterialEntry(B.MIRROR, {"kr": spec_tex("Kr", 0.9)})
    if name == "glass":
        return MaterialEntry(
            B.GLASS,
            {"kr": spec_tex("Kr", 1.0), "kt": spec_tex("Kt", 1.0),
             "roughness": float_tex("uroughness", 0.0)},
            eta_const=tp.find_float("eta", tp.find_float("index", 1.5)),
        )
    if name == "plastic":
        return MaterialEntry(
            B.PLASTIC,
            {"kd": spec_tex("Kd", 0.25), "ks": spec_tex("Ks", 0.25),
             "roughness": float_tex("roughness", 0.1)},
            remap_roughness=remap(),
        )
    if name == "metal":
        return MaterialEntry(
            B.METAL,
            {"roughness": float_tex("roughness", 0.01)},
            remap_roughness=remap(),
            metal_eta=np.asarray(tp.find_spectrum("eta", COPPER_ETA.astype(float_t)),
                                 dtype=np.float64),
            metal_k=np.asarray(tp.find_spectrum("k", COPPER_K.astype(float_t)),
                               dtype=np.float64),
        )
    if name == "substrate":
        return MaterialEntry(
            B.SUBSTRATE,
            {"kd": spec_tex("Kd", 0.5), "ks": spec_tex("Ks", 0.5),
             "roughness": float_tex("uroughness", 0.1)},
            remap_roughness=remap(),
        )
    if name == "uber":
        return MaterialEntry(
            B.UBER,
            {"kd": spec_tex("Kd", 0.25), "ks": spec_tex("Ks", 0.25),
             "kr": spec_tex("Kr", 0.0), "kt": spec_tex("Kt", 0.0),
             "roughness": float_tex("roughness", 0.1), "opacity": spec_tex("opacity", 1.0)},
            remap_roughness=remap(),
            eta_const=tp.find_float("eta", tp.find_float("index", 1.5)),
        )
    if name == "translucent":
        return MaterialEntry(
            B.TRANSLUCENT,
            {"kd": spec_tex("Kd", 0.25), "kt": spec_tex("transmit", 0.5),
             "roughness": float_tex("roughness", 0.1)},
        )
    if name == "disney":
        log.warning("Material 'disney' approximated by substrate lobes")
        return MaterialEntry(
            B.SUBSTRATE,
            {"kd": spec_tex("color", 0.5), "ks": spec_tex("color", 0.5),
             "roughness": float_tex("roughness", 0.5)},
        )
    if name == "mix":
        # f = amount f1 + (1 - amount) f2; the children were resolved
        # against the named materials when the record was made
        children = record.mix_children
        if not children or children[0] is None or children[1] is None:
            log.error("mix material missing children; using matte")
            return MaterialEntry(B.MATTE, {"kd": spec_tex("Kd", 0.5)})
        kids = [build_material(ch) for ch in children]
        return MaterialEntry(kids[0].type_id, mix_children=(kids[0], kids[1]),
                             mix_amount=spec_tex("amount", 0.5))
    if name in ("subsurface", "kdsubsurface"):
        # a dielectric interface (pbrt-v3 SubsurfaceMaterial's specular or
        # microfacet dielectric); the builder gives the shape the interior
        # medium (media/scattering.py) that volpath traces
        return MaterialEntry(
            B.GLASS,
            {"kr": spec_tex("Kr", 1.0), "kt": spec_tex("Kt", 1.0),
             "roughness": float_tex("uroughness", 0.0)},
            remap_roughness=remap(),
            eta_const=tp.find_float("eta", 1.33),
        )
    if name == "hair":
        # pbrt-v3 CreateHairMaterial's pigment priority: sigma_a > color >
        # eumelanin/pheomelanin > the default brown (ce = 1.3)
        from pbrt_tpu_torch.materials.hair import sigma_a_from_concentration

        e = MaterialEntry(B.HAIR, {"beta_m": float_tex("beta_m", 0.3),
                                   "beta_n": float_tex("beta_n", 0.3)})
        e.eta_const = tp.find_float("eta", 1.55)
        e.hair_alpha = tp.find_float("alpha", 2.0)
        sig = tp.get_spectrum_texture_or_none("sigma_a")
        col = tp.get_spectrum_texture_or_none("color")
        ce = tp.get_float_texture_or_none("eumelanin")
        cp = tp.get_float_texture_or_none("pheomelanin")
        if sig is not None:
            e.hair_mode = "sigma_a"
            e.textures["sigma_a"] = sig
        elif col is not None:
            e.hair_mode = "color"
            e.textures["sigma_a"] = col  # converted at evaluation (needs beta_n)
        else:
            def const_of(t, d):
                return (float(np.asarray(t.value).reshape(-1)[0])
                        if isinstance(t, ConstantTexture) else d)

            ce_v = const_of(ce, 0.0) if ce is not None else 0.0
            cp_v = const_of(cp, 0.0) if cp is not None else 0.0
            if ce is None and cp is None:
                ce_v = 1.3
            e.hair_mode = "melanin"
            e.hair_sigma_a = sigma_a_from_concentration(ce_v, cp_v).astype(float_t)
        return e
    if name == "fourier":
        from pbrt_tpu_torch.materials.fourier import FourierTable

        fname = tp.find_filename("bsdffile", "")
        try:
            table = FourierTable.read(fname)
        except (OSError, ValueError) as err:
            log.error("fourier material: %s; using matte", err)
            return MaterialEntry(B.MATTE, {"kd": spec_tex("Kd", 0.5)})
        return MaterialEntry(B.FOURIER, eta_const=table.eta, fourier_table=table)
    log.warning("Material '%s' unknown; using matte.", name)
    return MaterialEntry(B.MATTE, {"kd": spec_tex("Kd", 0.5)})


def iter_entries_deep(entries):
    """Every MaterialEntry, each mix entry followed by its children
    (depth first): the order in which build-time scans meet textures."""
    for e in entries:
        yield e
        if e.mix_children is not None:
            yield from iter_entries_deep(list(e.mix_children))


def _entry_masks(entries, mat_id):
    """(entry, lane mask) for each distinct entry object of ``entries``, in
    the order of first appearance.  The shapes after one ``Material``
    directive hold one entry at indices of their own (scene/builder.py), so
    a scene of thousands of them evaluates it once, not once an index."""
    first = {}
    group = [first.setdefault(id(e), len(first)) for e in entries]
    if len(first) == len(entries):
        return [(e, mat_id == k) for k, e in enumerate(entries)]
    uniq = list({id(e): e for e in entries}.values())
    lut = torch.tensor(group, dtype=torch.int32, device=mat_id.device)
    g = torch.where(mat_id >= 0, lut[torch.clamp(mat_id, min=0).long()], -1)
    return [(e, g == j) for j, e in enumerate(uniq)]


def _split(entries, half):
    """The entry list of one mix child: each mix entry replaced by its
    child ``half`` (0 or 1), the others kept, indices unchanged."""
    return [e.mix_children[half] if e.mix_children is not None else e for e in entries]


def material_theta(entries, device, float_t=np.float32):
    """The differentiable constant-parameter dict of ``entries``: [M, 3]
    kd/ks/kr/kt and [M] roughness/sigma rows on ``device``; rows of
    slots without a constant texture hold defaults and are not read.  A
    list holding mix entries gives ``{"a": ..., "b": ...}``, one half per
    child list, nesting as the mixes nest; every row in the policy's float
    ``float_t``."""
    if any(e.mix_children is not None for e in entries):
        return {"a": material_theta(_split(entries, 0), device, float_t),
                "b": material_theta(_split(entries, 1), device, float_t)}
    return _material_theta_flat(entries, device, float_t)


def _material_theta_flat(entries, device, float_t):
    m = len(entries)
    out = {slot: np.zeros((m, 3), dtype=float_t) for slot in _SPECTRUM_SLOTS}
    out["roughness"] = np.full((m,), 0.1, dtype=float_t)
    out["sigma"] = np.zeros((m,), dtype=float_t)
    for k, e in enumerate(entries):
        for slot in _SPECTRUM_SLOTS:
            tex = e.textures.get(slot)
            if isinstance(tex, ConstantTexture):
                v = np.asarray(tex.value, dtype=float_t).reshape(-1)
                out[slot][k] = v if v.size == 3 else np.full(3, float(v[0]))
        for slot in ("roughness", "sigma"):
            tex = e.textures.get(slot)
            if isinstance(tex, ConstantTexture):
                out[slot][k] = float(np.asarray(tex.value).reshape(-1)[0])
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def eval_material_params(entries, mat_id, si, theta=None):
    """Evaluate all material entries over the wavefront -> SoA params
    (type, kd, ks, kr, kt, roughness, eta, metal_eta, metal_k, sigma and
    the static type set ``_active``).

    mat_id: [N] int32 indices into ``entries`` (-1 = background/none).
    theta: optional override from :func:`material_theta` (plus
    ``tex_images``): constant-texture slots then read their rows from it.
    Mix materials give a second complete parameter set under
    ``params["mix_b"]``, the per-channel blend ``mix_amt`` [N, 3] and
    the luminance selection probability ``mix_pa`` [N] (bsdf.py's
    wrappers read them); nested mixes nest.
    """
    if not any(e.mix_children is not None for e in entries):
        return _eval_material_params_single(entries, mat_id, si, theta)
    theta_a = theta_b = None
    if theta is not None:
        if "a" not in theta:
            raise ValueError(
                "mix scenes need the split {a, b} theta from material_theta; "
                "got a flat parameter dict"
            )
        tex = {"tex_images": theta["tex_images"]} if "tex_images" in theta else {}
        theta_a = {**theta["a"], **tex}
        theta_b = {**theta["b"], **tex}
    params = eval_material_params(_split(entries, 0), mat_id, si, theta_a)
    params_b = eval_material_params(_split(entries, 1), mat_id, si, theta_b)
    n = mat_id.shape[0]
    dev = mat_id.device
    amt = torch.ones((n, 3), dtype=params["kd"].dtype, device=dev)
    is_mix = torch.zeros((n,), dtype=torch.bool, device=dev)
    for e, mask in _entry_masks(entries, mat_id):
        if e.mix_children is None:
            continue
        v = e.mix_amount.eval(si)
        if v.dim() == 1:
            v = v[..., None] * torch.ones((1, 3), dtype=v.dtype, device=dev)
        amt = torch.where(mask[..., None], torch.clamp(v, 0.0, 1.0), amt)
        is_mix = is_mix | mask
    y = torch.tensor([0.212671, 0.715160, 0.072169], dtype=amt.dtype, device=dev)
    pa = torch.sum(amt * y, dim=-1)
    params["mix_b"] = params_b
    params["mix_amt"] = amt
    params["mix_pa"] = torch.where(is_mix, torch.clamp(pa, 1e-3, 1.0 - 1e-3), 1.0)
    return params


def _eval_material_params_single(entries, mat_id, si, theta=None):
    """One entry list over the wavefront -> SoA params."""
    n = mat_id.shape[0]
    dev = mat_id.device
    # the scene's float (the reference's fallback where no point is given)
    dt = si["p"].dtype if "p" in si else torch.float32
    zeros1 = torch.zeros((n,), dtype=dt, device=dev)
    params = {
        "type": torch.full((n,), B.NONE, dtype=torch.int32, device=dev),
        **{slot: torch.zeros((n, 3), dtype=dt, device=dev) for slot in _SPECTRUM_SLOTS},
        "roughness": zeros1 + 1e-3,
        "eta": zeros1 + 1.5,
        "metal_eta": torch.as_tensor(COPPER_ETA, dtype=dt, device=dev).expand(n, 3),
        "metal_k": torch.as_tensor(COPPER_K, dtype=dt, device=dev).expand(n, 3),
        "sigma": zeros1,
        # static set of present material types: lobe code for absent
        # types is skipped
        "_active": frozenset(e.type_id for e in entries),
    }
    if theta is not None and "tex_images" in theta:
        si = {**si, "_tex": theta["tex_images"]}

    def put(slot, mask, val):
        m = mask[..., None] if params[slot].dim() == 2 else mask
        params[slot] = torch.where(m, val, params[slot])

    safe_id = torch.clamp(mat_id, 0, max(len(entries) - 1, 0)).long()
    masks = _entry_masks(entries, mat_id)
    for e, mask in masks:
        put("type", mask, torch.tensor(e.type_id, dtype=torch.int32, device=dev))
        for slot in _SPECTRUM_SLOTS:
            tex = e.textures.get(slot)
            if tex is None:
                continue
            if theta is not None and isinstance(tex, ConstantTexture):
                v = theta[slot][safe_id]
            else:
                v = tex.eval(si)
                if v.dim() == 1:
                    v = v[..., None] * torch.ones((1, 3), dtype=v.dtype, device=dev)
            put(slot, mask, v)
        rtex = e.textures.get("roughness")
        if rtex is not None:
            if theta is not None and isinstance(rtex, ConstantTexture):
                r = theta["roughness"][safe_id]
            else:
                r = rtex.eval(si)
                if r.dim() > 1:
                    r = r.mean(dim=-1)
            raw = r
            if e.remap_roughness:
                r = B.roughness_to_alpha(r)
            # zero roughness means perfectly smooth (specular glass) and
            # survives the remap
            put("roughness", mask, torch.where(raw <= 1e-5, 1e-4, torch.clamp(r, min=1e-3)))
        stex = e.textures.get("sigma")
        if stex is not None:
            if theta is not None and isinstance(stex, ConstantTexture):
                s = theta["sigma"][safe_id]
            else:
                s = stex.eval(si)
                if s.dim() > 1:
                    s = s.mean(dim=-1)
            put("sigma", mask, s)
        put("eta", mask, torch.tensor(e.eta_const, dtype=dt, device=dev))
        if e.metal_eta is not None:
            # float32 in either policy, as in the reference
            put("metal_eta", mask, torch.as_tensor(e.metal_eta.astype(np.float32), device=dev))
            put("metal_k", mask, torch.as_tensor(e.metal_k.astype(np.float32), device=dev))

    # the hair parameter block, present only when the scene has hair
    if any(e.type_id == B.HAIR for e in entries):
        from pbrt_tpu_torch.materials.hair import sigma_a_from_reflectance

        params["sigma_a"] = torch.zeros((n, 3), dtype=dt, device=dev)
        params["beta_m"] = zeros1 + 0.3
        params["beta_n"] = zeros1 + 0.3
        params["hair_alpha"] = zeros1 + 2.0
        for e, mask in masks:
            if e.type_id != B.HAIR:
                continue

            def fval(slot, default):
                tex = e.textures.get(slot)
                if tex is None:
                    return torch.full((n,), default, dtype=dt, device=dev)
                v = tex.eval(si)
                return v.mean(dim=-1) if v.dim() > 1 else v

            beta_m = fval("beta_m", 0.3)
            beta_n = fval("beta_n", 0.3)
            put("beta_m", mask, beta_m)
            put("beta_n", mask, beta_n)
            put("hair_alpha", mask, torch.tensor(e.hair_alpha, dtype=dt, device=dev))
            if e.hair_mode == "melanin":
                sig = torch.as_tensor(e.hair_sigma_a, device=dev).expand(n, 3)
            else:
                sig = e.textures["sigma_a"].eval(si)
                if sig.dim() == 1:
                    sig = sig[..., None] * torch.ones((1, 3), dtype=sig.dtype, device=dev)
                if e.hair_mode == "color":
                    sig = sigma_a_from_reflectance(sig, beta_n[..., None])
            put("sigma_a", mask, sig)

    # fourier tables: one device bundle per fourier entry
    if any(e.type_id == B.FOURIER for e in entries):
        float_t = np.float64 if dt == torch.float64 else np.float32
        params["fourier"] = [{**e.fourier_table.device_arrays(dev, float_t), "mask": mask}
                             for e, mask in masks if e.type_id == B.FOURIER]
    return params
