"""Typed parameter dictionaries for scene directives (copy of ``pbrt_tpu/core/paramset.py``).

Mirrors the reference ``ParamSet`` (the Rust reference's src/core/paramset.rs):
a typed heterogeneous dictionary with per-item used-tracking and
``report_unused`` config hygiene, plus the two-level ``TextureParams``
lookup (geometry params shadow material params, paramset.rs:549-590).

Divergences from the reference (deliberate, SURVEY.md §2.1):
  * ``find_one_*`` on a type mismatch logs an error and returns the default
    instead of panicking (the reference panics, contradicting its own doc,
    paramset.rs:241).
  * ``add_blackbody`` / ``add_sampled_spectrum{_files}`` are implemented
    (``todo!()`` in the reference, paramset.rs:197-207) — blackbody pairs
    are converted through Planck emission to RGB, sampled spectra are
    integrated against the CIE fits.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from pbrt_tpu_torch.core import spectrum as spec

log = logging.getLogger("pbrt_tpu_torch")

# Value kinds
BOOL = "bool"
FLOAT = "float"
INT = "int"
POINT2 = "point2"
VECTOR2 = "vector2"
POINT3 = "point3"
VECTOR3 = "vector3"
NORMAL3 = "normal3"
STRING = "string"
TEXTURE = "texture"
SPECTRUM = "spectrum"


class _Item:
    __slots__ = ("kind", "values", "looked_up")

    def __init__(self, kind: str, values):
        self.kind = kind
        self.values = values
        self.looked_up = False


class ParamSet:
    """Typed parameter set with used-tracking (paramset.rs:109-531)."""

    def __init__(self, float_t=np.float32):
        self._items: Dict[str, _Item] = {}
        self.float_t = float_t  # the policy's float (pbrt_tpu_torch.float_type)

    # -- adders (paramset.rs:143-215) -------------------------------------

    def _add(self, name: str, kind: str, values) -> None:
        self._items[name] = _Item(kind, values)

    def add_bool(self, name, values: List[bool]):
        self._add(name, BOOL, list(values))

    def add_int(self, name, values: List[int]):
        self._add(name, INT, [int(v) for v in values])

    def add_float(self, name, values):
        self._add(name, FLOAT, np.asarray(values, dtype=self.float_t))

    def add_point2f(self, name, values):
        self._add(name, POINT2, np.asarray(values, dtype=self.float_t).reshape(-1, 2))

    def add_vector2f(self, name, values):
        self._add(name, VECTOR2, np.asarray(values, dtype=self.float_t).reshape(-1, 2))

    def add_point3f(self, name, values):
        self._add(name, POINT3, np.asarray(values, dtype=self.float_t).reshape(-1, 3))

    def add_vector3f(self, name, values):
        self._add(name, VECTOR3, np.asarray(values, dtype=self.float_t).reshape(-1, 3))

    def add_normal3f(self, name, values):
        self._add(name, NORMAL3, np.asarray(values, dtype=self.float_t).reshape(-1, 3))

    def add_string(self, name, values: List[str]):
        self._add(name, STRING, list(values))

    def add_texture(self, name, value: str):
        self._add(name, TEXTURE, [value])

    def add_rgb_spectrum(self, name, values):
        """Flat [r,g,b,...] floats -> [N,3] RGB spectra (paramset.rs:175-184)."""
        self._add(name, SPECTRUM, np.asarray(values, dtype=self.float_t).reshape(-1, 3))

    def add_xyz_spectrum(self, name, values):
        xyz = np.asarray(values, dtype=self.float_t).reshape(-1, 3)
        self._add(name, SPECTRUM, spec.xyz_to_rgb(xyz, self.float_t))

    def add_blackbody(self, name, values):
        """Pairs of (temperature K, scale) -> RGB (paramset.rs:197-199 done)."""
        vals = np.asarray(values, dtype=np.float64).reshape(-1, 2)
        rgb = np.stack(
            [spec.blackbody_to_rgb(t, s, self.float_t) for t, s in vals], axis=0
        ).astype(self.float_t)
        self._add(name, SPECTRUM, rgb)

    def add_sampled_spectrum(self, name, values):
        """Pairs of (wavelength nm, value) -> RGB via CIE integration."""
        vals = np.asarray(values, dtype=np.float64).reshape(-1, 2)
        wl, v = vals[:, 0], vals[:, 1]
        order = np.argsort(wl)
        wl, v = wl[order], v[order]
        bucket_wl = spec._bucket_wavelengths()
        resampled = np.interp(bucket_wl, wl, v, left=v[0] if len(v) else 0.0, right=v[-1] if len(v) else 0.0)
        self._add(name, SPECTRUM, spec.sampled_to_rgb(resampled, self.float_t)[None, :])

    def add_sampled_spectrum_files(self, name, filenames: List[str]):
        from pbrt_tpu_torch.core.floatfile import read_float_file
        from pbrt_tpu_torch.core.fileutil import resolve_filename

        rgbs = []
        for fn in filenames:
            try:
                vals = read_float_file(str(resolve_filename(fn)), self.float_t)
            except OSError as e:
                log.error("Unable to read spectrum file '%s': %s", fn, e)
                vals = []
            vals = np.asarray(vals, dtype=np.float64)
            if len(vals) % 2:
                log.warning("Odd value count in spectrum file '%s'", fn)
                vals = vals[:-1]
            pairs = vals.reshape(-1, 2)
            if len(pairs) == 0:
                rgbs.append(np.zeros(3, dtype=self.float_t))
                continue
            order = np.argsort(pairs[:, 0])
            wl, v = pairs[order, 0], pairs[order, 1]
            bucket_wl = spec._bucket_wavelengths()
            resampled = np.interp(bucket_wl, wl, v, left=v[0], right=v[-1])
            rgbs.append(spec.sampled_to_rgb(resampled, self.float_t))
        self._add(name, SPECTRUM, np.stack(rgbs, axis=0).astype(self.float_t))

    # -- getters (paramset.rs:237-513) ------------------------------------

    def _find_one(self, name: str, kind: str, default):
        item = self._items.get(name)
        if item is None:
            return default
        if item.kind != kind:
            log.error(
                "Parameter '%s' has type '%s', expected '%s'; using default.",
                name,
                item.kind,
                kind,
            )
            return default
        item.looked_up = True
        vals = item.values
        if len(vals) == 0:
            return default
        return vals[0]

    def find_one_bool(self, name, default: bool) -> bool:
        return bool(self._find_one(name, BOOL, default))

    def find_one_float(self, name, default: float) -> float:
        return float(self._find_one(name, FLOAT, default))

    def find_one_int(self, name, default: int) -> int:
        return int(self._find_one(name, INT, default))

    def find_one_point2f(self, name, default):
        v = self._find_one(name, POINT2, None)
        return np.asarray(default if v is None else v, dtype=self.float_t)

    def find_one_vector2f(self, name, default):
        v = self._find_one(name, VECTOR2, None)
        return np.asarray(default if v is None else v, dtype=self.float_t)

    def find_one_point3f(self, name, default):
        v = self._find_one(name, POINT3, None)
        return np.asarray(default if v is None else v, dtype=self.float_t)

    def find_one_vector3f(self, name, default):
        v = self._find_one(name, VECTOR3, None)
        return np.asarray(default if v is None else v, dtype=self.float_t)

    def find_one_normal3f(self, name, default):
        v = self._find_one(name, NORMAL3, None)
        return np.asarray(default if v is None else v, dtype=self.float_t)

    def find_one_spectrum_raw(self, name, default):
        """RGB value with no spectral-pass promotion — for callers that
        combine several RGB factors (e.g. light L x scale x map) and must
        promote the *product* exactly once."""
        v = self._find_one(name, SPECTRUM, None)
        return np.asarray(default if v is None else v, dtype=self.float_t)

    def find_one_spectrum(self, name, default, illuminant: bool = False):
        out = self.find_one_spectrum_raw(name, default)
        # active spectral pass: RGB -> 3 wavelength-bin samples.  Emission
        # values pass illuminant=True (illuminant basis); everything else
        # is a reflectance.
        from pbrt_tpu_torch.core.spectrum import promote_rgb

        return promote_rgb(out, illuminant=illuminant, float_t=self.float_t)

    def find_one_string(self, name, default: str) -> str:
        return str(self._find_one(name, STRING, default))

    def find_one_filename(self, name, default: str) -> str:
        from pbrt_tpu_torch.core.fileutil import resolve_filename

        fn = self.find_one_string(name, "")
        if fn == "":
            return default
        return str(resolve_filename(fn))

    def find_one_texture(self, name, default: str) -> str:
        return str(self._find_one(name, TEXTURE, default))

    # -- whole-list getters (pbrt-v3 FindX) --------------------------------

    def _find(self, name: str, kind: str):
        item = self._items.get(name)
        if item is None or item.kind != kind:
            return None
        item.looked_up = True
        return item.values

    def find_float(self, name):
        return self._find(name, FLOAT)

    def find_int(self, name):
        return self._find(name, INT)

    def find_bool(self, name):
        return self._find(name, BOOL)

    def find_point2f(self, name):
        return self._find(name, POINT2)

    def find_vector2f(self, name):
        return self._find(name, VECTOR2)

    def find_point3f(self, name):
        return self._find(name, POINT3)

    def find_vector3f(self, name):
        return self._find(name, VECTOR3)

    def find_normal3f(self, name):
        return self._find(name, NORMAL3)

    def find_spectrum(self, name):
        v = self._find(name, SPECTRUM)
        if v is None:
            return None
        from pbrt_tpu_torch.core.spectrum import promote_rgb

        return promote_rgb(np.asarray(v, dtype=self.float_t), float_t=self.float_t)

    def find_string(self, name):
        return self._find(name, STRING)

    # -- hygiene (paramset.rs:519-531) -------------------------------------

    def report_unused(self) -> bool:
        any_unused = False
        for name, item in self._items.items():
            if not item.looked_up:
                log.warning("Parameter '%s' not used", name)
                any_unused = True
        return any_unused

    def mark_all_used(self) -> None:
        for item in self._items.values():
            item.looked_up = True

    # -- misc ---------------------------------------------------------------

    def __contains__(self, name) -> bool:
        return name in self._items

    def __len__(self) -> int:
        return len(self._items)

    def keys(self):
        return self._items.keys()

    def kind_of(self, name) -> Optional[str]:
        item = self._items.get(name)
        return item.kind if item else None

    def raw(self, name):
        item = self._items.get(name)
        return item.values if item else None

    def __repr__(self):
        parts = ", ".join(f"{k}:{v.kind}[{len(v.values)}]" for k, v in self._items.items())
        return f"ParamSet({parts})"

    def __eq__(self, other):
        if not isinstance(other, ParamSet):
            return NotImplemented
        if set(self._items) != set(other._items):
            return False
        for k, it in self._items.items():
            ot = other._items[k]
            if it.kind != ot.kind:
                return False
            a, b = np.asarray(it.values, dtype=object), np.asarray(ot.values, dtype=object)
            try:
                if not np.array_equal(np.asarray(it.values), np.asarray(ot.values)):
                    return False
            except Exception:
                if list(it.values) != list(ot.values):
                    return False
        return True

    def copy(self) -> "ParamSet":
        ps = ParamSet(self.float_t)
        for k, it in self._items.items():
            ps._items[k] = _Item(it.kind, it.values)
        return ps


class TextureParams:
    """Two-level (geometry-then-material) parameter lookup with texture
    indirection (paramset.rs:549-590)."""

    def __init__(self, geom_params: ParamSet, material_params: ParamSet,
                 float_textures: Dict[str, Any], spectrum_textures: Dict[str, Any]):
        self.geom_params = geom_params
        self.material_params = material_params
        self.float_t = material_params.float_t
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures

    def find_float(self, name, default: float) -> float:
        return self.geom_params.find_one_float(
            name, self.material_params.find_one_float(name, default)
        )

    def find_int(self, name, default: int) -> int:
        return self.geom_params.find_one_int(
            name, self.material_params.find_one_int(name, default)
        )

    def find_bool(self, name, default: bool) -> bool:
        return self.geom_params.find_one_bool(
            name, self.material_params.find_one_bool(name, default)
        )

    def find_string(self, name, default: str = "") -> str:
        return self.geom_params.find_one_string(
            name, self.material_params.find_one_string(name, default)
        )

    def find_filename(self, name, default: str = "") -> str:
        return self.geom_params.find_one_filename(
            name, self.material_params.find_one_filename(name, default)
        )

    def find_spectrum(self, name, default):
        return self.geom_params.find_one_spectrum(
            name, self.material_params.find_one_spectrum(name, default)
        )

    def find_vector3f(self, name, default):
        return self.geom_params.find_one_vector3f(
            name, self.material_params.find_one_vector3f(name, default)
        )

    def find_point3f(self, name, default):
        return self.geom_params.find_one_point3f(
            name, self.material_params.find_one_point3f(name, default)
        )

    def get_spectrum_texture(self, name, default_rgb):
        """Resolve to a texture object: named texture > spectrum constant >
        float constant > default (pbrt-v3 TextureParams::GetSpectrumTexture)."""
        from pbrt_tpu_torch.textures.constant import ConstantTexture

        for ps in (self.geom_params, self.material_params):
            if ps.kind_of(name) == TEXTURE:
                tex_name = ps.find_one_texture(name, "")
                tex = self.spectrum_textures.get(tex_name)
                if tex is not None:
                    return tex
                log.error("Couldn't find spectrum texture named '%s' for parameter '%s'", tex_name, name)
            if ps.kind_of(name) == SPECTRUM:
                return ConstantTexture(ps.find_one_spectrum(name, default_rgb), self.float_t)
            if ps.kind_of(name) == FLOAT:
                v = ps.find_one_float(name, 1.0)
                return ConstantTexture(np.array([v, v, v], dtype=self.float_t), self.float_t)
        return ConstantTexture(np.asarray(default_rgb, dtype=self.float_t), self.float_t)

    def get_float_texture(self, name, default: float):
        from pbrt_tpu_torch.textures.constant import ConstantTexture

        for ps in (self.geom_params, self.material_params):
            if ps.kind_of(name) == TEXTURE:
                tex_name = ps.find_one_texture(name, "")
                tex = self.float_textures.get(tex_name)
                if tex is not None:
                    return tex
                log.error("Couldn't find float texture named '%s' for parameter '%s'", tex_name, name)
            if ps.kind_of(name) == FLOAT:
                return ConstantTexture(np.asarray(ps.find_one_float(name, default), dtype=self.float_t), self.float_t)
        return ConstantTexture(np.asarray(default, dtype=self.float_t), self.float_t)

    def get_spectrum_texture_or_none(self, name):
        from pbrt_tpu_torch.textures.constant import ConstantTexture

        for ps in (self.geom_params, self.material_params):
            if ps.kind_of(name) == TEXTURE:
                tex_name = ps.find_one_texture(name, "")
                tex = self.spectrum_textures.get(tex_name)
                if tex is not None:
                    return tex
                log.error("Couldn't find spectrum texture named '%s' for parameter '%s'", tex_name, name)
                return None
            if ps.kind_of(name) == SPECTRUM:
                return ConstantTexture(ps.find_one_spectrum(name, np.zeros(3, dtype=self.float_t)), self.float_t)
            if ps.kind_of(name) == FLOAT:
                v = ps.find_one_float(name, 0.0)
                return ConstantTexture(np.array([v, v, v], dtype=self.float_t), self.float_t)
        return None

    def get_float_texture_or_none(self, name):
        from pbrt_tpu_torch.textures.constant import ConstantTexture

        for ps in (self.geom_params, self.material_params):
            if ps.kind_of(name) == TEXTURE:
                tex_name = ps.find_one_texture(name, "")
                tex = self.float_textures.get(tex_name)
                if tex is not None:
                    return tex
                log.error("Couldn't find float texture named '%s' for parameter '%s'", tex_name, name)
                return None
            if ps.kind_of(name) == FLOAT:
                return ConstantTexture(np.asarray(ps.find_one_float(name, 0.0), dtype=self.float_t), self.float_t)
        return None

    def report_unused(self):
        self.geom_params.report_unused()
