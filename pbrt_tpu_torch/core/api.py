"""The pbrt API state machine (copy of ``pbrt_tpu/core/api.py``).

Implements the full pbrt-v3 ``pbrtXxx()`` API surface that the reference
declares (the Rust reference's src/core/api.rs:70-146): a three-state machine
``Uninitialized -> OptionsBlock -> WorldBlock`` (api.rs:149-154), the
current-transform-matrix managed as a 2-slot animated ``TransformSet`` with
active-bits masking (api.rs:157-198), option-block accumulation in
``RenderOptions`` with defaults box/image/halton/bvh/path/perspective
(api.rs:226-249), world-block ``GraphicsState`` with attribute/transform
stacks (api.rs:481-522) and named coordinate systems (api.rs:734-747).

``world_end`` hands the accumulated :class:`SceneDescription` to
``render.render_scene`` on the API's ``device`` (``render_on_world_end``,
the CLI path) and keeps the result in ``last_render``; with it off,
callers build ``render.Renderer`` from ``api.scene``.

State-guard behavior mirrors the verify macros (api.rs:291-332): errors are
logged and the call is ignored; ``strict=True`` raises instead (the
analogue of the reference's ``debug_assert``).

Deliberately not inherited (SURVEY.md §2.1 bug list): the Transform-Mul
inverse-order bug, the inverted medium-interface condition (api.rs:275,281),
and the ``AttrbuteBegin`` parser typo.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from pbrt_tpu_torch import Options, float_type
from pbrt_tpu_torch.core import parser as parser_mod
from pbrt_tpu_torch.core.paramset import ParamSet, TextureParams
from pbrt_tpu_torch.core.transform import Transform

log = logging.getLogger("pbrt_tpu_torch")

# API states (api.rs:149-154)
UNINITIALIZED = 0
OPTIONS_BLOCK = 1
WORLD_BLOCK = 2

MAX_TRANSFORMS = 2
START_TRANSFORM_BITS = 1
END_TRANSFORM_BITS = 2
ALL_TRANSFORMS_BITS = (1 << MAX_TRANSFORMS) - 1


class TransformSet:
    """Two-slot (start/end time) transform set (api.rs:162-198)."""

    __slots__ = ("t",)

    def __init__(self, t=None):
        self.t = list(t) if t is not None else [Transform.identity(), Transform.identity()]

    def __getitem__(self, i) -> Transform:
        return self.t[i]

    def __setitem__(self, i, v: Transform) -> None:
        self.t[i] = v

    def is_animated(self) -> bool:
        for i in range(MAX_TRANSFORMS - 1):
            if self.t[i] != self.t[i + 1]:
                return True
        return False

    def inverse(self) -> "TransformSet":
        return TransformSet([t.inverse() for t in self.t])

    def copy(self) -> "TransformSet":
        return TransformSet(list(self.t))


@dataclasses.dataclass
class MaterialRecord:
    """Deferred material: created per-shape from graphics state (pbrt-v3
    GraphicsState::CreateMaterial)."""

    name: str
    params: ParamSet
    float_textures: Dict[str, Any]
    spectrum_textures: Dict[str, Any]
    named: Optional[str] = None  # set when NamedMaterial is active
    # "mix" materials: the two child records, resolved against the
    # named-material registry at record time (pbrt-v3 api.cpp MakeMaterial
    # looks up namedmaterial1/2 when the material is created)
    mix_children: Optional[tuple] = None


@dataclasses.dataclass
class ShapeRecord:
    """A shape plus the graphics state snapshotted at its directive."""

    name: str
    params: ParamSet
    object_to_world: Transform
    world_to_object: Transform
    reverse_orientation: bool
    material: MaterialRecord
    area_light_name: str = ""
    area_light_params: Optional[ParamSet] = None
    inside_medium: str = ""
    outside_medium: str = ""
    object_instance: Optional[str] = None  # name while inside ObjectBegin
    # end-slot (time transform_end_time) object-to-world when the shape was
    # declared under an animated CTM (api.rs:157-198 2-slot TransformSet);
    # None = static
    object_to_world_end: Optional[Transform] = None


@dataclasses.dataclass
class LightRecord:
    name: str
    params: ParamSet
    light_to_world: Transform
    medium: str = ""


@dataclasses.dataclass
class SceneDescription:
    """Everything world_end needs to build device tables and render."""

    filter_name: str = "box"
    filter_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    film_name: str = "image"
    film_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    sampler_name: str = "halton"
    sampler_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    integrator_name: str = "path"
    integrator_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    camera_name: str = "perspective"
    camera_params: ParamSet = dataclasses.field(default_factory=ParamSet)
    camera_to_world: TransformSet = dataclasses.field(default_factory=TransformSet)
    shapes: List[ShapeRecord] = dataclasses.field(default_factory=list)
    lights: List[LightRecord] = dataclasses.field(default_factory=list)
    named_media: Dict[str, ParamSet] = dataclasses.field(default_factory=dict)
    instances: Dict[str, List[ShapeRecord]] = dataclasses.field(default_factory=dict)
    instance_uses: List[tuple] = dataclasses.field(default_factory=list)
    transform_start_time: float = 0.0
    transform_end_time: float = 1.0
    have_scattering_media: bool = False
    camera_medium: str = ""
    float_t: type = np.float32  # the policy's float of every ParamSet here

    @classmethod
    def for_float(cls, float_t) -> "SceneDescription":
        """An empty description whose parameter sets hold ``float_t``."""
        return cls(**{f.name: ParamSet(float_t) for f in dataclasses.fields(cls)
                      if f.name.endswith("_params")}, float_t=float_t)


class _GraphicsState:
    """World-block attribute state (api.rs:251-289 + pbrt-v3 fields)."""

    def __init__(self, float_t=np.float32):
        self.float_t = float_t
        self.current_inside_medium = ""
        self.current_outside_medium = ""
        self.float_textures: Dict[str, Any] = {}
        self.spectrum_textures: Dict[str, Any] = {}
        self.material_name = "matte"
        self.material_params = ParamSet(float_t)
        self.named_materials: Dict[str, MaterialRecord] = {}
        self.current_named_material: Optional[str] = None
        self.area_light_name = ""
        self.area_light_params: Optional[ParamSet] = None
        self.reverse_orientation = False
        # the record that the shapes after a ``Material`` directive copy
        # (pbrt-v3's currentMaterial), made at the first such shape and
        # dropped when the material, a texture or a named material changes
        self.material_record: Optional[MaterialRecord] = None

    def copy(self) -> "_GraphicsState":
        gs = _GraphicsState(self.float_t)
        gs.current_inside_medium = self.current_inside_medium
        gs.current_outside_medium = self.current_outside_medium
        gs.float_textures = dict(self.float_textures)
        gs.spectrum_textures = dict(self.spectrum_textures)
        gs.material_name = self.material_name
        gs.material_params = self.material_params.copy()
        gs.named_materials = dict(self.named_materials)
        gs.current_named_material = self.current_named_material
        gs.area_light_name = self.area_light_name
        gs.area_light_params = (
            self.area_light_params.copy() if self.area_light_params else None
        )
        gs.reverse_orientation = self.reverse_orientation
        gs.material_record = self.material_record
        return gs

    def make_material_record(self) -> MaterialRecord:
        if self.current_named_material is not None:
            rec = self.named_materials.get(self.current_named_material)
            if rec is not None:
                return rec
            log.error(
                "Named material '%s' not defined; using default matte.",
                self.current_named_material,
            )
        if self.material_record is None:
            self.material_record = MaterialRecord(
                name=self.material_name,
                params=self.material_params.copy(),
                float_textures=dict(self.float_textures),
                spectrum_textures=dict(self.spectrum_textures),
                mix_children=self._resolve_mix(self.material_name, self.material_params),
            )
        # a record per shape, as the reference makes them (the material
        # table's indices follow), sharing the parameters and textures: the
        # builder makes one entry of them (scene/builder.py)
        return dataclasses.replace(self.material_record)

    def _resolve_mix(self, name: str, params) -> Optional[tuple]:
        if name != "mix":
            return None
        m1 = params.find_one_string("namedmaterial1", "")
        m2 = params.find_one_string("namedmaterial2", "")
        c1 = self.named_materials.get(m1)
        c2 = self.named_materials.get(m2)
        if c1 is None:
            log.error("Named material '%s' undefined (mix child 1)", m1)
        if c2 is None:
            log.error("Named material '%s' undefined (mix child 2)", m2)
        return (c1, c2)


class PbrtAPI:
    """Concrete API state machine (api.rs:355-841, completed)."""

    def __init__(self, options: Optional[Options] = None, strict: bool = False,
                 render_on_world_end: bool = True, device="cuda"):
        self.opt = options or Options()
        self.float_t = float_type(self.opt.double)  # every ParamSet's float
        self.device = device
        self.strict = strict
        self.render_on_world_end = render_on_world_end
        self.current_api_state = UNINITIALIZED
        self.current_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems: Dict[str, TransformSet] = {}
        self.scene = SceneDescription.for_float(self.float_t)
        self.graphics_state = _GraphicsState(self.float_t)
        self.pushed_graphics_states: List[_GraphicsState] = []
        self.pushed_transforms: List[TransformSet] = []
        self.pushed_active_transform_bits: List[int] = []
        self._current_instance: Optional[str] = None
        self.last_render: Any = None  # result of world_end's render

    # -- state guards (api.rs:291-332) -------------------------------------

    def _verify(self, required_state, func: str) -> bool:
        if self.current_api_state == UNINITIALIZED:
            msg = f'init() must be before calling "{func}()".'
            log.error("%s Ignoring.", msg)
            if self.strict:
                raise RuntimeError(msg)
            return False
        if required_state is OPTIONS_BLOCK and self.current_api_state == WORLD_BLOCK:
            msg = f'Options cannot be set inside world block; "{func}" not allowed.'
            log.error("%s Ignoring.", msg)
            if self.strict:
                raise RuntimeError(msg)
            return False
        if required_state is WORLD_BLOCK and self.current_api_state == OPTIONS_BLOCK:
            msg = f'Scene description must be inside world block; "{func}" not allowed.'
            log.error("%s Ignoring.", msg)
            if self.strict:
                raise RuntimeError(msg)
            return False
        return True

    def _verify_initialized(self, func):
        return self._verify(None, func)

    def _verify_options(self, func):
        return self._verify(OPTIONS_BLOCK, func)

    def _verify_world(self, func):
        return self._verify(WORLD_BLOCK, func)

    # -- lifecycle ----------------------------------------------------------

    def init(self) -> None:
        if self.current_api_state != UNINITIALIZED:
            log.error("init() has already been called.")
        self.current_api_state = OPTIONS_BLOCK
        self.scene = SceneDescription.for_float(self.float_t)

    def cleanup(self) -> None:
        if self.current_api_state == UNINITIALIZED:
            log.error("cleanup() called without init().")
        elif self.current_api_state == WORLD_BLOCK:
            log.error("cleanup() called while inside world block.")
        self.current_api_state = UNINITIALIZED
        self.scene = SceneDescription.for_float(self.float_t)

    # -- parsing ------------------------------------------------------------

    def parse_file(self, path) -> None:
        parser_mod.parse_file(path, self)

    def parse_string(self, data) -> None:
        parser_mod.parse(parser_mod.create_from_string(data), self)

    # -- transforms ---------------------------------------------------------

    def _for_active_transforms(self, f: Callable[[Transform], Transform]) -> None:
        for i in range(MAX_TRANSFORMS):
            if self.active_transform_bits & (1 << i):
                self.current_transform[i] = f(self.current_transform[i])

    def identity(self) -> None:
        if not self._verify_initialized("identity"):
            return
        self._for_active_transforms(lambda ct: Transform.identity())

    def translate(self, dx, dy, dz) -> None:
        if not self._verify_initialized("translate"):
            return
        t = Transform.translate([dx, dy, dz])
        self._for_active_transforms(lambda ct: ct * t)

    def rotate(self, angle_deg, ax, ay, az) -> None:
        if not self._verify_initialized("rotate"):
            return
        t = Transform.rotate(angle_deg, [ax, ay, az])
        self._for_active_transforms(lambda ct: ct * t)

    def scale(self, sx, sy, sz) -> None:
        if not self._verify_initialized("scale"):
            return
        t = Transform.scale(sx, sy, sz)
        self._for_active_transforms(lambda ct: ct * t)

    def look_at(self, eye, look, up) -> None:
        if not self._verify_initialized("look_at"):
            return
        log.info("eye: %s look: %s up: %s", eye, look, up)
        t = Transform.look_at(eye, look, up)
        self._for_active_transforms(lambda ct: ct * t)

    def concat_transform(self, m16) -> None:
        if not self._verify_initialized("concat_transform"):
            return
        t = Transform.from_flat(m16)
        self._for_active_transforms(lambda ct: ct * t)

    def transform(self, m16) -> None:
        if not self._verify_initialized("transform"):
            return
        t = Transform.from_flat(m16)
        self._for_active_transforms(lambda ct: t)

    def coordinate_system(self, name: str) -> None:
        if not self._verify_initialized("coordinate_system"):
            return
        self.named_coordinate_systems[name] = self.current_transform.copy()

    def coordinate_system_transform(self, name: str) -> None:
        if not self._verify_initialized("coordinate_system_transform"):
            return
        t = self.named_coordinate_systems.get(name)
        if t is None:
            log.warning('Couldn\'t find named coordinate system "%s"', name)
        else:
            self.current_transform = t.copy()

    def active_transform_all(self) -> None:
        self.active_transform_bits = ALL_TRANSFORMS_BITS

    def active_transform_end_time(self) -> None:
        self.active_transform_bits = END_TRANSFORM_BITS

    def active_transform_start_time(self) -> None:
        self.active_transform_bits = START_TRANSFORM_BITS

    def transform_times(self, start, end) -> None:
        if not self._verify_options("transform_times"):
            return
        self.scene.transform_start_time = float(start)
        self.scene.transform_end_time = float(end)

    def _warn_if_animated_transform(self, name: str) -> None:
        if self.current_transform.is_animated():
            log.warning(
                'Animated transformations set; ignoring for "%s" and using the '
                "start transform only",
                name,
            )

    # -- option-block directives --------------------------------------------

    def pixel_filter(self, name: str, params: ParamSet) -> None:
        if not self._verify_options("pixel_filter"):
            return
        self.scene.filter_name = name
        self.scene.filter_params = params

    def film(self, name: str, params: ParamSet) -> None:
        if not self._verify_options("film"):
            return
        self.scene.film_name = name
        self.scene.film_params = params

    def sampler(self, name: str, params: ParamSet) -> None:
        if not self._verify_options("sampler"):
            return
        self.scene.sampler_name = name
        self.scene.sampler_params = params

    def accelerator(self, name: str, params: ParamSet) -> None:
        if not self._verify_options("accelerator"):
            return
        self.scene.accelerator_name = name
        self.scene.accelerator_params = params

    def integrator(self, name: str, params: ParamSet) -> None:
        if not self._verify_options("integrator"):
            return
        self.scene.integrator_name = name
        self.scene.integrator_params = params

    def camera(self, name: str, params: ParamSet) -> None:
        if not self._verify_options("camera"):
            return
        self.scene.camera_name = name
        self.scene.camera_params = params
        self.scene.camera_to_world = self.current_transform.inverse()
        self.scene.camera_medium = self.graphics_state.current_outside_medium
        self.named_coordinate_systems["camera"] = self.scene.camera_to_world.copy()

    def make_named_medium(self, name: str, params: ParamSet) -> None:
        if not self._verify_initialized("make_named_medium"):
            return
        self._warn_if_animated_transform("make_named_medium")
        kind = params.find_one_string("type", "")
        if kind == "":
            log.error("No parameter string 'type' found in MakeNamedMedium")
            return
        self.scene.named_media[name] = params

    def medium_interface(self, inside_name: str, outside_name: str) -> None:
        if not self._verify_initialized("medium_interface"):
            return
        self.graphics_state.current_inside_medium = inside_name
        self.graphics_state.current_outside_medium = outside_name
        self.scene.have_scattering_media = True

    # -- world-block directives ---------------------------------------------

    def world_begin(self) -> None:
        if not self._verify_options("world_begin"):
            return
        self.current_api_state = WORLD_BLOCK
        self.current_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems["world"] = self.current_transform.copy()

    def attribute_begin(self) -> None:
        if not self._verify_world("attribute_begin"):
            return
        self.pushed_graphics_states.append(self.graphics_state.copy())
        self.pushed_transforms.append(self.current_transform.copy())
        self.pushed_active_transform_bits.append(self.active_transform_bits)

    def attribute_end(self) -> None:
        if not self._verify_world("attribute_end"):
            return
        if not self.pushed_graphics_states:
            log.error("Unmatched attribute_end() encountered. Ignoring it.")
            return
        self.graphics_state = self.pushed_graphics_states.pop()
        self.current_transform = self.pushed_transforms.pop()
        self.active_transform_bits = self.pushed_active_transform_bits.pop()

    def transform_begin(self) -> None:
        if not self._verify_world("transform_begin"):
            return
        self.pushed_transforms.append(self.current_transform.copy())
        self.pushed_active_transform_bits.append(self.active_transform_bits)

    def transform_end(self) -> None:
        if not self._verify_world("transform_end"):
            return
        if not self.pushed_transforms:
            log.error("Unmatched transform_end() encountered. Ignoring it.")
            return
        self.current_transform = self.pushed_transforms.pop()
        self.active_transform_bits = self.pushed_active_transform_bits.pop()

    def texture(self, name: str, kind: str, texname: str, params: ParamSet) -> None:
        if not self._verify_world("texture"):
            return
        from pbrt_tpu_torch.textures import make_float_texture, make_spectrum_texture

        tp = TextureParams(
            params,
            params,
            self.graphics_state.float_textures,
            self.graphics_state.spectrum_textures,
        )
        if kind == "float":
            if name in self.graphics_state.float_textures:
                log.info("Float texture '%s' is being redefined", name)
            self._warn_if_animated_transform("texture")
            ft = make_float_texture(texname, self.current_transform[0], tp)
            if ft is not None:
                self.graphics_state.float_textures[name] = ft
                self.graphics_state.material_record = None
        elif kind in ("color", "spectrum"):
            if name in self.graphics_state.spectrum_textures:
                log.info("Spectrum texture '%s' is being redefined", name)
            self._warn_if_animated_transform("texture")
            st = make_spectrum_texture(texname, self.current_transform[0], tp)
            if st is not None:
                self.graphics_state.spectrum_textures[name] = st
                self.graphics_state.material_record = None
        else:
            log.error("Texture type '%s' is unknown", kind)

    def material(self, name: str, params: ParamSet) -> None:
        if not self._verify_world("material"):
            return
        self.graphics_state.material_name = name
        self.graphics_state.material_params = params
        self.graphics_state.current_named_material = None
        self.graphics_state.material_record = None

    def make_named_material(self, name: str, params: ParamSet) -> None:
        if not self._verify_world("make_named_material"):
            return
        mat_type = params.find_one_string("type", "")
        if mat_type == "":
            log.error("No parameter string 'type' found in MakeNamedMaterial")
            return
        self._warn_if_animated_transform("make_named_material")
        self.graphics_state.named_materials[name] = MaterialRecord(
            name=mat_type,
            params=params,
            float_textures=dict(self.graphics_state.float_textures),
            spectrum_textures=dict(self.graphics_state.spectrum_textures),
            named=name,
            mix_children=self.graphics_state._resolve_mix(mat_type, params),
        )
        self.graphics_state.material_record = None

    def named_material(self, name: str) -> None:
        if not self._verify_world("named_material"):
            return
        self.graphics_state.current_named_material = name

    def light_source(self, name: str, params: ParamSet) -> None:
        if not self._verify_world("light_source"):
            return
        self._warn_if_animated_transform("light_source")
        self.scene.lights.append(
            LightRecord(
                name=name,
                params=params,
                light_to_world=self.current_transform[0],
                medium=self.graphics_state.current_outside_medium,
            )
        )

    def area_light_source(self, name: str, params: ParamSet) -> None:
        if not self._verify_world("area_light_source"):
            return
        self.graphics_state.area_light_name = name
        self.graphics_state.area_light_params = params

    def reverse_orientation(self) -> None:
        if not self._verify_world("reverse_orientation"):
            return
        self.graphics_state.reverse_orientation = not self.graphics_state.reverse_orientation

    def shape(self, name: str, params: ParamSet) -> None:
        if not self._verify_world("shape"):
            return
        o2w = self.current_transform[0]
        o2w_end = None
        if self.current_transform.is_animated():
            o2w_end = self.current_transform[1]
        rec = ShapeRecord(
            name=name,
            params=params,
            object_to_world=o2w,
            world_to_object=o2w.inverse(),
            reverse_orientation=self.graphics_state.reverse_orientation,
            material=self.graphics_state.make_material_record(),
            area_light_name=self.graphics_state.area_light_name,
            area_light_params=(
                self.graphics_state.area_light_params.copy()
                if self.graphics_state.area_light_params
                else None
            ),
            inside_medium=self.graphics_state.current_inside_medium,
            outside_medium=self.graphics_state.current_outside_medium,
            object_instance=self._current_instance,
            object_to_world_end=o2w_end,
        )
        if self._current_instance is not None:
            self.scene.instances[self._current_instance].append(rec)
        else:
            self.scene.shapes.append(rec)

    def object_begin(self, name: str) -> None:
        if not self._verify_world("object_begin"):
            return
        self.attribute_begin()
        if self._current_instance is not None:
            log.error("ObjectBegin called inside of instance definition")
        self.scene.instances[name] = []
        self._current_instance = name

    def object_end(self) -> None:
        if not self._verify_world("object_end"):
            return
        if self._current_instance is None:
            log.error("ObjectEnd called outside of instance definition")
        self._current_instance = None
        self.attribute_end()

    def object_instance(self, name: str) -> None:
        if not self._verify_world("object_instance"):
            return
        if self._current_instance is not None:
            log.error("ObjectInstance can't be called inside instance definition")
            return
        if name not in self.scene.instances:
            log.error("Unable to find instance named '%s'", name)
            return
        self._warn_if_animated_transform("object_instance")
        self.scene.instance_uses.append((name, self.current_transform[0]))

    def world_end(self) -> None:
        if not self._verify_world("world_end"):
            return
        # Warn about unmatched pushes (pbrt-v3 pbrtWorldEnd)
        while self.pushed_graphics_states:
            log.warning("Missing end to attribute_begin()")
            self.pushed_graphics_states.pop()
            self.pushed_transforms.pop()
            self.pushed_active_transform_bits.pop()
        while self.pushed_transforms:
            log.warning("Missing end to transform_begin()")
            self.pushed_transforms.pop()
            self.pushed_active_transform_bits.pop()

        if self.render_on_world_end:
            from pbrt_tpu_torch.render import render_scene

            self.last_render = render_scene(self.scene, self.opt, device=self.device)
            if self.opt.verbose:
                from pbrt_tpu_torch.utils import stats

                log.info("%s", stats.report())

        self.graphics_state = _GraphicsState(self.float_t)
        self.current_api_state = OPTIONS_BLOCK
        self.current_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems.clear()

    # -- test helper (api.rs:849-873) ---------------------------------------

    def assert_transforms(self, expected) -> None:
        import numpy as np

        if not isinstance(expected, Transform):
            expected = Transform(expected)
        for i in range(MAX_TRANSFORMS):
            if self.active_transform_bits & (1 << i):
                np.testing.assert_allclose(
                    self.current_transform[i].m, expected.m, atol=1e-6
                )
