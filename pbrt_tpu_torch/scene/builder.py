"""Compile a parsed SceneDescription into device tables and render objects
(counterpart of ``pbrt_tpu/scene/builder.py:97-142, 144-568, 618-878``).

Output is SoA: all triangles of the scene concatenated in world space,
analytic spheres with their transforms, per-primitive material/light ids,
the material entries and the lights, every table on the ``device``
handed to :func:`build_scene`.

Ported: film (with the options' quick render and image file), camera,
sampler, materials, lights, object instances (expanded into plain shape
records after the scene's own shapes, as in the reference), the named
media and the camera's medium, the triangle and sphere tables (spheres
that emit, bound a medium or carry a subsurface material become triangle
meshes, as in the reference), the per-triangle medium interface columns
(``med_in``/``med_out``: a subsurface material's interior medium, one per
material record, appended after the named media in the order first
used), the ``_flags`` that prune interaction work, the ``scene/*`` stats
counters, and the reference's intersector choice: the BVH for
``bvh``/``kdtree`` scenes of at least ``minprims`` triangles, the
brute-force sweep otherwise.  As in the reference, a surface without a
MediumInterface sends a ray that crosses it to vacuum (-1).

Motion blur, as in the reference: a camera whose transform moves across
the shutter gets keyframed camera-to-world matrices
(``set_animation``); shape records whose CTM moves get K decompose +
slerp keyframes (``core/animated.py``; K the most any record needs),
static records replicate across the keys so that every key table shares
one topology, animated spheres are tessellated, ``tables["tri_keys"]``
holds one [T, 18] (p0 p1 p2 n0 n1 n2) table per key and
``_flags["animated_keys"]`` is K, and the scene takes the keyframed
intersector (``ops/animated_intersect.AnimatedIntersector``), never the
BVH8 path.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from pbrt_tpu_torch import float_type, require_device
from pbrt_tpu_torch.cameras import make_camera
from pbrt_tpu_torch.core.animated import AnimatedTransform
from pbrt_tpu_torch.core.film import Film
from pbrt_tpu_torch.core.geometry import arccos0
from pbrt_tpu_torch.core.filters import make_filter
from pbrt_tpu_torch.core.spectrum import promote_rgb
from pbrt_tpu_torch.lights import DiffuseAreaLight, Light, make_light
from pbrt_tpu_torch.materials import MaterialEntry, build_material
from pbrt_tpu_torch.media import make_medium
from pbrt_tpu_torch.media.scattering import make_subsurface_medium
from pbrt_tpu_torch.ops.animated_intersect import AnimatedIntersector, blend, time_weights
from pbrt_tpu_torch.ops.intersect import KIND_SPHERE, KIND_TRI
from pbrt_tpu_torch.ops.intersect_soa import SoABruteForceIntersector
from pbrt_tpu_torch.ops.tables import select_rows
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.shapes import (
    SphereData,
    TriangleData,
    concat_sphere_data,
    concat_triangle_data,
    make_shape,
)
from pbrt_tpu_torch.utils import stats

log = logging.getLogger("pbrt_tpu_torch")

TRI_KEYS = ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2",
            "mat", "light", "med_in", "med_out")


@dataclasses.dataclass
class CompiledScene:
    film: Film
    camera: object
    sampler: object
    integrator_name: str
    integrator_params: object
    accelerator_name: str
    materials: List[MaterialEntry]
    lights: List[Light]
    area_lights: List[DiffuseAreaLight]
    tables: Dict[str, object]
    intersector: object
    tri_data: Optional[TriangleData]
    sph_data: Optional[SphereData]
    world_bounds: tuple
    device: torch.device
    float_t: type  # the policy's float (pbrt_tpu_torch.float_type) of every table
    media: list = dataclasses.field(default_factory=list)
    media_names: dict = dataclasses.field(default_factory=dict)
    camera_medium: int = -1  # the medium id camera rays start in (-1: vacuum)

    def initial_theta(self):
        """The differentiable scene parameters, a dict of tensors on the
        scene's device: the material slots of ``material_theta`` (split
        ``{"a", "b"}`` in mix scenes), ``env_l`` [infinite lights, 3],
        ``area_l`` [area lights, 3] and ``tex_images`` {tex_id: packed
        pyramid} of every image texture, mix children included.  Hand it
        (or a copy that requires grad) to ``diff/grad.py``'s functions."""
        from pbrt_tpu_torch.lights import InfiniteAreaLight
        from pbrt_tpu_torch.materials import material_theta
        from pbrt_tpu_torch.textures.imagemap import ImageTexture

        dev, float_t = self.device, self.float_t
        theta = material_theta(self.materials, dev, float_t)

        def rows(vals):
            return torch.as_tensor(np.stack(vals) if vals else np.zeros((0, 3), float_t),
                                   device=dev)

        theta["env_l"] = rows([np.asarray(lt.l_rgb, dtype=float_t) for lt in self.lights
                               if isinstance(lt, InfiniteAreaLight)])
        theta["area_l"] = rows([al.l_emit for al in self.area_lights])
        theta["tex_images"] = {
            tex.tex_id: tex.mipmap.flat_on(dev).clone()
            for tex in image_textures(self.materials) if isinstance(tex, ImageTexture)
        }
        return theta


def image_textures(materials):
    """Every texture of ``materials`` and their mix children (blend
    textures included), in ``iter_entries_deep`` order; the image
    textures among them are the ``tex_images`` of ``initial_theta``."""
    from pbrt_tpu_torch.materials import iter_entries_deep

    for e in iter_entries_deep(materials):
        yield from e.textures.values()
        if e.mix_amount is not None:
            yield e.mix_amount


def _tessellate_emitting_sphere(sph: SphereData, sub=24):
    """Emitting spheres become triangles, in the float of the spheres'
    table (the policy's), so area sampling is uniform (the reference's
    ``_tessellate_emitting_sphere``)."""
    from pbrt_tpu_torch.core.transform import Transform

    float_t = sph.radius.dtype.type
    parts = []
    for i in range(sph.count):
        r = float(sph.radius[i])
        us = np.linspace(0, 2 * np.pi, 2 * sub + 1)
        vs = np.linspace(0, np.pi, sub + 1)
        uu, vv = np.meshgrid(us, vs, indexing="ij")
        pts = np.stack([r * np.sin(vv) * np.cos(uu), r * np.sin(vv) * np.sin(uu),
                        r * np.cos(vv)], axis=-1)
        t = Transform(sph.o2w[i])
        pts_w = t.apply_p(pts.reshape(-1, 3), float_t).reshape(pts.shape)
        nrm_w = t.apply_n(pts.reshape(-1, 3), float_t).reshape(pts.shape)
        nn = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
        nrm_w = nrm_w / np.where(nn == 0, 1, nn)
        corners = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2")}
        nu, nv = uu.shape[0] - 1, uu.shape[1] - 1
        for a in range(nu):
            for b in range(nv):
                quad = [(a, b), (a + 1, b), (a + 1, b + 1), (a, b + 1)]
                for tri in ((0, 1, 2), (0, 2, 3)):
                    for c, k in enumerate(tri):
                        v = quad[k]
                        corners[f"p{c}"].append(pts_w[v])
                        corners[f"n{c}"].append(nrm_w[v])
                        corners[f"uv{c}"].append((v[0] / nu, v[1] / nv))
        td = TriangleData(**{k: np.asarray(v, dtype=float_t) for k, v in corners.items()})
        keep = td.areas() > 1e-14
        parts.append(TriangleData(**{k: getattr(td, k)[keep] for k in corners}))
    return concat_triangle_data(parts)


def build_scene(desc, options=None, seed: int = 0, device="cuda", walk: str = "bvh8",
                sort: str = "stable", stream_min_tris: int = 4096, key_obits: int = 5,
                deadbit: bool = True) -> CompiledScene:
    """SceneDescription (core/api.py) -> CompiledScene on ``device`` (a
    CUDA card unless the caller asks for the CPU; without one this
    raises).  ``options.quick_render`` quarters the resolution and
    ``options.image_file`` overrides the film's filename.  ``walk``,
    ``sort``, ``stream_min_tris``, ``key_obits`` and ``deadbit`` go to the
    BVH (``accel/bvh.py``).  The tables take the float of the
    description's parameters (``desc.float_t``, the API's policy), which
    must be that of ``options.double``."""
    device = require_device(device)
    float_t = desc.float_t
    if options is not None and float_type(options.double) != float_t:
        raise ValueError(f"build_scene: the description was parsed in {float_t.__name__}, "
                         f"options.double={options.double} asks for "
                         f"{float_type(options.double).__name__}")
    filt = make_filter(desc.filter_name, desc.filter_params)
    desc.filter_params.report_unused()
    fp = desc.film_params
    xres = fp.find_one_int("xresolution", 1280)
    yres = fp.find_one_int("yresolution", 720)
    if options is not None and options.quick_render:
        xres = max(1, xres // 4)
        yres = max(1, yres // 4)
    crop = fp.find_float("cropwindow")
    if crop is not None and len(crop) == 4:
        crop_window = ((float(crop[0]), float(crop[2])), (float(crop[1]), float(crop[3])))
    else:
        crop_window = ((0.0, 0.0), (1.0, 1.0))
    filename = fp.find_one_string("filename", "pbrt.png")
    if options is not None and options.image_file:
        filename = options.image_file
    film = Film(
        (xres, yres), crop_window, filt,
        fp.find_one_float("diagonal", 35.0), filename,
        fp.find_one_float("scale", 1.0),
        fp.find_one_float("maxsampleluminance", float("inf")),
        device=device, float_t=float_t,
    )
    fp.report_unused()
    camera = make_camera(desc.camera_name, desc.camera_params, desc.camera_to_world[0],
                         film, device=device)
    shutter_open = desc.camera_params.find_one_float("shutteropen", 0.0)
    shutter_close = desc.camera_params.find_one_float("shutterclose", 1.0)
    if desc.camera_to_world.is_animated():
        c_at = AnimatedTransform(desc.camera_to_world[0], desc.camera_to_world[1],
                                 desc.transform_start_time, desc.transform_end_time)
        if c_at.actually_animated and hasattr(camera, "set_animation"):
            camera.set_animation(c_at.key_transforms(shutter_open, shutter_close))
    desc.camera_params.report_unused()
    sampler = make_sampler(desc.sampler_name, desc.sampler_params, seed)
    desc.sampler_params.report_unused()

    media = []
    media_names = {}
    for m_name, m_params in desc.named_media.items():
        media.append(make_medium(m_params.find_one_string("type", "homogeneous"), m_params,
                                 device=device))
        m_params.report_unused()
        media_names[m_name] = len(media) - 1

    def med_id(name: str) -> int:
        if not name:
            return -1
        idx = media_names.get(name)
        if idx is None:
            log.error("Named medium '%s' undefined.", name)
            return -1
        return idx

    camera_medium = med_id(desc.camera_medium)

    # object instances become plain shape records after the scene's own,
    # in the order of their uses (the reference's expansion)
    shape_records = list(desc.shapes)
    for inst_name, xform in desc.instance_uses:
        for rec in desc.instances.get(inst_name, []):
            o2w = xform * rec.object_to_world
            shape_records.append(dataclasses.replace(
                rec, object_to_world=o2w, world_to_object=o2w.inverse(),
                object_instance=None, object_to_world_end=None))

    materials: List[MaterialEntry] = []
    mat_cache = {}
    # one entry for the records that share their parameters and textures
    # (those of the shapes after one Material directive): the material
    # table keeps an index per record, and they all hold the same entry
    entries = {}

    def mat_index(record) -> int:
        key = id(record)
        if key not in mat_cache:
            shared = (id(record.params), id(record.float_textures),
                      id(record.spectrum_textures))
            if shared not in entries:
                entries[shared] = build_material(record)
                record.params.report_unused()
            materials.append(entries[shared])
            mat_cache[key] = len(materials) - 1
        return mat_cache[key]

    tri_parts: List[TriangleData] = []
    tri_mat: List[np.ndarray] = []
    tri_light: List[np.ndarray] = []
    tri_med_in: List[np.ndarray] = []
    tri_med_out: List[np.ndarray] = []
    sph_parts: List[SphereData] = []
    sph_mat: List[int] = []
    area_lights: List[DiffuseAreaLight] = []
    sss_media = {}  # id(material record) -> its interior medium

    def sss_medium_index(record) -> int:
        if id(record) not in sss_media:
            media.append(make_subsurface_medium(record, device=device))
            sss_media[id(record)] = len(media) - 1
        return sss_media[id(record)]

    # motion blur: records whose CTM moves get K keyframes across the
    # shutter; in an animated scene the static records replicate
    anim_xforms = {}
    n_keys = 0
    for rec in shape_records:
        if rec.object_to_world_end is not None:
            at = AnimatedTransform(rec.object_to_world, rec.object_to_world_end,
                                   desc.transform_start_time, desc.transform_end_time)
            if at.actually_animated:
                anim_xforms[id(rec)] = at
                n_keys = max(n_keys, at.n_keys())
    scene_animated = bool(anim_xforms)
    tri_key_parts: List[List[TriangleData]] = [[] for _ in range(max(n_keys, 1))]

    for rec in shape_records:
        at = anim_xforms.get(id(rec))
        key_shapes = None
        if scene_animated:
            xfs = (at.key_transforms(shutter_open, shutter_close, n_keys) if at is not None
                   else [rec.object_to_world] * n_keys)
            key_shapes = [make_shape(rec.name, rec.params, xf, rec.reverse_orientation)
                          for xf in xfs]
            shape = key_shapes[0]
        else:
            shape = make_shape(rec.name, rec.params, rec.object_to_world,
                               rec.reverse_orientation)
        if shape is None:
            continue
        rec.params.report_unused()
        m_idx = mat_index(rec.material)
        is_sss = rec.material.name in ("subsurface", "kdsubsurface")
        if isinstance(shape, SphereData):
            if not (rec.area_light_name or is_sss or rec.inside_medium or rec.outside_medium
                    or at is not None):
                sph_parts.append(shape)
                sph_mat.extend([m_idx] * shape.count)
                continue
            # area sampling and medium interfaces live on the triangle
            # tables, and keyframed triangles carry an animated sphere's motion
            if at is not None:
                key_shapes = [_tessellate_emitting_sphere(sk) for sk in key_shapes]
                if len({sk.count for sk in key_shapes}) != 1:
                    raise ValueError("animated sphere tessellation produced inconsistent "
                                     "topology across keyframes")
                shape = key_shapes[0]
            else:
                shape = _tessellate_emitting_sphere(shape)
        if scene_animated:
            if at is None:
                key_shapes = [shape] * n_keys
            for k in range(n_keys):
                tri_key_parts[k].append(key_shapes[k])
        light_idx = -1
        if rec.area_light_name:
            ap = rec.area_light_params
            l_emit = promote_rgb(
                ap.find_one_spectrum_raw("L", np.ones(3, dtype=float_t))
                * ap.find_one_spectrum_raw("scale", np.ones(3, dtype=float_t)),
                illuminant=True, float_t=float_t,
            )
            two_sided = ap.find_one_bool("twosided", False)
            area_lights.append(DiffuseAreaLight(
                l_emit, two_sided, shape.p0, shape.p1, shape.p2, device=device, float_t=float_t
            ))
            ap.report_unused()
            light_idx = len(area_lights) - 1
        tri_parts.append(shape)
        tri_mat.append(np.full(shape.count, m_idx, dtype=np.int32))
        tri_light.append(np.full(shape.count, light_idx, dtype=np.int32))
        m_in = sss_medium_index(rec.material) if is_sss else med_id(rec.inside_medium)
        tri_med_in.append(np.full(shape.count, m_in, dtype=np.int32))
        tri_med_out.append(np.full(shape.count, med_id(rec.outside_medium), dtype=np.int32))

    tri_data = concat_triangle_data(tri_parts)
    tri_key_data = ([concat_triangle_data(parts) for parts in tri_key_parts]
                    if scene_animated and tri_key_parts[0] else None)
    sph_data = concat_sphere_data(sph_parts)
    lights: List[Light] = [lt for lt in (make_light(lr, device=device) for lr in desc.lights)
                           if lt is not None]
    lights.extend(area_lights)
    stats.count("scene/lights", len(lights))
    stats.count("scene/materials", len(materials))
    if tri_data is not None:
        stats.count("scene/triangles", int(tri_data.count))
    if sph_parts:
        stats.count("scene/spheres", int(sum(sp.count for sp in sph_parts)))
    if not lights:
        log.warning("No light sources defined in scene; rendering will be black.")

    tables: Dict[str, object] = {}
    if tri_data is not None:
        host = {k: getattr(tri_data, k) for k in TRI_KEYS[:9]}
        host["mat"] = np.concatenate(tri_mat)
        host["light"] = np.concatenate(tri_light)
        host["med_in"] = np.concatenate(tri_med_in)
        host["med_out"] = np.concatenate(tri_med_out)
        for k in TRI_KEYS[:9]:
            if not np.isfinite(host[k]).all():
                raise ValueError(f"Non-finite values in scene table 'tri.{k}'")
        if tri_data.tan0 is not None:
            # curve tangents (hair shading), zero on the other triangles
            for k in ("tan0", "tan1", "tan2"):
                host[k] = getattr(tri_data, k)
        tables["tri"] = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    if sph_data is not None:
        for k in ("o2w", "w2o", "radius", "z_min", "z_max"):
            if not np.isfinite(getattr(sph_data, k)).all():
                raise ValueError(f"Non-finite values in scene table 'sph.{k}'")
        sph_host = {
            "o2w": sph_data.o2w.astype(float_t), "w2o": sph_data.w2o.astype(float_t),
            "radius": sph_data.radius, "z_min": sph_data.z_min, "z_max": sph_data.z_max,
            "phi_max": sph_data.phi_max, "reverse": sph_data.reverse_orientation,
            "mat": np.asarray(sph_mat, dtype=np.int32),
        }
        tables["sph"] = {k: torch.as_tensor(v, device=device) for k, v in sph_host.items()}
        tables["sph_cols"] = _sph_cols(tables["sph"])

    # static interaction flags: uv only for non-constant textures, shading
    # normals only for non-flat meshes, footprints only for textures that
    # filter (the checkerboard and image textures)
    from pbrt_tpu_torch.materials import iter_entries_deep
    from pbrt_tpu_torch.textures.checkerboard import CheckerboardTexture
    from pbrt_tpu_torch.textures.constant import ConstantTexture
    from pbrt_tpu_torch.textures.imagemap import ImageTexture

    uv_needed = any(
        not isinstance(tex, ConstantTexture)
        for e in iter_entries_deep(materials) for tex in e.textures.values()
    ) or any(e.mix_children is not None for e in materials)
    tri_flat = False
    if tri_data is not None:
        fn = np.cross(tri_data.p1 - tri_data.p0, tri_data.p2 - tri_data.p0)
        nn = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.where(nn == 0, 1.0, nn)
        tri_flat = all(
            np.allclose(getattr(tri_data, f), fn, atol=1e-5) for f in ("n0", "n1", "n2")
        )
    tex_width_needed = any(
        isinstance(tex, (ImageTexture, CheckerboardTexture))
        for e in iter_entries_deep(materials) for tex in e.textures.values()
    )
    tables["_flags"] = {
        "uv": bool(uv_needed),
        "tri_flat": bool(tri_flat),
        "tex_width": bool(uv_needed and tex_width_needed),
        # K > 0: per-lane shutter times blend the geometry between K keys
        "animated_keys": len(tri_key_data) if tri_key_data is not None else 0,
    }
    if tri_key_data is not None:
        # [T, 18] per key: p0 p1 p2 n0 n1 n2 (compute_interaction blends the
        # rows of each lane's triangle with its hat weights)
        tables["tri_keys"] = [
            torch.as_tensor(np.concatenate([kd.p0, kd.p1, kd.p2, kd.n0, kd.n1, kd.n2],
                                           axis=1).astype(float_t), device=device)
            for kd in tri_key_data
        ]

    min_prims = desc.accelerator_params.find_one_int("minprims", 512)
    if tri_key_data is not None:
        intersector = AnimatedIntersector(tri_key_data, sph_data, device=device)
    elif (desc.accelerator_name in ("bvh", "kdtree") and tri_data is not None
            and tri_data.count >= min_prims):
        from pbrt_tpu_torch.accel.bvh import BVHIntersector

        intersector = BVHIntersector(tri_data, sph_data, device=device, walk=walk, sort=sort,
                                     stream_min_tris=stream_min_tris, key_obits=key_obits,
                                     deadbit=deadbit)
    else:
        intersector = SoABruteForceIntersector(tri_data, sph_data, device=device)
    desc.accelerator_params.report_unused()
    return CompiledScene(
        film=film, camera=camera, sampler=sampler,
        integrator_name=desc.integrator_name,
        integrator_params=desc.integrator_params,
        accelerator_name=desc.accelerator_name,
        materials=materials, lights=lights, area_lights=area_lights,
        tables=tables, intersector=intersector, tri_data=tri_data, sph_data=sph_data,
        world_bounds=_world_bounds(tri_data, sph_data), device=device, float_t=float_t,
        media=media, media_names=media_names, camera_medium=camera_medium,
    )


def _world_bounds(tri_data, sph_data):
    """(mins, maxs) over the triangles and the spheres' scaled radii."""
    from pbrt_tpu_torch.core.transform import Transform

    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    if tri_data is not None:
        for p in (tri_data.p0, tri_data.p1, tri_data.p2):
            mins = np.minimum(mins, p.min(axis=0))
            maxs = np.maximum(maxs, p.max(axis=0))
    if sph_data is not None:
        for i in range(sph_data.count):
            c = Transform(sph_data.o2w[i]).apply_p(np.zeros(3))
            r = sph_data.radius[i] * np.abs(sph_data.o2w[i][:3, :3]).max()
            mins = np.minimum(mins, c - r)
            maxs = np.maximum(maxs, c + r)
    if not np.isfinite(mins).all():
        mins, maxs = -np.ones(3), np.ones(3)
    return mins, maxs


def _tri_cols(tr, need_normals=True, need_uv=True):
    """Pack the triangle table into one [T, C] matrix of the table's float
    (ints are exact below 2^24) plus a name ->
    column-slice layout (the reference's ``_tri_cols``): p0 p1 p2 (9)
    [n0 n1 n2 (9)] [uv0 uv1 uv2 (6)] mat light med_in med_out (4)
    [tan0 tan1 tan2 (9)]."""
    names = ["p0", "p1", "p2"]
    if need_normals:
        names += ["n0", "n1", "n2"]
    if need_uv:
        names += ["uv0", "uv1", "uv2"]
    names += ["mat", "light", "med_in", "med_out"]
    if "tan0" in tr:
        names += ["tan0", "tan1", "tan2"]
    parts = []
    layout = {}
    at = 0
    for nm in names:
        v = tr[nm]
        if v.dim() == 1:
            v = v[:, None]
        parts.append(v.to(tr["p0"].dtype))
        layout[nm] = slice(at, at + v.shape[1])
        at += v.shape[1]
    return torch.cat(parts, dim=1), layout


def _sph_cols(sp):
    """Pack the sphere table: w2o rows (12) radius z_min z_max phi_max
    reverse mat (6) -> [S, 18] in the table's float."""
    parts = [
        sp["w2o"][:, :3, :4].reshape(sp["w2o"].shape[0], 12),
        sp["radius"][:, None], sp["z_min"][:, None], sp["z_max"][:, None],
        sp["phi_max"][:, None], sp["reverse"][:, None], sp["mat"][:, None],
    ]
    return torch.cat([p.to(sp["radius"].dtype) for p in parts], dim=1)


def compute_interaction(tables, hit, o, d, ray_diff=None, time=None):
    """Hit record -> SoA surface interaction dict (triangles and spheres).

    Keys: p, ng, ng_raw, ns [N, 3], uv [N, 2], mat, light, med_in,
    med_out [N], wo [N, 3]; with ``ray_diff = (dxd, dyd)`` (the +1-pixel
    camera ray directions sharing origin ``o``) also duvdx, duvdy [N, 2]
    and tex_width [N]; in scenes with curves also tang [N, 3], the
    interpolated curve tangent (zero off curves).  Misses get mat = light
    = -1.  ``time`` ([N] normalized shutter times) blends each lane's triangle vertices and
    shading normals between the ``tri_keys`` tables of an animated scene.
    """
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    t = hit["t"]
    p = o + d * t[..., None]
    ng = torch.zeros((n, 3), dtype=dt, device=dev)
    ng[:, 2] = 1.0
    ns = ng
    ng_raw = ng
    uv = torch.zeros((n, 2), dtype=dt, device=dev)
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    mat = light = med_in = med_out = minus1
    duvdx = torch.zeros((n, 2), dtype=dt, device=dev)
    duvdy = torch.zeros((n, 2), dtype=dt, device=dev)
    tex_width = torch.zeros((n,), dtype=dt, device=dev)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    def _plane_offsets(ng_plane):
        """Transfer the +1px offset rays to the hit plane: dpdx, dpdy."""
        dxd, dyd = ray_diff

        def transfer(dd):
            denom = dot(dd, ng_plane)
            ok = torch.abs(denom) > 1e-9
            tt = dot(p - o, ng_plane) / torch.where(ok, denom, 1.0)
            return torch.where(ok[..., None], o + dd * tt[..., None] - p, 0.0)

        return transfer(dxd), transfer(dyd)

    flags = tables.get("_flags", {})
    uv_needed = bool(flags.get("uv", True))
    tri_flat = bool(flags.get("tri_flat", False))

    if "tri" in tables:
        tr = tables["tri"]
        idx = torch.clamp(hit["prim"].long(), 0, tr["p0"].shape[0] - 1)
        is_tri = hit["hit"] & (hit["kind"] == KIND_TRI)
        cols, lay = _tri_cols(tr, need_normals=not tri_flat, need_uv=uv_needed)
        rows = select_rows(cols, idx)
        krows = None
        if time is not None and "tri_keys" in tables:
            keys = tables["tri_keys"]
            kw = time_weights(torch.broadcast_to(time, idx.shape).to(dt), len(keys))
            # rounded as the reference's compiled blend (and the walks)
            krows = blend(torch.stack([select_rows(k, idx) for k in keys], dim=1), kw)
            p0, p1, p2 = krows[:, 0:3], krows[:, 3:6], krows[:, 6:9]
        else:
            p0, p1, p2 = rows[:, lay["p0"]], rows[:, lay["p1"]], rows[:, lay["p2"]]
        b0, b1 = hit["b0"], hit["b1"]
        if b0 is None:
            # the walks return only (t, slot): project the hit point onto
            # the dual basis of (e1, e2)
            e1 = p1 - p0
            e2 = p2 - p0
            v = p - p0
            E = dot(e1, e1)
            F = dot(e1, e2)
            G = dot(e2, e2)
            det_b = E * G - F * F
            inv_b = torch.where(
                torch.abs(det_b) > 1e-20, 1.0 / torch.where(det_b == 0, 1.0, det_b), 0.0
            )
            ve1 = dot(v, e1)
            ve2 = dot(v, e2)
            b0 = (G * ve1 - F * ve2) * inv_b
            b1 = (E * ve2 - F * ve1) * inv_b
        b2 = 1.0 - b0 - b1

        def col_int(name):
            return torch.round(rows[:, lay[name]][:, 0]).to(torch.int32)

        ng_t = torch.linalg.cross(p1 - p0, p2 - p0)
        ng_t = ng_t / torch.clamp(torch.linalg.norm(ng_t, dim=-1, keepdim=True), min=1e-12)
        ng_raw_t = ng_t
        if tri_flat:
            ns_t = ng_t
        else:
            if krows is not None:
                n0, n1, n2 = krows[:, 9:12], krows[:, 12:15], krows[:, 15:18]
            else:
                n0, n1, n2 = rows[:, lay["n0"]], rows[:, lay["n1"]], rows[:, lay["n2"]]
            ns_t = b2[..., None] * n0 + b0[..., None] * n1 + b1[..., None] * n2
            ns_norm = torch.linalg.norm(ns_t, dim=-1, keepdim=True)
            ns_t = torch.where(ns_norm > 1e-9, ns_t / torch.clamp(ns_norm, min=1e-12), ng_t)
            ng_t = torch.where(dot(ng_t, ns_t)[..., None] < 0, -ng_t, ng_t)
        m = is_tri[..., None]
        if uv_needed:
            uv0, uv1, uv2 = rows[:, lay["uv0"]], rows[:, lay["uv1"]], rows[:, lay["uv2"]]
            uv_t = b2[..., None] * uv0 + b0[..., None] * uv1 + b1[..., None] * uv2
            uv = torch.where(m, uv_t, uv)
            if ray_diff is not None:
                dpdx, dpdy = _plane_offsets(ng_raw_t)
                # (dpdu, dpdv) from the uv parameterization (triangle.cpp)
                duv02 = uv0 - uv2
                duv12 = uv1 - uv2
                dp02 = p0 - p2
                dp12 = p1 - p2
                det_uv = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
                inv_uv = torch.where(
                    torch.abs(det_uv) > 1e-12,
                    1.0 / torch.where(det_uv == 0, 1.0, det_uv), 0.0,
                )[..., None]
                dpdu = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv_uv
                dpdv = (-duv12[..., 0:1] * dp02 + duv02[..., 0:1] * dp12) * inv_uv
                # dual basis of the first fundamental form: du = dp . fu
                E = dot(dpdu, dpdu)
                F = dot(dpdu, dpdv)
                G = dot(dpdv, dpdv)
                det_g = E * G - F * F
                inv_g = torch.where(det_g > 1e-20, 1.0 / torch.clamp(det_g, min=1e-30), 0.0)
                fu = (G[..., None] * dpdu - F[..., None] * dpdv) * inv_g[..., None]
                fv = (E[..., None] * dpdv - F[..., None] * dpdu) * inv_g[..., None]
                duvdx_t = torch.stack([dot(dpdx, fu), dot(dpdx, fv)], dim=-1)
                duvdy_t = torch.stack([dot(dpdy, fu), dot(dpdy, fv)], dim=-1)
                duvdx = torch.where(m, duvdx_t, duvdx)
                duvdy = torch.where(m, duvdy_t, duvdy)
                w_t = torch.maximum(
                    torch.abs(duvdx_t).amax(dim=-1), torch.abs(duvdy_t).amax(dim=-1)
                )
                tex_width = torch.where(is_tri, w_t, tex_width)
        ng = torch.where(m, ng_t, ng)
        ng_raw = torch.where(m, ng_raw_t, ng_raw)
        ns = torch.where(m, ns_t, ns)
        mat = torch.where(is_tri, col_int("mat"), mat)
        light = torch.where(is_tri, col_int("light"), light)
        med_in = torch.where(is_tri, col_int("med_in"), med_in)
        med_out = torch.where(is_tri, col_int("med_out"), med_out)
        if "tan0" in tr:
            # the curve tangent (hair shading); zero on other triangles
            tang_t = (b2[..., None] * rows[:, lay["tan0"]] + b0[..., None] * rows[:, lay["tan1"]]
                      + b1[..., None] * rows[:, lay["tan2"]])
            tang = torch.where(m, tang_t, 0.0)

    if "sph" in tables:
        cols = tables["sph_cols"]
        idx = torch.clamp(hit["prim"].long(), 0, cols.shape[0] - 1)
        is_sph = hit["hit"] & (hit["kind"] == KIND_SPHERE)
        srows = select_rows(cols, idx)
        m3 = srows[:, 0:12].reshape(-1, 3, 4)
        p_obj = torch.sum(m3[:, :, :3] * p[:, None, :], dim=-1) + m3[:, :, 3]
        n_obj = p_obj / torch.clamp(torch.linalg.norm(p_obj, dim=-1, keepdim=True), min=1e-12)
        # the normal transforms by (w2o)^T
        n_w = torch.sum(m3[:, :, :3] * n_obj[:, :, None], dim=1)
        n_w = n_w / torch.clamp(torch.linalg.norm(n_w, dim=-1, keepdim=True), min=1e-12)
        n_w = torch.where(srows[:, 16:17] != 0.0, -n_w, n_w)
        m = is_sph[..., None]
        if uv_needed:
            # (phi, theta) parameterization, only for textured scenes
            phi = torch.atan2(p_obj[..., 1], p_obj[..., 0])
            phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
            r = srows[:, 12]
            u_s = phi / srows[:, 15]
            zmin = srows[:, 13]
            zmax = srows[:, 14]
            r_safe = torch.clamp(r, min=1e-12)
            # arccos0: other lanes' uv is discarded, and a floor point under
            # a sphere resting on the floor has p_obj.z / r = -1
            theta = arccos0(p_obj[..., 2] / r_safe)
            theta_min = torch.arccos(torch.clamp(zmax / r_safe, -1, 1))
            theta_max = torch.arccos(torch.clamp(zmin / r_safe, -1, 1))
            v_s = (theta - theta_min) / torch.clamp(theta_max - theta_min, min=1e-9)
            uv = torch.where(m, torch.stack([u_s, v_s], dim=-1), uv)
            if ray_diff is not None:
                dpdx, dpdy = _plane_offsets(n_w)
                # arc-length footprint estimate: uv spans ~pi*r of surface
                wid = torch.maximum(
                    torch.linalg.norm(dpdx, dim=-1), torch.linalg.norm(dpdy, dim=-1)
                ) / torch.clamp(r * np.pi, min=1e-9)
                tex_width = torch.where(is_sph, wid, tex_width)
                duvdx = torch.where(m, torch.stack([wid, wid], dim=-1), duvdx)
                duvdy = torch.where(m, 0.0, duvdy)
        ng = torch.where(m, n_w, ng)
        ng_raw = torch.where(m, n_w, ng_raw)
        ns = torch.where(m, n_w, ns)
        mat = torch.where(is_sph, torch.round(srows[:, 17]).to(torch.int32), mat)

    out = {
        "p": p, "ng": ng, "ng_raw": ng_raw, "ns": ns, "uv": uv,
        "mat": mat, "light": light, "med_in": med_in, "med_out": med_out,
        "wo": -d,
    }
    if ray_diff is not None:
        out["tex_width"] = tex_width
        out["duvdx"] = duvdx
        out["duvdy"] = duvdy
    if "tri" in tables and "tan0" in tables["tri"]:
        out["tang"] = tang
    return out
