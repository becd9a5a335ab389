"""Built-in benchmark scenes (counterpart of ``pbrt_tpu/testscenes.py``).

BASELINE scene 2: the analytic Cornell box (12 triangles of diffuse
quads, a mirror sphere and a matte sphere, a ceiling area light, path
integrator), below the BVH's ``minprims``, so the brute-force
intersector sweeps it.

BASELINE config 3: a procedurally displaced ~50k-triangle torus with a
checkerboard-textured matte material on a matte floor, lit by a point
light and a quad area light, path integrator with MIS.  BASELINE config
5 is the same scene with a 1M-triangle torus (``nu=1000, nv=500``;
:func:`torus_triangle_data` gives its raw triangles).

BASELINE config 4 (:func:`config4_renderer`): config 3's camera, floor
and torus, the torus glossy plastic over an image texture, the floor
rough copper, a smooth glass sphere and a substrate sphere, lit only by
an image-mapped environment light (:func:`write_env_map`: a sky, a small
bright sun and seeded low-frequency noise).  BASELINE config 1's scene
file is not in the repo; :data:`CHECK_SPHERE` stands in for it: one
checkered matte sphere under a point light, box filter, 64x64.

The scene texts and meshes are the reference's (config 4 and the
config-1 stand-in are texts of reference features), so both packages
build the same scenes.
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch import Options
from pbrt_tpu_torch.core.api import PbrtAPI
from pbrt_tpu_torch.core.paramset import ParamSet


CORNELL_BOX = """
LookAt 278 273 -800  278 273 0  0 1 0
Camera "perspective" "float fov" 39.3
Sampler "halton" "integer pixelsamples" {spp}
Integrator "path" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
     "string filename" "{filename}"
WorldBegin
# ceiling area light
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [17 12 4]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [213 548.7 227  343 548.7 227  343 548.7 332  213 548.7 332]
AttributeEnd
# floor
Material "matte" "rgb Kd" [0.73 0.73 0.73]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [552.8 0 0  0 0 0  0 0 559.2  549.6 0 559.2]
# ceiling
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [556 548.8 0  556 548.8 559.2  0 548.8 559.2  0 548.8 0]
# back wall
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [549.6 0 559.2  0 0 559.2  0 548.8 559.2  556 548.8 559.2]
# right wall (green)
Material "matte" "rgb Kd" [0.12 0.45 0.15]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [0 0 559.2  0 0 0  0 548.8 0  0 548.8 559.2]
# left wall (red)
Material "matte" "rgb Kd" [0.65 0.05 0.05]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [552.8 0 0  549.6 0 559.2  556 548.8 559.2  556 548.8 0]
# mirror sphere
AttributeBegin
  Material "mirror" "rgb Kr" [0.95 0.95 0.95]
  Translate 185 100 170
  Shape "sphere" "float radius" 100
AttributeEnd
# matte sphere
AttributeBegin
  Material "matte" "rgb Kd" [0.8 0.7 0.6]
  Translate 370 90 350
  Shape "sphere" "float radius" 90
AttributeEnd
WorldEnd
"""


def cornell_text(xres=256, yres=256, spp=4, maxdepth=5, filename="cornell.png",
                 environment=False):
    """The Cornell scene's text.  ``environment``: add a constant infinite
    light (the box is open toward the camera), a gaussian pixel filter and
    a crop window, so the render takes the escaped-ray MIS and the
    filtered scatter film."""
    text = CORNELL_BOX.format(xres=xres, yres=yres, spp=spp, maxdepth=maxdepth,
                              filename=filename)
    if environment:
        text = text.replace('"string filename"', '"float cropwindow" [0.2 0.8 0.1 0.7]\n'
                            '     "string filename"')
        text = text.replace("WorldBegin\n", 'PixelFilter "gaussian"\nWorldBegin\n'
                            'LightSource "infinite" "rgb L" [0.2 0.2 0.25]\n')
    return text


def cornell_description(xres=256, yres=256, spp=4, maxdepth=5, filename="cornell.png",
                        options=None, environment=False):
    """Parse the Cornell scene (:func:`cornell_text`) -> (SceneDescription,
    Options)."""
    api = PbrtAPI(options or Options(), render_on_world_end=False)
    api.init()
    api.parse_string(cornell_text(xres, yres, spp, maxdepth, filename, environment))
    return api.scene, api.opt


def cornell_renderer(xres=256, yres=256, spp=4, maxdepth=5, ray_batch=1 << 16, seed=0,
                     device="cuda", walk="bvh8", sort="stable", environment=False,
                     double=False):
    """BASELINE scene 2 (or its ``environment`` variant) on ``device`` ->
    Renderer (``double``: the float64 policy).  ``walk`` and ``sort``
    reach only a scene that takes the BVH (``accel/bvh.py``)."""
    from pbrt_tpu_torch.render import Renderer

    desc, opts = cornell_description(xres, yres, spp, maxdepth,
                                     options=Options(ray_batch=ray_batch, double=double),
                                     environment=environment)
    return Renderer(desc, opts, seed=seed, device=device, walk=walk, sort=sort)


def _torus_mesh_params(nu=224, nv=112, major=1.0, minor=0.4, displace=0.08,
                       float_t=np.float32):
    """Procedural displaced torus: 2*nu*nv triangles (host numpy; its
    vertices rounded to float32 under either policy, as the reference's
    are, then held in the policy's float ``float_t``)."""
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = minor * (
        1.0
        + displace * np.sin(7 * uu) * np.cos(5 * vv)
        + 0.5 * displace * np.sin(13 * vv + 2 * uu)
    )
    x = (major + r * np.cos(vv)) * np.cos(uu)
    y = (major + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uvs = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], axis=-1).reshape(-1, 2)
    gi, gj = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")

    def vid(i, j):
        return (i % nu) * nv + (j % nv)

    a = vid(gi, gj)
    b = vid(gi + 1, gj)
    c = vid(gi + 1, gj + 1)
    dd = vid(gi, gj + 1)
    idx = np.stack([a, b, c, a, c, dd], axis=-1).reshape(-1).tolist()
    ps = ParamSet(float_t)
    ps.add_int("indices", idx)
    ps.add_point3f("P", pts.astype(np.float32))
    ps.add_point2f("uv", uvs.astype(np.float32))
    return ps, len(idx) // 3


MESH_SCENE = """
LookAt 2.8 2.2 2.8  0 0 0  0 0 1
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" {spp}
Integrator "path" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
Accelerator "bvh"
WorldBegin
LightSource "point" "rgb I" [30 28 25] "point from" [3 -3 4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 7]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 -1 3.5  1 -1 3.5  1 1 3.5  -1 1 3.5]
AttributeEnd
Texture "checks" "spectrum" "checkerboard"
    "float uscale" [16] "float vscale" [8]
    "rgb tex1" [.2 .3 .5] "rgb tex2" [.8 .75 .6]
Material "matte" "texture Kd" "checks"
"""

FLOOR = """
Material "matte" "rgb Kd" [0.4 0.4 0.42]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-8 -8 -0.7  8 -8 -0.7  8 8 -0.7  -8 8 -0.7]
"""

# an analytic mirror sphere between the camera and the torus (spheres beside
# the BVH)
MIRROR_SPHERE = """
AttributeBegin
  Material "mirror" "rgb Kr" [0.9 0.9 0.9]
  Translate 1.2 0.6 1.0
  Shape "sphere" "float radius" 0.5
AttributeEnd
"""


def _mesh_head(xres, yres, spp, maxdepth, integrator="path", extra=""):
    """:data:`MESH_SCENE` under ``Integrator "<integrator>"`` with the
    ``extra`` parameters."""
    return MESH_SCENE.format(spp=spp, maxdepth=maxdepth, xres=xres, yres=yres).replace(
        'Integrator "path"', f'Integrator "{integrator}" {extra}')


def mesh_scene_description(xres=256, yres=256, spp=4, maxdepth=5, ray_batch=1 << 16,
                           nu=224, nv=112, sphere=False, integrator="path", extra="",
                           double=False):
    """Parse BASELINE config 3 (``sphere``: with :data:`MIRROR_SPHERE`;
    ``integrator`` with the ``extra`` parameters in place of ``path``) ->
    (SceneDescription, Options, n_torus_tris); ``double``: the float64
    policy."""
    api = PbrtAPI(Options(ray_batch=ray_batch, double=double), render_on_world_end=False)
    api.init()
    api.parse_string(_mesh_head(xres, yres, spp, maxdepth, integrator, extra))
    ps, n_tris = _torus_mesh_params(nu, nv, float_t=api.float_t)
    api.shape("trianglemesh", ps)
    api.parse_string(FLOOR + (MIRROR_SPHERE if sphere else ""))
    api.scene.film_params.add_int("xresolution", [xres])
    api.scene.film_params.add_int("yresolution", [yres])
    return api.scene, api.opt, n_tris


def mesh_scene_renderer(xres=256, yres=256, spp=4, maxdepth=5, ray_batch=1 << 16,
                        nu=224, nv=112, seed=0, device="cuda", walk="bvh8",
                        sort="stable", sphere=False, integrator="path", extra="",
                        double=False, **switches):
    """BASELINE config 3 (``sphere``: with a mirror sphere; ``integrator``
    in place of ``path``) on ``device`` with the BVH walk ``walk`` and the
    ``co_sort`` network ``sort`` (``accel/bvh.py``); ``switches``: the
    rest of ``Renderer``'s (``sorted_carry``, ``shadow_sort``,
    ``stream_min_tris``, ``key_obits``, ``deadbit``; ``double``: the
    float64 policy) -> (Renderer, n_torus_tris)."""
    from pbrt_tpu_torch.render import Renderer

    desc, opts, n_tris = mesh_scene_description(xres, yres, spp, maxdepth, ray_batch,
                                                nu, nv, sphere, integrator, extra, double)
    return Renderer(desc, opts, seed=seed, device=device, walk=walk, sort=sort,
                    **switches), n_tris


CONFIG4_HEAD = """
LookAt 2.8 2.2 2.8  0 0 0  0 0 1
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" {spp}
Integrator "path" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
Accelerator "bvh"
WorldBegin
LightSource "infinite" "string mapname" "{env}"
Texture "albedo" "spectrum" "imagemap" "string filename" "{tex}"
Material "plastic" "texture Kd" "albedo" "rgb Ks" [0.4 0.4 0.4] "float roughness" 0.2
"""

CONFIG4_TAIL = """
Material "metal" "float roughness" 0.05
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-8 -8 -0.7  8 -8 -0.7  8 8 -0.7  -8 8 -0.7]
AttributeBegin
  Material "glass" "float eta" 1.5
  Translate 1.2 0.6 1.0
  Shape "sphere" "float radius" 0.5
AttributeEnd
AttributeBegin
  Material "substrate" "float uroughness" 0.1
  Translate 0.3 -1.9 -0.3
  Shape "sphere" "float radius" 0.4
AttributeEnd
"""


def write_env_map(path, w=1024, h=1024, seed=0):
    """Write a seeded lat-long environment map (PFM, [h, w] RGB; row 0 is
    the zenith, +z): a sky gradient over a dim ground, a small bright sun
    disc and low-frequency noise, so that its Distribution2D is far from
    uniform.  Keep it square: both packages' MIPMap raises for other
    shapes, and the light then falls back to a constant one."""
    from pbrt_tpu_torch.core.geometry import Bounds2i
    from pbrt_tpu_torch.core.imageio import write_image

    rng = np.random.default_rng(seed)
    theta = np.pi * (np.arange(h) + 0.5) / h
    phi = 2 * np.pi * (np.arange(w) + 0.5) / w
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    up = np.clip(np.cos(th), 0.0, 1.0)[..., None]
    sky = (1 - up) * np.array([0.9, 0.9, 1.0]) + up * np.array([0.25, 0.45, 1.0])
    img = np.where((th < np.pi / 2)[..., None], sky, np.array([0.15, 0.12, 0.1]))
    noise = np.zeros_like(th)
    for _ in range(6):
        ku, kv = rng.integers(1, 5, 2)
        noise += rng.uniform(0.02, 0.06) * np.sin(ku * ph + rng.uniform(0, 2 * np.pi)) * np.cos(
            kv * th + rng.uniform(0, 2 * np.pi))
    img = img * (1.0 + noise)[..., None]
    # the sun: 3 degrees across, 35 degrees from the zenith
    sun = np.array([np.sin(0.61) * np.cos(0.7), np.sin(0.61) * np.sin(0.7), np.cos(0.61)])
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], axis=-1)
    img = np.where((d @ sun > np.cos(np.radians(1.5)))[..., None], np.array([400.0, 380.0, 330.0]),
                   img)
    write_image(str(path), img.astype(np.float32), Bounds2i((0, 0), (w, h)))


def write_texture_map(path, size=256, seed=0):
    """Write a seeded [size, size] RGB texture (PFM), values in [0.1, 0.9]."""
    from pbrt_tpu_torch.core.geometry import Bounds2i
    from pbrt_tpu_torch.core.imageio import write_image

    img = np.random.default_rng(seed).uniform(0.1, 0.9, (size, size, 3))
    write_image(str(path), img.astype(np.float32), Bounds2i((0, 0), (size, size)))


def config4_text(env_path, tex_path, xres=256, yres=256, spp=8, maxdepth=5):
    """Config 4's scene text (head, tail): the torus mesh goes between
    them, under the head's plastic."""
    head = CONFIG4_HEAD.format(spp=spp, maxdepth=maxdepth, xres=xres, yres=yres,
                               env=env_path, tex=tex_path)
    return head, CONFIG4_TAIL


def config4_renderer(env_path, tex_path, xres=256, yres=256, spp=8, maxdepth=5,
                     ray_batch=1 << 18, nu=224, nv=112, seed=0, device="cuda", walk="bvh8",
                     sort="stable"):
    """BASELINE config 4 on ``device`` (the maps at ``env_path`` and
    ``tex_path``: :func:`write_env_map`, :func:`write_texture_map`) ->
    (Renderer, n_torus_tris)."""
    from pbrt_tpu_torch.render import Renderer

    head, tail = config4_text(env_path, tex_path, xres, yres, spp, maxdepth)
    api = PbrtAPI(Options(ray_batch=ray_batch), render_on_world_end=False)
    api.init()
    api.parse_string(head)
    ps, n_tris = _torus_mesh_params(nu, nv)
    api.shape("trianglemesh", ps)
    api.parse_string(tail)
    api.scene.film_params.add_int("xresolution", [xres])
    api.scene.film_params.add_int("yresolution", [yres])
    return Renderer(api.scene, api.opt, seed=seed, device=device, walk=walk,
                    sort=sort), n_tris


# a stand-in for BASELINE config 1's scenes/check-sphere.pbrt;
# ``{integrator}`` names the integrator and its parameters
CHECK_SPHERE = """
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" 35
Sampler "halton" "integer pixelsamples" {spp}
Integrator {integrator}
PixelFilter "box"
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
LightSource "point" "rgb I" [40 40 40] "point from" [3 3 4]
Texture "checks" "spectrum" "checkerboard" "float uscale" [8] "float vscale" [8]
    "rgb tex1" [.15 .15 .15] "rgb tex2" [.85 .8 .7]
Material "matte" "texture Kd" "checks"
Shape "sphere" "float radius" 1
WorldEnd
"""

# tests/test_direct.py's closed diffuse box under a ceiling area light
DIRECT_BOX = """
LookAt 0 1 4  0 1 0  0 1 0
Camera "perspective" "float fov" 60
Sampler "halton" "integer pixelsamples" {spp}
Integrator {integrator}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -0.5 2.49 -0.5   0.5 2.49 -0.5   0.5 2.49 0.5   -0.5 2.49 0.5 ]
AttributeEnd
Material "matte" "rgb Kd" [0.9 0.9 0.9]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 0 2.5   -2.5 0 2.5 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 2.5 -2.5   2.5 2.5 -2.5   2.5 2.5 2.5   -2.5 2.5 2.5 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 2.5 -2.5   -2.5 2.5 -2.5 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   -2.5 0 2.5   -2.5 2.5 2.5   -2.5 2.5 -2.5 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ 2.5 0 -2.5   2.5 0 2.5   2.5 2.5 2.5   2.5 2.5 -2.5 ]
WorldEnd
"""


def torus_triangle_data(nu=1000, nv=500, **kw):
    """Raw TriangleData of the displaced torus (2 nu nv triangles);
    ``nu=1000, nv=500`` is BASELINE config 5's 1M triangles."""
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.shapes import make_shape

    ps, _ = _torus_mesh_params(nu, nv, **kw)
    return make_shape("trianglemesh", ps, Transform.identity(), False)


# the reference's gradient targets (tests/test_grad.py, test_texture_grad.py)
GRAD_SPHERE = """
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 3
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [.5 .5 .5]
{material}
Shape "sphere" "float radius" 1
WorldEnd
"""
GRAD_MATTE = 'Material "matte" "rgb Kd" [0.4 0.5 0.6]'
GRAD_NESTED_MIX = """MakeNamedMaterial "ma" "string type" "matte" "rgb Kd" [0.4 0.5 0.6]
MakeNamedMaterial "mb" "string type" "matte" "rgb Kd" [0.1 0.8 0.3]
MakeNamedMaterial "mc" "string type" "matte" "rgb Kd" [0.7 0.2 0.1]
MakeNamedMaterial "inner" "string type" "mix" "string namedmaterial1" "mb"
  "string namedmaterial2" "mc" "rgb amount" [0.6 0.6 0.6]
Material "mix" "string namedmaterial1" "ma" "string namedmaterial2" "inner"
  "rgb amount" [0.3 0.3 0.3]"""
# an image-textured quad under a distant light, seen by an orthographic
# camera; ``{path}`` names the texture
GRAD_TEXTURE = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 2
Film "image" "integer xresolution" [12] "integer yresolution" [12]
WorldBegin
LightSource "distant" "point from" [0 0 10] "rgb L" [3 3 3]
Texture "wood" "spectrum" "imagemap" "string filename" "{path}"
Material "matte" "texture Kd" "wood"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -1 -1 0   1 -1 0   1 1 0   -1 1 0 ]
    "float st" [0 0  1 0  1 1  0 1]
WorldEnd
"""


def text_renderer(text, ray_batch=1 << 16, seed=0, device="cuda", double=False):
    """Scene text -> Renderer on ``device`` (``double``: the float64 policy)."""
    from pbrt_tpu_torch.render import Renderer

    api = PbrtAPI(Options(ray_batch=ray_batch, double=double), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    return Renderer(api.scene, api.opt, seed=seed, device=device)


def comb_tree(levels):
    """A skip-link BVH that is ``levels + 1`` levels deep, to exercise deep
    walk stacks: (mins, maxs, skips, firsts, counts, p0, p1, p2) in
    ``build_bvh``'s layout.  Spine node i (i < levels) has on its left a
    pair node over triangles 2i and 2i + 1, the two halves y + z <= 0 and
    y + z >= 0 of the square [-0.5, 0.5]^2 in the plane x = levels + 1 - i,
    and on its right spine node i + 1 (after the last, a leaf with
    triangle 2 levels at x = 1).  A +x ray through y + z < 0 from x < 1
    hits every box and takes the nearer right child at every spine node,
    so both the plain and the fused-leaf walk push ``levels`` - 1 or more
    entries."""
    n = levels
    m = 4 * n + 1
    x = np.repeat((n + 1 - np.arange(n)).astype(np.float32), 2)
    x = np.append(x, np.float32(1.0))
    lo, hi = np.full(2 * n + 1, -0.5, np.float32), np.full(2 * n + 1, 0.5, np.float32)
    upper = (np.arange(2 * n + 1) % 2 == 1)[:, None]  # the y + z >= 0 halves
    p0 = np.where(upper, np.stack([x, hi, hi], 1), np.stack([x, lo, lo], 1))
    p1 = np.where(upper, np.stack([x, lo, hi], 1), np.stack([x, hi, lo], 1))
    p2 = np.where(upper, np.stack([x, hi, lo], 1), np.stack([x, lo, hi], 1))
    t_min, t_max = np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)
    i = np.arange(n)
    spine, pair = 4 * i, 4 * i + 1
    leaves = np.append(np.stack([4 * i + 2, 4 * i + 3], 1).ravel(), m - 1)  # of triangle t
    mins = np.zeros((m, 3), np.float32)
    maxs = np.zeros((m, 3), np.float32)
    skips = np.full(m, m, np.int32)
    firsts = np.zeros(m, np.int32)
    counts = np.zeros(m, np.int32)
    mins[leaves], maxs[leaves] = t_min, t_max
    firsts[leaves], counts[leaves] = np.arange(2 * n + 1), 1
    skips[leaves[:-1]] = leaves[:-1] + 1
    skips[pair] = pair + 3
    mins[pair] = np.minimum(t_min[0:-1:2], t_min[1::2])
    maxs[pair] = np.maximum(t_max[0:-1:2], t_max[1::2])
    mins[spine] = np.minimum.accumulate(t_min[::-1])[::-1][0:-1:2]
    maxs[spine] = np.maximum.accumulate(t_max[::-1])[::-1][0:-1:2]
    return mins, maxs, skips, firsts, counts, p0, p1, p2


# --- scene files: the front door (python -m pbrt_tpu_torch scene.pbrt) -----


def write_torus_ply(path, nu=224, nv=112):
    """Write config 3's displaced torus (``_torus_mesh_params``) as a
    binary little-endian PLY: vertices (x, y, z, u, v) as float32, faces
    as (uchar 3, int32 x 3)."""
    ps, n_tris = _torus_mesh_params(nu, nv)
    pts = np.asarray(ps.find_point3f("P"), dtype="<f4").reshape(-1, 3)
    uvs = np.asarray(ps.find_point2f("uv"), dtype="<f4").reshape(-1, 2)
    idx = np.asarray(ps.find_int("indices"), dtype="<i4").reshape(-1, 3)
    faces = np.zeros(len(idx), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    faces["n"], faces["idx"] = 3, idx
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n"
              + "".join(f"property float {c}\n" for c in "xyzuv")
              + f"element face {len(idx)}\nproperty list uchar int vertex_indices\n"
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.concatenate([pts, uvs], axis=1).astype("<f4").tobytes())
        f.write(faces.tobytes())
    return n_tris


VOLUME_BOX = ((-2.3, -2.8, -0.66), (-1.1, -1.6, 0.54))  # the smoke box: p0, p1
VOLUME_HEAD = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.01 0.01 0.01] "rgb sigma_s" [0.05 0.05 0.05] "float g" 0.3
MakeNamedMedium "smoke" "string type" "heterogeneous"
    "rgb sigma_a" [0.5 0.5 0.5] "rgb sigma_s" [2 2 2] "float g" 0.2
    "integer nx" {grid} "integer ny" {grid} "integer nz" {grid}
    "point p0" [{p0}] "point p1" [{p1}]
    "float density" [{density}]
MediumInterface "" "fog"
LookAt 2.8 2.2 2.8  0 0 0  0 0 1
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" {spp}
Integrator "volpath" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
    "string filename" "{filename}"
Accelerator "bvh"
WorldBegin
LightSource "point" "rgb I" [30 28 25] "point from" [3 -3 4]
LightSource "spot" "rgb I" [60 60 55] "point from" [0.4 0.6 3.2] "point to" [0 0 0]
    "float coneangle" 30 "float conedeltaangle" 5
AttributeBegin
  MediumInterface "fog" "fog"
  AreaLightSource "diffuse" "rgb L" [6 6 7]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 -1 3.5  1 -1 3.5  1 1 3.5  -1 1 3.5]
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Material "subsurface" "string name" "marble"
  Shape "plymesh" "string filename" "{ply}"
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Material "matte" "rgb Kd" [0.4 0.4 0.42]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-8 -8 -0.7  8 -8 -0.7  8 8 -0.7  -8 8 -0.7]
AttributeEnd
AttributeBegin
  Material ""
  MediumInterface "smoke" "fog"
  Shape "trianglemesh" "integer indices" [{box_indices}]
    "point P" [{box_points}]
AttributeEnd
WorldEnd
"""


def smoke_density(grid=64, seed=0, blobs=6):
    """The smoke's [grid]^3 density ([z, y, x]): a sum of seeded gaussian
    blobs over the unit cube, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    c = (np.arange(grid) + 0.5) / grid
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    dens = np.zeros((grid, grid, grid))
    for _ in range(blobs):
        mx, my, mz = rng.uniform(0.25, 0.75, size=3)
        sigma = rng.uniform(0.1, 0.22)
        amp = rng.uniform(0.5, 1.0)
        dens += amp * np.exp(-((x - mx) ** 2 + (y - my) ** 2 + (z - mz) ** 2) / (2 * sigma ** 2))
    return np.clip(dens, 0.0, 1.0).astype(np.float32)


def volume_text(ply_path, xres=256, yres=256, spp=8, maxdepth=5, grid=64, seed=0,
                filename="volume.pfm"):
    """A fog-and-smoke scene file composed from config 3: the camera in a
    homogeneous fog that is every shape's outside, config 3's camera,
    point light, area quad and floor, the PLY torus (``write_torus_ply``)
    under ``Material "subsurface"`` (marble), a 12-triangle null-material
    box of heterogeneous smoke (a ``grid``^3 density of seeded blobs,
    inline) 0.04 above the floor behind the torus, seen above it, and a spot light
    above the torus; ``Integrator "volpath"``, halton.  Every shape
    declares its MediumInterface (a surface without one sends rays that
    cross it to vacuum), and no surface lies inside the box or on its
    faces: a floor inside it would take lanes out of the smoke."""
    p0, p1 = (np.asarray(p, dtype=np.float64) for p in VOLUME_BOX)
    # the box's corners, x fastest; its faces wound outward
    corners = np.array([[p1[0] if i & 1 else p0[0], p1[1] if i & 2 else p0[1],
                         p1[2] if i & 4 else p0[2]] for i in range(8)])
    faces = [0, 2, 3, 0, 3, 1, 4, 5, 7, 4, 7, 6, 0, 1, 5, 0, 5, 4,
             2, 6, 7, 2, 7, 3, 0, 4, 6, 0, 6, 2, 1, 3, 7, 1, 7, 5]
    dens = smoke_density(grid, seed)
    return VOLUME_HEAD.format(
        grid=grid, p0=" ".join(f"{v:g}" for v in p0), p1=" ".join(f"{v:g}" for v in p1),
        density=" ".join(f"{v:.4g}" for v in dens.ravel()), spp=spp, maxdepth=maxdepth,
        xres=xres, yres=yres, filename=filename, ply=ply_path,
        box_indices=" ".join(map(str, faces)),
        box_points=" ".join(f"{v:g}" for v in corners.ravel()))


def volume_rays(n, seed=0):
    """n seeded rays from around the smoke box (:data:`VOLUME_BOX`) toward
    points inside it, as host arrays: o, d [n, 3] (unit), t_max [n] (the
    far side of the box or short of it), pixel_xy [n, 2] and sample
    indices [n], for the tracking loops."""
    rng = np.random.default_rng(seed)
    p0, p1 = (np.asarray(p) for p in VOLUME_BOX)
    c, half = (p0 + p1) / 2, (p1 - p0) / 2
    o = c + rng.uniform(-1.6, 1.6, (n, 3)) * half
    d = c + rng.uniform(-0.8, 0.8, (n, 3)) * half - o
    dist = np.linalg.norm(d, axis=-1)
    d = d / dist[:, None]
    t_max = dist * rng.uniform(0.5, 2.0, n)
    pix = np.stack([rng.integers(0, 256, n), rng.integers(0, 256, n)], axis=-1)
    return (o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32), pix,
            rng.integers(0, 8, n))


def write_volume_scene(path, ply_path, nu=224, nv=112, **kw):
    """Write the torus PLY (``nu`` x ``nv``) and the :func:`volume_text`
    scene file that reads it; returns the torus's triangle count."""
    n_tris = write_torus_ply(ply_path, nu, nv)
    with open(path, "w") as f:
        f.write(volume_text(str(ply_path), **kw))
    return n_tris


def config3_scenefile(path, ply_path, xres=256, yres=256, spp=8, maxdepth=4,
                      integrator="path", extra="", camera="", rotate=0.0, shift=0.0,
                      material=""):
    """Config 3 as a scene file: :data:`MESH_SCENE` under ``Integrator
    "<integrator>"`` with ``extra`` parameters (e.g. ``"bdpt"``, or
    ``"mlt"`` with ``'"integer mutationsperpixel" 8'``), the torus as a
    ``plymesh`` (written by :func:`write_torus_ply`) and :data:`FLOOR`, in
    ``mesh_scene_description``'s shape order.  ``camera``: another camera
    line in place of the perspective one (``'Camera "environment"'``, or
    ``'Camera "realistic" "string lensfile" "biconvex-50mm-f8"'``).  With
    ``rotate`` or ``shift``, motion across ``shutteropen 0 shutterclose
    1``: the torus turns ``rotate`` degrees about its axis (z; 30 degrees
    gives 4 keyframes) and the camera moves ``shift`` along world x.
    ``material``: another material line for the torus (e.g. ``'Material
    "fourier" "string bsdffile" "glossy.bsdf"'``)."""
    head = _mesh_head(xres, yres, spp, maxdepth, integrator, extra)
    if material:
        torus_mat = 'Material "matte" "texture Kd" "checks"'
        assert torus_mat in head
        head = head.replace(torus_mat, material)
    cam = 'Camera "perspective" "float fov" 45'
    assert cam in head
    torus = f'Shape "plymesh" "string filename" "{ply_path}"\n'
    if rotate or shift:
        head = head.replace(cam, (f"ActiveTransform EndTime\nTranslate {-shift} 0 0\n"
                                  f"ActiveTransform All\n{camera or cam}"
                                  ' "float shutteropen" 0 "float shutterclose" 1'))
        torus = (f"AttributeBegin\nActiveTransform EndTime\nRotate {rotate} 0 0 1\n"
                 f"ActiveTransform All\n{torus}AttributeEnd\n")
    elif camera:
        head = head.replace(cam, camera)
    with open(path, "w") as f:
        f.write(head + torus + FLOOR + "WorldEnd\n")


QUADRICS = {  # name -> (transform, material, shape parameters)
    "cylinder": ("Translate 3 -1.5 -0.7", 'Material "matte" "texture Kd" "uvcyl"',
                 '"float radius" 0.4 "float zmin" 0 "float zmax" 1.2'),
    "cone": ("Translate -1.5 3 -0.7", 'Material "plastic" "texture Kd" "dotsph" '
             '"rgb Ks" [0.3 0.3 0.3] "float roughness" 0.1', '"float radius" 0.6 "float height" 1.5'),
    "paraboloid": ("Translate 3 3 -0.7", 'Material "matte" "texture Kd" "bilerp"',
                   '"float radius" 0.6 "float zmin" 0 "float zmax" 1.2'),
    "hyperboloid": ("Translate -3 1.5 -0.7", 'Material "matte" "texture Kd" "scaled"',
                    '"point p1" [0.5 0 0] "point p2" [0.3 0.4 1.4]'),
}

SCENEFILE_HEAD = """
LookAt 6 5 4.5  0 0 0  0 0 1
Camera "perspective" "float fov" 50
Sampler "{sampler}" "integer pixelsamples" {spp}
Integrator "path" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
    "string filename" "{filename}"
Accelerator "bvh"
WorldBegin
LightSource "point" "rgb I" [30 28 25] "point from" [3 -3 6]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 9]
  Translate 0 0 5
  Rotate 180 1 0 0
  Shape "disk" "float radius" 1.5
AttributeEnd
Texture "marble" "spectrum" "marble" "float scale" 2.5 "float variation" 0.4
Texture "checks3" "spectrum" "checkerboard" "integer dimension" 3
    "rgb tex1" [0.7 0.7 0.65] "rgb tex2" [0.25 0.3 0.35]
Texture "dotsplanar" "spectrum" "dots" "string mapping" "planar" "float udelta" 0.25
    "vector v1" [4 0 0] "vector v2" [0 4 0] "rgb inside" [0.8 0.2 0.15] "rgb outside" [0.5 0.5 0.45]
Texture "wrinkled" "float" "wrinkled" "integer octaves" 5
Texture "ground" "spectrum" "mix" "texture tex1" "checks3" "texture tex2" "dotsplanar"
    "texture amount" "wrinkled"
Texture "uvcyl" "spectrum" "uv" "string mapping" "cylindrical"
Texture "dotsph" "spectrum" "dots" "string mapping" "spherical"
    "rgb inside" [0.1 0.5 0.8] "rgb outside" [0.6 0.6 0.55]
Texture "bilerp" "spectrum" "bilerp" "string mapping" "planar"
    "rgb v00" [0.9 0.2 0.2] "rgb v01" [0.2 0.9 0.2] "rgb v10" [0.2 0.2 0.9] "rgb v11" [0.8 0.8 0.2]
Texture "windy" "float" "windy"
Texture "scaled" "spectrum" "scale" "texture tex1" "checks3" "texture tex2" "windy"
Texture "fbm" "spectrum" "fbm" "integer octaves" 6
Texture "uvtex" "spectrum" "uv" "float uscale" 3 "float vscale" 2
ObjectBegin "torus"
  Material "matte" "texture Kd" "marble"
  Shape "plymesh" "string filename" "{ply}"
ObjectEnd
"""

# the torus instances' placements, in the order they are used
INSTANCES = ("Translate 0 0 -0.2  Scale 0.7 0.7 0.7", "Translate 2.4 0.3 -0.4  Rotate 60 0 0 1",
             "Translate 0.2 2.5 -0.3  Rotate 90 1 0 0  Scale 0.6 0.6 0.6",
             "Translate -2.5 -2.2 -0.1  Rotate 30 0 1 0")

NURBS = """AttributeBegin
  Material "matte" "texture Kd" "uvtex"
  Translate -3 -3 0.2
  Shape "nurbs" "integer nu" 4 "integer nv" 3 "integer uorder" 3 "integer vorder" 2
    "float uknots" [0 0 0 0.5 1 1 1] "float vknots" [0 0 0.5 1 1]
    "point P" [0 0 0  0.6 0 0.5  1.2 0 0  1.8 0 0.4
               0 0.8 0.3  0.6 0.8 0.9  1.2 0.8 0.3  1.8 0.8 0.6
               0 1.6 0  0.6 1.6 0.4  1.2 1.6 0  1.8 1.6 0.3]
AttributeEnd
"""


def _icosahedron():
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]])
    f = [0, 11, 5, 0, 5, 1, 0, 1, 7, 0, 7, 10, 0, 10, 11, 1, 5, 9, 5, 11, 4, 11, 10, 2,
         10, 7, 6, 7, 1, 8, 3, 9, 4, 3, 4, 2, 3, 2, 6, 3, 6, 8, 3, 8, 9, 4, 9, 5, 2, 4, 11,
         6, 2, 10, 8, 6, 7, 9, 8, 1]
    return v / np.linalg.norm(v[0]), f


def scenefile_text(ply_path, xres=256, yres=256, spp=16, maxdepth=5, sampler="sobol",
                   filename="scenefile.pfm", instances=4, heightfield=256, loop_levels=4,
                   quadrics=tuple(QUADRICS), nurbs=True):
    """The scene vocabulary in one file: the PLY torus as an object placed
    ``instances`` times, a ``heightfield`` x ``heightfield``-sample floor,
    a Loop-subdivided icosahedron, the disk area light and the other
    ``quadrics``, a ``nurbs`` patch and a point light, under every
    procedural texture and mapping (uv, spherical, cylindrical, planar and
    3D)."""
    out = [SCENEFILE_HEAD.format(sampler=sampler, spp=spp, maxdepth=maxdepth, xres=xres,
                                 yres=yres, filename=filename, ply=ply_path)]
    for place in INSTANCES[:instances]:
        out.append(f'AttributeBegin\n  {place}\n  ObjectInstance "torus"\nAttributeEnd\n')
    n = heightfield
    u, v = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="xy")
    pz = 0.5 + 0.25 * np.sin(6 * u) * np.cos(5 * v) + 0.1 * np.sin(17 * u + 11 * v)
    out.append('AttributeBegin\n  Material "matte" "texture Kd" "ground"\n'
               '  Translate -6 -6 -1.1\n  Scale 12 12 0.5\n'
               f'  Shape "heightfield" "integer nu" {n} "integer nv" {n} "float Pz" ['
               + " ".join(f"{x:.5f}" for x in pz.ravel()) + "]\nAttributeEnd\n")
    verts, faces = _icosahedron()
    out.append('AttributeBegin\n  Material "matte" "texture Kd" "fbm"\n'
               '  Translate 1.8 -2.6 0.1\n  Scale 0.8 0.8 0.8\n'
               f'  Shape "loopsubdiv" "integer nlevels" {loop_levels} "integer indices" ['
               + " ".join(map(str, faces)) + '] "point P" ['
               + " ".join(f"{x:.9f}" for x in verts.ravel()) + "]\nAttributeEnd\n")
    for name in quadrics:
        place, material, params = QUADRICS[name]
        out.append(f'AttributeBegin\n  {material}\n  {place}\n  Shape "{name}" {params}\n'
                   "AttributeEnd\n")
    if nurbs:
        out.append(NURBS)
    out.append("WorldEnd\n")
    return "".join(out)


# --- bidirectional and Metropolis transport, volume gradients ---------------

# tests/test_mlt.py's caustic: a glass sphere over a floor under a point
# light, which only light tracing (BDPT's t = 0 strategies) renders
CAUSTIC = """
LookAt 0 2.2 3.2  0 0.4 0  0 1 0
Camera "perspective" "float fov" 45 {camera}
Sampler "halton" "integer pixelsamples" {spp}
Integrator "{integrator}" "integer maxdepth" {maxdepth} {extra}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
LightSource "point" "rgb I" [40 40 40] "point from" [0 3.0 0]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -3 0 -3   3 0 -3   3 0 3   -3 0 3 ]
AttributeBegin
  Material "glass"
  Translate 0 1.0 0
  Shape "sphere" "float radius" 0.45
AttributeEnd
WorldEnd
"""


# tests/test_sppm.py's open box: a ceiling area light over a floor and a
# back wall
GI_BOX = """
LookAt 0 1 4  0 1 0  0 1 0
Camera "perspective" "float fov" 60 {camera}
Sampler "halton" "integer pixelsamples" {spp}
Integrator "{integrator}" "integer maxdepth" {maxdepth} {extra}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -0.5 2.49 -0.5   0.5 2.49 -0.5   0.5 2.49 0.5   -0.5 2.49 0.5 ]
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 0 2.5   -2.5 0 2.5 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 2.5 -2.5   -2.5 2.5 -2.5 ]
WorldEnd
"""


def gi_box_text(integrator="bdpt", xres=24, yres=24, spp=8, maxdepth=4, extra="", camera=""):
    """:data:`GI_BOX` under ``integrator`` (``camera``: extra camera
    parameters, e.g. ``'"float lensradius" 0.05'``)."""
    return GI_BOX.format(integrator=integrator, xres=xres, yres=yres, spp=spp,
                         maxdepth=maxdepth, extra=extra, camera=camera)


# tests/test_refrender.py's GI box (a ceiling area light over a floor and a
# back wall), for the scalar tracer ``refrender.py``
REF_GI_BOX = """
LookAt 0 1 3.2  0 1 0  0 1 0
Camera "perspective" "float fov" 60
Sampler "halton" "integer pixelsamples" {spp}
Integrator "path" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -0.5 2.49 -0.5   0.5 2.49 -0.5   0.5 2.49 0.5   -0.5 2.49 0.5 ]
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.6 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2 0 -2   2 0 -2   2 0 2   -2 0 2 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2 0 -2   2 0 -2   2 2.5 -2   -2 2.5 -2 ]
WorldEnd
"""


def ref_gi_box(xres=16, yres=16, spp=4, maxdepth=4):
    """:data:`REF_GI_BOX` -> (scene text, the scalar tracer's RefScene
    arguments (spheres, triangles, materials, lights), its camera (eye,
    look, up, fov))."""
    def quad(p):
        p = [np.asarray(q, np.float64) for q in p]
        return [(p[0], p[1], p[2]), (p[0], p[2], p[3])]

    lq = quad([[-0.5, 2.49, -0.5], [0.5, 2.49, -0.5], [0.5, 2.49, 0.5], [-0.5, 2.49, 0.5]])
    floor = quad([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]])
    wall = quad([[-2, 0, -2], [2, 0, -2], [2, 2.5, -2], [-2, 2.5, -2]])
    tris = [(a, b, c, 0, 0) for a, b, c in lq] + [(a, b, c, 0, -1) for a, b, c in floor + wall]
    args = ([], tris, [{"type": "matte", "kd": [0.7, 0.6, 0.5]}],
            [{"type": "area", "L": [6, 6, 6], "tris": lq, "id": 0}])
    text = REF_GI_BOX.format(xres=xres, yres=yres, spp=spp, maxdepth=maxdepth)
    return text, args, ([0, 1, 3.2], [0, 1, 0], [0, 1, 0], 60.0)


def sample_table(renderer, xres, yres, spp, n_dims):
    """The renderer's sampler stream as a [lanes, n_dims] float64 table,
    lane = (y xres + x) spp + s (``bounded(spp).get`` on the renderer's
    device): the stream ``refrender.render_reference`` draws, so that it
    walks the renderer's paths."""
    import torch

    sampler = renderer.sampler.bounded(spp)
    ys, xs = np.mgrid[0:yres, 0:xres]
    pix = np.repeat(np.stack([xs.ravel(), ys.ravel()], -1), spp, axis=0)
    sidx = np.tile(np.arange(spp), xres * yres)
    dev = renderer.device
    pix = torch.as_tensor(pix.astype(np.int64), device=dev)
    sidx = torch.as_tensor(sidx.astype(np.int64), device=dev)
    return np.stack([sampler.get(pix, sidx, dim).cpu().numpy().astype(np.float64)
                     for dim in range(n_dims)], axis=-1)


def caustic_text(integrator="bdpt", xres=24, yres=24, spp=8, maxdepth=4, extra="", camera=""):
    """:data:`CAUSTIC` under ``integrator`` (``camera``: extra camera
    parameters, e.g. ``'"float lensradius" 0.05'``)."""
    return CAUSTIC.format(integrator=integrator, xres=xres, yres=yres, spp=spp,
                          maxdepth=maxdepth, extra=extra, camera=camera)


# a small torus (a PLY) and config 3's lights and floor in a homogeneous fog
FOG_TORUS = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.02 0.03 0.04] "rgb sigma_s" [0.15 0.12 0.1] "float g" 0.3
MediumInterface "" "fog"
LookAt 2.8 2.2 2.8  0 0 0  0 0 1
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" {spp}
Integrator "volpath" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
Accelerator "bvh"
WorldBegin
LightSource "point" "rgb I" [30 28 25] "point from" [3 -3 4]
AttributeBegin
  MediumInterface "fog" "fog"
  AreaLightSource "diffuse" "rgb L" [6 6 7]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 -1 3.5  1 -1 3.5  1 1 3.5  -1 1 3.5]
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Material "plastic" "rgb Kd" [0.5 0.3 0.2] "rgb Ks" [0.3 0.3 0.3] "float roughness" 0.2
  Shape "plymesh" "string filename" "{ply}"
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Material "matte" "rgb Kd" [0.4 0.4 0.42]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-8 -8 -0.7  8 -8 -0.7  8 8 -0.7  -8 8 -0.7]
AttributeEnd
WorldEnd
"""


def fog_torus_text(ply_path, xres=12, yres=12, spp=2, maxdepth=3):
    """:data:`FOG_TORUS` with the torus PLY at ``ply_path``
    (:func:`write_torus_ply`): every shape inside the fog, camera too."""
    return FOG_TORUS.format(ply=ply_path, xres=xres, yres=yres, spp=spp, maxdepth=maxdepth)


# tests/test_motion_integrators.py's scene: a red quad sweeping +x across
# the frame under a constant environment light; ``{motion}`` is its
# transform block, ``{camera_motion}`` the camera's (before ``Camera``)
MOTION_QUAD = """
LookAt 0 0 -5  0 0 0  0 1 0
{camera_motion}Camera "{camera}" "float fov" 50 "float shutteropen" 0 "float shutterclose" 1
Sampler "halton" "integer pixelsamples" {spp}
Integrator "{integrator}" "integer maxdepth" {maxdepth} {extra}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "matte" "rgb Kd" [0.9 0.2 0.2]
TransformBegin
{motion}
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-0.8 -0.8 0  0.8 -0.8 0  0.8 0.8 0  -0.8 0.8 0]
TransformEnd
{sphere}WorldEnd
"""

MOVE = "ActiveTransform EndTime\nTranslate 1.5 0 0\nActiveTransform All"
CAMERA_MOVE = "ActiveTransform EndTime\nTranslate 0.6 0.3 0\nActiveTransform All\n"
# a matte sphere that rises across the shutter (tessellated: keyframed
# triangles carry its motion)
MOVING_SPHERE = """AttributeBegin
Material "matte" "rgb Kd" [0.2 0.5 0.8]
Translate -1.2 -0.6 -0.5
ActiveTransform EndTime
Translate -1.2 0.2 -0.5
ActiveTransform All
Shape "sphere" "float radius" 0.35
AttributeEnd
"""


def motion_quad_text(integrator="path", xres=16, yres=16, spp=8, maxdepth=2, extra="",
                     motion=MOVE, camera_motion="", sphere="", camera="perspective"):
    """:data:`MOTION_QUAD` under ``integrator``: the quad moved by
    ``motion`` (:data:`MOVE`, or a static ``Translate``), the camera by
    ``camera_motion`` (:data:`CAMERA_MOVE`), and ``sphere`` (e.g.
    :data:`MOVING_SPHERE`) added."""
    return MOTION_QUAD.format(integrator=integrator, xres=xres, yres=yres, spp=spp,
                              maxdepth=maxdepth, extra=extra, motion=motion,
                              camera_motion=camera_motion, sphere=sphere, camera=camera)


FUR_HEAD = """
LookAt 0 -4.4 1.3  0 0 0.05  0 0 1
Camera "perspective" "float fov" 40
Sampler "halton" "integer pixelsamples" {spp}
Integrator "{integrator}" "integer maxdepth" {maxdepth}
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
    "string filename" "{filename}"
Accelerator "bvh"
WorldBegin
LightSource "infinite" "rgb L" [0.25 0.27 0.3]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [7 7 6.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1.5 -2.5 3.5  -1.5 -0.5 3.5  0.5 -0.5 3.5  0.5 -2.5 3.5]
AttributeEnd
Material "matte" "rgb Kd" [0.45 0.4 0.35]
Shape "sphere" "float radius" 1
Material "matte" "rgb Kd" [0.4 0.4 0.42]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-8 -8 -1.35  8 -8 -1.35  8 8 -1.35  -8 8 -1.35]
Material "hair" "float eumelanin" {eumelanin} "float pheomelanin" 0.3
    "float beta_m" 0.3 "float beta_n" 0.3 "float alpha" 2
"""


def fur_text(n_curves=4096, xres=256, yres=256, spp=8, maxdepth=8, seed=0,
             filename="fur.pfm", integrator="path", eumelanin=1.3, length=0.3,
             tessellation=8, tessellation_v=6):
    """A fur ball: ``n_curves`` cubic Bezier curves of ``type "flat"``
    rooted on a matte unit sphere, each growing ``length`` along its root
    normal and drooping toward -z, ``width0`` 0.01 tapering to ``width1``
    0.002, under one hair material in melanin mode; a floor quad, a quad
    area light and a constant infinite light.  Each curve tessellates into
    2 x ``tessellation`` x ``tessellation_v`` triangles (96 at 8 x 6):
    393,216 at the default 4096 curves.  The curves follow one plain
    ``Material "hair"`` directive, as pbrt's hair files put it, and share
    its record.  Roots and droop are made from ``seed`` with numpy."""
    rs = np.random.default_rng(seed)
    z = 1.0 - 2.0 * rs.random(n_curves)
    phi = 2.0 * np.pi * rs.random(n_curves)
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    n = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    droop = np.array([0.0, 0.0, -1.0]) + 0.3 * rs.normal(size=(n_curves, 3))
    droop -= np.sum(droop * n, axis=-1, keepdims=True) * n
    droop /= np.maximum(np.linalg.norm(droop, axis=-1, keepdims=True), 1e-9)
    lens = length * (0.8 + 0.4 * rs.random(n_curves))[:, None]
    ctrl = np.stack([n, n + 0.4 * lens * n, n + 0.75 * lens * n + 0.2 * lens * droop,
                     n + lens * (0.9 * n + 0.45 * droop)], axis=1)
    lines = [FUR_HEAD.format(spp=spp, maxdepth=maxdepth, xres=xres, yres=yres,
                             filename=filename, integrator=integrator, eumelanin=eumelanin)]
    for c in ctrl:
        pts = " ".join(f"{v:.6f}" for v in c.reshape(-1))
        lines.append(f'Shape "curve" "string type" "flat" "point P" [{pts}] '
                     f'"float width0" 0.01 "float width1" 0.002 '
                     f'"integer tessellation" {tessellation} '
                     f'"integer tessellation_v" {tessellation_v}')
    lines.append("WorldEnd\n")
    return "\n".join(lines)


def glossy_fourier_table(n_mu=64, orders=8, eta=1.3):
    """A synthetic glossy ``fourier`` table: reflection only, a_k =
    |mu_i| c_k (1, 0.8, 0.5) over the channels (Y, R, B) with c_k =
    (1 + k)^-1.2, on ``n_mu`` uniform zenith knots (``tests/test_fourier.py``'s
    glossy table with more orders and knots).  Write it with
    ``FourierTable.write``."""
    from pbrt_tpu_torch.materials.fourier import FourierTable

    coeffs = 1.0 / (1.0 + np.arange(orders)) ** 1.2
    mu = np.linspace(-1.0, 1.0, n_mu)
    oal = np.zeros((n_mu * n_mu, 2), dtype=np.int64)
    runs, off = [], 0
    for i in range(n_mu):
        for j in range(n_mu):
            if mu[i] * mu[j] < 0:
                a = np.outer([1.0, 0.8, 0.5], coeffs * abs(mu[i])).astype(np.float32)
                oal[i * n_mu + j] = (off, orders)
                runs.append(a.reshape(-1))
                off += 3 * orders
    return FourierTable(eta, mu, oal, np.concatenate(runs), m_max=orders, n_channels=3)
