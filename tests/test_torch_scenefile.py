"""The scene-file vocabulary of pbrt_tpu_torch against the JAX reference:
the tessellated shapes, PLY, Loop subdivision, NURBS and object
instancing; the six samplers, the Sobol' table and the host PCG32; the procedural
textures and mappings.

Shapes, instanced tables, samplers, the Sobol' table and PCG32 are
exact (np.array_equal, sample bits equal).  Textures are held against
the reference evaluated under ``jax.jit``, as its renders evaluate them,
to rtol 1e-5 / atol 1e-6.  The noise textures are held to that under a
transform that float32 applies exactly: XLA rounds a dot by a trace-time
constant matrix in its own order (its eager and compiled mappings differ
in the last bit too), and the noise's octaves amplify one bit of the
texture-space point beyond that tolerance.  Under the general transform
they are held looser (NOISE_SHARE of the lanes to rtol 1e-5 / atol 1e-6,
every lane to NOISE_ATOL): the gap left there is rounding, while a wrong
mapping composed into the noise moves nearly every lane.

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu import Options as RefOptions
from pbrt_tpu import samplers as ref_samplers
from pbrt_tpu.core import rng as ref_rng
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.core.lowdiscrepancy import sobol_matrices as ref_sobol_matrices
from pbrt_tpu.core.paramset import ParamSet as RefParamSet
from pbrt_tpu.core.paramset import TextureParams as RefTextureParams
from pbrt_tpu.core.transform import Transform as RefTransform
from pbrt_tpu.scene.builder import build_scene as ref_build_scene
from pbrt_tpu.shapes import make_shape as ref_make_shape
from pbrt_tpu.textures.factories import FACTORIES as REF_FACTORIES

# a general affine object-to-world / texture-to-world transform
M = np.array([[0.8, 0.2, 0.0, 1.0], [0.0, 1.5, 0.1, -2.0], [0.3, 0.0, 0.8, 0.5],
              [0.0, 0.0, 0.0, 1.0]])
# one that float32 applies exactly (powers of two, short offsets)
M_EXACT = np.array([[2.0, 0.0, 0.0, 0.5], [0.0, 0.5, 0.0, -1.0], [0.0, 0.0, 4.0, 0.25],
                    [0.0, 0.0, 0.0, 1.0]])
# noise under M (scripts/noise_rounding.py, 2048 seeded points): fbm leaves 12 lanes past
# rtol 1e-5 / atol 1e-6 (largest gap 3.3e-6) and marble 6 of 6144 (5.3e-6)
NOISE = ("fbm", "wrinkled", "windy", "marble")
NOISE_SHARE = 0.99
NOISE_ATOL = 1e-5
TRI_FIELDS = ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2")


def _write_plys(d):
    """An ASCII PLY (normals, uv, a quad face) and binary PLYs in both byte
    orders (s/t, quads and a pentagon); returns their paths."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    n = rng.normal(size=(6, 3)).astype(np.float32)
    uv = rng.random((6, 2)).astype(np.float32)
    paths = []
    p = d / "ascii.ply"
    faces = [[0, 1, 2], [2, 3, 4, 5], [0, 2, 4]]
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 6\n"
                + "".join(f"property float {c}\n" for c in ("x", "y", "z", "nx", "ny", "nz",
                                                           "u", "v"))
                + "element face 3\nproperty list uchar int vertex_indices\nend_header\n")
        for i in range(6):
            f.write(" ".join(repr(float(x)) for x in (*v[i], *n[i], *uv[i])) + "\n")
        for fc in faces:
            f.write(f"{len(fc)} " + " ".join(map(str, fc)) + "\n")
    paths.append(p)
    for order, ch in (("little", "<"), ("big", ">")):
        for quads in (True, False):
            p = d / f"bin_{order}_{quads}.ply"
            faces = ([[0, 1, 2, 3], [1, 2, 3, 4], [2, 3, 4, 5]] if quads
                     else [[0, 1, 2, 3], [1, 2, 3], [0, 2, 3, 4, 5]])
            with open(p, "wb") as f:
                f.write(f"ply\nformat binary_{order}_endian 1.0\nelement vertex 6\n".encode()
                        + b"".join(f"property float {c}\n".encode() for c in "xyzst")
                        + f"element face {len(faces)}\n".encode()
                        + b"property list uchar int vertex_indices\nend_header\n")
                for i in range(6):
                    f.write(struct.pack(ch + "5f", *v[i], *uv[i]))
                for fc in faces:
                    f.write(struct.pack(ch + "B", len(fc)) + struct.pack(f"{ch}{len(fc)}i", *fc))
            paths.append(p)
    return paths


def _shape_cases(tmp_path):
    """(name, [(kind, param name, values)]) of every newly ported shape."""
    rng = np.random.default_rng(2)
    ico_p = [[0, 0, 1], [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    ico_i = [0, 1, 2, 0, 2, 3, 0, 3, 4, 0, 4, 1, 5, 2, 1, 5, 3, 2, 5, 4, 3, 5, 1, 4]
    ctrl = rng.normal(size=(12, 3))
    w = rng.random(12) + 0.5
    knots = [("int", "nu", [4]), ("int", "nv", [3]), ("int", "uorder", [3]),
             ("int", "vorder", [2]), ("float", "uknots", [0, 0, 0, 0.5, 1, 1, 1]),
             ("float", "vknots", [0, 0, 0.5, 1, 1])]
    cases = [("plymesh", [("string", "filename", [str(p)])]) for p in _write_plys(tmp_path)]
    cases += [
        ("heightfield", [("int", "nu", [7]), ("int", "nv", [5]),
                         ("float", "Pz", rng.random(35).tolist())]),
        ("disk", [("float", "radius", [2.0]), ("float", "innerradius", [0.5]),
                  ("float", "height", [0.3])]),
        ("cylinder", [("float", "phimax", [270.0])]),
        ("cone", [("float", "height", [2.0])]),
        ("paraboloid", [("float", "zmin", [0.2])]),
        ("hyperboloid", [("point3f", "p1", [[0.5, 0, 0]]), ("point3f", "p2", [[1, 0.5, 1]])]),
        ("loopsubdiv", [("int", "nlevels", [2]), ("int", "indices", ico_i),
                        ("point3f", "P", ico_p)]),
        ("nurbs", knots + [("point3f", "P", ctrl)]),
        ("nurbs", knots + [("float", "Pw", np.concatenate(
            [ctrl * w[:, None], w[:, None]], axis=1).ravel().tolist())]),
    ]
    return cases


def _params(ps, items):
    for kind, name, vals in items:
        getattr(ps, f"add_{kind}")(name, vals)
    return ps


INSTANCED = """
LookAt 0 -6 3  0 0 0  0 0 1
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point from" [0 -3 4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -4 0  4 -4 0  4 4 0  -4 4 0]
ObjectBegin "pair"
  Material "matte" "rgb Kd" [0.7 0.2 0.2]
  Shape "disk" "float radius" 0.3
  Translate 0 0 1
  Material "plastic"
  Shape "trianglemesh" "integer indices" [0 1 2]  "point P" [0 0 0  1 0 0  0 1 0]
ObjectEnd
AttributeBegin
  Translate 1.5 0 0
  ObjectInstance "pair"
AttributeEnd
Rotate 40 0 0 1
Scale 0.5 0.5 2
ObjectInstance "pair"
Shape "trianglemesh" "integer indices" [0 1 2]  "point P" [0 0 2  1 0 2  0 1 2]
WorldEnd
"""


def test_shapes_and_instances_match_reference(tmp_path):
    """Every new shape's triangle arrays equal ``pbrt_tpu.shapes``'s (PLY
    in ASCII and both binary byte orders with quads and a pentagon,
    heightfield, the five quadrics, Loop subdivision at 2 levels, a
    non-rational and a rational NURBS patch); a scene with two
    ``ObjectInstance`` uses builds the reference's triangle tables."""
    from test_torch_host import _assert_tables_equal

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.core.paramset import ParamSet
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.scene.builder import build_scene
    from pbrt_tpu_torch.scene.convert import tables_from_numpy
    from pbrt_tpu_torch.shapes import make_shape

    for name, items in _shape_cases(tmp_path):
        want = ref_make_shape(name, _params(RefParamSet(), items), RefTransform(M), True)
        got = make_shape(name, _params(ParamSet(), items), Transform(M), True)
        assert got.count == want.count > 0, name
        for f in TRI_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), (name, f)
            if b is not None:
                assert a.dtype == b.dtype, (name, f)
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")

    ref_api = RefAPI(RefOptions(), render_on_world_end=False)
    ref_api.init()
    ref_api.parse_string(INSTANCED)
    ref = ref_build_scene(ref_api.scene, RefOptions(), 0)
    api = PbrtAPI(Options(), render_on_world_end=False)
    api.init()
    api.parse_string(INSTANCED)
    port = build_scene(api.scene, Options(), 0, device="cpu")
    # the disk: 64 x 2 cells, its 64 degenerate centre triangles dropped
    assert port.tri_data.count == ref.tri_data.count == 2 + 2 * (192 + 1) + 1
    ref_np = {"tri": {k: np.asarray(v) for k, v in ref.tables["tri"].items()},
              "_flags": dict(ref.tables["_flags"])}
    _assert_tables_equal(port.tables, tables_from_numpy(ref_np, "cpu"))
    assert [e.type_id for e in port.materials] == [e.type_id for e in ref.materials]


def test_samplers_sobol_and_pcg32_bit_equal():
    """The six samplers draw the reference's bits on seeded pixels, sample
    indices (bounded by spp, as a render asks, and over all 32 bits) and
    dimensions (the QMC ones and the hashed ones past them); the Sobol'
    table is the reference's; the host PCG32 that draws that table's
    parameters reproduces ``tests/test_rng.py``'s golden vectors and the
    reference's streams."""
    import torch

    from pbrt_tpu_torch import samplers
    from pbrt_tpu_torch.core import lowdiscrepancy, rng
    from pbrt_tpu_torch.core.paramset import ParamSet

    np.testing.assert_array_equal(lowdiscrepancy.sobol_matrices(), ref_sobol_matrices())

    gen = np.random.default_rng(3)
    n = 4096
    pix = gen.integers(-5, 300, (n, 2)).astype(np.int32)
    cases = [("random", {}), ("stratified", {"xsamples": 4, "ysamples": 4}),
             ("stratified", {"xsamples": 3, "ysamples": 5, "jitter": False}),
             ("halton", {}), ("sobol", {}), ("02sequence", {}), ("maxmindist", {})]
    for name, extra in cases:
        # indices below spp, as a render asks, and over all 32 bits; only
        # Halton's digit loop reads the bound
        for idx_hi in ((16, 1 << 32) if name == "halton" else (1 << 32,)):
            ps_ref, ps = RefParamSet(), ParamSet()
            for p in (ps_ref, ps):
                p.add_int("pixelsamples", [16])
                for k, v in extra.items():
                    if isinstance(v, bool):
                        p.add_bool(k, [v])
                    else:
                        p.add_int(k, [v])
            ref = ref_samplers.make_sampler(name, ps_ref, seed=7).bounded(idx_hi)
            port = samplers.make_sampler(name, ps, seed=7).bounded(idx_hi)
            assert type(port).__name__ == type(ref).__name__
            idx = gen.integers(0, idx_hi, n, dtype=np.uint64).astype(np.uint32)
            jp, ji = jnp.asarray(pix), jnp.asarray(idx)
            tp, ti = torch.as_tensor(pix), torch.as_tensor(idx.astype(np.int64))
            for dim in (0, 1, 2, 3, 7, 19, 20, 1030):
                want = np.asarray(ref.get(jp, ji, dim))
                got = port.get(tp, ti, dim).numpy()
                np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                              err_msg=f"{name} {extra} {idx_hi} dim {dim}")

    golden = [355248013, 41705475, 3406281715, 4186697710, 483882979, 2766312848,
              1713261421, 154902030, 3085534493, 3877580365]
    r = rng.Rng()
    assert [r.uniform_u32() for _ in range(10)] == golden
    r = rng.Rng()
    assert [r.uniform_u32_threshold(4095) for _ in range(10)] == [
        2668, 1995, 3385, 2470, 1399, 1118, 3511, 465, 1133, 295]
    assert rng.Rng(0).uniform_u32() == 1774745655
    for seq in [0, 1, 7, 123456, 2**40 + 17, 0x5B01]:
        a, b = rng.Rng(seq), ref_rng.Rng(seq)
        assert [a.uniform_u32() for _ in range(8)] == [b.uniform_u32() for _ in range(8)]


TEXTURES = [  # (kind, spectrum?, exact transform?, [(param kind, name, values)])
    ("scale", True, False, [("texture", "tex1", "checks"), ("float", "tex2", [0.5])]),
    ("mix", True, False, [("texture", "tex1", "checks"), ("rgb_spectrum", "tex2", [0.1, 0.9, 0.3]),
                          ("texture", "amount", "fbm")]),
    ("mix", False, False, [("float", "tex1", [0.2]), ("texture", "tex2", "fbm"),
                           ("float", "amount", [0.3])]),
    ("bilerp", True, False, [("rgb_spectrum", "v00", [1, 0, 0]), ("rgb_spectrum", "v01", [0, 1, 0]),
                             ("rgb_spectrum", "v10", [0, 0, 1]), ("rgb_spectrum", "v11", [1, 1, 1])]),
    ("bilerp", False, False, [("float", "v00", [1]), ("float", "v11", [3]),
                              ("string", "mapping", ["planar"]), ("vector3f", "v1", [[1, 0.5, 0]]),
                              ("vector3f", "v2", [[0, 0.3, 1]]), ("float", "udelta", [0.2]),
                              ("float", "vdelta", [-0.1])]),
    ("uv", True, False, [("string", "mapping", ["cylindrical"])]),
    ("uv", True, False, [("string", "mapping", ["spherical"])]),
    ("uv", True, False, [("float", "uscale", [2.0]), ("float", "vdelta", [0.3])]),
    ("checkerboard", True, False, [("int", "dimension", [3])]),
    ("checkerboard", False, False, [("int", "dimension", [3]), ("float", "tex1", [0.3])]),
    ("dots", True, False, [("rgb_spectrum", "inside", [0.9, 0.1, 0.1]),
                           ("string", "mapping", ["spherical"])]),
    ("dots", False, False, [("float", "inside", [0.7]), ("string", "mapping", ["planar"])]),
    ("dots", True, False, [("float", "uscale", [3.0])]),
    ("fbm", False, True, [("int", "octaves", [5]), ("float", "roughness", [0.6])]),
    ("fbm", False, False, [("int", "octaves", [5]), ("float", "roughness", [0.6])]),
    ("fbm", True, True, []),
    ("wrinkled", False, True, [("int", "octaves", [6])]),
    ("windy", True, True, []),
    ("marble", True, True, [("float", "scale", [2.5]), ("float", "variation", [0.4])]),
    ("marble", True, False, [("float", "scale", [2.5]), ("float", "variation", [0.4])]),
]


def _textures(P, TP, T, factories):
    """Each case of TEXTURES built by one package; children: a 2D
    checkerboard ("checks", uv mapping) and a float fbm ("fbm")."""
    ftex, stex = {}, {}
    ps = _params(P(), [("float", "uscale", [3.0]), ("float", "vscale", [2.0])])
    stex["checks"] = factories["checkerboard"](T(M), TP(ps, ps, ftex, stex), True)
    ps = _params(P(), [("int", "octaves", [4])])
    ftex["fbm"] = factories["fbm"](T(M_EXACT), TP(ps, ps, ftex, stex), False)
    out = []
    for name, spectral, exact, items in TEXTURES:
        ps = P()
        for kind, k, v in items:
            if kind == "texture":
                ps.add_texture(k, v)
            else:
                getattr(ps, f"add_{kind}")(k, v)
        out.append(factories[name](T(M_EXACT if exact else M), TP(ps, ps, ftex, stex), spectral))
    return out


def test_textures_and_mappings_match_reference():
    """scale, mix, bilerp, uv, the 3D checkerboard, dots, fbm, wrinkled,
    windy and marble, under the uv, spherical, cylindrical, planar and 3D
    mappings, on a seeded shading dict: rtol 1e-5, atol 1e-6 of the
    reference under ``jax.jit`` (the noise under the general transform to
    the module's looser bound); value shapes the reference's (a spectrum
    fbm or windy gives [N])."""
    import torch

    from pbrt_tpu_torch.core.paramset import ParamSet, TextureParams
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.textures.factories import FACTORIES

    gen = np.random.default_rng(5)
    p = (gen.normal(size=(2048, 3)) * 3).astype(np.float32)
    uv = (gen.random((2048, 2)) * 4 - 1).astype(np.float32)
    refs = _textures(RefParamSet, RefTextureParams, RefTransform, REF_FACTORIES)
    ports = _textures(ParamSet, TextureParams, Transform, FACTORIES)
    si_ref = {"p": jnp.asarray(p), "uv": jnp.asarray(uv)}
    si = {"p": torch.as_tensor(p), "uv": torch.as_tensor(uv)}
    wants = jax.jit(lambda si: [ref.eval(si) for ref in refs])(si_ref)
    for (name, spectral, exact, items), want, port in zip(TEXTURES, wants, ports):
        want = np.asarray(want)
        got = port.eval(si).numpy()
        assert got.shape == want.shape, (name, items)
        if name in NOISE and not exact:
            close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
            assert close.mean() >= NOISE_SHARE, (name, items, close.mean())
            np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_ATOL, err_msg=f"{name} {items}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{name} {items}")
