"""Curves and the hair BSDF in pbrt_tpu_torch against the JAX reference.

- ``Shape "curve"`` (Bezier and B-spline, degree 2 and 3; cylinder,
  ribbon and flat) tessellates to the reference's ``TriangleData`` bit
  for bit (positions, normals, uv, tangents: the port's ``shapes/curve.py``
  is a numpy copy), and a scene of curves beside a plain mesh packs its
  triangle table, tangent columns included, byte-equal to the
  reference's (non-curve triangles carry zero tangents).
- ``hair_f``, ``hair_pdf`` and ``hair_sample_wi`` on 20,000 seeded lanes in
  the three pigment modes (sigma_a, color, melanin; the parameters come
  from each package's ``eval_material_params``) against the reference
  under ``jax.jit``: f and pdf within rtol 1e-4 (atol 1e-6 of the
  largest value) on every lane; sampled directions within 1e-4 on
  >= 99.9% of lanes (the reference's compiled arcsin, atan2 and exp are
  XLA's own polynomials, one ulp from torch's on ~30% of inputs, and a
  lobe choice may flip on a last bit).  ``demux_float``: bit-equal.
  Non-hair lanes stay finite.
- A 16x16 fur ball of 16 curves (1,536 curve triangles: the whole-tree
  walk) under one ``Material "hair"`` directive against the reference's
  image, to the image tolerance of the other scene tests (image-mean
  relative difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol
  1e-4); the curves keep an index each in the material table and share
  one entry.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.materials import eval_material_params as ref_eval_material_params
from pbrt_tpu.materials import hair as ref_hair
from pbrt_tpu.render import render_scene as ref_render_scene
from pbrt_tpu.scene.builder import _tri_cols as ref_tri_cols
from pbrt_tpu.scene.builder import build_scene as ref_build_scene

CURVES = [  # (type, basis, degree, control points, extra parameters)
    ("cylinder", "bezier", 3, 7, ""),
    ("flat", "bezier", 2, 5, '"float width0" 0.05 "float width1" 0.01'),
    ("ribbon", "bezier", 3, 4, '"normal N" [0 0 1  0.3 0 1]'),
    ("cylinder", "bspline", 3, 6, '"integer tessellation" 5 "integer tessellation_v" 4'),
    ("ribbon", "bspline", 2, 5, '"normal N" [0 0 1  0 1 1  1 0 1  0 0 1]'),
    ("flat", "bspline", 2, 4, '"float width" 0.04'),
]
PIGMENTS = ('"rgb sigma_a" [0.8 1.2 2.1]', '"rgb color" [0.6 0.35 0.2]',
            '"float eumelanin" 0.8 "float pheomelanin" 0.4')


def _points(n, seed):
    rs = np.random.default_rng(seed)
    return np.cumsum(rs.uniform(-0.4, 0.6, size=(n, 3)), axis=0)


def _curve_scene(with_mesh=True):
    lines = ['LookAt 0 -5 1  0 0 0  0 0 1', 'Camera "perspective" "float fov" 45',
             'Film "image" "integer xresolution" [8] "integer yresolution" [8]', "WorldBegin"]
    if with_mesh:
        lines.append('Shape "trianglemesh" "integer indices" [0 1 2] '
                     '"point P" [-1 -1 0  1 -1 0  0 1 0]')
    for k, (ctype, basis, degree, n, extra) in enumerate(CURVES):
        pts = " ".join(f"{v:.6f}" for v in _points(n, k).reshape(-1))
        lines += ["AttributeBegin", f"Rotate {20 * k} 0 1 0",
                  f'Shape "curve" "string type" "{ctype}" "string basis" "{basis}" '
                  f'"integer degree" {degree} "point P" [{pts}] {extra}', "AttributeEnd"]
    return "\n".join(lines + ["WorldEnd"])


def _descs(text):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI

    ref = RefAPI(RefOptions(), render_on_world_end=False)
    port = PbrtAPI(Options(), render_on_world_end=False, device="cpu")
    for api in (ref, port):
        api.init()
        api.parse_string(text)
    return ref.scene, port.scene


def test_curves_tessellate_and_pack_like_reference():
    import torch

    from pbrt_tpu_torch.scene.builder import _tri_cols, build_scene
    from pbrt_tpu_torch.shapes import TriangleData
    from pbrt_tpu_torch.shapes.curve import make_curve

    # each curve alone, through make_curve with the parsed parameters
    ref_desc, port_desc = _descs(_curve_scene(with_mesh=False))
    from pbrt_tpu.shapes.curve import make_curve as ref_make_curve

    fields = [f for f in TriangleData.__dataclass_fields__]
    assert {"tan0", "tan1", "tan2"} <= set(fields)
    for rrec, prec in zip(ref_desc.shapes, port_desc.shapes, strict=True):
        want = ref_make_curve(rrec.params, rrec.object_to_world, rrec.reverse_orientation)
        got = make_curve(prec.params, prec.object_to_world, prec.reverse_orientation)
        assert got.count == want.count > 0
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)

    # the scene's tables and packed rows, a plain triangle beside the curves
    ref_desc, port_desc = _descs(_curve_scene())
    ref = ref_build_scene(ref_desc, RefOptions())
    port = build_scene(port_desc, None, device="cpu")
    tr_ref = {k: np.asarray(v) for k, v in ref.tables["tri"].items()}
    tr_port = port.tables["tri"]
    assert set(tr_port) == set(tr_ref) and "tan0" in tr_port
    for k, v in tr_ref.items():
        np.testing.assert_array_equal(tr_port[k].numpy(), v, err_msg=k)
    assert not tr_port["tan0"][0].any()  # the plain triangle: no tangent
    for normals, uv in ((True, True), (False, False)):
        want, want_lay = ref_tri_cols(ref.tables["tri"], normals, uv)
        got, got_lay = _tri_cols(tr_port, normals, uv)
        assert got_lay == want_lay and "tan2" in got_lay
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert torch.is_tensor(got)


def test_hair_bsdf_matches_reference():
    import torch

    from pbrt_tpu_torch.materials import bsdf as B
    from pbrt_tpu_torch.materials import eval_material_params
    from pbrt_tpu_torch.materials.hair import demux_float, hair_f, hair_pdf, hair_sample_wi
    from pbrt_tpu_torch.scene.builder import build_scene

    mats = [f'Material "hair" {p} "float beta_m" {0.2 + 0.2 * k} "float beta_n" '
            f'{0.5 - 0.1 * k} "float alpha" {1 + k}' for k, p in enumerate(PIGMENTS)]
    body = "\n".join(f'{m}\nShape "sphere" "float radius" {k + 1}'
                     for k, m in enumerate(['Material "matte"'] + mats))
    ref_desc, port_desc = _descs(f'Film "image" "integer xresolution" [4] '
                                 f'"integer yresolution" [4]\nWorldBegin\n{body}\nWorldEnd')
    ref = ref_build_scene(ref_desc, RefOptions())
    port = build_scene(port_desc, None, device="cpu")
    assert [e.hair_mode for e in port.materials] == ["", "sigma_a", "color", "melanin"]

    n = 20000
    rs = np.random.default_rng(5)

    def dirs(m):
        w = rs.normal(size=(m, 3))
        return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)

    wo, wi = dirs(n), dirs(n)
    wo[:, 2] = np.abs(wo[:, 2])
    u_lobe = rs.random(n, dtype=np.float32)
    u2 = rs.random((n, 2), dtype=np.float32)
    mat_id = rs.integers(-1, 4, n).astype(np.int32)
    uv = rs.random((n, 2), dtype=np.float32)
    si_ref = {"p": jnp.zeros((n, 3)), "uv": jnp.asarray(uv)}
    si = {"p": torch.zeros((n, 3)), "uv": torch.as_tensor(uv)}
    p_ref = ref_eval_material_params(ref.materials, jnp.asarray(mat_id), si_ref)
    params = eval_material_params(port.materials, torch.as_tensor(mat_id), si)
    for k in ("sigma_a", "beta_m", "beta_n", "hair_alpha", "eta", "type"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(p_ref[k]), rtol=1e-6,
                                   err_msg=k)
    hair = mat_id >= 1
    p_ref = {k: v for k, v in p_ref.items() if k != "_active"}  # static: not a jit argument
    args = (jnp.asarray(wo), jnp.asarray(wi))
    targs = (torch.as_tensor(wo), torch.as_tensor(wi))
    for fn, ref_fn in ((hair_f, ref_hair.hair_f), (hair_pdf, ref_hair.hair_pdf)):
        want = np.asarray(jax.jit(ref_fn)(p_ref, *args))
        got = fn(params, *targs).numpy()
        assert np.isfinite(got).all(), fn.__name__  # every lane, hair or not
        got, want = got[hair], want[hair]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=fn.__name__)
    want = np.asarray(jax.jit(ref_hair.hair_sample_wi)(p_ref, jnp.asarray(wo),
                                                       jnp.asarray(u_lobe), jnp.asarray(u2)))
    got = hair_sample_wi(params, torch.as_tensor(wo), torch.as_tensor(u_lobe),
                         torch.as_tensor(u2)).numpy()
    assert np.isfinite(got).all()
    far = np.abs(got - want).max(axis=-1)[hair] > 1e-4
    assert far.mean() <= 1e-3, far.mean()
    # the dispatch: bsdf_eval on hair lanes is hair_f
    f = B.bsdf_eval(params, *targs).numpy()
    np.testing.assert_array_equal(f[hair], hair_f(params, *targs).numpy()[hair])

    u = np.concatenate([rs.random(100000, dtype=np.float32),
                        np.array([0.0, 0.5, 0.99999994, 1.0], np.float32)])
    want = [np.asarray(x) for x in jax.jit(ref_hair.demux_float)(jnp.asarray(u))]
    got = [x.numpy() for x in demux_float(torch.as_tensor(u))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_fur_ball_renders_like_reference():
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import render_scene
    from pbrt_tpu_torch.testscenes import fur_text

    text = fur_text(16, xres=16, yres=16, spp=2, maxdepth=4)
    api = RefAPI(RefOptions(ray_batch=4096), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    want = np.asarray(ref_render_scene(api.scene, api.opt, write=False)["image"])
    api = PbrtAPI(Options(ray_batch=4096), render_on_world_end=False, device="cpu")
    api.init()
    api.parse_string(text)
    out = render_scene(api.scene, api.opt, write=False, device="cpu")
    got = out["image"]
    assert int((np.abs(out["renderer"].compiled.tri_data.tan0).sum(-1) > 0).sum()) == 16 * 96
    # an index per shape, as the reference numbers them, and one entry for
    # the 16 curves of the one Material directive
    mats = out["renderer"].compiled.materials
    assert len(mats) == 3 + 16 and len({id(e) for e in mats}) == 4
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close


SHARED = """Film "image" "integer xresolution" [4] "integer yresolution" [4]
WorldBegin
Material "matte" "rgb Kd" [0.5 0.2 0.1]
Shape "sphere" "float radius" 1
Shape "sphere" "float radius" 2
Texture "c" "spectrum" "constant" "rgb value" [0.1 0.6 0.3]
Shape "sphere" "float radius" 3
AttributeBegin
  Material "plastic" "texture Kd" "c"
  Shape "sphere" "float radius" 4
  Shape "sphere" "float radius" 5
AttributeEnd
Shape "sphere" "float radius" 6
Material "hair" "float eumelanin" 0.5
Shape "sphere" "float radius" 7
Shape "sphere" "float radius" 8
WorldEnd
"""


def test_one_material_directive_makes_one_entry():
    import torch

    from pbrt_tpu_torch.materials import eval_material_params
    from pbrt_tpu_torch.scene.builder import build_scene

    # the shapes after one Material directive share an entry; a new
    # texture or Material starts another, and AttributeEnd restores the
    # one before; the indices and every lane's parameters are the
    # reference's, which makes an entry per shape
    ref_desc, port_desc = _descs(SHARED)
    ref = ref_build_scene(ref_desc, RefOptions())
    port = build_scene(port_desc, None, device="cpu")
    assert [e.type_id for e in port.materials] == [e.type_id for e in ref.materials]
    assert len(port.materials) == 8
    first = {}
    assert [first.setdefault(id(e), len(first)) for e in port.materials] == [
        0, 0, 1, 2, 2, 1, 3, 3]
    n = 4096
    rs = np.random.default_rng(9)
    mat_id = rs.integers(-1, 8, n).astype(np.int32)
    uv = rs.random((n, 2), dtype=np.float32)
    want = ref_eval_material_params(ref.materials, jnp.asarray(mat_id),
                                    {"p": jnp.zeros((n, 3)), "uv": jnp.asarray(uv)})
    got = eval_material_params(port.materials, torch.as_tensor(mat_id),
                               {"p": torch.zeros((n, 3)), "uv": torch.as_tensor(uv)})
    assert got["_active"] == want["_active"]
    for k, v in want.items():
        if k != "_active":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
