"""The port's renderer against ``pbrt_tpu_torch/refrender.py``, the
port's own copy of the independent scalar numpy path tracer (its second
yardstick), on ``tests/test_refrender.py``'s scenes: the GI box, the
mirror sphere, the check-sphere acceptance scene and the glass sphere,
at that file's sizes and with its matched sample stream (the renderer's
sampler, ``bounded(spp).get``, tabulated per lane and dimension).

Each scene renders in float32 (the default policy) and in float64
(``Options(double=True)``); the scalar tracer works in float64 either
way.  The float32 images meet ``tests/test_refrender.py``'s bounds
(``_compare``: fewer than 3% of pixels off by more than 0.02, image means
within 5e-3, for the box and the mirror; ``_compare_tight``: fewer than
1%, for the others).  The float64 images meet tighter bounds, set from
what they measure (``DOUBLE_BOUNDS``), and no more of their pixels are
off by more than 2e-6 than of the float32 images.  Measured on the CPU
(pixels off by more than 0.02 / |mean difference| / pixels off by more
than 2e-6, float32 then float64): the box 0.39% / 3.2e-4 / 7.0% both
(its edge pixels, where a decision differs whatever the precision); the
mirror 0 / 1.3e-7 / 0 and 0 / 8.9e-8 / 0; the check sphere 0 / 5.1e-8 /
2.0% and 0 / 3.4e-8 / 0; the glass 0 / 4.7e-8 / 0.1% and 0 / 4.8e-8 /
0.  The floor of ~4e-7 on every pixel of both is the
film's RGB -> XYZ -> RGB round trip (pbrt's six-digit matrices are
inverses to ~1e-6), which the scalar tracer does not take.

The GI box also holds the copy to the reference's ``pbrt_tpu/refrender.py``:
the two give the same image, bit for bit, on the same sample table.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import numpy as np
import pytest

from tests.test_refrender import (CHECK_SPHERE_TEXT, DEPTH, GI_BOX_TEXT, GLASS_TEXT,
                                  MIRROR_TEXT, SPP, XRES, _gi_box_ref)

CHECK = dict(res=64, spp=2, depth=5)
GLASS = dict(res=32, spp=4, depth=5)

# (share of pixels off by more than 0.02, |mean difference|, share of
# pixels off by more than 2e-6) allowed of the float64 images
DOUBLE_BOUNDS = {
    "gi_box": (0.01, 1e-3, 0.08),
    "mirror": (0.005, 1e-6, 0.01),
    "check_sphere": (0.005, 1e-6, 0.01),
    "glass": (0.005, 1e-6, 0.01),
}


def _quad(p):
    p = [np.asarray(q, np.float64) for q in p]
    return [(p[0], p[1], p[2]), (p[0], p[2], p[3])]


def _scene(name, float_t):
    """(scene text, camera (eye, look, up, fov), res, spp, depth, the
    scalar tracer's RefScene arguments) of ``tests/test_refrender.py``'s
    scene ``name``."""
    from pbrt_tpu_torch.core import spectrum
    from pbrt_tpu_torch.testscenes import ref_gi_box

    if name == "gi_box":
        text, args, camera = ref_gi_box(XRES, XRES, SPP, DEPTH)
        assert text == GI_BOX_TEXT  # the port's copy of tests/test_refrender.py's box
        return text, camera, XRES, SPP, DEPTH, args
    if name == "mirror":
        floor = _quad([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]])
        args = ([([0, 1, 0], 0.6, 0)], [(a, b, c, 1, -1) for a, b, c in floor],
                [{"type": "mirror", "kr": [0.85, 0.85, 0.85]},
                 {"type": "matte", "kd": [0.6, 0.6, 0.6]}],
                [{"type": "infinite", "L": [0.3, 0.4, 0.5]},
                 {"type": "point", "p": [1.5, 2.5, 1.5], "I": [8, 8, 8]}])
        return MIRROR_TEXT, ([0, 1, 3.2], [0, 1, 0], [0, 1, 0], 60.0), XRES, SPP, DEPTH, args
    if name == "check_sphere":
        # the blackbody enters as the port's conversion in the policy's float
        # (tests/test_refrender.py holds the conversion itself)
        sun = np.asarray(spectrum.blackbody_to_rgb(3000.0, 1.5, float_t), np.float64)
        uv = [np.array(v, np.float64) for v in ([0, 0], [1, 0], [1, 1], [0, 1])]
        pq = [np.array(v, np.float64) for v in ([-20, -20, -1], [20, -20, -1], [20, 20, -1],
                                                [-20, 20, -1])]
        args = ([([0, 0, 0], 1.0, 0)],
                [(pq[0], pq[1], pq[2], 1, -1, uv[0], uv[1], uv[2]),
                 (pq[0], pq[2], pq[3], 1, -1, uv[0], uv[2], uv[3])],
                [{"type": "mirror", "kr": [0.9, 0.9, 0.9]},
                 {"type": "matte", "checker": {"su": 8.0, "sv": 8.0, "tex1": [0.1, 0.1, 0.1],
                                               "tex2": [0.8, 0.8, 0.8]}}],
                [{"type": "infinite", "L": [0.4, 0.45, 0.5]},
                 {"type": "distant", "dir": [-30.0, 40.0, 99.0], "L": sun}])
        return (CHECK_SPHERE_TEXT, ([3, 4, 1.5], [0.5, 0.5, 0], [0, 0, 1], 45.0),
                CHECK["res"], CHECK["spp"], CHECK["depth"], args)
    floor = _quad([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]])
    args = ([([0, 0.8, 0], 0.5, 0)], [(a, b, c, 1, -1) for a, b, c in floor],
            [{"type": "glass", "kr": [1, 1, 1], "kt": [1, 1, 1], "eta": 1.5},
             {"type": "matte", "kd": [0.55, 0.5, 0.45]}],
            [{"type": "infinite", "L": [0.3, 0.35, 0.4]},
             {"type": "point", "p": [2, 3, 2], "I": [10, 10, 10]}])
    return (GLASS_TEXT, ([0, 1.2, 3.0], [0, 0.6, 0], [0, 1, 0], 55.0), GLASS["res"],
            GLASS["spp"], GLASS["depth"], args)


def _device_render(text, res, spp, double):
    """The port's image of ``text`` on the CPU and its renderer."""
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    api = PbrtAPI(Options(ray_batch=res * res * spp, double=double),
                  render_on_world_end=False, device="cpu")
    api.init()
    api.parse_string(text)
    r = Renderer(api.scene, api.opt, device="cpu")
    return r.image(r.render(spp=spp, progress=False)), r


def _measure(dev, ref):
    """(share of pixels off by more than 0.02, |mean difference|, share of
    pixels off by more than 2e-6)."""
    assert np.isfinite(dev).all() and np.isfinite(ref).all() and ref.max() > 0.01
    off = np.abs(dev - ref).max(axis=-1)
    return (float((off > 0.02).mean()), abs(float(dev.mean() - ref.mean())),
            float((off > 2e-6).mean()))


@pytest.mark.parametrize("name", ["gi_box", "mirror", "check_sphere", "glass"])
def test_renderer_against_scalar_yardstick(name):
    from pbrt_tpu_torch.refrender import RefScene, look_at, render_reference
    from pbrt_tpu_torch.testscenes import sample_table

    off = {}
    for double in (False, True):
        float_t = np.float64 if double else np.float32
        text, (eye, look, up, fov), res, spp, depth, args = _scene(name, float_t)
        dev, r = _device_render(text, res, spp, double)
        assert dev.dtype == float_t
        table = sample_table(r, res, res, spp, 5 + 7 * depth)
        c2w = look_at(eye, look, up)
        ref = render_reference(RefScene(*args), c2w, fov, res, res, spp, depth, table)
        off[double] = _measure(dev, ref)
        if name == "gi_box" and not double:
            from pbrt_tpu.refrender import RefScene as JaxPkgRefScene
            from pbrt_tpu.refrender import render_reference as jax_pkg_render

            # the copy: the reference's tracer on its own scene gives the
            # same image, bit for bit
            same = jax_pkg_render(_gi_box_ref(), c2w, fov, res, res, spp, depth, table)
            assert isinstance(_gi_box_ref(), JaxPkgRefScene)
            np.testing.assert_array_equal(ref, same)
    print(f"{name}: float32 {off[False]}, float64 {off[True]} (pixels off by > 0.02, "
          "|mean difference|, pixels off by > 2e-6)")
    f32_bad = 0.03 if name in ("gi_box", "mirror") else 0.01
    assert off[False][0] < f32_bad and off[False][1] < 5e-3
    bad, mean, fine = DOUBLE_BOUNDS[name]
    assert bad <= f32_bad and mean <= 5e-3
    assert off[True][0] < bad and off[True][1] < mean and off[True][2] < fine
    assert off[True][2] <= off[False][2]
