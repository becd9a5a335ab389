"""pbrt_tpu_torch's directlighting, whitted and ao integrators against the
JAX reference on the CPU, on ``tests/test_direct.py``'s scenes (their
text copied here): a closed diffuse box under a ceiling area light, and a
mirror sphere over a diffuse floor under a point light.

Both packages draw the same samples through the same scenes, so the
images agree up to float rounding.  Gate (``tests/test_torch_cornell.py``'s):
image-mean relative difference <= 1e-3 and >= 99% of pixels within rtol
1e-3, atol 1e-4; the query counters exact (directlighting traces maxdepth
+ 1 segments, the last gathering emission only; ao one camera sweep and
``nsamples`` occlusion sweeps).

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting.
"""

import numpy as np

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.render import render_scene as ref_render_scene

HEAD = """
LookAt 0 1 4  0 1 0  0 1 0
Camera "perspective" "float fov" 60
Sampler "halton" "integer pixelsamples" 16
Integrator "{integ}" {extra}
Film "image" "integer xresolution" [20] "integer yresolution" [20]
WorldBegin
"""

# closed high-albedo GI box lit by a ceiling area light
DIFFUSE_BOX = HEAD + """
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -0.5 2.49 -0.5   0.5 2.49 -0.5   0.5 2.49 0.5   -0.5 2.49 0.5 ]
AttributeEnd
Material "matte" "rgb Kd" [0.9 0.9 0.9]
# floor
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 0 2.5   -2.5 0 2.5 ]
# ceiling
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 2.5 -2.5   2.5 2.5 -2.5   2.5 2.5 2.5   -2.5 2.5 2.5 ]
# back wall
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 2.5 -2.5   -2.5 2.5 -2.5 ]
# left / right walls
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   -2.5 0 2.5   -2.5 2.5 2.5   -2.5 2.5 -2.5 ]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ 2.5 0 -2.5   2.5 0 2.5   2.5 2.5 2.5   2.5 2.5 -2.5 ]
WorldEnd
"""

# mirror sphere over a diffuse floor, delta (point) light only
MIRROR_POINT = HEAD + """
LightSource "point" "rgb I" [20 20 20] "point from" [0 2.2 1]
Material "mirror" "rgb Kr" [0.9 0.9 0.9]
AttributeBegin
  Translate 0 1 0
  Shape "sphere" "float radius" 0.6
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -2.5 0 -2.5   2.5 0 -2.5   2.5 0 2.5   -2.5 0 2.5 ]
WorldEnd
"""


def _check(integ, scene, queries, extra='"integer maxdepth" 5'):
    """The port's image of ``scene`` under ``integ`` against the
    reference's; ``queries``: (closest, shadow) per camera sample."""
    from pbrt_tpu_torch.testscenes import text_renderer

    text = scene.format(integ=integ, extra=extra)
    api = RefAPI(RefOptions(ray_batch=20 * 20 * 16), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    want = np.asarray(ref_render_scene(api.scene, api.opt, seed=0, write=False)["image"])
    port = text_renderer(text, 20 * 20 * 16, device="cpu")
    got = port.image(port.render())
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.max() > 0
    lanes = 20 * 20 * 16
    assert port.integrator.queries_per_sample() == queries
    assert port.counters["closest_queries"] == lanes * queries[0]
    assert port.counters["shadow_queries"] == lanes * queries[1]
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    print(f"{integ}: mean {got.mean():.6f} (reference {want.mean():.6f}), rel diff "
          f"{rel_mean:.3e}; {close.mean():.4f} of pixels close")
    assert rel_mean <= 1e-3
    assert close.mean() >= 0.99
    return got


def test_directlighting_matches_reference():
    """The diffuse box (area light: both MIS halves, the BSDF half in the
    emission-only segment) and the mirror sphere (specular recursion to
    maxdepth, a delta light)."""
    box = _check("directlighting", DIFFUSE_BOX, (6, 5))
    mirror = _check("directlighting", MIRROR_POINT, (6, 5))
    assert box.mean() > 0 and mirror.mean() > 0


def test_whitted_matches_reference():
    """The mirror sphere: light sampling only and specular recursion; and
    the box, where no light sample has MIS."""
    _check("whitted", MIRROR_POINT, (5, 4))
    _check("whitted", DIFFUSE_BOX, (5, 4))


def test_ao_matches_reference():
    """The mirror scene with 2 occlusion rays per camera ray (the floor
    darkens under the sphere; the background stays 1) and the closed box
    (mostly occluded)."""
    img = _check("ao", MIRROR_POINT, (1, 2), extra='"integer nsamples" 2')
    assert abs(img.max() - 1.0) < 1e-5 and img.min() < 0.9
    _check("ao", DIFFUSE_BOX, (1, 1), extra="")
