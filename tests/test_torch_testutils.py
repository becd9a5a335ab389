"""``pbrt_tpu_torch/core/testutils.py`` against ``pbrt_tpu/core/testutils.py``:
the port's ``MockAPI`` records, through the port's parser, the call
sequence the reference's ``MockAPI`` records through the reference's
parser (parameter sets compared by name, kind and values, under either
float policy), and every ``make_*_param_set`` helper round-trips its
values through ``ParamSet.find_*``.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import numpy as np
import pytest

SCENE = """
LookAt 0 1 3.2  0 1 0  0 1 0
Camera "perspective" "float fov" 60
Sampler "halton" "integer pixelsamples" 4
Film "image" "integer xresolution" [16] "integer yresolution" [16]
  "string filename" "out.pfm"
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [6 6 6]
  Translate 0 0.5 0
  Rotate 30 0 1 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -0.5 2.49 -0.5   0.5 2.49 -0.5   0.5 2.49 0.5   -0.5 2.49 0.5 ]
AttributeEnd
Texture "checks" "spectrum" "checkerboard" "float uscale" [8] "rgb tex1" [.1 .1 .1]
Material "matte" "texture Kd" "checks" "bool flag" "true" "blackbody L" [3000 1.5]
MakeNamedMedium "fog" "string type" "homogeneous" "xyz sigma_s" [0.1 0.2 0.3]
Shape "sphere" "float radius" 0.6 "normal N" [0 0 1] "point2 uv" [0.25 0.75]
WorldEnd
"""


def _plain(x):
    """A call argument in a form both packages share: parameter sets as
    sorted (name, kind, values) tuples, every float a Python float."""
    if hasattr(x, "_items"):
        return tuple(sorted((k, it.kind, _plain(np.asarray(it.values, dtype=object).ravel()
                                                .tolist()))
                            for k, it in x._items.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    return x


def _close(a, b):
    """Equal structure; floats within rtol 1e-6 (float32's rounding)."""
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_close(x, y) for x, y in zip(a, b)))
    if isinstance(a, float):
        return isinstance(b, float) and bool(np.isclose(a, b, rtol=1e-6, atol=0.0))
    return a == b


@pytest.mark.parametrize("double", [False, True])
def test_mock_api_records_the_reference_call_sequence(double):
    from pbrt_tpu.core import parser as ref_parser
    from pbrt_tpu.core.testutils import MockAPI as RefMockAPI
    from pbrt_tpu_torch import float_type
    from pbrt_tpu_torch.core import parser
    from pbrt_tpu_torch.core.testutils import MockAPI

    ref, port = RefMockAPI(), MockAPI(float_type(double))
    ref_parser.parse(ref_parser.create_from_string(SCENE), ref)
    parser.parse(parser.create_from_string(SCENE), port)
    assert [c[0] for c in port.calls] == [c[0] for c in ref.calls]
    assert len(port.calls) > 15
    for (name, got), (_, want) in zip(port.calls, ref.calls):
        for g in got:
            if hasattr(g, "_items"):
                assert g.float_t is float_type(double), name
        if not double:
            assert _plain(got) == _plain(want), name
            continue
        # the reference parses in float32 in this process: the double
        # values round to its values, but for spectra (blackbody, xyz)
        # that the port converts in float64 and the reference in float32
        assert _close(_plain(got), _plain(want)), name


def test_make_param_set_helpers_round_trip():
    from pbrt_tpu_torch.core import testutils as T

    cases = [
        ("bool", [True, False], lambda ps, n: ps.find_bool(n)),
        ("float", [1.5, -2.25], lambda ps, n: ps.find_float(n)),
        ("int", [3, -4, 5], lambda ps, n: ps.find_int(n)),
        ("point2f", [0.5, 1.5, 2.5, 3.5], lambda ps, n: ps.find_point2f(n)),
        ("vector2f", [1.0, -1.0], lambda ps, n: ps.find_vector2f(n)),
        ("point3f", [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], lambda ps, n: ps.find_point3f(n)),
        ("vector3f", [0.0, 1.0, 0.0], lambda ps, n: ps.find_vector3f(n)),
        ("normal3f", [0.0, 0.0, 1.0], lambda ps, n: ps.find_normal3f(n)),
        ("string", ["a", "b"], lambda ps, n: ps.find_string(n)),
        ("rgb_spectrum", [0.25, 0.5, 0.75], lambda ps, n: ps.find_spectrum(n)),
    ]
    for float_t in (np.float32, np.float64):
        for kind, values, find in cases:
            ps = getattr(T, f"make_{kind}_param_set")("x", values, float_t)
            assert ps.float_t is float_t
            got = find(ps, "x")
            assert got is not None, kind
            flat = np.asarray(got).ravel().tolist() if kind != "string" else list(got)
            assert flat == list(values), (kind, flat)
            if kind in ("float", "point2f", "vector2f", "point3f", "vector3f", "normal3f",
                        "rgb_spectrum"):
                assert np.asarray(got).dtype == float_t, kind
        tex = T.make_texture_param_set("Kd", "checks", float_t)
        assert tex.find_one_texture("Kd", "") == "checks"
        assert not tex.report_unused()
