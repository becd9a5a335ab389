"""ParamSet construction helpers for tests (counterpart of
``pbrt_tpu/core/testutils.py``) on the port's ``core/paramset.ParamSet``.

One ``make_<type>_param_set`` per value kind, each a one-parameter
ParamSet in the policy's float ``float_t`` (float32 unless given), and
``MockAPI``, which records every API call the parser makes, so parser
tests need no renderer.
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core.paramset import ParamSet


def _make(adder_name, name, values, float_t=np.float32):
    ps = ParamSet(float_t)
    getattr(ps, adder_name)(name, values)
    return ps


def make_bool_param_set(name, values, float_t=np.float32):
    return _make("add_bool", name, values, float_t)


def make_float_param_set(name, values, float_t=np.float32):
    return _make("add_float", name, values, float_t)


def make_int_param_set(name, values, float_t=np.float32):
    return _make("add_int", name, values, float_t)


def make_point2f_param_set(name, values, float_t=np.float32):
    return _make("add_point2f", name, values, float_t)


def make_vector2f_param_set(name, values, float_t=np.float32):
    return _make("add_vector2f", name, values, float_t)


def make_point3f_param_set(name, values, float_t=np.float32):
    return _make("add_point3f", name, values, float_t)


def make_vector3f_param_set(name, values, float_t=np.float32):
    return _make("add_vector3f", name, values, float_t)


def make_normal3f_param_set(name, values, float_t=np.float32):
    return _make("add_normal3f", name, values, float_t)


def make_string_param_set(name, values, float_t=np.float32):
    return _make("add_string", name, values, float_t)


def make_texture_param_set(name, value, float_t=np.float32):
    return _make("add_texture", name, value, float_t)


def make_rgb_spectrum_param_set(name, values, float_t=np.float32):
    return _make("add_rgb_spectrum", name, values, float_t)


class MockAPI:
    """Records every API callback as (name, args), as the reference's
    MockAPI does; ``float_t`` is the float of the ParamSets the parser
    hands it (``core/parser.parse`` reads it from the API)."""

    def __init__(self, float_t=np.float32):
        self.float_t = float_t
        self.calls = []

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))

        return record
