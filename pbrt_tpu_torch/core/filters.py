"""Reconstruction filters (host; counterpart of ``pbrt_tpu/core/filters.py``).

Box, triangle, gaussian, mitchell and sinc (Lanczos), with pbrt-v3's
parameter defaults.  Filters are evaluated on the host only, to build the
16x16 weight table the film reads.
"""

from __future__ import annotations

import math

import numpy as np

FILTER_TABLE_WIDTH = 16


class Filter:
    """Base: radius (rx, ry); evaluate(x, y) vectorized on host numpy."""

    def __init__(self, radius):
        self.radius = (float(radius[0]), float(radius[1]))
        self.inv_radius = (1.0 / self.radius[0], 1.0 / self.radius[1])

    def evaluate(self, x, y):
        raise NotImplementedError

    def table(self, width: int = FILTER_TABLE_WIDTH, float_t=np.float32) -> np.ndarray:
        """[width, width] weights in ``float_t`` at the positive quadrant's
        cell centers (row y, column x)."""
        xs = (np.arange(width) + 0.5) * self.radius[0] / width
        ys = (np.arange(width) + 0.5) * self.radius[1] / width
        gx, gy = np.meshgrid(xs, ys)
        return self.evaluate(gx, gy).astype(float_t)


class BoxFilter(Filter):
    """Weight 1 everywhere inside the radius."""

    def evaluate(self, x, y):
        return np.ones_like(np.asarray(x, dtype=np.float64))


class TriangleFilter(Filter):
    def evaluate(self, x, y):
        rx, ry = self.radius
        return np.maximum(0.0, rx - np.abs(x)) * np.maximum(0.0, ry - np.abs(y))


class GaussianFilter(Filter):
    def __init__(self, radius, alpha=2.0):
        super().__init__(radius)
        self.alpha = float(alpha)
        self.exp_x = math.exp(-self.alpha * self.radius[0] ** 2)
        self.exp_y = math.exp(-self.alpha * self.radius[1] ** 2)

    def _g(self, d, expv):
        return np.maximum(0.0, np.exp(-self.alpha * d * d) - expv)

    def evaluate(self, x, y):
        return self._g(x, self.exp_x) * self._g(y, self.exp_y)


class MitchellFilter(Filter):
    def __init__(self, radius, b=1.0 / 3.0, c=1.0 / 3.0):
        super().__init__(radius)
        self.b, self.c = float(b), float(c)

    def _m(self, x):
        x = np.abs(2.0 * x)
        b, c = self.b, self.c
        big = (
            (-b - 6 * c) * x**3
            + (6 * b + 30 * c) * x**2
            + (-12 * b - 48 * c) * x
            + (8 * b + 24 * c)
        ) * (1.0 / 6.0)
        small = (
            (12 - 9 * b - 6 * c) * x**3
            + (-18 + 12 * b + 6 * c) * x**2
            + (6 - 2 * b)
        ) * (1.0 / 6.0)
        return np.where(x > 1, np.where(x < 2, big, 0.0), small)

    def evaluate(self, x, y):
        return self._m(x * self.inv_radius[0]) * self._m(y * self.inv_radius[1])


class LanczosSincFilter(Filter):
    def __init__(self, radius, tau=3.0):
        super().__init__(radius)
        self.tau = float(tau)

    @staticmethod
    def _sinc(x):
        x = np.abs(x)
        return np.where(x < 1e-5, 1.0, np.sin(np.pi * x) / (np.pi * x))

    def _windowed(self, x, radius):
        x = np.abs(x)
        return np.where(x > radius, 0.0, self._sinc(x) * self._sinc(x / self.tau))

    def evaluate(self, x, y):
        return self._windowed(x, self.radius[0]) * self._windowed(y, self.radius[1])


def make_filter(name: str, params) -> Filter:
    """Factory with pbrt-v3's parameter defaults."""

    def radius(default):
        return (params.find_one_float("xwidth", default),
                params.find_one_float("ywidth", default))

    if name == "box":
        return BoxFilter(radius(0.5))
    if name == "triangle":
        return TriangleFilter(radius(2.0))
    if name == "gaussian":
        return GaussianFilter(radius(2.0), params.find_one_float("alpha", 2.0))
    if name == "mitchell":
        return MitchellFilter(radius(2.0), params.find_one_float("B", 1.0 / 3.0),
                              params.find_one_float("C", 1.0 / 3.0))
    if name == "sinc":
        return LanczosSincFilter(radius(4.0), params.find_one_float("tau", 3.0))
    raise ValueError(f"Filter '{name}' unknown.")
