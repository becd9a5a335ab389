"""Film: pixel bounds (host) and the accumulated XYZ state (tensors).

Counterpart of ``pbrt_tpu/core/film.py`` for the dense path only:
``initial_state`` and ``to_rgb``.  Samples are accumulated by
``render.Renderer`` with a reshape-sum per pixel (the reference's
``_step_impl_dense``); the filtered scatter (``add_samples``) and splats
wait for the scatter film port (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from pbrt_tpu_torch import float_t
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.filters import BoxFilter
from pbrt_tpu_torch.core.geometry import Bounds2f, Bounds2i


class Film:
    def __init__(
        self,
        resolution,
        crop_window=((0.0, 0.0), (1.0, 1.0)),
        filter=None,
        diagonal_mm: float = 35.0,
        filename: str = "pbrt.png",
        scale: float = 1.0,
        max_sample_luminance: float = float("inf"),
        device="cuda",
    ):
        self.full_resolution = (int(resolution[0]), int(resolution[1]))
        self.crop_window = Bounds2f.from_points(crop_window[0], crop_window[1])
        self.filter = filter or BoxFilter((0.5, 0.5))
        self.diagonal_m = float(diagonal_mm) * 0.001
        self.filename = filename
        self.scale = float(scale)
        self.max_sample_luminance = float(max_sample_luminance)
        self.device = torch.device(device)
        fx, fy = self.full_resolution
        self.cropped_pixel_bounds = Bounds2i(
            (
                math.ceil(fx * self.crop_window.p_min[0]),
                math.ceil(fy * self.crop_window.p_min[1]),
            ),
            (
                math.ceil(fx * self.crop_window.p_max[0]),
                math.ceil(fy * self.crop_window.p_max[1]),
            ),
        )
        self.rgb_to_xyz = torch.as_tensor(
            np.asarray(spec.RGB_TO_XYZ, dtype=float_t), device=self.device
        )
        self.xyz_to_rgb = torch.as_tensor(
            np.asarray(spec.XYZ_TO_RGB, dtype=float_t), device=self.device
        )

    def get_sample_bounds(self) -> Bounds2i:
        rx, ry = self.filter.radius
        b = self.cropped_pixel_bounds
        return Bounds2i(
            (math.floor(b.p_min[0] + 0.5 - rx), math.floor(b.p_min[1] + 0.5 - ry)),
            (math.ceil(b.p_max[0] - 0.5 + rx), math.ceil(b.p_max[1] - 0.5 + ry)),
        )

    def initial_state(self) -> Dict[str, torch.Tensor]:
        w, h = self.cropped_pixel_bounds.diagonal()
        z = dict(dtype=torch.float32, device=self.device)
        return {
            "xyz": torch.zeros((h, w, 3), **z),
            "weight": torch.zeros((h, w), **z),
        }

    def to_rgb(self, state):
        """Final [H, W, 3] RGB in the reference's write order."""
        rgb = state["xyz"] @ self.xyz_to_rgb.T
        w = state["weight"]
        nz = w != 0.0
        inv_w = torch.where(nz, 1.0 / torch.where(nz, w, torch.ones_like(w)), 1.0)
        rgb = torch.where(nz[..., None], torch.clamp(rgb * inv_w[..., None], min=0.0), rgb)
        return rgb * self.scale
