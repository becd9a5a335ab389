"""Film: pixel bounds (host) and the accumulated XYZ state (tensors).

Counterpart of ``pbrt_tpu/core/film.py``: ``initial_state`` (``xyz``,
``weight`` and the splat channel ``splat_xyz``), ``add_samples`` (the
filtered scatter: each sample adds its filter-weighted XYZ to every pixel
of its half-open support, with the max-sample-luminance clamp and the
crop window), ``add_splats`` (the unfiltered scatter of BDPT's light
tracing and of MLT), ``set_image`` (a whole image, SPPM's) and
``to_rgb``, which adds ``splat_scale`` times the splat channel after the
weight division and before ``scale``.  The dense
path's per-pixel sums are taken by ``render.Renderer`` (the reference's
``_step_impl_dense``).

The reference's scatters wrap negative pixel offsets around, so samples
within the filter radius left of (above) the cropped film add to its
right (bottom) edge, and so do splats up to one film width (height) left
of (above) it; both scatters keep that for parity (ROADMAP.md Queue 3).

Both scatters accumulate with ``index_put_(..., accumulate=True)``.
On the card its sums over several samples differ from the CPU's in the
last bits, but not from run to run: two card renders through this film
were bit-equal, and so was a checkpointed render resumed midway
(``chip_smoke.py`` phase 13 (c), NVIDIA H100 80GB HBM3, 700.00 W).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from pbrt_tpu_torch import torch_dtype
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.filters import FILTER_TABLE_WIDTH, BoxFilter
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
        float_t=np.float32,
    ):
        self.full_resolution = (int(resolution[0]), int(resolution[1]))
        self.crop_window = Bounds2f.from_points(crop_window[0], crop_window[1])
        self.filter = filter or BoxFilter((0.5, 0.5))
        self.diagonal_m = float(diagonal_mm) * 0.001
        self.filename = filename
        self.scale = float(scale)
        self.max_sample_luminance = float(max_sample_luminance)
        self.device = torch.device(device)
        self.float_t = float_t  # the policy's float: the image's and the tables'
        self.dtype = torch_dtype(float_t)
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
        self.filter_table = torch.as_tensor(
            self.filter.table(FILTER_TABLE_WIDTH, float_t), device=self.device
        )

    def get_sample_bounds(self) -> Bounds2i:
        rx, ry = self.filter.radius
        b = self.cropped_pixel_bounds
        return Bounds2i(
            (math.floor(b.p_min[0] + 0.5 - rx), math.floor(b.p_min[1] + 0.5 - ry)),
            (math.ceil(b.p_max[0] - 0.5 + rx), math.ceil(b.p_max[1] - 0.5 + ry)),
        )

    def get_physical_extent(self) -> Bounds2f:
        """The film's extent in metres, centred on the optical axis (its
        diagonal is ``diagonal_m``)."""
        aspect = self.full_resolution[1] / self.full_resolution[0]
        x = math.sqrt(self.diagonal_m ** 2 / (1 + aspect ** 2))
        y = aspect * x
        return Bounds2f((-x / 2, -y / 2), (x / 2, y / 2))

    def initial_state(self) -> Dict[str, torch.Tensor]:
        w, h = self.cropped_pixel_bounds.diagonal()
        z = dict(dtype=self.dtype, device=self.device)
        return {
            "xyz": torch.zeros((h, w, 3), **z),
            "weight": torch.zeros((h, w), **z),
            "splat_xyz": torch.zeros((h, w, 3), **z),
        }

    def _filter_support(self):
        """Candidate pixels per axis of the half-open support (-r, r]."""
        rx, ry = self.filter.radius
        return int(math.floor(2 * rx)) + 1, int(math.floor(2 * ry)) + 1

    def add_samples(self, state, p_film, L_rgb, mask=None):
        """Accumulate filtered samples: p_film [N, 2] continuous raster
        positions, L_rgb [N, 3], mask [N] valid lanes -> the new state."""
        rx, ry = self.filter.radius
        inv_rx, inv_ry = 1.0 / rx, 1.0 / ry
        bx, by = self.cropped_pixel_bounds.p_min
        w, h = self.cropped_pixel_bounds.diagonal()
        fw, fh = self._filter_support()
        if mask is None:
            mask = torch.ones(p_film.shape[0], dtype=torch.bool, device=p_film.device)
        if math.isfinite(self.max_sample_luminance):
            y = 0.212671 * L_rgb[..., 0] + 0.715160 * L_rgb[..., 1] + 0.072169 * L_rgb[..., 2]
            s = torch.where(y > self.max_sample_luminance,
                            self.max_sample_luminance / torch.clamp(y, min=1e-20), 1.0)
            L_rgb = L_rgb * s[..., None]
        xyz = L_rgb @ self.rgb_to_xyz.T
        # half-open support (-r, r] per axis: a sample on a pixel boundary
        # belongs to the pixel it floors into, as on the dense path
        px = p_film[..., 0] - 0.5
        py = p_film[..., 1] - 0.5
        x0 = (torch.floor(px - rx) + 1).to(torch.int32)
        y0 = (torch.floor(py - ry) + 1).to(torch.int32)
        x1 = torch.floor(px + rx).to(torch.int32)
        y1 = torch.floor(py + ry).to(torch.int32)
        film_xyz = state["xyz"].reshape(-1, 3).clone()
        film_w = state["weight"].reshape(-1).clone()
        last = FILTER_TABLE_WIDTH - 1
        for j in range(fh):
            for i in range(fw):
                pxl_x = x0 + i
                pxl_y = y0 + j
                dx = torch.abs((pxl_x.to(self.dtype) - px) * inv_rx * FILTER_TABLE_WIDTH)
                dy = torch.abs((pxl_y.to(self.dtype) - py) * inv_ry * FILTER_TABLE_WIDTH)
                ix = torch.clamp(dx.to(torch.int32), max=last).long()
                iy = torch.clamp(dy.to(torch.int32), max=last).long()
                lx = pxl_x - bx
                ly = pxl_y - by
                # the reference's scatter indexes as NumPy does: a pixel up
                # to one film width (height) left of (above) the cropped
                # film lands that far from its right (bottom) edge, and
                # only pixels beyond that, or right of (below) it, drop
                ok = (mask & (pxl_x <= x1) & (pxl_y <= y1)
                      & (lx >= -w) & (lx < w) & (ly >= -h) & (ly < h))
                lx = torch.where(lx < 0, lx + w, lx)
                ly = torch.where(ly < 0, ly + h, ly)
                wgt = torch.where(ok, self.filter_table[iy, ix], 0.0)
                idx = torch.where(ok, ly * w + lx, 0).long()
                film_xyz.index_put_((idx,), xyz * wgt[..., None], accumulate=True)
                film_w.index_put_((idx,), wgt, accumulate=True)
        return {"xyz": film_xyz.reshape(h, w, 3), "weight": film_w.reshape(h, w),
                "splat_xyz": state["splat_xyz"]}

    def add_splats(self, state, p_film, L_rgb, mask=None):
        """Unfiltered splats: each lane's XYZ added to the pixel
        ``floor(p_film)`` of the cropped film, unweighted; p_film [N, 2]
        absolute raster positions, L_rgb [N, 3], mask [N] -> the new state.
        As the reference's scatter indexes, a pixel up to one film width
        (height) left of (above) the crop lands that far from its right
        (bottom) edge; pixels beyond that, or right of (below) it, drop."""
        bx, by = self.cropped_pixel_bounds.p_min
        w, h = self.cropped_pixel_bounds.diagonal()
        if mask is None:
            mask = torch.ones(p_film.shape[0], dtype=torch.bool, device=p_film.device)
        xyz = L_rgb @ self.rgb_to_xyz.T
        lx = torch.floor(p_film[..., 0]).to(torch.int32) - bx
        ly = torch.floor(p_film[..., 1]).to(torch.int32) - by
        ok = mask & (lx >= -w) & (lx < w) & (ly >= -h) & (ly < h)
        lx = torch.where(lx < 0, lx + w, lx)
        ly = torch.where(ly < 0, ly + h, ly)
        idx = torch.where(ok, ly * w + lx, 0).long()
        splat = state["splat_xyz"].reshape(-1, 3).clone()
        splat.index_put_((idx,), torch.where(ok[..., None], xyz, 0.0), accumulate=True)
        return {"xyz": state["xyz"], "weight": state["weight"],
                "splat_xyz": splat.reshape(h, w, 3)}

    def to_rgb(self, state, splat_scale: float = 1.0):
        """Final [H, W, 3] RGB in the reference's write order: the weighted
        mean, then ``splat_scale`` times the splat channel, then ``scale``."""
        rgb = state["xyz"] @ self.xyz_to_rgb.T
        w = state["weight"]
        nz = w != 0.0
        inv_w = torch.where(nz, 1.0 / torch.where(nz, w, torch.ones_like(w)), 1.0)
        rgb = torch.where(nz[..., None], torch.clamp(rgb * inv_w[..., None], min=0.0), rgb)
        rgb = rgb + splat_scale * (state["splat_xyz"] @ self.xyz_to_rgb.T)
        return rgb * self.scale

    def set_image(self, state, rgb_image):
        """A state whose image is ``rgb_image`` [H, W, 3] (weight 1, no
        splats): how integrators that estimate whole pixels (SPPM) hand
        back their result."""
        return {"xyz": rgb_image @ self.rgb_to_xyz.T,
                "weight": torch.ones_like(state["weight"]),
                "splat_xyz": torch.zeros_like(state["splat_xyz"])}

    def write_image(self, state, splat_scale: float = 1.0, filename=None) -> None:
        """Write the image to ``filename`` (the film's unless given); the
        format follows the extension (``core/imageio.write_image``)."""
        from pbrt_tpu_torch.core.imageio import write_image

        write_image(filename or self.filename, self.to_rgb(state, splat_scale).cpu().numpy(),
                    self.cropped_pixel_bounds, self.full_resolution)
