"""Cameras: batched ray generation (counterpart of
``pbrt_tpu/cameras/__init__.py``).

The perspective and orthographic cameras (with thin-lens depth of
field), the environment camera (``EnvironmentCamera``: the whole sphere
of directions in lat-long) and the lens-system camera
(``cameras/realistic.py``), and the pinhole perspective camera's
importance (``supports_light_tracing``, ``pdf_we_dir``, ``project``:
pbrt-v3's Pdf_We and We raster computation), which BDPT's light-tracing
strategies and their MIS densities read.

Camera motion blur (the projective cameras): ``set_animation`` keeps the
camera-to-world matrices keyframed across the shutter on the host
(``core/animated.py``), and ``generate_rays(p_film, u_lens, u_time)``
blends them per lane with the hat weights of its shutter time; without
``u_time`` (ray differentials, SPPM's camera rays) the static
camera-to-world applies, as in the reference.  A realistic camera whose
lens file cannot be read logs an error and falls back to a perspective
camera, as in the reference.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pbrt_tpu_torch import PI, torch_dtype
from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import Transform, apply_point, apply_vector
from pbrt_tpu_torch.ops.animated_intersect import time_weights

log = logging.getLogger("pbrt_tpu_torch")


def _screen_window(frame_aspect, screen_window_param=None):
    if screen_window_param is not None:
        return screen_window_param
    if frame_aspect > 1.0:
        return (-frame_aspect, frame_aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / frame_aspect, 1.0 / frame_aspect)


class ProjectiveCamera:
    def __init__(self, camera_to_world: Transform, camera_to_screen: Transform, resolution,
                 screen_window=None, lens_radius=0.0, focal_distance=1e6, device="cuda",
                 float_t=np.float32):
        aspect = resolution[0] / resolution[1]
        self.float_t = float_t
        x0, x1, y0, y1 = _screen_window(aspect, screen_window)
        res_x, res_y = resolution
        screen_to_raster = (
            Transform.scale(res_x, res_y, 1.0)
            * Transform.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
            * Transform.translate([-x0, -y1, 0.0])
        )
        raster_to_camera = camera_to_screen.inverse() * screen_to_raster.inverse()
        self.camera_to_world = camera_to_world
        self.lens_radius = float(lens_radius)
        self.focal_distance = float(focal_distance)
        self.resolution = (int(res_x), int(res_y))
        self._r2c = torch.as_tensor(raster_to_camera.m.astype(float_t), device=device)
        self._c2w = torch.as_tensor(camera_to_world.m.astype(float_t), device=device)
        self._w2c = torch.as_tensor(camera_to_world.m_inv.astype(float_t), device=device)
        self._c2r = torch.as_tensor(raster_to_camera.m_inv.astype(float_t), device=device)
        # importance normalization: the film's area on the camera-space z = 1
        # plane (pbrt-v3's PerspectiveCamera constructor)
        pmin = raster_to_camera.apply_p(np.zeros(3))
        pmax = raster_to_camera.apply_p(np.array([res_x, res_y, 0.0]))
        if abs(pmin[2]) > 1e-9 and abs(pmax[2]) > 1e-9:
            pmin, pmax = pmin / pmin[2], pmax / pmax[2]
            self.film_area = float(abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1])))
        else:
            self.film_area = 1.0
        self.cam_pos_world = np.asarray(camera_to_world.apply_p(np.zeros(3), float_t),
                                        dtype=float_t)
        self._anim_c2w = None  # [K, 4, 4] keyframes when the camera moves

    def set_animation(self, key_transforms):
        """Camera motion blur: the camera-to-world matrices at K shutter
        times (decompose + slerp on the host, ``core/animated.py``)."""
        self._anim_c2w = torch.as_tensor(
            np.stack([t.m for t in key_transforms]).astype(self.float_t),
            device=self._c2w.device)

    def _to_world(self, o, d, u_time=None):
        """Camera-space (o, d) -> world, blended per lane between the
        keyframed matrices when the camera moves and ``u_time`` is given;
        d normalized."""
        if self._anim_c2w is None or u_time is None:
            o_w, d_w = apply_point(self._c2w, o), apply_vector(self._c2w, d)
        else:
            w = time_weights(torch.broadcast_to(u_time, o.shape[:-1]).to(o.dtype),
                             self._anim_c2w.shape[0])
            m = w[:, 0, None, None] * self._anim_c2w[0]
            for k in range(1, self._anim_c2w.shape[0]):
                m = m + w[:, k, None, None] * self._anim_c2w[k]
            o_w = torch.sum(m[:, :3, :3] * o[:, None, :], dim=-1) + m[:, :3, 3]
            d_w = torch.sum(m[:, :3, :3] * d[:, None, :], dim=-1)
        return o_w, d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)


class PerspectiveCamera(ProjectiveCamera):
    def __init__(self, camera_to_world: Transform, fov_deg, resolution,
                 screen_window=None, lens_radius=0.0, focal_distance=1e6,
                 device="cuda", float_t=np.float32):
        super().__init__(camera_to_world, Transform.perspective(fov_deg, 1e-2, 1000.0),
                         resolution, screen_window, lens_radius, focal_distance, device, float_t)

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        """p_film: [N, 2] raster samples, u_lens [N, 2], u_time [N] shutter
        times -> (origin, dir [N, 3], weight [N])."""
        n = p_film.shape[0]
        p_raster = torch.cat([p_film, torch.zeros_like(p_film[:, :1])], dim=-1)
        p_camera = apply_point(self._r2c, p_raster)
        d = p_camera / torch.linalg.norm(p_camera, dim=-1, keepdim=True)
        o = torch.zeros_like(d)
        if self.lens_radius > 0.0 and u_lens is not None:
            p_lens = self.lens_radius * concentric_sample_disk(u_lens)
            p_focus = d * (self.focal_distance / d[..., 2:3])
            o = torch.cat([p_lens, torch.zeros_like(p_lens[:, :1])], dim=-1)
            d = p_focus - o
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o_w, d_w = self._to_world(o, d, u_time)
        return o_w, d_w, torch.ones(n, dtype=torch_dtype(self.float_t), device=p_film.device)

    # -- camera importance (pinhole only: BDPT's light tracing) -------------

    @property
    def supports_light_tracing(self):
        return self.lens_radius == 0.0

    def _in_raster(self, p_focus):
        """Raster positions [..., 2] of camera-space points on the z = 1
        plane, and whether they fall on the film."""
        p_raster = apply_point(self._c2r, p_focus)
        rx, ry = self.resolution
        ok = ((p_raster[..., 0] >= 0.0) & (p_raster[..., 0] < rx)
              & (p_raster[..., 1] >= 0.0) & (p_raster[..., 1] < ry))
        return p_raster[..., :2], ok

    def pdf_we_dir(self, d_world):
        """Directional density of ``generate_rays``: 1 / (A cos^3 theta)
        inside the frustum, 0 outside (pbrt-v3's Pdf_We)."""
        d_cam = apply_vector(self._w2c, d_world)
        d_cam = d_cam / torch.clamp(torch.linalg.norm(d_cam, dim=-1, keepdim=True), min=1e-12)
        cos_t = d_cam[..., 2]
        _, ok = self._in_raster(d_cam / torch.clamp(cos_t, min=1e-6)[..., None])
        pdf = 1.0 / torch.clamp(self.film_area * cos_t ** 3, min=1e-12)
        return torch.where(ok & (cos_t > 1e-6), pdf, 0.0)

    def project(self, p_world):
        """World points -> (raster [N, 2], on the film, cos theta, distance)
        relative to the pinhole (pbrt-v3's We raster computation)."""
        pc = apply_point(self._w2c, p_world)
        dist = torch.clamp(torch.linalg.norm(pc, dim=-1), min=1e-12)
        cos_t = pc[..., 2] / dist
        p_raster, ok = self._in_raster(pc / torch.clamp(pc[..., 2], min=1e-9)[..., None])
        return p_raster, ok & (cos_t > 1e-6), cos_t, dist


class OrthographicCamera(ProjectiveCamera):
    def __init__(self, camera_to_world: Transform, resolution, screen_window=None,
                 lens_radius=0.0, focal_distance=1e6, device="cuda", float_t=np.float32):
        super().__init__(camera_to_world, Transform.orthographic(0.0, 1.0), resolution,
                         screen_window, lens_radius, focal_distance, device, float_t)

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        """p_film: [N, 2] raster samples, u_lens [N, 2], u_time [N] shutter
        times -> (origin, dir [N, 3], weight [N])."""
        n = p_film.shape[0]
        o = apply_point(self._r2c, torch.cat([p_film, torch.zeros_like(p_film[:, :1])], dim=-1))
        d = torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype, device=o.device).expand(n, 3)
        if self.lens_radius > 0.0 and u_lens is not None:
            p_lens = self.lens_radius * concentric_sample_disk(u_lens)
            p_focus = o + d * self.focal_distance
            o = o + torch.cat([p_lens, torch.zeros_like(p_lens[:, :1])], dim=-1)
            d = p_focus - o
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o_w, d_w = self._to_world(o, d, u_time)
        return o_w, d_w, torch.ones(n, dtype=torch_dtype(self.float_t), device=p_film.device)


class EnvironmentCamera:
    """Every direction of the sphere in lat-long: x to phi, y to theta."""

    def __init__(self, camera_to_world: Transform, resolution, device="cuda",
                 float_t=np.float32):
        self.float_t = float_t
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self._c2w = torch.as_tensor(camera_to_world.m.astype(float_t), device=device)

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        """p_film: [N, 2] raster samples -> (origin, dir [N, 3], weight [N])."""
        res_x, res_y = self.resolution
        theta = PI * p_film[..., 1] / res_y
        phi = 2 * PI * p_film[..., 0] / res_x
        st, ct = torch.sin(theta), torch.cos(theta)
        d = torch.stack([st * torch.cos(phi), ct, -st * torch.sin(phi)], dim=-1)
        o_w = apply_point(self._c2w, torch.zeros_like(d))
        d_w = apply_vector(self._c2w, d)
        return o_w, d_w, torch.ones(p_film.shape[0], dtype=torch_dtype(self.float_t),
                                    device=p_film.device)


def make_camera(name: str, params, camera_to_world: Transform, film, device="cuda"):
    """Factory per pbrt-v3 MakeCamera; the film supplies the resolution,
    the parameters the policy's float."""
    res = film.full_resolution
    kw = dict(device=device, float_t=params.float_t)
    params.find_one_float("shutteropen", 0.0)
    params.find_one_float("shutterclose", 1.0)
    lens_radius = params.find_one_float("lensradius", 0.0)
    focal = params.find_one_float("focaldistance", 1e6)
    params.find_one_float("frameaspectratio", res[0] / res[1])
    sw_list = params.find_float("screenwindow")
    sw = None
    if sw_list is not None and len(sw_list) == 4:
        sw = tuple(float(v) for v in sw_list)
    if name == "orthographic":
        return OrthographicCamera(camera_to_world, res, sw, lens_radius, focal, **kw)
    if name == "environment":
        return EnvironmentCamera(camera_to_world, res, **kw)
    if name == "realistic":
        from pbrt_tpu_torch.cameras.realistic import (
            BUILTIN_LENSES,
            RealisticCamera,
            load_lens_file,
        )

        raw = params.find_one_string("lensfile", "")
        lensfile = raw if raw in BUILTIN_LENSES else params.find_one_filename("lensfile", "")
        ap_mm = params.find_one_float("aperturediameter", 1.0)
        focusd = params.find_one_float("focusdistance", 10.0)
        simple = params.find_one_bool("simpleweighting", True)
        try:
            return RealisticCamera(camera_to_world, load_lens_file(lensfile), film,
                                   focus_distance=focusd, aperture_diameter_m=ap_mm * 1e-3,
                                   simple_weighting=simple, device=device)
        except (OSError, ValueError) as err:
            log.error("realistic camera: %s; falling back to perspective", err)
            return PerspectiveCamera(camera_to_world, 45.0, res, sw, lens_radius, focal, **kw)
    if name != "perspective":
        log.warning("Camera '%s' unknown; using perspective.", name)
        return PerspectiveCamera(camera_to_world, 90.0, res, sw, lens_radius, focal, **kw)
    fov = params.find_one_float("fov", 90.0)
    half = params.find_one_float("halffov", -1.0)
    if half > 0:
        fov = 2 * half
    return PerspectiveCamera(camera_to_world, fov, res, sw, lens_radius, focal, **kw)
