"""Cameras: batched ray generation (counterpart of
``pbrt_tpu/cameras/__init__.py``).

The perspective and orthographic cameras (with thin-lens depth of
field) are ported.  Environment and realistic cameras, camera motion
blur and the BDPT importance functions wait for ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch import float_t
from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import Transform, apply_point, apply_vector


def _screen_window(frame_aspect, screen_window_param=None):
    if screen_window_param is not None:
        return screen_window_param
    if frame_aspect > 1.0:
        return (-frame_aspect, frame_aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / frame_aspect, 1.0 / frame_aspect)


class ProjectiveCamera:
    def __init__(self, camera_to_world: Transform, camera_to_screen: Transform, resolution,
                 screen_window=None, lens_radius=0.0, focal_distance=1e6, device="cuda"):
        aspect = resolution[0] / resolution[1]
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

    def _to_world(self, o, d):
        d_w = apply_vector(self._c2w, d)
        return apply_point(self._c2w, o), d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)


class PerspectiveCamera(ProjectiveCamera):
    def __init__(self, camera_to_world: Transform, fov_deg, resolution,
                 screen_window=None, lens_radius=0.0, focal_distance=1e6,
                 device="cuda"):
        super().__init__(camera_to_world, Transform.perspective(fov_deg, 1e-2, 1000.0),
                         resolution, screen_window, lens_radius, focal_distance, device)

    def generate_rays(self, p_film, u_lens=None):
        """p_film: [N, 2] raster samples -> (origin, dir [N, 3], weight [N])."""
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
        o_w, d_w = self._to_world(o, d)
        return o_w, d_w, torch.ones(n, dtype=torch.float32, device=p_film.device)


class OrthographicCamera(ProjectiveCamera):
    def __init__(self, camera_to_world: Transform, resolution, screen_window=None,
                 lens_radius=0.0, focal_distance=1e6, device="cuda"):
        super().__init__(camera_to_world, Transform.orthographic(0.0, 1.0), resolution,
                         screen_window, lens_radius, focal_distance, device)

    def generate_rays(self, p_film, u_lens=None):
        """p_film: [N, 2] raster samples -> (origin, dir [N, 3], weight [N])."""
        n = p_film.shape[0]
        o = apply_point(self._r2c, torch.cat([p_film, torch.zeros_like(p_film[:, :1])], dim=-1))
        d = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=o.device).expand(n, 3)
        if self.lens_radius > 0.0 and u_lens is not None:
            p_lens = self.lens_radius * concentric_sample_disk(u_lens)
            p_focus = o + d * self.focal_distance
            o = o + torch.cat([p_lens, torch.zeros_like(p_lens[:, :1])], dim=-1)
            d = p_focus - o
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o_w, d_w = self._to_world(o, d)
        return o_w, d_w, torch.ones(n, dtype=torch.float32, device=p_film.device)


def make_camera(name: str, params, camera_to_world: Transform, film, device="cuda"):
    """Factory per pbrt-v3 MakeCamera; the film supplies the resolution."""
    if name not in ("perspective", "orthographic"):
        raise NotImplementedError(
            f"Camera '{name}' is not ported yet (ROADMAP.md Queue 1 item 8); "
            "only 'perspective' and 'orthographic' are"
        )
    res = film.full_resolution
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
        return OrthographicCamera(camera_to_world, res, sw, lens_radius, focal, device=device)
    fov = params.find_one_float("fov", 90.0)
    half = params.find_one_float("halffov", -1.0)
    if half > 0:
        fov = 2 * half
    return PerspectiveCamera(camera_to_world, fov, res, sw, lens_radius, focal,
                             device=device)
