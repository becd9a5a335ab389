"""Realistic (lens-system) camera (counterpart of
``pbrt_tpu/cameras/realistic.py``; pbrt-v3 cameras/realistic.{h,cpp}).

Spherical lens elements read from a tabulated prescription (or one of
the built-in ones, ``BUILTIN_LENSES``: no lens file is fetched), rays
traced element by element with Snell refraction and aperture
vignetting, thick-lens autofocus.  The element list is tiny and static,
so the wavefront trace is an unrolled sequence of vector ops per surface
(the sphere quadratic and the refraction) over the whole batch with an
alive mask.  The host side (parsing, thick-lens focusing with paraxial
rays, the exit-pupil bounds) runs the same trace in numpy; the device
side runs it on tensors (``_TORCH``: the numpy calls the trace makes,
on torch).

Conventions follow pbrt: lens space has the film at z = 0 and the lens
system toward -z (camera space z is flipped on entry and exit);
prescriptions are millimetres (scaled to metres), rows of
``curvature_radius thickness eta aperture_diameter``; curvature 0 marks
the aperture stop.  Exit-pupil bounds are computed on the host per radial
film bin (pbrt BoundExitPupil) and lens samples land inside them
(SampleExitPupil); weights follow pbrt (cos^4 scaled by the bin's pupil
area).  The camera takes no shutter time, as in the reference.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from pbrt_tpu_torch import torch_dtype
from pbrt_tpu_torch.core.transform import Transform, apply_point, apply_vector

log = logging.getLogger("pbrt_tpu_torch")


class _TorchOps:
    """The numpy calls of the lens trace, on tensors (torch takes numpy's
    ``axis``/``keepdims`` names; ``maximum`` also takes a float)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def maximum(a, b):
        if isinstance(a, float):
            a, b = b, a
        return torch.clamp(a, min=b) if isinstance(b, float) else torch.maximum(a, b)


_TORCH = _TorchOps()


@dataclass
class LensElement:
    curvature_radius: float  # metres; 0 = aperture stop
    thickness: float  # metres, axial gap to the next element (rearward)
    eta: float  # index on the scene side of this interface (0 = air)
    aperture_radius: float  # metres


# A simple verifiable builtin: symmetric biconvex singlet, f ~= 50mm by the
# lensmaker's equation (used when scenes reference it by name and by tests).
BUILTIN_LENSES = {
    "biconvex-50mm": [
        # radius  thickness  eta   aperture (mm)
        (48.0, 4.0, 1.5, 30.0),
        (-48.0, 0.0, 1.0, 30.0),
    ],
    # same singlet with a 6mm stop 1mm behind it (f/8: aberration-free
    # enough for sharp renders; the wide-open variant shows the singlet's
    # real spherical aberration)
    "biconvex-50mm-f8": [
        (48.0, 4.0, 1.5, 30.0),
        (-48.0, 1.0, 1.0, 30.0),
        (0.0, 0.0, 0.0, 6.0),
    ],
}


def load_lens_file(filename: str):
    """Parse a pbrt lens .dat prescription (mm) -> [LensElement] (metres),
    ordered front (scene side) to rear (film side)."""
    if filename in BUILTIN_LENSES:
        rows = BUILTIN_LENSES[filename]
    else:
        rows = []
        with open(filename) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                vals = [float(v) for v in line.split()]
                if len(vals) != 4:
                    raise ValueError(f"{filename}: lens rows need 4 floats")
                rows.append(vals)
    if not rows:
        raise ValueError(f"{filename}: empty lens prescription")
    return [
        LensElement(r * 1e-3, t * 1e-3, e, 0.5 * a * 1e-3) for (r, t, e, a) in rows
    ]


def _intersect_spherical_element(radius, z_center, o, d, xp):
    """Quadratic against an axial sphere; returns (t, n, ok).

    pbrt-v3 IntersectSphericalElement: root selection depends on travel
    direction and element orientation; normal faces the incoming ray.
    """
    oz = o[..., 2] - z_center
    a = xp.sum(d * d, axis=-1)
    b = 2.0 * (d[..., 0] * o[..., 0] + d[..., 1] * o[..., 1] + d[..., 2] * oz)
    c = o[..., 0] ** 2 + o[..., 1] ** 2 + oz * oz - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = xp.sqrt(xp.maximum(disc, 0.0))
    q = xp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = q / xp.maximum(a, 1e-20)
    t1 = c / xp.where(xp.abs(q) < 1e-20, 1e-20, q)
    tmin = xp.minimum(t0, t1)
    tmax = xp.maximum(t0, t1)
    use_closer = (d[..., 2] > 0) ^ (radius < 0)
    t = xp.where(use_closer, tmin, tmax)
    ok = ok & (t > 0)
    p = o + t[..., None] * d
    n = p - xp.stack(
        [xp.zeros_like(t), xp.zeros_like(t), xp.full_like(t, z_center)], axis=-1
    )
    n = n / xp.maximum(
        xp.sqrt(xp.sum(n * n, axis=-1, keepdims=True)), 1e-20
    )
    # face-forward against the ray
    n = xp.where((xp.sum(n * d, axis=-1) > 0)[..., None], -n, n)
    return t, n, ok


def _refract(d, n, eta_ratio, xp):
    """Snell refraction of unit direction d through normal n (facing -d).
    eta_ratio = eta_i / eta_t.  Returns (d_t, ok)."""
    wi = -d
    cos_i = xp.sum(wi * n, axis=-1)
    sin2_i = xp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    cos_t = xp.sqrt(xp.maximum(0.0, 1.0 - sin2_t))
    wt = -wi * eta_ratio + (eta_ratio * cos_i - cos_t)[..., None] * n
    wt = wt / xp.maximum(xp.sqrt(xp.sum(wt * wt, axis=-1, keepdims=True)), 1e-20)
    return wt, ok


def trace_from_film(elements, o, d, xp=np):
    """Trace rays rear->front through the system in lens space
    (pbrt TraceLensesFromFilm).  o, d: [...,3]; returns (o, d, alive)."""
    alive = xp.ones_like(o[..., 0], dtype=bool)
    element_z = 0.0
    for i in range(len(elements) - 1, -1, -1):
        el = elements[i]
        element_z -= el.thickness
        is_stop = el.curvature_radius == 0.0
        if is_stop:
            t = (element_z - o[..., 2]) / xp.where(
                xp.abs(d[..., 2]) < 1e-20, 1e-20, d[..., 2]
            )
            ok = t > 0
            n = None
        else:
            z_center = element_z + el.curvature_radius
            t, n, ok = _intersect_spherical_element(
                el.curvature_radius, z_center, o, d, xp
            )
        p = o + t[..., None] * d
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        ok = ok & (r2 <= el.aperture_radius * el.aperture_radius)
        o = xp.where(alive[..., None], xp.where(ok[..., None], p, o), o)
        if not is_stop:
            eta_i = el.eta if el.eta != 0 else 1.0
            eta_t = (
                elements[i - 1].eta
                if (i > 0 and elements[i - 1].eta != 0)
                else 1.0
            )
            d_new, ok_r = _refract(d, n, eta_i / eta_t, xp)
            ok = ok & ok_r
            d = xp.where((alive & ok)[..., None], d_new, d)
        alive = alive & ok
    return o, d, alive


def trace_from_scene(elements, o, d, xp=np):
    """Trace front->rear (pbrt TraceLensesFromScene); lens space."""
    alive = xp.ones_like(o[..., 0], dtype=bool)
    element_z = -sum(el.thickness for el in elements)
    for i, el in enumerate(elements):
        is_stop = el.curvature_radius == 0.0
        if is_stop:
            t = (element_z - o[..., 2]) / xp.where(
                xp.abs(d[..., 2]) < 1e-20, 1e-20, d[..., 2]
            )
            ok = t > 0
            n = None
        else:
            z_center = element_z + el.curvature_radius
            t, n, ok = _intersect_spherical_element(
                el.curvature_radius, z_center, o, d, xp
            )
        p = o + t[..., None] * d
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        ok = ok & (r2 <= el.aperture_radius * el.aperture_radius)
        o = xp.where(alive[..., None], xp.where(ok[..., None], p, o), o)
        if not is_stop:
            eta_i = (
                1.0
                if (i == 0 or elements[i - 1].eta == 0)
                else elements[i - 1].eta
            )
            eta_t = el.eta if el.eta != 0 else 1.0
            d_new, ok_r = _refract(d, n, eta_i / eta_t, xp)
            ok = ok & ok_r
            d = xp.where((alive & ok)[..., None], d_new, d)
        alive = alive & ok
        element_z += el.thickness
    return o, d, alive


class RealisticCamera:
    """Full lens-system camera (pbrt-v3 RealisticCamera)."""

    def __init__(self, camera_to_world: Transform, elements, film,
                 focus_distance=10.0, aperture_diameter_m=None,
                 simple_weighting=True, device="cuda"):
        self.device = torch.device(device)
        self.float_t = float_t = film.float_t
        self._c2w = torch.as_tensor(camera_to_world.m.astype(float_t), device=self.device)
        self.elements = [LensElement(**vars(e)) for e in elements]
        self.simple_weighting = bool(simple_weighting)
        if aperture_diameter_m is not None:
            for el in self.elements:
                if el.curvature_radius == 0.0:
                    given = 0.5 * aperture_diameter_m
                    if given > el.aperture_radius:
                        log.warning(
                            "aperturediameter exceeds the prescription stop; clamping"
                        )
                    else:
                        el.aperture_radius = given
        # physical film plane
        ext = film.get_physical_extent()
        self._ext_min = np.asarray(ext.p_min, dtype=np.float64)
        self._ext_max = np.asarray(ext.p_max, dtype=np.float64)
        self.resolution = film.full_resolution
        self.film_diag = film.diagonal_m
        # thick-lens autofocus adjusts the film-to-rear-vertex gap
        self.elements[-1].thickness = self._focus_thick_lens(float(focus_distance))
        self.rear_z = self.elements[-1].thickness
        self.rear_radius = self.elements[-1].aperture_radius
        self._compute_exit_pupil()

    # -- host: cardinal points + focusing (pbrt ComputeThickLensApproximation)

    def _cardinal_points(self, o_in, o_out, d_out):
        # pbrt's ComputeCardinalPoints negates CAMERA-space z; our rays are
        # already in lens space (z = -camera z), so the values read directly
        tf = -o_out[0, 0] / d_out[0, 0]
        fz = o_out[0, 2] + tf * d_out[0, 2]
        tp = (o_in[0, 0] - o_out[0, 0]) / d_out[0, 0]
        pz = o_out[0, 2] + tp * d_out[0, 2]
        return pz, fz

    def _thick_lens(self):
        x = 0.001 * self.film_diag
        front_z = -sum(el.thickness for el in self.elements)
        # scene-side parallel ray -> film side
        o_s = np.array([[x, 0.0, front_z - 1.0]])
        d_s = np.array([[0.0, 0.0, 1.0]])
        o_o, d_o, ok = trace_from_scene(self.elements, o_s, d_s, np)
        if not ok.all():
            raise ValueError("realistic camera: paraxial scene ray vignetted")
        pz0, fz0 = self._cardinal_points(o_s, o_o, d_o)
        # film-side parallel ray -> scene side
        o_f = np.array([[x, 0.0, self.elements[-1].thickness + 1.0]])
        d_f = np.array([[0.0, 0.0, -1.0]])
        o_o, d_o, ok = trace_from_film(self.elements, o_f, d_f, np)
        if not ok.all():
            raise ValueError("realistic camera: paraxial film ray vignetted")
        pz1, fz1 = self._cardinal_points(o_f, o_o, d_o)
        return pz0, fz0, pz1, fz1

    def _focus_thick_lens(self, focus_distance: float) -> float:
        pz0, fz0, pz1, fz1 = self._thick_lens()
        f = fz0 - pz0
        if not np.isfinite(f) or f == 0:
            raise ValueError("realistic camera: degenerate lens system")
        z = -focus_distance
        c = (pz1 - z - pz0) * (pz1 - z - 4.0 * f - pz0)
        if c <= 0:
            raise ValueError(
                "realistic camera: coincident focus requested (focusdistance too small)"
            )
        delta = 0.5 * (pz1 - z + pz0 - np.sqrt(c))
        return self.elements[-1].thickness + delta

    @property
    def focal_length(self) -> float:
        pz0, fz0, _, _ = self._thick_lens()
        return fz0 - pz0

    # -- host: exit pupil (pbrt-v3 BoundExitPupil) ------------------------

    N_PUPIL_BINS = 32

    def _compute_exit_pupil(self, n_grid=192, n_film=4):
        """Per-radial-bin 2D bounds on the rear-element plane of rays that
        survive the full lens trace (pbrt BoundExitPupil), precomputed on
        host with one vectorized numpy trace per bin.  Sampling inside
        these bounds instead of the whole rear disk wastes far fewer rays
        on vignetted directions at off-axis film points."""
        half_diag = 0.5 * self.film_diag
        r_proj = 1.5 * self.rear_radius
        xs = np.linspace(-r_proj, r_proj, n_grid)
        gx, gy = np.meshgrid(xs, xs, indexing="ij")
        rear = np.stack(
            [gx.ravel(), gy.ravel(), np.full(gx.size, -self.rear_z)], axis=-1
        )
        mins = np.zeros((self.N_PUPIL_BINS, 2))
        maxs = np.zeros((self.N_PUPIL_BINS, 2))
        for b in range(self.N_PUPIL_BINS):
            r0 = half_diag * b / self.N_PUPIL_BINS
            r1 = half_diag * (b + 1) / self.N_PUPIL_BINS
            lo, hi = np.full(2, np.inf), np.full(2, -np.inf)
            for fr in np.linspace(r0, r1, n_film):
                o = np.zeros((rear.shape[0], 3))
                o[:, 0] = fr
                d = rear - o
                d /= np.linalg.norm(d, axis=-1, keepdims=True)
                _, _, alive = trace_from_film(self.elements, o, d, np)
                if alive.any():
                    pts = rear[alive, :2]
                    lo = np.minimum(lo, pts.min(axis=0))
                    hi = np.maximum(hi, pts.max(axis=0))
            if not np.isfinite(lo).all():
                # fully vignetted bin: keep the whole rear disk so the
                # trace itself (not the pupil) decides
                lo = np.array([-self.rear_radius, -self.rear_radius])
                hi = np.array([self.rear_radius, self.rear_radius])
            else:
                # expand by the sample-grid spacing (pbrt's Expand)
                delta = 2 * r_proj / n_grid
                lo -= delta
                hi += delta
            mins[b] = lo
            maxs[b] = hi
        self.pupil_bounds = (mins, maxs)  # host float64, per radial bin
        float_t = self.float_t
        self._pupil_min = torch.as_tensor(mins.astype(float_t), device=self.device)
        self._pupil_max = torch.as_tensor(maxs.astype(float_t), device=self.device)
        self._pupil_area = torch.as_tensor(
            ((maxs - mins)[:, 0] * (maxs - mins)[:, 1]).astype(float_t), device=self.device)

    def _sample_exit_pupil(self, p_phys, u_lens):
        """pbrt SampleExitPupil: pick inside the radial bin's bounds,
        rotate to the film point's azimuth.  Returns (p_rear_xy [N, 2],
        bounds_area [N])."""
        x, y = p_phys[..., 0], p_phys[..., 1]
        r_film = torch.sqrt(x * x + y * y)
        half_diag = 0.5 * self.film_diag
        b = torch.clamp((r_film / half_diag * self.N_PUPIL_BINS).to(torch.int32),
                        0, self.N_PUPIL_BINS - 1).long()
        lo = self._pupil_min[b]
        hi = self._pupil_max[b]
        p = lo + u_lens * (hi - lo)
        area = self._pupil_area[b]
        # rotate from the +x reference azimuth to the film point's
        sin_t = torch.where(r_film > 0, y / torch.clamp(r_film, min=1e-12), 0.0)
        cos_t = torch.where(r_film > 0, x / torch.clamp(r_film, min=1e-12), 1.0)
        px = cos_t * p[..., 0] - sin_t * p[..., 1]
        py = sin_t * p[..., 0] + cos_t * p[..., 1]
        return torch.stack([px, py], dim=-1), area

    # -- device: wavefront ray generation -------------------------------------

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        """p_film: [N, 2] raster samples, u_lens [N, 2] -> (origin, dir
        [N, 3], weight [N]: 0 where the lens system vignettes the ray)."""
        n = p_film.shape[0]
        dev = p_film.device
        dt = torch_dtype(self.float_t)
        res = torch.as_tensor(self.resolution, dtype=dt, device=dev)
        s = p_film / res
        ext_min = torch.as_tensor(self._ext_min, dtype=dt, device=dev)
        ext_max = torch.as_tensor(self._ext_max, dtype=dt, device=dev)
        p_phys = ext_min + s * (ext_max - ext_min)
        # pbrt flips x on the physical film (the image forms inverted)
        o_film = torch.stack([-p_phys[..., 0], p_phys[..., 1], torch.zeros_like(p_phys[..., 0])],
                             dim=-1)
        if u_lens is None:
            u_lens = torch.full((n, 2), 0.5, dtype=dt, device=dev)
        # exit-pupil sampling: only the rear-plane region that can survive
        # the trace, rotated to the film azimuth
        p_xy, pupil_area = self._sample_exit_pupil(o_film, u_lens)
        # the rear element's vertex sits at z = -rear_z in lens space
        p_rear = torch.cat([p_xy, torch.full((n, 1), -self.rear_z, dtype=dt,
                                             device=dev)], dim=-1)
        d = p_rear - o_film
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o_l, d_l, alive = trace_from_film(self.elements, o_film, d, _TORCH)
        # lens space -> camera space: flip z (pbrt LensToCamera Scale(1, 1, -1))
        flip = torch.tensor([1.0, 1.0, -1.0], dtype=dt, device=dev)
        o_c = o_l * flip
        d_c = d_l * flip
        d_c = d_c / torch.linalg.norm(d_c, dim=-1, keepdim=True)
        o_w = apply_point(self._c2w, o_c)
        d_w = apply_vector(self._c2w, d_c)
        d_w = d_w / torch.linalg.norm(d_w, dim=-1, keepdim=True)
        cos4 = torch.abs(d[..., 2]) ** 4
        if self.simple_weighting:
            # normalized by the on-axis pupil area, so the weight stays ~1
            # while off-axis bins integrate over their (smaller) bounds
            w = cos4 * pupil_area / torch.clamp(self._pupil_area[0], min=1e-20)
        else:
            w = cos4 * pupil_area / (self.rear_z ** 2)
        return o_w, d_w, torch.where(alive, w, 0.0).to(dt)
