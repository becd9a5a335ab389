"""AnimatedTransform: decompose + slerp keyframing, on the host (numpy
copy of ``pbrt_tpu/core/animated.py``; pbrt-v3 transform.cpp).

A start/end transform pair is decomposed into translation T, rotation
quaternion R and scale/shear S (the polar-decomposition iteration of
pbrt's AnimatedTransform::Decompose), and ``interpolate(t)`` rebuilds
the time-t transform with lerp(T), slerp(R), lerp(S).  The device never
slerps: the host samples ``n_keys`` transforms across the shutter (2 for
a pure translation, up to 9 by the rotation angle, so that the chord
between consecutive keyframes stays within ~0.5% of the slerp arc),
applies them to object-space geometry, and the wavefront blends vertex
positions between adjacent keyframes with each lane's hat weights
(``ops/animated_intersect.time_weights``).
"""

from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core.transform import Transform


def _quat_from_matrix(m):
    """Rotation matrix [3,3] -> unit quaternion (w, x, y, z)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _quat_to_matrix(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0, q1, t):
    """Spherical linear interpolation of unit quaternions (pbrt Slerp)."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = (1 - t) * q0 + t * q1
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / s


def decompose(m):
    """4x4 -> (T [3], R quaternion, S [3,3]) — pbrt AnimatedTransform::
    Decompose: polar iteration M_{k+1} = (M_k + M_k^-T)/2 for R, S = R^-1 M."""
    m = np.asarray(m, dtype=np.float64)
    t = m[:3, 3].copy()
    r = m[:3, :3].copy()
    for _ in range(100):
        try:
            r_next = 0.5 * (r + np.linalg.inv(r).T)
        except np.linalg.LinAlgError:
            break
        if np.abs(r_next - r).max() < 1e-10:
            r = r_next
            break
        r = r_next
    # guard mirrored transforms (det<0): fold the flip into S
    if np.linalg.det(r) < 0:
        r = -r
    q = _quat_from_matrix(r)
    s = np.linalg.inv(r) @ m[:3, :3]
    return t, q, s


class AnimatedTransform:
    """Start/end Transform pair + times; host-side interpolation."""

    def __init__(self, start, end, time_start=0.0, time_end=1.0):
        self.start = start
        self.end = end
        self.time_start = float(time_start)
        self.time_end = float(time_end)
        self.actually_animated = not np.allclose(start.m, end.m, atol=1e-12)
        self._t0, self._q0, self._s0 = decompose(start.m)
        self._t1, self._q1, self._s1 = decompose(end.m)

    @property
    def rotation_angle(self) -> float:
        """Total slerp arc angle (radians) between the two keyframes."""
        d = abs(float(np.dot(self._q0, self._q1)))
        return 2.0 * float(np.arccos(np.clip(d, -1.0, 1.0)))

    def interpolate(self, time: float):
        """Transform at ``time`` (clamped to the keyframe interval)."""
        if not self.actually_animated or time <= self.time_start:
            return self.start
        if time >= self.time_end:
            return self.end
        dt = (time - self.time_start) / (self.time_end - self.time_start)
        t = (1 - dt) * self._t0 + dt * self._t1
        q = slerp(self._q0, self._q1, dt)
        s = (1 - dt) * self._s0 + dt * self._s1
        m = np.eye(4)
        m[:3, :3] = _quat_to_matrix(q) @ s
        m[:3, 3] = t
        return Transform(m)

    def n_keys(self, max_chord_err: float = 0.005, cap: int = 9) -> int:
        """Keyframe count so per-segment linear vertex lerp stays within
        ``max_chord_err`` (relative chord-vs-arc error) of the slerp path."""
        if not self.actually_animated:
            return 1
        angle = self.rotation_angle
        if angle < 1e-6:
            return 2
        # chord error of a segment spanning angle a is ~1 - cos(a/2)
        segs = int(np.ceil(angle / (2 * np.arccos(1 - max_chord_err))))
        return int(np.clip(segs + 1, 2, cap))

    def key_transforms(self, shutter_open, shutter_close, n=None):
        """Transforms at n uniform times across the shutter."""
        if n is None:
            n = self.n_keys()
        if n <= 1:
            return [self.interpolate(shutter_open)]
        times = np.linspace(shutter_open, shutter_close, n)
        return [self.interpolate(float(t)) for t in times]
