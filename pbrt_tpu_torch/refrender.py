"""Independent scalar reference path tracer: the port's own copy of
``pbrt_tpu/refrender.py``, its second yardstick.

A deliberately naive, non-wavefront, pure-numpy recursive path tracer in
float64 that shares nothing with the device code paths: no torch, no
intersector, no BSDF, light or integrator module of either package (it
imports numpy and math only).  Its only contact with the renderer is the
sample stream: callers pass a precomputed ``(lane, dim)`` table drawn
from the same deterministic sampler (every sampler value is a pure
function of (pixel, sample index, dimension)), so the two renderers walk
the same random decisions and their images agree to floating-point noise,
not just to Monte-Carlo tolerance.  A systematic bias in the wavefront
machinery (masking, MIS bookkeeping, the sorted-carry permutation, the
film) shows up as a direct image mismatch.

Feature surface: spheres and triangles (with per-vertex st), matte
(Lambert, constant or checkerboard Kd with the closed-form box-filtered
anti-aliasing driven by independently derived camera ray-differential
footprints), perfect mirror and smooth dielectric glass (Fresnel
reflect/refract choice, total internal reflection, the radiance
transport's eta^2), point, distant, constant infinite and diffuse area
(triangle) lights, a Planck + CIE-fit blackbody to RGB conversion, the
perspective pinhole camera, and the path integrator with NEE,
power-heuristic MIS and Russian roulette, in the sample-dimension layout
of ``integrators/path.py``.  The code below the imports is the
reference's, line for line: ``tests/test_torch_refrender.py`` holds the
two to the same image, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np

PI = math.pi
INF_T = 1e8
SHADOW_EPS = 1e-3
RAY_EPS = 1e-4


# ---------------------------------------------------------------------------
# Scene description (plain data, independent of the device scene builder)
# ---------------------------------------------------------------------------


class RefScene:
    """spheres: [(center, radius, mat)]; triangles: [(p0, p1, p2, mat,
    light_id)] or [(p0, p1, p2, mat, light_id, uv0, uv1, uv2)] with
    2-vector texture coordinates; materials:
      {"type": "matte", "kd": rgb}                      constant Lambert
      {"type": "matte", "checker": {"su","sv","tex1","tex2"}}  checker Kd
      {"type": "mirror", "kr": rgb}
      {"type": "glass", "kr": rgb, "kt": rgb, "eta": float}
    lights: list of dicts:
      {"type": "point", "p": xyz, "I": rgb}
      {"type": "distant", "dir": xyz-toward-light, "L": rgb}
      {"type": "infinite", "L": rgb}
      {"type": "area", "L": rgb, "tris": [(p0, p1, p2)], "id": k}
    Area lights must also appear as triangles with light_id == k so camera
    and BSDF rays see their emission.
    """

    def __init__(self, spheres, triangles, materials, lights):
        self.spheres = [
            (np.asarray(c, np.float64), float(r), int(m)) for c, r, m in spheres
        ]
        default_uv = (np.zeros(2), np.array([1.0, 0.0]), np.array([1.0, 1.0]))
        self.triangles = [
            (np.asarray(t[0], np.float64), np.asarray(t[1], np.float64),
             np.asarray(t[2], np.float64), int(t[3]), int(t[4]),
             tuple(np.asarray(u, np.float64) for u in t[5:8]) if len(t) > 5
             else default_uv)
            for t in triangles
        ]
        self.materials = materials
        self.lights = lights
        for lt in lights:
            if lt["type"] == "area":
                tris = lt["tris"]
                areas = [
                    0.5 * np.linalg.norm(np.cross(b - a, c - a))
                    for a, b, c in (
                        (np.asarray(a, np.float64), np.asarray(b, np.float64),
                         np.asarray(c, np.float64))
                        for a, b, c in tris
                    )
                ]
                lt["_areas"] = np.asarray(areas)
                lt["_total_area"] = float(lt["_areas"].sum())
                # CDF over triangle areas (pbrt Distribution1D)
                cdf = np.concatenate([[0.0], np.cumsum(lt["_areas"])])
                lt["_cdf"] = cdf / cdf[-1]


def look_at(eye, look, up):
    """pbrt-v3 LookAt camera-to-world (transform.cpp LookAt)."""
    eye = np.asarray(eye, np.float64)
    d = np.asarray(look, np.float64) - eye
    d /= np.linalg.norm(d)
    right = np.cross(np.asarray(up, np.float64) / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, eye
    return m


def perspective_raster_to_camera(fov_deg, xres, yres):
    """Inverse of pbrt's screen_to_raster * camera_to_screen chain."""
    aspect = xres / yres
    if aspect > 1.0:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    # perspective projection (pbrt Transform::Perspective, n=1e-2 f=1e3)
    n, f = 1e-2, 1000.0
    persp = np.array(
        [[1, 0, 0, 0],
         [0, 1, 0, 0],
         [0, 0, f / (f - n), -f * n / (f - n)],
         [0, 0, 1, 0]], np.float64,
    )
    it = 1.0 / math.tan(math.radians(fov_deg) / 2)
    persp = np.diag([it, it, 1.0, 1.0]) @ persp
    s2r = (
        np.diag([xres, yres, 1.0, 1.0])
        @ np.diag([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0, 1.0])
        @ np.array([[1, 0, 0, -x0], [0, 1, 0, -y1], [0, 0, 1, 0],
                    [0, 0, 0, 1]], np.float64)
    )
    return np.linalg.inv(persp) @ np.linalg.inv(s2r)


# ---------------------------------------------------------------------------
# Scalar intersection
# ---------------------------------------------------------------------------


def _intersect(scene, o, d, t_max):
    """Closest hit: returns (t, p, ng, mat, light, tri_or_None, b0, b1)
    or None; ``tri`` is the winning triangle tuple (for uv/footprint
    derivation), None for sphere hits."""
    best = None
    bt = t_max
    for c, r, m in scene.spheres:
        oc = o - c
        b = np.dot(oc, d)
        disc = b * b - (np.dot(oc, oc) - r * r)
        if disc <= 0.0:
            continue
        sq = math.sqrt(disc)
        for tt in (-b - sq, -b + sq):
            if RAY_EPS < tt < bt:
                p = o + tt * d
                ng = (p - c) / r
                best = (tt, p, ng, m, -1, None, 0.0, 0.0)
                bt = tt
                break
    for tri in scene.triangles:
        p0, p1, p2, m, l, _uvs = tri
        e1, e2 = p1 - p0, p2 - p0
        pv = np.cross(d, e2)
        det = np.dot(e1, pv)
        if abs(det) < 1e-12:
            continue
        inv = 1.0 / det
        tv = o - p0
        b0 = np.dot(tv, pv) * inv
        if b0 < 0.0 or b0 > 1.0:
            continue
        qv = np.cross(tv, e1)
        b1 = np.dot(d, qv) * inv
        if b1 < 0.0 or b0 + b1 > 1.0:
            continue
        tt = np.dot(e2, qv) * inv
        if RAY_EPS < tt < bt:
            ng = np.cross(e1, e2)
            ng = ng / np.linalg.norm(ng)
            best = (tt, o + tt * d, ng, m, l, tri, b0, b1)
            bt = tt
    return best


def _occluded(scene, o, d, t_max):
    return _intersect(scene, o, d, t_max) is not None


# -- warps (re-derived from pbrt-v3 ch. 13, not imported) -------------------


def _concentric_disk(u0, u1):
    ox, oy = 2 * u0 - 1, 2 * u1 - 1
    if ox == 0 and oy == 0:
        return 0.0, 0.0
    if abs(ox) > abs(oy):
        r, theta = ox, (PI / 4) * (oy / ox)
    else:
        r, theta = oy, PI / 2 - (PI / 4) * (ox / oy)
    return r * math.cos(theta), r * math.sin(theta)


def _cosine_hemisphere(u0, u1):
    x, y = _concentric_disk(u0, u1)
    z = math.sqrt(max(0.0, 1.0 - x * x - y * y))
    return np.array([x, y, z])


def _uniform_sphere(u0, u1):
    z = 1.0 - 2.0 * u0
    r = math.sqrt(max(0.0, 1.0 - z * z))
    phi = 2 * PI * u1
    return np.array([r * math.cos(phi), r * math.sin(phi), z])


def _frame(ns):
    """Branchless ONB (Duff et al. 2017) — same basis the device builds."""
    sign = 1.0 if ns[2] >= 0.0 else -1.0
    a = -1.0 / (sign + ns[2])
    b = ns[0] * ns[1] * a
    ss = np.array([1.0 + sign * ns[0] * ns[0] * a, sign * b, -sign * ns[0]])
    ts = np.array([b, sign + ns[1] * ns[1] * a, -ns[1]])
    return ss, ts


def _power_heuristic(fp, gp):
    f2, g2 = fp * fp, gp * gp
    return f2 / (f2 + g2) if (f2 + g2) > 0 else 0.0


def _fresnel_dielectric(cos_i, eta_t):
    """Scalar dielectric Fresnel, eta_i = 1 (pbrt-v3 FrDielectric)."""
    cos_i = max(-1.0, min(1.0, cos_i))
    ei, et = (1.0, eta_t) if cos_i > 0.0 else (eta_t, 1.0)
    ci = abs(cos_i)
    sin_t = ei / et * math.sqrt(max(0.0, 1.0 - ci * ci))
    if sin_t >= 1.0:
        return 1.0
    ct = math.sqrt(max(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / max(et * ci + ei * ct, 1e-8)
    r_perp = (ei * ci - et * ct) / max(ei * ci + et * ct, 1e-8)
    return 0.5 * (r_par * r_par + r_perp * r_perp)


def _refract_local(wo_l, eta_ratio):
    """Refract about +z in the face-forwarded local frame; returns
    (wt_or_None).  eta_ratio = eta_i / eta_t for the crossing."""
    cos_i = wo_l[2]
    sin2_t = eta_ratio * eta_ratio * max(0.0, 1.0 - cos_i * cos_i)
    if sin2_t >= 1.0:
        return None  # total internal reflection
    cos_t = math.sqrt(max(0.0, 1.0 - sin2_t))
    wt = eta_ratio * (-wo_l) + np.array(
        [0.0, 0.0, eta_ratio * cos_i - cos_t]
    )
    return wt / max(np.linalg.norm(wt), 1e-12)


# -- checkerboard Kd (pbrt-v3 §10.5, CLOSEDFORM box filter) -----------------


def _bumpint(x):
    h = x * 0.5
    return math.floor(h) + 2.0 * max(h - math.floor(h) - 0.5, 0.0)


def _checker_kd(mat, uv, width):
    """Checkerboard Kd at (u,v) with optional filter ``width`` (uv-space
    footprint, already the max |duv| component).  Mirrors the device's
    textures/checkerboard.py exactly: point parity lookup, or the
    closed-form box-filtered odd-fraction when a footprint is present."""
    ck = mat["checker"]
    su, sv = ck["su"], ck["sv"]
    t1 = np.asarray(ck["tex1"], np.float64)
    t2 = np.asarray(ck["tex2"], np.float64)
    s, t = su * uv[0], sv * uv[1]
    point = t1 if (math.floor(s) + math.floor(t)) % 2 == 0 else t2
    w = width * max(abs(su), abs(sv))
    if w <= 1e-9:
        return point
    sint = (_bumpint(s + w) - _bumpint(s - w)) / max(2.0 * w, 1e-12)
    tint = (_bumpint(t + w) - _bumpint(t - w)) / max(2.0 * w, 1e-12)
    area2 = sint + tint - 2.0 * sint * tint
    if w > 1.0:
        area2 = 0.5
    area2 = min(max(area2, 0.0), 1.0)
    return (1.0 - area2) * t1 + area2 * t2


def _matte_kd(mat, uv, width):
    if "checker" in mat:
        return _checker_kd(mat, uv, width)
    return np.asarray(mat["kd"], np.float64)


def _tri_tex_width(o, p, tri, dxd, dyd):
    """uv-space footprint of the +1px camera offset rays at a triangle
    hit — the device formula (scene/builder.py compute_interaction):
    transfer the offsets to the hit plane, project onto (dpdu, dpdv)
    through the dual basis of the first fundamental form, take the max
    |duvdx|/|duvdy| component."""
    p0, p1, p2, _m, _l, (uv0, uv1, uv2) = tri
    ng = np.cross(p1 - p0, p2 - p0)
    nrm = np.linalg.norm(ng)
    if nrm <= 0.0:
        return 0.0
    ng = ng / nrm

    def transfer(dd):
        denom = np.dot(dd, ng)
        if abs(denom) <= 1e-9:
            return np.zeros(3)
        tt = np.dot(p - o, ng) / denom
        return o + dd * tt - p

    dpdx, dpdy = transfer(dxd), transfer(dyd)
    duv02, duv12 = uv0 - uv2, uv1 - uv2
    dp02, dp12 = p0 - p2, p1 - p2
    det_uv = duv02[0] * duv12[1] - duv02[1] * duv12[0]
    if abs(det_uv) <= 1e-12:
        return 0.0
    dpdu = (duv12[1] * dp02 - duv02[1] * dp12) / det_uv
    dpdv = (-duv12[0] * dp02 + duv02[0] * dp12) / det_uv
    E, F, G = np.dot(dpdu, dpdu), np.dot(dpdu, dpdv), np.dot(dpdv, dpdv)
    det_g = E * G - F * F
    if det_g <= 1e-20:
        return 0.0
    fu = (G * dpdu - F * dpdv) / det_g
    fv = (E * dpdv - F * dpdu) / det_g
    return max(
        abs(np.dot(dpdx, fu)), abs(np.dot(dpdx, fv)),
        abs(np.dot(dpdy, fu)), abs(np.dot(dpdy, fv)),
    )


# -- blackbody -> RGB, independently derived --------------------------------
#
# Planck's law (physics) sampled at 1 nm over 360-830 nm, integrated
# against the Wyman et al. 2013 multi-lobe Gaussian fits of the CIE 1931
# standard observer, then XYZ -> linear sRGB.  Shares no tables with
# core/spectrum.py (which uses the binned CIE data); the two conversions
# agree to a few percent, which the refrender tests assert.


def _cie_fit(lam):
    def g(x, mu, s1, s2):
        s = s1 if x < mu else s2
        return math.exp(-0.5 * ((x - mu) / s) ** 2)

    x = (1.056 * g(lam, 599.8, 37.9, 31.0)
         + 0.362 * g(lam, 442.0, 16.0, 26.7)
         - 0.065 * g(lam, 501.1, 20.4, 26.2))
    y = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    z = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    return x, y, z


def blackbody_rgb(temperature_k, scale=1.0):
    """Independent normalized-Planck -> RGB (the ``"blackbody L" [T s]``
    scene parameter semantics: peak-normalized spectrum, scaled)."""
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23

    def planck(lam_m):
        return (2 * h * c * c) / (
            lam_m ** 5 * (math.exp(h * c / (lam_m * kb * temperature_k)) - 1.0)
        )

    # normalize by the Wien-peak emission (pbrt BlackbodyNormalized)
    lam_max = 2.8977721e-3 / temperature_k
    peak = planck(lam_max)
    X = Y = Z = ynorm = 0.0
    for nm in range(360, 831):
        le = planck(nm * 1e-9) / peak * scale
        cx, cy, cz = _cie_fit(float(nm))
        X += cx * le
        Y += cy * le
        Z += cz * le
        ynorm += cy
    X, Y, Z = X / ynorm, Y / ynorm, Z / ynorm
    # CIE XYZ -> linear sRGB (the device's spectrum.rs:129-145 matrix)
    r = 3.240479 * X - 1.537150 * Y - 0.498535 * Z
    g = -0.969256 * X + 1.875991 * Y + 0.041556 * Z
    b = 0.055648 * X - 0.204043 * Y + 1.057311 * Z
    return np.array([max(r, 0.0), max(g, 0.0), max(b, 0.0)])


# ---------------------------------------------------------------------------
# Lights
# ---------------------------------------------------------------------------


def _sample_light(scene, lt, p, u0, u1):
    """Returns (wi, Li, pdf, dist, is_delta)."""
    if lt["type"] == "point":
        to_l = np.asarray(lt["p"], np.float64) - p
        d2 = float(np.dot(to_l, to_l))
        dist = math.sqrt(d2)
        wi = to_l / dist
        return wi, np.asarray(lt["I"]) / d2, 1.0, dist, True
    if lt["type"] == "distant":
        wi = np.asarray(lt["dir"], np.float64)
        wi = wi / np.linalg.norm(wi)
        return wi, np.asarray(lt["L"], np.float64), 1.0, 1e7, True
    if lt["type"] == "infinite":
        wi = _uniform_sphere(u0, u1)
        return wi, np.asarray(lt["L"], np.float64), 1.0 / (4 * PI), INF_T, False
    # area: pick a triangle by area CDF, then uniform in the triangle
    cdf = lt["_cdf"]
    n_tris = len(lt["tris"])
    k = 0
    for j in range(1, n_tris):
        if u0 >= cdf[j]:
            k += 1
    c0, c1 = cdf[k], cdf[k + 1]
    du = (u0 - c0) / (c1 - c0) if c1 > c0 else 0.0
    x = (k + du) / n_tris
    frac = min(max(x * n_tris - k, 0.0), 0.999999)
    su = math.sqrt(frac)
    b0, b1 = 1.0 - su, u1 * su
    p0, p1, p2 = (np.asarray(q, np.float64) for q in lt["tris"][k])
    p_l = p0 + b0 * (p1 - p0) + b1 * (p2 - p0)
    n_l = np.cross(p1 - p0, p2 - p0)
    n_l = n_l / np.linalg.norm(n_l)
    to_l = p_l - p
    d2 = float(np.dot(to_l, to_l))
    dist = math.sqrt(d2)
    wi = to_l / max(dist, 1e-12)
    cos_l = max(float(np.dot(n_l, -wi)), 0.0)  # one-sided
    if cos_l <= 1e-7:
        return wi, np.zeros(3), 0.0, dist * (1 - 1e-3), False
    pdf = d2 / (cos_l * lt["_total_area"])
    return wi, np.asarray(lt["L"], np.float64), pdf, dist * (1 - 1e-3), False


def _light_pdf_for_dir(scene, lt, p, ng_hit, p_hit, wi):
    """Solid-angle pdf that _sample_light would have produced this hit."""
    if lt["type"] == "infinite":
        return 1.0 / (4 * PI)
    if lt["type"] == "area":
        to_l = p_hit - p
        d2 = float(np.dot(to_l, to_l))
        cos_l = abs(float(np.dot(ng_hit, -wi)))
        return d2 / max(cos_l * lt["_total_area"], 1e-9)
    return 0.0


# ---------------------------------------------------------------------------
# The recursive estimator
# ---------------------------------------------------------------------------


def _radiance(scene, o, d, U, max_depth, ray_diff=None):
    """One path.  ``U(dim)`` yields this lane's sampler value at ``dim`` —
    the dimension layout matches integrators/path.py exactly.
    ``ray_diff = (dxd, dyd)``: the +1px-offset camera-ray directions,
    used (bounce 0 only, like the device) for checker filter footprints."""
    L = np.zeros(3)
    beta = np.ones(3)
    specular = True
    prev_pdf = 1.0
    prev_p = o.copy()
    n_lights = len(scene.lights)
    for bounce in range(max_depth):
        base = 5 + 7 * bounce
        hit = _intersect(scene, o, d, INF_T)
        if hit is None:
            for lt in scene.lights:
                if lt["type"] == "infinite":
                    w = 1.0 if specular else _power_heuristic(
                        prev_pdf, (1.0 / (4 * PI)) / n_lights
                    )
                    L = L + beta * np.asarray(lt["L"], np.float64) * w
            return L
        t, p, ng, mat_id, light_id, tri, hb0, hb1 = hit
        uv = np.zeros(2)
        width = 0.0
        if tri is not None:
            uv0, uv1, uv2 = tri[5]
            uv = (1.0 - hb0 - hb1) * uv0 + hb0 * uv1 + hb1 * uv2
            if bounce == 0 and ray_diff is not None:
                width = _tri_tex_width(o, p, tri, ray_diff[0], ray_diff[1])
        wo = -d
        if light_id >= 0:
            lt = scene.lights[light_id]
            if float(np.dot(ng, wo)) > 0.0:  # one-sided emitter
                if specular:
                    w = 1.0
                else:
                    al_pdf = _light_pdf_for_dir(
                        scene, lt, prev_p, ng, p, d
                    ) / n_lights
                    w = _power_heuristic(prev_pdf, al_pdf)
                L = L + beta * np.asarray(lt["L"], np.float64) * w
        if bounce == max_depth - 1:
            return L
        mat = scene.materials[mat_id]
        ns = ng if float(np.dot(ng, wo)) >= 0.0 else -ng  # face-forward
        ss, ts = _frame(ns)

        def to_local(v):
            return np.array([np.dot(v, ss), np.dot(v, ts), np.dot(v, ns)])

        wo_l = to_local(wo)

        # --- NEE ---------------------------------------------------------
        if n_lights and mat["type"] == "matte":
            u_sel = U(base + 0)
            pick = min(int(u_sel * n_lights), n_lights - 1)
            lt = scene.lights[pick]
            wi, li, l_pdf, l_dist, delta = _sample_light(
                scene, lt, p, U(base + 1), U(base + 2)
            )
            l_pdf /= n_lights
            wi_l = to_local(wi)
            if l_pdf > 0 and li.max() > 0 and wi_l[2] * wo_l[2] > 0:
                f = _matte_kd(mat, uv, width) / PI
                b_pdf = abs(wi_l[2]) / PI
                sh_o = p + ng * SHADOW_EPS * np.sign(np.dot(wi, ng))
                if not _occluded(scene, sh_o, wi, l_dist - 2 * SHADOW_EPS):
                    w = 1.0 if delta else _power_heuristic(l_pdf, b_pdf)
                    L = L + beta * f * li * abs(wi_l[2]) * w / l_pdf
        elif n_lights:
            U(base + 0), U(base + 1), U(base + 2)  # keep dims aligned

        # --- BSDF sampling ----------------------------------------------
        u_lobe = U(base + 3)  # lobe select / glass Fresnel choice
        u0, u1 = U(base + 4), U(base + 5)
        if mat["type"] == "mirror":
            wi_l = np.array([-wo_l[0], -wo_l[1], wo_l[2]])
            f = np.asarray(mat["kr"], np.float64) / max(abs(wi_l[2]), 1e-9)
            pdf = 1.0
            spec = True
        elif mat["type"] == "glass":
            # smooth dielectric (device materials/bsdf.py glass candidate):
            # reflect w.p. F (or TIR), refract w.p. 1-F with the
            # radiance-transport eta_ratio^2 scale; branch pdf folds into
            # f, so beta *= kr (reflect) / kt * eta_ratio^2 (refract)
            eta = float(mat.get("eta", 1.5))
            outside = float(np.dot(ng, wo)) > 0.0  # unflipped normal side
            cos_signed = abs(wo_l[2]) if outside else -abs(wo_l[2])
            fr = _fresnel_dielectric(cos_signed, eta)
            eta_ratio = (1.0 / eta) if outside else eta
            wt = _refract_local(wo_l, eta_ratio)
            if u_lobe < fr or wt is None:
                wi_l = np.array([-wo_l[0], -wo_l[1], wo_l[2]])
                f = np.asarray(mat.get("kr", [1, 1, 1]), np.float64)
            else:
                wi_l = wt
                f = np.asarray(mat.get("kt", [1, 1, 1]), np.float64) * (
                    eta_ratio * eta_ratio
                )
            f = f / max(abs(wi_l[2]), 1e-9)
            pdf = 1.0
            spec = True
        else:
            wi_l = _cosine_hemisphere(u0, u1)
            if wo_l[2] < 0:
                wi_l[2] = -wi_l[2]
            f = _matte_kd(mat, uv, width) / PI
            pdf = abs(wi_l[2]) / PI
            spec = False
        if pdf <= 0 or f.max() <= 0:
            return L
        wi = wi_l[0] * ss + wi_l[1] * ts + wi_l[2] * ns
        beta = beta * f * abs(wi_l[2]) / pdf
        prev_p = p
        prev_pdf = pdf
        specular = spec
        o = p + ng * SHADOW_EPS * np.sign(np.dot(wi, ng))
        d = wi

        # --- Russian roulette -------------------------------------------
        if bounce > 3:
            q = max(0.05, 1.0 - float(beta.max()))
            if U(base + 6) < q:
                return L
            beta = beta / (1.0 - q)
        else:
            pass
    return L


def render_reference(scene, c2w, fov_deg, xres, yres, spp, max_depth,
                     sample_table):
    """Full-frame scalar render.

    ``sample_table[lane, dim]`` holds the shared deterministic sampler
    values with ``lane = (y * xres + x) * spp + s`` — produced by the
    caller from the production sampler so both renderers draw identical
    streams.  Returns an [yres, xres, 3] float image (box-filter mean of
    the spp samples, like the device film's dense path).
    """
    r2c = perspective_raster_to_camera(fov_deg, xres, yres)
    img = np.zeros((yres, xres, 3))
    # do any materials carry a checker Kd?  Mirrors the device's
    # _flags["tex_width"] gate: differentials exist only when a texture
    # will consume them
    needs_diff = any("checker" in m for m in scene.materials)

    def cam_dir(px, py):
        pc = r2c @ np.array([px, py, 0.0, 1.0])
        pc = pc[:3] / pc[3]
        d_cam = pc / np.linalg.norm(pc)
        d_w = c2w[:3, :3] @ d_cam
        return d_w / np.linalg.norm(d_w)

    for y in range(yres):
        for x in range(xres):
            acc = np.zeros(3)
            for s in range(spp):
                lane = (y * xres + x) * spp + s
                row = sample_table[lane]

                def U(dim, row=row):
                    return float(row[dim])

                px = x + U(0)
                py = y + U(1)
                o_w = c2w[:3, 3].copy()
                d_w = cam_dir(px, py)
                ray_diff = None
                if needs_diff:
                    # +1px offset rays (pbrt GenerateRayDifferential /
                    # integrators/path.py bounce-0 differentials)
                    ray_diff = (cam_dir(px + 1, py), cam_dir(px, py + 1))
                acc += _radiance(scene, o_w, d_w, U, max_depth, ray_diff)
            img[y, x] = acc / spp
    return img
