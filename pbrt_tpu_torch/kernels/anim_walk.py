"""The keyframed skip-link walk of motion blur: a CUDA kernel and its plain
PyTorch version.

:func:`anim_walk` (K7) wraps ``anim_prep_kernel`` and
``anim_walk_kernel`` in ``csrc/anim_walk.cu``, which do what
``pbrt_tpu/ops/animated_intersect.py:176 _bvh_walk`` does (a
``jax.lax.while_loop``; the reference has no Pallas kernel for it): each
ray walks the skip-link BVH of shutter-union boxes
(``ops/pallas_bvh.pack_skip_tables``' node layout: box rows [M, 8] f32,
(skip, first, count) rows [M, 4] i32) and tests each leaf triangle
blended from its K keyframe rows with the lane's hat weights.  The prepass
answers the dead lanes and lists the live ones; a persistent grid walks
the list, R rays a warp's task (:func:`task_stats` reads what the last
launch found; a sparse sweep gives each ray a group of lanes that test a
leaf's triangles at once), and reads the keyframe rows from the packed table of
:func:`pack_keys` (each key padded to whole 16-byte vectors), which an
intersector makes once.

The kernel has two instances (``anim_walk_kernel<T>``): float for the
default policy, double for the double policy, where the keyframe rows, the
rays and the shutter times are float64 (the reference takes the hat
weights, blends and tests in float64 there); the node boxes are float32
in both.  The wrapper picks the instance from the keyframe rows' dtype.

The wrapper runs :func:`anim_walk_plain` only because its tensors lie on
the CPU; on CUDA tensors it launches the kernel or raises.  The plain
version is the reference's walk step by step.  Its blend and its
Moller-Trumbore test fuse products into sums as the reference's compiled
code does (the blend: w_0 c_0, then one fused multiply-add per key; the
test: ``tri_test``), which on a 3-key soup takes the share of hits whose
t is bit-equal to the reference's from 38% to 98% (plain float32
roundings against fused ones, tests/test_torch_motion.py's soup).  The
plain version fuses in float64 (``core/geometry.fma``), the kernel with
``fmaf``, over the keys of non-zero weight only (a zero weight adds an
exact zero), so the two agree but where float64's double rounding of a
fused result differs from ``fmaf``'s single one.  In double the plain
version cannot fuse (no wider type) and the kernel fuses with ``fma``:
they agree to the last bits of a double (:func:`anim_disagreement` with
``rtol`` 1e-12, b0 and b1 within 1e-9).  ``LAUNCHES`` counts wrapper calls that launched each
instance.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pbrt_tpu_torch.core.geometry import fma
from pbrt_tpu_torch.kernels import build
from pbrt_tpu_torch.kernels.bvh8_walk import RAY_EPS, check_rays, init_counters, safe_inv

LAUNCHES = {"anim_walk": 0, "anim_walk_f64": 0}  # K7<float>, K7<double>
# values a key's row of the packed table holds: 9, padded to whole 16-byte
# vectors (three float4, five double2)
ROW_PAD = {torch.float32: 12, torch.float64: 10}

_lib = None
_last_scratch = None  # (scratch, rays) of the last launch (task_stats)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_library():
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    if _lib is None:
        lib = build.load("anim_walk")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.launch_anim_walk, lib.launch_anim_walk_f64):
            fn.argtypes = [p] * 16 + [i] * 5 + [p]
            fn.restype = i
        _lib = lib
    return _lib


def time_weights(time_norm, n_keys: int):
    """[N] normalized times -> [N, K] hat weights max(0, 1 - |t (K-1) - k|)
    (``pbrt_tpu/ops/animated_intersect.py:30``)."""
    x = torch.clamp(time_norm, 0.0, 1.0) * (n_keys - 1)
    k = torch.arange(n_keys, dtype=time_norm.dtype, device=time_norm.device)
    return torch.clamp(1.0 - torch.abs(x[:, None] - k), min=0.0)


def key_pair(time_norm, n_keys: int):
    """The kernel's search for a lane's keys of non-zero hat weight, in
    PyTorch: [N] normalized times -> (ka [N] int64, wa, wb): the keys
    floor(x) (clamped to K - 1) and floor(x) + 1 either side of x = t (K -
    1), with :func:`time_weights`' expression for each (wb = 0 where key
    ka + 1 is past the last); every other key's weight is 0."""
    x = torch.clamp(time_norm, 0.0, 1.0) * (n_keys - 1)
    ka = torch.clamp(torch.floor(x), max=n_keys - 1)
    wa = torch.clamp(1.0 - torch.abs(x - ka), min=0.0)
    wb = torch.where(ka + 1 < n_keys, torch.clamp(1.0 - torch.abs(x - (ka + 1)), min=0.0), 0.0)
    return ka.long(), wa, wb


def pack_keys(keys):
    """[T, K, 9] keyframe rows -> the kernel's table [T, K, ROW_PAD]: each
    key's 9 values, then zeros to whole 16-byte vectors (12 float32 or 10
    float64), contiguous, so that the two adjacent keys of a lane are one
    aligned run of bytes.  ``keys[..., :9]`` of it is ``keys``."""
    pad = ROW_PAD[keys.dtype]
    packed = torch.zeros(keys.shape[:2] + (pad,), dtype=keys.dtype, device=keys.device)
    packed[..., :9] = keys
    return packed


def task_stats():
    """What the last :func:`anim_walk` launch found on the card: its live
    rays, the resident warps of its grid, and the rays per task and lanes
    per ray it chose (synchronises)."""
    scratch, n = _last_scratch
    live, _, warps, rays, lanes = scratch[n:n + 5].tolist()
    return {"live_rays": live, "resident_warps": warps, "rays_per_task": rays,
            "lanes_per_ray": lanes}


def anim_walk(nodes_f, nodes_i, keys, packed, comps, time, any_hit=False):
    """Keyframed skip-link walk (K7): nodes_f [M, 8] f32, nodes_i [M, 4]
    i32 (skip, first, count), keys [T, K, 9] f32 or f64 (each triangle's
    p0 p1 p2 at the K keyframes, in the tree's order) and ``packed``, its
    :func:`pack_keys` table (what the kernel reads; the plain version
    reads ``keys``), comps = 7 [N] ray columns (ox oy oz dx dy dz t_max)
    and time [N] in [0, 1], all of the keys' dtype.  Returns (t, prim, b0,
    b1) [N] (t, b0, b1 in the keys' dtype): prim the triangle's index in
    the tree's order, -1 = miss; a miss keeps its t_max.  ``any_hit``:
    stop at the first hit (only the mask is then meaningful).  f64 keys
    take the kernel's double instance."""
    global _last_scratch
    if nodes_f.device.type == "cpu":
        return anim_walk_plain(nodes_f, nodes_i, keys, comps, time, any_hit)
    dev = nodes_f.device
    if dev.type != "cuda":
        raise ValueError(f"anim_walk: unsupported device {dev}")
    dt = keys.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"keys: expected torch.float32 or torch.float64, got {dt}")
    build.check_tensor("nodes_f", nodes_f, torch.float32, dev, 2)
    build.check_tensor("nodes_i", nodes_i, torch.int32, dev, 2)
    build.check_tensor("keys", keys, dt, dev, 3)
    build.check_tensor("packed", packed, dt, dev, 3)
    build.check_tensor("time", time, dt, dev, 1)
    n = check_rays(comps, dev, dt)
    m, (t, k, nine) = nodes_f.shape[0], keys.shape
    if nodes_f.shape[1] != 8 or nodes_i.shape != (m, 4) or nine != 9 or t == 0:
        raise ValueError("anim_walk: expected [M,8] nodes_f, [M,4] nodes_i, [T,K,9] keys")
    if packed.shape != (t, k, ROW_PAD[dt]):
        raise ValueError(f"anim_walk: expected the [T,K,{ROW_PAD[dt]}] packed table of keys, "
                         f"got {tuple(packed.shape)}")
    if k < 1:
        raise ValueError("anim_walk: no keyframes")
    if time.shape[0] != n:
        raise ValueError(f"anim_walk: expected {n} times, got {time.shape[0]}")
    for name, x in (("nodes_f", nodes_f), ("nodes_i", nodes_i), ("packed", packed)):
        build.check_aligned(name, x)
    lib = load_library()
    double = dt == torch.float64
    t_out = torch.empty(n, dtype=dt, device=dev)
    prim_out = torch.empty(n, dtype=torch.int32, device=dev)
    b0_out = torch.empty(n, dtype=dt, device=dev)
    b1_out = torch.empty(n, dtype=dt, device=dev)
    scratch = torch.empty(n + 5, dtype=torch.int32, device=dev)  # the list, the header
    build.launch_checked(
        lib, lib.launch_anim_walk_f64 if double else lib.launch_anim_walk,
        nodes_f.data_ptr(), nodes_i.data_ptr(), packed.data_ptr(),
        *[c.data_ptr() for c in comps], time.data_ptr(), t_out.data_ptr(),
        prim_out.data_ptr(), b0_out.data_ptr(), b1_out.data_ptr(), scratch.data_ptr(), n, m,
        t, k, int(any_hit), torch.cuda.current_stream(dev).cuda_stream,
    )
    _last_scratch = (scratch, n)
    LAUNCHES["anim_walk_f64" if double else "anim_walk"] += 1
    return t_out, prim_out, b0_out, b1_out


def blend(keys, w):
    """[L, K, 9] keyframe rows and [L, K] weights -> [L, 9]: w_0 c_0, then
    one fused multiply-add per further key (``core/geometry.fma``)."""
    acc = w[:, 0:1] * keys[:, 0]
    for k in range(1, keys.shape[1]):
        acc = fma(w[:, k:k + 1], keys[:, k], acc)
    return acc


def tri_test(v, o, d, best_t):
    """Moller-Trumbore of [L, 9] blended triangles against [L, 3] rays ->
    (ok, t, b0, b1), its products fused into the sums as the reference's
    compiled code fuses them: a*b - c*d as fma(a, b, -(c d)), x . y as
    fma(x2, y2, fma(x0, y0, x1 y1))."""
    p0 = v[:, 0:3]
    e1 = v[:, 3:6] - p0
    e2 = v[:, 6:9] - p0

    def cross(a, b):
        return [fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))]

    def dot(a, b):
        return fma(a[2], b[2], fma(a[0], b[0], a[1] * b[1]))

    def cols(x):
        return [x[:, 0], x[:, 1], x[:, 2]]

    pv = cross(d, e2)
    det = dot(cols(e1), pv)
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tv = o - p0
    b0 = dot(cols(tv), pv) * inv_det
    qv = cross(tv, e1)
    b1 = dot(cols(d), qv) * inv_det
    tt = dot(cols(e2), qv) * inv_det
    ok = (det_ok & (b0 >= 0.0) & (b1 >= 0.0) & (b0 + b1 <= 1.0)
          & (tt > RAY_EPS) & (tt < best_t))
    return ok, tt, b0, b1


def anim_walk_plain(nodes_f, nodes_i, keys, comps, time, any_hit=False, counters=None):
    """Plain version of :func:`anim_walk` (same arguments, any device):
    the reference's ``_bvh_walk`` per lane, over the lanes still walking.
    ``counters`` (``bvh8_walk.init_counters``) counts node rows as skip
    nodes and triangles' keyframe rows as leaf rows."""
    ox, oy, oz, dx, dy, dz, t_max = comps
    dev = t_max.device
    n = t_max.shape[0]
    m, n_tris, n_keys = nodes_f.shape[0], keys.shape[0], keys.shape[1]
    if counters is not None:
        init_counters(counters, m, n_tris, dev)
    o = torch.stack([ox, oy, oz], dim=1)
    d = torch.stack([dx, dy, dz], dim=1)
    inv = torch.stack([safe_inv(dx), safe_inv(dy), safe_inv(dz)], dim=1)
    w_all = time_weights(time, n_keys)
    best_t = t_max.clone()
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b0a = torch.zeros(n, dtype=t_max.dtype, device=dev)
    b1a = torch.zeros(n, dtype=t_max.dtype, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    # a lane with t_max <= RAY_EPS cannot hit: its walk changes nothing
    live = t_max > RAY_EPS
    ni_all = nodes_i.long()
    while True:
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        nd = node[idx]
        ni = ni_all[nd]
        skip, first, count = ni[:, 0], ni[:, 1], ni[:, 2]
        lo, bt = o[idx], best_t[idx]
        t0 = (nodes_f[nd, 0:3] - lo) * inv[idx]
        t1 = (nodes_f[nd, 3:6] - lo) * inv[idx]
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        box = (tn <= tf) & (tf > RAY_EPS) & (tn < bt)
        if counters is not None:
            counters["slab_tests"] += len(idx)
            counters["node_seen"][nd] = True
        leaf = box & (count > 0)
        if leaf.any():
            li = idx[leaf]
            lo, ld, w = o[li], d[li], w_all[li]
            bt, bp = best_t[li], best_prim[li]
            b0l, b1l = b0a[li], b1a[li]
            lf, lc = first[leaf], count[leaf]
            # the leaf's triangles blended and tested at once (the test
            # but for ``t < best_t``, which the sequential pass below takes)
            nk = int(lc.max())
            kk = torch.arange(nk, device=dev)
            pids = torch.clamp(lf[:, None] + kk, max=n_tris - 1)  # [L, nk]
            in_leaf = kk < lc[:, None]
            flat = pids.reshape(-1)
            ok_all, tt_all, b0_all, b1_all = (
                x.reshape(-1, nk) for x in tri_test(
                    blend(keys[flat], w.repeat_interleave(nk, dim=0)),
                    lo.repeat_interleave(nk, dim=0), ld.repeat_interleave(nk, dim=0),
                    torch.full((len(flat),), torch.inf, dtype=t_max.dtype, device=dev)))
            if counters is not None:
                counters["tri_tests"] += int(in_leaf.sum())
                counters["leaf_seen"][pids[in_leaf]] = True
            for k in range(nk):
                ok = ok_all[:, k] & in_leaf[:, k] & (tt_all[:, k] < bt)
                bp = torch.where(ok, pids[:, k], bp)
                b0l = torch.where(ok, b0_all[:, k], b0l)
                b1l = torch.where(ok, b1_all[:, k], b1l)
                bt = torch.where(ok, tt_all[:, k], bt)
            best_t[li], best_prim[li], b0a[li], b1a[li] = bt, bp, b0l, b1l
        nxt = torch.where(box & (count == 0), nd + 1, skip)
        node[idx] = nxt
        stop = nxt >= m
        if any_hit:
            stop = stop | (best_prim[idx] >= 0)
        live[idx[stop]] = False
    return best_t, best_prim.to(torch.int32), b0a, b1a


# how far b0 and b1 may part where two K7 results hit the same prim, by
# the float of t: float32's bound admits a few hundred ulps of float32; a
# double walk whose barycentrics were taken in float32 (errors ~1e-7)
# fails float64's
B_ATOL = {np.dtype(np.float32): 2e-5, np.dtype(np.float64): 1e-9}


def anim_disagreement(got, want, keys, o, d, time, any_hit, rtol=1e-6):
    """How two K7 results (t, prim, b0, b1 as numpy arrays; prims in the
    tree's order) may differ: hit masks equal (any hit: nothing else is
    compared); t within ``rtol`` on hits and equal on misses; prims equal
    wherever the other prim, blended at the lane's time, does not hit
    within ``rtol`` of t (an exact t tie); b0 and b1 within
    ``B_ATOL[t.dtype]`` absolute where the prims agree.  Returns None when
    they agree, else a description."""
    t_a, p_a, b0_a, b1_a = got
    t_b, p_b, b0_b, b1_b = want
    hit = p_b >= 0
    if not np.array_equal(hit, p_a >= 0):
        return f"hit masks differ on {int((hit != (p_a >= 0)).sum())} lanes"
    if any_hit:
        return None
    if not np.allclose(t_a[hit], t_b[hit], rtol=rtol, atol=0.0):
        return f"t differs beyond rtol {rtol}"
    if not np.array_equal(t_a[~hit], t_b[~hit]):
        return "t of missing lanes differs"
    diff = np.nonzero(hit & (p_a != p_b))[0]
    if len(diff):
        w = time_weights(torch.as_tensor(time[diff]), keys.shape[1])
        v = blend(torch.as_tensor(keys[p_a[diff]]), w)
        far = torch.full((len(diff),), 1e30)
        ok, tt, _, _ = tri_test(v, torch.as_tensor(o[diff]), torch.as_tensor(d[diff]), far)
        tie = ok.numpy() & np.isclose(tt.numpy(), t_b[diff], rtol=rtol, atol=0.0)
        if not tie.all():
            return f"prims differ on {int((~tie).sum())} lanes that are not exact t ties"
    same = hit & (p_a == p_b)
    b_atol = B_ATOL[np.dtype(t_b.dtype)]
    for name, a, b in (("b0", b0_a, b0_b), ("b1", b1_a, b1_b)):
        if same.any() and np.abs(a[same] - b[same]).max() > b_atol:
            return f"{name} differs beyond {b_atol}"
    return None


def max_b_diff(got, want):
    """max |b0|, |b1| difference of two K7 results over the lanes where
    both hit the same prim (0.0 where there are none)."""
    same = (want[1] >= 0) & (got[1] == want[1])
    if not same.any():
        return 0.0
    return float(max(np.abs(got[i][same] - want[i][same]).max() for i in (2, 3)))
