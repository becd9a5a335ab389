"""Motion blur, SPPM and the environment and realistic cameras on the card
against the CPU.  Every test here is marked ``cuda`` and skips without a
card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_motion.py -m cuda -q

Gates: K7 (``kernels/anim_walk.anim_walk``) against its plain version run
on the card on rotating soups of 3000 triangles in 1, 2 and 4 keys, on
sweeps of 1%, 50% and all lanes live and times on the keys, closest and
any hit, by phase 3's rules (hit masks equal, t within rtol 1e-6, prims
equal except on exact t ties, b0 and b1 within 2e-5 absolute), the dead
lanes answered by the prepass and the packed keyframe table equal to
the rows (:func:`check_k7_sweeps`, which the double file runs on the
double instance); images on
the card against the CPU to ``tests/test_torch_slice.py``'s tolerance
(image-mean relative difference <= 1e-3, >= 99% of pixels within rtol
1e-3 / atol 1e-4); MLT over the moving quad as
tests/test_torch_cuda_bdpt.py holds MLT.  torch and the port are imported only once a test
knows it has a card.
"""

import numpy as np
import pytest


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


def _same(label, got, want):
    assert np.isfinite(got).all() and got.max() > 0, label
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, (label, rel_mean)
    assert close >= 0.99, (label, close)


def _render(text, dev):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False, device=dev)
    api.init()
    api.parse_string(text)
    r = Renderer(api.scene, api.opt, device=dev)
    return r.image(r.render(progress=False))


def check_k7_sweeps(torch, float_t, rtol):
    """K7's instance for ``float_t`` against its plain version run on the
    card, on a rotating soup of 3000 triangles in K = 1, 2 and 4 keys (over
    30 degrees; one key stands still): the packed table read back equal to
    the [T, K, 9] rows; sweeps of 16,384 rays (K = 1, 2) and 524,288 (K =
    4, so that the dense sweeps walk a ray a lane and the sparse ones 4
    lanes a ray: both occur) with 1%, 50% and 100% of the lanes live,
    every 5th lane's time exactly on a key (0 and 1 among them), the dead
    lanes at t_max 0, RAY_EPS, 5e-5 and -1; closest and any hit: one launch
    of that instance a sweep, its prepass listing exactly the live lanes,
    each dead lane answered (t_max, -1, 0, 0), and the results within
    ``anim_disagreement``'s rules (t within ``rtol``)."""
    from pbrt_tpu_torch.kernels import anim_walk
    from pbrt_tpu_torch.ops.animated_intersect import AnimatedTriIntersector
    from pbrt_tpu_torch.shapes import TriangleData

    dt = torch.float64 if float_t == np.float64 else torch.float32
    name = "anim_walk_f64" if float_t == np.float64 else "anim_walk"
    rng = np.random.default_rng(0)
    c = rng.uniform(-1, 1, (3000, 3))
    tri = [c, c + rng.uniform(-0.1, 0.1, (3000, 3)), c + rng.uniform(-0.1, 0.1, (3000, 3))]
    lanes_seen = set()
    for n_keys in (1, 2, 4):
        n = 1 << 19 if n_keys == 4 else 1 << 14
        keys = []
        for a in np.radians(np.linspace(0.0, 30.0, n_keys)):
            m = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            p = [(v @ m.T).astype(float_t) for v in tri]
            z = np.zeros((3000, 2), float_t)
            keys.append(TriangleData(p[0], p[1], p[2], z, z, z))
        itx = AnimatedTriIntersector(keys, device="cuda")
        assert itx.cols.dtype == itx.packed.dtype == dt and itx.cols.shape[1] == n_keys
        assert itx.packed.shape == (3000, n_keys, anim_walk.ROW_PAD[dt])
        assert torch.equal(itx.packed[..., :9], itx.cols) and not itx.packed[..., 9:].any()
        for share in (0.01, 0.5, 1.0):
            o = torch.as_tensor(rng.uniform(-1.5, 1.5, (n, 3)).astype(float_t), device="cuda")
            d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda", dtype=dt), dim=-1)
            t_max = rng.uniform(0.05, 4.0, n).astype(float_t)
            dead = rng.uniform(size=n) >= share
            t_max[dead] = rng.choice(np.array([0.0, 1e-4, 5e-5, -1.0], float_t), int(dead.sum()))
            time = rng.uniform(0, 1, n).astype(float_t)
            time[::5] = rng.integers(0, n_keys, len(time[::5])) / max(n_keys - 1, 1)
            time[:2] = (0.0, 1.0)
            t_max, time = (torch.as_tensor(x, device="cuda") for x in (t_max, time))
            comps = tuple(x.contiguous() for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                                                   d[:, 2], t_max))
            host = [x.cpu().numpy() for x in (o, d, time)]
            live = int((t_max > 1e-4).sum())
            for any_hit in (False, True):
                anim_walk.reset_launch_counts()
                got = anim_walk.anim_walk(itx.bvh["nodes_f"], itx.bvh["nodes_i"], itx.cols,
                                          itx.packed, comps, time, any_hit)
                torch.cuda.synchronize()
                assert anim_walk.LAUNCHES == {k: int(k == name) for k in anim_walk.LAUNCHES}
                stats = anim_walk.task_stats()
                assert stats["live_rays"] == live
                lanes_seen.add(stats["lanes_per_ray"])
                assert got[0].dtype == dt
                want = anim_walk.anim_walk_plain(itx.bvh["nodes_f"], itx.bvh["nodes_i"],
                                                 itx.cols, comps, time, any_hit)
                got, want = ([x.cpu().numpy() for x in v] for v in (got, want))
                label = (n_keys, share, any_hit)
                problem = anim_walk.anim_disagreement(got, want, itx.cols.cpu().numpy(), *host,
                                                      any_hit, rtol=rtol)
                assert problem is None, (label, problem)
                gone = ~(t_max > 1e-4).cpu().numpy()
                np.testing.assert_array_equal(got[0][gone], t_max.cpu().numpy()[gone])
                assert (got[1][gone] == -1).all() and not got[2][gone].any()
                assert not got[3][gone].any()
                if share == 1.0:
                    assert 0.1 < float((want[1] >= 0).mean()) < 0.9, label
    assert lanes_seen == {1, 4}, lanes_seen


@pytest.mark.cuda
def test_anim_walk_kernel_matches_plain():
    """:func:`check_k7_sweeps` on the float instance (t within rtol 1e-6,
    b0 and b1 within 2e-5)."""
    check_k7_sweeps(_need_card(), np.float32, 1e-6)


@pytest.mark.cuda
def test_motion_sppm_and_cameras_card_match_cpu():
    """The moving quad under path (a moving camera), volpath, bdpt and
    sppm, a moving tessellated sphere (K7), and the open box under the
    environment and realistic cameras: each 16x16 image on the card
    against the CPU."""
    _need_card()
    from pbrt_tpu_torch.kernels import anim_walk
    from pbrt_tpu_torch.testscenes import (
        CAMERA_MOVE,
        MOVING_SPHERE,
        gi_box_text,
        motion_quad_text,
    )

    sppm = '"integer numiterations" 2 "integer photonsperiteration" 2048'
    box = gi_box_text("path", 16, 16, 4, 3)
    cam = 'Camera "perspective" "float fov" 60'
    scenes = {
        "path, moving camera": motion_quad_text("path", camera_motion=CAMERA_MOVE),
        "volpath": motion_quad_text("volpath"),
        "bdpt": motion_quad_text("bdpt"),
        "sppm": motion_quad_text("sppm", extra=sppm),
        "moving sphere": motion_quad_text("path", sphere=MOVING_SPHERE),
        "environment camera": box.replace(cam, 'Camera "environment"'),
        "realistic camera": box.replace(cam, 'Camera "realistic" "string lensfile" '
                                        '"biconvex-50mm-f8" "float focusdistance" 4'),
    }
    for label, text in scenes.items():
        anim_walk.reset_launch_counts()
        card = _render(text, "cuda")
        if label == "moving sphere":
            assert anim_walk.LAUNCHES["anim_walk"] > 0
        _same(label, card, _render(text, "cpu"))


@pytest.mark.cuda
def test_motion_mlt_card_matches_cpu():
    """MLT over the moving quad (the shutter time from the primary-sample
    table's dimension 4): one evaluation of a seeded 1,024-lane table and
    the bootstrap b card against CPU, the image's mean within rtol 0.15 and
    the acceptance rate within 0.05, as tests/test_torch_cuda_bdpt.py holds
    MLT's."""
    torch = _need_card()
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import motion_quad_text

    text = motion_quad_text("mlt", spp=1, extra='"integer mutationsperpixel" 4')
    out = {}
    for dev in ("cuda", "cpu"):
        api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False, device=dev)
        api.init()
        api.parse_string(text)
        r = Renderer(api.scene, api.opt, device=dev)
        mlt = r.integrator
        u = np.random.default_rng(2).uniform(size=(1024, mlt.n_dims)).astype(np.float32)
        with torch.no_grad():
            ev = mlt._evaluate(torch.as_tensor(u, device=dev), r.film)
        img = r.image(r.render(progress=False))
        out[dev] = ([x.cpu().numpy() for x in ev[:3]], img, mlt.last_b, mlt.last_acceptance)
    (ev_g, img_g, b_g, acc_g), (ev_w, img_w, b_w, acc_w) = out["cuda"], out["cpu"]
    for g, w in zip(ev_g, ev_w):
        assert abs(g.mean() - w.mean()) <= 1e-3 * abs(w.mean())
        assert np.isclose(g, w, rtol=1e-3, atol=1e-4).mean() >= 0.99
    assert ev_w[2].max() > 0
    np.testing.assert_allclose(b_g, b_w, rtol=1e-4)
    assert np.isfinite(img_g).all() and img_g.max() > 0
    np.testing.assert_allclose(img_g.mean(), img_w.mean(), rtol=0.15)
    assert abs(acc_g - acc_w) <= 0.05
