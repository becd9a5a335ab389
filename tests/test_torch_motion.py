"""Motion blur in pbrt_tpu_torch against the JAX reference on the CPU.

* Keyframes: ``AnimatedTransform``'s key transforms (translation,
  rotation, rotation with scale) within rtol 1e-12 and its key counts
  equal; ``time_weights`` bit-equal; the builder's ``tri_keys`` tables,
  ``animated_keys`` flag and camera keyframes equal to the reference's for
  the same scene text (a moving quad, a moving tessellated sphere, a
  moving camera).
* The keyframed intersector on a 3-key rotating soup of 100 triangles
  (the shutter-union BVH walk: ``kernels/anim_walk.anim_walk_plain``;
  its skip-link tables and permutation equal to the reference's) and of
  40 (the brute-force sweep), random rays at random times against the
  reference's ``AnimatedTriIntersector``: hit masks equal, t within rtol
  1e-5, prims equal except on exact t ties, b0 and b1 within 2e-5
  absolute; occlusion masks equal.
* K7's host-side pieces, with no reference: ``pack_keys``' table read back
  equal to the [T, K, 9] rows with zero padding (float32 and float64), and
  the kernel's two-key search (``key_pair``) giving ``time_weights``'
  weights bit for bit at K = 1, 2, 3, 4 and 7, times on the keys and the
  ends included, every other key's weight 0.
* 16x16 renders of tests/test_motion_integrators.py's moving quad under
  ``path`` and ``sppm`` and of a moving camera under ``path``, to the
  image tolerance of the other scene tests (image-mean relative
  difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol 1e-4).
* The moving quad under ``mlt``, whose BDPT target reads the shutter
  time from dimension 4 of the primary-sample table: one evaluation of a
  seeded 1,024-lane table, and of the same table with every time at the
  shutter's open and at its close, against the reference's to the image
  tolerance (the two ends differ); the port's render's bootstrap b within
  rtol 1e-4 of the reference's target's mean over the same tables.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.render import Renderer as RefRenderer


def _renderers(text):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    api = RefAPI(RefOptions(ray_batch=1 << 14), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    port_api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False, device="cpu")
    port_api.init()
    port_api.parse_string(text)
    return (RefRenderer(api.scene, api.opt),
            Renderer(port_api.scene, port_api.opt, device="cpu"))


def test_keyframes_time_weights_and_tables_against_reference():
    import torch

    from pbrt_tpu.core.animated import AnimatedTransform as RefAT
    from pbrt_tpu.core.transform import Transform as RefTransform
    from pbrt_tpu.ops.animated_intersect import time_weights as ref_time_weights
    from pbrt_tpu_torch.core.animated import AnimatedTransform
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.kernels.anim_walk import time_weights
    from pbrt_tpu_torch.testscenes import CAMERA_MOVE, MOVING_SPHERE, motion_quad_text

    base = Transform.translate([0.3, -0.2, 1.0]) * Transform.rotate(20, [0, 1, 1])
    ends = {"translate": Transform.translate([1.5, 0.0, 0.2]) * base,
            "rotate": Transform.rotate(75, [0.2, 0.3, 1.0]) * base,
            "rotate_scale": (Transform.scale(1.3, 0.8, 1.1) * Transform.rotate(200, [1, 0, 0])
                             * base)}
    for label, end in ends.items():
        at = AnimatedTransform(base, end, 0.0, 1.0)
        ref = RefAT(RefTransform(base.m), RefTransform(end.m), 0.0, 1.0)
        assert at.n_keys() == ref.n_keys(), label
        assert at.actually_animated and at.n_keys() >= 2
        for got, want in zip(at.key_transforms(0.1, 0.9), ref.key_transforms(0.1, 0.9)):
            np.testing.assert_allclose(got.m, want.m, rtol=1e-12, atol=1e-12, err_msg=label)

    t = np.random.default_rng(3).uniform(-0.2, 1.2, 4096).astype(np.float32)
    t[:5] = [0.0, 1.0, 0.5, 1.0 / 3.0, 2.0 / 3.0]
    for k in (1, 2, 3, 4, 9):
        want = np.asarray(ref_time_weights(jnp.asarray(t), k))
        got = time_weights(torch.as_tensor(t), k).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

    for label, text in (("quad", motion_quad_text()),
                        ("sphere", motion_quad_text(motion="", sphere=MOVING_SPHERE)),
                        ("camera", motion_quad_text(motion="", camera_motion=CAMERA_MOVE))):
        ref, port = _renderers(text)
        rt, pt = ref.compiled.tables, port.compiled.tables
        assert pt["_flags"]["animated_keys"] == rt["_flags"]["animated_keys"], label
        assert ("tri_keys" in pt) == ("tri_keys" in rt) == (label != "camera")
        for got, want in zip(pt.get("tri_keys", []), rt.get("tri_keys", [])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=label)
        if label == "camera":
            np.testing.assert_array_equal(port.camera._anim_c2w.numpy(),
                                          np.asarray(ref.camera._anim_c2w))
        else:
            assert type(port.compiled.intersector).__name__ == "AnimatedIntersector"


def _soup(n_tri, seed):
    """A 3-key soup: n_tri triangles turning 40 degrees about z across the
    shutter, as (port, reference) key lists of objects with p0 p1 p2."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n_tri, 3))
    tri = [c, c + rng.uniform(-0.6, 0.6, (n_tri, 3)), c + rng.uniform(-0.6, 0.6, (n_tri, 3))]
    keys = []
    for a in np.radians([0.0, 20.0, 40.0]):
        m = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        p = [(v @ m.T + [0.1 * a, 0, 0]).astype(np.float32) for v in tri]
        keys.append(types.SimpleNamespace(p0=p[0], p1=p[1], p2=p[2], count=n_tri))
    return keys


@pytest.mark.parametrize("n_tri", [100, 40])
def test_keyframed_intersector_against_reference(n_tri):
    import torch

    from pbrt_tpu.ops.animated_intersect import AnimatedTriIntersector as RefAnim
    from pbrt_tpu_torch.kernels.anim_walk import anim_disagreement
    from pbrt_tpu_torch.ops.animated_intersect import AnimatedTriIntersector

    keys = _soup(n_tri, n_tri)
    ref = RefAnim(keys)
    port = AnimatedTriIntersector(keys, device="cpu")
    assert (ref._bvh is None) == (port.bvh is None) == (n_tri < 64)
    if port.bvh is not None:
        nf, ni = port.bvh["nodes_f"].numpy(), port.bvh["nodes_i"].numpy()
        np.testing.assert_array_equal(nf[:, 0:3], np.asarray(ref._bvh["min"]))
        np.testing.assert_array_equal(nf[:, 3:6], np.asarray(ref._bvh["max"]))
        for col, name in enumerate(("skip", "first", "count")):
            np.testing.assert_array_equal(ni[:, col], np.asarray(ref._bvh[name]))
        np.testing.assert_array_equal(port.bvh["perm"].numpy(), np.asarray(ref._bvh["perm"]))
    np.testing.assert_array_equal(port.cols.numpy(), np.asarray(ref.cols))

    rng = np.random.default_rng(7)
    n = 4096
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = (rng.uniform(-1, 1, (n, 3)) * 0.6 - o / np.linalg.norm(o, axis=1, keepdims=True))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = rng.uniform(0.5, 6.0, n).astype(np.float32)
    t_max[::97] = 0.0
    time = rng.uniform(0, 1, n).astype(np.float32)
    want = ref.intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(time))
    got = port.intersect(*(torch.as_tensor(x) for x in (o, d, t_max, time)))
    hit = np.asarray(want["hit"])
    assert 0.15 < hit.mean() < 0.9
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(want["t"]), rtol=1e-5)
    # prims as the walk's order (ties are judged there)
    inv = np.argsort(port.bvh["perm"].numpy()) if port.bvh is not None else np.arange(n_tri)
    res = [(got["t"].numpy(), np.where(hit, inv[got["prim"].numpy()], -1),
            got["b0"].numpy(), got["b1"].numpy()),
           (np.asarray(want["t"]), np.where(hit, inv[np.asarray(want["prim"])], -1),
            np.asarray(want["b0"]), np.asarray(want["b1"]))]
    problem = anim_disagreement(*res, port.cols.numpy(), o, d, time, any_hit=False, rtol=1e-5)
    assert problem is None, problem
    occ = port.occluded(*(torch.as_tensor(x) for x in (o, d, t_max, time))).numpy()
    np.testing.assert_array_equal(occ, hit)


@pytest.mark.parametrize("case", ["path", "camera", "sppm"])
def test_motion_render_against_reference(case):
    from pbrt_tpu_torch.testscenes import CAMERA_MOVE, motion_quad_text

    text = {"path": motion_quad_text("path"),
            "camera": motion_quad_text("path", motion="Translate 0.3 0 0",
                                       camera_motion=CAMERA_MOVE),
            "sppm": motion_quad_text("sppm", extra='"integer numiterations" 2 '
                                     '"integer photonsperiteration" 2048')}[case]
    ref, port = _renderers(text)
    want = np.asarray(ref.film.to_rgb(ref.render(progress=False)))
    got = port.image(port.render(progress=False))
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    print(f"{case}: mean {got.mean():.6f} (reference {want.mean():.6f}), mean rel diff "
          f"{rel_mean:.3e}, {close:.4f} of pixels close")
    assert rel_mean <= 1e-3 and close >= 0.99


def test_motion_mlt_evaluate_against_reference():
    import jax
    import torch

    from pbrt_tpu_torch.testscenes import motion_quad_text

    text = motion_quad_text("mlt", spp=1, extra='"integer mutationsperpixel" 2 '
                            '"integer bootstrapsamples" 2048')
    ref, port = _renderers(text)
    ri, pi = ref.integrator, port.integrator
    assert pi.n_dims == ri.n_dims and pi._bdpt is not None
    evaluate = jax.jit(lambda u: ri._evaluate(u, ref.film))
    u = np.random.default_rng(5).uniform(size=(1024, ri.n_dims)).astype(np.float32)
    ends = []
    for label, t in (("seeded", None), ("open", 0.0), ("close", 0.999)):
        if t is not None:
            u = u.copy()
            u[:, 4] = t
        want = evaluate(u)
        with torch.no_grad():
            got = pi._evaluate(torch.as_tensor(u), port.film)
        for name, g, w in zip(("p_film", "L", "f"), got[:3], want[:3]):
            g, w = g.numpy(), np.asarray(w)
            close = np.isclose(g, w, rtol=1e-3, atol=1e-4).mean()
            rel_mean = abs(g.mean() - w.mean()) / abs(w.mean())
            print(f"{label} {name}: mean rel diff {rel_mean:.3e}, {close:.4f} close")
            assert rel_mean <= 1e-3 and close >= 0.99, (label, name)
        ends.append(got[2].numpy())
    # the quad moves 1.5 across the shutter: the time changes the target
    assert (ends[1] > 0).any() and not np.allclose(ends[1], ends[2])

    boot = [evaluate(ri._uniform(1024, ri.n_dims, 1000 + r))[2] for r in range(2)]
    want_b = float(jnp.mean(jnp.concatenate(boot)))
    img = port.image(port.render(progress=False))
    print(f"b: port {pi.last_b:.7f} reference {want_b:.7f}; acceptance {pi.last_acceptance}")
    np.testing.assert_allclose(pi.last_b, want_b, rtol=1e-4)
    assert np.isfinite(img).all() and img.max() > 0


def test_anim_walk_packing_and_key_search():
    """``pack_keys`` round-trips; ``key_pair``'s floor search gives
    ``time_weights``' two non-zero weights bit for bit (no reference)."""
    import torch

    from pbrt_tpu_torch.kernels.anim_walk import ROW_PAD, key_pair, pack_keys, time_weights

    rng = np.random.default_rng(3)
    for dt in (torch.float32, torch.float64):
        keys = torch.as_tensor(rng.normal(size=(37, 4, 9))).to(dt)
        packed = pack_keys(keys)
        assert packed.dtype == dt and packed.shape == (37, 4, ROW_PAD[dt])
        assert packed.is_contiguous() and packed.element_size() * ROW_PAD[dt] % 16 == 0
        assert torch.equal(packed[..., :9], keys) and not packed[..., 9:].any()
        for n_keys in (1, 2, 3, 4, 7):
            t = torch.as_tensor(rng.uniform(-0.1, 1.1, 4096)).to(dt)
            t[::3] = torch.as_tensor(rng.integers(0, n_keys, len(t[::3]))).to(dt) / max(
                n_keys - 1, 1)
            t[:4] = torch.tensor([0.0, 1.0, -0.0, 0.5], dtype=dt)
            w = time_weights(t, n_keys)
            ka, wa, wb = key_pair(t, n_keys)
            rows = torch.arange(len(t))
            assert torch.equal(wa, w[rows, ka]) and bool((wa > 0).all())
            kb = torch.clamp(ka + 1, max=n_keys - 1)
            assert torch.equal(wb, torch.where(ka + 1 < n_keys, w[rows, kb], 0.0))
            rest = w.clone()
            rest[rows, ka] = 0.0
            rest[rows, kb] = 0.0
            assert not rest.any(), (dt, n_keys)
