"""The slice end to end: BASELINE config 3 (small torus) rendered by the
JAX reference and by pbrt_tpu_torch on the CPU.

Both draw the same samples (pure functions of pixel, sample, dimension)
through the same scene, so the images agree up to float rounding.  The
tolerance of the default walk: the reference walks skip links with
4-triangle leaves and takes barycentrics from the walk, the port walks
packed BVH8 clusters and re-derives barycentrics from the hit point;
visiting order and float operation order differ, so t ties and rounding
can send a handful of lanes down another path.  Hence: image-mean relative difference <=
1e-3 and >= 99% of pixels within rtol 1e-3, atol 1e-4.

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import numpy as np
import pytest

from pbrt_tpu.testscenes import mesh_scene_renderer as ref_mesh_scene

_SCENE = dict(xres=16, yres=16, spp=2, maxdepth=3, nu=48, nv=48)


@pytest.fixture(scope="module")
def reference_image():
    ref, _ = ref_mesh_scene(**_SCENE)
    return np.asarray(ref.film.to_rgb(ref.render(progress=False)))


def _port_image(walk):
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    port, _ = mesh_scene_renderer(**_SCENE, device="cpu", walk=walk)
    got = port.image(port.render())
    assert got.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.max() > 0
    assert port.counters["closest_queries"] == 16 * 16 * 2 * 3
    assert port.counters["shadow_queries"] == 16 * 16 * 2 * 2
    return got


def _compare(got, want, rtol, atol):
    """-> (image-mean relative difference, share of pixels within rtol/atol)."""
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1)
    err = np.abs(got - want).max(axis=-1)
    worst = np.unravel_index(np.argmax(err), err.shape)
    print(f"mean rel diff {rel_mean:.3e}; {close.mean():.4f} of pixels close; worst "
          f"pixel {worst}: ref {want[worst]} port {got[worst]}")
    return rel_mean, close.mean()


def test_config3_image_matches_reference(reference_image):
    rel_mean, close = _compare(_port_image("bvh8"), reference_image, 1e-3, 1e-4)
    assert rel_mean <= 1e-3
    assert close >= 0.99


@pytest.mark.parametrize("walk", ["skip", "binary", "binary_fused"])
def test_config3_walks_match_reference(reference_image, walk):
    """The other walks of ``BVHIntersector``.  ``skip`` is the walk the
    reference's CPU renderer takes itself (leaf size 4, barycentrics from
    the walk), so only float rounding separates the two images (XLA's
    fused multiply-adds against the port's separate roundings): every
    pixel within rtol 1e-5 / atol 1e-6 and image means within 1e-5.  The
    binary walks keep the bvh8 case's tolerance."""
    got = _port_image(walk)
    if walk == "skip":
        rel_mean, close = _compare(got, reference_image, 1e-5, 1e-6)
        assert rel_mean <= 1e-5
        assert close == 1.0
    else:
        rel_mean, close = _compare(got, reference_image, 1e-3, 1e-4)
        assert rel_mean <= 1e-3
        assert close >= 0.99
