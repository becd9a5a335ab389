"""The environment and realistic cameras of pbrt_tpu_torch against the JAX
reference on the CPU.

Each camera is built from the same scene text by both packages
(tests/test_sppm.py's open box, 16x16): its rays and weights for 4096
seeded film and lens samples within rtol 1e-5 (the realistic camera's
vignetting mask equal; its thick-lens focus, element list and exit-pupil
bounds, computed on the host in float64, within rtol 1e-12), and the
box's 16x16 render under ``path`` to the image tolerance of the other
scene tests (image-mean relative difference <= 1e-3, >= 99% of pixels
within rtol 1e-3 / atol 1e-4).  A lens file that cannot be read falls
back to a perspective camera with an error logged, in both packages.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.render import Renderer as RefRenderer

RES = 16
CAMERAS = {
    "environment": 'Camera "environment"',
    "realistic": ('Camera "realistic" "string lensfile" "biconvex-50mm-f8" '
                  '"float focusdistance" 4 "float aperturediameter" 5'),
}


def _renderers(camera):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import gi_box_text

    text = gi_box_text("path", RES, RES, 4, 3)
    cam = 'Camera "perspective" "float fov" 60'
    assert text.count(cam) == 1
    text = text.replace(cam, camera)
    api = RefAPI(RefOptions(ray_batch=1 << 14), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    port_api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False, device="cpu")
    port_api.init()
    port_api.parse_string(text)
    return (RefRenderer(api.scene, api.opt),
            Renderer(port_api.scene, port_api.opt, device="cpu"))


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_camera_rays_and_render_against_reference(name):
    import torch

    ref, port = _renderers(CAMERAS[name])
    rc, pc = ref.camera, port.camera
    assert type(pc).__name__ == type(rc).__name__
    if name == "realistic":
        assert len(pc.elements) == len(rc.elements) == 3
        for a, b in zip(pc.elements, rc.elements):
            np.testing.assert_allclose(
                [a.curvature_radius, a.thickness, a.eta, a.aperture_radius],
                [b.curvature_radius, b.thickness, b.eta, b.aperture_radius], rtol=1e-12)
        np.testing.assert_allclose([pc.rear_z, pc.rear_radius, pc.film_diag],
                                   [rc.rear_z, rc.rear_radius, rc.film_diag], rtol=1e-12)
        np.testing.assert_allclose(pc.focal_length, rc.focal_length, rtol=1e-12)
        lo, hi = pc.pupil_bounds
        np.testing.assert_allclose(lo.astype(np.float32), np.asarray(rc._pupil_min), rtol=1e-12)
        np.testing.assert_allclose(hi.astype(np.float32), np.asarray(rc._pupil_max), rtol=1e-12)
        np.testing.assert_array_equal(pc._pupil_area.numpy(), np.asarray(rc._pupil_area))

    rng = np.random.default_rng(5)
    p_film = rng.uniform(0, RES, (4096, 2)).astype(np.float32)
    p_film[:4] = [[0, 0], [RES / 2, RES / 2], [RES, RES], [0.5, RES - 0.5]]
    u_lens = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    want = [np.asarray(x) for x in rc.generate_rays(jnp.asarray(p_film), jnp.asarray(u_lens))]
    got = [x.numpy() for x in pc.generate_rays(torch.as_tensor(p_film),
                                                torch.as_tensor(u_lens))]
    alive = want[2] > 0
    np.testing.assert_array_equal(got[2] > 0, alive)
    assert alive.mean() > (0.5 if name == "realistic" else 0.999)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[alive], w[alive], rtol=1e-5, atol=1e-6)

    img_w = np.asarray(ref.film.to_rgb(ref.render(progress=False)))
    img_g = port.image(port.render(progress=False))
    assert np.isfinite(img_g).all() and img_g.max() > 0
    rel_mean = abs(img_g.mean() - img_w.mean()) / img_w.mean()
    close = np.isclose(img_g, img_w, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    print(f"{name}: mean {img_g.mean():.6f} (reference {img_w.mean():.6f}), mean rel diff "
          f"{rel_mean:.3e}, {close:.4f} of pixels close")
    assert rel_mean <= 1e-3 and close >= 0.99


def test_unreadable_lens_file_falls_back_to_perspective(tmp_path, caplog):
    bad = tmp_path / "lens.dat"
    bad.write_text("48.0 4.0 1.5\n")  # three columns: not a prescription
    with caplog.at_level(logging.ERROR):
        ref, port = _renderers(f'Camera "realistic" "string lensfile" "{bad}"')
    assert type(ref.camera).__name__ == type(port.camera).__name__ == "PerspectiveCamera"
    assert any(r.name == "pbrt_tpu_torch" and "falling back to perspective" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_array_equal(port.camera._r2c.numpy(), np.asarray(ref.camera._r2c))
