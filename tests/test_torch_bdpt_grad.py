"""BDPT path-replay gradients: pbrt_tpu_torch's bdpt loss against the
reference's ``jax.value_and_grad`` on tests/test_sppm.py's box
(``testscenes.gi_box_text``, the wall given a matte of its own) at 8x8, 2
spp, maxdepth 3, on the same theta (``scene/convert.theta_from_numpy``).

The reference is differentiated op by op (not under ``jax.jit``): XLA
takes minutes and tens of GiB to compile BDPT's unrolled connections
and their transpose.  Every element of every leaf is held within rtol
1e-3 of the reference's, or within 1e-6 of the largest magnitude in the
reference's gradient (the card-against-CPU tolerance of
``chip_smoke.py`` phase 10 (b)); the loss within rtol 1e-5; the
reference's leaves are finite here, so ``jax.jacfwd`` is not needed.
Then ``remat`` (accepted, and without effect: BDPT keeps every vertex
record for its connections, so it has no per-bounce checkpoint) on
against off, bit-equal, and the floor's kd against a central finite
difference of the port's loss (eps 1e-2, rtol 0.05).

torch and pbrt_tpu_torch are imported inside the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.diff.grad import make_loss_fn as ref_make_loss_fn
from pbrt_tpu.render import Renderer as RefRenderer

RTOL = 1e-3
ATOL_SHARE = 1e-6


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def _box():
    from pbrt_tpu_torch.testscenes import gi_box_text

    text = gi_box_text("bdpt", xres=8, yres=8, spp=2, maxdepth=3)
    wall = 'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n  "point P" [ -2.5 0 -2.5'
    assert text.count(wall) == 2
    # the second (the wall) gets a material of its own
    head, tail = text.rsplit(wall, 1)
    return head + 'Material "matte" "rgb Kd" [0.6 0.3 0.2]\n' + wall + tail


def test_bdpt_gradients_match_reference():
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.integrators.bdpt import BDPTIntegrator
    from pbrt_tpu_torch.scene.convert import theta_from_numpy
    from pbrt_tpu_torch.testscenes import text_renderer

    text = _box()
    api = RefAPI(RefOptions(ray_batch=64), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    ref = RefRenderer(api.scene, api.opt, seed=0)
    port = text_renderer(text, 64, device="cpu")
    assert type(port.integrator) is BDPTIntegrator
    ref_theta = ref.compiled.initial_theta()
    target = np.full((8, 8, 3), 0.05, np.float32)
    pixels = ref.film.cropped_pixel_bounds.offsets().astype(np.int32)
    want_value, want = jax.value_and_grad(ref_make_loss_fn(ref, target, spp=2))(
        ref_theta, jnp.asarray(pixels))
    want = _numpy(want)

    theta = theta_from_numpy(_numpy(ref_theta), port.compiled, "cpu")
    value, grads = value_and_grad(make_loss_fn(port, target, spp=2), theta,
                                  torch.as_tensor(pixels.astype(np.int64)))
    print(f"loss: port {float(value):.8e} reference {float(want_value):.8e}")
    np.testing.assert_allclose(float(value), float(want_value), rtol=1e-5)
    got = dict(_leaves(grads))
    scale = max(float(np.abs(v).max(initial=0.0)) for _, v in _leaves(want))
    assert scale > 0
    for k, w in _leaves(want):
        assert np.isfinite(w).all(), k
        g = got[k].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), k
        print(f"{k}: max |port - ref| {np.abs(g - w).max(initial=0.0):.3e} of "
              f"{np.abs(w).max(initial=0.0):.3e}")
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL_SHARE * scale, err_msg=k)
    # the floor's and the wall's kd (rows 1 and 2; row 0 is the light's
    # default matte) and the area light are reached
    assert float(got["kd"][1:].abs().min()) > 0 and float(got["area_l"].abs().max()) > 0


def test_bdpt_remat_has_no_effect_and_matches_finite_differences():
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, make_radiance_fn, value_and_grad
    from pbrt_tpu_torch.testscenes import text_renderer

    port = text_renderer(_box(), 64, device="cpu")
    theta = port.compiled.initial_theta()
    target = np.full((8, 8, 3), 0.05, np.float32)
    px = torch.as_tensor(port.film.cropped_pixel_bounds.offsets().astype(np.int64))
    values, grads = {}, {}
    for remat in (True, False):
        values[remat], grads[remat] = value_and_grad(
            make_loss_fn(port, target, spp=2, remat=remat), theta, px)
        with torch.no_grad():
            radiance = make_radiance_fn(port, remat)(theta, px,
                                                     torch.zeros(len(px), dtype=torch.int64))
        assert float(radiance.max()) > 0
    assert torch.equal(values[True], values[False])
    for k, v in _leaves(grads[False]):
        assert torch.equal(v, dict(_leaves(grads[True]))[k]), k

    loss = make_loss_fn(port, target, spp=2)

    def at(delta):
        t2 = dict(theta, kd=theta["kd"].clone())
        t2["kd"][1, 0] += delta
        with torch.no_grad():
            return float(loss(t2, px))

    fd = (at(1e-2) - at(-1e-2)) / 2e-2
    ad = float(grads[True]["kd"][1, 0])
    assert fd != 0.0 and abs(ad - fd) <= 0.05 * abs(fd), (ad, fd)
