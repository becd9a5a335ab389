"""Path-replay gradients: pbrt_tpu_torch's ``diff/grad.py`` against the
JAX reference's ``jax.grad`` on the CPU, on the same theta (carried
across by ``scene/convert.theta_from_numpy``).

Both packages draw the same samples and trace the same paths, so the
gradients agree up to float rounding: every element of every leaf within
rtol 1e-4 of the reference's, or within atol 1e-7 of the largest
magnitude in the reference's whole gradient.  The atol serves the leaves
that only rounding reaches.  On the torus, the area light faces away
from the scene, and its whole gradient (~2e-15, against the floor kd's
~5e-3) comes from one lane of 288: a bounce ray hits the quad's underside
(it carries the default matte), and the light sample from there lies in
the quad's plane up to rounding (wi.z = -7.5e-7), so its cosine passes
the 1e-7 threshold by rounding alone (pdf 33,333).  The reference, whose
XLA code fuses o + d t into an FMA, rounds that hit point differently:
its area-light gradient is 4% away.  The port's own gradient meets its
central finite difference (eps 1e-2) at rtol 0.05, the reference tests'
tolerance.

The reference's gradient is compiled once per scene, in the test that
uses it, so no fixture outlives its test.  torch and pbrt_tpu_torch are imported inside the tests: every
test worker imports every test module while collecting.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.diff.grad import make_loss_fn as ref_make_loss_fn
from pbrt_tpu.diff.grad import make_radiance_fn as ref_make_radiance_fn
from pbrt_tpu.render import Renderer as RefRenderer
from pbrt_tpu.testscenes import mesh_scene_renderer as ref_mesh_scene

RTOL = 1e-4
ATOL_SHARE = 1e-7  # of the largest magnitude in the reference's gradient
FD_EPS = 1e-2
FD_RTOL = 0.05

def _renderers(text, ray_batch):
    """(reference Renderer, port Renderer on the CPU) of scene text."""
    from pbrt_tpu_torch.testscenes import text_renderer

    api = RefAPI(RefOptions(ray_batch=ray_batch), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    return RefRenderer(api.scene, api.opt, seed=0), text_renderer(text, ray_batch,
                                                                  device="cpu")


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _pixels(renderer):
    return renderer.film.cropped_pixel_bounds.offsets()


def _max_abs(tree):
    return max([_max_abs(v) if isinstance(v, dict) else float(np.abs(v).max(initial=0.0))
                for v in tree.values()], default=0.0)


def _compare_leaves(got, want, path="", atol=None):
    """Every leaf of the port's gradient against the reference's (the
    port's tex_images mapped to the reference's by ascending key)."""
    atol = ATOL_SHARE * _max_abs(want) if atol is None else atol
    assert set(got) == set(want) or path.endswith("tex_images"), (path, set(got), set(want))
    if path.endswith("tex_images"):
        assert len(got) == len(want)
        got = dict(zip(sorted(want), [got[k] for k in sorted(got)]))
    for k in want:
        if isinstance(want[k], dict):
            _compare_leaves(got[k], want[k], f"{path}.{k}", atol)
            continue
        g = got[k].detach().cpu().numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, (path, k)
        assert np.isfinite(g).all(), (path, k)
        print(f"{path}.{k}: max |port - ref| {np.abs(g - w).max(initial=0.0):.3e} "
              f"of {np.abs(w).max(initial=0.0):.3e}")
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=f"{path}.{k}")


def _fd(loss, theta, path, index, args):
    """Central difference of loss at one element of the leaf at ``path``."""
    import copy

    def at(delta):
        t2 = copy.deepcopy(theta)
        node = t2
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]].clone()
        node[path[-1]][index] += delta
        return float(loss(t2, *args))

    return (at(FD_EPS) - at(-FD_EPS)) / (2 * FD_EPS)


def test_nested_mix_gradients_match_reference():
    """tests/test_grad.py's nested mix at 8x8, 2 spp: every leaf against
    jax.grad, the three kd leaves against the port's own finite
    differences, and the flat theta refused."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.materials import eval_material_params
    from pbrt_tpu_torch.scene.convert import theta_from_numpy

    from pbrt_tpu_torch.testscenes import GRAD_NESTED_MIX, GRAD_SPHERE

    ref, port = _renderers(GRAD_SPHERE.format(material=GRAD_NESTED_MIX), 64)
    ref_theta = ref.compiled.initial_theta()
    target = np.zeros((8, 8, 3), np.float32)
    pixels = _pixels(ref).astype(np.int32)
    want = jax.jit(jax.grad(ref_make_loss_fn(ref, target, spp=2)))(
        ref_theta, jnp.asarray(pixels))
    theta = theta_from_numpy(_numpy(ref_theta), port.compiled, "cpu")
    assert "a" in theta["b"] and "b" in theta["b"]
    loss = make_loss_fn(port, target, spp=2)
    px = torch.as_tensor(pixels.astype(np.int64))
    _, got = value_and_grad(loss, theta, px)
    _compare_leaves(got, _numpy(want))
    for path in (("a", "kd"), ("b", "a", "kd"), ("b", "b", "kd")):
        fd = _fd(loss, theta, path, (0, 0), (px,))
        ad = got
        for k in path:
            ad = ad[k]
        print(f"{path}: AD {float(ad[0, 0]):.6e} FD {fd:.6e}")
        assert fd != 0.0
        np.testing.assert_allclose(float(ad[0, 0]), fd, rtol=FD_RTOL)
    si = {"p": torch.zeros((4, 3)), "uv": torch.zeros((4, 2))}
    flat = {"kd": torch.zeros((len(port.compiled.materials), 3))}
    with pytest.raises(ValueError, match="split"):
        eval_material_params(port.compiled.materials, torch.zeros(4, dtype=torch.int32), si,
                             flat)


def test_texture_gradients_match_reference(tmp_path):
    """tests/test_texture_grad.py's scene (orthographic camera, distant
    light, a PFM image texture): one sample per pixel, its radiance and
    the gradient of mean(L^2) w.r.t. every leaf, texels included."""
    import torch

    from pbrt_tpu_torch.core.geometry import Bounds2i
    from pbrt_tpu_torch.core.imageio import read_image, write_image
    from pbrt_tpu_torch.diff.grad import make_radiance_fn, value_and_grad
    from pbrt_tpu_torch.scene.convert import theta_from_numpy
    from pbrt_tpu_torch.testscenes import GRAD_TEXTURE

    img = np.random.default_rng(3).uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32)
    path = str(tmp_path / "tex.pfm")
    write_image(path, img, Bounds2i((0, 0), (8, 8)))
    back, size = read_image(path)
    assert size == (8, 8) and np.array_equal(back, img)
    ref, port = _renderers(GRAD_TEXTURE.format(path=path), 12 * 12 * 4)
    ref_theta = ref.compiled.initial_theta()
    assert len(ref_theta["tex_images"]) == 1
    pixels = _pixels(ref).astype(np.int32)
    ref_rad = ref_make_radiance_fn(ref)
    sidx = jnp.zeros((len(pixels),), jnp.uint32)

    def ref_loss(theta):
        return jnp.mean(ref_rad(theta, jnp.asarray(pixels), sidx) ** 2)

    want_L = np.asarray(jax.jit(lambda t: ref_rad(t, jnp.asarray(pixels), sidx))(ref_theta))
    want = jax.jit(jax.grad(ref_loss))(ref_theta)

    theta = theta_from_numpy(_numpy(ref_theta), port.compiled, "cpu")
    (port_tex,) = port.compiled.initial_theta()["tex_images"].values()
    np.testing.assert_array_equal(port_tex.numpy(), np.asarray(
        next(iter(ref_theta["tex_images"].values()))))
    rad = make_radiance_fn(port)
    px = torch.as_tensor(pixels.astype(np.int64))
    zero = torch.zeros(len(pixels), dtype=torch.int64)
    with torch.no_grad():
        got_L = rad(theta, px, zero).numpy()
    print(f"radiance: max |port - ref| {np.abs(got_L - want_L).max():.3e} "
          f"of {np.abs(want_L).max():.3e}")
    assert want_L.max() > 0
    np.testing.assert_allclose(got_L, want_L, rtol=RTOL, atol=1e-6)
    _, got = value_and_grad(lambda t: torch.mean(rad(t, px, zero) ** 2), theta)
    (gtex,) = got["tex_images"].values()
    assert float(gtex.abs()[:64].sum()) > 0.0  # the finest level
    _compare_leaves(got, _numpy(want))


def test_torus_gradient_matches_reference():
    """The 24x24 torus (BVH, sorted carry) at 12x12, 2 spp, maxdepth 3:
    every leaf against jax.grad of the reference's loss (the floor's kd is
    the one the loss reaches); remat=True equal to remat=False; the
    differentiable render equal to the film's image (the gradient path's
    unbounded sampler draws the bounded sampler's values)."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, render_image_diff, value_and_grad
    from pbrt_tpu_torch.scene.convert import theta_from_numpy
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    scene = dict(xres=12, yres=12, spp=2, maxdepth=3, nu=24, nv=24)
    ref, _ = ref_mesh_scene(**scene)
    port, _ = mesh_scene_renderer(**scene, device="cpu")
    assert port.integrator._sc  # the sorted carry
    ref_theta = ref.compiled.initial_theta()
    target = np.zeros((12, 12, 3), np.float32)
    pixels = _pixels(ref).astype(np.int32)
    want = _numpy(jax.jit(jax.grad(ref_make_loss_fn(ref, target, spp=2)))(
        ref_theta, jnp.asarray(pixels)))
    theta = theta_from_numpy(_numpy(ref_theta), port.compiled, "cpu")
    px = torch.as_tensor(pixels.astype(np.int64))
    grads = {}
    for remat in (True, False):
        _, grads[remat] = value_and_grad(make_loss_fn(port, target, spp=2, remat=remat),
                                         theta, px)
    print("floor kd:", grads[True]["kd"][2].tolist(), "reference:", want["kd"][2].tolist())
    assert float(grads[True]["kd"][2].min()) > 1e-3
    _compare_leaves(grads[True], want)
    for k in grads[True]:
        if k != "tex_images":
            torch.testing.assert_close(grads[True][k], grads[False][k], rtol=0, atol=0)
    with torch.no_grad():
        img = render_image_diff(port, port.compiled.initial_theta(), spp=2).numpy()
    film = port.image(port.render())
    np.testing.assert_allclose(img, film, rtol=1e-5, atol=1e-6)
    # a lane escaped to t = 1e8 samples the area light with a pdf near
    # 1e22: its MIS weight must stay finite (a NaN there, masked out of
    # the radiance, made config 5's gradient NaN)
    from pbrt_tpu_torch.core.sampling import power_heuristic

    w = power_heuristic(1, torch.tensor([2.5e22, 0.3]), 1, torch.tensor([0.3, 2.5e22]))
    assert w.tolist() == [1.0, 0.0]


def test_bitonic_co_sort_refuses_gradients():
    """The bitonic network refuses payloads that require grad while grad
    mode is on (the reference's raises under jax.grad); without grad, or
    under no_grad, it sorts; the stable network carries gradients."""
    import torch

    from pbrt_tpu_torch.ops.sortnet import MIN_N, co_sort

    n = MIN_N
    gen = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 1 << 20, (n,), generator=gen, dtype=torch.int64)
    payload = torch.randn(n, 3, generator=gen, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        co_sort((keys, payload), "bitonic")
    with torch.no_grad():
        k_s, p_s = co_sort((keys, payload), "bitonic")
    k_t, p_t = co_sort((keys, payload.detach()), "bitonic")
    assert torch.equal(k_s, torch.sort(keys).values)
    assert torch.equal(p_s, p_t)
    _, p_g = co_sort((keys, payload), "stable")
    (g,) = torch.autograd.grad((p_g * torch.arange(n)[:, None]).sum(), payload)
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(g[order, 0], torch.arange(n, dtype=g.dtype))
