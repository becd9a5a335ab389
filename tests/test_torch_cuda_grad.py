"""pbrt_tpu_torch's path-replay gradients on the card against the same
gradients on the CPU (the plain versions).  Every test here is marked
``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_grad.py -m cuda -q

Gate: every element of every gradient leaf within rtol 1e-3 of the
CPU's, or within 1e-6 of the CPU gradient's largest magnitude; the
card's remat=True gradient equal to its remat=False one.  torch and the
port are imported only once a test knows it has a card.
"""

import numpy as np
import pytest

RTOL = 1e-3
ATOL_SHARE = 1e-6


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


def _grads(make, device, remat=True):
    """(gradient of a zero-target loss at 2 spp over every pixel, the
    kernel launches it made) of the renderer ``make(device)``."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.kernels import bvh8_walk

    r = make(device)
    b = r.film.cropped_pixel_bounds
    loss = make_loss_fn(r, np.zeros((b.height, b.width, 3), np.float32), spp=2, remat=remat)
    bvh8_walk.reset_launch_counts()
    _, g = value_and_grad(loss, r.compiled.initial_theta(),
                          torch.as_tensor(b.offsets(), device=device))
    return g, {k: v for k, v in bvh8_walk.LAUNCHES.items() if v}


def _flat(tree, pre=""):
    for k, v in tree.items():
        if k == "tex_images":  # ids count textures per process: match by order
            v = {i: v[key] for i, key in enumerate(sorted(v))}
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v.detach().cpu().numpy()


def _same(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys()
    scale = max(float(np.abs(v).max(initial=0.0)) for v in w.values())
    assert scale > 0
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL_SHARE * scale, err_msg=k)


@pytest.mark.cuda
def test_material_and_texture_gradients_match_cpu(tmp_path):
    """The nested mix under an infinite light and the PFM image texture
    under a distant light (orthographic camera)."""
    _need_card()
    from pbrt_tpu_torch.core.geometry import Bounds2i
    from pbrt_tpu_torch.core.imageio import write_image
    from pbrt_tpu_torch.testscenes import (GRAD_NESTED_MIX, GRAD_SPHERE, GRAD_TEXTURE,
                                           text_renderer)

    path = str(tmp_path / "tex.pfm")
    write_image(path, np.random.default_rng(3).uniform(0.1, 0.9, (8, 8, 3)),
                Bounds2i((0, 0), (8, 8)))
    for text, batch in ((GRAD_SPHERE.format(material=GRAD_NESTED_MIX), 64),
                        (GRAD_TEXTURE.format(path=path), 576)):
        card, _ = _grads(lambda dev: text_renderer(text, batch, device=dev), "cuda")
        cpu, _ = _grads(lambda dev: text_renderer(text, batch, device=dev), "cpu")
        _same(card, cpu)


@pytest.mark.cuda
def test_bvh_gradients_match_cpu():
    """The 24x24 torus (K1) and config 3 at 16x16 (K2), both with the
    sorted carry: the card's gradient, with and without remat, against
    the CPU's; the walk kernel launched, the replay included."""
    _need_card()
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    for kw, kname in ((dict(xres=12, yres=12, nu=24, nv=24), "wide_walk8"),
                      (dict(xres=16, yres=16), "stream_walk8")):
        def make(dev):
            return mesh_scene_renderer(**kw, spp=2, maxdepth=3, device=dev)[0]

        card, launched = _grads(make, "cuda")
        # 2 spp x (3 closest + 2 shadow sweeps), forward and replay
        assert launched == {kname: 20}, launched
        plain, _ = _grads(make, "cuda", remat=False)
        assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(_flat(card), _flat(plain)))
        cpu, _ = _grads(make, "cpu")
        _same(card, cpu)


@pytest.mark.cuda
def test_bitonic_co_sort_refuses_gradients_on_the_card():
    """K5 writes through raw pointers: under grad mode a payload that
    requires grad raises, from co_sort and from a render's loss."""
    torch = _need_card()
    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.ops.sortnet import MIN_N, co_sort
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    keys = torch.randint(0, 1 << 20, (MIN_N,), device="cuda")
    payload = torch.randn(MIN_N, 3, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        co_sort((keys, payload), "bitonic")
    with torch.no_grad():
        keys_s, _ = co_sort((keys, payload), "bitonic")
    assert torch.equal(keys_s, torch.sort(keys).values)
    r, _ = mesh_scene_renderer(xres=256, yres=128, spp=1, maxdepth=2, nu=24, nv=24,
                               device="cuda", sort="bitonic")
    loss = make_loss_fn(r, np.zeros((128, 256, 3), np.float32), spp=1)
    px = torch.as_tensor(r.film.cropped_pixel_bounds.offsets(), device="cuda")
    with pytest.raises(RuntimeError, match="not differentiable"):
        value_and_grad(loss, r.compiled.initial_theta(), px)
