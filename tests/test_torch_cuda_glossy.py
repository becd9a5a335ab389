"""BASELINE config 4 and config 1's integrators on the card against the
same renders on the CPU (the plain versions).  Every test here is marked
``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_glossy.py -m cuda -q

Gates: images to ``tests/test_torch_slice.py``'s tolerance (image-mean
relative difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol
1e-4); gradients, every element of every leaf within rtol 1e-3 of the
CPU's or within 1e-6 of the CPU gradient's largest magnitude.  torch and
the port are imported only once a test knows it has a card.
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


def _maps(tmp_path):
    from pbrt_tpu_torch.testscenes import write_env_map, write_texture_map

    env, tex = str(tmp_path / "env.pfm"), str(tmp_path / "tex.pfm")
    write_env_map(env, 256, 256, seed=0)
    write_texture_map(tex, 64, seed=1)
    return env, tex


def _same_image(got, want):
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3 and close >= 0.99, (rel_mean, close)


@pytest.mark.cuda
def test_config4_image_matches_cpu(tmp_path):
    """Config 4 (the 50,176-triangle torus: K2) at 16x16, 2 spp, maxdepth
    5: K2 launched once per sweep of the one chunk (5 closest + 4
    shadow)."""
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.testscenes import config4_renderer

    env, tex = _maps(tmp_path)
    imgs = {}
    for dev in ("cuda", "cpu"):
        r, _ = config4_renderer(env, tex, xres=16, yres=16, spp=2, maxdepth=5, device=dev)
        bvh8_walk.reset_launch_counts()
        imgs[dev] = r.image(r.render())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert {k: v for k, v in bvh8_walk.LAUNCHES.items() if v} == {"stream_walk8": 9}
    _same_image(imgs["cuda"], imgs["cpu"])


@pytest.mark.cuda
def test_config1_integrators_match_cpu():
    """The check-sphere stand-in at 16x16, 8 spp, under directlighting,
    whitted and ao (the brute-force sweep: no kernel)."""
    _need_card()
    from pbrt_tpu_torch.testscenes import CHECK_SPHERE, text_renderer

    for integ in ('"directlighting" "integer maxdepth" 5', '"whitted" "integer maxdepth" 5',
                  '"ao" "integer nsamples" 2'):
        text = CHECK_SPHERE.format(integrator=integ, xres=16, yres=16, spp=8)
        imgs = {dev: text_renderer(text, 16 * 16 * 8, device=dev) for dev in ("cuda", "cpu")}
        _same_image(*(r.image(r.render()) for r in (imgs["cuda"], imgs["cpu"])))


@pytest.mark.cuda
def test_config4_gradients_match_cpu(tmp_path):
    """Config 4 at 12x12, 2 spp, maxdepth 5: every leaf (roughness, ks,
    kr, kt and the texels included) on the card against the CPU's."""
    torch = _need_card()
    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.testscenes import config4_renderer

    env, tex = _maps(tmp_path)
    grads = {}
    for dev in ("cuda", "cpu"):
        r, _ = config4_renderer(env, tex, xres=12, yres=12, spp=2, maxdepth=5, device=dev)
        b = r.film.cropped_pixel_bounds
        loss = make_loss_fn(r, np.full((12, 12, 3), 0.2, np.float32), spp=2)
        _, grads[dev] = value_and_grad(loss, r.compiled.initial_theta(),
                                       torch.as_tensor(b.offsets(), device=dev))

    def flat(tree, pre=""):
        for k, v in tree.items():
            if k == "tex_images":  # ids count textures per process: match by order
                v = {i: v[key] for i, key in enumerate(sorted(v))}
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v.detach().cpu().numpy()

    g, w = dict(flat(grads["cuda"])), dict(flat(grads["cpu"]))
    assert g.keys() == w.keys()
    scale = max(float(np.abs(v).max(initial=0.0)) for v in w.values())
    assert scale > 0 and np.abs(w["roughness"]).max() > 0
    for k in w:
        assert np.isfinite(g[k]).all(), k
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL_SHARE * scale, err_msg=k)
