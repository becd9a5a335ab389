"""The scene-file front door on the card against the CPU.  Every test here
is marked ``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_scenefile.py -m cuda -q

Gates: images to ``tests/test_torch_slice.py``'s tolerance (image-mean
relative difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol
1e-4).  torch and the port are imported only once a test knows it has a
card.
"""

import numpy as np
import pytest


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


def _same_image(got, want):
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close


def _scene(tmp_path, **kw):
    from pbrt_tpu_torch.testscenes import scenefile_text, write_torus_ply

    ply = tmp_path / "torus.ply"
    write_torus_ply(ply, nu=48, nv=24)
    path = tmp_path / "scene.pbrt"
    path.write_text(scenefile_text(str(ply), **{
        **dict(xres=32, yres=32, spp=4, maxdepth=3, sampler="sobol", heightfield=32,
               loop_levels=2, filename=str(tmp_path / "film.pfm")), **kw}))
    return str(path)


@pytest.mark.cuda
def test_cli_card_matches_cpu(tmp_path):
    """The scene vocabulary (four PLY instances, heightfield, Loop
    subdivision, the five quadrics, NURBS, every procedural texture and
    mapping; > 4096 triangles: the streaming walk) through ``cli.main``
    at 32x32 on the card and on the CPU."""
    torch = _need_card()
    from pbrt_tpu_torch.cli import main
    from pbrt_tpu_torch.core.imageio import read_image
    from pbrt_tpu_torch.kernels import bvh8_walk

    scene = _scene(tmp_path)
    torch.cuda.synchronize()
    bvh8_walk.reset_launch_counts()
    assert main([scene, "-q", "--ray-batch", "2048", "-o", str(tmp_path / "card.pfm")]) == 0
    assert bvh8_walk.LAUNCHES["stream_walk8"] == 2 * (3 + 2)
    assert main([scene, "-q", "--ray-batch", "2048", "-o", str(tmp_path / "cpu.pfm")],
                device="cpu") == 0
    _same_image(read_image(str(tmp_path / "card.pfm"))[0],
                read_image(str(tmp_path / "cpu.pfm"))[0])


@pytest.mark.cuda
def test_checkpoint_resume_on_card(tmp_path):
    """Killed after 2 of 4 chunks and resumed in a fresh Renderer, the
    card's render equals the uninterrupted one; a checkpoint whose meta
    differs is ignored."""
    _need_card()
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    def renderer(ckpt_dir, spp=4):
        api = PbrtAPI(Options(ray_batch=1024, checkpoint_dir=str(ckpt_dir),
                              checkpoint_every=1), render_on_world_end=False)
        api.init()
        api.parse_file(_scene(tmp_path, spp=spp))
        return Renderer(api.scene, api.opt)

    r_ref = renderer(tmp_path / "ref")
    want = r_ref.image(r_ref.render(progress=False))
    r1 = renderer(tmp_path / "kill")
    calls = {"n": 0}
    radiance = r1._radiance

    def dying(*a, **kw):
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return radiance(*a, **kw)

    r1._radiance = dying
    with pytest.raises(KeyboardInterrupt):
        r1.render(progress=False)
    r2 = renderer(tmp_path / "kill")
    got = r2.image(r2.render(progress=False))
    assert r2.counters["chunks"] == 2
    _same_image(got, want)
    r3 = renderer(tmp_path / "kill", spp=2)
    img = r3.image(r3.render(progress=False))
    assert r3.counters["chunks"] == 2
    assert np.isfinite(img).all() and img.max() > 0
