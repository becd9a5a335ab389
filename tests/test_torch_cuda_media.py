"""Participating media on the card against the CPU.  Every test here is
marked ``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_media.py -m cuda -q

Gates: images to ``tests/test_torch_slice.py``'s tolerance (image-mean
relative difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol
1e-4); tracking: scattered masks equal on all but 1e-4 of the lanes
(the card's ``log`` and ``exp`` are not the CPU's to the last bit),
distances where both scattered within rtol 1e-5, transmittance within
rtol 1e-5 / atol 1e-5.  torch and the port are imported only once a test
knows it has a card.
"""

import numpy as np
import pytest


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


@pytest.mark.cuda
def test_volume_scene_card_matches_cpu(tmp_path):
    """The fog-and-smoke scene file at 16x16, 2 spp, maxdepth 3 with a 24x24
    torus (the whole-tree walk, K1) and an 8^3 grid through ``cli.main``."""
    torch = _need_card()
    from pbrt_tpu_torch.cli import main
    from pbrt_tpu_torch.core.imageio import read_image
    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.testscenes import write_volume_scene

    scene = tmp_path / "volume.pbrt"
    write_volume_scene(scene, tmp_path / "torus.ply", nu=24, nv=24, xres=16, yres=16, spp=2,
                       maxdepth=3, grid=8, filename=str(tmp_path / "film.pfm"))
    torch.cuda.synchronize()
    bvh8_walk.reset_launch_counts()
    assert main([str(scene), "-q", "-o", str(tmp_path / "card.pfm")]) == 0
    assert bvh8_walk.LAUNCHES["wide_walk8"] == 3 * 3 + 2 * 4
    assert main([str(scene), "-q", "-o", str(tmp_path / "cpu.pfm")], device="cpu") == 0
    got, want = (read_image(str(tmp_path / f"{k}.pfm"))[0] for k in ("card", "cpu"))
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close


@pytest.mark.cuda
def test_tracking_card_matches_cpu():
    """Delta and ratio tracking through a 16^3 smoke grid on 65,536 seeded
    lanes (``testscenes.volume_rays``), and the homogeneous fog's."""
    torch = _need_card()
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.media import GridDensityMedium, HomogeneousMedium, make_track_rng
    from pbrt_tpu_torch.testscenes import VOLUME_BOX, smoke_density, volume_rays

    p0, p1 = (np.asarray(p) for p in VOLUME_BOX)
    w2m = (Transform.translate(p0) * Transform.scale(*(p1 - p0))).m_inv
    host = volume_rays(65536, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        grid = GridDensityMedium([0.5] * 3, [2.0] * 3, 0.2, smoke_density(16, 0), w2m,
                                 device=dev)
        fog = HomogeneousMedium([0.01] * 3, [0.05] * 3, 0.3, device=dev)
        o, d, t_max, pix, si = (torch.as_tensor(x, device=dev) for x in host)
        u = make_track_rng(pix, si, 5)(0)
        res = []
        for m in (grid, fog):
            t, scat, _ = m.sample(o, d, u, t_max, make_track_rng(pix, si, 2048))
            res += [t, scat, m.tr(o, d, t_max, make_track_rng(pix, si, 1024))]
        out[dev] = [x.cpu().numpy() for x in res]
    for k in (0, 3):
        (t_g, s_g, tr_g), (t_w, s_w, tr_w) = out["cuda"][k:k + 3], out["cpu"][k:k + 3]
        assert 0.01 < s_w.mean() < 0.99
        assert np.mean(s_g != s_w) <= 1e-4
        both = s_g & s_w
        np.testing.assert_allclose(t_g[both], t_w[both], rtol=1e-5)
        np.testing.assert_allclose(tr_g, tr_w, rtol=1e-5, atol=1e-5)
