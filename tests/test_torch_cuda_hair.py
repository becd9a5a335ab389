"""Hair and fur, the fourier BSDF and sampled-spectrum rendering on the card
against the CPU.  Every test here is marked ``cuda`` and skips without a
card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_hair.py -m cuda -q

Gates: images on the card against the CPU to ``tests/test_torch_slice.py``'s
tolerance (image-mean relative difference <= 1e-3, >= 99% of pixels within
rtol 1e-3 / atol 1e-4): a fur ball of 64 curves (6,144 curve triangles:
the streaming walk, K2) under ``Material "hair"``, config 3's scene file
with a 64x40 torus under ``Material "fourier"``, and that scene at 15
spectral bins through ``cli.main --sampled-spectrum``; the hair and fourier
lobes on 65,536 seeded lanes, card against CPU, as tests/test_torch_hair.py
holds them against the reference: f and pdf within rtol 1e-4 (atol 1e-6
of the largest value) on >= 99.9% of lanes and within rtol 1e-3 on all,
sampled directions within 1e-4 on >= 99.9% of lanes.  torch and the
port are imported only once a test knows it has a card.
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


def _cli_image(path, dev, extra=()):
    from pbrt_tpu_torch import cli, render

    kept = []
    real = render.render_scene

    def keep(*a, **kw):
        kept.append(real(*a, **kw))
        return kept[-1]

    render.render_scene = keep
    try:
        assert cli.main([str(path), "--ray-batch", "16384", "-q", *extra], device=dev) == 0
    finally:
        render.render_scene = real
    return kept[-1]["image"]


@pytest.mark.cuda
def test_fur_ball_card_against_cpu(tmp_path):
    _need_card()
    from pbrt_tpu_torch.testscenes import fur_text

    path = tmp_path / "fur.pbrt"
    path.write_text(fur_text(64, xres=24, yres=24, spp=2, maxdepth=6,
                             filename=str(tmp_path / "fur.pfm")))
    _same("fur", _cli_image(path, "cuda"), _cli_image(path, "cpu"))


@pytest.mark.cuda
def test_fourier_and_spectral_card_against_cpu(tmp_path):
    _need_card()
    from pbrt_tpu_torch.testscenes import (config3_scenefile, glossy_fourier_table,
                                           write_torus_ply)

    write_torus_ply(tmp_path / "torus.ply", nu=64, nv=40)
    glossy_fourier_table().write(tmp_path / "glossy.bsdf")
    config3_scenefile(tmp_path / "fourier.pbrt", tmp_path / "torus.ply", xres=24, yres=24,
                      spp=2, maxdepth=4,
                      material=f'Material "fourier" "string bsdffile" "{tmp_path}/glossy.bsdf"')
    _same("fourier", _cli_image(tmp_path / "fourier.pbrt", "cuda"),
          _cli_image(tmp_path / "fourier.pbrt", "cpu"))
    config3_scenefile(tmp_path / "spectral.pbrt", tmp_path / "torus.ply", xres=24, yres=24,
                      spp=2, maxdepth=3)
    flags = ("--sampled-spectrum",)
    _same("spectral", _cli_image(tmp_path / "spectral.pbrt", "cuda", flags),
          _cli_image(tmp_path / "spectral.pbrt", "cpu", flags))


@pytest.mark.cuda
def test_hair_and_fourier_lobes_card_against_cpu():
    torch = _need_card()
    from pbrt_tpu_torch.materials.fourier import (fourier_f, fourier_pdf_tbl,
                                                  fourier_sample_wi_tbl)
    from pbrt_tpu_torch.materials.hair import hair_f, hair_pdf, hair_sample_wi
    from pbrt_tpu_torch.testscenes import glossy_fourier_table

    n = 65536
    rs = np.random.default_rng(2)
    w = rs.normal(size=(2, n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[0, :, 2] = np.abs(w[0, :, 2])
    host = {"wo": w[0], "wi": w[1], "u_lobe": rs.random(n), "u2": rs.random((n, 2)),
            "sigma_a": rs.uniform(0, 3, (n, 3)), "beta_m": rs.uniform(0.1, 0.9, n),
            "beta_n": rs.uniform(0.1, 0.9, n), "hair_alpha": rs.uniform(0, 4, n),
            "eta": np.full(n, 1.55)}
    table = glossy_fourier_table()
    out = {}
    for dev in ("cuda", "cpu"):
        x = {k: torch.as_tensor(v.astype(np.float32), device=dev) for k, v in host.items()}
        tbl = table.device_arrays(dev)
        out[dev] = [hair_f(x, x["wo"], x["wi"]), hair_pdf(x, x["wo"], x["wi"]),
                    fourier_f(tbl, x["wo"], x["wi"]), fourier_pdf_tbl(tbl, x["wo"], x["wi"]),
                    hair_sample_wi(x, x["wo"], x["u_lobe"], x["u2"]),
                    fourier_sample_wi_tbl(tbl, x["wo"], x["u_lobe"], x["u2"])]
    for i, (g, c) in enumerate(zip(out["cuda"], out["cpu"])):
        g, c = g.cpu().numpy(), c.numpy()
        assert np.isfinite(g).all(), i
        if i < 4:
            atol = 1e-6 * np.abs(c).max()
            close = np.isclose(g, c, rtol=1e-4, atol=atol).reshape(n, -1).all(axis=-1)
            assert close.mean() >= 0.999, (i, close.mean())
            np.testing.assert_allclose(g, c, rtol=1e-3, atol=atol, err_msg=str(i))
        else:
            assert (np.abs(g - c).max(axis=-1) > 1e-4).mean() <= 1e-3, i
