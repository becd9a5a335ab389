"""The fourier BSDF in pbrt_tpu_torch against the JAX reference.

- ``FourierTable`` (a numpy copy of the reference's): the ``.bsdf`` files
  the port writes are byte-equal to the reference's for the Lambertian
  table and a glossy 8-order table on 32 knots
  (``testscenes.glossy_fourier_table``); each package reads the other's
  file back to the same dense coefficients and sampling tables (the
  file's knots are float32).
- ``fourier_f``, ``fourier_pdf_tbl`` and ``fourier_sample_wi_tbl`` on
  20,000 seeded lanes against the reference under ``jax.jit``: f and pdf
  within rtol 1e-4 (atol 1e-6 of the largest value; the contraction over
  the orders and XLA's cos and arccos round otherwise than torch's),
  sampled directions within 1e-4 on >= 99.9% of lanes.
- ``Material "fourier"`` with a missing file logs an error and renders
  as matte in both packages.
- Config 3's scene file with a 24x24 torus under the glossy table (16
  knots, 4 orders) at 16x16, 2 spp, maxdepth 3, against the reference's
  image (image-mean relative difference <= 1e-3, >= 99% of pixels within
  rtol 1e-3 / atol 1e-4).

torch and pbrt_tpu_torch are imported inside the tests.
"""

import filecmp
import logging

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.materials import fourier as ref_fourier
from pbrt_tpu.render import render_scene as ref_render_scene
from pbrt_tpu.scene.builder import build_scene as ref_build_scene

N = 20000


def _ref_glossy(n_mu, orders):
    """The reference's FourierTable with testscenes.glossy_fourier_table's
    coefficients."""
    from pbrt_tpu_torch.testscenes import glossy_fourier_table

    t = glossy_fourier_table(n_mu=n_mu, orders=orders)
    n = t.n_mu
    oal, runs, off = np.zeros((n * n, 2), np.int64), [], 0
    for idx in range(n * n):
        coef = t.a_dense[idx // n, idx % n]
        if np.abs(coef).sum() > 0:
            oal[idx] = (off, orders)
            runs.append(coef.reshape(-1))
            off += coef.size
    return t, ref_fourier.FourierTable(t.eta, t.mu, oal, np.concatenate(runs), orders, 3)


def test_bsdf_files_round_trip_byte_equal(tmp_path):
    from pbrt_tpu_torch.materials.fourier import FourierTable

    pairs = [(FourierTable.lambertian((0.7, 0.4, 0.2)),
              ref_fourier.FourierTable.lambertian((0.7, 0.4, 0.2))), _ref_glossy(32, 8)]
    for k, (port, ref) in enumerate(pairs):
        for name in ("a_dense", "mu", "i_grid", "o_grid", "pdf_mu", "cdf_mu"):
            np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
        port.write(tmp_path / f"port{k}.bsdf")
        ref.write(str(tmp_path / f"ref{k}.bsdf"))
        assert filecmp.cmp(tmp_path / f"port{k}.bsdf", tmp_path / f"ref{k}.bsdf", shallow=False)
        back = FourierTable.read(str(tmp_path / f"ref{k}.bsdf"))
        ref_back = ref_fourier.FourierTable.read(str(tmp_path / f"port{k}.bsdf"))
        assert back.eta == ref_back.eta == float(np.float32(ref.eta))
        for name in ("a_dense", "mu", "pdf_mu", "cdf_mu"):
            np.testing.assert_array_equal(getattr(back, name), getattr(ref_back, name))
        np.testing.assert_array_equal(back.a_dense, port.a_dense)


def test_fourier_lobes_match_reference():
    import torch

    from pbrt_tpu_torch.materials.fourier import (fourier_f, fourier_pdf_tbl,
                                                  fourier_sample_wi_tbl)

    port, ref = _ref_glossy(32, 8)
    tbl, ref_tbl = port.device_arrays("cpu"), ref.device_arrays()
    assert port.device_arrays("cpu") is tbl  # one upload per device
    rs = np.random.default_rng(9)

    def dirs(m):
        w = rs.normal(size=(m, 3))
        return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)

    wo, wi = dirs(N), dirs(N)
    wo[:, 2] = np.abs(wo[:, 2])
    u_lobe = rs.random(N, dtype=np.float32)
    u2 = rs.random((N, 2), dtype=np.float32)
    targs = (torch.as_tensor(wo), torch.as_tensor(wi))
    for fn, ref_fn in ((fourier_f, ref_fourier.fourier_f),
                       (fourier_pdf_tbl, ref_fourier.fourier_pdf_tbl)):
        want = np.asarray(jax.jit(lambda a, b, f=ref_fn: f(ref_tbl, a, b))(wo, wi))
        got = fn(tbl, *targs).numpy()
        assert np.isfinite(got).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=fn.__name__)
    want = np.asarray(jax.jit(lambda a, b, c: ref_fourier.fourier_sample_wi_tbl(
        ref_tbl, a, b, c))(wo, u_lobe, u2))
    got = fourier_sample_wi_tbl(tbl, torch.as_tensor(wo), torch.as_tensor(u_lobe),
                                torch.as_tensor(u2)).numpy()
    assert np.isfinite(got).all()
    far = np.abs(got - want).max(axis=-1) > 1e-4
    assert far.mean() <= 1e-3, far.mean()


def test_missing_bsdf_file_falls_back_to_matte(tmp_path, caplog):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.materials import bsdf as B
    from pbrt_tpu_torch.scene.builder import build_scene

    text = (f'Film "image" "integer xresolution" [4] "integer yresolution" [4]\nWorldBegin\n'
            f'Material "fourier" "string bsdffile" "{tmp_path}/missing.bsdf"\n'
            'Shape "sphere"\nWorldEnd')
    ref_api = RefAPI(RefOptions(), render_on_world_end=False)
    api = PbrtAPI(Options(), render_on_world_end=False, device="cpu")
    for a in (ref_api, api):
        a.init()
        a.parse_string(text)
    with caplog.at_level(logging.ERROR):
        port = build_scene(api.scene, None, device="cpu")
    assert any("fourier material" in r.getMessage() and r.levelno == logging.ERROR
               for r in caplog.records)
    ref = ref_build_scene(ref_api.scene, RefOptions())
    assert [e.type_id for e in port.materials] == [e.type_id for e in ref.materials] == [
        B.MATTE]
    kd = port.materials[0].textures["kd"].value
    np.testing.assert_array_equal(kd, ref.materials[0].textures["kd"].value)


def test_fourier_scene_renders_like_reference(tmp_path):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import render_scene
    from pbrt_tpu_torch.testscenes import (config3_scenefile, glossy_fourier_table,
                                           write_torus_ply)

    write_torus_ply(tmp_path / "torus.ply", nu=24, nv=24)
    glossy_fourier_table(n_mu=16, orders=4).write(tmp_path / "glossy.bsdf")
    config3_scenefile(tmp_path / "s.pbrt", tmp_path / "torus.ply", xres=16, yres=16, spp=2,
                      maxdepth=3,
                      material=f'Material "fourier" "string bsdffile" "{tmp_path}/glossy.bsdf"')
    text = (tmp_path / "s.pbrt").read_text()
    api = RefAPI(RefOptions(ray_batch=4096), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    want = np.asarray(ref_render_scene(api.scene, api.opt, write=False)["image"])
    api = PbrtAPI(Options(ray_batch=4096), render_on_world_end=False, device="cpu")
    api.init()
    api.parse_string(text)
    out = render_scene(api.scene, api.opt, write=False, device="cpu")
    assert any(e.fourier_table is not None for e in out["renderer"].compiled.materials)
    got = out["image"]
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close
