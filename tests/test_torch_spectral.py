"""Sampled-spectrum rendering in pbrt_tpu_torch against the JAX reference.

- ``promote_rgb`` (the Smits promotion of a pass's three bins, by the
  illuminant and the reflectance basis) and ``rgb_to_sampled``: bit-equal
  to the reference's on seeded colours, RGB unchanged outside a pass.
- A 12x12 render at 15 bins (5 passes; a matte sphere and a plastic
  floor whose Kd is an image map, under an environment map, a point
  light and a projection light with its own map, path, maxdepth 3; the
  three maps written as PFM from a numpy seed, so texels, the mapped
  environment and a light's map promote in every pass) against
  the reference's ``render_scene`` with ``sampled_spectrum``, to the image
  tolerance of the other scene tests (image-mean relative difference
  <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol 1e-4); the same scene
  through the pbrt command's ``--sampled-spectrum`` writes that image.
- The pass state is cleared when the bin count is refused and when a
  pass raises.

torch and pbrt_tpu_torch are imported inside the tests.
"""

import numpy as np
import pytest

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core import spectrum as ref_spectrum
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.render import render_scene as ref_render_scene

SCENE = """
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 3
Film "image" "integer xresolution" [12] "integer yresolution" [12] "string filename" "{out}"
WorldBegin
LightSource "infinite" "rgb L" [1 0.9 0.8] "string mapname" "{env}"
LightSource "point" "rgb I" [3 2 1] "point from" [1 1 -2]
AttributeBegin
  Translate 0 3 0
  Rotate 90 1 0 0
  LightSource "projection" "rgb I" [2 2 2] "float fov" 60 "string mapname" "{proj}"
AttributeEnd
Material "matte" "rgb Kd" [0.8 0.3 0.1]
Shape "sphere" "float radius" 1
Texture "floor" "spectrum" "imagemap" "string filename" "{tex}"
Material "plastic" "texture Kd" "floor" "rgb Ks" [0.3 0.3 0.3]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-3 -1 -3  3 -1 -3  3 -1 3  -3 -1 3]
WorldEnd
"""


def _write_maps(d):
    """The scene's three maps as PFM files from a numpy seed: saturated
    texels, so the promotion's bins differ from RGB."""
    rs = np.random.default_rng(11)
    names = {}
    for key, (w, h) in (("env", (16, 8)), ("proj", (8, 8)), ("tex", (8, 8))):
        rgb = rs.uniform(0.02, 1.0, size=(h, w, 3)).astype("<f4")
        name = str(d / f"{key}.pfm")
        with open(name, "wb") as f:
            f.write(f"PF\n{w} {h}\n-1\n".encode())
            f.write(rgb.tobytes())
        names[key] = name
    return names


def _port_scene(text):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI

    api = PbrtAPI(Options(ray_batch=4096), render_on_world_end=False, device="cpu")
    api.init()
    api.parse_string(text)
    return api.scene


def test_promote_rgb_matches_reference():
    from pbrt_tpu_torch.core import spectrum

    rgb = np.random.default_rng(4).uniform(0.0, 1.5, size=(500, 3))
    rgb[:6] = [[1, 1, 1], [0, 0, 0], [1, 0, 0], [0.2, 0.2, 0.9], [0.5, 0.9, 0.5], [2, 1, 1]]
    for illuminant in (False, True):
        np.testing.assert_array_equal(spectrum.rgb_to_sampled(rgb, illuminant),
                                      ref_spectrum.rgb_to_sampled(rgb, illuminant))
    assert spectrum.get_spectral_bins() is None
    np.testing.assert_array_equal(spectrum.promote_rgb(rgb), rgb.astype(np.float32))
    try:
        for bins in ([1, 21, 41], [0, 30, 59]):
            spectrum.set_spectral_bins(bins)
            ref_spectrum.set_spectral_bins(bins)
            for illuminant in (False, True):
                got = spectrum.promote_rgb(rgb, illuminant=illuminant)
                assert got.dtype == np.float32 and got.shape == rgb.shape
                np.testing.assert_array_equal(got, ref_spectrum.promote_rgb(rgb, illuminant))
    finally:
        spectrum.set_spectral_bins(None)
        ref_spectrum.set_spectral_bins(None)
    with pytest.raises(ValueError):
        spectrum.set_spectral_bins([1, 2])


def test_spectral_render_matches_reference(tmp_path):
    from pbrt_tpu_torch import Options, cli
    from pbrt_tpu_torch.core.imageio import read_image
    from pbrt_tpu_torch.render import render_scene

    text = SCENE.format(out=tmp_path / "cli.pfm", **_write_maps(tmp_path))
    api = RefAPI(RefOptions(ray_batch=4096), render_on_world_end=False)
    api.init()
    api.parse_string(text)
    want = np.asarray(ref_render_scene(
        api.scene, RefOptions(ray_batch=4096, sampled_spectrum=True, n_spectral_bins=15),
        write=False)["image"])
    opts = Options(ray_batch=4096, sampled_spectrum=True, n_spectral_bins=15)
    out = render_scene(_port_scene(text), opts, write=False, device="cpu")
    got = out["image"]
    assert set(out) == {"image", "film", "seconds", "xyz"} and got.shape == (12, 12, 3)
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close
    # and differs from the RGB render (saturated colours, three bounces)
    rgb = render_scene(_port_scene(text), Options(ray_batch=4096), write=False,
                       device="cpu")["image"]
    assert np.abs(rgb - got).max() > 1e-3

    (tmp_path / "s.pbrt").write_text(text)
    assert cli.main([str(tmp_path / "s.pbrt"), "--ray-batch", "4096", "--sampled-spectrum",
                     "-q"], device="cpu") == 0
    written, _ = read_image(str(tmp_path / "cli.pfm"))
    np.testing.assert_allclose(np.asarray(written).reshape(got.shape), got, rtol=1e-6)


def test_pass_state_cleared_after_a_raise(monkeypatch, tmp_path):
    from pbrt_tpu_torch import Options, render
    from pbrt_tpu_torch.core import spectrum

    text = SCENE.format(out="unused.pfm", **_write_maps(tmp_path))
    with pytest.raises(ValueError):
        render.render_scene(_port_scene(text), Options(sampled_spectrum=True, n_spectral_bins=14),
                            write=False, device="cpu")
    assert spectrum.get_spectral_bins() is None

    seen = []

    class Failing:
        def __init__(self, *a, **kw):
            seen.append(spectrum.get_spectral_bins().tolist())
            if len(seen) == 2:
                raise RuntimeError("a pass fails")
            raise_later.append(1)
            self._real = real(*a, **kw)

        def __getattr__(self, name):
            return getattr(self._real, name)

    raise_later = []
    real = render.Renderer
    monkeypatch.setattr(render, "Renderer", Failing)
    with pytest.raises(RuntimeError, match="a pass fails"):
        render.render_scene(_port_scene(text), Options(ray_batch=4096, sampled_spectrum=True,
                                                       n_spectral_bins=15),
                            write=False, device="cpu")
    assert seen == [[2, 6, 10], [14, 18, 22]] and raise_later == [1]
    assert spectrum.get_spectral_bins() is None
