"""The scene-file front door of pbrt_tpu_torch on the CPU: ``cli.main``
against ``pbrt_tpu.cli.main`` on one scene file, the command's flags and
exit codes, and checkpoint / resume (the port's counterparts of
``tests/test_checkpoint.py``).

The scene file is ``testscenes.scenefile_text`` cut to 16x16, 2 spp,
maxdepth 2: a binary PLY torus placed twice with ``ObjectInstance``, a
heightfield, a Loop-subdivided icosahedron and the disk area light, under
marble, mix, the 3D checkerboard, planar dots, wrinkled and fbm textures,
with ``Sampler "sobol"``.  Both commands write PFMs; the images agree to
``tests/test_torch_slice.py``'s tolerance (image-mean relative
difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol 1e-4).

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting, and importing torch
there would add seconds to the whole suite's critical path.
"""

import numpy as np
import pytest

from pbrt_tpu.cli import main as ref_main


def _scene(tmp_path, **kw):
    from pbrt_tpu_torch.testscenes import scenefile_text, write_torus_ply

    ply = tmp_path / "torus.ply"
    write_torus_ply(ply, nu=16, nv=8)
    text = scenefile_text(str(ply), **{
        **dict(xres=16, yres=16, spp=2, maxdepth=2, sampler="sobol", instances=2,
               heightfield=8, loop_levels=1, quadrics=(), nurbs=False,
               filename=str(tmp_path / "film.pfm")), **kw})
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    return str(path)


def _read(path):
    from pbrt_tpu_torch.core.imageio import read_image

    return read_image(str(path))[0]


def test_cli_image_matches_reference(tmp_path):
    """The same scene file through both commands, ``-o x.pfm`` each."""
    scene = _scene(tmp_path)
    from pbrt_tpu_torch.cli import main

    assert main([scene, "-q", "--ray-batch", "1024", "-o", str(tmp_path / "port.pfm")],
                device="cpu") == 0
    assert ref_main([scene, "-q", "--ray-batch", "1024", "-o", str(tmp_path / "ref.pfm")]) == 0
    got, want = _read(tmp_path / "port.pfm"), _read(tmp_path / "ref.pfm")
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    assert rel_mean <= 1e-3, rel_mean
    assert close >= 0.99, close
    assert not (tmp_path / "film.pfm").exists()


def test_cli_flags_and_exit_codes(tmp_path):
    """Exit 1 on a parse error and on a missing file; ``--quick``
    quarters the resolution and the spp; ``-o`` wins over the film's
    filename; the command refuses to start without a card."""
    import torch

    from pbrt_tpu_torch.cli import main
    from pbrt_tpu_torch.testscenes import cornell_text
    from pbrt_tpu_torch.utils import stats

    bad = tmp_path / "bad.pbrt"
    bad.write_text('Camera "perspective"\nWorldBegin\nShape "sphere" "float radius" [1\n')
    assert main([str(bad), "-q"], device="cpu") == 1
    assert main([str(tmp_path / "missing.pbrt"), "-q"], device="cpu") == 1

    scene = tmp_path / "cornell.pbrt"
    scene.write_text(cornell_text(xres=16, yres=16, spp=8, maxdepth=2,
                                  filename=str(tmp_path / "film.pfm")))
    stats.reset()
    assert main([str(scene), "-q", "--quick", "-o", str(tmp_path / "quick.pfm")],
                device="cpu") == 0
    assert _read(tmp_path / "quick.pfm").shape == (4, 4, 3)
    assert stats.snapshot()["counters"]["render/camera_samples"] == 4 * 4 * 2
    assert not (tmp_path / "film.pfm").exists()
    assert main([str(scene), "-q"], device="cpu") == 0
    assert _read(tmp_path / "film.pfm").shape == (16, 16, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            main([str(scene), "-q"])


def _cornell(tmp, spp=2, ckpt=True):
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import cornell_description

    desc, _ = cornell_description(xres=24, yres=24, spp=spp, maxdepth=2)
    opt = Options(ray_batch=128, checkpoint_dir=str(tmp) if ckpt else None,
                  checkpoint_every=1)
    return Renderer(desc, opt, device="cpu")


def test_checkpoint_resume_and_stats(tmp_path):
    """A render killed after 3 of its 9 chunks resumes in a fresh
    Renderer bit for bit; the last checkpoint reloads into the final film
    state; a checkpoint of another render is ignored; the stats counters
    are live."""
    import torch

    from pbrt_tpu_torch.utils import stats
    from pbrt_tpu_torch.utils.checkpoint import load_checkpoint

    r_ref = _cornell(tmp_path / "ref")
    state_ref = r_ref.render(progress=False)
    assert r_ref.counters["chunks"] == 9
    loaded = load_checkpoint(tmp_path / "ref" / "film.ckpt.npz", "cpu")
    assert loaded is not None and loaded[1] == 9
    for k in ("xyz", "weight"):
        assert torch.equal(loaded[0][k], state_ref[k])

    r1 = _cornell(tmp_path / "kill")
    calls = {"n": 0}
    radiance = r1._radiance

    def dying(*a, **kw):
        if calls["n"] >= 3:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return radiance(*a, **kw)

    r1._radiance = dying
    with pytest.raises(KeyboardInterrupt):
        r1.render(progress=False)
    assert load_checkpoint(tmp_path / "kill" / "film.ckpt.npz", "cpu")[1] == 3
    r2 = _cornell(tmp_path / "kill")
    img2 = r2.image(r2.render(progress=False))
    assert r2.counters["chunks"] == 6
    np.testing.assert_array_equal(img2, r_ref.image(state_ref))

    r3 = _cornell(tmp_path / "ref", spp=4)  # the meta differs: a fresh render
    img3 = r3.image(r3.render(progress=False))
    assert r3.counters["chunks"] == 18
    assert np.isfinite(img3).all() and img3.max() > 0
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "film.ckpt.npz").write_bytes(b"PK\x03\x04 not a zip")
    assert load_checkpoint(tmp_path / "bad" / "film.ckpt.npz", "cpu") is None

    stats.reset()
    _cornell(tmp_path, ckpt=False).render(progress=False)
    snap = stats.snapshot()["counters"]
    assert snap["scene/lights"] >= 1 and snap["scene/triangles"] >= 10
    assert snap["render/chunks"] == 9 and snap["render/camera_samples"] == 24 * 24 * 2
    assert "Statistics:" in stats.report()
