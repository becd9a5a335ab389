"""The float64 policy on the card against the CPU.  Every test here is
marked ``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_double.py -m cuda -q

* K7's double instance (``kernels/anim_walk.anim_walk`` on float64 keys
  and rays) against its plain version run on the card, on rotating soups
  of 3000 triangles in 1, 2 and 4 keys, on sparse and dense sweeps and
  times on the keys, closest and any hit
  (``tests/test_torch_cuda_motion.check_k7_sweeps``): hit masks equal, t
  within rtol 1e-12, prims equal except on exact t ties, b0 and b1 within
  1e-9 absolute (``anim_walk.B_ATOL``; the kernel fuses with ``fma``, the
  plain version rounds twice); the float instance does not launch.
* Config 3 in double at 32x32, 4 spp, maxdepth 4: a float64 image on the
  card (K2 on the float32-cast rays) against the same frame on the CPU,
  to ``tests/test_torch_slice.py``'s tolerance (image-mean relative
  difference <= 1e-3, >= 99% of pixels within rtol 1e-3 / atol 1e-4).

torch and the port are imported only once a test knows it has a card.
"""

import numpy as np
import pytest


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


@pytest.mark.cuda
def test_anim_walk_double_kernel_matches_plain():
    """tests/test_torch_cuda_motion.py's :func:`check_k7_sweeps` on the
    double instance (t within rtol 1e-12, b0 and b1 within 1e-9); the float
    instance does not launch."""
    from test_torch_cuda_motion import check_k7_sweeps

    check_k7_sweeps(_need_card(), np.float64, 1e-12)


@pytest.mark.cuda
def test_config3_double_card_matches_cpu():
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    images = {}
    for dev in ("cuda", "cpu"):
        r, _ = mesh_scene_renderer(xres=32, yres=32, spp=4, maxdepth=4, device=dev,
                                   double=True)
        bvh8_walk.reset_launch_counts()
        images[dev] = r.image(r.render(progress=False))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert bvh8_walk.LAUNCHES["stream_walk8"] > 0
    got, want = images["cuda"], images["cpu"]
    assert got.dtype == want.dtype == np.float64
    assert np.isfinite(got).all() and got.max() > 0
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    print(f"config 3 double: mean rel diff {rel_mean:.3e}, {close:.4f} of pixels close")
    assert rel_mean <= 1e-3 and close >= 0.99
