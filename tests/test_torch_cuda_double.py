"""The float64 policy on the card against the CPU.  Every test here is
marked ``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_double.py -m cuda -q

* K7's double instance (``kernels/anim_walk.anim_walk`` on float64 keys
  and rays) against its plain version run on the card, on a 3-key
  rotating soup of 3000 triangles, closest and any hit: hit masks equal,
  t within rtol 1e-12, prims equal except on exact t ties, b0 and b1
  within 1e-9 absolute (``anim_walk.B_ATOL``; the kernel fuses with
  ``fma``, the plain version rounds twice); the float instance does not
  launch.
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
    torch = _need_card()
    from pbrt_tpu_torch.kernels import anim_walk
    from pbrt_tpu_torch.ops.animated_intersect import AnimatedTriIntersector
    from pbrt_tpu_torch.shapes import TriangleData

    rng = np.random.default_rng(0)
    c = rng.uniform(-1, 1, (3000, 3))
    tri = [c, c + rng.uniform(-0.1, 0.1, (3000, 3)), c + rng.uniform(-0.1, 0.1, (3000, 3))]
    keys = []
    for a in np.radians([0.0, 15.0, 30.0]):
        m = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        p = [v @ m.T for v in tri]
        z = np.zeros((3000, 2))
        keys.append(TriangleData(p[0], p[1], p[2], z, z, z))
    itx = AnimatedTriIntersector(keys, device="cuda")
    assert itx.cols.dtype == torch.float64
    n = 1 << 16
    o = torch.as_tensor(rng.uniform(-1.5, 1.5, (n, 3)), device="cuda")
    d = torch.nn.functional.normalize(torch.randn(n, 3, device="cuda", dtype=torch.float64),
                                      dim=-1)
    t_max = torch.as_tensor(rng.uniform(0.05, 4.0, n), device="cuda")
    t_max[::97] = 0.0
    time = torch.as_tensor(rng.uniform(0, 1, n), device="cuda")
    comps = tuple(x.contiguous() for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                                           d[:, 2], t_max))
    args = (itx.bvh["nodes_f"], itx.bvh["nodes_i"], itx.cols, comps, time)
    host = [x.cpu().numpy() for x in (o, d, time)]
    for any_hit in (False, True):
        anim_walk.reset_launch_counts()
        got = anim_walk.anim_walk(*args, any_hit=any_hit)
        torch.cuda.synchronize()
        assert anim_walk.LAUNCHES == {"anim_walk": 0, "anim_walk_f64": 1}
        assert got[0].dtype == torch.float64
        want = anim_walk.anim_walk_plain(*args, any_hit=any_hit)
        problem = anim_walk.anim_disagreement(
            [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want],
            itx.cols.cpu().numpy(), *host, any_hit, rtol=1e-12)
        assert problem is None, (any_hit, problem)
        assert 0.1 < float((want[1] >= 0).float().mean()) < 0.9


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
