"""The sharded paths' per-shard kernels on the card.  Every test here is
marked ``cuda`` and skips without a card.  The file imports no JAX:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda_sharding.py -m cuda -q

A spawned world of 2 gloo ranks sharing the card
(``parallel/multihost.run_local_world``, with a deadline) renders the
reference test's heightfield (3,042 triangles) at 64x64, 2 spp, maxdepth
3 over (dp, tp) = (1, 2), allreduce and ring, on packed and on skip-link
shard tables.  Rank 0 records the rays of its shard sweeps in each kind's
first case; once the world has exited, each sweep goes through the kernel
and its plain version on the card, on rank 0's shard tables: K2 to the
walk contract (``bvh8_walk.walk_disagreement``: hit masks equal, t within
rtol 1e-6, slots equal except on exact t ties), K6 bit-equal in t,
triangle, b0 and b1.  Every rank holds the same film, and the four images
agree to ``tests/test_torch_slice.py``'s tolerance.
"""

import numpy as np
import pytest

_CASES = [(1, 2, kind, f) for kind in ("packed", "skip") for f in ("allreduce", "ring")]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch


def _check_sweep(torch, shard, o, d, t_max):
    """One recorded sweep through its shard's kernel and plain version ->
    its hit count; raises where they disagree."""
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk
    from pbrt_tpu_torch.ops.stream_bvh import _stream_candidates, split_pad_rays

    n = len(o)
    comps = split_pad_rays(*(torch.as_tensor(a, device="cuda") for a in (o, d, t_max)), n)
    if shard["kind"] == "packed":
        clist, cnt = _stream_candidates(shard["pk_clmin"], shard["pk_clmax"], comps)
        args = (shard["pk_nodes"], shard["pk_tris"], shard["pk_roots"], clist, cnt, comps)
        kw = {"depth": shard["depth"]}
        kern, plain = bvh8_walk.stream_walk8(*args, **kw), bvh8_walk.stream_walk8_plain(*args, **kw)
        tris = shard["pk_tris"]
    else:
        args = (shard["sk_nodes_f"], shard["sk_nodes_i"], shard["sk_tris"], comps)
        kern, plain = bvh2_walk.skip_walk(*args), bvh2_walk.skip_walk_plain(*args)
        for i, (k, p) in enumerate(zip(kern, plain)):
            assert torch.equal(k, p), f"skip_walk output {i} (t, prim, b0, b1) not bit-equal"
        tris = shard["sk_tris"]
    t_k, s_k = (x[:n].cpu().numpy() for x in kern[:2])
    t_p, s_p = (x[:n].cpu().numpy() for x in plain[:2])
    problem = bvh8_walk.walk_disagreement(t_p, s_p, t_k, s_k, False, tris.cpu().numpy(), o, d)
    assert problem is None, f"{shard['kind']} shard: {problem}"
    return int((s_p >= 0).sum())


@pytest.mark.cuda
def test_shard_kernels_match_plain_versions():
    torch = _need_card()
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk
    from pbrt_tpu_torch.parallel import geomshard as G
    from pbrt_tpu_torch.parallel.multihost import run_local_world
    from pbrt_tpu_torch.parallel.worlds import heightfield_scene, rank_geomshard, rank_tasks

    task = (rank_geomshard, dict(cases=_CASES, res=64, spp=2, record_rank=0))
    world = [w[0] for w in run_local_world(rank_tasks, 2, backend="gloo", device="cuda",
                                           timeout_s=300, args=([task],))]
    for kind, kernel in (("packed", "stream_walk8"), ("skip", "skip_walk")):
        sweeps = world[0]["sweeps"][kind]
        assert len(sweeps) == 3, kind
        shard = G.local_shard(G.shard_triangle_arrays(*heightfield_scene(), 2, bvh=True,
                                                      packed=kind == "packed"), 0, "cuda")
        counts = (bvh8_walk if kind == "packed" else bvh2_walk).LAUNCHES
        before = counts[kernel]
        assert sum(_check_sweep(torch, shard, *sw) for sw in sweeps) > 0, kind
        assert counts[kernel] == before + 3, kind
        for case in _CASES:
            if case[2] == kind:
                want = 3 * (2 if case[3] == "ring" else 1)
                assert [r["launches"][case][kernel] for r in world] == [want, want], case
    assert world[0]["transport"]["ring"] == "gloo via host"
    base = world[0]["images"][_CASES[0]]
    assert np.isfinite(base).all() and base.max() > 0
    for case in _CASES:
        img = world[0]["images"][case]
        np.testing.assert_array_equal(world[1]["images"][case], img)
        rel_mean = abs(img.mean() - base.mean()) / base.mean()
        close = np.isclose(img, base, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
        assert rel_mean <= 1e-3 and close >= 0.99, case
