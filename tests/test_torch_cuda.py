"""pbrt_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card.  Every test here is marked ``cuda`` and skips without a card
(the kernels have no CPU mode).  The file imports no JAX, so it also runs
where JAX is not installed:

    PBRT_TPU_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda -q

(``PBRT_TPU_TEST_TPU=1`` keeps tests/conftest.py from switching JAX to
its CPU mesh.)  torch and the port are imported only once a test knows
it has a card: every test worker imports this module while collecting.
The file keeps to four tests or fewer: pytest-xdist queues files with
more tests first, and this one must not run ahead of the suite's longest
file.
"""

import numpy as np
import pytest


def _soup(n, seed=0, scale=0.08):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((n,), 1e9, np.float32)
    t_max[::97] = 0.0  # dead lanes
    return o, d, t_max


def _need_card():
    """Skip without a card; else return the modules the tests use."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from pbrt_tpu_torch.accel import bvh
    from pbrt_tpu_torch.kernels import bvh8_walk
    from pbrt_tpu_torch.ops import bvh8, stream_bvh

    return torch, bvh, bvh8_walk, bvh8, stream_bvh


def _agree(kern, plain, any_hit, tris, o, d):
    from pbrt_tpu_torch.kernels import bvh8_walk

    t_k, s_k = (x.cpu().numpy() for x in kern)
    t_p, s_p = (x.numpy() for x in plain)
    n = len(o)
    problem = bvh8_walk.walk_disagreement(t_p[:n], s_p[:n], t_k[:n], s_k[:n], any_hit,
                                          tris, o, d)
    assert problem is None, problem


@pytest.mark.cuda
def test_stream_kernel_matches_plain():
    torch, bvh, bvh8_walk, _, stream_bvh = _need_card()
    p0, p1, p2 = _soup(20000, seed=1)
    m, x, s, f, c, perm = bvh.build_bvh(p0, p1, p2, leaf_size=32)
    sb = stream_bvh.StreamBVH(m, x, s, f, c, p0[perm], p1[perm], p2[perm],
                              target_tris=4096, device="cuda")
    o, d, t_max = _rays(8192, seed=4)
    comps = stream_bvh.split_pad_rays(
        *(torch.as_tensor(a, device="cuda") for a in (o, d, t_max)), 8192)
    clist, cnt = stream_bvh._stream_candidates(sb.cl_min, sb.cl_max, comps)
    for any_hit in (False, True):
        before = bvh8_walk.LAUNCHES["stream_walk8"]
        kern = bvh8_walk.stream_walk8(sb.nodes, sb.tris, sb.roots, clist, cnt, comps,
                                      any_hit=any_hit, depth=sb.depth)
        torch.cuda.synchronize()
        assert bvh8_walk.LAUNCHES["stream_walk8"] == before + 1
        plain = bvh8_walk.stream_walk8_plain(
            sb.nodes.cpu(), sb.tris.cpu(), sb.roots.cpu(), clist.cpu(), cnt.cpu(),
            tuple(x.cpu() for x in comps), any_hit=any_hit)
        _agree(kern, plain, any_hit, sb.tris.cpu().numpy(), o, d)


@pytest.mark.cuda
def test_wide_kernel_matches_plain():
    torch, bvh, bvh8_walk, bvh8, stream_bvh = _need_card()
    p0, p1, p2 = _soup(3000)
    m, x, s, f, c, perm = bvh.build_bvh(p0, p1, p2, leaf_size=16)
    wide = bvh8.WideBVH8(m, x, s, f, c, p0[perm], p1[perm], p2[perm], device="cuda")
    o, d, t_max = _rays(8192, seed=5)
    comps = stream_bvh.split_pad_rays(
        *(torch.as_tensor(a, device="cuda") for a in (o, d, t_max)), 8192)
    for any_hit in (False, True):
        kern = bvh8_walk.wide_walk8(wide.nodes, wide.tris, wide.root, comps,
                                    any_hit=any_hit, depth=wide.depth)
        torch.cuda.synchronize()
        plain = bvh8_walk.wide_walk8_plain(
            wide.nodes.cpu(), wide.tris.cpu(), wide.root.cpu(),
            tuple(x.cpu() for x in comps), any_hit=any_hit)
        _agree(kern, plain, any_hit, wide.tris.cpu().numpy(), o, d)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs():
    torch, _, bvh8_walk, _, _ = _need_card()
    comps = tuple(torch.zeros(1024, device="cuda") for _ in range(7))
    nodes = torch.zeros(8, 64, device="cuda")
    tris = torch.zeros(8, 128, device="cuda")
    with pytest.raises(TypeError):
        bvh8_walk.wide_walk8(nodes, tris, torch.zeros(1, device="cuda"), comps)
    with pytest.raises(ValueError):
        bvh8_walk.wide_walk8(nodes[:, ::2], tris, torch.zeros(1, dtype=torch.int32,
                                                              device="cuda"), comps)


@pytest.mark.cuda
def test_binary_walks_and_bitonic_match_plain():
    """The binary walks (whole tree, streaming, fused streaming), the
    skip-link walk and the bitonic network against their plain versions:
    walks to ``walk_disagreement`` (skip walk b0/b1 equal on equal slots),
    the network bit for bit."""
    torch, bvh, _, _, stream_bvh = _need_card()
    from pbrt_tpu_torch.kernels import bitonic, bvh2_walk
    from pbrt_tpu_torch.ops import pallas_bvh, sortnet

    p0, p1, p2 = _soup(20000, seed=6)
    o, d, t_max = _rays(8192, seed=7)
    rays = [torch.as_tensor(a, device="cuda") for a in (o, d, t_max)]
    comps = stream_bvh.split_pad_rays(*rays, 8192)
    cpu = tuple(x.cpu() for x in comps)
    m, x, s, f, c, perm = bvh.build_bvh(p0, p1, p2, leaf_size=32)
    tp = (p0[perm], p1[perm], p2[perm])
    sb = stream_bvh.StreamBVH(m, x, s, f, c, *tp, target_tris=4096, wide=False,
                              device="cuda")
    clist, cnt = stream_bvh._stream_candidates(sb.cl_min, sb.cl_max, comps)
    tables = (sb.nodes, sb.tris, sb.roots, clist, cnt)
    for fused in (False, True):
        for any_hit in (False, True):
            kern = bvh2_walk.stream_walk2(*tables, comps, any_hit=any_hit, fused=fused,
                                          depth=sb.depth)
            torch.cuda.synchronize()
            plain = bvh2_walk.stream_walk2_plain(*(t.cpu() for t in tables), cpu,
                                                 any_hit=any_hit, fused=fused, depth=sb.depth)
            _agree(kern, plain, any_hit, sb.tris.cpu().numpy(), o, d)
    m, x, s, f, c, perm = bvh.build_bvh(p0[:3000], p1[:3000], p2[:3000], leaf_size=8)
    tp = (p0[perm], p1[perm], p2[perm])
    whole = pallas_bvh.OrderedBVH2(m, x, s, f, c, *tp, device="cuda")
    m, x, s, f, c, perm = bvh.build_bvh(p0[:3000], p1[:3000], p2[:3000], leaf_size=4)
    skip = pallas_bvh.SkipLinkBVH(m, x, s, f, c, p0[perm], p1[perm], p2[perm],
                                  device="cuda")
    for any_hit in (False, True):
        kern = bvh2_walk.ordered_walk2(whole.nodes, whole.tris, whole.root, comps, any_hit,
                                       depth=whole.depth)
        torch.cuda.synchronize()
        plain = bvh2_walk.ordered_walk2_plain(whole.nodes.cpu(), whole.tris.cpu(),
                                              whole.root.cpu(), cpu, any_hit, depth=whole.depth)
        _agree(kern, plain, any_hit, whole.tris.cpu().numpy(), o, d)
        kern = bvh2_walk.skip_walk(skip.nodes_f, skip.nodes_i, skip.tris, comps, any_hit)
        torch.cuda.synchronize()
        plain = bvh2_walk.skip_walk_plain(skip.nodes_f.cpu(), skip.nodes_i.cpu(),
                                          skip.tris.cpu(), cpu, any_hit)
        _agree(kern[:2], plain[:2], any_hit, skip.tris.cpu().numpy(), o, d)
        same = (plain[1] >= 0) & (plain[1] == kern[1].cpu())
        for b in (2, 3):
            assert torch.equal(kern[b].cpu()[same], plain[b][same])

    rng = np.random.default_rng(8)
    n = 1 << 18
    keys = (rng.integers(0, 64, n).astype(np.int64) * 977) | (
        rng.integers(0, 2, n).astype(np.int64) << 31)
    cols = (torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32)),
            torch.arange(n, dtype=torch.int32))
    before = dict(bitonic.LAUNCHES)
    calls = sum(bitonic.HOST_CALLS.values())
    got = sortnet.co_sort((torch.as_tensor(keys, device="cuda"),
                           *(x.cuda() for x in cols)), network="bitonic")
    torch.cuda.synchronize()
    assert sum(bitonic.HOST_CALLS.values()) == calls + 1
    assert bitonic.LAUNCHES["bitonic_tile"] == before["bitonic_tile"] + 6
    assert bitonic.LAUNCHES["bitonic_merge"] == before["bitonic_merge"] + 5
    assert bitonic.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    want = sortnet.co_sort((torch.as_tensor(keys), *cols), network="bitonic")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
