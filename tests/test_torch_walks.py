"""The binary and skip-link walks' plain PyTorch versions against the
reference Pallas kernels (run in interpret mode, as the reference's own
tests run them), and the port's default device.

Every walk test packs a 1500-triangle soup with the port's
packer and the reference's and requires the tables to be byte-equal,
then walks 1024 rays with every 97th lane dead through both (the any-hit
walks against the reference's closest-hit mask: a ray is occluded iff
it has a hit within t_max; this spares interpret-mode calls).  Tolerance
(``bvh8_walk.walk_disagreement``): hit masks equal; t within rtol 1e-6;
slot ids equal wherever no second candidate lies within 1e-6 of t (the
port takes each ray's own octant where the TPU took one lane's per
packet, so only exact t ties may resolve differently).  Any hit: masks
equal.  The skip walk also returns barycentrics, compared on lanes that
hit the same triangle: within 2e-5 absolute.  They cannot be held to a
relative tolerance here: XLA on the CPU contracts the reference's
multiply-adds into FMAs, the port rounds every operation (as its CUDA
kernel, built with -fmad=false, does), and b0 = (tv . pv) / det loses
digits to cancellation (the test prints the largest difference).  The
CUDA kernel matches its plain version bit for bit.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.  The file keeps to
four tests: pytest-xdist queues files with more tests first, and this
one must not run ahead of the suite's longest file.  torch and
pbrt_tpu_torch are imported inside the tests: every test worker imports
every test module while collecting.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from pbrt_tpu.accel.bvh import BVHIntersector as RefBVHIntersector
from pbrt_tpu.accel.bvh import build_bvh
from pbrt_tpu.ops.pallas_bvh import PallasBVH, PallasBVH2
from pbrt_tpu.ops.stream_bvh import pack_stream_tables as ref_pack_stream_tables
from pbrt_tpu.ops.stream_bvh import stream_traverse as ref_stream_traverse


def _soup(n, seed=0, scale=0.08):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return c, c + e1, c + e2


def _rays(n=1024, seed=2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((n,), 1e9, np.float32)
    t_max[::97] = 0.0  # dead lanes
    return o, d, t_max


def _agree(want, got, any_hit, tris, o, d, min_hits=20):
    from pbrt_tpu_torch.kernels.bvh8_walk import walk_disagreement

    t_r, slot_r = (np.asarray(x) for x in want)
    t_p, slot_p = (x.numpy() for x in got)
    assert (slot_r >= 0).sum() > min_hits
    problem = walk_disagreement(t_r, slot_r, t_p, slot_p, any_hit, tris, o, d)
    assert problem is None, problem


def test_ordered_walk2_matches_reference():
    import torch

    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2

    p0, p1, p2 = _soup(1500)
    m, x, s, f, c, perm = build_bvh(p0, p1, p2, leaf_size=8)
    tp = (p0[perm], p1[perm], p2[perm])
    ref = PallasBVH2(m, x, s, f, c, *tp, interpret=True)
    port = OrderedBVH2(m, x, s, f, c, *tp, device="cpu")
    assert torch.equal(port.nodes, torch.tensor(np.asarray(ref.nodes_f)))
    assert torch.equal(port.tris, torch.tensor(np.asarray(ref.tris)))
    assert int(port.root[0]) == int(ref.root)
    np.testing.assert_array_equal(port.slot_to_prim, ref.slot_to_prim)
    o, d, t_max = _rays()
    dead = t_max == 0
    want = ref.traverse(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), remap=False)
    for any_hit in (False, True):
        launches = dict(bvh2_walk.LAUNCHES)
        walk = port.occluded_slots if any_hit else port.traverse
        got = walk(*(torch.as_tensor(a) for a in (o, d, t_max)))
        assert bvh2_walk.LAUNCHES == launches  # CPU tensors: plain version, no launch
        # any hit: a ray is occluded iff it has a closest hit within t_max
        _agree(want, got, any_hit, np.asarray(ref.tris), o, d)
        assert (got[1].numpy()[dead] == -1).all()
        assert (got[0].numpy()[dead] == np.float32(-1e30)).all()  # inert


@pytest.mark.parametrize("case", ["clusters", "one_big_cluster"])
def test_stream_walk2_matches_reference(case):
    """``clusters``: a 1500-triangle soup cut into clusters of at most 512
    triangles; ``one_big_cluster``: 3000 triangles in leaves of at most 3
    as one cluster of more than 1024 node rows, which the walk takes like
    any other."""
    import torch

    from pbrt_tpu_torch.ops.stream_bvh import StreamBVH, pack_stream_tables, stream_traverse

    if case == "clusters":
        p0, p1, p2 = _soup(1500, seed=1)
        target, builds = 512, ((32, 32), (16, 16))  # (leaf size, leaf slots)
    else:
        p0, p1, p2 = _soup(3000, seed=1)
        target, builds = 4096, ((3, 8),)
    # the main path's leaves; the walked ones span 2 rows (clusters)
    for leaf_size, leaf_slots in builds:
        m, x, s, f, c, perm = build_bvh(p0, p1, p2, leaf_size=leaf_size)
        tp = (p0[perm], p1[perm], p2[perm])
        ref = ref_pack_stream_tables(m, x, s, f, c, *tp, target_tris=target,
                                     leaf_slots=leaf_slots, wide=False)
        got = pack_stream_tables(m, x, s, f, c, *tp, target_tris=target,
                                 leaf_slots=leaf_slots, wide=False)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    port = StreamBVH(m, x, s, f, c, *tp, target_tris=target, leaf_slots=leaf_slots,
                     wide=False, device="cpu")
    assert port.nodes.shape[2] == 16  # binary clusters
    if case == "clusters":
        assert port.nodes.shape[0] >= 3
    else:
        assert port.nodes.shape[0] == 1 and port.nodes.shape[1] > 1024
    o, d, t_max = _rays(seed=3)
    for fused in (False, True):
        want = ref_stream_traverse(
            *(jnp.asarray(ref[k]) for k in ("nodes", "tris", "roots", "cl_min", "cl_max")),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), leaf_slots=leaf_slots,
            interpret=True, fused=fused)
        for any_hit in (False, True):
            got = stream_traverse(port.nodes, port.tris, port.roots, port.cl_min,
                                  port.cl_max, *(torch.as_tensor(a) for a in (o, d, t_max)),
                                  any_hit=any_hit, fused=fused, depth=port.depth)
            _agree(want, got, any_hit, ref["tris"], o, d)
            assert (got[1].numpy()[t_max == 0] == -1).all()


def test_skip_walk_matches_reference():
    import torch

    from pbrt_tpu_torch.ops.pallas_bvh import SkipLinkBVH

    p0, p1, p2 = _soup(1500, seed=4)
    m, x, s, f, c, perm = build_bvh(p0, p1, p2, leaf_size=4)
    tp = (p0[perm], p1[perm], p2[perm])
    ref = PallasBVH(m, x, s, f, c, *tp, interpret=True)
    port = SkipLinkBVH(m, x, s, f, c, *tp, device="cpu")
    for name in ("nodes_f", "nodes_i", "tris"):
        assert torch.equal(getattr(port, name), torch.tensor(np.asarray(getattr(ref, name))))
    # the reference's CPU walk over the same build (leaf size 4, DFS prims)
    td = types.SimpleNamespace(count=len(p0), p0=p0, p1=p1, p2=p2)
    xla = RefBVHIntersector(td, None, use_pallas=False)
    o, d, t_max = _rays(seed=5)
    dead = t_max == 0
    live = ~dead  # the per-lane reference keeps a dead lane's t_max
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    wants = [ref.traverse(*args), xla._traverse_xla(*args, False)]
    for any_hit in (False, True):
        got = (port.occluded_slots if any_hit else port.traverse)(
            *(torch.as_tensor(a) for a in (o, d, t_max)))
        t_p, prim_p, b0_p, b1_p = (x.numpy() for x in got)
        assert (prim_p[dead] == -1).all() and (t_p[dead] == np.float32(-1e30)).all()
        for want in wants:
            t_r, prim_r, b0_r, b1_r = (np.asarray(v) for v in want)
            _agree((t_r[live], prim_r[live]), (got[0][live], got[1][live]), any_hit,
                   np.asarray(ref.tris), o[live], d[live])
            same = (prim_r >= 0) & (prim_r == prim_p)
            if not any_hit:
                assert same.sum() > 20
                rel = np.abs(b0_p[same] - b0_r[same]) / np.abs(b0_r[same]).clip(1e-30)
                print(f"b0 max |diff| {np.abs(b0_p[same] - b0_r[same]).max():.3e} "
                      f"(relative {rel.max():.3e}), b1 max |diff| "
                      f"{np.abs(b1_p[same] - b1_r[same]).max():.3e}")
                np.testing.assert_allclose(b0_p[same], b0_r[same], rtol=0, atol=2e-5)
                np.testing.assert_allclose(b1_p[same], b1_r[same], rtol=0, atol=2e-5)


def test_renderer_needs_a_card_unless_asked_for_cpu():
    import torch

    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import mesh_scene_description

    desc, opts, _ = mesh_scene_description(xres=8, yres=8, spp=1, maxdepth=1, nu=24, nv=24)
    if torch.cuda.is_available():
        assert Renderer(desc, opts).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Renderer(desc, opts)
    desc, opts, _ = mesh_scene_description(xres=8, yres=8, spp=1, maxdepth=1, nu=24, nv=24)
    assert Renderer(desc, opts, device="cpu").compiled.intersector.perm.device.type == "cpu"
