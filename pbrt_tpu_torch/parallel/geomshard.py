"""Geometry-sharded rendering: triangles distributed over the mesh's tp
axis (counterpart of ``pbrt_tpu/parallel/geomshard.py``).

BASELINE config 5: a scene too big to replicate is split into ``tp``
contiguous triangle slices, one a rank; a (dp, tp) mesh then gives:

* rays sharded over dp, replicated over tp;
* triangles sharded over tp, replicated over dp;
* closest hit = a sweep over this rank's slice, then an all-reduce (MIN)
  of the hit distance over tp, an all-reduce (MIN) of the (t, gid) tie
  key, and a masked-sum all-reduce that broadcasts the winner's
  attribute row (:func:`allreduce_closest`).

The ring formulation (:func:`ring_closest_hit`) shards the rays over tp
as well: each rank owns rays / tp lanes, and the ray packet (origins,
directions, the running best-hit record) rotates tp times around the tp
ring by point-to-point sends (``batch_isend_irecv``), visiting every
slice once, with the same (t, gid) tie-break.

A slice's sweep (:func:`local_closest_hit`) follows its tables:

* packed (``shard_triangle_arrays(..., packed=True)``): per-shard
  streaming BVH8 tables with 16-triangle leaves, walked by K2
  (``kernels/bvh8_walk.stream_walk8``) on the card and by K2's plain
  version on the CPU (where the reference's CPU takes its XLA walk);
* skip-link (``bvh=True``): per-shard trees with 4-triangle leaves,
  walked by K6 (``kernels/bvh2_walk.skip_walk``), which returns
  barycentrics as the reference's ``_local_bvh_hit`` does;
* brute (neither): plain PyTorch in chunks of 256 triangles, as the
  reference's scan (no kernel does this in either package).

Ties: across slices exact t ties go to the lowest global id; inside a
slice each walk resolves them in its own visiting order (the reference's
XLA walk compares gids), so images may differ only on such ties.

Collectives run on the tp group of the mesh (``multihost.axis``);
``TRANSPORT`` records which transport each kind took.  Gloo all-reduces
CUDA tensors itself; its point-to-point sends are not relied on for
them, so under gloo the ring's exchange stages a CUDA packet through
host tensors (:func:`ring_exchange`).  That is transport only: every
sweep runs where the tables lie.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from pbrt_tpu_torch import torch_dtype
from pbrt_tpu_torch.ops.intersect import RAY_EPS
from pbrt_tpu_torch.parallel.multihost import all_reduce_mesh, axis

INF_T = 1e8
NO_GID = 1 << 30  # the gid of padding triangles and of "no hit"
SHARD_LEAF = 4  # triangles per leaf of the skip-link shard trees
PACKED_LEAF = 16  # slots per leaf of the packed shard tables
BRUTE_CHUNK = 256

# attribute row layout: p0 p1 p2 | n0 n1 n2 | uv0 uv1 uv2 | mat light gid
_ROW_VEC = (("p0", 3), ("p1", 3), ("p2", 3), ("n0", 3), ("n1", 3), ("n2", 3),
            ("uv0", 2), ("uv1", 2), ("uv2", 2))
_REC_VEC = ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2")

#: collective kind -> transport it took last ("nccl", "gloo", "gloo via host")
TRANSPORT: dict = {}


def shard_triangle_arrays(tri_data, tri_mat, tri_light, n_shards: int, bvh: bool = False,
                          packed: bool = False):
    """Pad and split the triangle SoA into host arrays [n_shards, per, ...]
    (the reference's ``shard_triangle_arrays``, whose last argument is
    called ``pallas``: here ``packed``, the streaming-kernel tables).

    Keys p0 p1 p2 uv0 uv1 uv2 n0 n1 n2 (the scene's float), mat and light (int32,
    -1 pads), valid, gid (global triangle id, 2^30 pads).  ``bvh`` adds a
    per-shard binned-SAH tree with 4-triangle leaves and reorders each
    shard's triangles into its DFS-leaf order: ``bvh_min/bvh_max [S, M,
    3]``, ``bvh_skip/bvh_first/bvh_count [S, M]`` (padded to the largest
    shard), ``nn [S]``.  ``packed`` (implies ``bvh``) builds the trees with
    16-triangle leaves and packs each into streaming BVH8 cluster tables,
    padded to the largest shard: ``pk_nodes [S, C, NP, 64]``, ``pk_tris
    [S, C, LP, 128]``, ``pk_roots [S, C]`` (-1, an empty leaf, on padded
    clusters), ``pk_clmin/pk_clmax [S, C, 3]`` (+inf on padded clusters:
    no ray enters them), ``pk_s2p [S, C * LP * 8]``, ``leaf_tag [S, 16]``
    and the winner-attribute rows ``attr_rows [S, per, 27]``.  The
    reference also reads ``PBRT_TPU_WIDE`` here; the port's tables are
    always BVH8 (K2's)."""
    from pbrt_tpu_torch.accel.bvh import build_bvh
    from pbrt_tpu_torch.shapes import concat_triangle_data

    if packed:
        bvh = True
    t = tri_data.count
    per = -(-t // n_shards)
    total = per * n_shards
    if tri_data.n0 is None:
        tri_data = concat_triangle_data([tri_data])

    def pad(a, fill=0.0):
        # a copy: the shards are reordered in place below, and the
        # reference's np.asarray would reorder the caller's mat and light
        a = np.array(a)
        if len(a) < total:
            a = np.concatenate([a, np.full((total - len(a),) + a.shape[1:], fill, a.dtype)])
        return a.reshape(n_shards, per, *a.shape[1:])

    # the record columns keep the scene's float (the policy's)
    out = {k: pad(getattr(tri_data, k).astype(tri_data.p0.dtype)) for k in _REC_VEC}
    out["mat"] = pad(np.asarray(tri_mat, dtype=np.int32), fill=-1)
    out["light"] = pad(np.asarray(tri_light, dtype=np.int32), fill=-1)
    out["valid"] = pad(np.ones(t, dtype=bool), fill=False)
    out["gid"] = pad(np.arange(t, dtype=np.int32), fill=NO_GID)
    if not bvh:
        return out

    leaf = PACKED_LEAF if packed else SHARD_LEAF
    trees = []
    for s in range(n_shards):
        v = int(out["valid"][s].sum())
        if v == 0:
            trees.append((np.zeros((1, 3), np.float32), np.full((1, 3), -1.0, np.float32),
                          np.ones(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int32)))
            continue
        mins, maxs, skips, firsts, counts, perm = build_bvh(
            out["p0"][s][:v], out["p1"][s][:v], out["p2"][s][:v], leaf)
        order = np.concatenate([perm, np.arange(v, per)])
        for k in list(out):
            out[k][s] = out[k][s][order]
        trees.append((mins, maxs, skips, firsts, counts))
    nns = [0 if int(out["valid"][s].sum()) == 0 else len(trees[s][0])
           for s in range(n_shards)]
    m_pad = max(8, max(len(tr[0]) for tr in trees))

    def pad_nodes(i, fill, dtype):
        arrs = [tr[i] for tr in trees]
        res = np.full((n_shards, m_pad) + arrs[0].shape[1:], fill, dtype=dtype)
        for s, a in enumerate(arrs):
            res[s, :len(a)] = a
        return res

    out["bvh_min"] = pad_nodes(0, np.inf, np.float32)
    out["bvh_max"] = pad_nodes(1, -np.inf, np.float32)
    out["bvh_skip"] = pad_nodes(2, m_pad, np.int32)
    out["bvh_first"] = pad_nodes(3, 0, np.int32)
    out["bvh_count"] = pad_nodes(4, 0, np.int32)
    out["nn"] = np.asarray(nns, dtype=np.int32)
    if not packed:
        return out

    from pbrt_tpu_torch.ops.stream_bvh import pack_stream_tables

    packs = []
    for s in range(n_shards):
        v = int(out["valid"][s].sum())
        packs.append(None if v == 0 else pack_stream_tables(
            *trees[s], out["p0"][s][:v], out["p1"][s][:v], out["p2"][s][:v],
            leaf_slots=leaf, wide=True))
    live = [p for p in packs if p]
    c_pad = max(1, max((p["nodes"].shape[0] for p in live), default=1))
    np_pad = max(8, max((p["nodes"].shape[1] for p in live), default=8))
    lp_pad = max(8, max((p["tris"].shape[1] for p in live), default=8))
    spc = lp_pad * 8  # slots per cluster at the padded row count
    pk_nodes = np.zeros((n_shards, c_pad, np_pad, 64), np.float32)
    pk_tris = np.zeros((n_shards, c_pad, lp_pad, 128), np.float32)
    pk_roots = np.full((n_shards, c_pad), -1, np.int32)
    pk_clmin = np.full((n_shards, c_pad, 3), np.inf, np.float32)
    pk_clmax = np.full((n_shards, c_pad, 3), np.inf, np.float32)
    pk_s2p = np.zeros((n_shards, c_pad, spc), np.int32)
    for s, p in enumerate(packs):
        if p is None:
            continue
        c_s, np_s, lp_s = p["nodes"].shape[0], p["nodes"].shape[1], p["tris"].shape[1]
        pk_nodes[s, :c_s, :np_s] = p["nodes"]
        pk_tris[s, :c_s, :lp_s] = p["tris"]
        pk_roots[s, :c_s] = p["roots"]
        pk_clmin[s, :c_s] = p["cl_min"]
        pk_clmax[s, :c_s] = p["cl_max"]
        old_spc = p["slots_per_cluster"]
        pk_s2p[s, :c_s, :old_spc] = p["slot_to_prim"].reshape(c_s, old_spc).astype(np.int32)
    out.update(pk_nodes=pk_nodes, pk_tris=pk_tris, pk_roots=pk_roots, pk_clmin=pk_clmin,
               pk_clmax=pk_clmax, pk_s2p=pk_s2p.reshape(n_shards, c_pad * spc),
               leaf_tag=np.zeros((n_shards, leaf), np.float32))
    if t >= 1 << 24:
        raise ValueError("attr_rows carries gids as float32: scenes of 2^24 triangles or "
                         "more need an int32 column")
    out["attr_rows"] = _attr_rows_np(out)
    return out


def _attr_rows_np(out):
    """[..., 27] float32 winner rows of per-triangle arrays [..., k]
    (layout ``_ROW_VEC``, then mat, light, gid as floats: exact below
    2^24)."""
    return np.concatenate(
        [out[k] for k, _ in _ROW_VEC]
        + [out[k][..., None].astype(np.float32) for k in ("mat", "light", "gid")],
        axis=-1).astype(np.float32)


def local_shard(tables, index: int, device):
    """Shard ``index`` of :func:`shard_triangle_arrays`' host tables as the
    dict of tensors one rank keeps on ``device``, with its kind ("brute",
    "skip" or "packed") and the kernel tables of that kind: K6's packed
    skip-link rows (``sk_nodes_f``, ``sk_nodes_i``, ``sk_tris``) or K2's
    cluster tables and their deepest tree (``depth``)."""
    from pbrt_tpu_torch.ops.pallas_bvh import pack_skip_tables
    from pbrt_tpu_torch.ops.stream_bvh import tree_depth

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    per_tri = _REC_VEC + ("mat", "light", "valid", "gid")
    sh = {k: dev(tables[k][index]) for k in per_tri}
    sh["attr_rows"] = dev(tables["attr_rows"][index] if "attr_rows" in tables
                          else _attr_rows_np({k: tables[k][index] for k in per_tri}))
    if "pk_nodes" in tables:
        sh["kind"] = "packed"
        for k in ("pk_nodes", "pk_tris", "pk_roots", "pk_clmin", "pk_clmax"):
            sh[k] = dev(tables[k][index])
        sh["pk_s2p"] = dev(tables["pk_s2p"][index].astype(np.int64))
        sh["depth"] = max(tree_depth(nf, int(r)) for nf, r in
                          zip(tables["pk_nodes"][index], tables["pk_roots"][index]))
        return sh
    if "bvh_skip" not in tables:
        sh["kind"] = "brute"
        return sh
    sh["kind"] = "skip"
    nn = int(tables["nn"][index])
    sh["empty"] = nn == 0
    if nn:
        tree = [tables[k][index][:nn] for k in ("bvh_min", "bvh_max", "bvh_skip",
                                                "bvh_first", "bvh_count")]
        leaves = tree[4] > 0
        lf, lc = tree[3][leaves].astype(np.int64), tree[4][leaves]
        if (np.diff(lf) < lc[:-1]).any():
            raise ValueError("skip-link shard: leaf firsts must grow in DFS order")
        nodes_f, nodes_i, tris = pack_skip_tables(
            *tree, tables["p0"][index], tables["p1"][index], tables["p2"][index])
        sh["sk_nodes_f"], sh["sk_nodes_i"], sh["sk_tris"] = dev(nodes_f), dev(nodes_i), dev(tris)
    return sh


# ---------------------------------------------------------------------------
# This rank's sweep
# ---------------------------------------------------------------------------


def local_closest_hit(shard, o, d, t_max, chunk: int = BRUTE_CHUNK):
    """Closest hit of rays [N] against this rank's slice -> (t [N] (t_max
    where missed), local index [N] (-1 = miss), b0, b1); b0 and b1 are
    None on packed tables (barycentrics come from the winner's rows,
    :func:`interaction_from_reduced`)."""
    n = o.shape[0]
    tmax = torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype, device=o.device), (n,))
    with torch.no_grad():
        if shard["kind"] == "packed":
            return _stream_hit(shard, o, d, tmax)
        if shard["kind"] == "skip":
            return _skip_hit(shard, o, d, tmax)
        return _brute_hit(shard, o, d, tmax, chunk)


def _stream_hit(shard, o, d, tmax):
    """K2 (``stream_walk8``) over this shard's cluster tables."""
    from pbrt_tpu_torch.ops.stream_bvh import stream_traverse

    t, slot = stream_traverse(shard["pk_nodes"], shard["pk_tris"], shard["pk_roots"],
                              shard["pk_clmin"], shard["pk_clmax"], o, d, tmax,
                              depth=shard["depth"])
    idx = torch.where(slot >= 0, shard["pk_s2p"][slot.clamp(min=0).long()], -1)
    return torch.where(idx >= 0, t, tmax), idx.to(torch.int32), None, None


def _skip_hit(shard, o, d, tmax):
    """K6 (``skip_walk``) over this shard's skip-link tree."""
    from pbrt_tpu_torch.kernels.bvh2_walk import skip_walk
    from pbrt_tpu_torch.ops.stream_bvh import split_pad_rays

    n = o.shape[0]
    if shard["empty"]:
        zero = torch.zeros(n, dtype=o.dtype, device=o.device)
        return tmax.clone(), torch.full((n,), -1, dtype=torch.int32, device=o.device), zero, zero
    comps = split_pad_rays(o, d, tmax, n)
    t, prim, b0, b1 = (x[:n] for x in skip_walk(shard["sk_nodes_f"], shard["sk_nodes_i"],
                                                 shard["sk_tris"], comps))
    hit = prim >= 0
    return (torch.where(hit, t, tmax), prim.to(torch.int32), torch.where(hit, b0, 0.0),
            torch.where(hit, b1, 0.0))


def _brute_hit(shard, o, d, tmax, chunk):
    """Every triangle of the slice, ``chunk`` at a time (the reference's
    scan): the nearest valid hit below t_max, the first of equal t."""
    p0s, p1s, p2s, valid = shard["p0"], shard["p1"], shard["p2"], shard["valid"]
    n = o.shape[0]
    bt = tmax.clone()
    bi = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    b0c = torch.zeros(n, dtype=o.dtype, device=o.device)
    b1c = torch.zeros(n, dtype=o.dtype, device=o.device)
    rows = torch.arange(n, device=o.device)
    for c0 in range(0, p0s.shape[0], chunk):
        p0, p1, p2 = p0s[c0:c0 + chunk], p1s[c0:c0 + chunk], p2s[c0:c0 + chunk]
        # edges in the table's float, then the rays' (the reference's promotion)
        e1, e2 = (p1 - p0).to(o.dtype), (p2 - p0).to(o.dtype)
        pvec = torch.cross(d[:, None, :].expand(-1, len(p0), -1),
                           e2[None].expand(n, -1, -1), dim=-1)
        det = torch.sum(e1[None] * pvec, dim=-1)
        det_ok = torch.abs(det) > 1e-12
        inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
        tvec = o[:, None, :] - p0[None]
        b0 = torch.sum(tvec * pvec, dim=-1) * inv_det
        qvec = torch.cross(tvec, e1[None].expand(n, -1, -1), dim=-1)
        b1 = torch.sum(d[:, None, :] * qvec, dim=-1) * inv_det
        tt = torch.sum(e2[None] * qvec, dim=-1) * inv_det
        ok = (det_ok & (b0 >= 0) & (b1 >= 0) & (b0 + b1 <= 1) & (tt > RAY_EPS)
              & (tt < bt[:, None]) & valid[c0:c0 + chunk][None])
        tt = torch.where(ok, tt, torch.inf)
        best = torch.argmin(tt, dim=-1)
        t_best = tt[rows, best]
        better = t_best < bt
        bt = torch.where(better, t_best, bt)
        bi = torch.where(better, (c0 + best).to(torch.int32), bi)
        b0c = torch.where(better, b0[rows, best], b0c)
        b1c = torch.where(better, b1[rows, best], b1c)
    return bt, bi, b0c, b1c


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _transport(group, x):
    backend = dist.get_backend(group)
    return f"{backend} ({x.device.type} tensors)"


def _all_reduce(x, op, group, kind):
    TRANSPORT[kind] = _transport(group, x)
    dist.all_reduce(x, op=op, group=group)
    return x


def allreduce_closest(shard, t_local, idx_local, b0, b1, group):
    """Per-slice closest hits -> the mesh's closest hit and its attributes.

    Winner: the least (t, global id) over the tp group: an all-reduce
    (MIN) of t, then one (MIN) of the gids of the slices that tie it; the
    winner's attribute row (and barycentrics where the walk gave them) is
    broadcast by one masked-sum all-reduce.  Returns the hit record
    {t, hit, prim, b0, b1, p0..n2, uv0..uv2, mat, light}."""
    safe = idx_local.clamp(min=0).long()
    rows = shard["attr_rows"][safe]
    gid = torch.where(idx_local >= 0, shard["gid"][safe], NO_GID)
    t_global = _all_reduce(t_local.clone(), dist.ReduceOp.MIN, group, "all_reduce_min")
    is_tie = t_local <= t_global
    gid_min = _all_reduce(torch.where(is_tie, gid, NO_GID).to(torch.int32), dist.ReduceOp.MIN,
                          group, "all_reduce_min")
    winner = is_tie & (gid == gid_min) & (idx_local >= 0)
    hit = gid_min < NO_GID
    cols = [rows] + ([] if b0 is None else [b0[:, None], b1[:, None]])
    w = _all_reduce(torch.where(winner[:, None], torch.cat(cols, dim=1), 0.0),
                    dist.ReduceOp.SUM, group, "all_reduce_sum")
    return _record_from_row(w, t_global, hit, None if b0 is None else (w[:, 27], w[:, 28]))


def _record_from_row(w, t, hit, bary):
    """A hit record from winner rows [N, 27 (+2)] (misses: zero rows)."""
    rec = {"t": t, "hit": hit}
    at = 0
    for k, width in _ROW_VEC:
        rec[k] = w[:, at:at + width]
        at += width
    miss = torch.where(hit, 0, -1)
    rec["mat"] = (torch.round(w[:, 24]) + miss).to(torch.int32)
    rec["light"] = (torch.round(w[:, 25]) + miss).to(torch.int32)
    rec["prim"] = torch.round(w[:, 26]).to(torch.int32)
    rec["b0"], rec["b1"] = bary if bary is not None else (None, None)
    return rec


def sharded_occluded(shard, o, d, t_max, group):
    """Whether any slice of the tp group hits each ray below t_max."""
    _, idx, _, _ = local_closest_hit(shard, o, d, t_max)
    found = _all_reduce((idx >= 0).to(torch.int32), dist.ReduceOp.SUM, group,
                        "all_reduce_sum")
    return found > 0


def interaction_from_reduced(hit, o, d):
    """Hit record -> the SoA interaction (position, face-forwarded
    geometric and shading normals, uv, material, light, media -1, wo).
    Where the record has no barycentrics (packed tables) they come from
    projecting the hit point on the dual basis of the winner's edges, the
    single-card scheme (``compute_interaction``)."""
    t = hit["t"]
    p = o + d * t[..., None]
    b0, b1 = hit["b0"], hit["b1"]
    if b0 is None:
        e1 = hit["p1"] - hit["p0"]
        e2 = hit["p2"] - hit["p0"]
        vp = p - hit["p0"]
        d11 = torch.sum(e1 * e1, -1)
        d12 = torch.sum(e1 * e2, -1)
        d22 = torch.sum(e2 * e2, -1)
        den = d11 * d22 - d12 * d12
        inv_den = torch.where(torch.abs(den) > 1e-20,
                              1.0 / torch.where(den == 0.0, 1.0, den), 0.0)
        v1 = torch.sum(vp * e1, -1)
        v2 = torch.sum(vp * e2, -1)
        b0 = (d22 * v1 - d12 * v2) * inv_den
        b1 = (d11 * v2 - d12 * v1) * inv_den
    b2 = 1.0 - b0 - b1
    ng = torch.cross(hit["p1"] - hit["p0"], hit["p2"] - hit["p0"], dim=-1)
    ng = ng / torch.clamp(torch.linalg.norm(ng, dim=-1, keepdim=True), min=1e-12)
    ns = b2[..., None] * hit["n0"] + b0[..., None] * hit["n1"] + b1[..., None] * hit["n2"]
    nsn = torch.linalg.norm(ns, dim=-1, keepdim=True)
    ns = torch.where(nsn > 1e-9, ns / torch.clamp(nsn, min=1e-12), ng)
    ng = torch.where(torch.sum(ng * ns, dim=-1, keepdim=True) < 0, -ng, ng)
    uv = b2[..., None] * hit["uv0"] + b0[..., None] * hit["uv1"] + b1[..., None] * hit["uv2"]
    miss = ~hit["hit"]
    return {
        "p": p,
        "ng": torch.where(miss[..., None], 0.0, ng),
        "ns": torch.where(miss[..., None], 0.0, ns),
        "uv": uv,
        "mat": torch.where(miss, -1, hit["mat"]),
        "light": torch.where(miss, -1, hit["light"]),
        "med_in": torch.full(t.shape, -1, dtype=torch.int32, device=t.device),
        "med_out": torch.full(t.shape, -1, dtype=torch.int32, device=t.device),
        "wo": -d,
    }


# ---------------------------------------------------------------------------
# Ring formulation: rays sharded over tp as well
# ---------------------------------------------------------------------------


def ring_exchange(x, group):
    """Send ``x`` to the next rank of the tp ring and return what the
    previous one sent (one ``batch_isend_irecv``).  Under gloo a CUDA
    packet goes through host tensors, the one place the port stages a
    collective through the host."""
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % size)
    prv = dist.get_global_rank(group, (me - 1) % size)
    staged = dist.get_backend(group) == "gloo" and x.device.type == "cuda"
    TRANSPORT["ring"] = "gloo via host" if staged else _transport(group, x)
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                       dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()
    return recv.to(x.device) if staged else recv


def ring_closest_hit(shard, o, d, t_max, tp_size: int, group):
    """Closest hit with rays and triangles both sharded over tp.

    Each of ``tp_size`` steps sweeps the packet resident here against this
    rank's slice, folds the result into the packet's best-hit record
    (least (t, gid), the tie-break of :func:`allreduce_closest`) and passes
    the packet one hop round the ring; after tp steps every packet is home
    with every slice visited.  Returns the hit record of
    :func:`allreduce_closest`."""
    n = o.shape[0]
    dev = o.device
    tmax = torch.broadcast_to(torch.as_tensor(t_max, dtype=o.dtype, device=dev), (n,))
    # the packet: float columns (o d tmax t b0 b1 | the winner's 24
    # attribute floats) and int columns (gid mat light) as float bits
    fl = torch.cat([o, d, tmax[:, None], tmax[:, None], torch.zeros((n, 26), device=dev)], 1)
    it = torch.stack([torch.full((n,), NO_GID, dtype=torch.int32, device=dev),
                      torch.full((n,), -1, dtype=torch.int32, device=dev),
                      torch.full((n,), -1, dtype=torch.int32, device=dev)], 1)
    derive_bary = shard["kind"] == "packed"
    for _ in range(tp_size):
        t_l, idx_l, b0, b1 = local_closest_hit(shard, fl[:, 0:3], fl[:, 3:6], fl[:, 6])
        safe = idx_l.clamp(min=0).long()
        gid_l = torch.where(idx_l >= 0, shard["gid"][safe], NO_GID)
        t_p, gid_p = fl[:, 7], it[:, 0]
        better = (idx_l >= 0) & ((t_l < t_p) | ((t_l == t_p) & (gid_l < gid_p)))
        rows = shard["attr_rows"][safe]
        zero = torch.zeros_like(t_l)
        new_fl = torch.cat([t_l[:, None], (zero if b0 is None else b0)[:, None],
                            (zero if b1 is None else b1)[:, None], rows[:, :24]], 1)
        fl = torch.cat([fl[:, :7], torch.where(better[:, None], new_fl, fl[:, 7:])], 1)
        it = torch.where(better[:, None],
                         torch.stack([gid_l.to(torch.int32), shard["mat"][safe],
                                      shard["light"][safe]], 1), it)
        if tp_size > 1:
            packet = ring_exchange(torch.cat([fl, it.view(torch.float32)], 1), group)
            fl, it = packet[:, :34], packet[:, 34:].contiguous().view(torch.int32)
    found = it[:, 0] < NO_GID
    w = torch.cat([fl[:, 10:34], it[:, 1:3].to(torch.float32),
                   torch.where(found, it[:, 0], 0).to(torch.float32)[:, None]], 1)
    rec = _record_from_row(w, fl[:, 7], found,
                           None if derive_bary else (fl[:, 8], fl[:, 9]))
    # mat and light rode as ints: no miss offset to add
    rec["mat"], rec["light"] = it[:, 1], it[:, 2]
    rec["prim"] = torch.where(found, it[:, 0], 0)
    return rec


# ---------------------------------------------------------------------------
# Geometry-sharded wavefront path tracing (the config-5 harness)
# ---------------------------------------------------------------------------


def _lane_slice(n, mesh, dp_axis, tp_axis, ring):
    """This rank's block of ``n`` lanes: dp-sharded (allreduce), or
    sharded over (dp, tp) with tp minor (ring)."""
    _, dp, dpi = axis(mesh, dp_axis)
    _, tp, tpi = axis(mesh, tp_axis)
    shards, index = (dp * tp, dpi * tp + tpi) if ring else (dp, dpi)
    if n % shards:
        raise ValueError(f"{n} lanes do not split over {shards} ray shards")
    per = n // shards
    return slice(index * per, (index + 1) * per)


def _matte_bounce(si, kd_table, sampler, pixel_xy, sidx, bounce):
    """The harness's matte continuation: (kd of the hit [N, 3], next ray
    origin, direction)."""
    from pbrt_tpu_torch.core.geometry import coordinate_system, vface_forward
    from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere

    ns = vface_forward(si["ns"], si["wo"])
    ss, ts = coordinate_system(ns)
    kd = kd_table[torch.clamp(si["mat"], 0, kd_table.shape[0] - 1).long()]
    wl = cosine_sample_hemisphere(sampler.get2(pixel_xy, sidx, 5 + 3 * bounce))
    wi = wl[..., 0:1] * ss + wl[..., 1:2] * ts + wl[..., 2:3] * ns
    return kd, si["p"] + ns * 1e-3, wi


def make_sharded_path_fn(mesh, camera, sampler, film, kd_table, env_l, max_depth=3,
                         dp_axis="dp", tp_axis="tp", formulation="allreduce"):
    """-> fn(state, shard, pixels, sidx) -> the whole film state on every rank.

    Every rank passes the same film state and the whole lane batch
    (pixels [N, 2], sample indices [N]) with its own shard
    (:func:`local_shard`); it traces its block of lanes (dp-sharded for
    "allreduce", (dp, tp)-sharded for "ring").  Matte shading from
    ``kd_table`` [M, 3] and a constant environment ``env_l`` [3], no NEE:
    the scaling harness of BASELINE config 5, as the reference's.  The
    partial films sum over the mesh; under "allreduce" the tp replicas
    traced the same rays, so the sum is divided by tp.  The film
    positions, rays and carried radiance take the camera's float (float64
    under the double policy), as the reference's take ``float_t``."""
    if formulation not in ("allreduce", "ring"):
        raise ValueError(f"unknown formulation {formulation!r}")
    ring = formulation == "ring"
    tp_group, tp_size, _ = axis(mesh, tp_axis)

    def fn(state, shard, pixels, sidx):
        dev = state["xyz"].device
        dt = torch_dtype(camera.float_t)
        kd_t = torch.as_tensor(np.asarray(kd_table), dtype=dt, device=dev)
        env = torch.as_tensor(np.asarray(env_l), dtype=dt, device=dev)
        sl = _lane_slice(pixels.shape[0], mesh, dp_axis, tp_axis, ring)
        pixel_xy, sidx = pixels[sl], sidx[sl]
        n = pixel_xy.shape[0]
        with torch.no_grad():
            p_film = pixel_xy.to(dt) + sampler.get2(pixel_xy, sidx, 0)
            o, d, w = camera.generate_rays(p_film, sampler.get2(pixel_xy, sidx, 2))
            L = torch.zeros((n, 3), dtype=dt, device=dev)
            beta = torch.ones((n, 3), dtype=dt, device=dev)
            alive = torch.ones(n, dtype=torch.bool, device=dev)
            for bounce in range(max_depth):
                t_inf = torch.full((n,), INF_T, dtype=dt, device=dev)
                if ring:
                    hit = ring_closest_hit(shard, o, d, t_inf, tp_size, tp_group)
                else:
                    hit = allreduce_closest(shard, *local_closest_hit(shard, o, d, t_inf),
                                            tp_group)
                esc = alive & ~hit["hit"]
                L = L + torch.where(esc[..., None], beta * env, 0.0)
                alive = alive & hit["hit"]
                si = interaction_from_reduced(hit, o, d)
                if bounce == max_depth - 1:
                    break
                kd, o, d = _matte_bounce(si, kd_t, sampler, pixel_xy, sidx, bounce)
                beta = torch.where(alive[..., None], beta * kd, beta)
            L = torch.where(torch.isfinite(L), L, 0.0) * w[..., None]
            zero = {k: torch.zeros_like(v) for k, v in state.items()}
            partial = film.add_samples(zero, p_film, L)
            summed = all_reduce_mesh(partial, mesh)
            if not ring:
                summed = {k: v / tp_size for k, v in summed.items()}
            return {k: state[k] + v for k, v in summed.items()}

    return fn


def make_sharded_grad_fn(mesh, camera, sampler, film, target, max_depth=3, dp_axis="dp",
                         tp_axis="tp", remat=True):
    """-> fn(theta, shard, pixels, sidx) -> (loss, grads): the path-replay
    loss and its gradient with geometry sharded over tp (BASELINE config
    5's step).

    theta = {"kd": [M, 3], "env_l": [3]}; the forward pass is
    :func:`make_sharded_path_fn`'s allreduce harness, each bounce under
    ``torch.utils.checkpoint`` when ``remat`` (the backward replays the
    bounce, sweeps and collectives included, instead of keeping its
    wavefront).  The loss is the sum over every lane of the mesh of the
    squared error against ``target`` [H, W, 3] at the lane's pixel; tp
    replicas trace the same lanes, so each rank's lanes count 1 / tp.
    Each rank backpropagates its own lanes, and the gradients are
    all-reduced once over the mesh: the gradient of the loss.  (The
    reference differentiates through ``shard_map``, whose psum transposes
    to a psum: its gradient is that times the number of devices.)  The
    radiance, its carry and the target take the camera's float."""
    tp_group, tp_size, _ = axis(mesh, tp_axis)

    dt = torch_dtype(camera.float_t)

    def radiance(theta, shard, pixel_xy, sidx):
        n = pixel_xy.shape[0]
        dev = pixel_xy.device
        p_film = pixel_xy.to(dt) + sampler.get2(pixel_xy, sidx, 0)
        o, d, w = camera.generate_rays(p_film, sampler.get2(pixel_xy, sidx, 2))

        def bounce_body(bounce, L, beta, alive, o, d):
            t_far = torch.where(alive, INF_T, 0.0).to(dt)
            hit = allreduce_closest(shard, *local_closest_hit(shard, o, d, t_far), tp_group)
            esc = alive & ~hit["hit"]
            L = L + torch.where(esc[..., None], beta * theta["env_l"], 0.0)
            alive = alive & hit["hit"]
            if bounce == max_depth - 1:
                return L, beta, alive, o, d
            si = interaction_from_reduced(hit, o, d)
            kd, o, d = _matte_bounce(si, theta["kd"], sampler, pixel_xy, sidx, bounce)
            beta = torch.where(alive[..., None], beta * kd, beta)
            return L, beta, alive, o, d

        carry = (torch.zeros((n, 3), dtype=dt, device=dev),
                 torch.ones((n, 3), dtype=dt, device=dev),
                 torch.ones(n, dtype=torch.bool, device=dev), o, d)
        for bounce in range(max_depth):
            if remat:
                carry = checkpoint(bounce_body, bounce, *carry, use_reentrant=False)
            else:
                carry = bounce_body(bounce, *carry)
        L = carry[0]
        return torch.where(torch.isfinite(L), L, 0.0) * w[..., None], p_film

    def fn(theta, shard, pixels, sidx):
        dev = pixels.device
        tgt = torch.as_tensor(np.asarray(target), dtype=dt, device=dev)
        sl = _lane_slice(pixels.shape[0], mesh, dp_axis, tp_axis, ring=False)
        pixel_xy, sidx = pixels[sl], sidx[sl]
        leaves = {k: torch.as_tensor(v, device=dev).detach().clone().requires_grad_(True)
                  for k, v in theta.items()}
        L, p_film = radiance(leaves, shard, pixel_xy, sidx)
        hi = torch.tensor([tgt.shape[1] - 1, tgt.shape[0] - 1], device=dev)
        pix = torch.minimum(torch.clamp(p_film.to(torch.int64), min=0), hi)
        want = tgt[pix[..., 1], pix[..., 0]]
        local = torch.sum(torch.sum((L - want) ** 2, dim=-1) / tp_size)
        names = list(leaves)
        grads = torch.autograd.grad(local, [leaves[k] for k in names], allow_unused=True,
                                    materialize_grads=True)
        summed = all_reduce_mesh({**dict(zip(names, grads)), "_loss": local.detach()}, mesh)
        return summed.pop("_loss"), summed

    return fn
