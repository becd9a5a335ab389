#!/usr/bin/env python3
"""Time design variants of the walk kernels on one CUDA card.

Run from the repository root on a machine with a card:

    python3 scripts/walk_variants.py                 # every walk
    python3 scripts/walk_variants.py ordered_walk2   # only the walks named

Each variant is a text edit of a kernel source in
``pbrt_tpu_torch/kernels/csrc/``, built into a library of its own (the
library name hashes the source); an edit whose anchor text is missing
raises, so the script fails loudly once the sources move on.  Each walk
runs its own sweeps, recorded from one frame as in ``chip_smoke.py``:
config 3's seven chunk-0 sweeps (camera, bounce and shadow rays) for the
streaming walks and K6, the small torus's seven sweeps and the
3000-triangle soup's 262,144 closest-hit rays for the whole-tree K4.  The
variants run in turns, three rounds, and the script prints the median ms
per sweep and their mean by CUDA events (on small sweeps these include
the host's launch overhead) and by device time (torch.profiler, one
profile of 10 launches per variant and sweep), and, for the split walks,
the segments per ray each variant chose per sweep.  Every variant's t, hit mask and, closest
hit, slots must equal the design's (segments and loads change how a
result is found, not which; K6 any hit: t only where nothing was hit,
since a split ray may return another of its hits).

* K2 ``stream_walk8`` (``bvh8_walk.cu``): the design (S = 4 x resident
  warps / live groups, 6 CTAs per SM); S = 1, 2 and 8 x; no segments
  (S = 1 on every sweep, the sequential work); 4 CTAs per SM; the leaf
  loop unrolled 2 and 4 times (the loads of several triangle slots in
  flight at once; the float operations are the same).
* K4 / K4b ``stream_walk2`` (``bvh2_walk.cu``): the design (scalar node
  loads); node rows as four 16-byte loads.
* K6 ``skip_walk`` and the whole-tree K4 ``ordered_walk2``
  (``bvh2_walk.cu``): the design (``task_shape``: about 2 tasks per
  resident warp, up to 32 rays per task, fewer on a sparse sweep; with
  fewer live rays than resident warps, S = warps / live segments per ray;
  8 CTAs per SM); tasks of 32 rays with S = 2 x resident warps / live
  groups (segments without spreading); no segments (S = 1); segments
  below 2 x warps live rays (S = 2 x warps / live); half, 2x and 8x the
  tasks per warp; 6 CTAs per SM.
  K6 besides: scalar node loads; scalar triangle loads; the rows of both
  possible successors fetched during a step (80 registers, 6 CTAs per
  SM).  K4 besides: node rows as four 16-byte loads; scalar triangle
  loads; the stack in local memory.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "pbrt_tpu_torch" / "kernels" / "csrc"
VARIANT_DIR = ROOT / "build" / "walk_variants"


def edit(text, old, new):
    if old not in text:
        raise SystemExit(f"walk_variants: anchor not found in the source: {old[:60]!r}")
    return text.replace(old, new)


def k2_variants(src):
    seg, lb = "#define SEG_PER_WARP 4", "__launch_bounds__(THREADS, 6)\nstream_walk8_kernel"
    leaf = "      for (int k = 0; k < count; ++k) {\n        // a slot is 16 floats"
    return {
        "design (S = 4 x warps / groups, 6 CTAs per SM)": src,
        "S = 1 x warps / groups": edit(src, seg, "#define SEG_PER_WARP 1"),
        "S = 2 x warps / groups": edit(src, seg, "#define SEG_PER_WARP 2"),
        "S = 8 x warps / groups": edit(src, seg, "#define SEG_PER_WARP 8"),
        "no segments (S = 1)": edit(src, seg, "#define SEG_PER_WARP 0"),
        "4 CTAs per SM": edit(src, lb, lb.replace("6)", "4)")),
        "leaf loop unrolled 2x": edit(src, leaf, "#pragma unroll 2\n" + leaf),
        "leaf loop unrolled 4x": edit(src, leaf, "#pragma unroll 4\n" + leaf),
    }


def bvh2_variants(src):
    seg = "#define SEG_PER_WARP 2"
    shape = ("  const int rays = min(32, max(1, live / max(SEG_PER_WARP * warps, 1)));\n"
             "  return make_int2(rays, live >= warps ? 1 : warps / max(live, 1));\n")
    rays32 = ("  return make_int2(32, max(1, SEG_PER_WARP * warps / max((live + 31) / 32, 1)));"
              "\n")
    no_split = ("  const int rays = min(32, max(1, live / max(SEG_PER_WARP * warps, 1)));\n"
                "  return make_int2(rays, 1);\n")
    split_2x = ("  const int rays = min(32, max(1, live / max(SEG_PER_WARP * warps, 1)));\n"
                "  return make_int2(rays, rays > 1 ? 1 : max(1, 2 * warps / max(live, 1)));\n")
    scalar_nodes = """  __device__ __forceinline__ void node(int ref, NodeRow& n) const {
    const float* nf = nodes + (size_t)ref * NODE2_COLS;
#pragma unroll
    for (int c = 0; c < 12; ++c) n.box[c] = __ldg(nf + c);
    n.left = (int)__ldg(nf + 12);
    n.right = (int)__ldg(nf + 13);
    n.mask = (int)__ldg(nf + 14);
  }
"""
    vector_nodes = """  __device__ __forceinline__ void node(int ref, NodeRow& n) const {
    const float4* nf = reinterpret_cast<const float4*>(nodes + (size_t)ref * NODE2_COLS);
    const float4 a = __ldg(nf), b = __ldg(nf + 1), c = __ldg(nf + 2), d = __ldg(nf + 3);
    n.box[0] = a.x; n.box[1] = a.y; n.box[2] = a.z; n.box[3] = a.w;
    n.box[4] = b.x; n.box[5] = b.y; n.box[6] = b.z; n.box[7] = b.w;
    n.box[8] = c.x; n.box[9] = c.y; n.box[10] = c.z; n.box[11] = c.w;
    n.left = (int)d.x;
    n.right = (int)d.y;
    n.mask = (int)d.z;
  }
"""
    skip_vec = """  const float4* f = reinterpret_cast<const float4*>(nodes_f + 8 * (size_t)v);
  const float4 a = __ldg(f), b = __ldg(f + 1);
  const int4 c = __ldg(reinterpret_cast<const int4*>(nodes_i + 4 * (size_t)v));
  s.box[0] = a.x; s.box[1] = a.y; s.box[2] = a.z; s.box[3] = a.w;
  s.box[4] = b.x; s.box[5] = b.y;
  s.skip = c.x;
  s.first = c.y;
  s.count = c.z;
"""
    skip_scalar = """#pragma unroll
  for (int c = 0; c < 6; ++c) s.box[c] = __ldg(nodes_f + 8 * (size_t)v + c);
  s.skip = __ldg(nodes_i + 4 * (size_t)v);
  s.first = __ldg(nodes_i + 4 * (size_t)v + 1);
  s.count = __ldg(nodes_i + 4 * (size_t)v + 2);
"""
    skip_tri = "        tri16(tris + 16 * (size_t)pid, p);\n"
    scalar_tri = ("#pragma unroll\n        for (int c = 0; c < 9; ++c) "
                  "p[c] = __ldg(tris + 16 * (size_t)pid + c);\n")
    table_tri = "void tri(const float* t, float (&p)[9]) const { tri16(t, p); }"
    table_scalar_tri = ("void tri(const float* t, float (&p)[9]) const {\n#pragma unroll\n"
                        "    for (int c = 0; c < 9; ++c) p[c] = __ldg(t + c);\n  }")
    # the rows of both possible successors (node + 1 and skip) fetched
    # while a step's tests run
    walk = """  int node = a;
  while (node < b) {
    SkipNode cur;
    skip_node(nodes_f, nodes_i, node, cur);
"""
    fetch = """  if (a >= b) return;
  SkipNode cur;
  skip_node(nodes_f, nodes_i, a, cur);
  int node = a;
  while (true) {
    const int down = node + 1;
    const int over = cur.skip;
    SkipNode nd, ns;
    if (down < b) skip_node(nodes_f, nodes_i, down, nd);
    if (over != down && over < b) skip_node(nodes_f, nodes_i, over, ns);
"""
    step = """    node = box_hit && cur.count == 0 ? node + 1 : cur.skip;
    if (any_hit && best_prim >= 0) return;
    if (flag != nullptr && *(volatile const unsigned long long*)flag != NO_HIT) return;
"""
    fetch_step = """    const int next = box_hit && cur.count == 0 ? down : over;
    if (next >= b || (any_hit && best_prim >= 0)) return;
    if (flag != nullptr && *(volatile const unsigned long long*)flag != NO_HIT) return;
    cur = next == down ? nd : ns;
    node = next;
"""
    skip_lb = "__launch_bounds__(THREADS, 8)\nskip_walk_kernel"
    ordered_lb = "__launch_bounds__(THREADS, 8)\nordered_walk2_kernel"
    local_stack = edit(edit(edit(edit(
        src, "int& slot(int i) const { return stack[i * THREADS]; }",
        "int& slot(int i) const { return stack[i]; }"),
        "    const Tables<CAP> tab{nodes, tris, stacks + threadIdx.x};",
        "    int local[CAP];\n    const Tables<CAP> tab{nodes, tris, local};"),
        "      const SplitTables<CAP> tab{{nodes, tris, stacks + threadIdx.x},",
        "      int local[CAP];\n      const SplitTables<CAP> tab{{nodes, tris, local},"),
        "  const int smem = CAP * THREADS * 4;  // the i32 stacks\n  const Scratch s(",
        "  const int smem = 0;\n  const Scratch s(")
    return {
        "design": src,
        "32 rays per task, S = 2 x warps / groups": edit(src, shape, rays32),
        "no segments (S = 1)": edit(src, shape, no_split),
        "segments below 2 x warps live rays": edit(src, shape, split_2x),
        "half the S multiplier": edit(src, seg, "#define SEG_PER_WARP 1"),
        "2x the S multiplier": edit(src, seg, "#define SEG_PER_WARP 4"),
        "8x the S multiplier": edit(src, seg, "#define SEG_PER_WARP 16"),
        "16-byte node loads (K4)": edit(src, scalar_nodes, vector_nodes),
        "scalar triangle loads (K4)": edit(src, table_tri, table_scalar_tri),
        "stack in local memory (whole-tree K4)": local_stack,
        "scalar node loads (K6)": edit(src, skip_vec, skip_scalar),
        "scalar triangle loads (K6)": edit(src, skip_tri, scalar_tri),
        "successor fetch, 6 CTAs per SM (K6)": edit(edit(edit(src, walk, fetch), step, fetch_step),
                                                    skip_lb, skip_lb.replace("8)", "6)")),
        "6 CTAs per SM (K6)": edit(src, skip_lb, skip_lb.replace("8)", "6)")),
        "6 CTAs per SM (whole-tree K4)": edit(src, ordered_lb, ordered_lb.replace("8)", "6)")),
    }


# kernel -> (renderer whose sweeps it runs, library, its variants (None: all))
SPLIT = ("design", "32 rays per task, S = 2 x warps / groups", "no segments (S = 1)",
         "segments below 2 x warps live rays", "half the S multiplier", "2x the S multiplier",
         "8x the S multiplier")
PLAN = {
    "stream_walk8": ("default", "bvh8_walk", None),
    "stream_walk2": ("binary", "bvh2_walk", ("design", "16-byte node loads (K4)")),
    "stream_walk2_fused": ("binary_fused", "bvh2_walk", ("design", "16-byte node loads (K4)")),
    "skip_walk": ("skip", "bvh2_walk", SPLIT + (
        "scalar node loads (K6)", "scalar triangle loads (K6)",
        "successor fetch, 6 CTAs per SM (K6)", "6 CTAs per SM (K6)")),
    "ordered_walk2": ("small_binary", "bvh2_walk", SPLIT + (
        "16-byte node loads (K4)", "scalar triangle loads (K4)",
        "stack in local memory (whole-tree K4)", "6 CTAs per SM (whole-tree K4)")),
}
# the kernels of each walk whose device time the profiler sums
DEVICE_KERNELS = {"stream_walk8": ("stream_prep8_kernel", "stream_walk8_kernel"),
                  "stream_walk2": ("stream_walk2_kernel",),
                  "stream_walk2_fused": ("stream_walk2_kernel",),
                  "skip_walk": ("whole_prep_kernel", "skip_walk_kernel"),
                  "ordered_walk2": ("whole_prep_kernel", "ordered_walk2_kernel")}


def build_variants(name, variants, mod, kernels):
    """-> {label: loaded library} (one nvcc per variant, one at a time,
    into a directory of their own); prints the ptxas lines of ``kernels``."""
    from pbrt_tpu_torch.kernels import build

    build.BUILD_DIR = VARIANT_DIR
    libs = {}
    for i, (label, text) in enumerate(variants.items()):
        d = VARIANT_DIR / f"{name}_{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(text)
        build.CSRC = d
        build._libs.pop(name, None)
        mod._lib = None
        mod.load_library()
        libs[label] = mod._lib
        lines = build.build_logs.get(name, "").splitlines()
        for kernel in kernels:
            at = next((j for j, line in enumerate(lines) if kernel in line), None)
            ptxas = " | ".join(x.strip() for x in lines[at + 2:at + 4]) if at is not None else ""
            print(f"  {name} {label}: {kernel}: {ptxas}", flush=True)
    build.CSRC = CSRC
    return libs


def sweeps_of(cs, kname, rs, closest, shadow):
    """[(fn, args, kwargs)] of ``kname`` on its sweeps (see the docstring)."""
    import torch

    variant = PLAN[kname][0]
    walk = rs[variant].compiled.intersector.walk
    calls = cs.record_walks(rs[variant])[:closest + shadow]
    if kname == "ordered_walk2":
        from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2

        soup = OrderedBVH2(*cs.soup_tables(8), device=cs.DEVICE)
        o, d, t_max = cs.random_rays(cs.SWEEP, 3, -2.0, 2.0)
        calls = [(c[0], c[1], c[2], c[3], walk) for c in calls] + [(o, d, t_max, False, soup)]
    else:
        calls = [c + (walk,) for c in calls]
    out = []
    for o, d, t_max, any_hit, w in calls:
        fn, _, args, kw, *_ = cs.walk_call(kname, w, o, d, t_max)
        out.append((fn, args, dict(kw, any_hit=any_hit)))
    torch.cuda.synchronize()
    return out


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk

    if not torch.cuda.is_available():
        raise SystemExit("walk_variants: needs a CUDA card")
    print(cs.card_info(), flush=True)
    plan = {k: v for k, v in PLAN.items() if k in (sys.argv[1:] or PLAN)}
    mods = {"bvh8_walk": bvh8_walk, "bvh2_walk": bvh2_walk}
    sources = {  # library -> (its variants, the kernels whose ptxas lines are printed)
        "bvh8_walk": (k2_variants, ("stream_walk8_kernelILi32E",)),
        "bvh2_walk": (bvh2_variants, ("stream_walk2_kernelILb0ELi16E", "skip_walk_kernel",
                                      "ordered_walk2_kernelILi16E")),
    }
    libs = {name: build_variants(name, variants((CSRC / f"{name}.cu").read_text()), mods[name],
                                 kernels)
            for name, (variants, kernels) in sources.items()
            if any(v[1] == name for v in plan.values())}
    cs.VARIANTS = {k: cs.VARIANTS[k] for k in {v[0] for v in plan.values()}}
    rs = cs.renderers()
    closest, shadow = next(iter(rs.values())).integrator.queries_per_sample()
    for kname, (_, lib_name, labels) in plan.items():
        mod = mods[lib_name]
        chosen = {k: v for k, v in libs[lib_name].items() if labels is None or k in labels}
        sweeps = sweeps_of(cs, kname, rs, closest, shadow)
        times = {label: [[] for _ in sweeps] for label in chosen}
        device = {label: [] for label in chosen}
        segments = {}
        want = []
        for rnd in range(3):
            for label, lib in chosen.items():
                mod._lib = lib
                for i, (fn, args, kw) in enumerate(sweeps):
                    out = fn(*args, **kw)
                    if rnd == 0 and kname in cs.SPLIT_WALKS:
                        segments.setdefault(label, []).append(
                            bvh2_walk.segment_stats()["segments"])
                    t, slot = out[0].clone(), out[1].clone()
                    if len(want) <= i:
                        want.append((t, slot))
                    else:
                        hit = want[i][1] >= 0
                        same_t = (torch.equal(t[~hit], want[i][0][~hit])
                                  if kname == "skip_walk" and kw["any_hit"]
                                  else torch.equal(t, want[i][0]))
                        same_slot = (torch.equal(slot >= 0, hit) if kw["any_hit"]
                                     else torch.equal(slot, want[i][1]))
                        if not (same_t and same_slot):
                            raise AssertionError(f"{kname} {label}: sweep {i} differs")
                    times[label][i].append(cs.cuda_ms(lambda: fn(*args, **kw), 20))
                    if rnd == 0:
                        device[label].append(sum(v[0] or 0.0 for v in cs.profiled_ms(
                            lambda: fn(*args, **kw), 10, DEVICE_KERNELS[kname]).values()))
        print(f"{kname} (ms per sweep by events, median of 3 rounds; device ms from one "
              f"profile of 10 launches; {len(sweeps)} sweeps)")
        for label, per in times.items():
            med = [float(np.median(x)) for x in per]
            extra = f", S {segments[label]}" if label in segments else ""
            print(f"  {label}: mean {np.mean(med):.4f}, sweeps {[round(t, 4) for t in med]}; "
                  f"device mean {np.mean(device[label]):.4f}, sweeps "
                  f"{[round(t, 4) for t in device[label]]}" + extra, flush=True)
        mod._lib = None


if __name__ == "__main__":
    main()
