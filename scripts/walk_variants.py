#!/usr/bin/env python3
"""Time design variants of the streaming walk kernels on one CUDA card.

Run from the repository root on a machine with a card:

    python3 scripts/walk_variants.py

Each variant is a text edit of a kernel source in
``pbrt_tpu_torch/kernels/csrc/``, built into a library of its own (the
library name hashes the source); an edit whose anchor text is missing
raises, so the script fails loudly once the sources move on.  The
variants run config 3's seven chunk-0 sweeps (camera, bounce and shadow
rays, recorded from one frame as in ``chip_smoke.py``) in turns, three
rounds, and print the median ms per sweep and their mean.  Every
variant's t and hit mask must equal the design's (the segments of K2 and
the loads change how a result is found, not which).

* K2 ``stream_walk8`` (``bvh8_walk.cu``): the design (S = 4 x resident
  warps / live groups, 6 CTAs per SM); S = 1, 2 and 8 x; no segments
  (S = 1 on every sweep, the sequential work); 4 CTAs per SM; the leaf
  loop unrolled 2 and 4 times (the loads of several triangle slots in
  flight at once; the float operations are the same).
* K4 / K4b ``stream_walk2`` (``bvh2_walk.cu``): the design (scalar node
  loads); node rows as four 16-byte loads.
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


def k4_variants(src):
    anchor = "  static constexpr int CAP = CAP_;\n"
    vector_nodes = anchor + """  __device__ __forceinline__ void node(int ref, NodeRow& n) const {
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
    return {"design (scalar node loads)": src,
            "16-byte node loads": edit(src, anchor, vector_nodes)}


def build_variants(name, variants, mod, kernel):
    """-> {label: loaded library} (one nvcc per variant, one at a time,
    into a directory of their own); prints ``kernel``'s ptxas lines."""
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
        at = next((j for j, line in enumerate(lines) if kernel in line), None)
        ptxas = " | ".join(x.strip() for x in lines[at + 2:at + 4]) if at is not None else ""
        print(f"  {name} {label}: {kernel}: {ptxas}", flush=True)
    build.CSRC = CSRC
    return libs


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk

    if not torch.cuda.is_available():
        raise SystemExit("walk_variants: needs a CUDA card")
    print(cs.card_info(), flush=True)
    libs8 = build_variants("bvh8_walk", k2_variants((CSRC / "bvh8_walk.cu").read_text()),
                           bvh8_walk, "stream_walk8_kernelILi32E")
    libs2 = build_variants("bvh2_walk", k4_variants((CSRC / "bvh2_walk.cu").read_text()),
                           bvh2_walk, "stream_walk2_kernelILb0ELi16E")
    cs.VARIANTS = {k: cs.VARIANTS[k] for k in ("default", "binary", "binary_fused")}
    rs = cs.renderers()
    closest, shadow = rs["default"].integrator.queries_per_sample()
    for kname, variant, libs, mod in (("stream_walk8", "default", libs8, bvh8_walk),
                                      ("stream_walk2", "binary", libs2, bvh2_walk),
                                      ("stream_walk2_fused", "binary_fused", libs2, bvh2_walk)):
        walk = rs[variant].compiled.intersector.walk
        sweeps = []
        for o, d, t_max, any_hit in cs.record_walks(rs[variant])[:closest + shadow]:
            fn, _, args, kw, *_ = cs.walk_call(kname, walk, o, d, t_max)
            sweeps.append((fn, args, dict(kw, any_hit=any_hit)))
        times = {label: [[] for _ in sweeps] for label in libs}
        want = None
        for _ in range(3):
            for label, lib in libs.items():
                mod._lib = lib
                for i, (fn, args, kw) in enumerate(sweeps):
                    t, slot = fn(*args, **kw)
                    got = (t.clone(), slot >= 0)
                    if want is None or len(want) <= i:
                        want = (want or []) + [got]
                    elif not (torch.equal(got[0], want[i][0])
                              and torch.equal(got[1], want[i][1])):
                        raise AssertionError(f"{kname} {label}: sweep {i} differs")
                    times[label][i].append(cs.cuda_ms(lambda: fn(*args, **kw), 20))
        print(f"{kname} (ms per sweep, median of 3 rounds; camera, then bounce and shadow)")
        for label, per in times.items():
            med = [float(np.median(x)) for x in per]
            print(f"  {label}: mean {np.mean(med):.4f}, sweeps {[round(t, 4) for t in med]}",
                  flush=True)
        mod._lib = None


if __name__ == "__main__":
    main()
