#!/usr/bin/env python3
"""Time design variants of K7, the keyframed walk, on one CUDA card.

Run from the repository root on a machine with a card:

    python3 scripts/k7_variants.py

Each variant is a text edit of ``pbrt_tpu_torch/kernels/csrc/anim_walk.cu``
built into a library of its own (the library name hashes the source); an
edit whose anchor text is missing raises, so the script fails loudly once
the source moves on.  The sweeps are those of ``chip_smoke.py`` phase 16
(a)'s motion frame (config 3 turning 30 degrees, 256x256, 8 spp, maxdepth
4, 2 chunks: 14 sweeps of 262,144 rays) and of phase 19 (b)'s (the same
frame under ``--double``), recorded from one frame each.  The variants
run in turns, three rounds, and the script prints per instance the mean
over the sweeps of each sweep's median ms (CUDA events, 20 launches after
a warm-up) and the medians per sweep.  Every variant's results must equal
the design's bit for bit (any hit: the hit masks), since each computes
the sequential walk's result.

* the design: R rays a task from the live count (2 tasks per resident
  warp, up to 32), 4 lanes a ray (R <= 8) on a sweep of at most 2 live rays
  per resident lane, the while-while walk with speculative traversal;
* one lane a ray on every sweep; 4 lanes a ray on every sweep; 4 lanes a
  ray only where task_shape's R <= 8 (this PR's first rule); groups up to
  1 and up to 4 live rays per resident lane;
* no speculative traversal (a ray holding a leaf waits);
* 1 and 4 tasks per resident warp;
* 2 lanes a ray where the design takes 1; 2 lanes a ray on every sweep
  (a lane tests a leaf's triangles j and j + 2);
* at least 8 and at least 12 CTAs an SM (``__launch_bounds__``: fewer
  registers, more warps; the double instance takes 80 registers, 6 CTAs,
  the float one 56, 9 CTAs).
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "pbrt_tpu_torch" / "kernels" / "csrc"
VARIANT_DIR = ROOT / "build" / "k7_variants"


def edit(text, old, new):
    if old not in text:
        raise SystemExit(f"k7_variants: anchor not found: {old[:60]!r}")
    return text.replace(old, new)


def variants(src):
    group = "const int group = live <= GROUP_RAYS_PER_LANE * 32 * warps ? LEAF_TRIS : 1;"
    bounds = "__launch_bounds__(THREADS)\nanim_walk_kernel("
    per_lane = "#define GROUP_RAYS_PER_LANE 2"
    tasks = "#define TASKS_PER_WARP 2"
    rays = "const int rays = min(task_shape(live, warps), 32 / group);"
    return {
        "design": src,
        "one lane a ray": edit(src, group, "const int group = 1;"),
        "4 lanes a ray": edit(src, group, "const int group = LEAF_TRIS;"),
        "4 lanes where R <= 8": edit(src, group, "const int group = task_shape(live, warps) * "
                                     "LEAF_TRIS <= 32 ? LEAF_TRIS : 1;"),
        "groups to 1 live ray a lane": edit(src, per_lane, "#define GROUP_RAYS_PER_LANE 1"),
        "groups to 4 live rays a lane": edit(src, per_lane, "#define GROUP_RAYS_PER_LANE 4"),
        "no speculation": edit(src, "if (!walking || stopped) continue;",
                               "if (!walking || stopped || held_count > 0) continue;"),
        "1 task a warp": edit(src, tasks, "#define TASKS_PER_WARP 1"),
        "4 tasks a warp": edit(src, tasks, "#define TASKS_PER_WARP 4"),
        "2 lanes a ray for the design's 1": edit(edit(
            src, "walk_tasks<T, 1>(", "walk_tasks<T, 2>("), rays, rays.replace(
                "32 / group", "32 / (group == 1 ? 2 : group)")),
        "2 lanes a ray": edit(edit(src, "walk_tasks<T, LEAF_TRIS>(", "walk_tasks<T, 2>("),
                              group, "const int group = 2;"),
        "8 CTAs an SM": edit(src, bounds, "__launch_bounds__(THREADS, 8)\nanim_walk_kernel("),
        "12 CTAs an SM": edit(src, bounds, "__launch_bounds__(THREADS, 12)\nanim_walk_kernel("),
    }


def build_variants(texts):
    """-> {label: loaded library}, one nvcc per variant into a directory of
    its own; prints each variant's ptxas lines of the walk kernels."""
    from pbrt_tpu_torch.kernels import anim_walk, build

    build.BUILD_DIR = VARIANT_DIR
    libs = {}
    for i, (label, text) in enumerate(texts.items()):
        d = VARIANT_DIR / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "anim_walk.cu").write_text(text)
        build.CSRC = d
        build._libs.pop("anim_walk", None)
        anim_walk._lib = None
        anim_walk.load_library()
        libs[label] = anim_walk._lib
        lines = build.build_logs.get("anim_walk", "").splitlines()
        regs = [line.strip() for line in lines if "registers" in line]
        print(f"  {label}: {regs}", flush=True)
    build.CSRC = CSRC
    return libs


def record(cs, scene, extra):
    """The recorded K7 calls of one motion frame: [(args, kwargs)]."""
    import torch

    from pbrt_tpu_torch.ops import animated_intersect

    d = os.path.dirname(scene)
    got, _, launches = cs.cli_render([scene, "--ray-batch", str(cs.MOTION_BATCH), *extra,
                                      "-o", f"{d}/variants.pfm", "-q"])
    orig = animated_intersect.anim_walk
    calls = []

    def copy(x):
        return x.clone() if torch.is_tensor(x) else tuple(map(copy, x)) if isinstance(
            x, tuple) else x

    def recording(*a, **kw):
        calls.append((copy(a), kw))
        return orig(*a, **kw)

    animated_intersect.anim_walk = recording
    try:
        got["renderer"].render()
        torch.cuda.synchronize()
    finally:
        animated_intersect.anim_walk = orig
    return calls


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from pbrt_tpu_torch.kernels import anim_walk
    from pbrt_tpu_torch.testscenes import config3_scenefile, write_torus_ply

    if not torch.cuda.is_available():
        raise SystemExit("k7_variants: needs a CUDA card")
    print(cs.card_info(), flush=True)
    os.chdir(ROOT)
    libs = build_variants(variants((CSRC / "anim_walk.cu").read_text()))
    d = os.path.abspath(cs.SCENEFILE_DIR)
    os.makedirs(d, exist_ok=True)
    write_torus_ply(f"{d}/torus.ply")
    scene = f"{d}/motion.pbrt"
    config3_scenefile(scene, f"{d}/torus.ply", **cs.MOTION, rotate=cs.MOTION_ROTATE,
                      shift=cs.MOTION_SHIFT)
    anim_walk._lib = libs["design"]
    for label, extra in (("K7<float>", []), ("K7<double>", ["--double"])):
        calls = record(cs, scene, extra)
        times = {v: [[] for _ in calls] for v in libs}
        want = []
        for rnd in range(3):
            for v, lib in libs.items():
                anim_walk._lib = lib
                for i, (a, kw) in enumerate(calls):
                    out = [x.clone() for x in anim_walk.anim_walk(*a, **kw)]
                    any_hit = kw.get("any_hit", a[-1] if len(a) > 6 else False)
                    if len(want) <= i:
                        want.append(out)
                    elif any_hit:
                        if not torch.equal(out[1] >= 0, want[i][1] >= 0):
                            raise AssertionError(f"{label} {v}: sweep {i}'s hits differ")
                    elif not all(torch.equal(x, y) for x, y in zip(out, want[i])):
                        raise AssertionError(f"{label} {v}: sweep {i} differs")
                    times[v][i].append(cs.cuda_ms(lambda: anim_walk.anim_walk(*a, **kw), 20))
        print(f"{label} (ms per sweep by events, median of 3 rounds; {len(calls)} sweeps)")
        for v, per in times.items():
            med = [float(np.median(x)) for x in per]
            print(f"  {v}: mean {np.mean(med):.4f}, sweeps {[round(t, 4) for t in med]}",
                  flush=True)
        anim_walk._lib = libs["design"]
        del calls


if __name__ == "__main__":
    main()
