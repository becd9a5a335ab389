#!/usr/bin/env python3
"""K7's milliseconds a sweep on the motion frame of ``chip_smoke.py``
phase 16 (a) (config 3 turning 30 degrees, 256x256, 8 spp, maxdepth 4, 2
chunks: 14 sweeps of 262,144 rays) and of phase 19 (b) (the same frame
under ``--double``), for one or more checkouts, each with its own package,
kernels and ``chip_smoke.py``, taken in turns on one card:

    python3 scripts/k7_sweeps.py PARENT CHANGE [--rounds 2]

runs PARENT, CHANGE, CHANGE, PARENT (``--rounds 2``; one round is the
checkouts in order), each in a process of its own.  A checkout's run
renders each frame through its ``cli.main`` with its kernels, records
the arguments of every call of ``ops/animated_intersect.anim_walk`` and
replays each: its mean time over 20 calls by CUDA events after a warm-up
(the wrapper and every launch it makes), and, where the checkout has
``kernels/anim_walk.task_stats``, its live rays and rays per task.  The
last line is one JSON object: the card's ``nvidia-smi`` name and power
limit and, per run, the checkout, its per-sweep times and their means.
"""

import argparse
import json
import os
import subprocess
import sys


def one(root):
    """The sweeps of one checkout -> {"float": [...], "double": [...]}."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pbrt_tpu_torch.kernels import anim_walk, build
    from pbrt_tpu_torch.ops import animated_intersect
    from pbrt_tpu_torch.testscenes import config3_scenefile, write_torus_ply

    build.build(("anim_walk",))
    d = os.path.abspath(cs.SCENEFILE_DIR)
    os.makedirs(d, exist_ok=True)
    ply = f"{d}/torus.ply"
    write_torus_ply(ply)
    scene = f"{d}/motion.pbrt"
    config3_scenefile(scene, ply, **cs.MOTION, rotate=cs.MOTION_ROTATE, shift=cs.MOTION_SHIFT)
    out = {"checkout": root}
    orig = animated_intersect.anim_walk
    for label, extra in (("float", []), ("double", ["--double"])):
        got, _, launches = cs.cli_render([scene, "--ray-batch", str(cs.MOTION_BATCH), *extra,
                                          "-o", f"{d}/motion_{label}.pfm", "-q"])
        calls = []

        def copy(x):
            return (x.clone() if torch.is_tensor(x)
                    else tuple(map(copy, x)) if isinstance(x, tuple) else x)

        def recording(*a, **kw):
            calls.append((copy(a), kw))
            return orig(*a, **kw)

        animated_intersect.anim_walk = recording
        try:
            got["renderer"].render()
            torch.cuda.synchronize()
        finally:
            animated_intersect.anim_walk = orig
        sweeps = []
        for a, kw in calls:
            ms = cs.cuda_ms(lambda: orig(*a, **kw), 20)
            stats = anim_walk.task_stats() if hasattr(anim_walk, "task_stats") else None
            sweeps.append({"ms": ms, "stats": stats})
        out[label] = {"launches": launches, "sweep_ms": [s["ms"] for s in sweeps],
                      "stats": [s["stats"] for s in sweeps],
                      "mean_ms": float(np.mean([s["ms"] for s in sweeps]))}
        del got, calls
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.checkouts[0])))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    order = []
    for r in range(args.rounds):
        order += args.checkouts if r % 2 == 0 else args.checkouts[::-1]
    runs = []
    for ck in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", ck],
                             capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            raise SystemExit(f"k7_sweeps: {ck} failed:\n{res.stdout[-3000:]}{res.stderr[-3000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{ck}: K7<float> {run['float']['mean_ms']:.4f} ms, K7<double> "
              f"{run['double']['mean_ms']:.4f} ms a sweep (means of 14) on {card}", flush=True)
        runs.append(run)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
