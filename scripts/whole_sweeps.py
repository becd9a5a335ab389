#!/usr/bin/env python3
"""Time the whole-tree walks on their own sweeps on one CUDA card.

Run from the root of a checkout on a machine with a card:

    python3 scripts/whole_sweeps.py

It times K6 ``skip_walk`` on config 3's seven chunk-0 sweeps
(``walk="skip"``) and the whole-tree K4 ``ordered_walk2`` on the small
torus's seven sweeps (``walk="binary"``) and on the 3000-triangle soup's
262,144 closest-hit rays, each sweep recorded from one frame as in
``chip_smoke.py`` and timed as the mean of 20 launches after one (CUDA
events; on small sweeps these include the host's launch overhead) and by
the device time of its kernels (torch.profiler over 10 launches: the
prepass, where there is one, and the walk).  It prints one line per
sweep (live rays, the segments per ray S and rays per task R the kernel
chose where the tree's kernels report them, ms, device ms) and a JSON
line.  It uses only ``chip_smoke.py`` and the package of the checkout it
lies in, so a copy of it placed in another checkout's ``scripts/`` times
that checkout's kernels; compare two checkouts in turns within one call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import torch

    import chip_smoke as cs
    from pbrt_tpu_torch.kernels import bvh2_walk
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2

    if not torch.cuda.is_available():
        raise SystemExit("whole_sweeps: needs a CUDA card")
    print(cs.card_info(), flush=True)
    segment_stats = getattr(bvh2_walk, "segment_stats", None)
    cs.VARIANTS = {k: cs.VARIANTS[k] for k in ("skip", "small_binary")}
    rs = cs.renderers()
    closest, shadow = rs["skip"].integrator.queries_per_sample()
    soup = OrderedBVH2(*cs.soup_tables(8), device=cs.DEVICE)
    sweeps = {
        "skip_walk": [(rs["skip"].compiled.intersector.walk, call)
                      for call in cs.record_walks(rs["skip"])[:closest + shadow]],
        "ordered_walk2": [(rs["small_binary"].compiled.intersector.walk, call)
                          for call in cs.record_walks(rs["small_binary"])]
        + [(soup, cs.random_rays(cs.SWEEP, 3, -2.0, 2.0) + (False,))],
    }
    result = {}
    for name, calls in sweeps.items():
        lines = []
        for walk, (o, d, t_max, any_hit) in calls:
            fn, _, args, kw, *_ = cs.walk_call(name, walk, o, d, t_max)
            kw = dict(kw, any_hit=any_hit)
            fn(*args, **kw)
            torch.cuda.synchronize()
            split = segment_stats() if segment_stats else {}
            segments, rays = split.get("segments"), split.get("rays_per_task")
            ms = cs.cuda_ms(lambda: fn(*args, **kw), 20)
            kernels = cs.profiled_ms(lambda: fn(*args, **kw), 10,
                                     ("whole_prep_kernel", f"{name}_kernel"))
            dev = sum(v[0] or 0.0 for v in kernels.values())
            live = int((t_max > 1e-4).sum())
            lines.append({"rays": int(t_max.shape[0]), "live": live, "any_hit": any_hit,
                          "segments": segments, "rays_per_task": rays, "ms": ms,
                          "device_ms": dev})
            print(f"  {name}: {t_max.shape[0]} rays, {live} live, "
                  f"{'any' if any_hit else 'closest'} hit, S = {segments}, R = {rays}, "
                  f"{ms:.4f} ms, device {dev:.4f} ms", flush=True)
        result[name] = lines
    print(json.dumps(result))


if __name__ == "__main__":
    main()
