#!/usr/bin/env python3
"""Save, or compare, the port's outputs under its default arguments on
the CPU: images and gradients that two checkouts must give bit for bit
when a change leaves the defaults alone.

Run from the root of each checkout, then compare:

    python3 scripts/default_outputs.py save out_a.npz      # checkout A
    python3 scripts/default_outputs.py save out_b.npz      # checkout B
    python3 scripts/default_outputs.py compare out_a.npz out_b.npz

``save`` renders config 3's scene with a 48x48 torus (4,612 triangles:
the streaming BVH8 tables) at 16x16, 4 spp, maxdepth 4 under the walks
``bvh8`` (sorts ``stable`` and ``bitonic``), ``skip`` and ``binary``,
takes the loss and gradient of ``make_loss_fn`` on it at 12x12, 2 spp,
and renders the Cornell box at 16x16, 2 spp, maxdepth 3 (~1 min).  It
uses only the package of the checkout it lies in.  ``compare`` prints,
for each array, whether the two are bit-equal, and exits 1 unless all
are.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def save(path):
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.testscenes import cornell_renderer, mesh_scene_renderer

    out = {}
    for walk, sort in (("bvh8", "stable"), ("bvh8", "bitonic"), ("skip", "stable"),
                       ("binary", "stable")):
        r, _ = mesh_scene_renderer(xres=16, yres=16, spp=4, maxdepth=4, nu=48, nv=48,
                                   device="cpu", walk=walk, sort=sort)
        out[f"image_{walk}_{sort}"] = r.image(r.render())
    r, _ = mesh_scene_renderer(xres=12, yres=12, spp=2, maxdepth=4, nu=48, nv=48, device="cpu")
    px = torch.as_tensor(r.film.cropped_pixel_bounds.offsets())
    value, grads = value_and_grad(make_loss_fn(r, np.zeros((12, 12, 3), np.float32), spp=2),
                                  r.compiled.initial_theta(), px)
    out["loss"] = np.array(float(value))
    out.update({f"grad_{k}": v.numpy() for k, v in grads.items() if isinstance(v, torch.Tensor)})
    c = cornell_renderer(xres=16, yres=16, spp=2, maxdepth=3, device="cpu")
    out["image_cornell"] = c.image(c.render())
    np.savez(path, **out)
    print(f"saved {len(out)} arrays to {path}")


def compare(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    same = sorted(a.files) == sorted(b.files)
    for k in sorted(set(a.files) & set(b.files)):
        equal = np.array_equal(a[k], b[k])
        same &= equal
        print(f"{k}: {'bit-equal' if equal else 'DIFFERENT'} "
              f"(max |x| {np.abs(a[k]).max(initial=0.0):.6g})")
    print("all bit-equal" if same else "outputs differ")
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
