#!/usr/bin/env python3
"""Wall seconds of some of ``chip_smoke.py``'s phases, on the card, for
the checkout given (its own package, kernels and ``chip_smoke.py``):

    python3 scripts/phase_seconds.py CHECKOUT [3] [15c] [16] [17]

``3`` is phase 3 (the kernels against their plain versions, with phase
4's renderers built first), ``15c`` phase 15 (c) (the volpath gradient
step), ``16`` phase 16 (motion blur, SPPM, the cameras), ``17`` phase 17
(hair, fourier, spectral, the BDPT step).  Each
runs once after the kernels are built; the last line is one JSON object
with the card's ``nvidia-smi`` name and power limit and each phase's
seconds.  To compare two checkouts (e.g. the parent unpacked with
``git archive`` under ``build/``), run both in one chip call, in turns.
"""

import json
import os
import sys
import time


def main(argv):
    root = os.path.abspath(argv[0])
    phases = argv[1:] or ["3", "15c", "17"]
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pbrt_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("phase_seconds: needs a CUDA card")
    card = cs.card_info()
    build.build()
    d = os.path.abspath(cs.SCENEFILE_DIR)
    os.makedirs(d, exist_ok=True)
    run = {"3": lambda: cs.phase_kernels(cs.renderers()),
           "15c": lambda: cs.phase_volpath_grad(card, d),
           "16": lambda: cs.phase_motion(card),
           "17": lambda: cs.phase_features(card)}
    out = {"checkout": root, "card": card}
    for p in phases:
        t0 = time.time()
        run[p]()
        torch.cuda.synchronize()
        out[f"phase_{p}_s"] = time.time() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
