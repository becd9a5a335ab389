"""Command-line driver (counterpart of ``pbrt_tpu/cli.py``):

    python -m pbrt_tpu_torch [-n N] [--quick] [-q] [-v] [-o FILE]
                             [--ray-batch N] [--checkpoint DIR]
                             [--sampled-spectrum] [--double] scene.pbrt ...

parses the scene files and renders each world block at its ``WorldEnd``
on the CUDA card, writing the film's image (PNG or PFM by extension).
Parse errors and missing files exit 1.  The device is an argument of
:func:`main`, not a flag: the command runs on the card and raises where
there is none; tests call ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from pbrt_tpu_torch import Options, require_device
from pbrt_tpu_torch.core.api import PbrtAPI
from pbrt_tpu_torch.core.parser import ParseError


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="pbrt-tpu-torch",
                                 description="pbrt-v3 renderer on PyTorch and CUDA")
    ap.add_argument("-n", "--nthreads", type=int, default=1,
                    help="accepted and ignored, for pbrt compatibility (the card is the "
                         "parallelism)")
    ap.add_argument("--quick", action="store_true",
                    help="quarter-resolution, quarter-spp draft render")
    ap.add_argument("-q", "--quiet", action="store_true", help="log errors only")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-o", "--outfile", default="", help="override output image path")
    ap.add_argument("--ray-batch", type=int, default=1 << 16)
    ap.add_argument("--checkpoint", default="", metavar="DIR",
                    help="save film state + sweep cursor to DIR periodically and resume "
                         "from it if present")
    ap.add_argument("--sampled-spectrum", action="store_true",
                    help="sampled-spectrum transport: five passes of three wavelength bins, "
                         "summed to XYZ (the reference's PBRT_TPU_SAMPLED_SPECTRUM)")
    ap.add_argument("--double", action="store_true",
                    help="the float64 policy: parameters, tables, film and gradients in "
                         "float64 (the reference's PBRT_TPU_DOUBLE=1)")
    ap.add_argument("scenes", nargs="+", help="pbrt scene files")
    args = ap.parse_args(argv)
    device = require_device(device)

    level = logging.DEBUG if args.verbose else logging.INFO
    if args.quiet:
        level = logging.ERROR
    logging.basicConfig(level=level, format="%(asctime)s.%(msecs)03d %(levelname)s %(message)s",
                        datefmt="%H:%M:%S")
    opts = Options(
        quick_render=args.quick,
        verbose=args.verbose,
        image_file=args.outfile,
        ray_batch=args.ray_batch,
        checkpoint_dir=args.checkpoint or None,
        sampled_spectrum=args.sampled_spectrum,
        double=args.double,
    )
    pbrt = PbrtAPI(opts, device=device)
    pbrt.init()
    for f in args.scenes:
        try:
            pbrt.parse_file(f)
        except (ParseError, OSError) as e:
            logging.error("%s: %s", f, e)
            return 1
    pbrt.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
