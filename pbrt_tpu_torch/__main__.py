"""``python -m pbrt_tpu_torch scene.pbrt``: see ``cli.py``."""

import sys

from pbrt_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
