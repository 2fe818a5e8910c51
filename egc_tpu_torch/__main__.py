"""``python -m egc_tpu_torch EXP_DIR MODEL DATASET [options]``: the port's
command line (``cli.py``)."""

import sys

from egc_tpu_torch.cli import cli

if __name__ == "__main__":
    sys.exit(cli())
