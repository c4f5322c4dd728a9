"""`python -m bwbble_tpu_torch` — the bwbble CLI (see bwbble_tpu_torch.cli)."""

import sys

from bwbble_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
