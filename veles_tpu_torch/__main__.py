"""`python -m veles_tpu_torch workflow.py (--fused | --serve PORT) ...`
(see launcher.py)."""

import sys

from veles_tpu_torch.launcher import main

if __name__ == "__main__":
    sys.exit(main())
