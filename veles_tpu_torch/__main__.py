"""`python -m veles_tpu_torch workflow.py [--fused | --serve PORT] ...`,
`python -m veles_tpu_torch --route SPEC [--route-port P]` and
`python -m veles_tpu_torch --serve-rollback URL` (see launcher.py)."""

import sys

from veles_tpu_torch.launcher import main

if __name__ == "__main__":
    sys.exit(main())
