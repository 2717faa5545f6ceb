"""Command line of `rlsolver_tpu_torch.eval.eco_distribution` (the port of scripts/eco_distribution.py).

    python scripts/torch_eco_distribution.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.eco_distribution import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
