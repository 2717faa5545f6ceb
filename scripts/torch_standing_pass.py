"""Command line of `rlsolver_tpu_torch.eval.standing_pass` (the port of scripts/standing_pass.py).

    python scripts/torch_standing_pass.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.standing_pass import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
