"""Command line of `rlsolver_tpu_torch.eval.quality_summary` (`check_standing_main`, the port of scripts/check_standing.py).

    python scripts/torch_check_standing.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.quality_summary import check_standing_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(check_standing_main(sys.argv[1:]))
