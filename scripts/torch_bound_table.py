"""Command line of `rlsolver_tpu_torch.eval.quality` (`bound_main`, the port of scripts/bound_table.py).

    python scripts/torch_bound_table.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.quality import bound_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(bound_main(sys.argv[1:]))
