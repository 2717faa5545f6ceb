"""Command line of `rlsolver_tpu_torch.eval.quality_summary` (`violating_cells_main`, the port of scripts/violating_cells.py).

    python scripts/torch_violating_cells.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.quality_summary import violating_cells_main  # noqa: E402

if __name__ == "__main__":
    sys.exit(violating_cells_main(sys.argv[1:]))
