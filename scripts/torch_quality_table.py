"""Command line of `rlsolver_tpu_torch.eval.quality` (the port of scripts/quality_table.py).

    python scripts/torch_quality_table.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.quality import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
