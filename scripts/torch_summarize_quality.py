"""Command line of `rlsolver_tpu_torch.eval.quality_summary` (the port of scripts/summarize_quality.py).

    python scripts/torch_summarize_quality.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.quality_summary import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
