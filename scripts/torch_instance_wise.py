"""Command line of `rlsolver_tpu_torch.eval.instance_wise` (the port of scripts/instance_wise.py).

    python scripts/torch_instance_wise.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.eval.instance_wise import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
