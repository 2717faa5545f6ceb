"""RUN-CSP's maxcut cell on the CPU, the JAX package beside the port, over
training seeds: `scripts/learned_gap.py --cell runcsp` under its old name.

    JAX_PLATFORMS=cpu python scripts/runcsp_gap.py [--side jax|port|both] [--seeds 10 11 ...] [--pool]

The cell, the rows it appends to `results_quality/torch/learned_gap.csv`
and the JSON line it prints are `learned_gap.py`'s.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from learned_gap import main  # noqa: E402

if __name__ == "__main__":
    main(["--cell", "runcsp", *sys.argv[1:]])
