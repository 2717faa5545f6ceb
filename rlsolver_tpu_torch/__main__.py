"""`python -m rlsolver_tpu_torch` — the port's CLI (see rlsolver_tpu_torch.run)."""

from rlsolver_tpu_torch.run import main

raise SystemExit(main())
