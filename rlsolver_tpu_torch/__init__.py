"""PyTorch/CUDA port of `rlsolver_tpu`, one slice at a time.

This slice covers MCPG maxcut end to end (`python -m rlsolver_tpu_torch
--alg mcpg [--fast]`): graphs, the cut objective, the Metropolis samplers,
the degree-ordered and 1-flip sweeps, the Bernoulli policy with its
REINFORCE/Adam update, and the CLI. The bit-packed hot loops run as CUDA
kernels written for Hopper (`csrc/*.cu`, wrapped in `ops/kernels/`).

The package imports torch and numpy only. Entry points run on `cuda` unless
the caller passes `device="cpu"`; on the CPU each kernel wrapper runs its
plain PyTorch version.
"""
