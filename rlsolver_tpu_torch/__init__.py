"""PyTorch/CUDA port of `rlsolver_tpu` for an NVIDIA H100.

The port covers the JAX package: MCPG and L2A on maxcut and across
problems, local search, Pattern I (ECO/S2V-DQN, Jumanji PPO), the classical
baselines, the runners and the problem axis, TNCO, flip-MDP PPO/A2C, S2V,
beamforming, VQE, the TSP axis (POMO, REINFORCE, seq2seq, L2O), RUN-CSP,
DCS, the RL+OR pipelines, the off-policy and multi-agent agents, and the
data-parallel layer (`parallel/`) with the sharded forms of TNCO MCPG, PPO,
L2A and POMO, and the entry points of `__graft_entry__.py` (`entry.py`).
The TPU's Pallas kernels run as CUDA kernels written for Hopper
(`csrc/*.cu`, wrapped in `ops/kernels/`).

The package imports torch and numpy only. Entry points run on `cuda` unless
the caller passes `device="cpu"`; on the CPU each kernel wrapper runs its
plain PyTorch version.
"""
