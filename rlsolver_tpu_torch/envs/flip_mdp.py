"""Pattern-I vectorized flip MDP: one node flip per env per step
(counterpart of `rlsolver_tpu/envs/flip_mdp.py`; RLSolver
`envs/env_PPO.py:63-126`).

The action is a node index, the state the current bits, the reward the cut
delta (the flipped node's gain from `ops.cut.flip_gains`) and an episode
ends after `horizon` steps. The observation is the bits as f32 (what the
MLP agent of `methods/PPO.py:55-80` sees). The step count is a Python int.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops import cut as cut_ops


class FlipMdpState(NamedTuple):
    xs: torch.Tensor  # bool [B, N]
    cut: torch.Tensor  # f32 [B] current objective
    t: int  # step count within the episode


class FlipMdpEnv:
    """Static per-instance tensors (on `cuda` unless `device="cpu"`) and
    reset/step (maximize the cut)."""

    def __init__(self, graph: Graph, horizon: int, device=None):
        self.graph = graph
        self.num_nodes = graph.num_nodes
        self.horizon = horizon
        self.cg = cut_ops.CutGraph.build(graph, device)
        self.device = self.cg.n0.device

    def reset(self, gen: Optional[torch.Generator], num_envs: int, start_bits=None,
              xs: Optional[torch.Tensor] = None) -> Tuple[FlipMdpState, torch.Tensor]:
        """`start_bits` [N] starts every env from one known solution (the
        reference's base64 `start_str` warm start, `methods/PPO.py:19-21`);
        else fair coin flips from `gen` (or the injected `xs` [B, N]) with
        node 0 pinned to 0 (`env_PPO.py:124-126`)."""
        if start_bits is not None:
            xs = torch.as_tensor(np.asarray(start_bits, bool), device=self.device)[None, :].expand(
                num_envs, self.num_nodes).clone()
        else:
            if xs is None:
                xs = torch.rand(num_envs, self.num_nodes, generator=gen, device=self.device) < 0.5
            xs = xs.to(self.device).bool().clone()
            xs[:, 0] = False
        state = FlipMdpState(xs, cut_ops.cut_value(xs, self.cg), 0)
        return state, self.observe(state)

    def observe(self, state: FlipMdpState) -> torch.Tensor:
        return state.xs.float()

    def step(self, state: FlipMdpState, actions: torch.Tensor):
        """actions int [B]: the node each env flips. Returns (state, obs,
        reward, done): reward = the flipped node's gain, done 1.0 for every
        env once `horizon` steps are taken (then t restarts at 0; resetting
        the bits is the caller's choice, as in the reference)."""
        gains = cut_ops.flip_gains(state.xs, self.cg)
        actions = actions.long()
        reward = gains.gather(1, actions[:, None])[:, 0]
        xs = state.xs.clone()
        rows = torch.arange(xs.shape[0], device=xs.device)
        xs[rows, actions] = ~xs[rows, actions]
        t = state.t + 1
        done = torch.full((xs.shape[0],), float(t >= self.horizon), device=xs.device)
        new_state = FlipMdpState(xs, state.cut + reward, 0 if t >= self.horizon else t)
        return new_state, self.observe(new_state), reward, done
