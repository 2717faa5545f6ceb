"""Host-side adapter for external (gym-style) python environments
(counterpart of the JAX package's `envs/external.py`; numpy only).

Reference counterpart: `rlsolver/elegantrl/envs/CustomGymEnv.py` (gym
wrapper normalizing reset/step signatures) and the process-per-env
`VecEnv`/`SubEnv` vectorization (`elegantrl/train/config.py:212-313`).

Python envs live on the host, so the equivalent is a host-side batcher: K
python env instances stepped in a loop (the reference steps them in K
processes — pure dispatch overhead at these env sizes), exposing a batched
numpy API. Anything gym-compatible works: the adapter duck-types
`reset() -> obs` / `step(a) -> (obs, reward, done, info)` and both the
4-tuple and the 5-tuple (terminated/truncated) step conventions.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np


class BatchedHostEnv:
    """Batch of python envs behind one numpy-batched reset/step API.

    env_fns: factories, one per env instance. Auto-resets finished envs
    (the standard vec-env convention) so the batch never blocks.
    """

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        if not env_fns:
            raise ValueError("need at least one env factory")
        self.envs: List[Any] = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)

    @staticmethod
    def _reset_one(env) -> np.ndarray:
        out = env.reset()
        if isinstance(out, tuple):  # gymnasium: (obs, info)
            out = out[0]
        return np.asarray(out)

    @staticmethod
    def _step_one(env, action) -> Tuple[np.ndarray, float, bool]:
        out = env.step(action)
        if len(out) == 5:  # gymnasium: obs, rew, terminated, truncated, info
            obs, rew, term, trunc, _ = out
            done = bool(term) or bool(trunc)
        else:  # classic gym: obs, rew, done, info
            obs, rew, done, _ = out
            done = bool(done)
        return np.asarray(obs), float(rew), done

    def reset(self) -> np.ndarray:
        return np.stack([self._reset_one(e) for e in self.envs])

    def step(self, actions: np.ndarray):
        """actions [B, ...] -> (obs [B, ...], rew f32 [B], done bool [B]).

        Done envs are auto-reset; their returned obs is the fresh reset
        observation (reward/done describe the finished step).
        """
        obs_l, rew_l, done_l = [], [], []
        for env, a in zip(self.envs, actions):
            obs, rew, done = self._step_one(env, a)
            if done:
                obs = self._reset_one(env)
            obs_l.append(obs)
            rew_l.append(rew)
            done_l.append(done)
        return (
            np.stack(obs_l),
            np.asarray(rew_l, np.float32),
            np.asarray(done_l, bool),
        )
