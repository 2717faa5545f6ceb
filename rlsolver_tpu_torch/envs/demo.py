"""Demo continuous-control envs (counterpart of the JAX package's
`envs/demo.py`; ElegantRL's `PointChasingEnv` and `StockTradingEnv`).

Batched state machines whose state tensors live on the card (unless
`device="cpu"`), used with `algos/continuous.py`. Everything is float32, as
in the JAX package, so that cash and holdings round the same way. The
step counters are host ints (one for the whole batch). Draws come from a
`torch.Generator` unless the caller injects them (`reset(..., chaser=,
target=)`, `step(..., noise=)`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from rlsolver_tpu_torch.device import resolve_device


# ------------------------------------------------------------ point chasing
class PointChasingState(NamedTuple):
    chaser: torch.Tensor  # [B, 2]
    target: torch.Tensor  # [B, 2]
    t: int


@dataclasses.dataclass(frozen=True)
class PointChasingEnv:
    """Chaser vs drifting target; obs = [chaser, target, delta]; reward =
    -distance; `done` every `horizon` steps, when t wraps to 0."""

    dt: float = 0.2
    target_speed: float = 0.05
    horizon: int = 32
    device: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def obs_dim(self) -> int:
        return 6

    @property
    def act_dim(self) -> int:
        return 2

    def reset(self, batch: int, generator: Optional[torch.Generator] = None, chaser: Optional[torch.Tensor] = None,
              target: Optional[torch.Tensor] = None):
        """Positions uniform in [-1, 1)^2 (from `generator` unless given)."""
        if chaser is None:
            chaser = torch.rand((batch, 2), generator=generator, device=self.device) * 2.0 - 1.0
        if target is None:
            target = torch.rand((batch, 2), generator=generator, device=self.device) * 2.0 - 1.0
        state = PointChasingState(chaser.to(self.device), target.to(self.device), 0)
        return state, self.observe(state)

    def observe(self, state: PointChasingState) -> torch.Tensor:
        return torch.cat([state.chaser, state.target, state.target - state.chaser], dim=-1)

    def step(self, state: PointChasingState, action: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None):
        """(state, obs, reward [B], done f32 [B]); `noise` the target's unit
        normals [B, 2] (from `generator` unless given)."""
        chaser = state.chaser + torch.clamp(action, -1.0, 1.0) * self.dt
        # the target drifts away from the chaser with noise (the evade behavior)
        away = state.target - state.chaser
        away = away / (torch.linalg.vector_norm(away, dim=-1, keepdim=True) + 1e-6)
        if noise is None:
            noise = torch.randn(state.target.shape, generator=generator, device=self.device)
        target = torch.clamp(state.target + away * self.target_speed + noise.to(self.device) * 0.02, -2.0, 2.0)
        reward = -torch.linalg.vector_norm(chaser - target, dim=-1)
        t = state.t + 1
        done = torch.full_like(reward, float(t >= self.horizon))
        new = PointChasingState(chaser, target, 0 if t >= self.horizon else t)
        return new, self.observe(new), reward, done


# ------------------------------------------------------------- stock trading
class StockState(NamedTuple):
    cash: torch.Tensor  # [B]
    shares: torch.Tensor  # [B, S]
    day: int


@dataclasses.dataclass(frozen=True)
class StockTradingEnv:
    """Daily rebalancing over a fixed price array [T, S] (f32): an action in
    [-1, 1]^S trades up to +-`max_trade` shares of each stock, sells capped
    by the holdings and the whole trade scaled down (never below zero) to
    what the cash pays for; reward = the change in total assets."""

    prices: np.ndarray  # [T, S]
    initial_cash: float = 1e4
    max_trade: float = 10.0
    device: Optional[object] = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "_price_table", torch.as_tensor(np.asarray(self.prices, np.float32), device=dev))

    @property
    def num_stocks(self) -> int:
        return int(self.prices.shape[1])

    @property
    def num_days(self) -> int:
        return int(self.prices.shape[0])

    @property
    def obs_dim(self) -> int:
        return 1 + 2 * self.num_stocks

    @staticmethod
    def random_walk(num_days: int, num_stocks: int, seed: int = 0, device=None) -> "StockTradingEnv":
        """Geometric random walks from 50 (numpy's RandomState(seed))."""
        rng = np.random.RandomState(seed)
        rets = rng.normal(0.0003, 0.02, (num_days, num_stocks))
        prices = 50.0 * np.exp(np.cumsum(rets, axis=0))
        return StockTradingEnv(prices.astype(np.float32), device=device)

    def _prices(self, day: int) -> torch.Tensor:
        return self._price_table[day]

    def assets(self, state: StockState) -> torch.Tensor:
        return state.cash + (state.shares * self._prices(state.day)[None, :]).sum(dim=-1)

    def reset(self, batch: int):
        state = StockState(torch.full((batch,), self.initial_cash, dtype=torch.float32, device=self.device),
                           torch.zeros((batch, self.num_stocks), device=self.device), 0)
        return state, self.observe(state)

    def observe(self, state: StockState) -> torch.Tensor:
        p = self._prices(state.day)
        return torch.cat([state.cash[:, None] / self.initial_cash, state.shares,
                          p[None, :].expand(state.shares.shape) / 100.0], dim=-1)

    def step(self, state: StockState, action: torch.Tensor):
        """(state, obs, reward [B], done f32 [B])."""
        p = self._prices(state.day)[None, :]
        trade = torch.clamp(action, -1.0, 1.0) * self.max_trade
        # sells capped by holdings, buys capped by cash (greedy scale-down)
        trade = torch.maximum(trade, -state.shares)
        cost = (trade * p).sum(dim=-1)
        scale = torch.where(cost > state.cash, state.cash / torch.clamp(cost, min=1e-9), 1.0)
        # the JAX package lets f32 rounding's slightly negative cash turn the
        # scale negative, which reverses every trade (holdings below zero):
        # here it stops at 0 (no trade), and matches JAX wherever cash >= 0
        trade = trade * torch.clamp(scale, min=0.0, max=1.0)[:, None]
        cost = (trade * p).sum(dim=-1)
        before = self.assets(state)
        new = StockState(state.cash - cost, state.shares + trade, min(state.day + 1, self.num_days - 1))
        reward = self.assets(new) - before
        done = torch.full_like(reward, float(new.day >= self.num_days - 1))
        return new, self.observe(new), reward, done
