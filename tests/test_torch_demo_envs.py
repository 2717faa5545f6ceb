"""The demo envs (`envs/demo.py`) and the host adapter (`envs/external.py`)
against the JAX package's: PointChasingEnv's reset and steps, across its
horizon, with JAX's uniforms and noise injected (within 1e-6);
StockTradingEnv's random-walk prices bit for bit (the same numpy
RandomState); a 30-day rollout with injected actions (some beyond [-1, 1],
some selling more than is held, some buying more than the cash allows):
cash, shares, rewards and `done` within 1e-4 relative at every day, never
short and never overspent; a cash left just below zero by f32 rounding
stops the port's trades, where the JAX package's negative scale reverses
them (a JAX fault the port does not copy); BatchedHostEnv on a duck-typed
old-gym and gymnasium env."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.envs import demo as jd
from rlsolver_tpu.envs.external import BatchedHostEnv as JBatchedHostEnv
from rlsolver_tpu_torch.envs import demo as td
from rlsolver_tpu_torch.envs.external import BatchedHostEnv

torch.set_num_threads(1)


def test_point_chasing_matches_jax():
    jenv, tenv = jd.PointChasingEnv(horizon=4), td.PointChasingEnv(horizon=4, device="cpu")
    key = jax.random.PRNGKey(0)
    js, jobs = jenv.reset(key, 8)
    k1, k2 = jax.random.split(key)
    ts, tobs = tenv.reset(8, chaser=torch.from_numpy(np.array(jax.random.uniform(k1, (8, 2), minval=-1.0,
                                                                                    maxval=1.0))),
                          target=torch.from_numpy(np.array(jax.random.uniform(k2, (8, 2), minval=-1.0, maxval=1.0))))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(1)
    for step in range(9):
        key, k = jax.random.split(key)
        action = rng.uniform(-1.5, 1.5, (8, 2)).astype(np.float32)
        js, jobs, jr, jdone = jenv.step(k, js, jnp.asarray(action))
        noise = torch.from_numpy(np.array(jax.random.normal(k, (8, 2))))
        ts, tobs, tr, tdone = tenv.step(ts, torch.from_numpy(action), noise=noise)
        for a, b in ((tobs, jobs), (tr, jr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6, err_msg=f"step {step}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        assert ts.t == int(js.t)
    assert ts.t == 1  # wrapped at 4 and 8


def test_stock_trading_rollout_matches_jax():
    jwalk, twalk = jd.StockTradingEnv.random_walk(30, 3, seed=2), td.StockTradingEnv.random_walk(30, 3, seed=2,
                                                                                                 device="cpu")
    np.testing.assert_array_equal(twalk.prices, jwalk.prices)
    assert twalk.prices.dtype == np.float32
    cash = 2000.0  # a few days of full buys spend it
    jenv = jd.StockTradingEnv(jwalk.prices, initial_cash=cash)
    tenv = td.StockTradingEnv(twalk.prices, initial_cash=cash, device="cpu")
    js, jobs = jenv.reset(4)
    ts, tobs = tenv.reset(4)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(3)
    tight = False
    for day in range(29):
        action = rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32)
        if day == 3:
            action[:] = 1.5  # every env buys all it may
        js, jobs, jr, jdone = jenv.step(js, jnp.asarray(action))
        ts, tobs, tr, tdone = tenv.step(ts, torch.from_numpy(action))
        # relative to the assets (cash, rewards) or to each holding (shares, obs)
        for a, b, scale in ((ts.cash, js.cash, cash), (tr, jr, cash), (ts.shares, js.shares, 1.0), (tobs, jobs, 1.0)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4 * scale, err_msg=f"day {day}")
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        assert ts.day == int(js.day)
        assert (ts.cash.numpy() >= -1e-3).all() and (ts.shares.numpy() >= 0).all()
        tight |= bool((ts.cash.numpy() < 1.0).any())
    assert tight  # the cash ran out on some env: the scale-down acted
    assert tdone.numpy().all() and ts.day == 29
    rich = ts._replace(cash=torch.full((4,), 10.0))
    out, _, _, _ = tenv.step(rich, torch.ones(4, 3))
    assert (out.cash.numpy() >= -1e-3).all()


def test_rounding_below_zero_cash_never_reverses_trades():
    """JAX's scale-down divides a slightly negative cash (f32 rounding after
    a full buy) by the cost: a negative scale reverses every trade and
    leaves holdings below zero. The port stops the scale at 0."""
    prices = np.full((3, 2), 50.0, np.float32)
    jenv, tenv = jd.StockTradingEnv(prices), td.StockTradingEnv(prices, device="cpu")
    cash, shares, action = np.float32(-2 ** -10), np.asarray([[0.0, 1.0]], np.float32), np.asarray([[1.0, -0.05]],
                                                                                                     np.float32)
    js, _, _, _ = jenv.step(jd.StockState(jnp.asarray([cash]), jnp.asarray(shares), jnp.int32(0)), jnp.asarray(action))
    ts, _, tr, _ = tenv.step(td.StockState(torch.tensor([cash]), torch.from_numpy(shares), 0), torch.from_numpy(action))
    assert float(np.asarray(js.shares).min()) < 0  # the JAX package's reversed buy
    np.testing.assert_array_equal(ts.shares.numpy(), shares)  # no trade
    assert float(ts.cash[0]) == cash and float(tr[0]) == 0.0


def _gym_classes():
    class OldGym:
        def __init__(self):
            self.t = 0

        def reset(self):
            self.t = 0
            return np.array([0.0])

        def step(self, a):
            self.t += 1
            return np.array([float(self.t)]), 1.0, self.t >= 3, {}

    class NewGym:
        def __init__(self):
            self.t = 0

        def reset(self):
            self.t = 0
            return np.array([10.0]), {}

        def step(self, a):
            self.t += 1
            return np.array([10.0 + self.t]), 2.0, self.t >= 2, False, {}

    return OldGym, NewGym


def test_batched_host_env_matches_jax():
    ours, theirs = BatchedHostEnv(_gym_classes()), JBatchedHostEnv(_gym_classes())
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    acts = np.zeros((2, 1))
    for _ in range(7):
        for a, b in zip(ours.step(acts), theirs.step(acts)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        BatchedHostEnv([])


ENTRY_POINTS = {
    "PointChasingEnv": lambda dev: td.PointChasingEnv(device=dev).reset(2)[1],
    "StockTradingEnv": lambda dev: td.StockTradingEnv.random_walk(5, 2, device=dev).reset(2)[1],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
