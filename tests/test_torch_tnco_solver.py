"""The TNCO solvers (`algos/tnco_solver.py`) against the JAX package's:
three MCPG rounds with `sampler="scan"` and JAX's MH and local-search draws
injected (incumbents, logits, Adam's moments and the metrics within 1e-6),
the local-search solver's history equal from JAX's orders and draws, and
the `sampler="fused"` step on the CPU (K3's plain version): valid orders
and a state of the right shapes. K3 itself is held bit for bit against its
plain version only on the card (`chip_smoke.py`, phase tnco)."""

import jax
import numpy as np
import torch

from rlsolver_tpu.algos import tnco_solver as js
from rlsolver_tpu.envs import tnco as jt
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import tnco_solver as ts
from rlsolver_tpu_torch.envs import tnco as tt

torch.set_num_threads(1)
NODES = tt.random_circuit_nodes(6, 5, seed=0)


def envs():
    return jt.TncoEnv(jt.TensorNetwork.from_nodes_list(*NODES)), tt.TncoEnv(
        tt.TensorNetwork.from_nodes_list(*NODES), "cpu")


def ls_draws(key, num_iters, b, num_spin, run_edges):
    """`TncoEnv.local_search`'s draws from key, as numpy."""
    idx, normal = [], []
    for k in jax.random.split(key, num_iters):
        k_idx, k_noise = jax.random.split(k)
        idx.append(np.array(jax.random.randint(k_idx, (b, num_spin), 0, run_edges)))
        normal.append(np.array(jax.random.normal(k_noise, (b, num_spin))))
    return tt.LocalSearchDraws(torch.from_numpy(np.stack(idx)), torch.from_numpy(np.stack(normal)))


def mh_draws(key, rounds, b, n):
    """`metropolis_bitflip_scan`'s proposals from key, as numpy."""
    nodes, u = [], []
    for k in jax.random.split(key, rounds):
        k_node, k_u = jax.random.split(k)
        nodes.append(np.array(jax.random.randint(k_node, (b,), 0, n)))
        u.append(np.array(jax.random.uniform(k_u, (b,))))
    return torch.from_numpy(np.stack(nodes)), torch.from_numpy(np.stack(u))


def test_three_mcpg_rounds_match_jax():
    jenv, tenv = envs()
    cfg_kw = dict(num_chains=8, repeat_times=4, mh_rounds=64, ls_iters=2, seed=3)
    jcfg, tcfg = js.TncoMcpgConfig(**cfg_kw), ts.TncoMcpgConfig(**cfg_kw)
    policy, optimizer, jstep = js.make_tnco_mcpg_step(jenv, jcfg)
    jstate = js.init_tnco_mcpg_state(jenv, policy, optimizer, jcfg)
    k_init, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    sorts = torch.from_numpy(np.array(jenv.random_edge_sorts(k_init, jcfg.num_chains)))
    tstate = ts.init_tnco_mcpg_state(tenv, tcfg, sorts=sorts)
    np.testing.assert_allclose(tstate.best_vs.numpy(), np.asarray(jstate.best_vs), rtol=0, atol=2e-6)
    tstep = ts.make_tnco_mcpg_step(tenv, tcfg)
    jit_step = jax.jit(jstep)
    b = jcfg.num_chains * jcfg.repeat_times
    for _ in range(3):
        _, k_mh, k_ls = jax.random.split(jstate.key, 3)
        draws = ts.TncoRoundDraws(*mh_draws(k_mh, jcfg.mh_rounds, b, jenv.num_bits),
                                  ls_draws(k_ls, jcfg.ls_iters, b, 8, jenv.run_edges))
        jstate, jm = jit_step(jstate)
        tstate, tm = tstep(tstate, draws)
        np.testing.assert_allclose(tstate.best_fs.numpy(), np.asarray(jstate.best_fs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tstate.best_vs.numpy(), np.asarray(jstate.best_vs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(tm["best"]), float(jm["best"]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(tm["mean"]), float(jm["mean"]), rtol=0, atol=1e-6)
        logits = convert.policy_state_dict(jax.tree.map(np.asarray, jstate.params))["logits"].numpy()
        np.testing.assert_allclose(tstate.policy.logits.detach().numpy(), logits, rtol=0, atol=1e-6)
        adam = convert.adam_state(jax.tree.map(np.asarray, jstate.opt_state))
        assert adam["count"] == tstate.optimizer.count
        np.testing.assert_allclose(tstate.optimizer.mu[0].numpy(), adam["mu"][0].numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tstate.optimizer.nu[0].numpy(), adam["nu"][0].numpy(), rtol=1e-4, atol=1e-9)
    # the policy moved and the incumbents improved on the initial orders
    assert float(tm["best"]) <= float(tstate.best_vs.max())


def test_local_search_solver_history_matches_jax():
    jenv, tenv = envs()
    cfg = ts.TncoSearchConfig(num_chains=16, num_rounds=4, ls_iters=3, seed=5)
    order, cost, history = js.solve_tnco_local_search(jenv, js.TncoSearchConfig(**cfg.__dict__))
    key = jax.random.PRNGKey(cfg.seed)
    k_init, key = jax.random.split(key)
    sorts = torch.from_numpy(np.array(jenv.random_edge_sorts(k_init, cfg.num_chains)))
    draws = []
    for _ in range(cfg.num_rounds):
        key, k = jax.random.split(key)
        draws.append(ls_draws(k, cfg.ls_iters, cfg.num_chains, cfg.num_spin, jenv.run_edges))
    t_order, t_cost, t_history = ts.solve_tnco_local_search(tenv, cfg, sorts=sorts, draws=draws)
    np.testing.assert_allclose(t_history, history, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(t_order, order)
    assert abs(t_cost - cost) < 2e-6
    assert abs(tenv.log10_multiple_times_accurate(t_order[None])[0] - t_cost) < 1e-4


def test_fused_step_on_the_cpu_runs_the_plain_sampler():
    _, tenv = envs()
    cfg = ts.TncoMcpgConfig(num_chains=4, repeat_times=2, num_rounds=2, mh_rounds=16, ls_iters=1, sampler="fused")
    order, cost, history = ts.solve_tnco_mcpg(tenv, cfg)
    assert sorted(order.tolist()) == list(range(tenv.run_edges))
    assert len(history) == 2 and history[1] <= history[0]
    assert abs(tenv.log10_multiple_times_accurate(order[None])[0] - cost) < 1e-4
    step = ts.make_tnco_mcpg_step(tenv, cfg)
    state, metrics = step(ts.init_tnco_mcpg_state(tenv, cfg))
    assert state.best_fs.shape == (4, tenv.run_edges) and state.best_vs.shape == (4,)
    assert state.policy.logits.shape == (tenv.num_bits,) and state.optimizer.count == 1
    assert set(metrics) == {"best", "mean"}
