"""Batched multi-instance MCPG (`algos/mcpg_batch.py`) against the JAX
package's on three small BA graphs: the budget-masked MH and one whole
round with JAX's draws injected (samples, sweeps, cuts and incumbents bit
for bit; the first update's gradient at rtol 1e-4, the logits after the
round's clipped-Adam steps at rtol 1e-5 where that gradient is not f32
noise around 0), and a short solve's per-graph best cuts."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import mcpg_batch as jb
from rlsolver_tpu.algos.mcpg import MCPGConfig as JConfig
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu.ops.sweeps import SweepData as JSweepData, degree_ordered_sweep, mcpg_init_values
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import mcpg_batch as tb
from rlsolver_tpu_torch.algos.mcpg import MCPGConfig
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
NAMES = [f"BA_24_ID{i}" for i in range(3)]
G, N = len(NAMES), 24


@pytest.fixture(scope="module")
def graphs():
    jgs, tgs = [j_graph_from_name(n) for n in NAMES], [graph_from_name(n) for n in NAMES]
    return jgs, tgs, jb.StackedGraphs.build(jgs), tb.StackedGraphs.build(tgs, "cpu")


def mh_draws(key, rounds, b):
    def one(k):
        k_node, k_u = jax.random.split(k)
        return jax.random.randint(k_node, (G, b), 0, N), jax.random.uniform(k_u, (G, b))

    return jax.vmap(one)(jax.random.split(key, rounds))


def sweep_draws(key, sweeps, b):
    """[sweeps, N, G, b]: graph g's sweep s, node step i draws from
    split(split(split(key, G)[g], sweeps)[s], N)[i], as the vmapped
    `degree_ordered_sweep` does."""
    per_graph = jax.vmap(lambda kg: jax.vmap(lambda ks: jax.vmap(lambda ki: jax.random.uniform(ki, (b,)))(
        jax.random.split(ks, N)))(jax.random.split(kg, sweeps)))(jax.random.split(key, G))
    return jnp.transpose(per_graph, (1, 2, 0, 3))


def test_stacked_tables_and_cuts(graphs):
    jgs, tgs, jsg, tsg = graphs
    np.testing.assert_array_equal(tsg.order.numpy(), np.asarray(jsg.sweep.order))
    # step k's rows: JAX's padded table row of each graph's k-th node, cut to
    # the step's longest list, offset to the graph's block of the state
    j_nbrs, j_w = np.asarray(jsg.sweep.nbrs), np.asarray(jsg.sweep.nbr_w)
    base = (np.arange(G) * (N + 1))[:, None]
    for k in range(N):
        rows, w = tsg.step_tables(k)
        rows = rows.view(G, -1).numpy() - base
        d = rows.shape[1]
        np.testing.assert_array_equal(rows, j_nbrs[:, k, :d])
        np.testing.assert_array_equal(w[:, 0].numpy(), j_w[:, k, :d])
        assert (j_nbrs[:, k, d:] == N).all() and (rows < N).any()
    np.testing.assert_array_equal(tsg.order_rows.numpy().T - base, tsg.order.numpy())
    xs = np.random.default_rng(0).random((G, 5, N)) < 0.5
    np.testing.assert_array_equal(tb.cut_values_stacked(torch.from_numpy(xs), tsg).numpy(),
                                  np.asarray(jb.cut_values_stacked(jnp.asarray(xs), jsg)))
    for g in range(G):
        assert tb.cut_values_stacked(torch.from_numpy(xs), tsg)[g, 0] == obj_maxcut(xs[g, 0], tgs[g])
    with pytest.raises(ValueError, match="num_nodes"):
        tb.StackedGraphs.build([tgs[0], graph_from_name("BA_20_ID0")], "cpu")


@pytest.mark.parametrize("change_times", [1, 3])
def test_mh_stacked_matches_jax_with_budget(change_times):
    b = 10
    rng = np.random.default_rng(change_times)
    probs = rng.uniform(0.2, 0.8, (G, N)).astype(np.float32)
    bits = rng.random((G, b, N)) < 0.5
    key = jax.random.PRNGKey(change_times)
    expect, (nodes, u) = jax.tree.map(np.array, jax.jit(lambda p, x: (
        jb._mh_stacked(key, p, x, change_times), mh_draws(key, 5 * change_times, b)))(probs, bits))
    got = tb._mh_stacked(None, torch.from_numpy(probs), torch.from_numpy(bits), change_times,
                         nodes=torch.from_numpy(nodes), u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), expect)
    # the budget binds: without it the same draws give other chains
    free = bits.copy()
    for t, g, c in np.ndindex(*nodes.shape):
        p = probs[g, nodes[t, g, c]]
        q = p if free[g, c, nodes[t, g, c]] else 1 - p
        free[g, c, nodes[t, g, c]] ^= u[t, g, c] < (1 - q) / q
    assert (free != expect).any()


def test_one_round_matches_jax(graphs):
    jgs, tgs, jsg, tsg = graphs
    C, R = 6, 3
    b = C * R
    cfg = MCPGConfig(total_mcmc_num=C, repeat_times=R, num_ls=2, sample_epoch_num=3, change_times=2)
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 0.5, (G, N)).astype(np.float32)
    start = rng.random((G, b, N)) < 0.5
    best_xs = rng.random((G, C, N)) < 0.5
    k_mh, k_ls = jax.random.split(jax.random.PRNGKey(5))
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))
    sweep_v = jax.vmap(degree_ordered_sweep, in_axes=(0, 0, JSweepData(0, 0, 0, 0, 0, None), None))

    def loss_fn(logits, mh_bits, value):  # `solve_maxcut_mcpg_batched`'s
        probs = jax.nn.sigmoid(logits) * 0.6 + 0.2
        x = mh_bits.astype(jnp.float32)
        logp = jnp.sum(jnp.log(jnp.clip(x * probs[:, None] + (1 - x) * (1 - probs[:, None]), 1e-8)), axis=2)
        return jnp.sum(jnp.mean(logp * value, axis=1))

    @jax.jit
    def jax_round(logits, start, best_xs):  # the body of its `round_step`
        best_vs = jb.cut_values_stacked(best_xs, jsg)
        mh = jb._mh_stacked(k_mh, jax.nn.sigmoid(logits) * 0.6 + 0.2, start, cfg.change_times)
        xt = sweep_v(jax.random.split(k_ls, G), jax.vmap(mcpg_init_values)(mh), jsg.sweep, cfg.num_ls)
        ls = xt[:, :, :N] > 0.5
        cuts = jb.cut_values_stacked(ls, jsg)
        chain_xs, chain_vs = jax.vmap(pick_xs_by_vs, in_axes=(0, 0, None))(ls, cuts, R)
        best_xs, best_vs = jax.vmap(update_xs_by_vs)(best_xs, best_vs, chain_xs, chain_vs)
        top, worst, gi = jnp.argmax(best_vs, axis=1), jnp.argmin(best_vs, axis=1), jnp.arange(G)
        best_xs = best_xs.at[gi, worst].set(best_xs[gi, top])
        best_vs = best_vs.at[gi, worst].set(best_vs[gi, top])
        energy = jsg.total_w[:, None] - 2.0 * cuts
        value = energy - jnp.mean(energy, axis=1, keepdims=True)
        grad0 = jax.grad(loss_fn)(logits, mh, value)
        opt_state = optimizer.init(logits)
        for _ in range(cfg.sample_epoch_num):
            updates, opt_state = optimizer.update(jax.grad(loss_fn)(logits, mh, value), opt_state, logits)
            logits = optax.apply_updates(logits, updates)
        draws = (*mh_draws(k_mh, 5 * cfg.change_times, b), sweep_draws(k_ls, cfg.num_ls, b))
        return mh, ls, cuts, best_xs, best_vs, jnp.tile(chain_xs, (1, R, 1)), grad0, logits, opt_state, draws

    out = jax.tree.map(np.array, jax_round(jnp.asarray(logits), jnp.asarray(start), jnp.asarray(best_xs)))
    mh, ls, cuts, j_xs, j_vs, restart, grad0, j_logits, j_opt, draws = out
    t_draws = tb.BatchDraws(*(torch.from_numpy(a) for a in draws))
    t_start_vs = tb.cut_values_stacked(torch.from_numpy(best_xs), tsg)

    t_logits, t_opt = tb.new_logits(G, N, cfg, "cpu")
    with torch.no_grad():
        t_logits.copy_(torch.from_numpy(logits))
    t_mh, t_ls, t_cuts = tb.sample_round(None, t_logits, torch.from_numpy(start), tsg, cfg, t_draws)
    t_xs, t_vs, t_restart = tb.reduce_round(t_ls, t_cuts, torch.from_numpy(best_xs), t_start_vs, R)
    for got, expect in ((t_mh, mh), (t_ls, ls), (t_cuts, cuts), (t_xs, j_xs), (t_vs, j_vs), (t_restart, restart)):
        np.testing.assert_array_equal(got.numpy(), expect)

    tb.update_round(t_logits, t_opt, t_mh, t_cuts, tsg, 1)  # the first step's gradient
    np.testing.assert_allclose(t_logits.grad.numpy(), grad0, rtol=1e-4, atol=1e-6)
    t_logits, t_opt = tb.new_logits(G, N, cfg, "cpu")
    with torch.no_grad():
        t_logits.copy_(torch.from_numpy(logits))
    tb.update_round(t_logits, t_opt, t_mh, t_cuts, tsg, cfg.sample_epoch_num)
    sure = np.abs(grad0) >= 1e-5  # elsewhere Adam's first step is f32 noise
    assert sure.mean() > 0.5
    np.testing.assert_allclose(t_logits.detach().numpy()[sure], j_logits[sure], rtol=1e-5, atol=1e-6)
    adam = convert.adam_state(j_opt)
    assert t_opt.count == adam["count"] == cfg.sample_epoch_num
    np.testing.assert_allclose(t_opt.mu[0].numpy()[sure], adam["mu"][0].numpy()[sure], rtol=1e-4, atol=1e-7)


def test_short_solve_matches_jax_per_graph_best(graphs):
    jgs, tgs, _, _ = graphs
    kw = dict(total_mcmc_num=32, repeat_times=4, num_ls=2, max_epoch_num=2, reset_epoch_num=8,
              sample_epoch_num=4, warmup_ls_rounds=1)
    _, j_best, _ = jb.solve_maxcut_mcpg_batched(jgs, JConfig(**kw))
    x, v, history = tb.solve_maxcut_mcpg_batched(tgs, MCPGConfig(**kw), device="cpu")
    np.testing.assert_array_equal(v, j_best)
    for g in range(G):
        assert v[g] == obj_maxcut(x[g], tgs[g])
    assert len(history) == 2 and (history[1]["best"] >= history[0]["best"]).all()
