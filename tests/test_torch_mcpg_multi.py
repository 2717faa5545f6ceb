"""The generic MCPG solver (`algos/mcpg_multi.py`) against the JAX
package's: one round of every adapter with JAX's draws and starting logits
injected (MH samples, local search, scores and incumbents bit for bit; the
gradient at rtol 1e-4 and the logits after the Adam step at rtol 1e-5, since
a first Adam step sees only the gradient's sign), whole solves on the CPU
with both samplers (the fused one is K3's plain version) against brute-force
optima, and one round of MCPG's colored sweep mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import mcpg as jm
from rlsolver_tpu.algos import mcpg_multi as jmm
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.models.policy import BernoulliPolicy as JPolicy
from rlsolver_tpu.ops import sweeps as jsw
from rlsolver_tpu.ops.pallas import mh_sampler as jmh
from rlsolver_tpu.ops.reductions import pick_xs_by_vs, update_xs_by_vs
from rlsolver_tpu.ops.sampling import bernoulli_logp, metropolis_bitflip_scan
from rlsolver_tpu.problems import cheeger as jc, maxsat as jms, mimo as jmi, qubo as jq, subset_sum as jss
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import mcpg as tm
from rlsolver_tpu_torch.algos import mcpg_multi as tmm
from rlsolver_tpu_torch.algos.mcpg_multi import RoundDraws
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.ops import sweeps as tsw
from rlsolver_tpu_torch.ops.kernels import mh_sampler as tmh
from rlsolver_tpu_torch.problems import cheeger as tc, maxsat as tms, mimo as tmi, qubo as tq, subset_sum as tss
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
C, R = 8, 4


def sat_clauses(n=10, m=40, seed=0):
    rng = np.random.RandomState(seed)
    clauses = []
    for _ in range(m):
        k = rng.randint(2, 4)
        vs = rng.choice(n, size=k, replace=False) + 1
        clauses.append(list(vs * rng.choice([-1, 1], size=k)))
    return clauses


def quantized_mimo(k=4, seed=9):
    rng = np.random.RandomState(seed)
    h = np.round(rng.randn(2 * k, 2 * k) * 16) / 64
    x = rng.choice([-1.0, 1.0], size=2 * k)
    return h, h @ x + np.round(rng.randn(2 * k) * 8) / 64, x


def adapters():
    """name -> (JAX problem, port problem, the port's noise from JAX's
    k_ls for a batch of b chains, or None)."""
    g_name = "BA_24_ID1"
    jg, tg = j_graph_from_name(g_name), graph_from_name(g_name)
    q = jq.maxcut_to_qubo(jg.adjacency_dense())
    q_int = np.random.default_rng(3).integers(-4, 5, size=(20, 20)).astype(np.float64)
    clauses = sat_clauses()
    h, y, x = quantized_mimo()
    amounts = np.random.RandomState(2).randint(-60, 60, 20)
    tags = np.arange(20) % 3

    def edge_noise(k, b):
        return jax.vmap(lambda kk: jax.random.uniform(kk, (4, b)))(jax.random.split(k, jg.num_edges))

    def sat_noise(k, b):
        return jax.vmap(lambda kk: jax.random.uniform(kk, (b,), minval=-0.5, maxval=0.5))(jax.random.split(k, 2 * 10))

    jsat = jms.MaxSatEnv(jms.MaxSatInstance.from_clauses(10, clauses))
    tsat = tms.MaxSatEnv(tms.MaxSatInstance.from_clauses(10, clauses), "cpu")
    return {
        "maxcut_edge": (jmm.maxcut_edge_problem(jg), tmm.maxcut_edge_problem(tg, device="cpu"), edge_noise),
        "maxsat": (jmm.maxsat_problem(jsat), tmm.maxsat_problem(tsat), sat_noise),
        "qubo": (jmm.qubo_problem(jq.QuboEnv(q)), tmm.qubo_problem(tq.QuboEnv(q, "cpu")), None),
        "qubo_bin": (jmm.qubo_problem(jq.QuboEnv(q_int), binary=True),
                     tmm.qubo_problem(tq.QuboEnv(q_int, "cpu"), binary=True), None),
        "cheeger": (jmm.cheeger_problem(jc.CheegerEnv(jg)),
                    tmm.cheeger_problem(tc.CheegerEnv(tg, device="cpu")), None),
        "ncheeger": (jmm.cheeger_problem(jc.CheegerEnv(jg, normalized=True)),
                     tmm.cheeger_problem(tc.CheegerEnv(tg, normalized=True, device="cpu")), None),
        "mimo": (jmm.mimo_problem(jmi.MimoEnv(jmi.MimoInstance(h, y, x, 10.0, 0.5))),
                 tmm.mimo_problem(tmi.MimoEnv(tmi.MimoInstance(h, y, x, 10.0, 0.5), "cpu")), None),
        "subset_sum": (jss.subset_sum_problem(jss.SubsetSumEnv(amounts, tags=tags)),
                       tss.subset_sum_problem(tss.SubsetSumEnv(amounts, tags=tags, device="cpu")), None),
    }


ADAPTERS = adapters()


@pytest.mark.parametrize("name", sorted(ADAPTERS))
def test_one_round_matches_jax(name):
    jp, tp, noise_of = ADAPTERS[name]
    n, b = jp.num_vars, C * R
    cfg = tmm.MultiMCPGConfig(num_chains=C, repeat_times=R)
    rounds = tmm.mh_rounds(tp, cfg)
    rng = np.random.default_rng(len(name))
    logits = rng.normal(0.0, 0.7, n).astype(np.float32)
    chains = rng.random((C, n)) < 0.5
    best_bits = rng.random((C, n)) < 0.5

    # JAX: the body of `mcpg_multi.solve_mcpg`'s round, from its pieces, and
    # the round's draws, in one jitted call (one compile)
    policy, opt = JPolicy(n), optax.adam(cfg.lr)
    _, k_mh, k_ls = jax.random.split(jax.random.PRNGKey(len(name)), 3)

    @jax.jit
    def jax_round(params, chains, best_bits):
        if jp.init_bits is not None:
            chains = jp.init_bits(None, C)
        best_vs = jp.score(best_bits)
        mh = metropolis_bitflip_scan(k_mh, policy.apply(params), jnp.tile(chains, (R, 1)), rounds)
        improved = jp.improve(k_ls, mh)
        scores = jp.score(improved)
        best = update_xs_by_vs(best_bits, best_vs, *pick_xs_by_vs(improved, scores, R))
        adv = scores - scores.mean()
        grads = jax.grad(lambda p: -jnp.mean(bernoulli_logp(policy.apply(p), mh) * adv))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        nodes, u = jax.vmap(lambda k: (lambda a, c: (jax.random.randint(a, (b,), 0, n), jax.random.uniform(c, (b,))))(
            *jax.random.split(k)))(jax.random.split(k_mh, rounds))
        noise = None if noise_of is None else noise_of(k_ls, b)
        return (chains, best_vs, mh, scores, best, grads, optax.apply_updates(params, updates),
                RoundDraws(nodes, u, noise))

    chains, best_vs, mh, scores, j_best, grads, params, jdraws = jax.tree.map(
        np.array, jax_round({"params": {"logits": jnp.asarray(logits)}}, jnp.asarray(chains), jnp.asarray(best_bits)))

    # the port, with the same draws
    draws = tmm.RoundDraws(*(None if a is None else torch.from_numpy(a) for a in jdraws))
    t_policy, t_opt = tmm.new_policy(n, cfg, "cpu")
    t_policy.load_state_dict(convert.policy_state_dict({"params": {"logits": logits}}))
    t_bits, t_vs, t_mh, t_scores = tmm.round_step(tp, cfg, t_policy, t_opt, None, torch.from_numpy(chains),
                                                  torch.from_numpy(best_bits), torch.from_numpy(best_vs), draws)
    np.testing.assert_array_equal(t_mh.numpy(), np.asarray(mh))
    np.testing.assert_array_equal(t_scores.numpy(), np.asarray(scores))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(j_best[0]))
    np.testing.assert_array_equal(t_vs.numpy(), np.asarray(j_best[1]))
    j_grad = np.asarray(grads["params"]["logits"])
    np.testing.assert_allclose(t_policy.logits.grad.numpy(), j_grad, rtol=1e-4, atol=1e-6)
    # Adam's first step moves each logit by lr * g / (|g| + 1e-8): where the
    # gradient is f32 rounding noise around 0 that is noise too, so the
    # logits are held where |g| >= 1e-5 and elsewhere moved at most lr
    t_new, j_new = t_policy.logits.detach().numpy(), np.asarray(params["params"]["logits"])
    sure = np.abs(j_grad) >= 1e-5
    assert sure.mean() > 0.5
    np.testing.assert_allclose(t_new[sure], j_new[sure], rtol=1e-5, atol=1e-6)
    assert (np.abs(t_new - logits) <= cfg.lr * (1 + 1e-5)).all()


def brute_maxsat(env):
    bits = (np.arange(2**env.num_vars)[:, None] >> np.arange(env.num_vars)) & 1
    return float(env.obj(torch.from_numpy(bits.astype(bool))).max())


@pytest.mark.parametrize("sampler", ["scan", "fused"])
def test_solves_reach_brute_force_optima(sampler):
    env = tms.MaxSatEnv(tms.MaxSatInstance.from_clauses(10, sat_clauses()), "cpu")
    res = tmm.solve_mcpg(tmm.maxsat_problem(env),
                         tmm.MultiMCPGConfig(num_chains=16, repeat_times=4, num_rounds=12, sampler=sampler), "cpu")
    assert res.best_score == brute_maxsat(env)
    assert res.best_score == float(env.obj(torch.from_numpy(res.best_bits[None]))[0])

    inst = tmi.generate_mimo(k=3, snr_db=15.0, seed=8)
    menv = tmi.MimoEnv(inst, "cpu")
    ml = tmi.detect_ml_brute(inst)
    ml_e = float(menv.obj(torch.from_numpy(ml[None].astype(np.float32)))[0])
    res = tmm.solve_mcpg(tmm.mimo_problem(menv),
                         tmm.MultiMCPGConfig(num_chains=16, repeat_times=4, num_rounds=8, sampler=sampler), "cpu")
    np.testing.assert_array_equal(np.where(res.best_bits, 1.0, -1.0), ml)
    assert -res.best_score <= ml_e + 1e-4
    assert len(res.history) == 8 and res.history == sorted(res.history)


@pytest.mark.parametrize("sampler", ["scan", "fused"])
def test_solves_on_graph_problems(sampler):
    g = graph_from_name("BA_24_ID1")
    cfg = tmm.MultiMCPGConfig(num_chains=16, repeat_times=2, num_rounds=8, sampler=sampler)
    res = tmm.solve_mcpg(tmm.maxcut_edge_problem(g, device="cpu"), cfg, "cpu")
    assert res.best_score > 0.5 * g.total_weight
    assert res.best_score == obj_maxcut(res.best_bits.astype(np.int64), g)
    env = tc.CheegerEnv(g, device="cpu")
    res = tmm.solve_mcpg(tmm.cheeger_problem(env), dataclasses.replace(cfg, num_chains=8), "cpu")
    assert np.isfinite(res.best_score) and 0 < res.best_bits.sum() < g.num_nodes
    with pytest.raises(ValueError, match="sampler"):
        tmm.solve_mcpg(tmm.cheeger_problem(env), dataclasses.replace(cfg, sampler="budgeted"), "cpu")


def test_colored_round_matches_jax():
    name, Cc, Rc, S, rounds = "BA_100_ID0", 8, 4, 2, 20
    jg, tg = j_graph_from_name(name), graph_from_name(name)
    n, b = jg.num_nodes, Cc * Rc
    cfg_j = jm.MCPGConfig(total_mcmc_num=Cc, repeat_times=Rc, num_ls=S, sweep_mode="colored")
    jenv, jdata = JEnv(jg, dtype=jnp.float32), jsw.SweepData.build(jg)
    policy, optimizer, _, j_reduce, j_update = jm._build_steps(jenv, jdata, cfg_j)
    tenv = MaxcutEnv(tg, "cpu")
    tdata = tsw.SweepData.build(tg, "cpu")
    t_steps = tm._build_steps(tenv, tdata, tm.MCPGConfig(**{f.name: getattr(cfg_j, f.name)
                                                            for f in dataclasses.fields(cfg_j)}))
    rng = np.random.default_rng(1)
    params = {"params": {"logits": jnp.asarray(rng.normal(0, 0.5, n).astype(np.float32))}}
    opt_state = optimizer.init(params)
    t_policy, t_opt = tm.new_policy(n, tm.MCPGConfig(), "cpu")
    t_policy.load_state_dict(convert.policy_state_dict(jax.tree.map(np.asarray, params)))

    key, k_ls = jax.random.split(jax.random.PRNGKey(2))
    start = rng.random((b, n)) < 0.5
    best_xs = rng.random((Cc, n)) < 0.5
    num_colors = tdata.color_masks.shape[0]

    @jax.jit
    def jax_round(params, opt_state, start, best_xs):
        probs = policy.apply(params)
        j_mh = jmh.mh_reference_stream(key, probs, start, rounds)
        j_ls = jsw.colored_sweep(k_ls, j_mh.astype(jnp.float32), jnp.asarray(jg.adjacency_dense()),
                                 jnp.asarray(jg.weighted_degrees()), jdata.color_masks, num_sweeps=S) > 0.5
        j_cuts = jenv.obj(j_ls)
        j_best = j_reduce(j_ls, j_cuts, best_xs, jenv.obj(best_xs))
        stream = jmh.make_proposal_stream(key, rounds, b, probs)
        noise = jax.vmap(lambda k: jax.vmap(lambda kc: jax.random.uniform(kc, (b, n)))(
            jax.random.split(k, num_colors)))(jax.random.split(k_ls, S))
        return j_mh, j_ls, j_cuts, j_best, j_update(params, opt_state, j_mh, j_cuts)[0], stream, noise

    j_mh, j_ls, j_cuts, j_best, params, stream, noise = jax.tree.map(
        np.array, jax_round(params, opt_state, jnp.asarray(start), jnp.asarray(best_xs)))
    best_vs = np.array(jenv.obj(jnp.asarray(best_xs)))
    t_mh = tmh.mh_sample_stream(torch.from_numpy(stream), torch.from_numpy(start))
    t_ls = tsw.colored_sweep(None, t_mh.float(), tenv.cg.adj, tenv.cg.deg_w, tdata.color_masks, S,
                             noise=torch.from_numpy(noise)) > 0.5
    t_cuts = tenv.obj(t_ls)
    t_best = t_steps.reduce_step(t_ls, t_cuts, torch.from_numpy(best_xs.copy()), torch.from_numpy(best_vs.copy()))
    t_steps.update_step(t_policy, t_opt, t_mh, t_cuts)
    np.testing.assert_array_equal(t_mh.numpy(), np.asarray(j_mh))
    np.testing.assert_array_equal(t_ls.numpy(), np.asarray(j_ls))
    np.testing.assert_array_equal(t_cuts.numpy(), np.asarray(j_cuts))
    for a, c in zip(t_best, j_best):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    np.testing.assert_allclose(t_policy.logits.detach().numpy(), params["params"]["logits"], rtol=1e-6, atol=1e-7)

    # the whole colored solve on the CPU: its best cut is the host's
    cfg = tm.MCPGConfig(total_mcmc_num=8, repeat_times=4, num_ls=2, max_epoch_num=1, reset_epoch_num=16,
                        warmup_ls_rounds=1, sweep_mode="colored", seed=3)
    x, v, ev = tm.solve_maxcut_mcpg(tg, cfg, device="cpu")
    assert v == obj_maxcut(x.astype(np.int64), tg) and v >= 250 and len(ev.records) == 3
