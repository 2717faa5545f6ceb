"""Flip-MDP PPO and A2C (`envs/flip_mdp.py`, `algos/ppo.py`), the S2V
constructive policy (`models/s2v_policy.py`) and PER (`train/replay.py`)
against the JAX package's: the flip-MDP reset and steps equal; `gae` within
1e-6; `ClippedAdam`'s linear schedule against optax's clip_by_global_norm
and adam(linear_schedule) for 5 updates within 1e-6; one PPO iteration from
JAX's converted params with its Gumbel draws and permutations injected
(params and metrics within 1e-5); A2C; the `start_str` warm start; the S2V
logits within 1e-5 and its rollouts' cuts equal; PER's indices and weights
equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import ppo as jppo
from rlsolver_tpu.config import GraphType as JGraphType
from rlsolver_tpu.core.generate import generate_graph as j_generate_graph
from rlsolver_tpu.envs import flip_mdp as jfm
from rlsolver_tpu.models import s2v_policy as js2v
from rlsolver_tpu.train import replay as jrep
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import ppo as tppo
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.encode import SolutionCodec
from rlsolver_tpu_torch.core.generate import generate_graph
from rlsolver_tpu_torch.envs import flip_mdp as tfm
from rlsolver_tpu_torch.models import s2v_policy as ts2v
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.problems.objectives import obj_maxcut
from rlsolver_tpu_torch.train import replay as trep

torch.set_num_threads(1)
N, B, T = 16, 8, 6


def graphs():
    return j_generate_graph(JGraphType.BA, N, seed=3), generate_graph(GraphType.BA, N, seed=3)


def to_np(tree):
    return jax.tree.map(np.array, tree)


def test_flip_mdp_reset_and_steps_equal():
    jg, tg = graphs()
    jenv, tenv = jfm.FlipMdpEnv(jg, horizon=3), tfm.FlipMdpEnv(tg, horizon=3, device="cpu")
    k = jax.random.PRNGKey(0)
    js, jobs = jenv.reset(k, B)
    xs = np.array(jax.random.bernoulli(k, 0.5, (B, N)))
    ts, tobs = tenv.reset(None, B, xs=torch.from_numpy(xs))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(ts.cut.numpy(), np.asarray(js.cut))
    assert not ts.xs[:, 0].any()
    rng = np.random.default_rng(1)
    for step in range(5):
        a = rng.integers(0, N, B)
        js, jobs, jr, jd = jenv.step(js, jnp.asarray(a))
        ts, tobs, tr, td = tenv.step(ts, torch.from_numpy(a))
        for x, y in ((tobs, jobs), (tr, jr), (td, jd), (ts.cut, js.cut)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert ts.t == int(js.t)
    host = np.array([obj_maxcut(x.astype(np.int64), tg) for x in ts.xs.numpy()])
    np.testing.assert_array_equal(ts.cut.numpy(), host)
    start = rng.random(N) < 0.5
    ts, _ = tenv.reset(None, B, start_bits=start)
    js, _ = jenv.reset(k, B, start_bits=jnp.asarray(start))
    np.testing.assert_array_equal(ts.xs.numpy(), np.asarray(js.xs))


def test_gae_matches_jax():
    rng = np.random.default_rng(2)
    r, v = rng.standard_normal((T, B)).astype(np.float32), rng.standard_normal((T, B)).astype(np.float32)
    d = (rng.random((T, B)) < 0.3).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    j = np.asarray(jax.jit(jppo.gae, static_argnums=(4, 5))(r, v, d, last, 0.99, 0.95))
    t = tppo.gae(*(torch.from_numpy(x) for x in (r, v, d, last)), 0.99, 0.95).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_clipped_adam_linear_schedule_matches_optax():
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) * s for s in (0.1, 2.0, 0.3, 5.0, 0.01)]
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(optax.linear_schedule(2.5e-4, 0.0, 8), eps=1e-5))
    w, st = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = ClippedAdam([p], 2.5e-4, max_norm=0.5, eps=1e-5, schedule_steps=8)
    for g in grads:
        up, st = jax.jit(opt.update)(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, up)
        p.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)


def jax_setup(cfg):
    jg, tg = graphs()
    jenv, tenv = jfm.FlipMdpEnv(jg, horizon=cfg.horizon), tfm.FlipMdpEnv(tg, horizon=cfg.horizon, device="cpu")
    model = jppo.MLPActorCritic(N, hidden=16)
    optimizer, iteration = jppo.make_ppo_iteration(jenv, model, cfg)
    state = jppo.init_ppo_state(jenv, model, optimizer, cfg, cfg.num_envs)
    return jenv, tenv, model, jax.jit(iteration), state


def iteration_draws(key, cfg, n):
    """`make_ppo_iteration`'s Gumbel draws and permutations from the state's key."""
    _, k_roll, k_perm = jax.random.split(key, 3)
    gumbel = np.stack([np.array(jax.random.gumbel(k, (cfg.num_envs, n))) for k in jax.random.split(k_roll, cfg.horizon)])
    perms = np.stack([np.array(jax.random.permutation(k, cfg.horizon * cfg.num_envs))
                      for k in jax.random.split(k_perm, cfg.update_epochs)])
    return tppo.PPODraws(torch.from_numpy(gumbel), torch.from_numpy(perms))


def torch_state(tenv, cfg, jstate):
    model = tppo.MLPActorCritic(N, hidden=16)
    model.load_state_dict(convert.mlp_actor_critic_state_dict(to_np(jstate.params)))
    state = tppo.init_ppo_state(tenv, cfg, cfg.num_envs, model, xs=torch.from_numpy(np.array(jstate.env_state.xs)))
    np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jstate.obs))
    return state


def check_params(model, params, atol):
    ref = convert.mlp_actor_critic_state_dict(to_np(params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_one_iteration_matches_jax(algo):
    cfg = jppo.PPOConfig(num_envs=B, horizon=T, num_iterations=3, num_minibatches=2, update_epochs=2, seed=1)
    if algo == "a2c":
        cfg = dataclasses.replace(cfg, num_minibatches=1, update_epochs=1, clip_coef=10.0, clip_vloss=False)
    jenv, tenv, model, jit_iter, jstate = jax_setup(cfg)
    tcfg = tppo.PPOConfig(**dataclasses.asdict(cfg))
    assert tcfg == (tppo.a2c_config(tppo.PPOConfig(**{**dataclasses.asdict(cfg), "num_minibatches": 2}))
                    if algo == "a2c" else tcfg)
    tstate = torch_state(tenv, tcfg, jstate)
    titer = tppo.make_ppo_iteration(tenv, tcfg)
    for _ in range(2):
        draws = iteration_draws(jstate.key, cfg, N)
        jstate, jm = jit_iter(jstate)
        tstate, tm = titer(tstate, draws)
        np.testing.assert_array_equal(tstate.env_state.xs.numpy(), np.asarray(jstate.env_state.xs))
        for k in ("loss", "mean_cut", "best_cut", "mean_reward"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
        check_params(tstate.model, jstate.params, 1e-5)
    assert tstate.optimizer.count == 2 * cfg.update_epochs * cfg.num_minibatches


def test_train_a2c_and_the_warm_start():
    _, tg = graphs()
    start = np.random.default_rng(4).random(N) < 0.5
    start_str = SolutionCodec(N).bits_to_str(start)
    cfg = tppo.PPOConfig(num_envs=B, horizon=4, num_iterations=3, start_str=start_str)
    state, history = tppo.train_a2c(tg, cfg, device="cpu")
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    assert state.optimizer.count == 3
    # the warm start: every env starts from the decoded bits
    tenv = tfm.FlipMdpEnv(tg, horizon=4, device="cpu")
    st = tppo.init_ppo_state(tenv, cfg, B)
    assert (st.env_state.xs.numpy() == start[None]).all()
    assert float(st.env_state.cut[0]) == obj_maxcut(start.astype(np.int64), tg)
    _, hist = tppo.train_ppo(tg, dataclasses.replace(cfg, num_iterations=2, num_minibatches=2, update_epochs=2),
                             device="cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_s2v_logits_and_rollouts_match_jax():
    jgs = [j_generate_graph(JGraphType.BA, N, seed=s) for s in range(3)]
    adj = np.stack([np.asarray(g.adjacency_dense(), np.float32) for g in jgs])
    model = js2v.S2VConstructivePolicy(embed_dim=16, num_layers=2)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(adj))
    tmodel = ts2v.S2VConstructivePolicy(embed_dim=16, num_layers=2)
    tmodel.load_state_dict(convert.s2v_state_dict(to_np(params)))
    a = torch.from_numpy(adj)
    np.testing.assert_allclose(tmodel(a).detach().numpy(), np.asarray(model.apply(params, jnp.asarray(adj))),
                               rtol=0, atol=1e-5)
    assigned = np.random.default_rng(5).random((3, N)) < 0.4
    h = model.apply(params, jnp.asarray(adj), method=model.encode)
    jl = model.apply(params, h, jnp.asarray(assigned), jnp.asarray(adj), method=model.decode_logits)
    tl = tmodel.decode_logits(tmodel.encode(a), torch.from_numpy(assigned), a)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    key = jax.random.PRNGKey(7)
    for greedy in (True, False):
        jxs, jlogp, jr = js2v.rollout_s2v_maxcut(model, params, key, jnp.asarray(adj), greedy=greedy)
        gumbel = np.stack([np.array(jax.random.gumbel(k, (3, N))) for k in jax.random.split(key, N // 2)])
        with torch.no_grad():
            txs, tlogp, tr = ts2v.rollout_s2v_maxcut(tmodel, a, greedy=greedy, gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=0, atol=1e-4)
        host = [obj_maxcut(x.astype(np.int64), generate_graph(GraphType.BA, N, seed=s)) for s, x in
                enumerate(txs.numpy())]
        np.testing.assert_array_equal(tr.numpy(), host)


def test_per_matches_jax():
    example = (np.zeros(3, np.float32), np.float32(0))
    jbuf = jrep.PrioritizedReplay.create(tuple(jnp.asarray(x) for x in example), capacity=32)
    tbuf = trep.PrioritizedReplay.create(tuple(torch.from_numpy(np.asarray(x)) for x in example), capacity=32)
    for i in range(20):
        item = (np.full(3, float(i), np.float32), np.float32(i))
        jbuf = jrep.per_add(jbuf, tuple(jnp.asarray(x) for x in item))
        tbuf = trep.per_add(tbuf, tuple(torch.from_numpy(np.asarray(x)) for x in item))
    rng = np.random.default_rng(6)
    for r in range(3):
        key = jax.random.PRNGKey(r)
        (jd, jr), jidx, jw = jrep.per_sample(jbuf, key, 64, beta=0.4)
        gumbel = np.array(jax.random.gumbel(key, (64, 32)))
        (td, tr), tidx, tw = trep.per_sample(tbuf, None, 64, beta=0.4, gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        td_err = rng.standard_normal(64).astype(np.float32) * (r + 1)
        jbuf = jrep.per_update(jbuf, jidx, jnp.asarray(td_err))
        tbuf = trep.per_update(tbuf, tidx, torch.from_numpy(td_err))
        np.testing.assert_allclose(tbuf.priorities.numpy(), np.asarray(jbuf.priorities), rtol=1e-6, atol=0)
        assert float(tbuf.max_priority) == float(jbuf.max_priority)
    assert not (tidx.numpy() >= 20).any()  # empty slots are never drawn
