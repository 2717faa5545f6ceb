"""Jumanji PPO (`algos/jumanji_ppo.py`) against the JAX package's: the
actor-critic forward (rtol 1e-5), GAE against the reversed recursion, one
training iteration (rollout, GAE, PPO update) with JAX's draws injected
(best cuts equal, the loss and the updated params at rtol 1e-4 where the
gradient is at least 1e-5, since Adam's first step sees signs), the A2C
update over two minibatches, and the greedy evaluator from JAX's reset
spins (the same cut)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import jumanji_ppo as jj
from rlsolver_tpu.config import GraphType as JGraphType
from rlsolver_tpu.core.generate import generate_graph as j_generate_graph
from rlsolver_tpu.envs import spin_system as jss
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import jumanji_ppo as tj
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.generate import generate_graph
from rlsolver_tpu_torch.envs import spin_system as tss

torch.set_num_threads(1)
N, B, T = 20, 8, 6
ENV_KW = dict(num_envs=B, max_steps=T, basin_reward=1 / N, stag_punishment=0.01)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def setup(cfg_kw):
    jg, tg = j_generate_graph(JGraphType.BA, N, seed=4), generate_graph(GraphType.BA, N, seed=4)
    jenv, tenv = jss.SpinSystemEnv(N, jss.SpinSystemConfig(**ENV_KW)), tss.SpinSystemEnv(N, tss.SpinSystemConfig(
        **ENV_KW))
    kw = {**dict(num_iters=1, features=8, n_layers=1), **cfg_kw}
    return jg, tg, jenv, tenv, jj.SpinPPOConfig(**kw), tj.SpinPPOConfig(**kw)


def jax_iteration_draws(jenv, jg, cfg):
    """The initial params and the first iteration's draws, split from the
    key as `train_spin_ppo` splits it."""
    pe = jenv.params_from_graph(jg)
    key = jax.random.PRNGKey(cfg.seed)
    key, k_init = jax.random.split(key)
    net = jj.MPNNActorCritic(features=cfg.features, n_layers=cfg.n_layers)
    params = net.init(k_init, jnp.zeros((B, N, jenv.config.num_observables)), pe.adj)
    _, k = jax.random.split(key)
    k_roll, k_up = jax.random.split(k)
    key_r, k_reset = jax.random.split(k_roll)
    spins = jnp.where(jax.random.bernoulli(k_reset, 0.5, (B, N)), 1.0, -1.0)
    gumbel = jnp.stack([jax.random.gumbel(ks, (B, N)) for ks in jax.random.split(key_r, T)])
    epochs = cfg.update_epochs if cfg.algo == "ppo" else 1
    perms = jnp.stack([jax.random.permutation(ke, T * B) for ke in jax.random.split(k_up, epochs)])
    draws = tj.PPODraws(*(torch.from_numpy(np.array(x)) for x in (spins, gumbel, perms)))
    return net, params, draws


def test_actor_critic_forward_matches_flax():
    net = jj.MPNNActorCritic(features=8, n_layers=2)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((B, N, 7)).astype(np.float32)
    adj = np.asarray(jss.SpinSystemEnv(N, jss.SpinSystemConfig(num_envs=B)).params_from_graph(
        j_generate_graph(JGraphType.BA, N, seed=4)).adj)
    params = net.init(jax.random.PRNGKey(1), obs, adj)
    tnet = tj.MPNNActorCritic(7, 8, 2, device="cpu")
    tnet.load_state_dict(convert.flax_state_dict(to_np(params)))
    logits, value = (x.detach().numpy() for x in tnet(torch.from_numpy(obs), torch.from_numpy(np.array(adj))))
    j_logits, j_value = net.apply(params, obs, adj)
    np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(value, np.asarray(j_value), rtol=1e-5, atol=1e-6)


def test_gae_is_the_reversed_recursion():
    rng = np.random.default_rng(2)
    r, v = rng.standard_normal((T, B)).astype(np.float32), rng.standard_normal((T, B)).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    advs = tj.gae(torch.from_numpy(r), torch.from_numpy(v), torch.from_numpy(last), 0.99, 0.95).numpy()
    expect, adv = np.zeros_like(r), np.zeros(B, np.float32)
    for t in reversed(range(T)):
        next_v = v[t + 1] if t + 1 < T else np.zeros(B, np.float32)  # no bootstrap past the horizon
        adv = r[t] + np.float32(0.99) * next_v - v[t] + np.float32(0.99 * 0.95) * adv
        expect[t] = adv
    np.testing.assert_allclose(advs, expect, rtol=1e-6, atol=1e-6)


def port_gradients(tenv, tg, tcfg, params, draws):
    """The gradient of the first minibatch step, as the port computes it."""
    net = tj.MPNNActorCritic(tenv.config.num_observables, tcfg.features, tcfg.n_layers, device="cpu")
    net.load_state_dict(params)
    pe = tenv.params_from_graph(tg, device="cpu")
    batch, last_value, _ = tj.spin_rollout(net, tenv, pe, draws=draws)
    advs = tj.gae(batch.rewards, batch.values, last_value, tcfg.gamma, tcfg.gae_lambda)
    idx = draws.perms[0]
    tb = T * B
    flat = dict(obs=batch.obs.reshape(tb, N, -1), mask=batch.mask.reshape(tb, N), actions=batch.actions.reshape(tb),
                old_logp=batch.logprobs.reshape(tb), advs=advs.reshape(tb), returns=(advs + batch.values).reshape(tb))
    tj.ppo_loss(net, pe.adj, cfg=tcfg, **{k: v[idx] for k, v in flat.items()}).backward()
    return {k: p.grad.numpy() for k, p in net.named_parameters()}


def test_one_ppo_iteration_matches_jax():
    jg, tg, jenv, tenv, jcfg, tcfg = setup(dict(update_epochs=1))
    _, j_params0, draws = jax_iteration_draws(jenv, jg, jcfg)
    j_params, j_hist = jj.train_spin_ppo(jenv, jg, jcfg)
    params0 = convert.flax_state_dict(to_np(j_params0))
    t_params, t_hist = tj.train_spin_ppo(tenv, tg, tcfg, device="cpu", params=params0, draws=[draws])
    assert t_hist["best_cut"] == j_hist["best_cut"]
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-4)
    grads = port_gradients(tenv, tg, tcfg, params0, draws)
    j_sd = convert.flax_state_dict(to_np(j_params))
    moved = 0
    for k, g in grads.items():
        keep = np.abs(g) >= 1e-5
        moved += int(keep.sum())
        np.testing.assert_allclose(t_params[k].numpy()[keep], j_sd[k].numpy()[keep], rtol=1e-4, atol=1e-7, err_msg=k)
    assert moved > 100


def test_a2c_minibatches_match_jax():
    jg, tg, jenv, tenv, jcfg, tcfg = setup(dict(algo="a2c", num_minibatches=2))
    _, j_params0, draws = jax_iteration_draws(jenv, jg, jcfg)
    _, j_hist = jj.train_spin_ppo(jenv, jg, jcfg)
    _, t_hist = tj.train_spin_ppo(tenv, tg, tcfg, device="cpu", params=convert.flax_state_dict(to_np(j_params0)),
                                  draws=[draws])
    assert t_hist["best_cut"] == j_hist["best_cut"]
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-4)


def test_greedy_evaluator_matches_jax():
    jg, tg, jenv, tenv, jcfg, tcfg = setup(dict())
    net, params, _ = jax_iteration_draws(jenv, jg, jcfg)
    key = jax.random.PRNGKey(5)
    j_cut = jj.make_greedy_evaluator(jenv, net)(params, jg, key)
    spins = np.array(jnp.where(jax.random.bernoulli(key, 0.5, (B, N)), 1.0, -1.0))
    tnet = tj.MPNNActorCritic(7, tcfg.features, tcfg.n_layers, device="cpu")
    t_cut = tj.make_greedy_evaluator(tenv, tnet)(convert.flax_state_dict(to_np(params)), tg, spins=spins)
    assert t_cut == j_cut


def test_train_and_evaluate_from_generators():
    """The generator paths: a short PPO run, its greedy evaluation and the
    random and epsilon-greedy policies give valid, reproducible cuts."""
    _, tg, _, tenv, _, tcfg = setup(dict(num_iters=2))
    params, hist = tj.train_spin_ppo(tenv, tg, tcfg, device="cpu")
    params2, _ = tj.train_spin_ppo(tenv, tg, tcfg, device="cpu")
    assert all(torch.equal(params[k], params2[k]) for k in params) and len(hist["loss"]) == 2
    net = tj.MPNNActorCritic(7, tcfg.features, tcfg.n_layers, device="cpu")
    greedy = tj.make_greedy_evaluator(tenv, net)(params, tg)
    rand = tj.evaluate_spin_policy(tenv, tg, device="cpu", seed=1)
    eps = tj.evaluate_spin_policy(tenv, tg, params, cfg=tcfg, epsilon=0.5, device="cpu", seed=1)
    assert 0 < min(greedy, rand, eps) and max(greedy, rand, eps) <= tg.num_edges
    assert rand == tj.evaluate_spin_policy(tenv, tg, device="cpu", seed=1)
    if not torch.cuda.is_available():  # entry points run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tj.train_spin_ppo(tenv, tg, tcfg)
