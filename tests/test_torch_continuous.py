"""DDPG, TD3, SAC and EmbedDQN (`algos/continuous.py`) against the JAX
package's: the replay ring (size, pointer, contents, rows sampled at JAX's
indices) exactly; `soft_update` within 1e-7; for each off-policy agent, 5
updates from JAX's converted `init()` with JAX's batches and draws
injected (SAC's target and actor normals, TD3's smoothing noise): both
losses within 1e-5 at every step, and the parameters, targets, `log_alpha`
and Adam moments within 1e-5 after the fifth, which covers TD3's delayed
actor steps; EmbedDQN's `q_all`, an exploring `act` and 3 updates the same
way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import continuous as jc
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import continuous as tc

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
B = 16


def to_np(tree):
    return jax.tree.map(np.array, tree)


def names(module):
    return [n for n, _ in module.named_parameters()]


def assert_module(module, tree, **tol):
    sd = convert.flax_state_dict(to_np(tree))
    assert set(sd) == set(dict(module.named_parameters()))
    for k, v in module.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), sd[k].numpy(), err_msg=k, **(tol or TOL))


def assert_adam(opt, jopt, module=None):
    state = convert.adam_state(to_np(jopt), names(module) if module is not None else None)
    assert opt.count == state["count"]
    for a, b in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def load_module(module, tree):
    module.load_state_dict(convert.flax_state_dict(to_np(tree)))


def random_batch(rng, obs_dim, act_dim, discrete=None):
    obs = rng.standard_normal((B, obs_dim)).astype(np.float32)
    if discrete:
        act = rng.integers(0, discrete, (B, 1)).astype(np.float32)
    else:
        act = rng.uniform(-1, 1, (B, act_dim)).astype(np.float32)
    rew = rng.standard_normal(B).astype(np.float32)
    nxt = rng.standard_normal((B, obs_dim)).astype(np.float32)
    done = (rng.random(B) < 0.2).astype(np.float32)
    return jc.Transition(*map(jnp.asarray, (obs, act, rew, nxt, done))), tc.Transition(
        *map(torch.from_numpy, (obs, act, rew, nxt, done)))


def test_replay_ring_and_samples():
    jbuf, tbuf = jc.Replay.create(4, 3, 2), tc.Replay.create(4, 3, 2, device="cpu")
    for i in range(6):
        item = (np.full(3, float(i), np.float32), np.full(2, -float(i), np.float32), np.float32(i),
                np.full(3, 0.5 * i, np.float32), np.float32(i % 2))
        jbuf = jc.replay_add(jbuf, jc.Transition(*map(jnp.asarray, item)))
        tbuf = tc.replay_add(tbuf, tc.Transition(*(torch.as_tensor(x) for x in item)))
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size)) == (2, 4)
    for a, b in zip(tbuf.data, jbuf.data):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    key = jax.random.PRNGKey(3)
    jb = jc.replay_sample(jbuf, key, 8)
    idx = np.array(jax.random.randint(key, (8,), 0, jnp.maximum(jbuf.size, 1)))
    for a, b in zip(tc.replay_sample(tbuf, 8, idx=torch.from_numpy(idx)), jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a batch of K rows equals K single adds, across the wrap and past the capacity
    for k in (3, 6):
        single, batched = tc.Replay.create(4, 3, 2, device="cpu"), tc.Replay.create(4, 3, 2, device="cpu")
        single, batched = tc.replay_add(single, tc.Transition(*(x[0] for x in tbuf.data))), \
            tc.replay_add(batched, tc.Transition(*(x[0] for x in tbuf.data)))
        rows = tc.Transition(*(torch.arange(k, dtype=torch.float32).reshape((k,) + (1,) * (x.dim() - 1))
                               .expand((k,) + tuple(x.shape[1:])).clone() for x in tbuf.data))
        for i in range(k):
            single = tc.replay_add(single, tc.Transition(*(x[i] for x in rows)))
        batched = tc.replay_add(batched, rows)
        assert (single.ptr, single.size) == (batched.ptr, batched.size)
        for a, b in zip(single.data, batched.data):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_soft_update_matches_jax():
    rng = np.random.default_rng(0)
    t, o = rng.standard_normal(5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    j = jc.soft_update({"w": jnp.asarray(t)}, {"w": jnp.asarray(o)}, 0.1)
    out = tc.soft_update({"w": torch.from_numpy(t)}, {"w": torch.from_numpy(o)}, 0.1)
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(j["w"]), rtol=1e-7, atol=1e-7)
    m, m2 = tc.MLP(3, 2, hidden=4), tc.MLP(3, 2, hidden=4, gen=torch.Generator().manual_seed(5))
    before = [p.detach().clone() for p in m.parameters()]
    tc.soft_update(m, m2, 0.25)
    for b, p, q in zip(before, m.parameters(), m2.parameters()):
        torch.testing.assert_close(p.detach(), b * 0.75 + q.detach() * 0.25)


def port_state(jagent, jstate, tagent):
    ts = tagent.init()
    for mod, tree in ((ts.actor, jstate.actor), (ts.actor_target, jstate.actor_target),
                      (ts.critic, jstate.critic), (ts.critic_target, jstate.critic_target)):
        load_module(mod, tree)
    ts.actor_opt.load_state_dict(convert.adam_state(to_np(jstate.actor_opt), names(ts.actor)))
    ts.critic_opt.load_state_dict(convert.adam_state(to_np(jstate.critic_opt), names(ts.critic)))
    ts.alpha_opt.load_state_dict(convert.adam_state(to_np(jstate.alpha_opt)))
    with torch.no_grad():
        ts.log_alpha.copy_(torch.as_tensor(np.array(jstate.log_alpha)))
    return ts


@pytest.mark.parametrize("algo", ["ddpg", "td3", "sac"])
def test_off_policy_updates_match_jax(algo):
    cfg = tc.OffPolicyConfig(obs_dim=5, act_dim=2, lr=1e-3, batch=B, seed=1)
    jagent = jc.OffPolicyAgent(algo, jc.OffPolicyConfig(obs_dim=5, act_dim=2, lr=1e-3, batch=B, seed=1))
    tagent = tc.OffPolicyAgent(algo, cfg, device="cpu")
    jstate = jagent.init()
    ts = port_state(jagent, jstate, tagent)
    jupdate, tupdate = jagent.make_update(), tagent.make_update()
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(4)
    obs = rng.standard_normal((B, 5)).astype(np.float32)
    noise = np.array(jax.random.normal(key, (B, 2)))
    np.testing.assert_allclose(tagent.act(ts, torch.from_numpy(obs), noise=torch.from_numpy(noise)).numpy(),
                               np.asarray(jagent.act(jstate, jnp.asarray(obs), key)), **TOL)
    for step in range(5):
        jb, tb = random_batch(rng, 5, 2)
        key, k = jax.random.split(key)
        k_t, k_a = jax.random.split(k)
        draws = tc.OffPolicyDraws(torch.from_numpy(np.array(jax.random.normal(k_t, (B, 2)))),
                                  torch.from_numpy(np.array(jax.random.normal(k_a, (B, 2)))))
        jstate, jm = jupdate(jstate, jb, k)
        ts, tm = tupdate(ts, tb, draws)
        for name in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), err_msg=f"{name} at step {step}", **TOL)
    assert ts.step == int(jstate.step) == 5
    for mod, tree in ((ts.actor, jstate.actor), (ts.actor_target, jstate.actor_target),
                      (ts.critic, jstate.critic), (ts.critic_target, jstate.critic_target)):
        assert_module(mod, tree)
    assert_adam(ts.actor_opt, jstate.actor_opt, ts.actor)
    assert_adam(ts.critic_opt, jstate.critic_opt, ts.critic)
    np.testing.assert_allclose(float(ts.log_alpha.detach()), float(jstate.log_alpha), **TOL)
    assert_adam(ts.alpha_opt, jstate.alpha_opt)


def test_embed_dqn_matches_jax():
    cfg = dict(obs_dim=4, action_dim=5, lr=3e-3, batch=B, tau=0.05, seed=0)
    jagent, tagent = jc.EmbedDQNAgent(jc.EmbedDQNConfig(**cfg)), tc.EmbedDQNAgent(tc.EmbedDQNConfig(**cfg),
                                                                                  device="cpu")
    jstate = jagent.init()
    ts = tagent.init()
    load_module(ts.params, jstate.params)
    load_module(ts.target, jstate.target)
    ts.opt_state.load_state_dict(convert.adam_state(to_np(jstate.opt_state), names(ts.params)))
    rng = np.random.default_rng(5)
    obs = rng.random((B, 4)).astype(np.float32)
    np.testing.assert_allclose(tagent.q_all(ts.params, torch.from_numpy(obs)).detach().numpy(),
                               np.asarray(jagent.q_all(jstate.params, jnp.asarray(obs))), **TOL)
    for seed in range(4):  # the whole batch explores or none does
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        draws = tc.EmbedDraws(torch.from_numpy(np.array(jax.random.randint(k1, (B,), 0, 5))),
                              torch.as_tensor(np.array(jax.random.uniform(k2, ()))))
        np.testing.assert_array_equal(tagent.act(ts, torch.from_numpy(obs), draws=draws).numpy(),
                                      np.asarray(jagent.act(jstate, jnp.asarray(obs), key)))
    jupdate, tupdate = jagent.make_update(), tagent.make_update()
    for step in range(3):
        jb, tb = random_batch(rng, 4, 1, discrete=5)
        jstate, jl = jupdate(jstate, jb)
        ts, tl = tupdate(ts, tb)
        np.testing.assert_allclose(float(tl), float(jl), err_msg=f"step {step}", **TOL)
    assert_module(ts.params, jstate.params)
    assert_module(ts.target, jstate.target)
    assert_adam(ts.opt_state, jstate.opt_state, ts.params)


ENTRY_POINTS = {
    "OffPolicyAgent": lambda dev: tc.OffPolicyAgent("td3", device=dev).init().actor.Dense_0.kernel,
    "EmbedDQNAgent": lambda dev: tc.EmbedDQNAgent(device=dev).init().params.Dense_0.kernel,
    "Replay": lambda dev: tc.Replay.create(4, 3, 2, device=dev).data.obs,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
