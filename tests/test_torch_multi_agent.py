"""VDN, QMIX, MAPPO and MADDPG (`algos/multi_agent.py`) against the JAX
package's: each 3 updates from JAX's converted parameters and Adam states,
with JAX's batches and draws injected (VDN/QMIX's exploring `act` draws
both its random actions and its coin flips from one key; MAPPO's
categorical draws as Gumbel noise), losses and parameters within 1e-5. The
VDN/QMIX batches carry rewards large enough that the global-norm clip at 5
acts on every update (checked on JAX's gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import multi_agent as jm
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import multi_agent as tm

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
B, N_AGENTS, OBS, ACTIONS = 16, 3, 4, 3


def to_np(tree):
    return jax.tree.map(np.array, tree)


def names(module):
    return [n for n, _ in module.named_parameters()]


def assert_params(module, sd):
    assert set(sd) == set(dict(module.named_parameters()))
    for k, v in module.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), sd[k].numpy(), err_msg=k, **TOL)


def assert_adam(opt, jopt, module, tree_fn=None):
    state = convert.adam_state(to_np(jopt), names(module), tree_fn=tree_fn)
    assert opt.count == state["count"]
    for a, b in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mixer", ["sum", "qmix"])
def test_value_mix_updates_match_jax(mixer):
    kw = dict(n_agents=N_AGENTS, obs_dim=OBS, state_dim=3 * N_AGENTS, num_actions=ACTIONS, lr=2e-3, seed=1)
    jagent, tagent = jm.ValueMixAgent(mixer, jm.MixConfig(**kw)), tm.ValueMixAgent(mixer, tm.MixConfig(**kw),
                                                                                    device="cpu")
    jst = jagent.init()
    ts = tagent.init()
    ts.params.load_state_dict(convert.value_mix_state_dict(to_np(jst.params)))
    ts.target.load_state_dict(convert.value_mix_state_dict(to_np(jst.target)))
    ts.opt_state.load_state_dict(convert.adam_state(to_np(jst.opt_state), names(ts.params),
                                                    tree_fn=convert.value_mix_state_dict))
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((B, N_AGENTS, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    draws = tm.MixDraws(torch.from_numpy(np.array(jax.random.randint(key, (B, N_AGENTS), 0, ACTIONS))),
                        torch.from_numpy(np.array(jax.random.bernoulli(key, 0.3, (B, N_AGENTS)))))
    np.testing.assert_array_equal(tagent.act(ts, torch.from_numpy(obs), 0.3, draws=draws).numpy(),
                                  np.asarray(jagent.act(jst, jnp.asarray(obs), key, epsilon=0.3)))
    jupdate, tupdate = jagent.make_update(), tagent.make_update()
    for step in range(3):
        arrays = (rng.standard_normal((B, N_AGENTS, OBS)).astype(np.float32),
                  rng.integers(0, ACTIONS, (B, N_AGENTS)),
                  (40.0 * rng.standard_normal(B)).astype(np.float32),
                  rng.standard_normal((B, N_AGENTS, OBS)).astype(np.float32),
                  (rng.random(B) < 0.3).astype(np.float32),
                  rng.standard_normal((B, 3 * N_AGENTS)).astype(np.float32),
                  rng.standard_normal((B, 3 * N_AGENTS)).astype(np.float32))
        ja, ta = both(*arrays)
        # the clip acts: JAX's gradient norm at this step is above 5
        a_star = jnp.argmax(jagent.q_values(jst.params, ja[3]), axis=-1)
        y = ja[2] + 0.95 * (1.0 - ja[4]) * jagent._joint(jst.target, ja[3], a_star, ja[6])
        grads = jax.grad(lambda p: optax.huber_loss(jagent._joint(p, ja[0], ja[1], ja[5]), y, delta=10.0).mean())(
            jst.params)
        assert float(optax.global_norm(grads)) > 5.0
        jst, jl = jupdate(jst, *ja)
        ts, tl = tupdate(ts, *ta)
        np.testing.assert_allclose(float(tl), float(jl), err_msg=f"step {step}", **TOL)
    assert_params(ts.params, convert.value_mix_state_dict(to_np(jst.params)))
    assert_params(ts.target, convert.value_mix_state_dict(to_np(jst.target)))
    assert_adam(ts.opt_state, jst.opt_state, ts.params, convert.value_mix_state_dict)


def test_mappo_updates_match_jax():
    kw = dict(n_agents=N_AGENTS, obs_dim=OBS, state_dim=3 * N_AGENTS, num_actions=ACTIONS, lr=1e-3, seed=2)
    jagent, tagent = jm.MappoAgent(jm.MappoConfig(**kw)), tm.MappoAgent(tm.MappoConfig(**kw), device="cpu")
    jst = jagent.init()
    ts = tagent.init()
    ts.actor.load_state_dict(convert.flax_state_dict(to_np(jst.actor)))
    ts.critic.load_state_dict(convert.flax_state_dict(to_np(jst.critic)))
    ts.actor_opt.load_state_dict(convert.adam_state(to_np(jst.actor_opt), names(ts.actor)))
    ts.critic_opt.load_state_dict(convert.adam_state(to_np(jst.critic_opt), names(ts.critic)))
    jupdate, tupdate = jagent.make_update(), tagent.make_update()
    rng = np.random.default_rng(4)
    key = jax.random.PRNGKey(1)
    for step in range(3):
        key, k_a = jax.random.split(key)
        obs = rng.standard_normal((B, N_AGENTS, OBS)).astype(np.float32)
        sg = rng.standard_normal((B, 3 * N_AGENTS)).astype(np.float32)
        j_actions, j_logp = jagent.act(jst, jnp.asarray(obs), k_a)
        gumbel = np.array(jax.random.gumbel(k_a, (B, N_AGENTS, ACTIONS)))
        t_actions, t_logp = tagent.act(ts, torch.from_numpy(obs), gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(t_actions.numpy(), np.asarray(j_actions))
        np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), **TOL)
        np.testing.assert_allclose(tagent.value(ts, torch.from_numpy(sg)).numpy(),
                                   np.asarray(jagent.value(jst, jnp.asarray(sg))), **TOL)
        reward = rng.standard_normal(B).astype(np.float32)
        adv = rng.standard_normal(B).astype(np.float32)
        ja, ta = both(obs, np.array(j_actions), np.array(j_logp), adv, reward, sg)
        jst, jmet = jupdate(jst, *ja)
        ts, tmet = tupdate(ts, *ta)
        for name in ("actor_loss", "critic_loss"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]), err_msg=f"{name} at {step}", **TOL)
    assert_params(ts.actor, convert.flax_state_dict(to_np(jst.actor)))
    assert_params(ts.critic, convert.flax_state_dict(to_np(jst.critic)))
    assert_adam(ts.actor_opt, jst.actor_opt, ts.actor)
    assert_adam(ts.critic_opt, jst.critic_opt, ts.critic)


def test_maddpg_updates_match_jax():
    kw = dict(n_agents=2, obs_dim=3, act_dim=1, lr=1e-3, seed=3)
    jagent, tagent = jm.MaddpgAgent(jm.MaddpgConfig(**kw)), tm.MaddpgAgent(tm.MaddpgConfig(**kw), device="cpu")
    jst = jagent.init()
    ts = tagent.init()
    for mod, tree in ((ts.actors, jst.actors), (ts.actors_target, jst.actors_target), (ts.critics, jst.critics),
                      (ts.critics_target, jst.critics_target)):
        mod.load_state_dict(convert.flax_state_dict(to_np(tree)))
    ts.actor_opt.load_state_dict(convert.adam_state(to_np(jst.actor_opt), names(ts.actors)))
    ts.critic_opt.load_state_dict(convert.adam_state(to_np(jst.critic_opt), names(ts.critics)))
    jupdate, tupdate = jagent.make_update(), tagent.make_update()
    rng = np.random.default_rng(5)
    for step in range(3):
        obs = rng.standard_normal((B, 2, 3)).astype(np.float32)
        act = np.clip(rng.standard_normal((B, 2, 1)), -1, 1).astype(np.float32)
        reward = -np.abs(act[..., 0] - obs[..., 0]).astype(np.float32)
        nxt = rng.standard_normal((B, 2, 3)).astype(np.float32)
        done = (rng.random(B) < 0.5).astype(np.float32)
        ja, ta = both(obs, act, reward, nxt, done)
        np.testing.assert_allclose(tagent.act(ts, ta[0]).numpy(), np.asarray(jagent.act(jst, ja[0])), **TOL)
        jst, jmet = jupdate(jst, *ja)
        ts, tmet = tupdate(ts, *ta)
        for name in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(tmet[name]), float(jmet[name]), err_msg=f"{name} at {step}", **TOL)
    for mod, tree in ((ts.actors, jst.actors), (ts.actors_target, jst.actors_target), (ts.critics, jst.critics),
                      (ts.critics_target, jst.critics_target)):
        assert_params(mod, convert.flax_state_dict(to_np(tree)))
    assert_adam(ts.actor_opt, jst.actor_opt, ts.actors)
    assert_adam(ts.critic_opt, jst.critic_opt, ts.critics)


ENTRY_POINTS = {
    "ValueMixAgent": lambda dev: tm.ValueMixAgent("qmix", device=dev).init().params.q.Dense_0.kernel,
    "MappoAgent": lambda dev: tm.MappoAgent(device=dev).init().actor.Dense_0.kernel,
    "MaddpgAgent": lambda dev: tm.MaddpgAgent(device=dev).init().actors.Dense_0.kernel,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
