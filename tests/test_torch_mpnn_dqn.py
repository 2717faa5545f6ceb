"""The MPNN (`models/mpnn.py`) and DQN (`algos/dqn.py`) against the JAX
package's, with JAX's params carried through `convert`: the forward in f32
(rtol 1e-5) and bf16 (rtol 2e-2, argmax agreement), one double-DQN +
Adam step (the loss and the gradient, read from Adam's first moment, at
rtol 1e-4; the params where |g| >= 1e-5, since Adam's first step sees
signs), the replay ring with injected indices, loop steps with JAX's draws
injected, and the committed ECO-DQN network's greedy cut on BA_100_ID0 with
JAX's reset spins."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import dqn as jdqn
from rlsolver_tpu.core.generate import generate_graph as j_generate_graph, graph_from_name as j_graph_from_name
from rlsolver_tpu.config import GraphType as JGraphType
from rlsolver_tpu.envs import spin_system as jss
from rlsolver_tpu.models.mpnn import MPNN as JMPNN
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import dqn as tdqn
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.generate import generate_graph, graph_from_name
from rlsolver_tpu_torch.envs import spin_system as tss
from rlsolver_tpu_torch.models.mpnn import MPNN
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECO_PKL = os.path.join(REPO, "results_quality", "eco_params_BA.pkl")
N, B = 24, 8


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def sd(params):
    return convert.mpnn_state_dict(to_np(params))


def adjacency(seed=0, batch=None):
    rng = np.random.default_rng(seed)
    a = np.triu((rng.random((N, N)) < 0.25).astype(np.float32), 1)
    a = a + a.T
    return a if batch is None else np.stack([np.roll(a, i, axis=0) for i in range(batch)])


# ---------------------------------------------------------------- MPNN
@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
@pytest.mark.parametrize("kw", [dict(n_layers=2), dict(n_layers=1, tied_weights=True),
                                dict(n_layers=2, readout_hidden=(12, 6))], ids=["plain", "tied", "readout_hidden"])
def test_mpnn_forward_matches_flax(kw, per_sample):
    obs = np.random.default_rng(1).standard_normal((B, N, 7)).astype(np.float32)
    adj = adjacency(2, B if per_sample else None)
    jm = JMPNN(features=16, **kw)
    params = jm.init(jax.random.PRNGKey(3), obs, adj)
    tm = MPNN(7, 16, device="cpu", **kw)
    tm.load_state_dict(sd(params))
    q_j = np.asarray(jm.apply(params, obs, adj))
    q_t = tm(torch.from_numpy(obs), torch.from_numpy(adj)).detach().numpy()
    assert q_t.shape == (B, N)
    np.testing.assert_allclose(q_t, q_j, rtol=1e-5, atol=1e-6)

    jb = JMPNN(features=16, dtype=jnp.bfloat16, **kw)
    tb = MPNN(7, 16, dtype=torch.bfloat16, device="cpu", **kw)
    tb.load_state_dict(sd(params))
    qb_j = np.asarray(jb.apply(params, obs, adj))
    qb_t = tb(torch.from_numpy(obs), torch.from_numpy(adj)).detach().numpy()
    assert qb_t.dtype == np.float32
    np.testing.assert_allclose(qb_t, qb_j, rtol=2e-2, atol=2e-2 * np.abs(qb_j).max())
    assert (qb_t.argmax(-1) == qb_j.argmax(-1)).mean() >= 0.95


def test_init_params_layout():
    env = tss.SpinSystemEnv(N, tss.SpinSystemConfig(num_envs=B))
    agent = tdqn.DQNAgent(env, tdqn.DQNConfig(features=16, n_layers=2), device="cpu")
    p = agent.init_params(0)
    jp = to_np(JMPNN(features=16, n_layers=2).init(jax.random.PRNGKey(0), np.zeros((B, N, 7), np.float32),
                                                   adjacency()))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in sd(jp).items()}
    assert float(p["readout_out.bias"].abs().max()) == 0.0
    k = p["message_0.kernel"]
    assert abs(float(k.std()) - (1 / 32) ** 0.5) < 0.03 and float(k.abs().max()) <= 2 * (1 / 32) ** 0.5 / 0.8796 + 1e-6


# ----------------------------------------------------------------- DQN
def agents(cfg_kw=None, env_kw=None):
    cfg_kw = {**dict(features=16, n_layers=2, batch_size=8), **(cfg_kw or {})}
    env_kw = {**dict(num_envs=B, basin_reward=1 / N, stag_punishment=0.01), **(env_kw or {})}
    jenv = jss.SpinSystemEnv(N, jss.SpinSystemConfig(**env_kw))
    tenv = tss.SpinSystemEnv(N, tss.SpinSystemConfig(**env_kw))
    return jdqn.DQNAgent(jenv, jdqn.DQNConfig(**cfg_kw)), tdqn.DQNAgent(tenv, tdqn.DQNConfig(**cfg_kw), device="cpu")


def assert_params_close(tp, jp, grads):
    """Each parameter at rtol 1e-4 where its gradient is at least 1e-5."""
    for k, g in grads.items():
        keep = np.abs(g) >= 1e-5
        np.testing.assert_allclose(tp[k].numpy()[keep], jp[k][keep], rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per_sample"])
def test_train_step_matches_jax(per_sample):
    ja, ta = agents()
    rng = np.random.default_rng(5)
    bs = 8
    obs, next_obs = (rng.standard_normal((bs, N, 7)).astype(np.float32) for _ in range(2))
    batch = (obs, rng.integers(0, N, bs).astype(np.int32), rng.standard_normal(bs).astype(np.float32), next_obs,
             rng.random(bs) < 0.3)
    adj = adjacency(6, bs if per_sample else None)
    params = ja.init_params(jax.random.PRNGKey(1), ja.env.params_from_graph(j_generate_graph(JGraphType.BA, N, seed=1)))
    target = ja.init_params(jax.random.PRNGKey(2), ja.env.params_from_graph(j_generate_graph(JGraphType.BA, N, seed=1)))
    opt_state = ja.optimizer.init(params)
    names = list(sd(params))
    t_batch = tuple(torch.from_numpy(np.asarray(x)) for x in batch)
    t_params, t_opt = sd(params), convert.adam_state(to_np(opt_state), names=names)
    mu_prev = {k: np.zeros_like(v.numpy()) for k, v in t_params.items()}
    for _ in range(2):  # the first step from Adam's zero state, the second from a converted one
        params, opt_state, loss = ja._train_step(params, target, opt_state, batch, adj)
        t_params, t_opt, t_loss = ta.train_step(t_params, sd(target), t_opt, t_batch, torch.from_numpy(adj))
        np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-4)
        j_adam = convert.adam_state(to_np(opt_state), names=names)
        assert t_opt["count"] == j_adam["count"]
        grads = {}
        for k, m_t, m_j in zip(names, t_opt["mu"], j_adam["mu"]):
            g_j = (m_j.numpy() - 0.9 * mu_prev[k]) / 0.1  # mu = 0.9 mu + 0.1 g
            g_t = (m_t.numpy() - 0.9 * mu_prev[k]) / 0.1
            keep = np.abs(g_j) >= 1e-5
            np.testing.assert_allclose(g_t[keep], g_j[keep], rtol=1e-4, atol=1e-8, err_msg=k)
            grads[k], mu_prev[k] = g_j, m_j.numpy()
        assert_params_close(t_params, sd(params), grads)
        t_params, t_opt = sd(params), convert.adam_state(to_np(opt_state), names=names)  # continue from JAX's


def test_replay_ring_add_and_sample():
    cap, bs = 16, 5
    jbuf = jdqn.ReplayBuffer.create(cap, N, 7)
    tbuf = tdqn.ReplayBuffer.create(cap, N, 7, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(3):  # the third add wraps the ring
        obs, nxt = (rng.standard_normal((B, N, 7)).astype(np.float32) for _ in range(2))
        act, rew, done = rng.integers(0, N, B).astype(np.int32), rng.standard_normal(B).astype(np.float32), rng.random(
            B) < 0.5
        jbuf = jdqn.buffer_add(jbuf, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew), jnp.asarray(nxt),
                               jnp.asarray(done), gidx=i)
        tbuf = tdqn.buffer_add(tbuf, *(torch.from_numpy(x) for x in (obs, act, rew, nxt, done)), gidx=i)
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
        for name in ("obs", "action", "reward", "next_obs", "done", "gidx"):
            np.testing.assert_array_equal(getattr(tbuf, name).numpy(), np.asarray(getattr(jbuf, name)))
        key = jax.random.PRNGKey(i)
        idx = np.asarray(jax.random.randint(key, (bs,), 0, jbuf.size))
        for t, j in zip(tdqn.buffer_sample(tbuf, bs, idx=torch.from_numpy(np.array(idx))), jdqn.buffer_sample(jbuf, key, bs)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="divide"):
        tdqn.buffer_add(tbuf, *(torch.zeros(3, N, 7), torch.zeros(3), torch.zeros(3), torch.zeros(3, N, 7),
                                torch.zeros(3, dtype=torch.bool)))


def loop_draws(jenv, jstate, cfg):
    """JAX's draws of one loop step, from the loop state's key."""
    _, k_act, k_sample, k_reset = jax.random.split(jstate.key, 4)
    k1, k2 = jax.random.split(k_act)
    mask = jenv.allowed_action_mask(jstate.env_state)
    random_a = jax.random.categorical(k1, jnp.where(mask, 0.0, -jnp.inf), axis=-1)
    u = jax.random.uniform(k2, (jenv.config.num_envs,))
    size = min(int(jstate.buf.size) + jenv.config.num_envs, jstate.buf.obs.shape[0])
    idx = jax.random.randint(k_sample, (cfg.batch_size,), 0, size)
    spins = jnp.where(jax.random.bernoulli(k_reset, 0.5, (jenv.config.num_envs, N)), 1.0, -1.0)
    return tdqn.LoopDraws(tdqn.ActDraws(*(torch.from_numpy(np.array(x)) for x in (random_a, u))),
                          torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(spins)))


@pytest.mark.parametrize("num_graphs", [1, 2])
def test_loop_steps_with_injected_draws(num_graphs):
    cfg_kw = dict(buffer_capacity=32, learning_starts=8, update_frequency=1, target_update_frequency=2,
                  eps_decay_steps=4)
    ja, ta = agents(cfg_kw, dict(max_steps=2))
    seeds = (1, 2)[:num_graphs]
    jg = [j_generate_graph(JGraphType.BA, N, seed=s) for s in seeds]
    tg = [generate_graph(GraphType.BA, N, seed=s) for s in seeds]
    j_step, js = ja._build_loop_step(jg if num_graphs > 1 else jg[0])
    t_step, ts = ta._build_loop_step(tg if num_graphs > 1 else tg[0])
    names = list(sd(js.params))
    env_state, _ = ta.env.reset(ta.env.params_from_graph(tg[0], device="cpu"), spins=np.asarray(js.env_state.spins))
    # JAX builds its first observation eagerly, where x / c is a true division
    # (compiled steps multiply by f32(1 / c)): carry that observation over
    obs = torch.from_numpy(np.array(js.obs))
    ts = ts._replace(params=sd(js.params), target_params=sd(js.target_params), env_state=env_state, obs=obs,
                     opt_state=convert.adam_state(to_np(js.opt_state), names=names))
    j_step = jax.jit(j_step)
    for _ in range(5):  # two episodes of two steps and one more; training from the first step
        draws = loop_draws(ja.env, js, ja.cfg)
        mu0 = convert.adam_state(to_np(js.opt_state), names=names)["mu"]
        js, jm = j_step(js)
        ts, tm = t_step(ts, draws)
        for name in ("spins", "gains", "score", "best_score", "best_spins", "time_since_flip", "hist_h1"):
            np.testing.assert_array_equal(getattr(ts.env_state, name).numpy(),
                                          np.asarray(getattr(js.env_state, name)).astype(
                                              getattr(ts.env_state, name).numpy().dtype), err_msg=name)
        np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
        for name in ("obs", "action", "reward", "done", "gidx"):
            np.testing.assert_array_equal(getattr(ts.buf, name).numpy(), np.asarray(getattr(js.buf, name)))
        assert (ts.buf.ptr, ts.buf.size, ts.step_idx, ts.train_steps, ts.graph_idx) == (
            int(js.buf.ptr), int(js.buf.size), int(js.step_idx), int(js.train_steps), int(js.graph_idx))
        assert float(ts.best_cut) == float(js.best_cut) and tm["eps"] == float(jm["eps"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        j_adam = convert.adam_state(to_np(js.opt_state), names=names)
        grads = {k: (m.numpy() - 0.9 * m0.numpy()) / 0.1 for k, m, m0 in zip(names, j_adam["mu"], mu0)}
        assert_params_close(ts.params, sd(js.params), grads)
        assert_params_close(ts.target_params, sd(js.target_params), grads)
        # carry on from JAX's params, so that Adam's sign-sensitive steps do not compound
        ts = ts._replace(params=sd(js.params), target_params=sd(js.target_params),
                         opt_state=convert.adam_state(to_np(js.opt_state), names=names))
    assert int(js.train_steps) == 5


# ------------------------------------------------------- the ECO network
def eco_greedy_cut(name, envs, bf16):
    """The committed ECO-DQN network (BA), greedy from JAX's reset spins
    (`PRNGKey(0)`) in both packages: (JAX's cut, the port's), the port's
    equal to its host re-score."""
    n = graph_from_name(name).num_nodes
    kw = dict(num_envs=envs, basin_reward=1 / n, stag_punishment=0.01)
    with open(ECO_PKL, "rb") as f:
        j_params = pickle.load(f)
    ja = jdqn.DQNAgent(jss.SpinSystemEnv(n, jss.SpinSystemConfig(**kw)),
                       jdqn.DQNConfig(features=64, n_layers=3, dtype=jnp.bfloat16 if bf16 else jnp.float32))
    ta = tdqn.DQNAgent(tss.SpinSystemEnv(n, tss.SpinSystemConfig(**kw)),
                       tdqn.DQNConfig(features=64, n_layers=3, dtype=torch.bfloat16 if bf16 else torch.float32),
                       device="cpu")
    key = jax.random.PRNGKey(0)
    j_cut = ja.evaluate_scan(j_params, j_graph_from_name(name), key=key)
    spins = jnp.where(jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5, (envs, n)), 1.0, -1.0)
    params = convert.mpnn_state_dict(convert.load_flax_pickle(ECO_PKL))
    g = graph_from_name(name)
    t_cut = ta.evaluate_scan(params, g, spins=[np.asarray(spins)])
    st = ta.last_eval_state
    b = int(st.best_score.argmax())
    assert obj_maxcut((st.best_spins[b] > 0).numpy().astype(int), g) == t_cut
    return j_cut, t_cut


def test_eco_checkpoint_greedy_cut_matches_jax():
    """f32 at 16 envs on BA_100_ID0: the same best cut as JAX's."""
    j_cut, t_cut = eco_greedy_cut("BA_100_ID0", 16, bf16=False)
    assert t_cut == j_cut


def test_eco_checkpoint_greedy_cut_matches_jax_bf16_id9():
    """bf16 at scripts/eco_distribution.py's 50 envs x 200 steps on
    BA_100_ID9: JAX's own CPU cut, 279 (dist_table.csv's 280 is the TPU
    run's)."""
    j_cut, t_cut = eco_greedy_cut("BA_100_ID9", 50, bf16=True)
    assert t_cut == j_cut == 279


def test_load_flax_pickle_without_jax():
    probe = (
        "import sys\n"
        "from rlsolver_tpu_torch import convert\n"
        f"p = convert.load_flax_pickle({ECO_PKL!r})\n"
        "sd = convert.mpnn_state_dict(p)\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "print(len(sd), tuple(sd['node_init.kernel'].shape), tuple(sd['readout_out.bias'].shape))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["12", "(7,", "64)", "(1,)"]
    with open(ECO_PKL, "rb") as f:
        j_params = to_np(pickle.load(f))
    t_params = convert.load_flax_pickle(ECO_PKL)
    for a, b in zip(jax.tree.leaves(j_params), jax.tree.leaves(t_params)):
        np.testing.assert_array_equal(a, b)


def test_load_flax_pickle_refuses_other_globals(tmp_path):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"x": subprocess.Popen}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        convert.load_flax_pickle(str(path))


def test_trainers_and_evaluators_run_from_generators():
    """The generator paths of the host-loop trainer, the rotating-pool
    trainer with validation selection, and the two greedy evaluators (the
    same rollout from the same generator seed)."""
    _, ta = agents(dict(features=8, n_layers=1, buffer_capacity=64, learning_starts=16, update_frequency=2,
                        eps_decay_steps=32), dict(num_envs=4, max_steps=8))
    graphs = [generate_graph(GraphType.BA, N, seed=s) for s in (9, 10, 11)]
    params, hist = ta.train(lambda i: graphs[i % 3], 24, eval_every=12, eval_graphs=graphs[:1], select_best=True)
    assert len(hist["best_cut"]) == 3 and len(hist["eval"]) == 2 and len(hist["loss"]) > 0
    best, seg = ta.train_scan_select(graphs, 32, graphs[:1], num_segments=2, scan_chunk=8)
    assert [s for s, _ in seg] == [16, 32] and all(np.isfinite(v) for _, v in seg)
    _, best_cut, state = ta.train_scan(graphs[0], 20, scan_chunk=8)
    assert state.step_idx == 16 and best_cut > 0
    v_loop = ta.evaluate(best, graphs[0], generator=torch.Generator().manual_seed(7), num_envs=8)
    v_one = ta.evaluate(best, graphs[0], generator=torch.Generator().manual_seed(7))
    v_scan = ta.evaluate_scan(best, graphs[0], generator=torch.Generator().manual_seed(7))
    assert v_scan == v_one <= v_loop
    assert host_cut(ta.last_eval_state, graphs[0]) == v_scan
    if not torch.cuda.is_available():  # entry points run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tdqn.DQNAgent(ta.env, ta.cfg)


def host_cut(state, g):
    b = int(state.best_score.argmax())
    return obj_maxcut((state.best_spins[b] > 0).numpy().astype(int), g)
