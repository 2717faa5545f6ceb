"""The port's own draws and seeded initializers against the JAX package's,
as distributions (fixed seeds, so every statistic below is a fixed number):

  * epsilon-greedy's uniform action over the allowed set (`algos/dqn.py`
    `DQNAgent.act`) and its explore coin, the replay indices
    (`buffer_sample`), the reset spins (`envs/spin_system.py` `reset`) and
    the minibatch permutation (`torch.randperm`, as `algos/jumanji_ppo.py`
    `ppo_update` draws it): chi-square of the frequencies against the
    uniform law and against JAX's draws at the same sizes;
  * the Gumbel noise (`ops/sampling.gumbel_noise`), RUN-CSP's h0
    (`RunCspSolver.initial_state`) and `lecun_normal`'s truncated normal:
    Kolmogorov-Smirnov against the law and against JAX's draws;
  * `_orthogonal`: singular values, and its entries against flax's;
  * every initial-parameter tensor of `MPNN`, `MPNNActorCritic` and
    `RunCspNetwork` over 16 seeds: names and shapes as flax's, the constant
    ones equal, the drawn ones' mean, standard deviation and max |x| against
    flax's initializers' law.

A p-value must exceed 1e-3: with these seeds each is far above it, and a
biased sampler (an action or slot drawn 5% more often, a scale off by 5%)
falls far below it at these sample sizes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from scipy import stats

from rlsolver_tpu.algos import jumanji_ppo as jppo
from rlsolver_tpu.algos import runcsp as jrc
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.models.mpnn import MPNN as JMPNN
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import dqn as tdqn
from rlsolver_tpu_torch.algos import jumanji_ppo as tppo
from rlsolver_tpu_torch.algos import runcsp as trc
from rlsolver_tpu_torch.algos.l2o import _orthogonal
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.envs import spin_system as tss
from rlsolver_tpu_torch.models.mpnn import MPNN
from rlsolver_tpu_torch.models.transformer import lecun_normal
from rlsolver_tpu_torch.ops.sampling import gumbel_noise

torch.set_num_threads(1)
P_MIN = 1e-3
TRUNC_STD = 0.87962566103423978  # the standard deviation of a unit normal truncated to [-2, 2]


def gof(counts, probs):
    """Chi-square p-value of `counts` against the law `probs` (cells with
    probability 0 must be empty)."""
    counts, probs = np.asarray(counts, np.float64), np.asarray(probs, np.float64)
    assert counts[probs == 0].sum() == 0
    live = probs > 0
    return stats.chisquare(counts[live], counts[live].sum() * probs[live] / probs[live].sum()).pvalue


def same_law(a, b):
    """Chi-square p-value that the count vectors `a` and `b` come from one law."""
    table = np.stack([a, b]).astype(np.float64)
    return stats.chi2_contingency(table[:, table.sum(axis=0) > 0]).pvalue


def trunc_normal_cdf(scale):
    lo, hi = stats.norm.cdf(-2.0), stats.norm.cdf(2.0)
    return lambda x: np.clip((stats.norm.cdf(np.clip(x / scale, -2, 2)) - lo) / (hi - lo), 0, 1)


# ------------------------------------------------------------ discrete draws
def test_epsilon_greedy_random_action_and_coin():
    n, b, draws = 10, 2048, 8
    allowed = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1], bool)
    mask = torch.from_numpy(np.tile(allowed, (b, 1)))
    env = tss.SpinSystemEnv(n, tss.SpinSystemConfig(num_envs=b))
    agent = tdqn.DQNAgent(env, tdqn.DQNConfig(features=8, n_layers=1), device="cpu")
    params = agent.init_params(0)
    obs, adj = torch.zeros(b, n, env.config.num_observables), torch.zeros(n, n)
    gen = torch.Generator().manual_seed(0)
    # eps = 1: every action is the uniform draw over the allowed set
    port = np.concatenate([agent.act(params, obs, adj, mask, gen, 1.0).numpy() for _ in range(draws)])
    key = jax.random.PRNGKey(0)
    logits = jnp.where(jnp.asarray(mask.numpy()), 0.0, -jnp.inf)
    ref = np.concatenate([np.asarray(jax.random.categorical(k, logits, axis=-1))
                          for k in jax.random.split(key, draws)])
    pc, jc = np.bincount(port, minlength=n), np.bincount(ref, minlength=n)
    assert gof(pc, allowed) > P_MIN and gof(jc, allowed) > P_MIN and same_law(pc, jc) > P_MIN
    # the coin: a greedy argmax everywhere but where u < eps
    q = agent.q_values(params, obs, adj).masked_fill(~mask, -torch.inf).argmax(dim=-1)
    eps = 0.3
    explored = np.concatenate([(agent.act(params, obs, adj, mask, gen, eps) != q).numpy() for _ in range(draws)])
    # a random action equals the greedy one 1 time in 7
    p_differ = eps * (1 - 1 / allowed.sum())
    assert stats.binomtest(int(explored.sum()), explored.size, p_differ).pvalue > P_MIN


def test_replay_indices_uniform_over_filled_slots():
    cap, size, bs, draws = 256, 96, 64, 400
    buf = tdqn.ReplayBuffer.create(cap, 2, 1, device="cpu")
    buf = buf._replace(action=torch.arange(cap), size=size)
    gen = torch.Generator().manual_seed(1)
    port = np.concatenate([tdqn.buffer_sample(buf, bs, gen)[1].numpy() for _ in range(draws)])
    ref = np.concatenate([np.asarray(jax.random.randint(k, (bs,), 0, size))
                          for k in jax.random.split(jax.random.PRNGKey(1), draws)])
    law = np.r_[np.ones(size), np.zeros(cap - size)]
    pc, jc = np.bincount(port, minlength=cap), np.bincount(ref, minlength=cap)
    assert gof(pc, law) > P_MIN and gof(jc, law) > P_MIN and same_law(pc, jc) > P_MIN


def test_reset_spins_fair_and_independent():
    n, b = 50, 4096
    env = tss.SpinSystemEnv(n, tss.SpinSystemConfig(num_envs=b))
    pe = env.params_from_graph(_graph("BA", n, 0), device="cpu")
    state, _ = env.reset(pe, generator=torch.Generator().manual_seed(2))
    up = (state.spins > 0).numpy()
    ref = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(2), 0.5, (b, n)))
    for s in (up, ref):
        assert stats.binomtest(int(s.sum()), s.size, 0.5).pvalue > P_MIN
        assert gof(s.sum(axis=0), np.ones(n)) > P_MIN  # each node as often +1
        # pairs of neighbouring nodes: the four joint outcomes equally often
        pairs = 2 * s[:, :-1].astype(int) + s[:, 1:]
        assert gof(np.bincount(pairs.ravel(), minlength=4), np.ones(4)) > P_MIN
    assert same_law(up.sum(axis=0), ref.sum(axis=0)) > P_MIN


def _graph(dist, n, seed):
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph

    return generate_graph(GraphType(dist), n, seed=seed)


def test_minibatch_permutation_uniform_first_positions():
    tb, draws, first = 24, 6000, 4
    gen = torch.Generator().manual_seed(3)
    port = np.stack([torch.randperm(tb, generator=gen)[:first].numpy() for _ in range(draws)])
    ref = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, tb)[:first])(
        jax.random.split(jax.random.PRNGKey(3), draws)))
    for pos in range(first):
        pc, jc = np.bincount(port[:, pos], minlength=tb), np.bincount(ref[:, pos], minlength=tb)
        assert gof(pc, np.ones(tb)) > P_MIN and gof(jc, np.ones(tb)) > P_MIN and same_law(pc, jc) > P_MIN
    # a permutation: no value twice among the first positions
    assert all(len(set(r)) == first for r in port)


# ---------------------------------------------------------- continuous draws
def test_gumbel_noise_law():
    x = gumbel_noise((200_000,), torch.Generator().manual_seed(4)).numpy().astype(np.float64)
    ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(4), (200_000,)), np.float64)
    assert stats.kstest(x, stats.gumbel_r.cdf).pvalue > P_MIN
    assert stats.kstest(ref, stats.gumbel_r.cdf).pvalue > P_MIN
    assert stats.ks_2samp(x, ref).pvalue > P_MIN
    assert abs(x.mean() - np.euler_gamma) < 4 * math.pi / math.sqrt(6 * x.size)


def test_runcsp_initial_state_law():
    lang = trc.ConstraintLanguage.maxcut()
    solver = trc.RunCspSolver(lang, trc.RunCspConfig(), device="cpu")
    h0 = solver.initial_state(2000, torch.Generator().manual_seed(5)).numpy().ravel().astype(np.float64)
    # JAX's `_unroll`: jax.random.normal(key, (V, S)) * 0.1
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2000, 64)) * 0.1, np.float64).ravel()
    assert h0.size == ref.size == 128_000
    law = stats.norm(scale=0.1).cdf
    assert stats.kstest(h0, law).pvalue > P_MIN and stats.kstest(ref, law).pvalue > P_MIN
    assert stats.ks_2samp(h0, ref).pvalue > P_MIN


def test_lecun_normal_truncated_law():
    fan_in, shape = 400, (400, 300)
    x = lecun_normal(shape, fan_in, torch.Generator().manual_seed(6)).numpy().ravel().astype(np.float64)
    ref = np.asarray(fnn.initializers.lecun_normal()(jax.random.PRNGKey(6), shape), np.float64).ravel()
    scale = math.sqrt(1.0 / fan_in) / TRUNC_STD
    cdf = trunc_normal_cdf(scale)
    assert stats.kstest(x, cdf).pvalue > P_MIN and stats.kstest(ref, cdf).pvalue > P_MIN
    assert stats.ks_2samp(x, ref).pvalue > P_MIN
    for v in (x, ref):
        assert np.abs(v).max() <= 2 * scale * (1 + 1e-6)
        assert abs(v.std() / math.sqrt(1.0 / fan_in) - 1) < 0.01


@pytest.mark.parametrize("shape", [(16, 16), (24, 8), (8, 24)])
def test_orthogonal_singular_values_and_law(shape):
    gen = torch.Generator().manual_seed(7)
    port = [_orthogonal(*shape, gen).numpy() for _ in range(300)]
    ref = [np.asarray(x) for x in jax.vmap(lambda k: fnn.initializers.orthogonal()(k, shape))(
        jax.random.split(jax.random.PRNGKey(7), 300))]
    for q in port[:20] + ref[:20]:
        np.testing.assert_allclose(np.linalg.svd(q, compute_uv=False), 1.0, atol=1e-5)
    assert port[0].shape == ref[0].shape == shape
    # a Haar draw's entries: every one has the same law; the first row's and
    # the corner's against flax's
    pe, je = np.stack(port), np.stack(ref)
    for sel in (np.s_[:, 0, 0], np.s_[:, 0, :], np.s_[:, :, -1]):
        assert stats.ks_2samp(pe[sel].ravel(), je[sel].ravel()).pvalue > P_MIN
    # the signs fixed by R's diagonal: no systematic sign on the diagonal
    assert stats.binomtest(int((pe[:, 0, 0] > 0).sum()), len(pe), 0.5).pvalue > P_MIN


# -------------------------------------------------- networks' initial params
SEEDS = range(16)


def _moments_match(name, port, ref, fan_in_of):
    """`port` and `ref` [seeds, ...] of one parameter: constant tensors equal;
    drawn ones with flax's law (lecun-normal kernels, orthogonal recurrent
    kernels)."""
    assert port.shape == ref.shape, name
    if np.all(ref == ref.reshape(-1)[0]):
        np.testing.assert_array_equal(port, ref, err_msg=name)
        return
    is_orth = ".h" in name and name.startswith("lstm.")
    expect = 1.0 / math.sqrt(port.shape[1]) if is_orth else math.sqrt(1.0 / fan_in_of(name, port))
    for v in (port, ref):
        v = v.ravel().astype(np.float64)
        se = expect / math.sqrt(v.size)
        assert abs(v.mean()) < 5 * se, name
        assert abs(v.std() / expect - 1) < 5 / math.sqrt(2 * v.size) + 0.02, name
        bound = 1.0 + 1e-5 if is_orth else 2 * expect / TRUNC_STD * (1 + 1e-6)
        assert np.abs(v).max() <= bound, name
    assert stats.ks_2samp(port.ravel(), ref.ravel()).pvalue > P_MIN, name


def _fan_in(name, arr):
    return int(np.prod(arr.shape[1:-1]))  # [seeds, in.., out]


def _stack(dicts):
    return {k: np.stack([d[k].numpy() if isinstance(d[k], torch.Tensor) else np.asarray(d[k]) for d in dicts])
            for k in dicts[0]}


@pytest.mark.parametrize("num_obs", [1, 7], ids=["s2v", "eco"])
def test_mpnn_initial_params_law(num_obs):
    f, layers, b, n = 32, 2, 2, 12
    obs, adj = jnp.zeros((b, n, num_obs)), jnp.zeros((n, n))
    ref = _stack([convert.mpnn_state_dict(jax.tree.map(np.asarray, JMPNN(features=f, n_layers=layers).init(
        jax.random.PRNGKey(s), obs, adj))) for s in SEEDS])
    port = _stack([MPNN(num_obs, f, layers, seed=s, device="cpu").state_dict() for s in SEEDS])
    assert sorted(port) == sorted(ref)
    for k in ref:
        _moments_match(k, port[k], ref[k], _fan_in)


def test_actor_critic_initial_params_law():
    b, n, num_obs = 2, 12, 7
    obs, adj = jnp.zeros((b, n, num_obs)), jnp.zeros((n, n))
    ref = _stack([convert.flax_state_dict(jax.tree.map(np.asarray, jppo.MPNNActorCritic().init(
        jax.random.PRNGKey(s), obs, adj))) for s in SEEDS])
    port = _stack([tppo.MPNNActorCritic(num_obs, seed=s, device="cpu").state_dict() for s in SEEDS])
    assert sorted(port) == sorted(ref)
    for k in ref:
        _moments_match(k, port[k], ref[k], _fan_in)


def test_runcsp_network_initial_params_law():
    jl, tl = jrc.ConstraintLanguage.maxcut(), trc.ConstraintLanguage.maxcut()
    jinst = jrc.CSPInstance.from_graph(j_graph_from_name("BA_100_ID0"), jl, "NEQ")
    ref = _stack([convert.runcsp_state_dict(jax.tree.map(np.asarray, jrc.RunCspSolver(
        jl, jrc.RunCspConfig(seed=s)).init_params(jinst))) for s in SEEDS])
    port = _stack([trc.RunCspSolver(tl, trc.RunCspConfig(seed=s), device="cpu").init_params() for s in SEEDS])
    assert sorted(port) == sorted(ref)
    for k in ref:
        _moments_match(k, port[k], ref[k], _fan_in)


def test_actor_critic_initial_outputs_law_along_a_rollout():
    """The initial networks' outputs over 32 seeds on one state 100 random
    flips from a reset, where the unnormalised Hamming observable has grown:
    the value's scale, which decides how long the value loss dominates
    Jumanji's clipped gradient, and the logits' spread, each as JAX's."""
    from rlsolver_tpu.config import GraphType as JGraphType
    from rlsolver_tpu.core.generate import generate_graph as j_generate_graph
    from rlsolver_tpu.envs import spin_system as jss

    n, b = 64, 4
    cfg = dict(num_envs=b, max_steps=128, basin_reward=1 / n, stag_punishment=0.01)
    jenv, tenv = jss.SpinSystemEnv(n, jss.SpinSystemConfig(**cfg)), tss.SpinSystemEnv(n, tss.SpinSystemConfig(**cfg))
    jpe = jenv.params_from_graph(j_generate_graph(JGraphType.PL, n, seed=5))
    tpe = tenv.params_from_graph(_graph("PL", n, 5), device="cpu")
    np.testing.assert_array_equal(tpe.adj.numpy(), np.asarray(jpe.adj))
    state, obs = jenv.reset(jpe, jax.random.PRNGKey(8))
    step = jax.jit(jenv.step)
    for k in jax.random.split(jax.random.PRNGKey(9), 100):
        state, obs, _, _ = step(jpe, state, jax.random.randint(k, (b,), 0, n))
    tobs, net = torch.from_numpy(np.array(obs)), jppo.MPNNActorCritic()
    init, apply = jax.jit(net.init), jax.jit(net.apply)
    ref, port = [], []
    for s in range(32):
        logits, v = apply(init(jax.random.PRNGKey(s), obs, jpe.adj), obs, jpe.adj)
        ref.append((float(jnp.abs(v).max()), float(jnp.std(logits))))
        with torch.no_grad():
            logits, v = tppo.MPNNActorCritic(7, seed=s, device="cpu")(tobs, tpe.adj)
        port.append((float(v.abs().max()), float(logits.std(correction=0))))
    ref, port = np.array(ref), np.array(port)
    assert np.median(ref[:, 0]) > 1.0  # the grown observable lifts the values off the reset's scale
    for col in range(2):
        assert stats.ks_2samp(port[:, col], ref[:, col]).pvalue > P_MIN
