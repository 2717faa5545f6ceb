"""The Pattern-I env (`envs/spin_system.py`) and the graph generators
(`envs/generators.py`) against the JAX package's. The env is reset with
JAX's spins injected and stepped through a whole episode with the same
actions: spins, gains, scores, rewards, observations, hashes and `done`
must be bit-exact (unit and small-integer weights) under every reward
signal, the S2V irreversible mode, a finite revisit memory and both spin
bases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.config import GraphType as JGraphType
from rlsolver_tpu.core.generate import generate_graph as j_generate_graph
from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs import generators as jgen
from rlsolver_tpu.envs import spin_system as jss
from rlsolver_tpu_torch.config import GraphType
from rlsolver_tpu_torch.core.generate import generate_graph
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.envs import generators as tgen
from rlsolver_tpu_torch.envs import spin_system as tss
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
N, B, STEPS = 24, 8, 14


def graph_pair(weighted: bool):
    """The same BA graph in both packages, unit or with weights in
    {-1, 1, 2, 3} (positive weighted degrees somewhere)."""
    g = generate_graph(GraphType.BA, N, seed=5)
    w = np.random.default_rng(1).choice([-1.0, 1.0, 2.0, 3.0], size=g.num_edges) if weighted else g.weights
    edges = [(int(a), int(b), float(x)) for (a, b), x in zip(g.edges.tolist(), w)]
    return JGraph.from_edge_list(N, edges), Graph.from_edge_list(N, edges)


CASES = {
    "bls_eco_binary": dict(basin_reward=1 / N, stag_punishment=0.01),
    "bls_signed_unnormed": dict(spin_basis="SIGNED", norm_rewards=False),
    "custom_bls_memory3": dict(reward_signal="CUSTOM_BLS", stag_punishment=0.05, memory_length=3),
    "dense_basin_horizon": dict(reward_signal="DENSE", basin_reward=0.5, horizon_length=5),
    "single_stag": dict(reward_signal="SINGLE", stag_punishment=0.25),
    "s2v_irreversible": dict(reward_signal="DENSE", reversible_spins=False, num_observables=1, norm_rewards=False,
                             max_steps=N),
}


def configs(case: str):
    kw = dict(CASES[case])
    kw.setdefault("max_steps", STEPS)
    j_kw, t_kw = dict(kw), dict(kw)
    for name, enum_j, enum_t in (("reward_signal", jss.RewardSignal, tss.RewardSignal),
                                 ("spin_basis", jss.SpinBasis, tss.SpinBasis)):
        if name in kw:
            j_kw[name], t_kw[name] = enum_j[kw[name]], enum_t[kw[name]]
    return jss.SpinSystemConfig(num_envs=B, **j_kw), tss.SpinSystemConfig(num_envs=B, **t_kw)


def assert_state_equal(js, ts):
    for name in ("spins", "gains", "max_local", "score", "init_score", "best_score", "best_spins", "time_since_flip"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), err_msg=name)
    assert ts.step_count == int(js.step_count)
    for name in ("hist_h1", "hist_h2"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)).astype(np.int64),
                                      err_msg=name)


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "int"])
@pytest.mark.parametrize("case", list(CASES))
def test_episode_bit_exact(case, weighted):
    jg, tg = graph_pair(weighted)
    jcfg, tcfg = configs(case)
    jenv, tenv = jss.SpinSystemEnv(N, jcfg), tss.SpinSystemEnv(N, tcfg)
    jp, tp = jenv.params_from_graph(jg, hash_seed=3), tenv.params_from_graph(tg, hash_seed=3, device="cpu")
    np.testing.assert_array_equal(tp.hash_r1.numpy(), np.asarray(jp.hash_r1).astype(np.int64))
    np.testing.assert_array_equal(tp.adj.numpy(), np.asarray(jp.adj))
    assert float(tp.total_w) == float(jp.total_w) and float(tp.max_local_reward) == float(jp.max_local_reward)

    js, jo = jax.jit(jenv.reset)(jp, jax.random.PRNGKey(7))  # compiled, as the JAX package runs it
    ts, to = tenv.reset(tp, spins=np.asarray(js.spins) if tcfg.reversible_spins else None)
    assert_state_equal(js, ts)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for b in range(3):  # the score is the host cut
        assert float(ts.score[b]) == obj_maxcut((ts.spins[b] > 0).numpy().astype(int), tg)

    rng = np.random.default_rng(11)
    jstep = jax.jit(jenv.step)
    for t in range(jenv.max_steps):
        mask = tenv.allowed_action_mask(ts).numpy()
        np.testing.assert_array_equal(mask, np.asarray(jenv.allowed_action_mask(js)))
        # few distinct nodes, so that states recur and the revisit memory counts
        pool = np.arange(N) if not tcfg.reversible_spins else np.arange(4)
        actions = np.array([rng.choice(pool[mask[b, pool]]) for b in range(B)], np.int32)
        js, jo, jr, jd = jstep(jp, js, jnp.asarray(actions))
        ts, to, tr, td = tenv.step(tp, ts, torch.from_numpy(actions))
        assert_state_equal(js, ts)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert bool(td.all())  # the episode ended at max_steps
    np.testing.assert_array_equal(tenv._cut(tp, ts.spins).numpy(), ts.score.numpy())
    np.testing.assert_array_equal(tenv._gains_full(tp, ts.spins).numpy(), ts.gains.numpy())


def test_state_hash_wraps_as_uint32():
    """Sums of hash entries above 2^32 wrap as JAX's uint32 sums do."""
    jenv, tenv = jss.SpinSystemEnv(N, jss.SpinSystemConfig(num_envs=B)), tss.SpinSystemEnv(N, tss.SpinSystemConfig(
        num_envs=B))
    jg, tg = graph_pair(False)
    jp, tp = jenv.params_from_graph(jg, hash_seed=9), tenv.params_from_graph(tg, hash_seed=9, device="cpu")
    spins = np.where(np.random.default_rng(2).random((B, N)) < 0.5, 1.0, -1.0).astype(np.float32)
    spins[0] = 1.0  # all bits: the largest sum
    spins[1] = -1.0  # no bits: the empty sum, raised to 1
    for jh, th in zip(jenv._state_hash(jp, jnp.asarray(spins)), tenv._state_hash(tp, torch.from_numpy(spins))):
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    assert int(th[1]) == 1
    assert int(torch.where(torch.ones(N, dtype=torch.bool), tp.hash_r2, 0).sum()) > 2**32  # it did wrap


def test_reset_from_generator_and_errors():
    _, tg = graph_pair(False)
    env = tss.SpinSystemEnv(N, tss.SpinSystemConfig(num_envs=B))
    p = env.params_from_graph(tg, device="cpu")
    s1, _ = env.reset(p, generator=torch.Generator().manual_seed(0))
    s2, _ = env.reset(p, generator=torch.Generator().manual_seed(0))
    assert torch.equal(s1.spins, s2.spins) and set(s1.spins.unique().tolist()) == {-1.0, 1.0}
    with pytest.raises(ValueError, match="generator"):
        env.reset(p)
    with pytest.raises(ValueError, match="nodes"):
        env.params_from_graph(generate_graph(GraphType.BA, N + 1, seed=0), device="cpu")
    if not torch.cuda.is_available():  # entry points run on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            env.params_from_graph(tg)


# ------------------------------------------------------------- generators
def same_graph(jg, tg):
    assert jg.num_nodes == tg.num_nodes and jg.name == tg.name
    np.testing.assert_array_equal(np.asarray(jg.edges), tg.edges)
    np.testing.assert_array_equal(np.asarray(jg.weights), tg.weights)


@pytest.mark.parametrize("kind", ["BA", "ER", "PL"])
def test_random_and_validation_generators_match(kind):
    jr, tr = jgen.RandomGraphGenerator(JGraphType(kind), 30, seed=4), tgen.RandomGraphGenerator(GraphType(kind), 30,
                                                                                                   seed=4)
    for i in range(3):
        same_graph(jr(i), tr(i))
    jv, tv = jgen.ValidationGraphGenerator(JGraphType(kind), 30, num_graphs=3), tgen.ValidationGraphGenerator(
        GraphType(kind), 30, num_graphs=3)
    for a, b in zip(jv.get(), tv.get()):
        same_graph(a, b)
    same_graph(jv(4), tv(4))


def test_set_and_perturbed_generators_match():
    seeds = (1, 2, 3)
    jgs = [j_generate_graph(JGraphType.BA, 20, seed=s) for s in seeds]
    tgs = [generate_graph(GraphType.BA, 20, seed=s) for s in seeds]
    for ordered in (True, False):
        js, ts = jgen.SetGraphGenerator(jgs, ordered=ordered, seed=5), tgen.SetGraphGenerator(tgs, ordered=ordered,
                                                                                               seed=5)
        for _ in range(5):
            same_graph(js(), ts())
        jpg = jgen.PerturbedGraphGenerator(jgs, perturb_std=0.1, ordered=ordered, seed=6)
        tpg = tgen.PerturbedGraphGenerator(tgs, perturb_std=0.1, ordered=ordered, seed=6)
        for _ in range(3):
            same_graph(jpg(), tpg())
    same_graph(jgen.SingleGraphGenerator(jgs[0])(3), tgen.SingleGraphGenerator(tgs[0])(3))
    with pytest.raises(ValueError, match="num_nodes"):
        tgen.SetGraphGenerator([tgs[0], generate_graph(GraphType.BA, 21, seed=0)])
