"""The data-parallel forms against the JAX package's `shard_map` on 2 of the
8 virtual CPU devices: one round of sharded TNCO MCPG, one sharded PPO
iteration, one data-parallel L2A iteration and one POMO step, each run by 2
spawned gloo ranks (`parallel.launch`) from JAX's converted parameters with
each shard's draws (JAX's `fold_in` of the shard index) injected. Bits and
cuts equal; TNCO's priorities and costs within 1e-6, PPO's metrics and
parameters within 1e-5, L2A's losses and parameters within 1e-4, POMO's
metrics and parameters within 1e-5 (the unsharded tests' tolerances; the
attention's key biases, whose gradient is zero, within lr of their start).
The replicated parameters and Adam moments are bit for bit equal on both
ranks, and a world of one rank equals the unsharded call bit for bit. Run
through at world size 2 from their own draws, `solve_tnco_mcpg_sharded`
returns the same global best on both ranks, its cost its float64 re-score,
and `train_ppo_sharded`'s best and mean cut are the host's max and f32 mean
of the ranks' own cuts, each of which is its host re-score.

JAX is imported inside the fixtures only: a spawned rank imports this
module to find its target and must not load JAX."""

import numpy as np
import pytest
import torch

from rlsolver_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)
PATHS = ("tnco", "ppo", "l2a", "pomo")
TNCO_CFG = dict(num_chains=8, repeat_times=2, mh_rounds=16, ls_iters=2, num_rounds=2, seed=3)
PPO_N, PPO_CFG = 16, dict(num_envs=8, horizon=4, num_iterations=3, num_minibatches=2, update_epochs=2, seed=1)
L2A_GRAPH = "BA_24_ID0"
L2A_CFG = dict(num_sims=8, num_repeats=2, top_k=4, seq_len=2, num_iters=1, embed_dim=8, num_heads=2,
               pretrain_steps=1, update_times=2, num_searchers=1, ls_iters=1, ls_num_spin=2, seed=0)
L2A_SEED = 3
POMO_CFG = dict(num_cities=6, embed_dim=16, num_heads=2, num_layers=1, batch_size=3, num_steps=1, seed=2)
JOIN_S = 240


# ------------------------------------------------------------------ the ranks
def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).cpu() for t in tensors])


def _opt_tensors(opt):
    return _flat(opt.params), _flat(opt.mu + opt.nu)


def _tnco_env():
    from rlsolver_tpu_torch.envs import tnco as tt

    return tt.TncoEnv(tt.TensorNetwork.from_nodes_list(*tt.random_circuit_nodes(4, 3, seed=0)), "cpu")


def _tnco_rank(mesh, case):
    from rlsolver_tpu_torch.algos import tnco_solver as ts
    from rlsolver_tpu_torch.envs.tnco import LocalSearchDraws
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    env, cfg = _tnco_env(), ts.TncoMcpgConfig(**TNCO_CFG)
    state = ts.init_tnco_mcpg_state(env, cfg, sorts=torch.from_numpy(case["sorts"]), group=mesh)
    d = case["draws"][mesh_lib.rank(mesh)]
    draws = ts.TncoRoundDraws(*(torch.from_numpy(d[k]) for k in ("nodes", "u")),
                              LocalSearchDraws(torch.from_numpy(d["idx"]), torch.from_numpy(d["normal"])))
    state, m = ts.make_tnco_mcpg_step(env, cfg, group=mesh)(state, draws)
    params, moments = _opt_tensors(state.optimizer)
    return dict(best_fs=state.best_fs, best_vs=state.best_vs, best=float(m["best"]), mean=float(m["mean"]),
                params=params, moments=moments, count=state.optimizer.count)


def _ppo_rank(mesh, case):
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.algos import ppo as tppo
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.envs.flip_mdp import FlipMdpEnv
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    cfg = tppo.PPOConfig(**PPO_CFG)
    env = FlipMdpEnv(generate_graph(GraphType.BA, PPO_N, seed=3), horizon=cfg.horizon, device="cpu")
    model = tppo.MLPActorCritic(PPO_N, hidden=16)
    model.load_state_dict(convert.mlp_actor_critic_state_dict(case["params"]))
    xs = torch.from_numpy(case["xs"][mesh_lib.rank(mesh)])
    state = tppo.init_ppo_state(env, cfg, cfg.num_envs, model, xs=xs, group=mesh)
    d = case["draws"][mesh_lib.rank(mesh)]
    state, m = tppo.make_ppo_iteration(env, cfg, group=mesh)(
        state, tppo.PPODraws(torch.from_numpy(d["gumbel"]), torch.from_numpy(d["perms"])))
    params, moments = _opt_tensors(state.optimizer)
    return dict(xs=state.env_state.xs, metrics={k: float(v) for k, v in m.items()},
                state_dict={k: v.clone() for k, v in state.model.state_dict().items()}, params=params,
                moments=moments)


def _l2a_rank(mesh, case):
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.algos import l2a as tl2a
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.models.transformer import PolicyTrsWithValue
    from rlsolver_tpu_torch.optim import ClippedAdam
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    cfg = tl2a.L2AConfig(**L2A_CFG)
    net = PolicyTrsWithValue(cfg.embed_dim, cfg.num_heads, device="cpu")
    net.load_state_dict(convert.flax_state_dict(case["params"]))
    opt = ClippedAdam(net.parameters(), cfg.lr)
    env = MaxcutEnv(graph_from_name(L2A_GRAPH), "cpu")
    steps = tl2a._build_l2a_steps(env, net, torch.from_numpy(case["seq_graph"]), cfg, opt, group=mesh)
    xs = torch.from_numpy(case["xs"][mesh_lib.rank(mesh)])
    d = case["draws"][mesh_lib.rank(mesh)]
    draws = [tl2a.RolloutDraws(*(torch.from_numpy(x) for x in step)) for step in d["rollout"]]
    xs, vs, losses = tl2a.data_parallel_iteration(steps, None, xs, env.obj(xs), cfg.seq_len, draws=draws,
                                                  ids=[torch.from_numpy(i).long() for i in d["ids"]])
    params, moments = _opt_tensors(opt)
    return dict(xs=xs, vs=vs, loss=float(losses.mean()),
                state_dict={k: v.clone() for k, v in net.state_dict().items()}, params=params, moments=moments)


def _pomo_rank(mesh, case):
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.algos import am_pomo as tap
    from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    cfg = tap.POMOConfig(**POMO_CFG)
    model = AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers, device="cpu")
    model.load_state_dict(convert.attention_tsp_state_dict(case["params"]))
    opt, step = tap.make_pomo_step(model, cfg, cuda_graph=False, group=mesh)
    d = case["draws"][mesh_lib.rank(mesh)]
    m = step(draws=tap.POMODraws(torch.from_numpy(d["nodes"]), torch.from_numpy(d["gumbel"])))
    params, moments = _opt_tensors(opt)
    return dict(metrics={k: float(v) for k, v in m.items()},
                state_dict={k: v.clone() for k, v in model.state_dict().items()}, params=params, moments=moments)


def _solvers_rank(mesh):
    """`solve_tnco_mcpg_sharded` and `train_ppo_sharded` run through on this
    rank from their own draws: what they return, and this rank's own PPO
    envs."""
    from rlsolver_tpu_torch.algos import ppo as tppo, tnco_solver as ts
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph

    order, cost, history = ts.solve_tnco_mcpg_sharded(_tnco_env(), mesh, ts.TncoMcpgConfig(**TNCO_CFG))
    state, hist = tppo.train_ppo_sharded(generate_graph(GraphType.BA, PPO_N, seed=3), mesh,
                                         tppo.PPOConfig(**{**PPO_CFG, "num_iterations": 2}), device="cpu")
    return dict(tnco=(order, cost, history), ppo_history=hist, ppo_xs=state.env_state.xs,
                ppo_cut=state.env_state.cut)


def _sharded_rank(cases):
    """One rank of the world of 2: the four paths on JAX's inputs, then the
    two sharded solvers run through."""
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh()
    runs = dict(tnco=_tnco_rank, ppo=_ppo_rank, l2a=_l2a_rank, pomo=_pomo_rank)
    out = {p: runs[p](mesh, cases[p]) for p in PATHS}
    out["solvers"] = _solvers_rank(mesh)
    return out


def _world_of_one_rank():
    """A world of one rank: each path sharded over its group, beside the
    unsharded call from the same seeds. Returns {path: (sharded, unsharded)}."""
    from rlsolver_tpu_torch.algos import am_pomo as tap, l2a as tl2a, ppo as tppo, tnco_solver as ts
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh()
    assert mesh_lib.world_size(mesh) == 1
    out = {}
    env, cfg = _tnco_env(), ts.TncoMcpgConfig(**TNCO_CFG)
    out["tnco"] = (ts.solve_tnco_mcpg_sharded(env, mesh, cfg), ts.solve_tnco_mcpg(env, cfg))
    g = generate_graph(GraphType.BA, PPO_N, seed=3)
    runs = []
    for sharded in (True, False):
        pcfg = tppo.PPOConfig(**{**PPO_CFG, "num_iterations": 2})
        state, hist = (tppo.train_ppo_sharded(g, mesh, pcfg, device="cpu") if sharded
                       else tppo.train_ppo(g, pcfg, device="cpu"))
        runs.append((hist, _flat(state.model.parameters()), state.env_state.xs))
    out["ppo"] = tuple(runs)
    runs = []
    for group in (mesh, None):
        lcfg = tl2a.L2AConfig(**L2A_CFG)
        env_l, gen, net, opt, steps = tl2a._l2a_setup(graph_from_name(L2A_GRAPH), lcfg, torch.device("cpu"),
                                                      group=group)
        xs = env_l.random_xs(gen, lcfg.num_sims)
        xs, vs, losses = tl2a.data_parallel_iteration(steps, gen, xs, env_l.obj(xs), lcfg.seq_len)
        runs.append((xs, vs, losses, _flat(net.parameters()), _flat(opt.mu + opt.nu)))
    out["l2a"] = tuple(runs)
    runs = []
    for group in (mesh, None):
        pcfg = tap.POMOConfig(**{**POMO_CFG, "num_steps": 2})
        model = AttentionTSP(pcfg.embed_dim, pcfg.num_heads, pcfg.num_layers, seed=pcfg.seed, device="cpu")
        _, step = tap.make_pomo_step(model, pcfg, group=group)
        gen = torch.Generator().manual_seed(pcfg.seed)
        hist = [{k: float(v) for k, v in step(gen).items()} for _ in range(pcfg.num_steps)]
        runs.append((hist, _flat(model.parameters())))
    out["pomo"] = tuple(runs)
    return out


# ------------------------------------------------------------ JAX's references
def _jax_mesh(axis="env"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:2]), (axis,))


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _tnco_case():
    import jax
    from jax.sharding import PartitionSpec as P

    from rlsolver_tpu.algos import tnco_solver as js
    from rlsolver_tpu.envs import tnco as jt
    from rlsolver_tpu_torch.envs import tnco as tt

    jenv = jt.TncoEnv(jt.TensorNetwork.from_nodes_list(*tt.random_circuit_nodes(4, 3, seed=0)))
    jcfg = js.TncoMcpgConfig(**TNCO_CFG)
    policy, optimizer, jstep = js.make_tnco_mcpg_step(jenv, jcfg, axis_name="env")
    state = js.init_tnco_mcpg_state(jenv, policy, optimizer, jcfg)
    k_init, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    sorts = np.array(jenv.random_edge_sorts(k_init, jcfg.num_chains))
    spec = js.TncoMcpgState(P(), P(), P(), P("env"), P("env"))
    stepped = jax.jit(jax.shard_map(jstep, mesh=_jax_mesh(), in_specs=(spec,),
                                    out_specs=(spec, {"best": P(), "mean": P()}), check_vma=False))
    _, k_mh, k_ls = jax.random.split(state.key, 3)
    b = jcfg.num_chains // 2 * jcfg.repeat_times
    draws = []
    for s in range(2):
        km, kl = jax.random.fold_in(k_mh, s), jax.random.fold_in(k_ls, s)
        d = dict(nodes=[], u=[], idx=[], normal=[])
        for k in jax.random.split(km, jcfg.mh_rounds):
            k_node, k_u = jax.random.split(k)
            d["nodes"].append(np.array(jax.random.randint(k_node, (b,), 0, jenv.num_bits)))
            d["u"].append(np.array(jax.random.uniform(k_u, (b,))))
        for k in jax.random.split(kl, jcfg.ls_iters):
            k_idx, k_noise = jax.random.split(k)
            d["idx"].append(np.array(jax.random.randint(k_idx, (b, 8), 0, jenv.run_edges)))
            d["normal"].append(np.array(jax.random.normal(k_noise, (b, 8))))
        draws.append({k: np.stack(v) for k, v in d.items()})
    new, m = stepped(state)
    want = dict(best_fs=np.asarray(new.best_fs), best_vs=np.asarray(new.best_vs), best=float(m["best"]),
                mean=float(m["mean"]), params=_np(new.params), opt_state=_np(new.opt_state))
    return dict(sorts=sorts, draws=draws), want


def _ppo_case():
    import jax
    from jax.sharding import PartitionSpec as P

    from rlsolver_tpu.algos import ppo as jppo
    from rlsolver_tpu.config import GraphType as JGraphType
    from rlsolver_tpu.core.generate import generate_graph as j_generate_graph
    from rlsolver_tpu.envs import flip_mdp as jfm
    from rlsolver_tpu_torch import convert

    cfg = jppo.PPOConfig(**PPO_CFG)
    jenv = jfm.FlipMdpEnv(j_generate_graph(JGraphType.BA, PPO_N, seed=3), horizon=cfg.horizon)
    model = jppo.MLPActorCritic(PPO_N, hidden=16)
    optimizer, iteration = jppo.make_ppo_iteration(jenv, model, cfg, axis_name="env")
    state = jppo.init_ppo_state(jenv, model, optimizer, cfg, cfg.num_envs)
    spec = jppo.PPOTrainState(P(), P(), jfm.FlipMdpState(P("env"), P("env"), P()), P("env"), P(), P())
    metric_spec = {k: P() for k in ("loss", "mean_cut", "best_cut", "mean_reward")}
    stepped = jax.jit(jax.shard_map(iteration, mesh=_jax_mesh(), in_specs=(spec,), out_specs=(spec, metric_spec),
                                    check_vma=False))
    _, k_roll, k_perm = jax.random.split(state.key, 3)
    b = cfg.num_envs // 2
    perms = np.stack([np.array(jax.random.permutation(k, cfg.horizon * b))
                      for k in jax.random.split(k_perm, cfg.update_epochs)])
    draws = [dict(gumbel=np.stack([np.array(jax.random.gumbel(k, (b, PPO_N)))
                                   for k in jax.random.split(jax.random.fold_in(k_roll, s), cfg.horizon)]),
                  perms=perms) for s in range(2)]
    inputs = dict(params=_np(state.params), xs=convert.split_by_rank(np.array(state.env_state.xs), 2), draws=draws)
    new, m = stepped(state)
    want = dict(xs=np.asarray(new.env_state.xs), metrics={k: float(v) for k, v in m.items()},
                params=_np(new.params))
    return inputs, want


def _l2a_case():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rlsolver_tpu.algos import l2a as jl2a
    from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
    from rlsolver_tpu_torch import convert

    cfg = jl2a.L2AConfig(**L2A_CFG)
    env, n, key, seq_graph, net, params, opt, opt_state = jl2a._l2a_setup(j_graph_from_name(L2A_GRAPH), cfg)
    roll_fn, ppo_fn = jl2a._build_l2a_steps(env, net, seq_graph, cfg, opt, axis_name="sim")

    def l2a_step(params, opt_state, seed, xs, vs, adj):  # `__graft_entry__.py`'s sharded step
        k = jax.random.fold_in(jax.random.PRNGKey(seed), jax.lax.axis_index("sim"))
        states, rewards, logprobs = [xs], [], []
        for _ in range(cfg.seq_len):
            k, kt = jax.random.split(k)
            xs, vs, reward, logprob = roll_fn(kt, params, xs, vs, adj)
            states.append(xs)
            rewards.append(reward)
            logprobs.append(logprob)
        batch = jl2a.RolloutBatch(jnp.stack(states), jnp.stack(rewards), jnp.stack(logprobs))
        k, kp = jax.random.split(k)
        params, opt_state, losses = ppo_fn(kp, params, opt_state, batch)
        return params, opt_state, xs, vs, jnp.mean(losses)

    stepped = jax.jit(jax.shard_map(l2a_step, mesh=_jax_mesh("sim"),
                                    in_specs=(P(), P(), P(), P("sim"), P("sim"), P()),
                                    out_specs=(P(), P(), P("sim"), P("sim"), P()), check_vma=False))
    xs = env.random_xs(jax.random.fold_in(key, 7), cfg.num_sims)
    b, rb, k_e = cfg.num_sims // 2, cfg.num_sims // 2 * cfg.num_repeats, min(cfg.top_k, n)
    draws = []
    for s in range(2):
        k = jax.random.fold_in(jax.random.PRNGKey(L2A_SEED), s)
        rollout = []
        for _ in range(cfg.seq_len):
            k, kt = jax.random.split(k)
            k_noise, k_sample, k_ls, k_pos, k_draw = jax.random.split(kt, 5)
            ls = []
            for _ in range(cfg.num_searchers):
                k_ls, kk = jax.random.split(k_ls)
                kk, k0 = jax.random.split(kk)
                ls.append(np.stack([np.array(jax.random.normal(x, (rb, n)))
                                    for x in [k0, *jax.random.split(kk, cfg.ls_iters)]]))
            rollout.append((np.array(jax.random.normal(k_noise, (b, n))),
                            np.array(jax.random.uniform(k_sample, (rb, cfg.top_k))),
                            np.array(jax.random.randint(k_pos, (b, k_e), 0, n)),
                            np.array(jax.random.bernoulli(k_draw, 0.5, (b, k_e))), np.stack(ls)))
        k, kp = jax.random.split(k)
        ids = [np.array(jax.random.randint(x, (b,), 0, cfg.seq_len * b))
               for x in jax.random.split(kp, cfg.update_times)]
        draws.append(dict(rollout=rollout, ids=ids))
    inputs = dict(params=_np(params), seq_graph=np.array(seq_graph), xs=convert.split_by_rank(np.array(xs), 2),
                  draws=draws)
    new_params, _, new_xs, new_vs, loss = stepped(params, opt_state, jnp.uint32(L2A_SEED), xs, env.obj(xs), env.cg.adj)
    want = dict(xs=np.asarray(new_xs), vs=np.asarray(new_vs), loss=float(loss), params=_np(new_params))
    return inputs, want


def _pomo_case():
    import jax
    from jax.sharding import PartitionSpec as P

    from rlsolver_tpu.algos import am_pomo as jap
    from rlsolver_tpu.models.attention_tsp import AttentionTSP as JAttentionTSP

    cfg = jap.POMOConfig(**POMO_CFG)
    jm = JAttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers)
    opt, step = jap.make_pomo_step(jm, cfg, axis_name="env")
    state = jap.init_pomo_state(jm, cfg, opt)
    spec = jap.POMOTrainState(P(), P(), P())
    stepped = jax.jit(jax.shard_map(step, mesh=_jax_mesh(), in_specs=(spec,),
                                    out_specs=(spec, {k: P() for k in ("loss", "mean_length", "best_length")}),
                                    check_vma=False))
    _, k_data, k_roll = jax.random.split(state.key, 3)
    n, b = cfg.num_cities, cfg.batch_size
    draws = [dict(nodes=np.array(jax.random.uniform(jax.random.fold_in(k_data, s), (b, n, 2))),
                  gumbel=np.stack([np.asarray(jax.random.gumbel(k, (b, n, n)))
                                   for k in jax.random.split(jax.random.fold_in(k_roll, s), n - 1)]))
             for s in range(2)]
    inputs = dict(params=_np(state.params), draws=draws)
    new, m = stepped(state)
    want = dict(metrics={k: float(v) for k, v in m.items()}, params=_np(new.params), start=_np(state.params))
    return inputs, want


@pytest.fixture(scope="module")
def cases():
    return dict(tnco=_tnco_case(), ppo=_ppo_case(), l2a=_l2a_case(), pomo=_pomo_case())


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    return launch(_sharded_rank, 2, ({p: cases[p][0] for p in PATHS},), device="cpu", timeout_s=60,
                  join_timeout_s=JOIN_S, store_dir=str(tmp_path_factory.mktemp("store")))


# ------------------------------------------------------------------ the tests
def _gather(ranks, path, key):
    return np.concatenate([r[path][key].numpy() for r in ranks])


def _state_dict_close(got, want, atol, start=None, moved=None):
    for k, v in want.items():
        if start is not None and k.endswith("key.bias"):  # zero gradient: moved by f32 noise, lr an Adam step
            assert np.abs(got[k].numpy() - start[k].numpy()).max() <= 1.01 * moved, k
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_tnco_round_matches_jax(cases, ranks):
    from rlsolver_tpu_torch import convert

    want = cases["tnco"][1]
    np.testing.assert_allclose(_gather(ranks, "tnco", "best_fs"), want["best_fs"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(_gather(ranks, "tnco", "best_vs"), want["best_vs"], rtol=0, atol=1e-6)
    for r in ranks:
        assert abs(r["tnco"]["best"] - want["best"]) <= 1e-6 and abs(r["tnco"]["mean"] - want["mean"]) <= 1e-6
        assert r["tnco"]["best"] == float(_gather(ranks, "tnco", "best_vs").min())  # the pmin
    logits = convert.policy_state_dict(want["params"])["logits"].numpy()
    np.testing.assert_allclose(ranks[0]["tnco"]["params"].numpy(), logits, rtol=0, atol=1e-6)
    adam = convert.adam_state(want["opt_state"])
    assert ranks[0]["tnco"]["count"] == adam["count"] == 1


def test_ppo_iteration_matches_jax(cases, ranks):
    from rlsolver_tpu_torch import convert

    want = cases["ppo"][1]
    np.testing.assert_array_equal(_gather(ranks, "ppo", "xs"), want["xs"])
    for r in ranks:
        assert r["ppo"]["metrics"]["best_cut"] == want["metrics"]["best_cut"]  # a cut: exact
        for k in ("loss", "mean_cut", "mean_reward"):
            np.testing.assert_allclose(r["ppo"]["metrics"][k], want["metrics"][k], rtol=1e-5, atol=1e-5, err_msg=k)
    _state_dict_close(ranks[0]["ppo"]["state_dict"], convert.mlp_actor_critic_state_dict(want["params"]), 1e-5)


def test_l2a_iteration_matches_jax(cases, ranks):
    from rlsolver_tpu_torch import convert

    want = cases["l2a"][1]
    np.testing.assert_array_equal(_gather(ranks, "l2a", "xs"), want["xs"])
    np.testing.assert_array_equal(_gather(ranks, "l2a", "vs"), want["vs"])
    # the JAX step returns shard 0's mean loss (a replicated out spec of a per-shard value)
    np.testing.assert_allclose(ranks[0]["l2a"]["loss"], want["loss"], rtol=0, atol=1e-4)
    start = convert.flax_state_dict(cases["l2a"][0]["params"])
    _state_dict_close(ranks[0]["l2a"]["state_dict"], convert.flax_state_dict(want["params"]), 1e-4, start,
                      L2A_CFG["update_times"] * 1e-4)


def test_pomo_step_matches_jax(cases, ranks):
    from rlsolver_tpu_torch import convert

    want = cases["pomo"][1]
    for r in ranks:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["pomo"]["metrics"][k], v, rtol=0, atol=1e-5, err_msg=k)
    _state_dict_close(ranks[0]["pomo"]["state_dict"], convert.attention_tsp_state_dict(want["params"]), 1e-5,
                      convert.attention_tsp_state_dict(want["start"]), 1e-4)


@pytest.mark.parametrize("path", PATHS)
def test_replicated_state_bit_identical_across_ranks(path, ranks):
    for key in ("params", "moments"):
        assert torch.equal(ranks[0][path][key], ranks[1][path][key]), key


def test_tnco_solve_sharded_returns_the_global_best(ranks):
    env = _tnco_env()
    order, cost, history = ranks[0]["solvers"]["tnco"]
    assert _equal(ranks[1]["solvers"]["tnco"], (order, cost, history))  # the same on every rank
    assert sorted(order.tolist()) == list(range(env.run_edges))
    assert cost == history[-1]  # the gathered incumbents' least is the last round's pmin'd best
    assert history[1] <= history[0]
    assert abs(env.log10_multiple_times_accurate(order[None])[0] - cost) < 1e-4  # its float64 re-score


def test_train_ppo_sharded_reduces_over_the_ranks(ranks):
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    g = generate_graph(GraphType.BA, PPO_N, seed=3)
    hist = ranks[0]["solvers"]["ppo_history"]
    assert ranks[1]["solvers"]["ppo_history"] == hist
    cuts = [r["solvers"]["ppo_cut"] for r in ranks]
    assert hist[-1]["best_cut"] == max(float(c.max()) for c in cuts)  # the pmax
    assert hist[-1]["mean_cut"] == float((cuts[0].mean() + cuts[1].mean()) / 2)  # the pmean: SUM / n in f32
    for r in ranks:
        xs, cut = r["solvers"]["ppo_xs"], r["solvers"]["ppo_cut"]
        for b in range(xs.shape[0]):
            assert obj_maxcut(xs[b].numpy().astype(np.int64), g) == float(cut[b])  # host re-score


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    return launch(_world_of_one_rank, 1, device="cpu", timeout_s=60, join_timeout_s=JOIN_S,
                  store_dir=str(tmp_path_factory.mktemp("store")))[0]


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("path", PATHS)
def test_world_of_one_equals_unsharded(path, world_of_one):
    sharded, unsharded = world_of_one[path]
    assert _equal(sharded, unsharded)
