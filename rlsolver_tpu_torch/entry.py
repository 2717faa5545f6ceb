"""Entry points of the port (counterpart of the repo's
`__graft_entry__.py`, which stays the JAX package's):

  entry()             -> (fn, example_args): the flagship forward step on one
                         card, the MPNN Q-network (64 features, 3 layers)
                         over a batched observation [32, 256, 7] of
                         BA_256_ID0; fn(params, obs) -> Q [32, 256].
  dryrun_multichip(n) -> spawns n ranks (`parallel.launch`) and runs one
                         data-parallel step of each flagship training path
                         on tiny shapes, with `__graft_entry__.py`'s asserts: the
                         1-D MCPG step (envs sharded, the policy replicated,
                         psum'd gradients, pmax'd best), `train_ppo_sharded`,
                         a data-parallel L2A iteration, a data-parallel
                         double-DQN step on `SpinSystemEnv`, and at even n
                         the 2-D host x device rollout. Every replicated
                         parameter must come back bit for bit equal on
                         every rank. `extra`, where given, is more work
                         each rank then runs in the same process group.

    python -m rlsolver_tpu_torch.entry [--dryrun N] [--device cpu]

Runs on `cuda` unless `--device cpu`; the ranks share the card over gloo
when there are more ranks than cards (`parallel.launch.choose_backend`).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from rlsolver_tpu_torch.device import resolve_device


def entry(device=None):
    """The flagship forward step (see the module doc)."""
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.models.mpnn import MPNN

    dev = resolve_device(device)
    graph = graph_from_name("BA_256_ID0")
    adj = torch.from_numpy(graph.adjacency_dense()).to(dev)
    model = MPNN(features=64, n_layers=3, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    obs = torch.randn(32, graph.num_nodes, 7, generator=gen, device=dev)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(params: Dict[str, torch.Tensor], obs: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, params, (obs, adj))

    return fn, (params, obs)


def _flat(module_or_params) -> torch.Tensor:
    params = module_or_params.parameters() if hasattr(module_or_params, "parameters") else module_or_params
    return torch.cat([p.detach().reshape(-1).cpu() for p in params])


def _rank_generator(seed: int, mesh, dev) -> torch.Generator:
    """This rank's generator: its own (seed, rank) stream when sharded, the
    seed's own on one rank."""
    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    gen = mesh_lib.shard_generator(seed, mesh, dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    return gen


def _dryrun_rank(device: str, extra: Optional[Callable[[], object]] = None) -> dict:
    """One rank of `dryrun_multichip`: the five paths, then `extra()`;
    returns what the caller checks (every tensor on the CPU), the paths'
    seconds and what `extra` returned."""
    import torch.distributed as dist

    from rlsolver_tpu_torch.algos import l2a
    from rlsolver_tpu_torch.algos.ppo import PPOConfig, train_ppo_sharded
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig, SpinSystemEnv
    from rlsolver_tpu_torch.models.mpnn import MPNN
    from rlsolver_tpu_torch.models.policy import BernoulliPolicy
    from rlsolver_tpu_torch.ops.sampling import bernoulli_logp, metropolis_bitflip_scan
    from rlsolver_tpu_torch.ops.sweeps import SweepData, degree_ordered_sweep, mcpg_init_values
    from rlsolver_tpu_torch.optim import ClippedAdam
    from rlsolver_tpu_torch.parallel import distributed as dist2d, mesh as mesh_lib

    t0 = time.time()
    dev = resolve_device(device if device == "cpu" else torch.device("cuda", torch.cuda.current_device()))
    n_ranks = dist.get_world_size()
    mesh = mesh_lib.make_mesh()
    out: dict = {"rank": mesh_lib.rank(mesh)}
    graph = graph_from_name("BA_64_ID0")
    env = MaxcutEnv(graph, dev)
    n = graph.num_nodes
    num_envs = n_ranks * 8

    # 1-D MCPG step: envs sharded, the policy replicated, grads psum'd
    data = SweepData.build(graph, dev)
    policy = BernoulliPolicy(n, device=dev)
    opt = ClippedAdam(policy.parameters(), 1e-2, max_norm=1.0)
    xs = env.random_xs(torch.Generator(device=dev).manual_seed(1), num_envs)
    xs = mesh_lib.shard_env_batch(mesh, mesh_lib.replicated(xs, mesh))
    gen = _rank_generator(2, mesh, dev)
    with torch.no_grad():
        probs = policy()
    mh = metropolis_bitflip_scan(gen, probs, xs, 16)
    xt = degree_ordered_sweep(gen, mcpg_init_values(mh), data, num_sweeps=1)
    ls_bits = xt[:, :n] > 0.5
    cuts = env.obj(ls_bits)
    energy = env.cg.total_w - 2.0 * cuts
    global_cnt = mesh_lib.psum(torch.tensor(float(energy.shape[0]), device=dev), mesh)
    value = energy - mesh_lib.psum(energy.sum(), mesh) / global_cnt
    loss = torch.sum(bernoulli_logp(policy(), mh) * value) / global_cnt
    opt.zero_grad()
    loss.backward()
    mesh_lib.pmean_grads(opt.params, mesh, mean=False)  # `__graft_entry__.py`'s psum
    opt.step()
    out["mcpg"] = dict(params=_flat(policy), xs=mesh_lib.all_gather_rows(ls_bits, mesh).cpu(),
                       best=float(mesh_lib.pmax(cuts.max(), mesh)), local_best=float(cuts.max()))

    # data-parallel PPO (S2V_PPO's DDP)
    ppo_cfg = PPOConfig(num_envs=2 * n_ranks, horizon=4, num_iterations=1, num_minibatches=2, update_epochs=1)
    ppo_state, ppo_hist = train_ppo_sharded(graph, mesh, ppo_cfg, device=dev)
    out["ppo"] = dict(params=_flat(ppo_state.model), loss=ppo_hist[0]["loss"], best_cut=ppo_hist[0]["best_cut"],
                      local_best=float(ppo_state.env_state.cut.max()))

    # data-parallel L2A: sims sharded, one improvement rollout and the PPO update
    l2a_cfg = l2a.L2AConfig(num_sims=2 * n_ranks, num_repeats=2, top_k=4, seq_len=2, num_iters=1, embed_dim=16,
                            num_heads=2, pretrain_steps=2, update_times=2, ls_iters=1, ls_num_spin=2)
    env_l, gen_l, net, _, steps = l2a._l2a_setup(graph, l2a_cfg, dev, group=mesh)
    xs_l = mesh_lib.shard_env_batch(mesh, mesh_lib.replicated(env_l.random_xs(gen_l, l2a_cfg.num_sims), mesh))
    xs_l, vs_l, losses = l2a.data_parallel_iteration(steps, _rank_generator(3, mesh, dev), xs_l, env_l.obj(xs_l),
                                                     l2a_cfg.seq_len)
    out["l2a"] = dict(params=_flat(net), loss=float(mesh_lib.pmean(losses.mean(), mesh)), vs=vs_l.cpu())

    # data-parallel double DQN on the vectorized SpinSystem (Pattern I)
    s_env = SpinSystemEnv(n, SpinSystemConfig(num_envs=2, max_steps=4, basin_reward=1.0 / n))
    pe = s_env.params_from_graph(graph, device=dev)
    qnet = mesh_lib.replicated(MPNN(features=16, n_layers=2, seed=11, device=dev), mesh)
    dqn_opt = ClippedAdam(qnet.parameters(), 1e-3, max_norm=None)
    state, obs = s_env.reset(pe, generator=_rank_generator(5, mesh, dev))
    with torch.no_grad():
        actions = qnet(obs, pe.adj).argmax(dim=-1)
        _, obs2, rew, done = s_env.step(pe, state, actions)
        q_next = qnet(obs2, pe.adj)  # the target network's stand-in
        tgt = rew + 0.99 * q_next.max(dim=-1).values * (1.0 - done.float())
    qa = qnet(obs, pe.adj).gather(1, actions[:, None])[:, 0]
    count = mesh_lib.psum(torch.tensor(float(qa.shape[0]), device=dev), mesh)
    loss = torch.sum((qa - tgt) ** 2) / count
    dqn_opt.zero_grad()
    loss.backward()
    mesh_lib.pmean_grads(dqn_opt.params, mesh, mean=False)  # psum'd: the replicas stay bit for bit equal
    dqn_opt.step()
    out["dqn"] = dict(params=_flat(qnet), reward=float(mesh_lib.pmean(rew.mean(), mesh)),
                      local_reward=float(rew.mean()))

    # the 2-D host x device rollout at even world sizes
    if n_ranks >= 2 and n_ranks % 2 == 0:
        mesh2 = dist2d.make_host_device_mesh(num_hosts=2)
        xs2 = dist2d.replicated_2d(env.random_xs(torch.Generator(device=dev).manual_seed(3), num_envs), mesh2)

        def rollout(xs):
            return dist2d.pmax_all(env.obj(xs).max(), mesh2).expand(xs.shape[0]).contiguous()

        out["rollout_2d"] = dict(out=dist2d.shard_rollout_2d(mesh2, rollout)(xs2).cpu(),
                                 host_best=float(env.obj(xs2).max()))
    out["seconds"] = time.time() - t0
    if extra is not None:
        out["extra"] = extra()
    return out


def check_dryrun(results: List[dict], n_devices: int, num_nodes: int = 64) -> None:
    """`__graft_entry__.py`'s asserts on the ranks' results, and every replicated
    parameter bit for bit equal across the ranks."""
    first = results[0]
    assert [r["rank"] for r in results] == list(range(n_devices))
    for r in results:
        for path in ("mcpg", "ppo", "l2a", "dqn"):
            if not torch.equal(r[path]["params"], first[path]["params"]):
                raise AssertionError(f"{path}: rank {r['rank']}'s replicated parameters differ from rank 0's")
            if not torch.isfinite(r[path]["params"]).all():
                raise AssertionError(f"{path}: rank {r['rank']} holds non-finite parameters")
    assert first["mcpg"]["xs"].shape == (n_devices * 8, num_nodes)
    assert all(math.isfinite(r["mcpg"]["best"]) and r["mcpg"]["best"] == first["mcpg"]["best"] for r in results)
    assert first["mcpg"]["best"] == max(r["mcpg"]["local_best"] for r in results)
    assert all(math.isfinite(r["ppo"]["loss"]) for r in results)
    assert first["ppo"]["best_cut"] == max(r["ppo"]["local_best"] for r in results)
    assert all(math.isfinite(r["l2a"]["loss"]) and torch.isfinite(r["l2a"]["vs"]).all() for r in results)
    assert all(math.isfinite(r["dqn"]["reward"]) for r in results)
    if n_devices >= 2 and n_devices % 2 == 0:
        out = first["rollout_2d"]["out"]
        assert out.shape == (n_devices * 8,) and torch.isfinite(out).all()
        assert (out == first["rollout_2d"]["host_best"]).all()


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout_s: float = 120.0,
                     join_timeout_s: float = 600.0, store_dir: Optional[str] = None,
                     extra: Optional[Callable[[], object]] = None) -> List[dict]:
    """Spawn `n_devices` ranks (`parallel.launch.launch`, whose arguments
    `timeout_s`, `join_timeout_s` and `store_dir` are), run one sharded step
    of each path (see the module doc) and check them; returns the ranks'
    results. `extra`, a module-level function, runs on every rank after the
    paths, in the same process group (one start-up for both); its result is
    the rank's `"extra"`."""
    from rlsolver_tpu_torch.parallel.launch import launch

    dev = "cpu" if device == "cpu" else "cuda"
    resolve_device(dev)
    results = launch(_dryrun_rank, n_devices, (dev, extra), device=dev, timeout_s=timeout_s,
                     join_timeout_s=join_timeout_s, store_dir=store_dir)
    check_dryrun(results, n_devices)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rlsolver_tpu_torch.entry")
    parser.add_argument("--dryrun", type=int, default=0, help="ranks of dryrun_multichip (0: skip)")
    parser.add_argument("--device", default=None, help="cpu, or the card by default")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    with torch.no_grad():
        print("entry ok:", tuple(fn(*example).shape))
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
        print(f"dryrun_multichip({args.dryrun}) ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
