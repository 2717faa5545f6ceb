"""The learned solvers' cells over training seeds, the JAX package beside
the port: is the port's mean cut within the seeds' own spread of JAX's?

    python scripts/learned_gap.py --cell s2v|jumanji|runcsp [--dist BA] [--n 100]
        [--side jax|port|both] [--seeds 0 1 ...] [--iters K] [--device cpu] [--pool]

Each cell runs the quality protocol as each package's harness runs it
(JAX: `scripts/quality_table.py`'s s2v and jumanji branches; the port:
`eval/quality.py`'s `cell_dqn("s2v")` and `cell_jumanji`): trained on
`generate_graph(dist, n, seed=92000)` (S2V) or `seed=91000` (Jumanji),
evaluated greedily on `{dist}_{n}_ID0..9`. Only the trainer's seed
varies (`DQNConfig.seed`, `SpinPPOConfig.seed`). `--iters` cuts the
protocol the same way on both sides: S2V's loop steps (epsilon decays
over half of them, as in the protocol), Jumanji's PPO iterations,
RUN-CSP's epochs. RUN-CSP's cell: `RunCspConfig(seed=s)` trained on
BA_100_ID0..3, then 8 boosted predictions on each, boost i of seed s from
key / generator seed 100 + 1000 s + i; the port runs from its own initial
parameters.

The JAX side runs on the CPU only (`JAX_PLATFORMS=cpu`). The port side
runs on `cuda` unless `--device cpu`; RUN-CSP's on the CPU unless
`--device cuda`. Every cut is re-scored on the host (the spins of the
best env through `obj_maxcut` in float64; RUN-CSP's conflicts are counted
on the host) and a run stops if a reported cut differs. Each finished
seed appends one row an instance,

    cell,side,device,seed,instance,cut,seconds

to `results_quality/torch/learned_gap.csv` (seconds: the training's
seconds over the instances, as the quality table books them, plus the
instance's evaluation), and a run skips the seeds the file already holds.
The port's rows count only on the device they ran on (`--device`), so the
card's and the CPU's runs of one cell stay apart.
It prints each seed's mean over the instances, then one JSON line: each
side's per-seed means, their mean and standard deviation, the gap (port
less JAX), its standard error and the verdict: "not a fault" when |gap|
<= 2 SE, "fault" when |gap| >= 3 SE, else "undecided" (add seeds). With
fewer than 4 JAX seeds the port's spread stands for both sides
(`"se_from": "port"`). `--pool` runs nothing and prints that line for the
seeds in the file (those of `--seeds`, if given). `--arm B|C|D` (RUN-CSP,
S2V; the CPU, since it needs JAX) runs the port from JAX's initial
parameters (B), with JAX's draws injected (C), or both (D): arm D follows
JAX's run cut for cut, so the arms tell an initializer's or a sampler's
fault from the arithmetic's. `--trace` prints Jumanji's training iteration
by iteration. `tpu_row` is
`results_quality/dist_table.csv`'s first JAX run of the cell, shown for
reference only.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "results_quality", "torch", "learned_gap.csv")
HEADER = ["cell", "side", "device", "seed", "instance", "cut", "seconds"]
DQN_TRAIN_SEED, JUMANJI_TRAIN_SEED = 92000, 91000
RUNCSP_INSTANCES = [f"BA_100_ID{i}" for i in range(4)]
RUNCSP_BOOSTS = 8
NUM_IDS = 10

Rows = List[Tuple[str, float, float]]  # (instance, cut, seconds)


def cell_name(cell: str, dist: str, n: int, iters: Optional[int], arm: str = "A") -> str:
    name = "runcsp:BA_100" if cell == "runcsp" else f"{cell}:{dist}_{n}"
    return name + (f":iters{iters}" if iters else "") + ("" if arm == "A" else f":arm{arm}")


def instances(cell: str, dist: str, n: int) -> List[str]:
    return RUNCSP_INSTANCES if cell == "runcsp" else [f"{dist}_{n}_ID{i}" for i in range(NUM_IDS)]


def host_cut(graph, bits, value: float, label: str) -> float:
    """`value` after checking it against the float64 host cut of `bits`."""
    from rlsolver_tpu_torch.problems.objectives import obj_maxcut

    host = obj_maxcut(np.asarray(bits).astype(np.int64), graph)
    if host != float(value):
        raise AssertionError(f"{label} {graph.name}: reported cut {value} != host re-score {host}")
    return float(value)


def port_graph(name: str):
    from rlsolver_tpu_torch.core.generate import graph_from_name

    return graph_from_name(name)


# ------------------------------------------------------------------ JAX side
def jax_best_spins(state) -> np.ndarray:
    b = int(np.argmax(np.asarray(state.best_score)))
    return np.asarray(state.best_spins)[b] > 0


def jax_s2v(dist: str, n: int, seed: int, iters: Optional[int]) -> Rows:
    """`scripts/quality_table.py`'s s2v branch with `DQNConfig.seed = seed`;
    the greedy rollout is `DQNAgent.evaluate_scan`'s (reset key
    fold_in(PRNGKey(0), 0)), returning its final state for the re-score."""
    import jax

    from rlsolver_tpu.algos.dqn import DQNAgent, DQNConfig
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu.envs.spin_system import NUM_OBSERVABLES_S2V, RewardSignal, SpinSystemConfig, SpinSystemEnv

    cfg = SpinSystemConfig(num_envs=32, max_steps=n, reversible_spins=False, num_observables=NUM_OBSERVABLES_S2V,
                           reward_signal=RewardSignal.DENSE, norm_rewards=False)
    steps = iters or (6144 if n <= 500 else 3072)
    dcfg = DQNConfig(features=32, n_layers=2, buffer_capacity=2**12, eps_decay_steps=steps // 2, seed=seed)
    agent = DQNAgent(SpinSystemEnv(n, cfg), dcfg)
    t0 = time.time()
    params, _, _ = agent.train_scan(generate_graph(GraphType(dist), n, seed=DQN_TRAIN_SEED), steps)
    jax.block_until_ready(params)
    names = instances("s2v", dist, n)
    dt = (time.time() - t0) / len(names)
    eval_agent = DQNAgent(SpinSystemEnv(n, cfg), dcfg)
    env = eval_agent.env

    @jax.jit
    def rollout(params, params_env, k):
        state, obs = env.reset(params_env, k)

        def body(carry, _):
            state, obs = carry
            actions = eval_agent._act(params, obs, params_env.adj, env.allowed_action_mask(state),
                                      jax.random.PRNGKey(0), 0.0)
            state, obs, _, _ = env.step(params_env, state, actions)
            return (state, obs), None

        (state, _), _ = jax.lax.scan(body, (state, obs), None, length=env.max_steps)
        return state

    rows = []
    for name in names:
        t1 = time.time()
        graph = graph_from_name(name)
        state = rollout(params, env.params_from_graph(graph), jax.random.fold_in(jax.random.PRNGKey(0), 0))
        value = float(np.max(np.asarray(state.best_score)))
        rows.append((name, host_cut(port_graph(name), jax_best_spins(state), value, "jax s2v"),
                     dt + time.time() - t1))
    return rows


def jax_jumanji(dist: str, n: int, seed: int, iters: Optional[int]) -> Rows:
    """`scripts/quality_table.py`'s jumanji branch with `SpinPPOConfig.seed
    = seed`; the greedy rollout is `make_greedy_evaluator`'s (reset key
    PRNGKey(0)), returning its final state for the re-score."""
    import jax
    import jax.numpy as jnp

    from rlsolver_tpu.algos.jumanji_ppo import MPNNActorCritic, SpinPPOConfig, train_spin_ppo
    from rlsolver_tpu.config import GraphType
    from rlsolver_tpu.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu.envs.spin_system import SpinSystemConfig, SpinSystemEnv

    train_env = SpinSystemEnv(n, SpinSystemConfig(num_envs=128 if n <= 500 else 64, max_steps=min(2 * n, 256),
                                                  basin_reward=1.0 / n, stag_punishment=0.01))
    env = SpinSystemEnv(n, SpinSystemConfig(num_envs=64, basin_reward=1.0 / n, stag_punishment=0.01))
    jcfg = SpinPPOConfig(num_iters=iters or (100 if n <= 500 else 80), features=32, n_layers=2,
                         num_minibatches=1 if n <= 300 else (8 if n <= 500 else 16), seed=seed)
    t0 = time.time()
    params, _ = train_spin_ppo(train_env, generate_graph(GraphType(dist), n, seed=JUMANJI_TRAIN_SEED), jcfg)
    jax.block_until_ready(params)
    names = instances("jumanji", dist, n)
    dt = (time.time() - t0) / len(names)
    net = MPNNActorCritic(features=jcfg.features, n_layers=jcfg.n_layers)

    @jax.jit
    def rollout(params, params_env, key):
        state, obs = env.reset(params_env, key)

        def body(carry, _):
            state, obs = carry
            logits, _ = net.apply(params, obs, params_env.adj)
            actions = jnp.argmax(jnp.where(env.allowed_action_mask(state), logits, -1e9), axis=-1)
            state, obs, _, _ = env.step(params_env, state, actions)
            return (state, obs), None

        (state, _), _ = jax.lax.scan(body, (state, obs), None, length=env.max_steps)
        return state

    rows = []
    for name in names:
        t1 = time.time()
        state = rollout(params, env.params_from_graph(graph_from_name(name)), jax.random.PRNGKey(0))
        value = float(np.max(np.asarray(state.best_score)))
        rows.append((name, host_cut(port_graph(name), jax_best_spins(state), value, "jax jumanji"),
                     dt + time.time() - t1))
    return rows


def jax_runcsp(seed: int, iters: Optional[int]) -> Rows:
    import jax

    from rlsolver_tpu.algos.runcsp import ConstraintLanguage, CSPInstance, RunCspConfig, RunCspSolver
    from rlsolver_tpu.core.generate import graph_from_name

    lang = ConstraintLanguage.maxcut()
    insts = [CSPInstance.from_graph(graph_from_name(nm), lang, "NEQ") for nm in RUNCSP_INSTANCES]
    t0 = time.time()
    solver = RunCspSolver(lang, RunCspConfig(seed=seed, **({"epochs": iters} if iters else {})))
    params, _ = solver.train(insts)
    dt = (time.time() - t0) / len(insts)
    rows = []
    for name, inst in zip(RUNCSP_INSTANCES, insts):
        t1 = time.time()
        conf = min(inst.count_conflicts(solver.predict(params, inst, jax.random.PRNGKey(100 + 1000 * seed + i)))
                   for i in range(RUNCSP_BOOSTS))
        rows.append((name, float(inst.num_clauses - conf), dt + time.time() - t1))
    return rows


# ----------------------------------------------------------------- port side
def port_s2v(dist: str, n: int, seed: int, iters: Optional[int], device) -> Rows:
    from rlsolver_tpu_torch.eval.quality import cell_dqn

    names = instances("s2v", dist, n)
    graphs = [port_graph(nm) for nm in names]
    cuts, secs = cell_dqn("s2v", dist, n, graphs, device, seed=seed, steps=iters)
    return list(zip(names, cuts, secs))


def port_s2v_arm(dist: str, n: int, seed: int, iters: Optional[int], device, arm: str) -> Rows:
    """`cell_dqn("s2v")` stepped loop by loop, from JAX's initial parameters
    (arms B, D: `DQNAgent.init_params` at the key `train_scan` splits from
    PRNGKey(seed)) and/or with JAX's draws injected (arms C, D: each loop
    step's key split as `_build_loop_step` splits it; the random action is
    `jax.random.categorical` over the port's allowed mask, the coin a
    uniform, the replay indices `randint` over the ring's filled size)."""
    import jax
    import jax.numpy as jnp
    import torch

    from rlsolver_tpu.algos.dqn import DQNAgent as JAgent, DQNConfig as JConfig
    from rlsolver_tpu.config import GraphType as JGraphType
    from rlsolver_tpu.core.generate import generate_graph as j_generate_graph
    from rlsolver_tpu.envs.spin_system import SpinSystemEnv as JEnv
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.algos.dqn import ActDraws, DQNAgent, LoopDraws
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv
    from rlsolver_tpu_torch.eval.quality import dqn_configs, rescored, state_bits

    train_cfg, eval_cfg, dcfg, steps = dqn_configs("s2v", n, seed, iters)
    agent = DQNAgent(SpinSystemEnv(n, train_cfg), dcfg, device=device)
    t0 = time.time()
    step_fn, state = agent._build_loop_step(generate_graph(GraphType(dist), n, seed=DQN_TRAIN_SEED))
    key, k_init, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    if arm in ("B", "D"):
        from rlsolver_tpu.envs.spin_system import SpinSystemConfig as JSpinConfig

        # the initialisation reads only the shapes: envs, nodes, observables
        jcfg = JSpinConfig(num_envs=train_cfg.num_envs, num_observables=train_cfg.num_observables)
        jagent = JAgent(JEnv(n, jcfg), JConfig(features=dcfg.features, n_layers=dcfg.n_layers))
        jpe = jagent.env.params_from_graph(j_generate_graph(JGraphType(dist), n, seed=DQN_TRAIN_SEED))
        params = {k: v.to(agent.device) for k, v in convert.mpnn_state_dict(
            jax.tree.map(np.asarray, jagent.init_params(k_init, jpe))).items()}
        state = state._replace(params=params, target_params=params, opt_state=agent.new_opt_state(params))
    b, cap = train_cfg.num_envs, dcfg.buffer_capacity
    for _ in range(max(1, steps // 256) * 256):
        draws = None
        if arm in ("C", "D"):
            key, k_act, k_sample, _ = jax.random.split(key, 4)
            k1, k2 = jax.random.split(k_act)
            mask = jnp.asarray(agent.env.allowed_action_mask(state.env_state).cpu().numpy())
            random_a = jax.random.categorical(k1, jnp.where(mask, 0.0, -jnp.inf), axis=-1)
            u = jax.random.uniform(k2, (b,))
            idx = jax.random.randint(k_sample, (dcfg.batch_size,), 0, min(state.buf.size + b, cap))
            draws = LoopDraws(ActDraws(*(torch.from_numpy(np.array(x)) for x in (random_a, u))),
                              torch.from_numpy(np.array(idx)), None)
        state, _ = step_fn(state, draws)
    names = instances("s2v", dist, n)
    dt = (time.time() - t0) / len(names)
    eval_agent = DQNAgent(SpinSystemEnv(n, eval_cfg), dcfg, device=device)
    rows = []
    for name in names:
        t1 = time.time()
        g = port_graph(name)
        v = eval_agent.evaluate_scan(state.params, g)
        rows.append((name, rescored("s2v", g, state_bits(eval_agent.last_eval_state), v), dt + time.time() - t1))
    return rows


def port_jumanji(dist: str, n: int, seed: int, iters: Optional[int], device) -> Rows:
    from rlsolver_tpu_torch.eval.quality import cell_jumanji

    names = instances("jumanji", dist, n)
    graphs = [port_graph(nm) for nm in names]
    cuts, secs = cell_jumanji(dist, n, graphs, device, seed=seed, iters=iters)
    return list(zip(names, cuts, secs))


def jax_runcsp_arm(seed: int, cfg, arm: str, num_vars: List[int]):
    """The JAX package's pieces an arm injects into the port's RUN-CSP:
    (initial params or None, training h0s or None, predict(i, inst) h0 or
    None). h0s follow `RunCspSolver.train`'s key chain (PRNGKey(seed + 1),
    one split a step) and the boosts' keys; each is normal(key, (V, S)) *
    0.1, as `_unroll` draws it."""
    import jax
    import torch

    from rlsolver_tpu.algos.runcsp import ConstraintLanguage, CSPInstance, RunCspConfig, RunCspSolver
    from rlsolver_tpu.core.generate import graph_from_name
    from rlsolver_tpu_torch import convert

    params = h0s = boost = None
    if arm in ("B", "D"):
        lang = ConstraintLanguage.maxcut()
        inst = CSPInstance.from_graph(graph_from_name(RUNCSP_INSTANCES[0]), lang, "NEQ")
        jparams = RunCspSolver(lang, RunCspConfig(seed=seed, state_size=cfg.state_size)).init_params(inst)
        params = convert.runcsp_state_dict(jax.tree.map(np.asarray, jparams))
    if arm in ("C", "D"):
        def h0(key, v):
            return torch.from_numpy(np.array(jax.random.normal(key, (v, cfg.state_size)) * 0.1))

        key, h0s = jax.random.PRNGKey(seed + 1), []
        for _ in range(cfg.epochs):
            for v in num_vars:  # the instances round-robin
                key, k = jax.random.split(key)
                h0s.append(h0(k, v))
        boost = lambda i, nv: h0(jax.random.PRNGKey(100 + 1000 * seed + i), nv)  # noqa: E731
    return params, h0s, boost


def port_runcsp(seed: int, iters: Optional[int], device, arm: str = "A") -> Rows:
    import torch

    from rlsolver_tpu_torch.algos.runcsp import ConstraintLanguage, CSPInstance, RunCspConfig, RunCspSolver

    lang = ConstraintLanguage.maxcut()
    insts = [CSPInstance.from_graph(port_graph(nm), lang, "NEQ") for nm in RUNCSP_INSTANCES]
    cfg = RunCspConfig(seed=seed, **({"epochs": iters} if iters else {}))
    params, h0s, boost = jax_runcsp_arm(seed, cfg, arm, [i.num_vars for i in insts]) if arm != "A" else (None, None, None)
    t0 = time.time()
    solver = RunCspSolver(lang, cfg, device=device)
    params, _ = solver.train(insts, params=params, h0s=h0s)
    dt = (time.time() - t0) / len(insts)
    rows = []
    for name, inst in zip(RUNCSP_INSTANCES, insts):
        t1 = time.time()
        conf = min(inst.count_conflicts(solver.predict(
            params, inst, torch.Generator(device=solver.device).manual_seed(100 + 1000 * seed + i),
            h0=None if boost is None else boost(i, inst.num_vars))) for i in range(RUNCSP_BOOSTS))
        rows.append((name, float(inst.num_clauses - conf), dt + time.time() - t1))
    return rows


def trace_jumanji(dist: str, n: int, seed: int, iters: Optional[int], device) -> None:
    """The port's Jumanji training of one seed as `train_spin_ppo` runs it
    (the same draws in the same order), printing one JSON line an
    iteration: the rollout's best cut, its largest |value|, the PPO loss,
    the largest |parameter| and whether every parameter is finite."""
    import torch

    from rlsolver_tpu_torch.algos.jumanji_ppo import MPNNActorCritic, gae, ppo_update, spin_rollout
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv
    from rlsolver_tpu_torch.eval.quality import jumanji_configs
    from rlsolver_tpu_torch.optim import ClippedAdam

    train_cfg, _, cfg = jumanji_configs(n, seed, iters)
    env = SpinSystemEnv(n, train_cfg)
    pe = env.params_from_graph(generate_graph(GraphType(dist), n, seed=JUMANJI_TRAIN_SEED), device=device)
    net = MPNNActorCritic(env.config.num_observables, cfg.features, cfg.n_layers, seed=cfg.seed, device=device)
    optimizer = ClippedAdam(list(net.parameters()), cfg.lr, max_norm=0.5)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    for it in range(cfg.num_iters):
        batch, last_value, best_cut = spin_rollout(net, env, pe, gen)
        advs = gae(batch.rewards, batch.values, last_value, cfg.gamma, cfg.gae_lambda)
        loss = ppo_update(net, optimizer, batch, advs, advs + batch.values, pe.adj, cfg, gen)
        params = [p.detach() for p in net.parameters()]
        print(json.dumps(dict(iter=it, best_cut=float(best_cut), max_abs_value=float(batch.values.abs().max()),
                              loss=float(loss), max_abs_param=max(float(p.abs().max()) for p in params),
                              finite=all(bool(torch.isfinite(p).all()) for p in params))), flush=True)


def run_seed(args, side: str, seed: int, device: str) -> Rows:
    if side == "jax":
        if args.cell == "runcsp":
            return jax_runcsp(seed, args.iters)
        return (jax_s2v if args.cell == "s2v" else jax_jumanji)(args.dist, args.n, seed, args.iters)
    if args.cell == "runcsp":
        return port_runcsp(seed, args.iters, device, args.arm)
    if args.arm != "A":
        if args.cell != "s2v":
            raise SystemExit("the arms are RUN-CSP's and S2V's")
        return port_s2v_arm(args.dist, args.n, seed, args.iters, device, args.arm)
    return (port_s2v if args.cell == "s2v" else port_jumanji)(args.dist, args.n, seed, args.iters, device)


# ------------------------------------------------------------------- records
def read_rows(path: str, cell: str, port_device: Optional[str] = None) -> Dict[Tuple[str, int], Dict[str, float]]:
    """(side, seed) -> {instance: cut} of the cell's rows in the file (the
    port's only those run on `port_device`, when given)."""
    out: Dict[Tuple[str, int], Dict[str, float]] = {}
    if os.path.exists(path):
        with open(path) as f:
            for row in csv.DictReader(f):
                if row["cell"] == cell and (port_device is None or row["side"] == "jax"
                                            or row["device"] == port_device):
                    out.setdefault((row["side"], int(row["seed"])), {})[row["instance"]] = float(row["cut"])
    return out


def append_rows(path: str, cell: str, side: str, device: str, seed: int, rows: Rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(HEADER)
        for name, cut, secs in rows:
            w.writerow([cell, side, device, seed, name, f"{cut:.1f}", f"{secs:.2f}"])


def tpu_row(cell: str, dist: str, n: int) -> Optional[float]:
    """dist_table.csv's first JAX run of the cell, its mean over IDs 0-9."""
    if cell == "runcsp":
        return None
    first: Dict[int, float] = {}
    with open(os.path.join(REPO, "results_quality", "dist_table.csv")) as f:
        for row in csv.DictReader(f):
            if row["alg"] == cell and row["dist"] == dist and int(row["n"]) == n:
                first.setdefault(int(row["id"]), float(row["obj"]))
    return float(np.mean([first[i] for i in range(NUM_IDS)])) if len(first) >= NUM_IDS else None


def verdict(gap: float, se: float) -> str:
    if abs(gap) <= 2 * se:
        return "not a fault"
    return "fault" if abs(gap) >= 3 * se else "undecided"


def summary(per_side: Dict[str, List[float]]) -> dict:
    """Each side's per-seed means, their mean and standard deviation; with
    both sides, the gap (port less JAX), its standard error and the
    verdict. Under 4 JAX seeds the port's deviation stands for both."""
    result = {side: dict(seeds=len(v), per_seed=v, mean=float(np.mean(v)),
                         std=float(np.std(v, ddof=1)) if len(v) > 1 else None)
              for side, v in per_side.items() if v}
    if "jax" in result and "port" in result:
        nj, npo = result["jax"]["seeds"], result["port"]["seeds"]
        from_port = nj < 4
        sj = result["port"]["std"] if from_port else result["jax"]["std"]
        sp = result["port"]["std"]
        result["gap"] = result["port"]["mean"] - result["jax"]["mean"]
        if sj is not None and sp is not None:
            result["se_gap"] = float(np.sqrt(sj ** 2 / nj + sp ** 2 / npo))
            result["se_from"] = "port" if from_port else "both"
            result["verdict"] = verdict(result["gap"], result["se_gap"])
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", choices=("runcsp", "s2v", "jumanji"), required=True)
    p.add_argument("--dist", default="BA")
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--side", choices=("jax", "port", "both"), default="both")
    p.add_argument("--seeds", nargs="+", type=int, default=None, help="default: 0-7 (--pool: every seed on file)")
    p.add_argument("--iters", type=int, default=None, help="a cut protocol: loop steps, iterations or epochs")
    p.add_argument("--device", default=None, help="the port's device (default: cuda; RUN-CSP: cpu)")
    p.add_argument("--out", default=OUT)
    p.add_argument("--arm", choices="ABCD", default="A",
                   help="the port's initial params / draws: A own / own, B JAX's / own, C own / JAX's, D JAX's / JAX's")
    p.add_argument("--trace", action="store_true",
                   help="jumanji, port side: print each training iteration's figures, write no row")
    p.add_argument("--pool", action="store_true", help="run nothing: summarize the seeds on file")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    cell = cell_name(args.cell, args.dist, args.n, args.iters, args.arm)
    names = instances(args.cell, args.dist, args.n)
    device = args.device or ("cpu" if args.cell == "runcsp" else "cuda")
    sides = ("jax", "port") if args.side == "both" else (args.side,)
    if args.trace:
        for seed in args.seeds if args.seeds is not None else range(8):
            print(f"{cell} port seed {seed}", flush=True)
            trace_jumanji(args.dist, args.n, seed, args.iters, device)
        return
    if not args.pool:
        if "port" in sides and device != "cpu":
            import torch

            if not torch.cuda.is_available():
                raise SystemExit(f"the port side runs on {device}, which this machine lacks (--device cpu)")
        done = read_rows(args.out, cell, device)
        for side in sides:
            dev = "cpu" if side == "jax" else device
            for seed in args.seeds if args.seeds is not None else range(8):
                if len(done.get((side, seed), {})) == len(names):
                    continue
                t0 = time.time()
                rows = run_seed(args, side, seed, dev)
                append_rows(args.out, cell, side, dev, seed, rows)
                print(f"{cell} {side} seed {seed}: {[c for _, c, _ in rows]} mean {np.mean([c for _, c, _ in rows])}"
                      f" ({time.time() - t0:.1f} s)", flush=True)
    done = read_rows(args.out, cell, device)
    per_side = {side: [float(np.mean(list(v.values()))) for (s, seed), v in sorted(done.items())
                       if s == side and len(v) == len(names) and (args.seeds is None or seed in args.seeds)]
                for side in ("jax", "port")}
    result = {"cell": cell, "port_device": device, **summary(per_side)}
    row = tpu_row(args.cell, args.dist, args.n)
    if row is not None:
        result["tpu_row"] = row
    print(json.dumps(result))


if __name__ == "__main__":
    main()
