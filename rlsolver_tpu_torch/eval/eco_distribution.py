"""ECO-DQN at the reference's training protocol (counterpart of
`scripts/eco_distribution.py`; reference `ECO_S2V/config.py:33-83`).

One network per distribution, trained at N = 200 on a rotating pool of fresh
instances with validation-selected checkpoints (`DQNAgent.train_scan_select`,
bf16 MPNN), then inferred across every table size (50 greedy envs at
N <= 500, else 32). Defaults: 32768 loop steps x 64 envs = 2.1 M transitions
and 32768 SGD updates per distribution.

The network is kept as a pickled flax-layout tree of numpy arrays
(`{"params": {"node_init": {"kernel": ...}, ...}}`), the format of the JAX
package's `results_quality/eco_params_{dist}.pkl`, which
`convert.load_flax_pickle` reads without JAX: a committed JAX network serves
as a checkpoint (`--params`), and the port's own go to
`results_quality/torch/eco_params_{dist}.pkl` (`--ckpt`). `--params` is only
read, never written.

Appends `eco` rows to `--out` and marks each finished (dist, N) in `--done`,
so a fresh process resumes at the first unfinished size.

    python scripts/torch_eco_distribution.py [--dists BA,PL,ER] [--sizes ...]
        [--params results_quality/eco_params_{dist}.pkl] [--loop-steps 32768] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import List, Optional

import numpy as np

from rlsolver_tpu_torch.eval import quality

CKPT = os.path.join("results_quality", "torch", "eco_params_{dist}.pkl")
POOL_SEED, VAL_SEED, NUM_VAL = 95000, 96000, 5


def dqn_config(loop_steps: int, features: int = 64, n_layers: int = 3):
    import torch

    from rlsolver_tpu_torch.algos.dqn import DQNConfig

    return DQNConfig(
        features=features,
        n_layers=n_layers,
        lr=1e-4,
        gamma=0.95,
        buffer_capacity=2**15,
        batch_size=128,
        update_frequency=1,  # 1 SGD step per vector step of the envs
        # the reference syncs every 4000 env steps / UPDATE_FREQUENCY = 32,
        # i.e. every 125 updates; 250 here (1 update per 64 transitions)
        target_update_frequency=250,
        eps_start=1.0,
        eps_end=0.05,
        eps_decay_steps=int(0.8 * loop_steps),
        learning_starts=1024,
        dtype=torch.bfloat16,
        seed=3,
    )


def train_config(train_nodes: int, train_envs: int):
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig

    return SpinSystemConfig(num_envs=train_envs, max_steps=2 * train_nodes,  # the reference's full episodes
                            basin_reward=1.0 / train_nodes, stag_punishment=0.01)


def eval_config(n: int):
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemConfig

    return SpinSystemConfig(num_envs=50 if n <= 500 else 32,  # the reference's NUM_INFERENCE_ENVS
                            basin_reward=1.0 / n, stag_punishment=0.01)


def flax_tree(state_dict) -> dict:
    """A state dict {"a.b.kernel": tensor} as the flax tree {"params": {"a":
    {"b": {"kernel": ndarray}}}}: the inverse of `convert.flax_state_dict`."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value.detach().float().cpu().numpy()
    return {"params": tree}


def save_params(state_dict, path: str) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(flax_tree(state_dict), f)


def load_params(path: str, device):
    from rlsolver_tpu_torch import convert

    return {k: v.to(device) for k, v in convert.mpnn_state_dict(convert.load_flax_pickle(path)).items()}


def done_cells(path: str) -> set:
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return {tuple(line.split()) for line in f.read().splitlines() if line}


def mark_done(path: str, dist: str, n: int) -> None:
    with open(path, "a") as f:
        f.write(f"{dist} {n}\n")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dists", default="BA,PL,ER")
    p.add_argument("--sizes", default="100,200,300,400,500,600,700,800,900,1000")
    p.add_argument("--ids", type=int, default=10)
    p.add_argument("--train-nodes", type=int, default=200)
    p.add_argument("--train-envs", type=int, default=64)
    p.add_argument("--pool", type=int, default=48)
    p.add_argument("--loop-steps", type=int, default=int(os.environ.get("ECO_LOOP_STEPS", 32768)))
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=3)
    p.add_argument("--segments", type=int, default=16)
    p.add_argument("--out", default=quality.OUT)
    p.add_argument("--done", default=None, help="default: <out without .csv>_eco_done.txt")
    p.add_argument("--ckpt", default=CKPT, help="the port's networks, {dist} filled in: loaded if present, else "
                                               "trained and written")
    p.add_argument("--params", default=None, help="networks to infer with instead, {dist} filled in (e.g. the JAX "
                                                 "package's results_quality/eco_params_{dist}.pkl); never written")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from rlsolver_tpu_torch.algos.dqn import DQNAgent
    from rlsolver_tpu_torch.config import GraphType
    from rlsolver_tpu_torch.core.generate import generate_graph, graph_from_name
    from rlsolver_tpu_torch.device import resolve_device
    from rlsolver_tpu_torch.envs.spin_system import SpinSystemEnv

    device = resolve_device(args.device)
    done_path = args.done or os.path.splitext(args.out)[0] + "_eco_done.txt"
    sizes = [int(s) for s in args.sizes.split(",")]
    ntr = args.train_nodes
    dcfg = dqn_config(args.loop_steps, args.features, args.n_layers)
    quality.ensure_csv(args.out)
    done = done_cells(done_path)

    for dist in args.dists.split(","):
        gt = GraphType(dist)
        ckpt = (args.params or args.ckpt).format(dist=dist)
        if args.params or os.path.exists(ckpt):
            params = load_params(ckpt, device)
            t_train = 0.0
            print(f"== {dist}: loaded trained params from {ckpt}", flush=True)
        else:
            pool = [generate_graph(gt, ntr, seed=POOL_SEED + i) for i in range(args.pool)]
            val = [generate_graph(gt, ntr, seed=VAL_SEED + i) for i in range(NUM_VAL)]
            agent = DQNAgent(SpinSystemEnv(ntr, train_config(ntr, args.train_envs)), dcfg, device=device)
            print(f"== {dist}: training at N={ntr} ({args.loop_steps} loop steps x {args.train_envs} envs = "
                  f"{args.loop_steps * args.train_envs / 1e6:.1f}M transitions, {args.pool}-graph pool, bf16 MPNN)",
                  flush=True)
            t0 = time.time()
            params, hist = agent.train_scan_select(pool, args.loop_steps, val, num_segments=args.segments,
                                                   verbose=True)
            t_train = time.time() - t0
            print(f"== {dist}: trained in {t_train:.0f}s; val history {hist}", flush=True)
            save_params(params, ckpt)

        for n in sizes:
            if (dist, str(n)) in done:
                continue
            eval_agent = DQNAgent(SpinSystemEnv(n, eval_config(n)), dcfg, device=device)
            t0 = time.time()
            try:
                vals = []
                for i in range(args.ids):
                    g = graph_from_name(f"{dist}_{n}_ID{i}")
                    v = eval_agent.evaluate_scan(params, g)
                    vals.append(quality.rescored("eco", g, quality.state_bits(eval_agent.last_eval_state), v))
            except Exception as e:
                print(f"!! {dist}_{n} eco failed: {e!r}", flush=True)
                if quality.context_lost(e):
                    print("!! CUDA context lost - exiting for a fresh process to resume", flush=True)
                    raise SystemExit(quality.EXIT_CONTEXT_LOST)
                continue
            dt = (time.time() - t0) / args.ids + t_train / (len(sizes) * args.ids)
            for i, v in enumerate(vals):
                quality.append_row(args.out, dist, n, i, "eco", v, dt)
            mark_done(done_path, dist, n)
            print(f"{dist}_{n} eco: avg {np.mean(vals):.1f} ({(time.time() - t0):.0f}s)", flush=True)
    print("done", flush=True)
    return 0
