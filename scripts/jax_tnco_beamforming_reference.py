"""The JAX package's TNCO MCPG, beamforming training and flip-MDP PPO runs
on the CPU, which `chip_smoke.py`'s `tnco`, `beamforming` and `ppo` phases
hold the port to.

    JAX_PLATFORMS=cpu python scripts/jax_tnco_beamforming_reference.py

Prints one JSON object: for seeds 0-2, `solve_tnco_mcpg`'s final best
log10 cost at `random_circuit_nodes(12, 14, seed=0)` (101 tensors, 166
bonds) with `TncoMcpgConfig(sampler="scan", seed=s)` (its defaults: 32
chains x 4 repeats, 64 MH rounds, 4 local-search iterations, 30 rounds),
and `train_beamforming`'s final rate (the mean of the last 10 history
entries) at `BeamformingSpec()` and `BeamformingTrainConfig(seed=s)` (4
users x 4 antennas, batch 256, episode 6, 300 steps), and `train_ppo` on
G22-like (`bench.py`'s stand-in for Gset G22, rebuilt from the port's
`gnm_edges` so that both packages see the same graph) at `PPOConfig(seed=s)`
(128 envs x 64 steps, 4 minibatches x 4 epochs, 100 iterations): the mean
over its first PPO_ITERS iterations (the depth `chip_smoke.py` runs) of the
envs' mean cut and of the mean reward a step, the same over all 100, and
how far the policy moved in those PPO_ITERS iterations: on the start
observations (the 128 envs' reset bits), the mean KL(pi_40 || pi_0) and
the mean entropy of pi_0 less that of pi_40 (`policy_movement`).
"""

import _bootstrap  # noqa: F401  (sys.path + backend repair)

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from rlsolver_tpu.algos.ppo import MLPActorCritic, PPOConfig, init_ppo_state, make_ppo_iteration
from rlsolver_tpu.algos.tnco_solver import TncoMcpgConfig, solve_tnco_mcpg
from rlsolver_tpu.envs.flip_mdp import FlipMdpEnv
from rlsolver_tpu.envs.tnco import TensorNetwork, TncoEnv, random_circuit_nodes
from rlsolver_tpu.problems.beamforming import BeamformingSpec, BeamformingTrainConfig, train_beamforming

SEEDS = (0, 1, 2)
PPO_ITERS = 40


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    env = TncoEnv(TensorNetwork.from_nodes_list(*random_circuit_nodes(12, 14, seed=0)))
    out = {"tnco": [], "tnco_seconds": [], "beamforming": [], "beamforming_seconds": []}
    for s in SEEDS:
        t0 = time.time()
        _, cost, _ = solve_tnco_mcpg(env, TncoMcpgConfig(sampler="scan", seed=s))
        out["tnco"].append(cost)
        out["tnco_seconds"].append(time.time() - t0)
    for s in SEEDS:
        t0 = time.time()
        _, _, history = train_beamforming(BeamformingSpec(), BeamformingTrainConfig(seed=s))
        out["beamforming"].append(float(np.mean(history[-10:])))
        out["beamforming_seconds"].append(time.time() - t0)
    out.update(ppo_mean_cut=[], ppo_mean_reward=[], ppo_mean_cut_100=[], ppo_mean_reward_100=[], ppo_seconds=[],
               ppo_kl_from_start=[], ppo_entropy_drop=[])
    g = g22_like()
    for s in SEEDS:
        t0 = time.time()
        cfg = PPOConfig(seed=s)
        env = FlipMdpEnv(g, horizon=cfg.horizon)
        model = MLPActorCritic(g.num_nodes)
        optimizer, iteration = make_ppo_iteration(env, model, cfg)
        state = init_ppo_state(env, model, optimizer, cfg, cfg.num_envs)
        obs0, params0 = state.obs, state.params
        step = jax.jit(iteration)
        history = []
        for i in range(cfg.num_iterations):  # as `train_ppo` runs them
            state, metrics = step(state)
            history.append({k: float(v) for k, v in metrics.items()})
            if i + 1 == PPO_ITERS:
                kl, drop = policy_movement(model, params0, state.params, obs0)
                out["ppo_kl_from_start"].append(kl)
                out["ppo_entropy_drop"].append(drop)
        out["ppo_mean_cut"].append(float(np.mean([h["mean_cut"] for h in history[:PPO_ITERS]])))
        out["ppo_mean_reward"].append(float(np.mean([h["mean_reward"] for h in history[:PPO_ITERS]])))
        out["ppo_mean_cut_100"].append(float(np.mean([h["mean_cut"] for h in history])))
        out["ppo_mean_reward_100"].append(float(np.mean([h["mean_reward"] for h in history])))
        out["ppo_seconds"].append(time.time() - t0)
    print(json.dumps(out))


def policy_movement(model, params0, params, obs):
    """(mean KL(pi || pi_0), mean entropy of pi_0 less that of pi) over the
    rows of obs, pi_0 and pi the policies of params0 and params."""
    lp0 = jax.nn.log_softmax(model.apply(params0, obs)[0], axis=-1)
    lp = jax.nn.log_softmax(model.apply(params, obs)[0], axis=-1)
    kl = jnp.mean(jnp.sum(jnp.exp(lp) * (lp - lp0), axis=-1))
    ent0 = -jnp.mean(jnp.sum(jnp.exp(lp0) * lp0, axis=-1))
    ent = -jnp.mean(jnp.sum(jnp.exp(lp) * lp, axis=-1))
    return float(kl), float(ent0 - ent)


def g22_like():
    """The port's `build_g22_like()` (2000 nodes, 19990 unit edges) as a
    graph of the JAX package."""
    from rlsolver_tpu.core.graph import Graph
    from rlsolver_tpu_torch.core.generate import build_g22_like

    g = build_g22_like()
    return Graph.from_edge_list(g.num_nodes, [(int(a), int(b), 1.0) for a, b in g.edges.tolist()], name="G22like")


if __name__ == "__main__":
    main()
