"""The slice as a whole: one MCPG round with injected randomness through
both packages, MCPG solves on the CPU against JAX's cut spread, the CLI,
and the device rule of the entry points."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import mcpg as jm
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.ops.pallas import mcpg_sweep as jsw
from rlsolver_tpu.ops.pallas import mh_sampler as jmh
from rlsolver_tpu.ops.sweeps import SweepData as JSweepData
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import mcpg as tm
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.models.policy import BernoulliPolicy
from rlsolver_tpu_torch.ops import cut as tcut
from rlsolver_tpu_torch.ops.sweeps import SweepData
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as tsw
from rlsolver_tpu_torch.ops.kernels import mh_sampler as tmh
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as twsw
from rlsolver_tpu_torch.ops.kernels.engine import FlipSweepEngine, FusedSweepEngine
from rlsolver_tpu_torch.problems.objectives import obj_maxcut
from rlsolver_tpu_torch.run import main as cli_main

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_injected_round_matches_jax():
    name, C, R, S, rounds = "BA_100_ID0", 16, 8, 2, 20
    jg, tg = j_graph_from_name(name), graph_from_name(name)
    n, B = jg.num_nodes, C * R
    cfg_j = jm.MCPGConfig(total_mcmc_num=C, repeat_times=R, num_ls=S)
    jenv = JEnv(jg)
    policy, optimizer, _, j_reduce, j_update = jm._build_steps(jenv, JSweepData.build(jg), cfg_j)
    tenv = MaxcutEnv(tg, "cpu")
    t_steps = tm._build_steps(tenv, None, tm.MCPGConfig(total_mcmc_num=C, repeat_times=R, num_ls=S,
                                                        sweep_mode="packed"))
    rng = np.random.default_rng(0)

    # a JAX update on random samples first, so that params and Adam state
    # are not at their zero start; then carry both across
    params = policy.init(jax.random.PRNGKey(0))
    opt_state = optimizer.init(params)
    warm_bits = rng.random((B, n)) < 0.5
    params, opt_state = j_update(params, opt_state, jnp.asarray(warm_bits),
                                 jenv.obj(jnp.asarray(warm_bits)))
    t_policy, t_opt = tm.new_policy(n, tm.MCPGConfig(), "cpu")
    t_policy.load_state_dict(convert.policy_state_dict(jax.tree.map(np.asarray, params)))
    t_opt.load_state_dict(convert.adam_state(jax.tree.map(np.asarray, opt_state)))
    torch.testing.assert_close(t_policy().detach(), torch.from_numpy(np.array(policy.apply(params))),
                               rtol=1e-6, atol=0)

    # the round: JAX's stream and noise through K2 and K4 in both packages
    key = jax.random.PRNGKey(1)
    probs = policy.apply(params)
    start = rng.random((B, n)) < 0.5
    best_xs = rng.random((C, n)) < 0.5
    best_vs = np.asarray(jenv.obj(jnp.asarray(best_xs)))
    noise = rng.integers(0, 65536, (S * n, B)).astype(np.int32)
    stream = np.array(jmh.make_proposal_stream(key, rounds, B, probs))

    j_mh = jmh.mh_reference_stream(key, probs, jnp.asarray(start), rounds)
    j_tables = jsw.PackedSweepTables.build(jg)
    j_ls = jsw.mcpg_sweep_reference(jnp.asarray(noise), j_mh, j_tables, jg, num_sweeps=S)
    j_cuts = jenv.obj(j_ls)
    j_best = j_reduce(j_ls, j_cuts, jnp.asarray(best_xs), jnp.asarray(best_vs))
    params, opt_state = j_update(params, opt_state, j_mh, j_cuts)

    t_mh = tmh.mh_sample_stream(torch.from_numpy(stream), torch.from_numpy(start))
    t_tables = tsw.PackedSweepTables.build(tg, "cpu")
    t_ls = tsw.mcpg_sweep_packed(torch.from_numpy(noise), t_mh, t_tables, num_sweeps=S)
    t_cuts = tenv.obj(t_ls)
    t_best = t_steps.reduce_step(t_ls, t_cuts, torch.from_numpy(best_xs.copy()), torch.from_numpy(best_vs.copy()))
    t_steps.update_step(t_policy, t_opt, t_mh, t_cuts)

    np.testing.assert_array_equal(t_mh.numpy(), np.asarray(j_mh))
    np.testing.assert_array_equal(t_ls.numpy(), np.asarray(j_ls))
    np.testing.assert_array_equal(t_cuts.numpy(), np.asarray(j_cuts))
    for a, b in zip(t_best, j_best):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # f32 sums in another order (the loss is formed from value @ bits):
    # params agree to 1e-6 relative after the 8 Adam steps
    np.testing.assert_allclose(t_policy.logits.detach().numpy(),
                               np.asarray(params["params"]["logits"]), rtol=1e-6, atol=1e-7)
    adam = convert.adam_state(jax.tree.map(np.asarray, opt_state))
    assert t_opt.count == adam["count"] == 2 * cfg_j.sample_epoch_num
    np.testing.assert_allclose(t_opt.mu[0].numpy(), adam["mu"][0].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_opt.nu[0].numpy(), adam["nu"][0].numpy(), rtol=1e-5, atol=1e-9)


SMALL = dict(total_mcmc_num=8, repeat_times=4, num_ls=1, max_epoch_num=1, reset_epoch_num=8,
             sample_epoch_num=8, warmup_ls_rounds=0)


def test_solve_lands_within_jax_spread():
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    j_cuts = [jm.solve_maxcut_mcpg(jg, jm.MCPGConfig(seed=s, **SMALL))[1] for s in range(4)]
    t_cuts = []
    for s in range(4):
        x, v, _ = tm.solve_maxcut_mcpg(tg, tm.MCPGConfig(seed=s, **SMALL), device="cpu")
        assert v == obj_maxcut(x.astype(np.int64), tg)
        t_cuts.append(v)
    # seeds do not carry across generators: compare the cut distributions
    assert min(j_cuts) <= np.mean(t_cuts) <= max(j_cuts), (t_cuts, j_cuts)


@pytest.mark.parametrize("sampler", ["fused", "budgeted"])
def test_solve_packed_paths_on_cpu(sampler):
    tg = graph_from_name("BA_100_ID0")
    cfg = tm.MCPGConfig(seed=1, sampler=sampler, sweep_mode="packed", **SMALL)
    x, v, ev = tm.solve_maxcut_mcpg(tg, cfg, device="cpu")
    assert v == obj_maxcut(x.astype(np.int64), tg) and v >= 250
    assert len(ev.records) == 2  # the start and one round


def test_cli_runs_on_cpu():
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "rlsolver_tpu_torch", "--alg", "mcpg", "--graphs", "BA_100_ID0",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("mcpg BA_100_ID0: obj=")


def test_cli_rejects_algs_not_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli_main(["--alg", "milp", "--graphs", "BA_100_ID0", "--device", "cpu"])


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.solve_maxcut_mcpg(graph_from_name("BA_20_ID0"), tm.MCPGConfig(**SMALL))


# public builders that put tensors on a device: `cuda` unless told "cpu"
BUILDERS = {
    "MaxcutEnv": lambda g, dev: MaxcutEnv(g, dev).cg.adj,
    "CutGraph.build": lambda g, dev: tcut.CutGraph.build(g, dev).w,
    "SweepData.build": lambda g, dev: SweepData.build(g, dev).nbrs,
    "PackedSweepTables.build": lambda g, dev: tsw.PackedSweepTables.build(g, dev).masks,
    "pack_adjacency": lambda g, dev: tsw.pack_adjacency(g, dev).pos,
    "BernoulliPolicy": lambda g, dev: BernoulliPolicy(g.num_nodes, device=dev).logits,
    "WeightedSweepTables.build": lambda g, dev: twsw.WeightedSweepTables.build(g, dev).planes,
    "WeightedAdjPlanes.build": lambda g, dev: twsw.WeightedAdjPlanes.build(g, dev).planes,
    "FusedSweepEngine.build": lambda g, dev: FusedSweepEngine.build(g, dev).tables.nodes,
    "FlipSweepEngine.build": lambda g, dev: FlipSweepEngine.build(g, dev).tables.pos,
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    g = graph_from_name("BA_20_ID0")
    assert BUILDERS[name](g, "cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BUILDERS[name](g, None)
