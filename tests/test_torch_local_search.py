"""Port parity for the parallel local-search solver: `evolutionary_replacement`
with JAX's donors, the solve against JAX's cut spread, the CLI for
`--alg local_search` and `--alg l2a` on the CPU, and the device rule of the
new entry points."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos.local_search_solver import LocalSearchConfig as JConfig
from rlsolver_tpu.algos.local_search_solver import solve_maxcut_local_search as j_solve
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.ops.reductions import evolutionary_replacement as j_replace
from rlsolver_tpu_torch.algos import l2a as tl2a
from rlsolver_tpu_torch.algos.local_search_solver import LocalSearchConfig, solve_maxcut_local_search
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.models.transformer import GraphEncoder, PolicyTrsWithValue
from rlsolver_tpu_torch.ops.reductions import evolutionary_replacement
from rlsolver_tpu_torch.problems.objectives import obj_maxcut
from rlsolver_tpu_torch.run import PORTED_ALGS
from rlsolver_tpu_torch.run import main as cli_main

torch.set_num_threads(1)


@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_evolutionary_replacement_bit_exact_with_jax_donors(maximize, ties):
    rng = np.random.default_rng(int(maximize) + 2 * int(ties))
    num_sims, n, low_k = 24, 10, 5
    xs = rng.random((num_sims, n)) < 0.5
    vs = (rng.integers(0, 6, num_sims) if ties else rng.permutation(num_sims)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j_xs, j_vs = j_replace(key, jnp.asarray(xs), jnp.asarray(vs), low_k, maximize)
    donors = torch.from_numpy(np.array(jax.random.randint(key, (low_k,), 0, num_sims - low_k))).long()
    t_xs, t_vs = evolutionary_replacement(None, torch.from_numpy(xs), torch.from_numpy(vs), low_k, maximize,
                                          donors=donors)
    np.testing.assert_array_equal(t_xs.numpy(), np.asarray(j_xs))
    np.testing.assert_array_equal(t_vs.numpy(), np.asarray(j_vs))


def test_evolutionary_replacement_draws_donors_among_the_best():
    vs = torch.arange(16, dtype=torch.float32)
    xs = torch.arange(16)[:, None].repeat(1, 3) > 7
    new_xs, new_vs = evolutionary_replacement(torch.Generator().manual_seed(0), xs, vs, 4)
    assert bool((new_vs[:4] >= 4).all()) and torch.equal(new_vs[4:], vs[4:])
    assert torch.equal(new_xs[4:], xs[4:]) and torch.equal(vs, torch.arange(16, dtype=torch.float32))


LS = dict(num_sims=64, num_iters=4, ls_iters=4)


def test_solve_local_search_within_jax_spread():
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    j_cuts = [j_solve(jg, JConfig(seed=s, **LS))[1] for s in range(8)]
    t_cuts = []
    for s in range(8):
        x, v, ev = solve_maxcut_local_search(tg, LocalSearchConfig(seed=s, **LS), device="cpu")
        assert v == obj_maxcut(x.astype(np.int64), tg)
        assert len(ev.records) == 2  # the start and iteration 4
        t_cuts.append(v)
    # seeds do not carry across generators: compare the cut distributions
    assert min(j_cuts) <= np.mean(t_cuts) <= max(j_cuts), (t_cuts, j_cuts)


def test_solve_local_search_packed_sweep_on_cpu():
    tg = graph_from_name("BA_100_ID0")
    x, v, _ = solve_maxcut_local_search(tg, LocalSearchConfig(seed=1, packed_sweep=True, **LS), device="cpu")
    assert v == obj_maxcut(x.astype(np.int64), tg) and v >= 270


SMALL_L2A = dict(num_sims=16, num_repeats=4, top_k=8, num_searchers=1, seq_len=4, num_iters=2, embed_dim=32,
                 pretrain_steps=30, update_times=4, ls_iters=2)


@pytest.mark.parametrize("fast", [False, True], ids=["plain", "fast"])
@pytest.mark.parametrize("alg", ["local_search", "l2a"])
def test_cli_runs_on_cpu(alg, fast, capsys, monkeypatch):
    # L2A's default config takes minutes on one CPU thread: the CLI runs it
    # at a small one here (chip_smoke.py runs the default on the card)
    monkeypatch.setattr(tl2a, "L2AConfig", functools.partial(tl2a.L2AConfig, **SMALL_L2A))
    argv = ["--alg", alg, "--graphs", "BA_100_ID0", "--device", "cpu"] + (["--fast"] if fast else [])
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{alg} BA_100_ID0: obj=") and float(out.split("obj=")[1].split()[0]) >= 270


def test_cli_lists_the_ported_algs():
    assert PORTED_ALGS == ("mcpg", "local_search", "l2a", "greedy", "sa", "ga", "random_walk", "sdp", "bls", "isco",
                           "pignn")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli_main(["--alg", "vqe", "--graphs", "BA_100_ID0", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="--problem mis: isco"):
        cli_main(["--problem", "mis", "--alg", "greedy", "--graphs", "BA_100_ID0", "--device", "cpu"])


ENTRY_POINTS = {
    "solve_maxcut_local_search": lambda g, dev: solve_maxcut_local_search(
        g, LocalSearchConfig(num_sims=4, num_iters=1), device=dev)[1],
    "solve_maxcut_l2a": lambda g, dev: tl2a.solve_maxcut_l2a(
        g, tl2a.L2AConfig(**dict(SMALL_L2A, num_sims=4, num_iters=1, seq_len=1, pretrain_steps=1)), device=dev)[1],
    "GraphEncoder": lambda g, dev: GraphEncoder(g.num_nodes, 8, 2, device=dev).inp.fc0.kernel.device.type,
    "PolicyTrsWithValue": lambda g, dev: PolicyTrsWithValue(8, 2, device=dev).cell.mix.kernel.device.type,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    g = graph_from_name("BA_20_ID0")
    assert ENTRY_POINTS[name](g, "cpu") is not None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](g, None)
