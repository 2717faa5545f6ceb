"""Port parity: the bit-plane tables and the plain versions of K6, K7, K8a
and K8b, the engine's choice of kernel, and MCPG `--fast` on integer
weights. Tables equal JAX's word for word (without the TPU's lane padding,
which holds only zeros); the sweeps fed JAX's noise are bit-exact with
`mcpg_sweep_reference` and the Pallas kernels in interpret mode, resident and
node-chunked; the 1-flip sweeps (K8a, and K8b against JAX's node-chunked
kernel) are bit-exact with the Pallas kernels and both packages' f32
sweeps. All sums are integers: every comparison is exact."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.graph import Graph as JGraph
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.ops.pallas import mcpg_sweep as jsw
from rlsolver_tpu.ops.pallas import weighted_sweep as jwsw
from rlsolver_tpu_torch.algos.mcpg import MCPGConfig, solve_maxcut_mcpg
from rlsolver_tpu_torch.core.generate import build_d2000_like, build_g22_like, build_w22_like, build_w70_like, gnm_edges
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.ops.kernels import build, engine
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as tsw
from rlsolver_tpu_torch.ops.kernels import philox
from rlsolver_tpu_torch.ops.kernels import weighted_sweep as twsw
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weighted_edges(n, seed, w_max, signed):
    """The edges of the JAX package's `weighted_graph` test instances."""
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for j in rng.choice(n, size=4, replace=False):
            if i < j:
                w = int(rng.integers(1, w_max + 1))
                if signed and rng.random() < 0.4:
                    w = -w
                edges.append((i, int(j), float(w)))
    return edges


def _pair(n, seed, w_max, signed):
    e = _weighted_edges(n, seed, w_max, signed)
    name = f"W{n}"
    return JGraph.from_edge_list(n, e, name=name), Graph.from_edge_list(n, e, name=name)


# (N, seed, w_max, signed): JAX's shapes, signed and unsigned, w_max 3-7
CASES = [(72, 3, 5, True), (40, 7, 6, False), (56, 9, 7, True), (96, 21, 4, True), (64, 23, 3, False)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"N{c[0]}w{c[2]}{'s' if c[3] else 'u'}")
def case(request):
    jg, tg = _pair(*request.param)
    return jg, tg, jwsw.WeightedSweepTables.build(jg), twsw.WeightedSweepTables.build(tg, "cpu")


def _same_words(port: torch.Tensor, jax_words) -> None:
    j = np.asarray(jax_words)
    w = port.shape[-1]
    np.testing.assert_array_equal(port.numpy(), j[..., :w])
    assert not j[..., w:].any()  # the JAX lane padding holds nothing


def test_tables_match_jax(case):
    jg, tg, jt, tt = case
    assert tt.k == len(jt.planes_pos) and tt.signed == bool(jt.planes_neg)
    _same_words(tt.earlier, jt.earlier)
    assert len(tt.planes_pos) == len(jt.planes_pos) and len(tt.planes_neg) == len(jt.planes_neg)
    for p, q in zip(tt.planes_pos + tt.planes_neg, jt.planes_pos + jt.planes_neg):
        _same_words(p, q)
    np.testing.assert_array_equal(tt.nodes.numpy(), np.asarray(jt.nodes))
    np.testing.assert_array_equal(tt.thr1.numpy(), np.asarray(jt.thr1))
    np.testing.assert_array_equal(tt.thr2.numpy(), np.asarray(jt.thr2))
    ja = jwsw.WeightedAdjPlanes.build(jg)
    ta = twsw.WeightedAdjPlanes.build(tg, "cpu")
    assert len(ta.planes_pos) == len(ja.planes_pos) and len(ta.planes_neg) == len(ja.planes_neg)
    for p, q in zip(ta.planes_pos + ta.planes_neg, ja.planes_pos + ja.planes_neg):
        _same_words(p, q)
    np.testing.assert_array_equal(ta.wdeg.numpy(), tg.adjacency_dense().sum(axis=1).astype(np.int32))


def _bits_noise(n, b, sweeps, seed):
    rng = np.random.default_rng(seed)
    return rng.random((b, n)) < 0.5, rng.integers(0, 65536, (sweeps * n, b)).astype(np.int32)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_k6_plain_bit_exact_vs_jax(case, sweeps):
    jg, tg, jt, tt = case
    n, b = jg.num_nodes, 16
    bits, noise = _bits_noise(n, b, sweeps, sweeps)
    ref = np.asarray(jsw.mcpg_sweep_reference(jnp.asarray(noise), jnp.asarray(bits), jt, jg, num_sweeps=sweeps))
    out = twsw.mcpg_sweep_weighted(torch.from_numpy(noise), torch.from_numpy(bits), tt, num_sweeps=sweeps).numpy()
    np.testing.assert_array_equal(out, ref)
    if sweeps == 2:  # one interpret-mode run per graph keeps the file quick
        pallas = jwsw.mcpg_sweep_weighted(jnp.asarray(noise), jnp.asarray(bits), jt, num_sweeps=sweeps,
                                          block_chains=b, interpret=True)
        np.testing.assert_array_equal(out, np.asarray(pallas))


def test_k7_chunked_wrapper_matches_jax_chunked_kernel():
    jg, tg = _pair(96, 21, 4, True)
    jt, tt = jwsw.WeightedSweepTables.build(jg), twsw.WeightedSweepTables.build(tg, "cpu")
    n, b, sweeps = 96, 16, 2
    bits, noise = _bits_noise(n, b, sweeps, 8)
    chunked = jwsw.mcpg_sweep_weighted(jnp.asarray(noise), jnp.asarray(bits), jt, num_sweeps=sweeps,
                                       block_chains=b, node_chunk=24, interpret=True)
    out = twsw.mcpg_sweep_weighted(torch.from_numpy(noise), torch.from_numpy(bits), tt, num_sweeps=sweeps,
                                   node_chunk=24)
    np.testing.assert_array_equal(out.numpy(), np.asarray(chunked))
    with pytest.raises(ValueError, match="node_chunk"):
        twsw.mcpg_sweep_weighted(torch.from_numpy(noise), torch.from_numpy(bits), tt, num_sweeps=sweeps,
                                 node_chunk=0)


@pytest.mark.parametrize("node_chunk", [None, 16])
def test_k8_plain_bit_exact_vs_jax(case, node_chunk):
    jg, tg, _, _ = case
    n, b = jg.num_nodes, 16
    bits = np.random.default_rng(5).random((b, n)) < 0.5
    pallas = jwsw.sweep_1flip_weighted(jnp.asarray(bits), jwsw.WeightedAdjPlanes.build(jg), block_chains=b,
                                       node_chunk=node_chunk if n % 16 == 0 else None, interpret=True)
    jenv = JEnv(jg, dtype=jnp.float32)
    j_bits, _ = jenv.sweep_1flip(jnp.asarray(bits), jenv.obj(jnp.asarray(bits)))
    # JAX's node-chunked kernel is K8b's TPU counterpart
    out = twsw.sweep_1flip_weighted(torch.from_numpy(bits), twsw.WeightedAdjPlanes.build(tg, "cpu"),
                                    levels=node_chunk is not None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_bits))


def test_k6_fused_draws_the_philox_noise(case):
    # the fused sweep is the injected one fed draw t = s*N + k of each chain
    _, tg, _, tt = case
    n, b, s, seed = tg.num_nodes, 24, 2, 91
    bits = torch.from_numpy(np.random.default_rng(4).random((b, n)) < 0.5)
    chains = torch.arange(b)
    noise = torch.stack([philox.philox_block(seed, philox.TAG_SWEEP, t >> 2, chains)[t & 3] & 0xFFFF
                         for t in range(s * n)]).to(torch.int32)
    fused = twsw.mcpg_sweep_weighted_fused(seed, bits, tt, num_sweeps=s)
    assert torch.equal(fused, twsw.mcpg_sweep_weighted(noise, bits, tt, num_sweeps=s))
    assert torch.equal(fused, twsw.mcpg_sweep_weighted_fused(seed, bits, tt, num_sweeps=s, node_chunk=8))
    assert not torch.equal(fused, twsw.mcpg_sweep_weighted_fused(seed + 1, bits, tt, num_sweeps=s))


def _pm1_graph():
    rng = np.random.default_rng(11)
    e = [(a, b, -1.0 if rng.random() < 0.5 else 1.0) for a, b, _ in _weighted_edges(64, 3, 1, False)]
    return Graph.from_edge_list(64, e, name="signed64")


def test_fused_k6_equals_fused_k4_on_a_pm1_graph():
    g = _pm1_graph()
    tw, tp = twsw.WeightedSweepTables.build(g, "cpu"), tsw.PackedSweepTables.build(g, "cpu")
    assert tw.k == 1 and tw.signed and tp.signed
    np.testing.assert_array_equal(tw.thr1.numpy(), tp.thr1.numpy())
    bits = torch.from_numpy(np.random.default_rng(12).random((32, 64)) < 0.5)
    for seed in (5, 6):
        k4 = tsw.mcpg_sweep_fused(seed, bits, tp, num_sweeps=3)
        assert torch.equal(twsw.mcpg_sweep_weighted_fused(seed, bits, tw, num_sweeps=3), k4)


def test_engine_choices_with_the_h100_l2():
    """The engine's choices on the smoke run's graphs, from sizes alone:
    G22-like K4/K5; W22-like K6 (a tile of 128 chains of 63 words, 32 KB,
    leaves 7 tiles per SM) and K8b (20 neighbours a node, below the 80 from
    which K8a was the faster); W70-like K7 (a tile of 313 words leaves one
    per SM) with the engine's list stage, and K8b (2 neighbours a node);
    D2000-like K8a (200 neighbours a node, 3.6 MB of word entries)."""
    l2 = engine.H100_L2_BYTES
    g22, w22, w70, d2000 = build_g22_like(), build_w22_like(), build_w70_like(), build_d2000_like()
    assert engine.plan_sweep(g22, l2) == (False, None)
    assert engine.plan_1flip(g22, l2) == (False, False)
    assert twsw.weight_planes(w22) == (3, True) == twsw.weight_planes(w70) == twsw.weight_planes(d2000)
    assert 128 * (63 | 1) * 4 == 32_256 and engine.k6_tiles_per_sm(2000) == 7
    assert engine.plan_sweep(w22, l2) == (True, None)
    assert 2 * w22.num_edges / w22.num_nodes < engine.K8A_MIN_NEIGHBOURS == 80
    assert engine.plan_1flip(w22, l2) == engine.FlipPlan(weighted=True, levels=True)
    assert 128 * (313 | 1) * 4 == 160_256 and engine.k6_tiles_per_sm(10000) == 1
    assert engine.plan_sweep(w70, l2) == (True, engine.LIST_STAGE_ENTRIES)
    assert engine.plan_1flip(w70, l2) == engine.FlipPlan(weighted=True, levels=True)
    assert 2 * d2000.num_edges / d2000.num_nodes > engine.K8A_MIN_NEIGHBOURS
    assert twsw.word_entry_bytes(d2000) == 3_637_780 <= engine.FLIP_L2_SHARE * l2
    assert engine.plan_1flip(d2000, l2) == engine.FlipPlan(weighted=True, levels=False)
    # K8a's word entries must fit their share of L2, or K8b runs
    assert engine.plan_1flip(d2000, 3_637_780 / engine.FLIP_L2_SHARE + 1) == (True, False)
    assert engine.plan_1flip(d2000, 3_637_779 / engine.FLIP_L2_SHARE) == (True, True)
    # unit weights at G70's size: K4's word lists fit, but its chain tile
    # leaves one per SM, so K7 runs the noisy sweep (as in the JAX package,
    # which streamed the tables for VMEM; K7 was 1.8-3.7 times faster than
    # K4 there on the H100); K5's table fits a block's shared memory
    g70 = Graph.from_edge_list(10000, [(a, b, 1.0) for a, b in gnm_edges(10000, 9999, seed=70)], "G70like")
    assert tsw.word_list_bytes(g70) <= engine.SWEEP_L2_SHARE * l2
    assert engine.plan_sweep(g70, l2) == (True, engine.LIST_STAGE_ENTRIES)
    assert engine.plan_1flip(g70, l2) == (False, False)
    # K4's rule charges the word lists it reads: G22-like's 556,676 bytes
    # (34,292 step words of 16 bytes, and the offsets), not its 1.5 MB of
    # mask planes; K5's reads no L2 share: its table (at most 103,984 bytes)
    # and a chain's words must fit a block's shared memory
    t22 = tsw.PackedSweepTables.build(g22, "cpu")
    assert tsw.word_list_bytes(g22) == t22.word_entries.numel() * 4 + t22.word_offsets.numel() * 4 == 556_676
    assert engine.plan_sweep(g22, 556_676 / engine.SWEEP_L2_SHARE + 1) == (False, None)
    assert engine.plan_sweep(g22, 556_675 / engine.SWEEP_L2_SHARE) == (True, None)
    assert tsw.level_smem_bytes(tsw.level_table_bytes(g22), 2000) == 16 + 103_984 + (63 | 1) * 4
    assert engine.plan_1flip(g22, 2000 * 63 * 4 / engine.FLIP_L2_SHARE + 1) == (False, False)
    assert engine.plan_1flip(g22, (2000 * 63 * 4 - 1) / engine.FLIP_L2_SHARE) == (False, False)
    # K7's two stages of list entries fit a block's shared memory
    assert build.header_constant("kChainsPerBlock") == 128
    assert 2 * engine.LIST_STAGE_ENTRIES * 8 <= build.header_constant("kMaxSmem") == 227 * 1024
    assert engine.l2_bytes("cpu") == l2
    # weights that no packed kernel takes raise, whatever the size
    bad = Graph.from_edge_list(3, [(0, 1, 0.5), (1, 2, 1.0)], "half")
    with pytest.raises(ValueError, match="integer"):
        engine.plan_sweep(bad, l2)
    with pytest.raises(ValueError, match="integer"):
        engine.plan_1flip(bad, l2)


# (N, tiles per SM, plan): K6 while its chain tile leaves K6_MIN_TILES_PER_SM
# tiles per SM, K7 beyond, on a 3-bit signed graph of each size
@pytest.mark.parametrize("n, tiles, k7", [(2000, 7, False), (3000, 4, False), (3500, 4, False), (4000, 3, True),
                                          (5000, 2, True), (7000, 2, True), (8000, 1, True), (10000, 1, True),
                                          (60000, 0, True)])
def test_k6_runs_while_its_tile_leaves_enough_per_sm(n, tiles, k7):
    assert engine.k6_tiles_per_sm(n) == tiles
    g = Graph.from_edge_list(n, [(0, 1, 3.0), (1, 2, -5.0)], f"path{n}")
    assert engine.plan_sweep(g, engine.H100_L2_BYTES) == (True, engine.LIST_STAGE_ENTRIES if k7 else None)


# (N, K4): on unit weights K4 runs while its chain tile (K6's) leaves
# K6_MIN_TILES_PER_SM tiles per SM, K7 beyond, however small its word lists;
# at 60,000 nodes not even 32 chains of K4 fit a block's shared memory
@pytest.mark.parametrize("n, k4", [(2000, True), (3000, True), (4000, False), (10000, False), (20000, False),
                                   (60000, False)])
def test_k4_runs_while_its_tile_leaves_enough_per_sm(n, k4):
    g = Graph.from_edge_list(n, [(a, b, 1.0) for a, b in gnm_edges(n, 2 * n, seed=n)], f"U{n}")
    assert tsw.word_list_bytes(g) <= engine.SWEEP_L2_SHARE * engine.H100_L2_BYTES
    assert (engine.k6_tiles_per_sm(n) >= engine.K6_MIN_TILES_PER_SM) == k4
    assert engine.plan_sweep(g, engine.H100_L2_BYTES) == ((False, None) if k4 else (True, engine.LIST_STAGE_ENTRIES))
    assert engine.plan_1flip(g, engine.H100_L2_BYTES).weighted == (n > 10000)  # K5 while its table fits


def test_engines_build_and_run_on_cpu():
    g = _pair(40, 7, 6, False)[1]
    eng = engine.FusedSweepEngine.build(g, "cpu")
    assert eng.weighted and eng.node_chunk is None and isinstance(eng.tables, twsw.WeightedSweepTables)
    bits = torch.from_numpy(np.random.default_rng(3).random((8, 40)) < 0.5)
    assert torch.equal(eng.sweep(9, bits, 2), twsw.mcpg_sweep_weighted_fused(9, bits, eng.tables, 2))
    flip = engine.FlipSweepEngine.build(g, "cpu")  # a few neighbours a node: K8b
    assert flip.weighted and flip.levels and isinstance(flip.tables, twsw.WeightedAdjPlanes)
    assert torch.equal(flip.sweep(bits), twsw.sweep_1flip_weighted(bits, flip.tables, levels=True))
    # every pair of 90 nodes (89 neighbours a node): K8a
    rng = np.random.default_rng(4)
    dense = Graph.from_edge_list(90, [(a, b, float(rng.integers(1, 8) * rng.choice((-1, 1))))
                                      for a in range(90) for b in range(a + 1, 90)], "K90")
    flip_d = engine.FlipSweepEngine.build(dense, "cpu")
    assert flip_d.weighted and not flip_d.levels
    bits_d = torch.from_numpy(np.random.default_rng(5).random((8, 90)) < 0.5)
    assert torch.equal(flip_d.sweep(bits_d), twsw.sweep_1flip_weighted(bits_d, flip_d.tables, levels=True))
    g_pm = _pm1_graph()
    unit, unit_flip = engine.FusedSweepEngine.build(g_pm, "cpu"), engine.FlipSweepEngine.build(g_pm, "cpu")
    assert not unit.weighted and isinstance(unit.tables, tsw.PackedSweepTables)
    assert not unit_flip.weighted and isinstance(unit_flip.tables, tsw.PackedAdjacency)


def test_mcpg_fast_on_a_weighted_graph_on_cpu():
    _, g = _pair(56, 9, 7, True)
    cfg = MCPGConfig(seed=2, sampler="fused", sweep_mode="packed", total_mcmc_num=8, repeat_times=4, num_ls=2,
                     max_epoch_num=1, reset_epoch_num=16, sample_epoch_num=8, warmup_ls_rounds=1)
    x, v, ev = solve_maxcut_mcpg(g, cfg, device="cpu")
    assert v == obj_maxcut(x.astype(np.int64), g)
    assert len(ev.records) >= 2 and v > 0


def test_cli_fast_on_a_weighted_gset_file(tmp_path):
    edges = _weighted_edges(24, 5, 5, True)
    path = tmp_path / "wgset_24.txt"
    path.write_text(f"24 {len(edges)}\n" + "".join(f"{a + 1} {b + 1} {int(w)}\n" for a, b, w in edges))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "rlsolver_tpu_torch", "--alg", "mcpg", "--fast", "--data-dir",
                           str(tmp_path), "--prefixes", "wgset", "--device", "cpu"],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("mcpg wgset_24: obj=")
