"""The certified spectral maxcut bound of the port
(`rlsolver_tpu_torch/classical/spectral_bound.py`) against the JAX
package's on the CPU. The float64 host certificate is the same code, so it
is equal; the descent's block power iteration is f32 matmuls summed in
other orders, so the certified bound after 20 iterations is held at rtol
1e-5 (single instance and cell); and the bound is at or above the
brute-force optimum of a 12-node graph.

The comparisons hold the smoothing temperature mu fixed (mu_halvings=0;
the other settings are scripts/quality_table.py's). The schedule's 10
halvings squeezed into 20 iterations halve mu every step, and a softmax
that sharp over near-equal Ritz values turns the summation-order
differences (1e-9 relative after the first iteration) into different
subgradient steps: certified bounds 1e-6 to 1.3e-3 apart on BA_100_ID0..5
(seeds 0 and 1). With mu fixed they stay within 1e-7."""

import itertools

import numpy as np
import pytest
import torch

from rlsolver_tpu.classical import spectral_bound as jsb
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu_torch.classical import spectral_bound as sb
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
KW = dict(opt_iters=20, block_size=16, lr=4.0, mu_halvings=0, certify_squarings=12, seed=1)


@pytest.mark.parametrize("squarings", [4, 10, 12])
def test_certify_lambda_max_is_the_jax_packages(squarings):
    rng = np.random.default_rng(squarings)
    a = rng.normal(size=(30, 30))
    m = a + a.T
    assert sb.certify_lambda_max(m, squarings) == jsb.certify_lambda_max(m, squarings)
    assert sb.certify_lambda_max(m, squarings) >= np.linalg.eigvalsh(m)[-1]
    assert sb.certify_lambda_max(np.zeros((4, 4))) == jsb.certify_lambda_max(np.zeros((4, 4)))
    g = graph_from_name("BA_100_ID0")
    np.testing.assert_array_equal(sb._laplacian(g), jsb._laplacian(j_graph_from_name("BA_100_ID0")))


def test_bound_matches_jax_single():
    j_b, j_info = jsb.maxcut_upper_bound(j_graph_from_name("BA_100_ID1"), jsb.SpectralBoundConfig(**KW))
    est = []
    t_b, t_info = sb.maxcut_upper_bound(graph_from_name("BA_100_ID1"), sb.SpectralBoundConfig(**KW),
                                        record=lambda i, e: est.append(e), device="cpu")
    np.testing.assert_allclose(t_b, j_b, rtol=1e-5)
    np.testing.assert_allclose(t_info["estimate"], j_info["estimate"], rtol=1e-5)
    assert t_info["trivial_bound"] == j_info["trivial_bound"] and len(est) == KW["opt_iters"]


def test_bound_matches_jax_cell():
    names = [f"BA_100_ID{i}" for i in range(3)]
    j_b = jsb.maxcut_upper_bound_cell([j_graph_from_name(n) for n in names], jsb.SpectralBoundConfig(**KW))
    t_b = sb.maxcut_upper_bound_cell([graph_from_name(n) for n in names], sb.SpectralBoundConfig(**KW),
                                     device="cpu")
    np.testing.assert_allclose(t_b, j_b, rtol=1e-5)


def test_bound_is_above_the_brute_force_optimum():
    rng = np.random.default_rng(12)
    edges = [(a, b, float(rng.integers(1, 4))) for a, b in itertools.combinations(range(12), 2) if rng.random() < 0.4]
    g = Graph.from_edge_list(12, edges)
    best = max(obj_maxcut(np.array([(k >> i) & 1 for i in range(12)]), g) for k in range(1 << 11))
    cfg = sb.SpectralBoundConfig(opt_iters=200, block_size=8, lr=4.0, mu_halvings=10, certify_squarings=12)
    single, _ = sb.maxcut_upper_bound(g, cfg, device="cpu")
    (cell,) = sb.maxcut_upper_bound_cell([g], cfg, device="cpu")
    assert best <= single and best <= cell
    assert single <= 1.1 * best  # tighter than the trivial bound of the total weight here
