"""The statevector VQE (`solvers/vqe.py`) against the JAX package's: the
basis table and the maxcut diagonal equal, the TwoLocal(ry, cz) state
within 1e-6, and SPSA from JAX's initial draw and perturbations on a
10-node graph reaching the same bits and cut (its energy history within
1e-4); the CLI's `--alg vqe` on a small BA graph with `--device cpu`
reports a cut equal to its re-score. The builders run on the card unless
told "cpu"."""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.solvers import vqe as jv
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.problems.objectives import obj_maxcut
from rlsolver_tpu_torch.run import PORTED_ALGS
from rlsolver_tpu_torch.run import main as cli_main
from rlsolver_tpu_torch.solvers import vqe as tv

torch.set_num_threads(1)


def test_diagonal_and_state_match_jax():
    g, jg = graph_from_name("BA_8_ID0"), j_graph_from_name("BA_8_ID0")
    np.testing.assert_array_equal(tv.basis_bits(8, "cpu").numpy(), np.asarray(jv.basis_bits(8)))
    np.testing.assert_array_equal(tv.maxcut_diagonal(g, "cpu").numpy(), np.asarray(jv.maxcut_diagonal(jg)))
    np.testing.assert_array_equal(tv.cz_chain_mask(7, "cpu").numpy(), np.asarray(jv.cz_chain_mask(7)))
    n, reps = 7, 2
    params = np.random.default_rng(0).uniform(-np.pi, np.pi, (reps + 1) * n).astype(np.float32)
    t = tv.two_local_state(torch.from_numpy(params), n, reps, tv.cz_chain_mask(n, "cpu")).numpy()
    j = np.asarray(jax.jit(jv.two_local_state, static_argnums=(1, 2))(jnp.asarray(params), n, reps,
                                                                        jv.cz_chain_mask(n)))
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert abs(float((t**2).sum()) - 1.0) < 1e-5


def test_spsa_reaches_jax_bits_and_cut():
    g, jg = graph_from_name("BA_10_ID0"), j_graph_from_name("BA_10_ID0")
    cfg = jv.VQEConfig(num_iters=120, seed=3)
    jbits, jcut, jhist = jv.vqe_maxcut(jg, cfg)
    key = jax.random.PRNGKey(cfg.seed)
    num_params = (cfg.reps + 1) * g.num_nodes
    init = np.array(jax.random.uniform(key, (num_params,), minval=-0.1, maxval=0.1))
    delta = []
    for _ in range(cfg.num_iters):
        key, k = jax.random.split(key)
        delta.append(np.where(np.array(jax.random.bernoulli(k, 0.5, (num_params,))), 1.0, -1.0).astype(np.float32))
    draws = tv.SPSADraws(torch.from_numpy(init), torch.from_numpy(np.stack(delta)))
    tbits, tcut, thist = tv.vqe_maxcut(g, tv.VQEConfig(num_iters=120, seed=3), device="cpu", draws=draws)
    np.testing.assert_array_equal(tbits, jbits)
    assert tcut == jcut == obj_maxcut(tbits.astype(np.int64), g)
    np.testing.assert_allclose(thist, jhist, rtol=0, atol=1e-4)
    # from the generator: a cut no worse than a random bitstring's mean
    bits, cut, hist = tv.vqe_maxcut(g, tv.VQEConfig(num_iters=60), device="cpu")
    assert cut == obj_maxcut(bits.astype(np.int64), g) and len(hist) == 60
    with pytest.raises(ValueError):
        tv.vqe_maxcut(graph_from_name("BA_20_ID0"), device="cpu")


def test_cli_vqe_reports_its_rescore():
    assert "vqe" in PORTED_ALGS
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--alg", "vqe", "--graphs", "BA_12_ID0", "--device", "cpu"])
    assert rc == 0
    value = float(re.search(r"obj=([-\d.]+)", out.getvalue()).group(1))
    g = graph_from_name("BA_12_ID0")
    bits, cut, _ = tv.vqe_maxcut(g, tv.VQEConfig(seed=0), device="cpu")
    assert value == cut == obj_maxcut(bits.astype(np.int64), g)


# public builders that put tensors on a device: `cuda` unless told "cpu"
ENTRY_POINTS = {
    "basis_bits": lambda dev: tv.basis_bits(4, dev),
    "maxcut_diagonal": lambda dev: tv.maxcut_diagonal(graph_from_name("BA_8_ID0"), dev),
    "cz_chain_mask": lambda dev: tv.cz_chain_mask(4, dev),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
