"""The batched objectives (`rlsolver_tpu_torch/ops/objectives.py`) and ISCO
(`rlsolver_tpu_torch/algos/isco.py`) against the JAX package's on the CPU.

The objectives are exact on integer data. ISCO's helpers are held at atol
1e-6 (the renormalized log-likelihoods at 1e-6 plus their conditioning,
see the test): log, exp, expm1 and log1p round differently in XLA and in
torch (one ulp in about a tenth of the values). Whole chains take JAX's
draws (start bits, Poisson path lengths, Gumbel and accept uniforms, each
recorded by a scan that mirrors JAX's own step for step, checked against
JAX's `run_segment`), at shapes where JAX runs one scan segment (chain <=
800, N * chain <= 320000). The accept decisions and the energies are then
equal step for step for 50 steps: a decision could flip only where the
accept uniform's log lies within such a difference of log_acc, which these
runs never meet. The acceptance probabilities are exps of sums of those
log-likelihoods, whose ill-conditioned entries (an item drawn after the
earlier ones took all but a fraction 1 - P of the mass) carry the ulp
differences of exp and log times P / (1 - P): held at rtol 1e-4 from 1e-2
up; below, where 1 - P reaches f32's resolution and log(1 - P) is noise in
both packages (measured: 6e-5 against 2e-4), both must be below 1e-2. The
prefix sums themselves are XLA's (`isco.blocked_cumsum`, bit for bit).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import isco as jisco
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.core.io import KnapsackInstance as JKnapsack, SetCoverInstance as JSetCover
from rlsolver_tpu.ops import cut as jcut
from rlsolver_tpu.ops import objectives as jobj
from rlsolver_tpu_torch.algos import isco
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.io import KnapsackInstance, SetCoverInstance
from rlsolver_tpu_torch.ops import objectives as tobj
from rlsolver_tpu_torch.problems.objectives import obj_maxcut, obj_maximum_independent_set

torch.set_num_threads(1)
T, B = 50, 16


def t_(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------- objectives
def test_batched_objectives_match_jax():
    rng = np.random.default_rng(0)
    jg, tg = j_graph_from_name("BA_40_ID1"), graph_from_name("BA_40_ID1")
    je, te = jobj.EdgeArrays.build(jg), tobj.EdgeArrays.build(tg, "cpu")
    xs = rng.random((6, 40)) < 0.3
    for pen in (None, 1.5):
        for jf, tf in ((jobj.obj_minimum_vertex_cover, tobj.obj_minimum_vertex_cover),
                       (jobj.obj_maximum_independent_set, tobj.obj_maximum_independent_set)):
            np.testing.assert_array_equal(tf(t_(xs), te, penalty=pen).numpy(), np.asarray(jf(jnp.asarray(xs), je,
                                                                                               penalty=pen)))
        np.testing.assert_array_equal(tobj.obj_graph_partitioning(t_(xs), te, 40, penalty=pen).numpy(),
                                      np.asarray(jobj.obj_graph_partitioning(jnp.asarray(xs), je, 40, penalty=pen)))
        member = rng.random((9, 12)) < 0.3
        sx = rng.random((6, 9)) < 0.6
        np.testing.assert_array_equal(tobj.obj_set_cover(t_(sx), t_(member), penalty=pen).numpy(),
                                      np.asarray(jobj.obj_set_cover(jnp.asarray(sx), jnp.asarray(member), penalty=pen)))
        w, p = rng.integers(1, 9, 10).astype(np.float32), rng.integers(1, 9, 10).astype(np.float32)
        kx = rng.random((6, 10)) < 0.5
        np.testing.assert_array_equal(
            tobj.obj_knapsack(t_(kx), t_(w), t_(p), 20.0, penalty=pen).numpy(),
            np.asarray(jobj.obj_knapsack(jnp.asarray(kx), jnp.asarray(w), jnp.asarray(p), 20.0, penalty=pen)))
        labels = rng.integers(0, 4, (6, 40))
        np.testing.assert_array_equal(tobj.obj_graph_coloring(t_(labels), te, 4, penalty=pen).numpy(),
                                      np.asarray(jobj.obj_graph_coloring(jnp.asarray(labels), je, 4, penalty=pen)))
    np.testing.assert_array_equal(tobj.obj_maxcut(t_(xs), te).numpy(), np.asarray(jobj.obj_maxcut(jnp.asarray(xs), je)))
    assert tobj.obj_maxcut(t_(xs), te)[0] == obj_maxcut(xs[0], tg)
    nums = rng.random(10).astype(np.float32) * 10  # non-integer data: rtol 1e-6
    np.testing.assert_allclose(tobj.obj_number_partitioning(t_(kx), t_(nums)).numpy(),
                               np.asarray(jobj.obj_number_partitioning(jnp.asarray(kx), jnp.asarray(nums))), rtol=1e-6)
    tours = np.stack([rng.permutation(7) for _ in range(4)])
    dist = rng.random((7, 7)).astype(np.float32)
    np.testing.assert_allclose(tobj.obj_tsp(t_(tours), t_(dist)).numpy(),
                               np.asarray(jobj.obj_tsp(jnp.asarray(tours), jnp.asarray(dist))), rtol=1e-6)


def test_instance_containers_and_host_mis():
    subsets = ((1, 2), (2, 3, 4), (4,))
    assert (SetCoverInstance(4, subsets).membership_matrix() == JSetCover(4, subsets).membership_matrix()).all()
    assert SetCoverInstance(4, subsets).num_sets == 3
    ks = KnapsackInstance(0, 5.0, np.ones(3, np.float32), np.ones(3, np.float32))
    assert ks.num_items == JKnapsack(0, 5.0, np.ones(3, np.float32), np.ones(3, np.float32)).num_items == 3
    from rlsolver_tpu.problems.objectives import obj_maximum_independent_set as j_obj_mis

    jg, tg = j_graph_from_name("BA_40_ID2"), graph_from_name("BA_40_ID2")
    for x in np.random.default_rng(1).random((20, 40)) < 0.08:
        assert obj_maximum_independent_set(x, tg) == j_obj_mis(x, jg)


# ------------------------------------------------------------------- helpers
@pytest.mark.parametrize("n", [1, 16, 17, 100, 1000, 2000])
def test_blocked_cumsum_is_xla_cumsum(n):
    x = np.random.default_rng(n).random((3, 5, n)).astype(np.float32)
    np.testing.assert_array_equal(isco.blocked_cumsum(t_(x)).numpy(),
                                  np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x)))


def test_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = np.concatenate([-rng.random(50) * 5, [0.0, -0.693, -0.6931, -np.inf]]).astype(np.float32)
    np.testing.assert_allclose(isco.log1mexp(t_(x)).numpy(), np.asarray(jisco.log1mexp(jnp.asarray(x))), atol=1e-6)
    ll = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(8, 30)).astype(np.float32) * 3), axis=-1)
    ll = ll.at[0, 5:].set(-1e18)  # the reverse pass's masked entries
    j = np.asarray(jisco.noreplacement_renormalize(ll))
    t = isco.noreplacement_renormalize(t_(ll)).numpy()
    assert not np.isnan(t).any() and (t <= 0).all()
    # entry i is ll_i - log(1 - P_i), P_i the mass of the entries before it:
    # an ulp of exp or log moves P_i by about 2^-24 P_i and the entry by
    # that over 1 - P_i, which is large where the earlier entries hold
    # nearly all the mass
    p = np.exp(np.asarray(ll, np.float64))
    prior = np.clip(np.cumsum(p, axis=-1) - p, 0.0, 1.0)
    tol = 1e-6 + 16 * 2.0**-24 * prior / np.maximum(1.0 - prior, 1e-30)
    assert (np.abs(t - j) <= tol).all(), np.abs(t - j).max()
    key = jax.random.PRNGKey(3)
    pl = jnp.asarray(rng.integers(1, 31, 8), jnp.int32)
    j_info = jisco.sample_flip_set(key, ll, pl)
    t_info = isco.sample_flip_set(t_(jax.random.uniform(key, ll.shape)), t_(ll), t_(pl))
    np.testing.assert_array_equal(t_info.mask.numpy(), np.asarray(j_info.mask))
    assert (t_info.mask.sum(1).numpy() == np.asarray(pl)).all()
    np.testing.assert_allclose(t_info.perturbed_ll.numpy(), np.asarray(j_info.perturbed_ll), atol=1e-6)
    np.testing.assert_allclose(t_info.ll_forward.numpy(), np.asarray(j_info.ll_forward), atol=1e-6, rtol=1e-6)
    lp_y = jax.nn.log_softmax(jnp.asarray(rng.normal(size=(8, 30)).astype(np.float32)), axis=-1)
    np.testing.assert_allclose(isco.reverse_ll(t_(lp_y), t_info).numpy(), np.asarray(jisco.reverse_ll(lp_y, j_info)),
                               atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- whole chains
def jax_chain(sampler, key, temps, data=None):
    """JAX's `run_segment` body from `init_carry(key)`, also returning each
    step's draws and state: (x0, final carry, (path_length, u_prop, u_acc,
    x, energy, acc))."""
    cfg = sampler.cfg
    carry = sampler.init_carry(key, data)
    b, n = carry[0].shape

    def body(carry, temp):
        x, mu, best_x, best_e, key = carry
        key, k_pl, k_step = jax.random.split(key, 3)
        pl = jnp.clip(jax.random.poisson(k_pl, mu, (b,)), 1, n).astype(jnp.int32)
        k_prop, k_acc = jax.random.split(k_step)
        draws = (pl, jax.random.uniform(k_prop, (b, n)), jax.random.uniform(k_acc, (b,)))
        x, energy, acc = sampler.step(k_step, x, pl, temp, data)
        mu = jnp.clip(mu + cfg.mu_lr * (acc - cfg.target_accept), 1.0, float(n))
        better = energy > best_e
        best_e = jnp.where(better, energy, best_e)
        best_x = jnp.where(better[:, None], x, best_x)
        return (x, mu, best_x, best_e, key), draws + (x, energy, acc)

    final, rec = jax.lax.scan(body, carry, temps)
    return carry[0], final, rec


def jax_maxcut_sampler(jg, cfg):
    cg = jcut.CutGraph.build(jg, dtype=jnp.float32, with_dense=True)
    return jisco.ISCOSampler(jg.num_nodes, lambda x: jcut.cut_value(x > 0.5, cg, "dense"),
                             lambda x: jcut.flip_gains(x > 0.5, cg, "dense"), cfg)


def test_one_step_and_50_steps_match_jax():
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    jcfg = jisco.ISCOConfig(batch_size=B, chain_length=T, seed=5)
    js = jax_maxcut_sampler(jg, jcfg)
    temps = js.temperatures(T)
    x0, final, rec = jax.jit(functools.partial(jax_chain, js))(jax.random.PRNGKey(jcfg.seed), temps)
    ref = jax.jit(js.run_segment)(js.init_carry(jax.random.PRNGKey(jcfg.seed)), temps)
    for a, b in zip(final, ref):  # the mirror is JAX's scan
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cfg = isco.ISCOConfig(batch_size=B, chain_length=T, seed=5)
    ts = isco.ISCOSampler(100, *(lambda cg: (lambda x: isco.cut_ops.cut_value(x > 0.5, cg, "dense"),
                                            lambda x: isco.cut_ops.flip_gains(x > 0.5, cg, "dense")))(
        isco.cut_ops.CutGraph.build(tg, "cpu")), cfg)
    np.testing.assert_array_equal(ts.temperatures(T), np.asarray(temps))
    x = t_(x0)
    pl, up, ua, jx, je, jacc = (np.asarray(a) for a in rec)
    accepts = 0
    for t in range(T):  # one step at a time from the port's own state
        x_prev = x
        x, e, acc = ts.step(x, t_(pl[t]), torch.tensor(np.asarray(temps)[t]), t_(up[t]), t_(ua[t]))
        np.testing.assert_array_equal(x.numpy(), jx[t], err_msg=f"step {t}")
        np.testing.assert_array_equal(e.numpy(), je[t])
        big = jacc[t] >= 1e-2
        np.testing.assert_allclose(acc.numpy()[big], jacc[t][big], rtol=1e-4)
        assert (acc.numpy()[~big] < 1e-2).all()
        accepts += int((x != x_prev).any(dim=1).sum())
    assert 0 < accepts < T * B  # both branches of the accept
    # the solver with the same draws
    bits, val = isco.solve_maxcut_isco(tg, cfg, device="cpu", draws=isco.ISCODraws(*(t_(a) for a in (x0, pl, up, ua))))
    i = int(np.argmax(np.asarray(final[3])))
    assert val == float(final[3][i]) == obj_maxcut(bits, tg)
    np.testing.assert_array_equal(bits, np.asarray(final[2][i]) > 0.5)


def test_cell_50_steps_matches_jax():
    names = ["BA_100_ID1", "BA_100_ID2"]
    jgs, tgs = [j_graph_from_name(n) for n in names], [graph_from_name(n) for n in names]
    jcfg = jisco.ISCOConfig(batch_size=B, chain_length=T, seed=3)
    j_bits, j_vals = jisco.solve_maxcut_isco_cell(jgs, jcfg, mode="dense")
    # the cell is vmapped over split(PRNGKey(seed), G): instance g's chain is
    # the single-instance chain from that key
    recs = [jax.jit(functools.partial(jax_chain, jax_maxcut_sampler(jg, jcfg)))(k, jisco.ISCOSampler(
        100, None, None, jcfg).temperatures(T)) for jg, k in zip(jgs, jax.random.split(jax.random.PRNGKey(3), 2))]
    x0 = np.stack([np.asarray(r[0]) for r in recs])
    pl, up, ua = (np.stack([np.asarray(r[2][i]) for r in recs], axis=1) for i in range(3))
    t_bits, t_vals = isco.solve_maxcut_isco_cell(tgs, isco.ISCOConfig(batch_size=B, chain_length=T, seed=3),
                                                 device="cpu", draws=isco.ISCODraws(*(t_(a) for a in (x0, pl, up, ua))))
    np.testing.assert_array_equal(t_vals, np.asarray(j_vals))
    np.testing.assert_array_equal(t_bits, np.asarray(j_bits))
    for g, b, v in zip(tgs, t_bits, t_vals):
        assert obj_maxcut(b, g) == v
    # the port's own draws, and a cell of one against the single solver's shape
    bits, vals = isco.solve_maxcut_isco_cell(tgs, isco.ISCOConfig(batch_size=B, chain_length=T), device="cpu")
    assert [obj_maxcut(b, g) for g, b in zip(tgs, bits)] == list(vals) and min(vals) > 250


def test_mis_isco_is_a_feasible_set():
    tg = graph_from_name("BA_100_ID3")
    bits, size = isco.solve_mis_isco(tg, isco.ISCOConfig(batch_size=B, chain_length=100), device="cpu")
    assert obj_maximum_independent_set(bits, tg) == size > 25


@pytest.mark.parametrize("problem", ["maxcut", "mis"])
def test_cli_runs_isco_on_cpu(problem, capsys, monkeypatch):
    monkeypatch.setattr(isco, "ISCOConfig", functools.partial(isco.ISCOConfig, chain_length=60))
    from rlsolver_tpu_torch.run import main as cli_main

    assert cli_main(["--problem", problem, "--alg", "isco", "--graphs", "BA_100_ID0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("isco BA_100_ID0: obj=") and float(out.split("obj=")[1].split()[0]) > 25
