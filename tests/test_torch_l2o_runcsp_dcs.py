"""seq2seq and L2O (`algos/l2o.py`), RUN-CSP (`algos/runcsp.py`) and DCS
(`algos/dcs.py`) against the JAX package with its parameters carried across
(`convert.solver_lstm_state_dict`, `runcsp_state_dict`, `dcs_params`) and
its draws injected: the expected cut and the LSTM's forward within 1e-6;
3 seq2seq steps (losses within 4e-5: a mean of terms of size 30 that
cancel) and 3 L2O epochs (losses within 1e-5), best cuts equal;
RUN-CSP's update and one training step (loss and parameters within 1e-5),
its instances and conflict counts equal; ISTA within 1e-6 and one DCS step
through its second-order loss (loss and parameters within 1e-5); and the
CLI's `--alg seq2seq|l2o` on BA_16_ID0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import dcs as jdcs
from rlsolver_tpu.algos import l2o as jl2o
from rlsolver_tpu.algos import runcsp as jcsp
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import dcs as tdcs
from rlsolver_tpu_torch.algos import l2o as tl2o
from rlsolver_tpu_torch.algos import runcsp as tcsp
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.problems.objectives import obj_maxcut
from rlsolver_tpu_torch.run import main as cli_main

torch.set_num_threads(1)
E, HID, STEPS = 6, 16, 3
GRAPH = "BA_16_ID0"


def to_np(tree):
    return jax.tree.map(np.array, tree)


def lstm_pair(n: int, key):
    jm = jl2o.SolverLSTM(n, HID)
    carry = jm.init_carry(key, E)
    params = jm.init(key, carry, jnp.full((E, n), 0.5))
    tm = tl2o.SolverLSTM(n, HID, device="cpu")
    tm.load_state_dict(convert.solver_lstm_state_dict(to_np(params)))
    return jm, tm, params


def test_expected_cut_and_lstm_forward_match():
    g = graph_from_name(GRAPH)
    adj = g.adjacency_dense()
    p = np.random.default_rng(0).random((E, g.num_nodes)).astype(np.float32)
    np.testing.assert_allclose(tl2o.expected_cut(torch.from_numpy(p), torch.from_numpy(adj)).numpy(),
                               np.asarray(jl2o.expected_cut(jnp.asarray(p), jnp.asarray(adj))), rtol=0, atol=1e-4)
    jm, tm, params = lstm_pair(g.num_nodes, jax.random.PRNGKey(0))
    carry = (jnp.asarray(p[:, :HID]), jnp.asarray(p[:, -HID:]))
    (jc, jh), jp = jm.apply(params, carry, jnp.asarray(p))
    with torch.no_grad():
        (tc, th), tp = tm((torch.from_numpy(p[:, :HID]), torch.from_numpy(p[:, -HID:])), torch.from_numpy(p))
    for a, b in ((tc, jc), (th, jh), (tp, jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_seq2seq_steps_match():
    g, jg = graph_from_name(GRAPH), j_graph_from_name(GRAPH)
    cfg = dict(num_envs=E, num_steps=STEPS, hidden=HID, seed=3)
    _, jcut, jhist = jl2o.solve_maxcut_seq2seq(jg, jl2o.Seq2SeqConfig(**cfg))
    key = jax.random.PRNGKey(3)
    k_init, k_sample, key = jax.random.split(key, 3)
    sample0 = np.array(jax.random.bernoulli(k_sample, 0.5, (E, g.num_nodes)))
    us = []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        us.append(np.array(jax.random.uniform(k, (E, g.num_nodes))))
    _, tm, _ = lstm_pair(g.num_nodes, k_init)
    bits, tcut, thist = tl2o.solve_maxcut_seq2seq(g, tl2o.Seq2SeqConfig(**cfg), device="cpu", model=tm,
                                                  draws=tl2o.Seq2SeqDraws(torch.from_numpy(sample0),
                                                                          torch.from_numpy(np.stack(us))))
    # the loss is the mean of adv * logp terms of size ~30 that cancel to ~0.3,
    # so f32 noise (XLA's own log, 1 ulp of logp = 1e-6) reaches 3e-5 there:
    # 1e-5 plus 1e-6 of the terms' size
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=0, atol=4e-5)
    assert [h["max_cut"] for h in thist] == [h["max_cut"] for h in jhist]
    assert tcut == jcut == obj_maxcut(bits.astype(np.int64), g)


def test_l2o_epochs_match():
    g, jg = graph_from_name(GRAPH), j_graph_from_name(GRAPH)
    cfg = dict(num_envs=E, num_epochs=STEPS, hidden=HID, episode_length=5, seed=4)
    _, jcut, jhist = jl2o.solve_maxcut_l2o(jg, jl2o.L2OConfig(**cfg))
    k_init, key = jax.random.split(jax.random.PRNGKey(4))
    starts = []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        starts.append(np.array(jax.random.uniform(k, (E, g.num_nodes))))
    _, tm, _ = lstm_pair(g.num_nodes, k_init)
    bits, tcut, thist = tl2o.solve_maxcut_l2o(g, tl2o.L2OConfig(**cfg), device="cpu", model=tm,
                                              draws=tl2o.L2ODraws(torch.from_numpy(np.stack(starts))))
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=0, atol=1e-5)
    assert [h["max_cut"] for h in thist] == [h["max_cut"] for h in jhist]
    assert tcut == jcut == obj_maxcut(bits.astype(np.int64), g)


@pytest.mark.parametrize("lang", ["maxcut", "max2sat", "coloring"])
def test_runcsp_update_and_training_step_match(lang):
    if lang == "maxcut":
        jl, tl = jcsp.ConstraintLanguage.maxcut(), tcsp.ConstraintLanguage.maxcut()
        ji = jcsp.CSPInstance.from_graph(j_graph_from_name(GRAPH), jl, "NEQ")
        ti = tcsp.CSPInstance.from_graph(graph_from_name(GRAPH), tl, "NEQ")
    elif lang == "max2sat":
        jl, tl = jcsp.ConstraintLanguage.max2sat(), tcsp.ConstraintLanguage.max2sat()
        ji, ti = jcsp.CSPInstance.generate_random(12, 30, jl, 2), tcsp.CSPInstance.generate_random(12, 30, tl, 2)
    else:
        (ji, jh), (ti, th) = jcsp.CSPInstance.generate_xu(15, 3, 1.5, 5), tcsp.CSPInstance.generate_xu(15, 3, 1.5, 5)
        np.testing.assert_array_equal(th, jh)
        jl, tl = ji.language, ti.language
    for r in ji.clauses:
        np.testing.assert_array_equal(ti.clauses[r], ji.clauses[r])
    cfg = dict(state_size=8, iterations=4, epochs=1, seed=1)
    js = jcsp.RunCspSolver(jl, jcsp.RunCspConfig(**cfg))
    ts = tcsp.RunCspSolver(tl, tcsp.RunCspConfig(**cfg), device="cpu")
    jp = js.init_params(ji)
    tp = convert.runcsp_state_dict(to_np(jp))
    key = jax.random.PRNGKey(7)
    h0 = np.array(jax.random.normal(key, (ji.num_vars, 8)) * 0.1)
    jphis = js._unroll(jp, key, js._device_instance(ji), ji.num_vars)
    tphis = ts._unroll(tp, ts.device_instance(ti), torch.from_numpy(h0))
    np.testing.assert_allclose(tphis[-1].detach().numpy(), np.asarray(jphis[-1]), rtol=0, atol=1e-5)
    _, k = jax.random.split(jax.random.PRNGKey(cfg["seed"] + 1))
    h0 = np.array(jax.random.normal(k, (ji.num_vars, 8)) * 0.1)
    jparams, jhist = js.train([ji])
    tparams, thist = ts.train([ti], params=tp, h0s=[torch.from_numpy(h0)])
    np.testing.assert_allclose(thist, jhist, rtol=1e-5, atol=1e-5)
    ref = convert.runcsp_state_dict(to_np(jparams))
    for name, v in tparams.items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
    a = ts.predict(tparams, ti, h0=torch.from_numpy(h0))
    assert ti.count_conflicts(a) == ji.count_conflicts(a)


def test_ista_and_dcs_step_match():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(10, 24)).astype(np.float32)
    y = rng.normal(size=(4, 10)).astype(np.float32)
    np.testing.assert_allclose(tdcs.ista(torch.from_numpy(f), torch.from_numpy(y)).numpy(),
                               np.asarray(jdcs.ista(jnp.asarray(f), jnp.asarray(y))), rtol=0, atol=1e-6)
    cfg = dict(signal_dim=24, latent_dim=6, num_measure=10, sparsity=3, num_grad_iters=3, batch_size=8,
               num_epochs=1, seed=2)
    jm = jdcs.DCS(jdcs.DCSConfig(**cfg))
    k_sig, k_z, _ = jax.random.split(jm.key, 3)
    x = np.array(jdcs.sparse_signals(k_sig, 8, 24, 3))
    z0 = np.array(jax.random.normal(k_z, (8, 6)))
    tm = tdcs.DCS(tdcs.DCSConfig(**cfg), device="cpu", params=tdcs_params(jm.params))
    jhist = jm.train()
    tloss = tm.train_step(tdcs.DCSDraws(torch.from_numpy(x), torch.from_numpy(z0)))
    np.testing.assert_allclose(tloss, jhist[0], rtol=1e-5, atol=1e-5)
    ref = tdcs_params(jm.params)
    for k, v in tm.params.items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert ((x != 0).sum(axis=1) == 3).all()


def tdcs_params(params):
    return convert.dcs_params({"gen": to_np(params["gen"]), "f": np.array(params["f"]),
                               "log_step": np.array(params["log_step"])})


SMALL = {"Seq2SeqConfig": dict(num_envs=8, num_steps=20, hidden=32),
         "L2OConfig": dict(num_envs=8, num_epochs=10, hidden=32, episode_length=4)}


@pytest.mark.parametrize("alg", ["seq2seq", "l2o"])
def test_cli_runs_on_cpu(alg, capsys, monkeypatch):
    # the default configs run on the card (chip_smoke.py); a small one here
    for name, kw in SMALL.items():
        monkeypatch.setattr(tl2o, name, functools.partial(getattr(tl2o, name), **kw))
    assert cli_main(["--alg", alg, "--graphs", GRAPH, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{alg} {GRAPH}: obj=") and float(out.split("obj=")[1].split()[0]) >= 10


ENTRY_POINTS = {
    "SolverLSTM": lambda dev: tl2o.SolverLSTM(4, 4, device=dev).out.kernel,
    "solve_maxcut_seq2seq": lambda dev: torch.as_tensor(tl2o.solve_maxcut_seq2seq(
        graph_from_name("BA_8_ID0"), tl2o.Seq2SeqConfig(num_envs=2, num_steps=1, hidden=4), device=dev)[1]),
    "solve_maxcut_l2o": lambda dev: torch.as_tensor(tl2o.solve_maxcut_l2o(
        graph_from_name("BA_8_ID0"), tl2o.L2OConfig(num_envs=2, num_epochs=1, hidden=4), device=dev)[1]),
    "RunCspSolver": lambda dev: tcsp.RunCspSolver(tcsp.ConstraintLanguage.mis(), device=dev).model.out.kernel,
    "DCS": lambda dev: tdcs.DCS(device=dev).params["f"],
    "Lista": lambda dev: tdcs.Lista(4, 6, device=dev).w,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)


def test_runcsp_trained_boosted_predictions_match():
    """A trained maxcut network's boosted predictions (RUN-CSP's cell:
    trained on BA_100 instances, 8 starts on each; cut here to ID0..1 and 8
    of 50 epochs) with JAX's initial states injected (`boosted_predict`'s
    keys 100 + i): every start's assignment and conflict count equal JAX's,
    so the boosted pick does too (ROADMAP Queue 3's RUN-CSP gap: inference)."""
    jl, tl = jcsp.ConstraintLanguage.maxcut(), tcsp.ConstraintLanguage.maxcut()
    names = [f"BA_100_ID{i}" for i in range(2)]
    jinsts = [jcsp.CSPInstance.from_graph(j_graph_from_name(nm), jl, "NEQ") for nm in names]
    tinsts = [tcsp.CSPInstance.from_graph(graph_from_name(nm), tl, "NEQ") for nm in names]
    cfg = dict(epochs=8, seed=0)
    js = jcsp.RunCspSolver(jl, jcsp.RunCspConfig(**cfg))
    ts = tcsp.RunCspSolver(tl, tcsp.RunCspConfig(**cfg), device="cpu")
    jparams, _ = js.train(jinsts)
    tparams = convert.runcsp_state_dict(to_np(jparams))
    for ji, ti in zip(jinsts, tinsts):
        jconfs, tconfs = [], []
        for i in range(8):
            key = jax.random.PRNGKey(100 + i)
            h0 = np.array(jax.random.normal(key, (ji.num_vars, js.cfg.state_size)) * 0.1)
            a, ja = ts.predict(tparams, ti, h0=torch.from_numpy(h0)), js.predict(jparams, ji, key)
            np.testing.assert_array_equal(a, ja)
            tconfs.append(ti.count_conflicts(a))
            jconfs.append(ji.count_conflicts(ja))
        assert tconfs == jconfs
