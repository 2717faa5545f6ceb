"""The GCN models (`rlsolver_tpu_torch/models/gcn.py`) and PI-GNN
(`rlsolver_tpu_torch/algos/pignn.py`) against flax / optax on the CPU, on
the JAX package's own initial parameters (`convert.gcn_state_dict`).

The forward passes agree at rtol 1e-5 (f32 matmuls summed in other
orders). The port takes the maxcut loss on the dense adjacency, -(p . deg_w
- p^T A p) / tw, where JAX sums the edges: the loss is held to JAX's at
rtol 1e-5 and every gradient to `jax.grad` at rtol 1e-4 (atol 1e-4 of the
leaf's largest gradient: Adam's first step sees only signs, and entries
near 0 are f32 noise in both). After 20 Adam steps the best probabilities
agree at atol 1e-4, single instance and a two-graph cell at chunk=5 (its
JAX reference, a mirror of `solve_maxcut_pignn_cell`'s loop, is checked to
give the JAX solver's cuts)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import pignn as jpignn
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.models import gcn as jgcn
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import pignn
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.models import gcn
from rlsolver_tpu_torch.problems.objectives import obj_maxcut, obj_maximum_independent_set

torch.set_num_threads(1)
STEPS = 20


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_init(key, n, cfg, a_norm):
    """`rlsolver_tpu.algos.pignn._train`'s initial parameters."""
    k_emb, k_init = jax.random.split(key)
    embed = jax.random.normal(k_emb, (n, cfg.embed_dim)) * 0.1
    k_init, k_skip = jax.random.split(k_init)
    return {"gcn": jgcn.GCN(hidden=cfg.hidden, out_dim=1).init(k_init, embed, a_norm), "embed": embed,
            "skip": jax.random.normal(k_skip, (cfg.embed_dim,)) * 0.1}


def jax_edge_loss(jg):
    n0, n1, w = (jnp.asarray(a) for a in jg.edge_arrays())
    tw = max(float(np.asarray(w).sum()), 1e-9)
    return lambda p: -jnp.sum(w * (p[n0] + p[n1] - 2.0 * p[n0] * p[n1])) / tw


def jax_probs(params, a_norm, cfg):
    logits = jgcn.GCN(hidden=cfg.hidden, out_dim=1).apply(params["gcn"], params["embed"], a_norm)[..., 0]
    return jax.nn.sigmoid(logits + params["embed"] @ params["skip"])


# --------------------------------------------------------------------- GCN
@pytest.mark.parametrize("hidden", [(64,), (32, 16)])
def test_gcn_forward_matches_flax(hidden):
    g = graph_from_name("BA_40_ID0")
    a = gcn.normalized_adjacency(g)
    np.testing.assert_array_equal(a, jgcn.normalized_adjacency(j_graph_from_name("BA_40_ID0")))
    x = np.random.default_rng(0).normal(size=(3, 40, 7)).astype(np.float32)
    params = jgcn.GCN(hidden=hidden, out_dim=2).init(jax.random.PRNGKey(1), x, a)
    model = gcn.GCN(7, hidden, 2, device="cpu")
    model.load_state_dict(convert.gcn_state_dict(to_np(params)))
    j = np.asarray(jgcn.GCN(hidden=hidden, out_dim=2).apply(params, x, a))
    np.testing.assert_allclose(model(torch.from_numpy(x), torch.from_numpy(a)).detach().numpy(), j, rtol=1e-5,
                               atol=1e-6)
    ac = jgcn.GCNActorCritic(hidden=hidden)
    p_ac = ac.init(jax.random.PRNGKey(2), x, a)
    t_ac = gcn.GCNActorCritic(7, hidden, device="cpu")
    t_ac.load_state_dict(convert.gcn_state_dict(to_np(p_ac)))
    for t_out, j_out in zip(t_ac(torch.from_numpy(x), torch.from_numpy(a)), ac.apply(p_ac, x, a)):
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------- PI-GNN
def test_loss_and_gradients_match_jax():
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    cfg = jpignn.PIGNNConfig()
    a = jnp.asarray(jgcn.normalized_adjacency(jg))
    params = jax_init(jax.random.PRNGKey(cfg.seed), 100, cfg, a)
    loss_fn = jax_edge_loss(jg)
    j_loss, j_grads = jax.value_and_grad(lambda p: loss_fn(jax_probs(p, a, cfg)))(params)
    tp = {k: v.requires_grad_(True) for k, v in convert.gcn_state_dict(to_np(params)).items()}
    adj = torch.from_numpy(tg.adjacency_dense())
    loss = pignn.maxcut_loss(pignn.pignn_probs(tp, torch.from_numpy(np.array(a)), len(cfg.hidden)), adj,
                             torch.from_numpy(tg.weighted_degrees()), tg.total_weight)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for k, jgrad in convert.gcn_state_dict(to_np(j_grads)).items():
        jgrad = jgrad.numpy()
        np.testing.assert_allclose(tp[k].grad.numpy(), jgrad, rtol=1e-4, atol=1e-4 * np.abs(jgrad).max(), err_msg=k)
    # the dense MIS loss against the edge sum
    p = torch.rand(100, generator=torch.Generator().manual_seed(0))
    n0, n1, _ = tg.edge_arrays()
    unit = torch.from_numpy((tg.adjacency_dense() != 0).astype(np.float32))
    np.testing.assert_allclose(float(0.5 * torch.sum(p * (unit @ p))), float(torch.sum(p[n0] * p[n1])), rtol=1e-5)


def test_20_adam_steps_match_jax():
    jg, tg = j_graph_from_name("BA_100_ID1"), graph_from_name("BA_100_ID1")
    kw = dict(max_steps=STEPS, seed=3)
    cfg = jpignn.PIGNNConfig(**kw)
    a = jnp.asarray(jgcn.normalized_adjacency(jg))
    j_probs = jpignn._train(jg, jax_edge_loss(jg), cfg)
    params = convert.gcn_state_dict(to_np(jax_init(jax.random.PRNGKey(cfg.seed), 100, cfg, a)))
    cg = pignn.cut_ops.CutGraph.build(tg, "cpu")
    t_probs = pignn._train(tg, lambda p: pignn.maxcut_loss(p, cg.adj, cg.deg_w, tg.total_weight),
                           pignn.PIGNNConfig(**kw), torch.device("cpu"), params)
    np.testing.assert_allclose(t_probs, j_probs, atol=1e-4, rtol=0)
    bits, cut = pignn.solve_maxcut_pignn(tg, pignn.PIGNNConfig(**kw), device="cpu", params=params)
    assert cut == obj_maxcut(bits, tg)


def jax_cell(jgs, cfg, chunk):
    """`solve_maxcut_pignn_cell`'s initialization and chunk loop -> (the
    initial parameters, the best probs)."""
    n, g_cnt = jgs[0].num_nodes, len(jgs)
    arrs = [g.edge_arrays() for g in jgs]
    m_max = max(len(e[0]) for e in arrs)
    n0, n1, w = (jnp.asarray(np.stack([np.pad(e[i], (0, m_max - len(e[i]))) for e in arrs])) for i in range(3))
    a_norm = jnp.asarray(np.stack([jgcn.normalized_adjacency(g) for g in jgs]))
    model, opt = jgcn.GCN(hidden=cfg.hidden, out_dim=1), optax.adam(cfg.lr)

    def init_one(key):
        k_emb, k_init, k_skip = jax.random.split(key, 3)
        embed = jax.random.normal(k_emb, (n, cfg.embed_dim)) * 0.1
        return {"gcn": model.init(k_init, embed, a_norm[0]), "embed": embed,
                "skip": jax.random.normal(k_skip, (cfg.embed_dim,)) * 0.1}

    params = jax.vmap(init_one)(jax.random.split(jax.random.PRNGKey(cfg.seed), g_cnt))
    init = to_np(params)
    opt_state = opt.init(params)
    tw = jnp.maximum(jnp.sum(w, axis=1), 1e-9)

    def loss_one(p, an, e0, e1, ew, wsum):
        logits = model.apply(p["gcn"], p["embed"], an)[..., 0] + p["embed"] @ p["skip"]
        probs = jax.nn.sigmoid(logits)
        return -jnp.sum(ew * (probs[e0] + probs[e1] - 2.0 * probs[e0] * probs[e1])) / wsum, probs

    grad_v = jax.vmap(jax.value_and_grad(loss_one, has_aux=True))

    @jax.jit
    def run_chunk(params, opt_state, best_loss, best_probs):
        def body(carry, _):
            params, opt_state, best_loss, best_probs = carry
            (loss, probs), grads = grad_v(params, a_norm, n0, n1, w, tw)
            updates, opt_state = opt.update(grads, opt_state, params)
            better = loss < best_loss - cfg.tol
            return (optax.apply_updates(params, updates), opt_state, jnp.where(better, loss, best_loss),
                    jnp.where(better[:, None], probs, best_probs)), None

        return jax.lax.scan(body, (params, opt_state, best_loss, best_probs), None, length=chunk)[0]

    best_loss, best_probs = jnp.full((g_cnt,), jnp.inf), jnp.zeros((g_cnt, n))
    prev = np.full((g_cnt,), np.inf)
    for _ in range(max(1, cfg.max_steps // chunk)):
        params, opt_state, best_loss, best_probs = run_chunk(params, opt_state, best_loss, best_probs)
        cur = np.asarray(best_loss)
        if np.all(cur > prev - cfg.tol):
            break
        prev = cur
    return init, np.asarray(best_probs)


def test_cell_at_chunk_5_matches_jax():
    names = ["BA_100_ID2", "BA_100_ID3"]
    jgs, tgs = [j_graph_from_name(n) for n in names], [graph_from_name(n) for n in names]
    kw = dict(max_steps=STEPS, seed=1)
    j_bits, j_vals = jpignn.solve_maxcut_pignn_cell(jgs, jpignn.PIGNNConfig(**kw), chunk=5)
    init, j_probs = jax_cell(jgs, jpignn.PIGNNConfig(**kw), 5)
    np.testing.assert_array_equal(j_probs > 0.5, j_bits)  # the mirror is JAX's solver
    params = convert.gcn_state_dict(init)
    t_probs, t_loss = pignn.train_pignn_cell(tgs, pignn.PIGNNConfig(**kw), 5, "cpu", params)
    np.testing.assert_allclose(t_probs.numpy(), j_probs, atol=1e-4, rtol=0)
    bits, vals = pignn.solve_maxcut_pignn_cell(tgs, pignn.PIGNNConfig(**kw), 5, "cpu", params)
    np.testing.assert_array_equal(vals, [obj_maxcut(b, g) for g, b in zip(tgs, bits)])
    # the port's own initialization trains too
    bits, vals = pignn.solve_maxcut_pignn_cell(tgs, pignn.PIGNNConfig(max_steps=200), 50, "cpu")
    assert (vals == [obj_maxcut(b, g) for g, b in zip(tgs, bits)]).all() and vals.min() > 200


def test_mis_pignn_is_a_maximal_independent_set():
    tg = graph_from_name("BA_100_ID4")
    bits, size = pignn.solve_mis_pignn(tg, pignn.PIGNNConfig(max_steps=50), device="cpu")
    assert obj_maximum_independent_set(bits, tg) == size
    nbrs, _, deg = tg.padded_neighbors()
    assert all(bits[v] or bits[nbrs[v, : deg[v]]].any() for v in range(100))  # maximal


def test_cli_runs_pignn_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(pignn, "PIGNNConfig", functools.partial(pignn.PIGNNConfig, max_steps=100))
    from rlsolver_tpu_torch.run import main as cli_main

    assert cli_main(["--alg", "pignn", "--graphs", "BA_100_ID0", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("pignn BA_100_ID0: obj=")
