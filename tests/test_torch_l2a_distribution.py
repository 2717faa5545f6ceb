"""Port parity for distribution-wise L2A (`algos/l2a_distribution.py`): the
adjacency-argument primitives and the 1-flip sweep against JAX bit for bit
(and the sweep against the plain versions of K5, K8 and K10), pretraining,
one improvement round, one unrolled update, one guided round and one
perturb round against JAX with JAX's draws injected and the same weights,
and the packed evaluator's best cuts against their host re-scores and
against JAX's evaluator at the same budget."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import l2a_distribution as jd
from rlsolver_tpu.config import GraphType as JGraphType
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.models import transformer as jtr
from rlsolver_tpu.ops.reductions import update_xs_by_vs as j_update
from rlsolver_tpu.ops.sampling import sub_set_sampling as j_sub_set_sampling
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import l2a_distribution as td
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.models import transformer as ttr
from rlsolver_tpu_torch.ops.kernels import mcpg_sweep as sw, sweep_kernel as sk, weighted_sweep as wsw
from rlsolver_tpu_torch.ops.kernels.engine import FlipSweepEngine
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)

N, D, H = 24, 16, 2
# flax's modules, their init and apply compiled once for the file (eager
# flax compiles each of its operations on first use)
NET = jtr.PolicyTrsWithValue(embed_dim=D, num_heads=H)
_net_init, _net_apply = jax.jit(NET.init), jax.jit(NET.apply)


@functools.lru_cache(maxsize=None)
def _encoder(n):
    """flax's encoder at n nodes, its init and its embed, compiled."""
    enc = jtr.GraphEncoder(num_nodes=n, embed_dim=D, num_heads=H)
    return enc, jax.jit(enc.init), jax.jit(lambda p, adj: enc.embed(p, adj[None])[0])


def _net_params(seed):
    """flax's init of the policy from PRNGKey(seed) (its params depend on
    neither N nor the batch)."""
    return _net_init(jax.random.PRNGKey(seed), jtr.solution_to_prob_channels(jnp.zeros((1, N), bool)),
                     jnp.zeros((N, D), jnp.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, params):
    module.load_state_dict(convert.flax_state_dict(_np(params)))
    return module


def _assert_params_close(module, params, atol):
    """Every parameter within atol, except the attention's key biases, whose
    gradient is rounding noise in either package (a key bias adds the same
    term to every score of a query, which the softmax cancels)."""
    want = convert.flax_state_dict(_np(params))
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if not k.endswith("key.bias"):
            np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), atol=atol, rtol=0, err_msg=k)


def _assert_grads_close(module, grads, rtol=1e-3):
    """Every parameter's .grad within rtol of JAX's gradient (and within
    rtol of its leaf's largest entry, for entries near zero), except the
    key biases' (see `_assert_params_close`). No .grad (a parameter the
    loss does not reach) must be JAX's zero."""
    want = convert.flax_state_dict(_np(grads))
    for k, p in module.named_parameters():
        if not k.endswith("key.bias"):
            w = want[k].numpy()
            got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            np.testing.assert_allclose(got, w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=k)


def _weighted(name: str, signed: bool) -> Graph:
    """The topology of graph `name`, unit weights or weights in +-{1..7}."""
    g = graph_from_name(name)
    if not signed:
        return g
    rng = np.random.default_rng(7)
    w = rng.integers(1, 8, g.num_edges) * rng.choice((-1, 1), g.num_edges)
    return Graph(g.num_nodes, g.edges, w.astype(np.float32), g.name + "pm7")


CASES = [("BA_40_ID3", False), ("BA_40_ID3", True), ("PL_64_ID1", True)]


@pytest.mark.parametrize("name,signed", CASES, ids=["ba", "ba_pm7", "pl_pm7"])
def test_cut_and_gains_exact_on_integer_weights(name, signed):
    g = _weighted(name, signed)
    adj = g.adjacency_dense()
    xs = np.random.default_rng(1).random((9, g.num_nodes)) < 0.5
    cut = td._cut_value_adj(_t(xs), _t(adj)).numpy()
    np.testing.assert_array_equal(cut, np.asarray(jd._cut_value_adj(jnp.asarray(xs), jnp.asarray(adj))))
    np.testing.assert_array_equal(cut, [obj_maxcut(x.astype(np.int64), g) for x in xs])
    np.testing.assert_array_equal(td.flip_gains_adj(_t(xs), _t(adj)).numpy(),
                                  np.asarray(jd.flip_gains_adj(jnp.asarray(xs), jnp.asarray(adj))))


@pytest.mark.parametrize("name,signed", CASES, ids=["ba", "ba_pm7", "pl_pm7"])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_sweep_1flip_adj_bit_exact(name, signed, sweeps):
    g = _weighted(name, signed)
    adj = g.adjacency_dense()
    xs = np.random.default_rng(2).random((16, g.num_nodes)) < 0.5
    want = np.asarray(jd.sweep_1flip_adj(jnp.asarray(xs), jnp.asarray(adj), sweeps))
    plain = td.sweep_1flip_adj(_t(xs), _t(adj), sweeps)  # the plain f32 loop
    np.testing.assert_array_equal(plain.numpy(), want)
    assert (want != xs).any()
    # the engine the card would run, on the CPU: the plain version of the
    # packed kernel the rule picks (K5 on unit weights, K8a/K8b else)
    flip = td.AdjSweep.build(g, _t(adj))
    assert flip.lists is None and flip.engine.weighted == signed
    np.testing.assert_array_equal(td.sweep_1flip_adj(_t(xs), _t(adj), sweeps, flip).numpy(), want)
    # and the plain versions of K10 and of K5 or K8b themselves
    s = torch.where(_t(xs), 1.0, -1.0)
    gains = s * (s @ _t(adj))
    x_packed = _t(xs)
    for _ in range(sweeps):
        s, gains, _ = sk.sweep_1flip_f32_plain(_t(adj), s, gains, torch.zeros(len(xs)))
        x_packed = (wsw._sweep_1flip_plain(x_packed, wsw.WeightedAdjPlanes.build(g, "cpu")) if signed
                    else sw._sweep_1flip_plain(x_packed, sw.pack_adjacency(g, "cpu")))
    np.testing.assert_array_equal((s > 0).numpy(), want)
    np.testing.assert_array_equal(x_packed.numpy(), want)


def test_adj_sweep_takes_k10_lists_where_no_packed_kernel_fits():
    g = graph_from_name("BA_40_ID3")
    real = Graph(g.num_nodes, g.edges, np.linspace(0.5, 1.5, g.num_edges).astype(np.float32), "real")
    adj = _t(real.adjacency_dense())
    flip = td.AdjSweep.build(real, adj)
    assert flip.engine is None and torch.equal(flip.lists.offsets, sk.F32AdjLists.build(adj).offsets)
    back = td.graph_from_adjacency(real.adjacency_dense())
    np.testing.assert_array_equal(back.edges, real.edges)
    np.testing.assert_array_equal(back.weights, real.weights)
    assert td._adj_sweep(adj) is None  # on the CPU: the plain loop


@pytest.mark.parametrize("kind", ["unit", "pm7", "real", "too_large"])
def test_adj_sweep_routes_by_the_weights_the_engine_takes(kind):
    """The packed 1-flip engine exactly where `weight_fault` finds none, and
    where it finds one the engine refuses the graph with that fault."""
    g = _weighted("BA_40_ID3", kind == "pm7")
    w = {"real": np.linspace(0.5, 1.5, g.num_edges), "too_large": np.full(g.num_edges, 2.0 ** 15)}.get(kind, g.weights)
    gw = Graph(g.num_nodes, g.edges, np.asarray(w, np.float32), kind)
    flip, fault = td.AdjSweep.build(gw, _t(gw.adjacency_dense())), wsw.weight_fault(gw.weights)
    assert (flip.engine is None) == (flip.lists is not None) == (fault is not None) == (kind in ("real", "too_large"))
    if fault is not None:
        with pytest.raises(ValueError, match=re.escape(fault)):
            FlipSweepEngine.build(gw, "cpu")


def _jcfg(**kw):
    d = dict(num_nodes=N, num_sims=8, num_repeats=3, top_k=5, seq_len=3, num_iters=2, embed_dim=D, num_heads=H,
             pretrain_steps=3, lr=1e-3, ls_sweeps=2, num_validation=2)
    d.update(kw)
    return jd.L2ADistConfig(**d), td.L2ADistConfig(**d)


def test_pretrain_matches_jax():
    jcfg, tcfg = _jcfg()
    enc, params, losses = jd.pretrain_encoder_distribution(jcfg)
    init = _encoder(N)[1](jax.random.PRNGKey(jcfg.seed), jd._sample_adj(jcfg, 0)[None])  # the JAX package's init
    tenc = _load(ttr.GraphEncoder(N, D, H, device="cpu"), init)
    # the first step's gradient (Adam's first step sees only its sign)
    adj = jd._sample_adj(jcfg, 10_000)
    grads = jax.jit(jax.grad(lambda p: jnp.mean((enc.apply(p, adj[None])[0] - adj[None]) ** 2)))(init)
    recon, _ = tenc(_t(adj)[None])
    torch.mean((recon - _t(adj)[None]) ** 2).backward()
    _assert_grads_close(tenc, grads)
    tenc, t_losses = td.pretrain_encoder_distribution(tcfg, "cpu", enc=tenc)
    np.testing.assert_allclose(t_losses, losses, atol=1e-5, rtol=0)
    _assert_params_close(tenc, params, atol=1e-4)


def _policy_case(jcfg, seed=3):
    """Policy params from flax's init, loaded into the port; a BA graph, a
    random seq_graph and incumbents."""
    rng = np.random.default_rng(seed)
    g = graph_from_name(f"BA_{N}_ID{seed}")
    adj = g.adjacency_dense()
    seq = rng.normal(size=(N, D)).astype(np.float32)
    xs = rng.random((jcfg.num_sims, N)) < 0.5
    params = _net_params(seed)
    tnet = _load(ttr.PolicyTrsWithValue(D, H, device="cpu"), params)
    return g, adj, seq, xs, NET, params, tnet


def _assert_no_ties(probs):
    """`torch.topk` and `jax.lax.top_k` may order ties in |p - 0.5| apart."""
    det = np.abs(np.asarray(probs) - np.float32(0.5))
    assert all(len(set(row)) == len(row) for row in det.tolist())


def test_improve_round_matches_jax():
    jcfg, tcfg = _jcfg()
    g, adj, seq, xs, net, params, tnet = _policy_case(jcfg)
    ja, jx = jnp.asarray(adj), jnp.asarray(xs)
    vs = jd._cut_value_adj(jx, ja)
    k_sample, _ = jax.random.split(jax.random.PRNGKey(11))

    @jax.jit
    def improve_round(params, jx, vs):  # the body of the JAX package's `improve_round`
        logits, _ = NET.apply(params, jtr.solution_to_prob_channels(jx), jnp.asarray(seq))
        probs = jax.nn.softmax(logits, axis=-1)[..., 0]
        cand = j_sub_set_sampling(k_sample, probs, jx, jcfg.num_repeats, jcfg.top_k)
        cand = jd.sweep_1flip_adj(cand, ja, jcfg.ls_sweeps)
        cand_vs = jd._cut_value_adj(cand, ja)
        rows = jnp.argmax(cand_vs.reshape(jcfg.num_repeats, jcfg.num_sims), axis=0) * jcfg.num_sims + jnp.arange(
            jcfg.num_sims)
        new_xs, new_vs = cand[rows], cand_vs[rows]
        xs2, vs2 = j_update(jx, vs, new_xs, new_vs)
        s = new_xs.astype(jnp.float32)
        return xs2, vs2, jnp.log(jnp.clip(s * probs + (1 - s) * (1 - probs), 1e-8)).sum(axis=1), probs

    xs2, vs2, logp, probs = improve_round(params, jx, vs)
    _assert_no_ties(probs)

    u = _t(jax.random.uniform(k_sample, (jcfg.num_repeats * jcfg.num_sims, jcfg.top_k)))
    steps = td._build_dist_steps(tnet, tcfg)
    t_xs, t_vs, t_logp, t_reward = steps.improve_round(None, _t(adj), _t(seq), _t(xs), _t(vs), u=u)
    np.testing.assert_array_equal(t_xs.numpy(), np.asarray(xs2))
    np.testing.assert_array_equal(t_vs.numpy(), np.asarray(vs2))
    np.testing.assert_array_equal(t_reward.numpy(), np.asarray(vs2 - vs))
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(logp), atol=1e-4, rtol=0)
    assert (np.asarray(vs2) > np.asarray(vs)).any()


def test_update_matches_jax():
    jcfg, tcfg = _jcfg()
    g, adj, seq, xs, net, params, tnet = _policy_case(jcfg, seed=4)
    ja, jx, jseq = jnp.asarray(adj), jnp.asarray(xs), jnp.asarray(seq)
    vs = jd._cut_value_adj(jx, ja)
    key = jax.random.PRNGKey(12)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(jcfg.lr))
    opt_state = jax.jit(optimizer.init)(params)

    def loss_fn(p):  # the JAX package's `update` loss
        k, total, xs_c, vs_c = key, 0.0, jx, vs
        for t in range(jcfg.seq_len):
            k = jax.random.fold_in(k, t)
            k_sample, _ = jax.random.split(k)
            logits, _ = net.apply(p, jtr.solution_to_prob_channels(xs_c), jseq)
            probs = jax.nn.softmax(logits, axis=-1)[..., 0]
            cand = j_sub_set_sampling(k_sample, probs, xs_c, 1, jcfg.top_k)
            cand = jd.sweep_1flip_adj(cand, ja, jcfg.ls_sweeps)
            xs_new, vs_new = j_update(xs_c, vs_c, cand, jd._cut_value_adj(cand, ja))
            reward = vs_new - vs_c
            s = jax.lax.stop_gradient(cand.astype(jnp.float32))
            logp = jnp.log(jnp.clip(s * probs + (1 - s) * (1 - probs), 1e-8)).sum(1)
            total = total - jnp.mean(logp * jax.lax.stop_gradient(reward - reward.mean()))
            xs_c, vs_c = jax.lax.stop_gradient(xs_new), jax.lax.stop_gradient(vs_new)
        return total / jcfg.seq_len, (xs_c, vs_c)

    (loss, (xs2, vs2)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    params = jax.jit(lambda g, s, p: optax.apply_updates(p, optimizer.update(g, s, p)[0]))(grads, opt_state, params)
    # the same per-step draws: fold_in, then split, as the JAX loop keys them
    us, k = [], key
    for t in range(jcfg.seq_len):
        k = jax.random.fold_in(k, t)
        us.append(_t(jax.random.uniform(jax.random.split(k)[0], (jcfg.num_sims, jcfg.top_k))))

    steps = td._build_dist_steps(tnet, tcfg, ClippedAdam(tnet.parameters(), tcfg.lr))
    t_xs, t_vs, t_loss = steps.update(None, _t(adj), _t(seq), _t(xs), _t(vs), us=us)
    np.testing.assert_array_equal(t_xs.numpy(), np.asarray(xs2))
    np.testing.assert_array_equal(t_vs.numpy(), np.asarray(vs2))
    np.testing.assert_allclose(float(t_loss), float(loss), atol=1e-4, rtol=0)
    _assert_grads_close(tnet, grads)  # the step left .grad as the loss's gradient
    _assert_params_close(tnet, params, atol=1e-4)
    assert float(loss) != 0.0


def _guided_draws(key, s, n, num_repeats, top_k):
    """JAX's draws of one `_guided_round`, in the order it splits its key;
    None where a row draws a position twice with two values, which neither
    package's scatter orders."""
    k_sample, _, k_pos, k_draw = jax.random.split(key, 4)
    k_e = min(top_k, n)
    ids = np.asarray(jax.random.randint(k_pos, (s, k_e), 0, n))
    bern = np.asarray(jax.random.bernoulli(k_draw, 0.5, (s, k_e)))
    for row_ids, row_bits in zip(ids, bern):
        if any(len({b for i2, b in zip(row_ids, row_bits) if i2 == i}) > 1 for i in row_ids):
            return None
    return td.GuidedDraws(_t(jax.random.uniform(k_sample, (num_repeats * s, top_k))), _t(ids), _t(bern), 0)


def _ordered_key(rounds, s, n, num_repeats, top_k):
    """The first key of a fixed sequence whose rounds' exploration draws all
    have an order (see `_guided_draws`), and those draws."""
    for i in range(100):
        key = jax.random.fold_in(jax.random.PRNGKey(13), i)
        draws = [_guided_draws(k, s, n, num_repeats, top_k) for k in jax.random.split(key, rounds)]
        if all(d is not None for d in draws):
            return key, draws
    raise AssertionError("no key with ordered exploration draws")


@pytest.mark.parametrize("rounds", [1, 3])
def test_guided_rounds_xla_path_match_jax(rounds):
    jcfg, _ = _jcfg(num_sims=10)
    g, adj, seq, xs, net, params, tnet = _policy_case(jcfg, seed=5)
    ja, jx, jseq = jnp.asarray(adj), jnp.asarray(xs), jnp.asarray(seq)
    vs = jd._cut_value_adj(jx, ja)
    kw = dict(num_repeats=3, top_k=4, num_sweeps=2)
    key, draws = _ordered_key(rounds, 10, N, 3, 4)
    want_xs, want_vs = jd._guided_block(net, params, jseq, key, None, ja, jx, vs, block_chains=30, kernel=None,
                                        block_len=rounds, **kw)
    got_xs, got_vs = td._guided_block(tnet, _t(seq), None, None, _t(adj), _t(xs), _t(vs), block_len=rounds,
                                      draws=draws, **kw)
    np.testing.assert_array_equal(got_xs.numpy(), np.asarray(want_xs))
    np.testing.assert_array_equal(got_vs.numpy(), np.asarray(want_vs))
    assert (np.asarray(want_vs) > np.asarray(vs)).any()


def test_perturb_round_matches_jax():
    jcfg, tcfg = _jcfg()
    g, adj, seq, xs, net, params, tnet = _policy_case(jcfg, seed=6)
    ja, jx, jseq = jnp.asarray(adj), jnp.asarray(xs), jnp.asarray(seq)
    vs = jd._cut_value_adj(jx, ja)
    k_sample, k_noise = jax.random.split(jax.random.PRNGKey(14))

    @jax.jit
    def perturb_round(params, jx, vs):  # the body of `improve` in the JAX package's `evaluate_l2a_distribution`
        logits, _ = NET.apply(params, jtr.solution_to_prob_channels(jx), jseq)
        probs = jax.nn.softmax(logits, axis=-1)[..., 0]
        cand = jd.sweep_1flip_adj(j_sub_set_sampling(k_sample, probs, jx, jcfg.num_repeats, jcfg.top_k), ja,
                                  jcfg.ls_sweeps)
        cand_vs = jd._cut_value_adj(cand, ja)
        rows = jnp.argmax(cand_vs.reshape(jcfg.num_repeats, jcfg.num_sims), axis=0) * jcfg.num_sims + jnp.arange(
            jcfg.num_sims)
        x1, v1 = j_update(jx, vs, cand[rows], cand_vs[rows])
        gains = jd.flip_gains_adj(x1, ja)
        noise = jax.random.normal(k_noise, gains.shape)
        noisy = gains + noise * (0.25 * jnp.std(gains, axis=1, keepdims=True) + 1e-3)
        thresh = jnp.sort(noisy, axis=1)[:, -max(2, jcfg.top_k // 2)][:, None]
        pert = jd.sweep_1flip_adj(jnp.logical_xor(x1, noisy >= thresh), ja, jcfg.ls_sweeps)
        return (*j_update(x1, v1, pert, jd._cut_value_adj(pert, ja)), noise)

    want_xs, want_vs, noise = perturb_round(params, jx, vs)
    u = _t(jax.random.uniform(k_sample, (jcfg.num_repeats * jcfg.num_sims, jcfg.top_k)))
    got_xs, got_vs = td._perturb_round(tnet, _t(seq), None, _t(adj), _t(xs), _t(vs), tcfg, u=u, noise=_t(noise))
    np.testing.assert_array_equal(got_xs.numpy(), np.asarray(want_xs))
    np.testing.assert_array_equal(got_vs.numpy(), np.asarray(want_vs))


@functools.lru_cache(maxsize=None)
def _jax_bundle(n, seed=0):
    """An untrained JAX bundle at width D: flax's inits, no training step."""
    cfg = jd.L2ADistConfig(graph_type=JGraphType.BA, num_nodes=n, num_sims=8, num_repeats=2, top_k=10,
                           embed_dim=D, num_heads=H, num_validation=1, seed=seed)
    enc, enc_init, _ = _encoder(n)
    enc_params = enc_init(jax.random.PRNGKey(seed), jd._sample_adj(cfg, 0)[None])
    return {"net": NET, "params": _net_params(seed + 1), "encoder": enc, "encoder_params": enc_params,
            "history": [], "config": cfg}


def test_bundle_from_jax_carries_the_weights():
    jb = _jax_bundle(N)
    tb = td.bundle_from_jax(jb, "cpu")
    assert tb["config"].graph_type.value == "BA" and tb["config"].num_nodes == N
    adj = jd._sample_adj(jb["config"], 5)
    seq = _encoder(N)[2](jb["encoder_params"], adj)
    np.testing.assert_allclose(td._embed(tb["encoder"], _t(adj)).numpy(), np.asarray(seq), atol=1e-4, rtol=0)
    xs = np.random.default_rng(8).random((4, N)) < 0.5
    logits, value = _net_apply(jb["params"], jtr.solution_to_prob_channels(jnp.asarray(xs)), seq)
    t_logits, t_value = tb["net"](ttr.solution_to_prob_channels(_t(xs)), _t(seq))
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_value.detach().numpy(), np.asarray(value), atol=1e-3, rtol=0)


EVAL = dict(num_rounds=8, num_sims=16, num_repeats=4, num_sweeps=2)


def test_evaluate_l2a_packed_best_cuts_equal_host_rescore():
    _, tcfg = _jcfg(num_nodes=100, pretrain_steps=0, num_iters=0, top_k=10)
    tb = td.train_l2a_distribution(tcfg, device="cpu")
    g = graph_from_name("BA_100_ID0")
    vals, xs = td.evaluate_l2a_packed(tb, [g, g], use_packed=True, seed=1, return_xs=True, **EVAL)
    assert [obj_maxcut(x.astype(np.int64), g) for x in xs] == list(vals)
    assert vals.min() >= 270


def test_evaluate_l2a_packed_mean_within_jax_spread():
    """Seeds do not carry across generators: the port's packed search (the
    plain Philox sweeps here) against JAX's XLA-path evaluator on the same
    weights and budget, over 3 seeds."""
    jb = _jax_bundle(100)
    tb = td.bundle_from_jax(jb, "cpu")
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    j_cuts = [float(jd.evaluate_l2a_packed(jb, [jg], seed=s, use_packed=False, **EVAL)[0]) for s in range(3)]
    t_cuts = [float(td.evaluate_l2a_packed(tb, [tg], seed=s, use_packed=True, **EVAL)[0]) for s in range(3)]
    assert np.mean(t_cuts) >= np.mean(j_cuts) - (max(j_cuts) - min(j_cuts)), (t_cuts, j_cuts)


def test_train_validate_and_evaluate_distribution_on_cpu():
    _, tcfg = _jcfg(num_sims=16, top_k=6, num_iters=3, pretrain_steps=4, num_validation=2)
    timings = {}
    bundle = td.train_l2a_distribution(tcfg, device="cpu", timings=timings)
    assert [len(timings[k]) for k in ("pretrain", "iteration")] == [1, tcfg.num_iters]
    assert len(bundle["history"]) == tcfg.num_iters and np.isfinite([h["loss"] for h in bundle["history"]]).all()
    half = np.mean([0.5 * graph_from_name(f"BA_{N}_ID{77_000 + v}").total_weight
                    for v in range(tcfg.num_validation)])
    assert bundle["validate"]() > half
    adjs = [graph_from_name(f"BA_{N}_ID{s}").adjacency_dense() for s in (0, 1)]
    vals = td.evaluate_l2a_distribution(bundle, adjs, num_rounds=8, num_sims=8)
    for a, v in zip(adjs, vals):
        assert 0.5 * a.sum() / 2 < v <= a.sum() / 2 and v == int(v)
