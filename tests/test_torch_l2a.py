"""Port parity for L2A: the networks against flax with converted params, one
pretraining step and one PPO update against JAX on the same batch and
indices (the optax state carried across), GAE, `sub_set_sampling` with
injected uniforms, and solves on the packed paths (the solve against JAX's
cut spread is in `test_torch_l2a_solve.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlsolver_tpu.algos import l2a as jl2a
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
from rlsolver_tpu.models import transformer as jtr
from rlsolver_tpu.ops.sampling import sub_set_sampling as j_sub_set_sampling
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import l2a as tl2a
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
from rlsolver_tpu_torch.models import transformer as ttr
from rlsolver_tpu_torch.ops.sampling import sub_set_sampling
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)

D, H, N = 32, 4, 24


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, params):
    module.load_state_dict(convert.flax_state_dict(_np(params)))
    return module


def _assert_params_close(module, params, atol):
    """Every parameter within atol, except the attention's key biases: a key
    bias adds the same term to every score of a query, which the softmax
    cancels, so its gradient is rounding noise that Adam scales up to a step
    of about lr in either package. (The outputs do not depend on it.)"""
    want = convert.flax_state_dict(_np(params))
    got = dict(module.named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if not k.endswith("key.bias"):
            np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("budget", [1 << 28, 4 * 3 * H * N * 5], ids=["whole", "chunked"])
def test_chunked_mha_matches_flax(budget):
    x = np.random.default_rng(0).normal(size=(3, N, D)).astype(np.float32)
    jm = jtr.ChunkedMHA(num_heads=H, score_budget=budget)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(x))
    tm = _load(ttr.ChunkedMHA(D, H, torch.Generator(), score_budget=budget), params)
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    out = tm(xt, xt)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5, rtol=0)
    # under autograd the chunks are recomputed: the same gradient as whole
    out.square().sum().backward()
    whole = _load(ttr.ChunkedMHA(D, H, torch.Generator()), params)
    xw = _t(x).requires_grad_()
    whole(xw, xw).square().sum().backward()
    torch.testing.assert_close(xt.grad, xw.grad, rtol=1e-5, atol=1e-5)


def _graph_case():
    jg = j_graph_from_name(f"BA_{N}_ID0")
    adj = jnp.asarray(jg.adjacency_dense(), jnp.float32)
    enc = jtr.GraphEncoder(num_nodes=N, embed_dim=D, num_heads=H)
    return jg, adj, enc, enc.init(jax.random.PRNGKey(1), adj[None])


def test_graph_encoder_matches_flax():
    _, adj, enc, params = _graph_case()
    tenc = _load(ttr.GraphEncoder(N, D, H, device="cpu"), params)
    recon, seq = enc.apply(params, adj[None])
    t_recon, t_seq = tenc(_t(adj)[None])
    np.testing.assert_allclose(t_recon.detach().numpy(), np.asarray(recon), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_seq.detach().numpy(), np.asarray(seq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tenc.embed(_t(adj)[None]).detach().numpy(), np.asarray(enc.embed(params, adj[None])),
                               atol=1e-4, rtol=0)


def _policy_case(b=5):
    rng = np.random.default_rng(2)
    xs = rng.random((b, N)) < 0.5
    seq = rng.normal(size=(N, D)).astype(np.float32)
    net = jtr.PolicyTrsWithValue(embed_dim=D, num_heads=H)
    params = net.init(jax.random.PRNGKey(3), jtr.solution_to_prob_channels(jnp.asarray(xs)), jnp.asarray(seq))
    return xs, seq, net, params


def test_policy_matches_flax():
    xs, seq, net, params = _policy_case()
    tnet = _load(ttr.PolicyTrsWithValue(D, H, device="cpu"), params)
    np.testing.assert_array_equal(ttr.solution_to_prob_channels(_t(xs)).numpy(),
                                  np.asarray(jtr.solution_to_prob_channels(jnp.asarray(xs))))
    logits, value = net.apply(params, jtr.solution_to_prob_channels(jnp.asarray(xs)), jnp.asarray(seq))
    t_logits, t_value = tnet(ttr.solution_to_prob_channels(_t(xs)), _t(seq))
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(logits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_value.detach().numpy(), np.asarray(value), atol=1e-4, rtol=0)


def test_pretrain_steps_match_jax():
    _, adj, enc, params = _graph_case()
    tenc = _load(ttr.GraphEncoder(N, D, H, device="cpu"), params)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    t_opt = ClippedAdam(tenc.parameters(), 1e-3, max_norm=None)
    rng = np.random.default_rng(4)

    @jax.jit
    def loss_and_grads(p, keep):  # the body of the JAX package's pretraining step
        def loss_fn(p):
            recon, _ = enc.apply(p, (adj * keep * keep.T)[None])
            return optax.sigmoid_binary_cross_entropy(recon[0], (adj > 0).astype(jnp.float32)).mean()

        return jax.value_and_grad(loss_fn)(p)

    for _ in range(2):  # the second step reads the carried Adam moments
        keep = rng.random((N, N)) < 0.9
        loss, grads = loss_and_grads(params, jnp.asarray(keep))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        t_loss = tl2a.pretrain_step(tenc, t_opt, _t(adj), torch.from_numpy(keep))
        np.testing.assert_allclose(float(t_loss), float(loss), atol=1e-5, rtol=0)
    _assert_params_close(tenc, params, atol=1e-4)
    np.testing.assert_allclose(tenc(_t(adj)[None])[0].detach().numpy(), np.asarray(enc.apply(params, adj[None])[0]),
                               atol=1e-4, rtol=0)


def _gae_jax(rewards, values, lam):
    def body(carry, inp):
        next_value, adv = carry
        r, v = inp
        adv = r + next_value - v + lam * adv
        return (v, adv), adv

    zeros = jnp.zeros_like(rewards[0])
    return jax.lax.scan(body, (zeros, zeros), (rewards, values), reverse=True)[1]


def test_gae_matches_jax_scan():
    rng = np.random.default_rng(5)
    rewards, values = (rng.normal(size=(7, 9)).astype(np.float32) for _ in range(2))
    want = np.asarray(_gae_jax(jnp.asarray(rewards), jnp.asarray(values), 0.98))
    np.testing.assert_allclose(tl2a.gae_advantages(_t(rewards), _t(values), 0.98).numpy(), want, atol=1e-6, rtol=0)


def test_ppo_update_matches_jax():
    """One JAX PPO update warms the optax state; both packages then run the
    next update on the same batch and minibatch indices."""
    T, B = 3, 8
    cfg = jl2a.L2AConfig(num_sims=B, seq_len=T, update_times=2, embed_dim=D, num_heads=H, lr=1e-3)
    jg = j_graph_from_name(f"BA_{N}_ID0")
    xs, seq, net, params = _policy_case(b=B)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(cfg.lr))
    opt_state = optimizer.init(params)
    ppo = jax.jit(jl2a._build_l2a_steps(JEnv(jg), net, jnp.asarray(seq), cfg, optimizer)[1])
    rng = np.random.default_rng(6)
    batch = jl2a.RolloutBatch(states=jnp.asarray(rng.random((T + 1, B, N)) < 0.5),
                              rewards=jnp.asarray(rng.integers(0, 4, (T, B)).astype(np.float32)),
                              logprobs=jnp.asarray(rng.normal(-16.0, 1.0, (T, B)).astype(np.float32)))
    params, opt_state, _ = ppo(jax.random.PRNGKey(7), params, opt_state, batch)

    tnet = _load(ttr.PolicyTrsWithValue(D, H, device="cpu"), params)
    names = [k for k, _ in tnet.named_parameters()]
    t_opt = ClippedAdam(tnet.parameters(), cfg.lr)
    t_opt.load_state_dict(convert.adam_state(_np(opt_state), names))
    t_cfg = tl2a.L2AConfig(num_sims=B, seq_len=T, update_times=2, embed_dim=D, num_heads=H, lr=1e-3)
    env = MaxcutEnv(graph_from_name(f"BA_{N}_ID0"), "cpu")
    steps = tl2a._build_l2a_steps(env, tnet, _t(seq), t_cfg, t_opt)

    key = jax.random.PRNGKey(8)
    ids = [torch.from_numpy(np.array(jax.random.randint(k, (B,), 0, T * B))).long()
           for k in jax.random.split(key, cfg.update_times)]
    params, opt_state, losses = ppo(key, params, opt_state, batch)
    t_losses = steps.ppo_update(None, tl2a.RolloutBatch(*(_t(a) for a in batch)), ids=ids)
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(losses), atol=1e-4, rtol=0)
    _assert_params_close(tnet, params, atol=1e-4)
    adam = convert.adam_state(_np(opt_state), names)
    assert t_opt.count == adam["count"] == 2 * cfg.update_times
    for mine, want in zip(t_opt.mu, adam["mu"]):
        np.testing.assert_allclose(mine.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_sub_set_sampling_bit_exact_with_injected_uniforms():
    rng = np.random.default_rng(9)
    b, n, reps, k = 6, 20, 3, 5
    probs = rng.uniform(0.02, 0.98, (b, n)).astype(np.float32)
    det = np.abs(probs - np.float32(0.5))
    assert all(len(set(row)) == n for row in det.tolist())  # top-k orders ties differently
    start = rng.random((b, n)) < 0.5
    key = jax.random.PRNGKey(10)
    want = np.asarray(j_sub_set_sampling(key, jnp.asarray(probs), jnp.asarray(start), reps, k))
    u = _t(jax.random.uniform(key, (reps * b, k)))
    got = sub_set_sampling(None, _t(probs), _t(start), reps, k, u=u)
    np.testing.assert_array_equal(got.numpy(), want)
    # drawn from a generator instead: only the k least certain bits move
    drawn = sub_set_sampling(torch.Generator().manual_seed(0), _t(probs), _t(start), reps, k)
    certain = np.argsort(-np.abs(probs - 0.5), axis=1)[:, : n - k]
    for r in range(reps):
        rows = drawn[r * b : (r + 1) * b].numpy()
        np.testing.assert_array_equal(np.take_along_axis(rows, certain, 1), np.take_along_axis(start, certain, 1))


SMALL = dict(num_sims=16, num_repeats=4, top_k=8, num_searchers=1, seq_len=4, num_iters=2, embed_dim=32,
             pretrain_steps=30, update_times=4, ls_iters=2)


@pytest.mark.parametrize("opts", [dict(packed_sweep=True), dict(fused_ls=True, fused_sweeps=2)],
                         ids=["packed_sweep", "fused_ls"])
def test_solve_l2a_packed_paths_on_cpu(opts):
    tg = graph_from_name("BA_100_ID0")
    x, v, _ = tl2a.solve_maxcut_l2a(tg, tl2a.L2AConfig(seed=1, **SMALL, **opts), device="cpu")
    assert v == obj_maxcut(x.astype(np.int64), tg) and v >= 270
