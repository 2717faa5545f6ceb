"""The TSP attention model and POMO (`models/attention_tsp.py`,
`algos/am_pomo.py`) against flax/optax on the JAX package's parameters
(`convert.attention_tsp_state_dict`): the forward's encodings within
1e-5 and its logits within 1e-5 of each; a sampled POMO rollout with JAX's Gumbel noise injected
(actions equal, log-probs within 1e-4); one POMO training step (parameters
within 1e-5; the attention's key biases, whose gradient is zero, within lr
of their start); beam search and x8 greedy inference (tours equal); the
augmentation and the tour lengths. N = 10 cities, embed 32, 2 layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import am_pomo as jap
from rlsolver_tpu.models.attention_tsp import AttentionTSP as JAttentionTSP
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import am_pomo as tap
from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP

torch.set_num_threads(1)
N, D, H, L, BATCH = 10, 32, 4, 2, 3
CFG = dict(num_cities=N, embed_dim=D, num_heads=H, num_layers=L, batch_size=BATCH, num_steps=1)


def models(seed: int = 0):
    cfg = jap.POMOConfig(**CFG, seed=seed)
    jm = JAttentionTSP(D, H, L)
    opt, step = jap.make_pomo_step(jm, cfg)
    state = jap.init_pomo_state(jm, cfg, opt)
    tm = AttentionTSP(D, H, L, device="cpu")
    tm.load_state_dict(convert.attention_tsp_state_dict(jax.tree.map(np.asarray, state.params)))
    return jm, tm, state, step, cfg


def nodes_of(seed: int, b: int = BATCH) -> np.ndarray:
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (b, N, 2)))


def test_forward_matches_flax():
    jm, tm, state, _, _ = models()
    nodes = nodes_of(1)
    rng = np.random.default_rng(0)
    p = 4  # starts
    visited = rng.random((BATCH, p, N)) < 0.4
    cur, fst = rng.integers(0, N, (BATCH, p)), rng.integers(0, N, (BATCH, p))
    visited[np.arange(BATCH)[:, None], np.arange(p)[None, :], cur] = True
    jl, je = jm.apply(state.params, jnp.asarray(nodes), jnp.asarray(cur, jnp.int32), jnp.asarray(fst, jnp.int32),
                      jnp.asarray(~visited))
    with torch.no_grad():
        tl, te = tm(torch.from_numpy(nodes), torch.from_numpy(cur), torch.from_numpy(fst), torch.from_numpy(~visited))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-5)
    # logits reach C = 10: 1e-5 of each, f32 noise (JAX's own jitted and eager
    # forwards differ by 9.5e-6 here)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    assert (tl.numpy()[visited] == -1e4).all()


def _gumbel(key, b, p):
    return np.stack([np.asarray(jax.random.gumbel(k, (b, p, N))) for k in jax.random.split(key, N - 1)])


def test_sampled_rollout_matches_with_jax_gumbel():
    jm, tm, state, _, _ = models(1)
    nodes = nodes_of(2)
    key = jax.random.PRNGKey(9)
    ja, jlp, jlen = jap.rollout_pomo(jm, state.params, key, jnp.asarray(nodes), pomo_size=6)
    with torch.no_grad():
        ta, tlp, tlen = tap.rollout_pomo(tm, torch.from_numpy(nodes), 6,
                                         gumbel=torch.from_numpy(_gumbel(key, BATCH, 6)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlen.numpy(), np.asarray(jlen), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tap.tour_lengths(torch.from_numpy(nodes), ta).numpy(),
                               np.asarray(jap.tour_lengths(jnp.asarray(nodes), ja)), rtol=0, atol=1e-6)


def test_pomo_training_step_matches_optax():
    jm, tm, state, step, cfg = models(2)
    _, k_data, k_roll = jax.random.split(state.key, 3)
    nodes = np.array(jax.random.uniform(k_data, (BATCH, N, 2)))
    new_state, jmetrics = jax.jit(step)(state)
    _, tstep = tap.make_pomo_step(tm, tap.POMOConfig(**CFG))
    tmetrics = tstep(draws=tap.POMODraws(torch.from_numpy(nodes), torch.from_numpy(_gumbel(k_roll, BATCH, N))))
    for k in ("loss", "mean_length", "best_length"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=0, atol=1e-5, err_msg=k)
    ref = convert.attention_tsp_state_dict(jax.tree.map(np.asarray, new_state.params))
    old = convert.attention_tsp_state_dict(jax.tree.map(np.asarray, state.params))
    for k, v in tm.state_dict().items():
        if k.endswith("key.bias"):
            # a key bias adds the same q . b to every score of a query: its
            # gradient is zero, so both packages move it by f32 noise, which
            # Adam's first step scales up to at most lr
            assert np.abs(v.numpy() - old[k].numpy()).max() <= 1.01e-4, k
            continue
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_beam_search_and_x8_inference_equal():
    jm, tm, state, _, _ = models(3)
    nodes = nodes_of(4, 4)
    jt, jl = jap.beam_search(jm, state.params, jnp.asarray(nodes), beam_width=4)
    tt, tl = tap.beam_search(tm, torch.from_numpy(nodes), beam_width=4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    jt, jl = jap.infer_pomo(jm, state.params, jnp.asarray(nodes))
    tt, tl = tap.infer_pomo(tm, torch.from_numpy(nodes))
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tap.augment_coords_x8(torch.from_numpy(nodes)).numpy(),
                                  np.asarray(jap.augment_coords_x8(jnp.asarray(nodes))))
    for row in tt.numpy():
        assert sorted(row.tolist()) == list(range(N))


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_captured_adam_step_equals_eager(scale):
    # `ClippedAdam.step(corr=...)`, the form a CUDA graph holds (the clip a
    # `where`, the count and the bias corrections the caller's), moves the
    # parameters exactly as the eager step, on both sides of the clip
    from rlsolver_tpu_torch.optim import ClippedAdam

    rng = np.random.default_rng(0)
    start = [torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)) for _ in range(2)]
    ps = [[p.clone() for p in start] for _ in range(2)]
    opts = [ClippedAdam(p, 1e-2, max_norm=1.0) for p in ps]
    for _ in range(3):
        grads = [torch.from_numpy(scale * rng.standard_normal((4, 3)).astype(np.float32)) for _ in range(2)]
        for params in ps:
            for p, g in zip(params, grads):
                p.grad = g.clone()
        opts[0].step()
        opts[1].step(corr=opts[1].corrections())
    for a, b in zip(ps[0], ps[1]):
        assert torch.equal(a, b)
    assert opts[0].count == opts[1].count == 3


def test_training_lowers_the_length():
    _, hist = tap.train_pomo(tap.POMOConfig(**dict(CFG, num_steps=30, batch_size=16), lr=1e-3), device="cpu")
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert np.mean([h["mean_length"] for h in hist[-5:]]) < np.mean([h["mean_length"] for h in hist[:5]])


ENTRY_POINTS = {
    "AttentionTSP": lambda dev: AttentionTSP(8, 2, 1, device=dev).embed.kernel,
    "train_pomo": lambda dev: tap.train_pomo(tap.POMOConfig(**dict(CFG, embed_dim=8, num_layers=1)),
                                             device=dev)[0].embed.kernel,
    "eval_nodes": lambda dev: tap.eval_nodes(2, N, 0, device=dev),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
