"""The REINFORCE baseline zoo and trainer (`algos/reinforce_baselines.py`)
against the JAX package's: every baseline's `eval` over three successive
reward batches within 1e-6 (the critic on JAX's converted parameters, and
its Adam step within 1e-6; the rollout baseline's greedy values within
1e-5 on JAX's converted policy), the t-test's survival function and the
rollout baseline's decision on fixed difference vectors equal; the
rollout baseline's epoch update adopting a better candidate; and
`train_reinforce` with the TSP and the S2V maxcut adapters (finite
losses, rewards equal to host re-scores)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlsolver_tpu.algos import am_pomo as jap
from rlsolver_tpu.algos import reinforce_baselines as jrb
from rlsolver_tpu.models.attention_tsp import AttentionTSP as JAttentionTSP
from rlsolver_tpu_torch import convert
from rlsolver_tpu_torch.algos import reinforce_baselines as trb
from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)
N, BATCH, P = 8, 5, 3


def rewards_and_nodes(seed: int, pomo: bool):
    rng = np.random.default_rng(seed)
    r = rng.normal(-4.0, 0.5, (BATCH, P) if pomo else (BATCH,)).astype(np.float32)
    return r, rng.random((BATCH, N, 2)).astype(np.float32)


@pytest.mark.parametrize("name", ["no", "shared", "exponential", "mean", "warmup_exponential", "warmup_shared",
                                  "critic"])
def test_baseline_evals_match(name):
    pomo = "shared" in name
    jb, tb = jrb.get_reinforce_baseline(name), trb.get_reinforce_baseline(name)
    if name == "warmup_shared":
        jb.n_steps = tb.n_steps = 2
    _, nodes0 = rewards_and_nodes(0, pomo)
    js = jb.init(jax.random.PRNGKey(0), None, None, jnp.asarray(nodes0))
    ts = tb.init(None, torch.from_numpy(nodes0))
    if name == "critic":
        ts.critic.load_state_dict(convert.critic_state_dict(jax.tree.map(np.asarray, js.critic_params)))
    for step in range(3):
        r, nodes = rewards_and_nodes(step + 1, pomo)
        jv, js = jb.eval(js, jnp.asarray(r), jnp.asarray(nodes))
        tv, ts = tb.eval(ts, torch.from_numpy(r), torch.from_numpy(nodes))
        assert tuple(tv.shape) == np.shape(jv)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
        if name == "critic":
            js = jb.update_critic(js, jnp.asarray(r), jnp.asarray(nodes))
            ts = tb.update_critic(ts, torch.from_numpy(r), torch.from_numpy(nodes))
            ref = convert.critic_state_dict(jax.tree.map(np.asarray, js.critic_params))
            for k, v in ts.critic.state_dict().items():
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_shared_baseline_refuses_flat_rewards():
    with pytest.raises(ValueError, match="shared"):
        trb.SharedBaseline().eval(trb.BaselineState(), torch.zeros(3), None)
    with pytest.raises(ValueError, match="unknown baseline"):
        trb.get_reinforce_baseline("nope")


def test_t_test_and_swap_decision_equal():
    for t in (-3.0, -0.2, 0.0, 0.7, 1.8, 2.5, 6.0):
        for df in (1, 4, 30, 255):
            assert trb._t_sf(t, df) == jrb._t_sf(t, df)
    rng = np.random.default_rng(3)
    for shift in (-0.1, 0.0, 0.02, 0.05, 0.3):
        diff = rng.normal(shift, 0.2, 64)
        # `RolloutBaseline.epoch_update`'s test in the JAX package, on the same diff
        expected = diff.mean() > 0 and jrb._t_sf(diff.mean() / max(diff.std(ddof=1) / np.sqrt(64), 1e-12), 63) < 0.05
        assert trb.rollout_swap(diff, 0.05) == expected


def test_rollout_baseline_matches_and_swaps():
    cfg = jap.POMOConfig(num_cities=N, embed_dim=16, num_heads=2, num_layers=1, batch_size=BATCH)
    jm = JAttentionTSP(16, 2, 1)
    opt, _ = jap.make_pomo_step(jm, cfg)
    params = jap.init_pomo_state(jm, cfg, opt).params
    tm = AttentionTSP(16, 2, 1, device="cpu")
    tm.load_state_dict(convert.attention_tsp_state_dict(jax.tree.map(np.asarray, params)))
    _, nodes = rewards_and_nodes(5, False)
    ev = jnp.asarray(nodes)
    jb = jrb.get_reinforce_baseline("rollout", model=jm, eval_nodes=ev)
    tb = trb.get_reinforce_baseline("rollout", eval_nodes=torch.from_numpy(nodes))
    js = jb.init(None, jm, params, ev)
    ts = tb.init(tm, torch.from_numpy(nodes))
    assert abs(ts.frozen_mean - float(js.frozen_mean)) < 1e-5
    r, _ = rewards_and_nodes(6, True)
    jv, _ = jb.eval(js, jnp.asarray(r), ev)
    tv, _ = tb.eval(ts, torch.from_numpy(r), torch.from_numpy(nodes))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert tb.epoch_update(ts, tm).swaps == 0  # the same policy: no gain
    better = trb.RolloutBaseline(torch.from_numpy(nodes))
    better.greedy_rewards = lambda model, x: torch.full((x.shape[0],), 0.0) if model is tm else \
        torch.linspace(-1.0, -0.9, x.shape[0])
    st = better.epoch_update(trb.BaselineState(frozen=AttentionTSP(16, 2, 1, device="cpu")), tm)
    assert st.swaps == 1 and st.frozen is not tm and st.frozen_mean == 0.0


@pytest.mark.parametrize("name", ["exponential", "critic", "rollout"])
def test_train_reinforce_tsp(name):
    cfg = trb.ReinforceConfig(num_cities=N, embed_dim=16, num_heads=2, num_layers=1, batch_size=8, num_steps=4,
                              epoch_every=2)
    kw = {"eval_nodes": torch.rand(16, N, 2, generator=torch.Generator().manual_seed(1))} if name == "rollout" else {}
    model, hist, state = trb.train_reinforce(trb.get_reinforce_baseline(name, **kw), cfg, device="cpu")
    assert len(hist["mean_length"]) == 4 and np.isfinite(hist["mean_length"]).all() and np.isfinite(hist["loss"]).all()
    assert all(2.0 < x < 8.0 for x in hist["mean_length"])


def test_train_reinforce_s2v_maxcut():
    cfg = trb.ReinforceConfig(embed_dim=16, num_layers=2, batch_size=6, num_steps=3, epoch_every=0, lr=1e-3)
    adapter = trb.S2VMaxcutAdapter(cfg, num_nodes=16, pool_size=5, device="cpu")
    model, hist, _ = trb.train_reinforce(trb.get_reinforce_baseline("mean"), cfg, adapter=adapter)
    assert np.isfinite(hist["mean_reward"]).all() and np.isfinite(hist["loss"]).all()
    from rlsolver_tpu_torch.core.generate import generate_graph
    from rlsolver_tpu_torch.config import GraphType

    graphs = [generate_graph(GraphType.BA, 16, seed=s) for s in range(5)]
    np.testing.assert_array_equal(adapter.pool().numpy(), np.stack([g.adjacency_dense() for g in graphs]))
    xs, _, cuts = adapter.rollout(model, adapter.pool(), greedy=True)
    assert [obj_maxcut(x.numpy().astype(np.int64), g) for x, g in zip(xs, graphs)] == cuts.tolist()


ENTRY_POINTS = {
    "TSPAdapter": lambda dev: trb.TSPAdapter(trb.ReinforceConfig(batch_size=1), device=dev).sample_instances(None),
    "S2VMaxcutAdapter": lambda dev: trb.S2VMaxcutAdapter(trb.ReinforceConfig(), 8, pool_size=1, device=dev).pool(),
    "train_reinforce": lambda dev: trb.train_reinforce(
        trb.NoBaseline(), trb.ReinforceConfig(num_cities=5, embed_dim=8, num_layers=1, batch_size=2, num_steps=1),
        device=dev)[0].embed.kernel,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](None)
