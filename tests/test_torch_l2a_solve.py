"""The L2A solve as a whole: on BA_100_ID0 at a small config, the port's
best cuts equal their host re-scores and land within the spread of JAX's
over the same seeds (seeds do not carry across generators)."""

import numpy as np
import torch

from rlsolver_tpu.algos import l2a as jl2a
from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
from rlsolver_tpu_torch.algos import l2a as tl2a
from rlsolver_tpu_torch.core.generate import graph_from_name
from rlsolver_tpu_torch.problems.objectives import obj_maxcut

torch.set_num_threads(1)

SMALL = dict(num_sims=16, num_repeats=4, top_k=8, num_searchers=1, seq_len=4, num_iters=2, embed_dim=32,
             pretrain_steps=30, update_times=4, ls_iters=2)


def test_solve_l2a_within_jax_spread():
    jg, tg = j_graph_from_name("BA_100_ID0"), graph_from_name("BA_100_ID0")
    j_cuts = [jl2a.solve_maxcut_l2a(jg, jl2a.L2AConfig(seed=s, **SMALL))[1] for s in range(3)]
    t_cuts = []
    for s in range(3):
        timings = {}
        x, v, ev = tl2a.solve_maxcut_l2a(tg, tl2a.L2AConfig(seed=s, **SMALL), device="cpu", timings=timings)
        assert v == obj_maxcut(x.astype(np.int64), tg)
        assert len(ev.records) == 1 + SMALL["num_iters"]
        assert [len(timings[k]) for k in ("pretrain", "rollout", "ppo")] == [1, 8, 2]
        t_cuts.append(v)
    # seeds do not carry across generators: compare the cut distributions
    assert min(j_cuts) <= np.mean(t_cuts) <= max(j_cuts), (t_cuts, j_cuts)
