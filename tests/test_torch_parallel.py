"""The data-parallel layer (`parallel/`) against the JAX package's on the 8
virtual CPU devices: `tests/test_distributed.py`'s four cases and
`test_models_parallel.py`'s mesh, sharded-rollout and PolicyMLP cases, the
port's side run by spawned gloo ranks (`parallel.launch`) at world sizes 2
and 4, JAX's on as many devices; the 2-D cases on a (2, 2) mesh. Cuts, bits
and sums equal; PolicyMLP within 1e-6. Then `dryrun_multichip` at 2 and 4
ranks, and at 2 with extra work in its process group, and a rank that
raises fails its launch with its traceback within the time limit.

JAX is imported inside the fixtures and tests only: a spawned rank imports
this module to find its target and must not load JAX."""

import time

import numpy as np
import pytest
import torch

from rlsolver_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)
WORLDS = (2, 4)
SIMS_1D = 64  # test_models_parallel.py's, on BA_32_ID0
GRAPH_2D, SIMS_2D = "BA_24_ID0", 32  # test_distributed.py's


def _layer_rank(xs_1d, xs_2d):
    """One rank: the 1-D mesh and its sharded rollout, and at even world
    sizes the 2-D mesh, its collectives and its sharded env rollout."""
    import torch.distributed as dist

    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv
    from rlsolver_tpu_torch.parallel import distributed as d2, mesh as mesh_lib

    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh()
    env = MaxcutEnv(graph_from_name("BA_32_ID0"), "cpu")

    def per_shard(xs):
        xs2, vs2 = env.sweep_1flip(xs, env.obj(xs))
        best = mesh_lib.pmax(vs2.max(), mesh)
        return xs2, vs2, best.expand(xs.shape[0]).contiguous()

    xs_s, vs_s, best_s = mesh_lib.shard_rollout(mesh, per_shard)(torch.from_numpy(xs_1d))
    out = dict(mesh_size=mesh.size(), mesh_names=mesh.mesh_dim_names, xs=xs_s, vs=vs_s, best=best_s,
               local=mesh_lib.shard_env_batch(mesh, torch.arange(2 * n)))
    if n % 2 == 0:  # every world of the tests
        mesh2 = d2.make_host_device_mesh(num_hosts=2)
        out["mesh2_shape"], out["mesh2_names"] = tuple(mesh2.mesh.shape), mesh2.mesh_dim_names
        x = torch.arange(float(n))
        both = d2.shard_rollout_2d(mesh2, lambda s: torch.full_like(s, float(d2.psum_all(s.sum(), mesh2))))
        out["both_axes"] = both(x)
        env2 = MaxcutEnv(graph_from_name(GRAPH_2D), "cpu")

        def rollout(xs):
            vs = env2.obj(xs)
            return (d2.pmax_all(vs.max(), mesh2) - d2.pmean_all(vs.mean(), mesh2)).expand(xs.shape[0]).contiguous()

        out["rollout_2d"] = d2.shard_rollout_2d(mesh2, rollout)(torch.from_numpy(xs_2d))
    return out


def _failing_rank(bad_rank):
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} stops here")
    dist.barrier()  # the others wait for it: the group's timeout ends them
    return dist.get_rank()


def _jax_mesh_2d(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]).reshape(2, n // 2), ("host", "device"))


@pytest.fixture(scope="module")
def inputs():
    import jax

    from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
    from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv

    xs_1d = np.array(JEnv(j_graph_from_name("BA_32_ID0")).random_xs(jax.random.PRNGKey(0), SIMS_1D))
    xs_2d = np.array(JEnv(j_graph_from_name(GRAPH_2D)).random_xs(jax.random.PRNGKey(0), SIMS_2D))
    return xs_1d, xs_2d


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request, inputs, tmp_path_factory):
    n = request.param
    return n, launch(_layer_rank, n, inputs, device="cpu", timeout_s=60, join_timeout_s=180,
                     store_dir=str(tmp_path_factory.mktemp("store")))


def test_initialize_noop_single_process():
    from rlsolver_tpu.parallel.distributed import initialize_multihost as j_initialize
    from rlsolver_tpu_torch.parallel.distributed import initialize_multihost
    from rlsolver_tpu_torch.parallel.mesh import make_mesh

    assert initialize_multihost() is j_initialize() is False
    assert make_mesh() is None  # one process: the collectives are identities


def test_mesh_has_the_world_size(world):
    import jax

    from rlsolver_tpu.parallel import mesh as j_mesh

    n, ranks = world
    jm = j_mesh.make_mesh(n)
    assert jm.devices.size == n and jax.device_count() == 8
    for r in ranks:
        assert r["mesh_size"] == n and r["mesh_names"] == jm.axis_names
    assert torch.equal(torch.cat([r["local"] for r in ranks]), torch.arange(2 * n))


def test_sharded_rollout_matches_jax_and_single_device(world, inputs):
    """local_search's 1-flip sweep sharded over the env axis equals JAX's
    `shard_rollout` on n devices and the port's unsharded sweep."""
    import jax
    import jax.numpy as jnp

    from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
    from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
    from rlsolver_tpu.parallel import mesh as j_mesh
    from rlsolver_tpu_torch.core.generate import graph_from_name
    from rlsolver_tpu_torch.envs.maxcut import MaxcutEnv

    n, ranks = world
    xs = inputs[0]
    jenv = JEnv(j_graph_from_name("BA_32_ID0"))
    m = j_mesh.make_mesh(n)

    def per_shard(xs):
        xs2, vs2 = jenv.sweep_1flip(xs, jenv.obj(xs))
        return xs2, vs2, jnp.broadcast_to(jax.lax.pmax(jnp.max(vs2), j_mesh.ENV_AXIS), (xs.shape[0],))

    jxs, jvs, jbest = j_mesh.shard_rollout(m, per_shard)(j_mesh.shard_env_batch(m, jnp.asarray(xs)))
    env = MaxcutEnv(graph_from_name("BA_32_ID0"), "cpu")
    txs = torch.from_numpy(xs)
    uxs, uvs = env.sweep_1flip(txs, env.obj(txs))
    for r in ranks:
        np.testing.assert_array_equal(r["xs"].numpy(), np.asarray(jxs))
        np.testing.assert_array_equal(r["vs"].numpy(), np.asarray(jvs))
        np.testing.assert_array_equal(r["best"].numpy(), np.asarray(jbest))
        assert torch.equal(r["xs"], uxs) and torch.equal(r["vs"], uvs)


def test_mesh_shape_and_axes(world):
    """The 2-D mesh: hosts on the rows (JAX's rule), (2, 2) at 4 ranks."""
    from rlsolver_tpu.parallel.distributed import make_host_device_mesh as j_make

    n, ranks = world
    jm = j_make(num_hosts=2)
    assert jm.devices.shape == (2, 8 // 2)
    for r in ranks:
        assert r["mesh2_shape"] == (2, n // 2) and r["mesh2_names"] == jm.axis_names


def test_collectives_over_both_axes(world):
    import jax.numpy as jnp

    from rlsolver_tpu.parallel.distributed import psum_all, shard_rollout_2d

    n, ranks = world
    x = jnp.arange(float(n))
    want = np.asarray(shard_rollout_2d(_jax_mesh_2d(n), lambda s: jnp.full_like(s, psum_all(s.sum())))(x))
    for r in ranks:
        np.testing.assert_array_equal(r["both_axes"].numpy(), want)


def test_sharded_env_rollout_2d(world, inputs):
    """The env batch sharded over (host, device); best - mean by pmax_all
    and pmean_all, equal on every rank, to JAX's and to the unsharded."""
    import jax.numpy as jnp

    from rlsolver_tpu.core.generate import graph_from_name as j_graph_from_name
    from rlsolver_tpu.envs.maxcut import MaxcutEnv as JEnv
    from rlsolver_tpu.parallel.distributed import pmax_all, pmean_all, shard_rollout_2d

    n, ranks = world
    jenv = JEnv(j_graph_from_name(GRAPH_2D))

    def rollout(xs):
        vs = jenv.obj(xs)
        return jnp.broadcast_to(pmax_all(jnp.max(vs)) - pmean_all(jnp.mean(vs)), (xs.shape[0],))

    want = np.asarray(shard_rollout_2d(_jax_mesh_2d(n), rollout)(jnp.asarray(inputs[1])))
    vs = np.asarray(jenv.obj(jnp.asarray(inputs[1])))
    for r in ranks:
        got = r["rollout_2d"].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got[0], vs.max() - vs.mean(), rtol=0, atol=1e-4)


def test_policy_mlp():
    import jax
    import jax.numpy as jnp

    from rlsolver_tpu.models.policy import PolicyMLP as JPolicyMLP
    from rlsolver_tpu_torch import convert
    from rlsolver_tpu_torch.models.policy import PolicyMLP

    jp = JPolicyMLP(12, hidden=(16,))
    p0 = np.random.default_rng(0).random((5, 12)).astype(np.float32)
    params = jp.init(jax.random.PRNGKey(0), jnp.asarray(p0))
    want = np.asarray(jp.apply(params, jnp.asarray(p0)))
    tp = PolicyMLP(12, hidden=(16,), device="cpu")
    sd = convert.flax_state_dict(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(k for k, _ in tp.named_parameters())
    tp.load_state_dict(sd)
    with torch.no_grad():
        got = tp(torch.from_numpy(p0)).numpy()
    assert got.shape == (5, 12) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_dryrun_multichip(n, tmp_path):
    from rlsolver_tpu_torch.entry import dryrun_multichip

    results = dryrun_multichip(n, device="cpu", timeout_s=60, join_timeout_s=180, store_dir=str(tmp_path))
    assert len(results) == n


def _extra_rank(tag):
    import torch.distributed as dist

    from rlsolver_tpu_torch.parallel import mesh as mesh_lib

    return tag, dist.get_rank(), float(mesh_lib.psum(torch.ones(()), mesh_lib.make_mesh()))


def test_dryrun_multichip_runs_extra_work_in_its_group(tmp_path):
    import functools

    from rlsolver_tpu_torch.entry import dryrun_multichip

    results = dryrun_multichip(2, device="cpu", timeout_s=60, join_timeout_s=180, store_dir=str(tmp_path),
                               extra=functools.partial(_extra_rank, "more"))
    assert [r["extra"] for r in results] == [("more", 0, 2.0), ("more", 1, 2.0)]
    assert all(r["seconds"] > 0 for r in results)


def test_a_failing_rank_fails_the_launch_in_time(tmp_path):
    t0 = time.time()
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:(.|\n)*ValueError: rank 1 stops here"):
        launch(_failing_rank, 2, (1,), device="cpu", timeout_s=20, join_timeout_s=60, store_dir=str(tmp_path))
    assert time.time() - t0 < 60
