"""Carry the JAX package's MCPG and L2A state into the port.

The JAX state arrives as numpy arrays (the caller converts with
`np.asarray`; this module imports nothing of JAX):

  * BernoulliPolicy params `{"params": {"logits": [N]}}` become the port's
    `BernoulliPolicy` state dict `{"logits": [N]}`;
  * any flax param tree, such as those of L2A's `GraphEncoder` and
    `PolicyTrsWithValue`, becomes a state dict whose keys join the tree's
    keys with "." (`flax_state_dict`): the port's modules keep flax's names
    and layouts;
  * the optax state of `chain(clip_by_global_norm, adam)` (or of a plain
    `adam`) — nested tuples holding one `ScaleByAdamState(count, mu, nu)`
    with mu, nu shaped like the params — becomes the state of the port's
    `ClippedAdam`, over the module's parameters in `named_parameters` order,
    or over the one raw array where the params are one (mcpg_batch's
    logits [G, N], which themselves carry across as `torch.from_numpy`);
  * a pickled flax tree of `jax.Array`s, such as the trained ECO-DQN
    networks in `results_quality/eco_params_*.pkl`, loads without JAX
    (`load_flax_pickle`), and the MPNN's tree becomes its state dict
    (`mpnn_state_dict`);
  * the flax trees of PPO's `MLPActorCritic`, the S2V constructive policy
    and the beamforming `PrecoderPolicy` become their modules' state dicts
    (`mlp_actor_critic_state_dict`, `s2v_state_dict`,
    `precoder_state_dict`: the port keeps flax's names); TNCO's Bernoulli
    logits go through `policy_state_dict`;
  * a flax `GCN` tree, or PI-GNN's `{"gcn": tree, "embed", "skip"}`,
    becomes the port's GCN state dict or PI-GNN parameter dict
    (`gcn_state_dict`);
  * the trees of the TSP `AttentionTSP`, the L2O/seq2seq `SolverLSTM`
    (flax's `OptimizedLSTMCell`: `lstm.ii.kernel` .. `lstm.ho.bias`),
    `RunCspNetwork` and the REINFORCE critic become their modules' state
    dicts (`attention_tsp_state_dict`, `solver_lstm_state_dict`,
    `runcsp_state_dict`, `critic_state_dict`), and DCS's `{"gen": tree,
    "f", "log_step"}` its parameter dict (`dcs_params`);
  * the RL+OR scorers (`BranchNet`'s and `ScorePolicy`'s nets), the
    off-policy networks (`MLP`, `_TwinCritic`, `_GaussianActor`,
    `QEmbedTwin`) and the multi-agent ones (`AgentQNet`, `QMixer`, MAPPO's
    actor and critic, MADDPG's stacked per-agent actors and critics, their
    leading agent axis kept) become their modules' state dicts
    (`flax_state_dict`: the port keeps flax's names); VDN/QMIX's `{"q":
    tree, "mix": tree}` becomes one `MixParams` state dict
    (`value_mix_state_dict`), and its optax state converts with
    `adam_state(..., tree_fn=value_mix_state_dict)`;
  * the state of a sharded form (`shard_map` over a mesh axis): its
    replicated leaves (params, optimizer state, keys) convert as above on
    every rank, and its sharded leaves (env state, incumbents: [B, ...] on
    the mesh axis) split into the ranks' rows (`split_by_rank`), rank r
    holding rows r * B / n to (r + 1) * B / n, as `parallel.mesh.
    shard_env_batch` takes them.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# the one global of JAX that a pickled jax.Array names, and the numpy
# globals that rebuild its host copy
_JAX_ARRAY = ("jax._src.array", "_reconstruct_array")
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar"}


def policy_state_dict(params) -> Dict[str, torch.Tensor]:
    """`{"params": {"logits": arr}}` -> `{"logits": tensor}`."""
    return {"logits": torch.from_numpy(np.array(params["params"]["logits"], np.float32))}


def flax_state_dict(params) -> Dict[str, torch.Tensor]:
    """A flax tree `{"params": {...}}` (numpy leaves) -> {"a.b.kernel": tensor}.

    It is also the state dict of every network whose module names its
    parameters after the flax tree: `BranchNet`'s and `ScorePolicy`'s `_Net`
    (`Dense_0` .. `Dense_2`, the port's `branching.ScoreMLP`); the
    off-policy `MLP` (`Dense_0` .. `Dense_2`), `_TwinCritic`
    (`q1.Dense_0.kernel`, ...), `_GaussianActor` (`Dense_0`, `Dense_1`,
    `mu`, `log_std`) and `QEmbedTwin` (`Embed_0.embedding`, `Dense_0` ..
    `Dense_2`); `AgentQNet`, `QMixer` (`hw1`, `hb1`, `hw2`, `hb2h`, `hb2`),
    MAPPO's actor and critic, and MADDPG's vmapped actors and critics
    (every leaf [n_agents, ...], the port's `StackedMLP`)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if hasattr(v, "items"):  # a dict or a FrozenDict
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = torch.from_numpy(np.array(v, np.float32))

    walk(params["params"], "")
    return out


def _find_adam_state(opt_state):
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_adam_state(item)
            if found is not None:
                return found
    return None


def adam_state(opt_state, names: Optional[Sequence[str]] = None, tree_fn=None) -> Dict[str, object]:
    """optax Adam state -> `ClippedAdam` state dict `{"count": int, "mu":
    [tensor], "nu": [tensor]}`, one tensor per parameter `names` lists
    (default: MCPG's policy logits, or the one array the params are), the
    moments' trees flattened by `tree_fn` (default `flax_state_dict`)."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) found in the optimizer state")
    if names is None and not hasattr(adam.mu, "items"):  # the params are one array
        mu, nu = [torch.from_numpy(np.array(adam.mu, np.float32))], [torch.from_numpy(np.array(adam.nu, np.float32))]
    elif names is None:
        mu, nu = [policy_state_dict(adam.mu)["logits"]], [policy_state_dict(adam.nu)["logits"]]
    else:
        tree_fn = tree_fn if tree_fn is not None else flax_state_dict
        fm, fn = tree_fn(adam.mu), tree_fn(adam.nu)
        mu, nu = [fm[k] for k in names], [fn[k] for k in names]
    return {"count": int(np.asarray(adam.count)), "mu": mu, "nu": nu}


def _reconstruct_array(fun, args, arr_state, aval_state):
    """What a pickled jax.Array calls on load: here it builds the numpy
    array (`fun(*args)` then its pickled state) and returns it."""
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class _FlaxUnpickler(pickle.Unpickler):
    """Loads numpy arrays and `jax.Array`s (as numpy arrays) in plain
    containers, and refuses every other global."""

    def find_class(self, module: str, name: str):
        if (module, name) == _JAX_ARRAY:
            return _reconstruct_array
        if (module == "numpy" or module.startswith("numpy.")) and name in _NUMPY_NAMES:
            if module.startswith("numpy._core") and int(np.__version__.split(".")[0]) < 2:
                module = "numpy.core" + module[len("numpy._core"):]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load the global {module}.{name}")


def load_flax_pickle(path: str):
    """A pickled tree of `jax.Array`s (e.g. `results_quality/eco_params_BA.pkl`)
    as the same tree of numpy arrays, without importing JAX."""
    with open(path, "rb") as f:
        return _FlaxUnpickler(f).load()


def mpnn_state_dict(params) -> Dict[str, torch.Tensor]:
    """The MPNN's flax tree `{"params": {"node_init": {"kernel": ...}, ...}}`
    -> the port's `MPNN` state dict (f32; the MPNN's `dtype` casts at use)."""
    return flax_state_dict(params)


def gcn_state_dict(params) -> Dict[str, torch.Tensor]:
    """A flax GCN tree `{"params": {"gcn0": ..., "out": ...}}` -> the port's
    `GCN` state dict; PI-GNN's `{"gcn": tree, "embed": [N, E], "skip": [E]}`
    (leaves of any leading shape, e.g. a cell's [G, ...]) -> the
    `algos.pignn` parameter dict {"gcn.gcn0.kernel", ..., "embed", "skip"}."""
    if "gcn" not in params:
        return flax_state_dict(params)
    out = {"gcn." + k: v for k, v in flax_state_dict(params["gcn"]).items()}
    for k in ("embed", "skip"):
        out[k] = torch.from_numpy(np.array(params[k], np.float32))
    return out


def mlp_actor_critic_state_dict(params) -> Dict[str, torch.Tensor]:
    """PPO's flax `MLPActorCritic` tree -> the port's `algos.ppo.MLPActorCritic`."""
    return flax_state_dict(params)


def s2v_state_dict(params) -> Dict[str, torch.Tensor]:
    """The flax `S2VConstructivePolicy` tree -> the port's module
    (`encoder.Dense_0.kernel`, ..., `dec_out.bias`)."""
    return flax_state_dict(params)


def precoder_state_dict(params) -> Dict[str, torch.Tensor]:
    """The flax `PrecoderPolicy` tree (`Dense_0` .. `Dense_2`) -> the port's."""
    return flax_state_dict(params)


def attention_tsp_state_dict(params) -> Dict[str, torch.Tensor]:
    """The flax `AttentionTSP` tree -> the port's (`embed.kernel`,
    `enc0.mha.query.kernel` [D, H, D/H], ..., `out.bias`)."""
    return flax_state_dict(params)


def solver_lstm_state_dict(params) -> Dict[str, torch.Tensor]:
    """The flax `SolverLSTM` tree -> the port's (`lstm.ii.kernel`, ...,
    `lstm.ho.bias`, `out.kernel`, `out.bias`)."""
    return flax_state_dict(params)


def runcsp_state_dict(params) -> Dict[str, torch.Tensor]:
    """The flax `RunCspNetwork` tree -> the port's (`NEQ_lr.kernel`, ...,
    `norm.scale`, `lstm.ii.kernel`, ..., `out.kernel`)."""
    return flax_state_dict(params)


def critic_state_dict(params) -> Dict[str, torch.Tensor]:
    """The REINFORCE `CriticBaseline`'s flax tree -> the port's `CriticNet`
    (`Dense_0` .. `Dense_2`)."""
    return flax_state_dict(params)


def dcs_params(params) -> Dict[str, torch.Tensor]:
    """DCS's `{"gen": flax tree, "f": [M, N], "log_step": []}` -> the port's
    parameter dict {"gen.Dense_0.kernel", ..., "f", "log_step"}."""
    out = {"gen." + k: v for k, v in flax_state_dict(params["gen"]).items()}
    for k in ("f", "log_step"):
        out[k] = torch.from_numpy(np.array(params[k], np.float32))
    return out


def value_mix_state_dict(params) -> Dict[str, torch.Tensor]:
    """VDN/QMIX's `{"q": tree, "mix": tree}` (no "mix" for VDN) -> the
    port's `MixParams` state dict {"q.Dense_0.kernel", ..., "mix.hw1.kernel", ...}."""
    out = {}
    for part in ("q", "mix"):
        if part in params:
            out.update({f"{part}.{k}": v for k, v in flax_state_dict(params[part]).items()})
    return out


def load_npz_tree(path: str):
    """A tree saved by `np.savez` under '/'-joined keys ("params/Dense_0/kernel")
    as the nested dict of numpy arrays it came from."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def split_by_rank(tree, world_size: int):
    """A tree of [B, ...] numpy leaves (a sharded state's rows) -> one tree a
    rank, rank r's leaves its B / world_size rows. Dicts, lists, tuples and
    NamedTuples keep their structure."""

    def part(x, r):
        if isinstance(x, dict):
            return {k: part(v, r) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(part(v, r) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(part(v, r) for v in x)
        arr = np.asarray(x)
        if arr.shape[0] % world_size:
            raise ValueError(f"{arr.shape[0]} rows do not divide over {world_size} ranks")
        per = arr.shape[0] // world_size
        return arr[r * per : (r + 1) * per]

    return [part(tree, r) for r in range(world_size)]

