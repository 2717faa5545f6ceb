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
  * a flax `GCN` tree, or PI-GNN's `{"gcn": tree, "embed", "skip"}`,
    becomes the port's GCN state dict or PI-GNN parameter dict
    (`gcn_state_dict`).
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
    """A flax tree `{"params": {...}}` (numpy leaves) -> {"a.b.kernel": tensor}."""
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


def adam_state(opt_state, names: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """optax Adam state -> `ClippedAdam` state dict `{"count": int, "mu":
    [tensor], "nu": [tensor]}`, one tensor per parameter `names` lists
    (default: MCPG's policy logits, or the one array the params are)."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) found in the optimizer state")
    if names is None and not hasattr(adam.mu, "items"):  # the params are one array
        mu, nu = [torch.from_numpy(np.array(adam.mu, np.float32))], [torch.from_numpy(np.array(adam.nu, np.float32))]
    elif names is None:
        mu, nu = [policy_state_dict(adam.mu)["logits"]], [policy_state_dict(adam.nu)["logits"]]
    else:
        fm, fn = flax_state_dict(adam.mu), flax_state_dict(adam.nu)
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
