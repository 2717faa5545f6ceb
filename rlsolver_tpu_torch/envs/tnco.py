"""TNCO: the tensor-network contraction-ordering environment (counterpart of
`rlsolver_tpu/envs/tnco.py`; RLSolver `methods/L2A/TNCO_simulator.py:649-910`).

  * a tensor network is an adjacency list `nodes_list` (per tensor, the
    tensors it connects to); every bond has dimension 2;
  * a solution is an order over the contractible ("run") edges; the
    dangling edges (`ban_edges` of them) are numbered last and never
    contracted;
  * the objective (minimized) is log10 of the total scalar-multiplication
    count of contracting the network in that order;
  * three codecs: integer edge permutations, continuous per-edge priorities
    (local search) and `num_bases = ceil(log2 num_edges)` big-endian rank
    bits per edge (the policy's bits).

The contraction is simulated step by step over the `run_edges` edges of an
order, for B orders at once. Where the JAX package carries a [B, N, N]
state (each node's cluster row and membership, every member row the same
row) and rewrites all of it each step, this port keeps one row per cluster,
indexed by the cluster's id, and a cluster id per node [B, N]: a step reads
two rows and writes one, O(B N) bytes. The per-step exponents are small
integers and halves, exact in f32, so the counts equal the JAX package's
bit for bit in any summation order. The steps are many small launches; on
the card one evaluation replays them as a CUDA graph.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.device import resolve_device


# ----------------------------------------------------------------- topologies
def tensor_train_nodes(length: int = 4) -> Tuple[List[List[int]], int]:
    """Tensor train (MPS) with one dangling leg per site
    (`TNCO_simulator.py:541-553`): sites 0..L-1 in a chain, site i also
    joined to a leaf L + i; `ban_edges = L`."""
    nodes: List[List[int]] = [[] for _ in range(length)]
    for i in range(length):
        if i > 0:
            nodes[i].append(i - 1)
        if i < length - 1:
            nodes[i].append(i + 1)
        nodes[i].append(i + length)
        nodes.append([i])
    return nodes, length


def tensor_ring_nodes(length: int = 4) -> Tuple[List[List[int]], int]:
    """Tensor ring (`TNCO_simulator.py:528-539`)."""
    nodes: List[List[int]] = [[] for _ in range(length)]
    for i in range(length):
        nodes[i].append((i - 1) % length)
        nodes[i].append((i + 1) % length)
        nodes[i].append(i + length)
        nodes.append([i])
    return nodes, length


def tensor_tree_nodes(depth: int = 3) -> Tuple[List[List[int]], int]:
    """Balanced binary tensor tree (`TNCO_simulator.py:556-581`)."""
    depth -= 1
    num_nodes = 2 ** (depth + 1) - 1
    ban_edges = 2**depth
    tree: List[List[int]] = [[] for _ in range(num_nodes)]

    def add_edges(d: int, node: int = 0, parent: int = -1) -> None:
        if parent >= 0:
            tree[node].append(parent)
        if d == 0:
            return
        left, right = node * 2 + 1, node * 2 + 2
        tree[node].append(left)
        tree[node].append(right)
        add_edges(d - 1, left, node)
        add_edges(d - 1, right, node)

    add_edges(depth)
    return tree, ban_edges


def random_circuit_nodes(num_qubits: int, num_layers: int, seed: int = 0) -> Tuple[List[List[int]], int]:
    """A Sycamore-shaped random-circuit network, closed (`ban_edges = 0`):
    one rank-1 tensor per wire, a brickwork of 2-qubit gates (layer l pairs
    wires from l % 2, in an order shuffled by `np.random.RandomState(seed)`),
    each joined to the previous tensor on its two wires, and a closing
    rank-1 tensor per wire. (53, 12) has 418 tensors and 677 bonds."""
    rng = np.random.RandomState(seed)
    nodes: List[List[int]] = []
    frontier = []
    for q in range(num_qubits):
        nodes.append([])
        frontier.append(q)
    for layer in range(num_layers):
        offset = layer % 2
        pairs = [(q, q + 1) for q in range(offset, num_qubits - 1, 2)]
        if not pairs:
            continue
        rng.shuffle(pairs)
        for a, b in pairs:
            gate = len(nodes)
            nodes.append([frontier[a], frontier[b]])
            nodes[frontier[a]].append(gate)
            nodes[frontier[b]].append(gate)
            frontier[a] = gate
            frontier[b] = gate
    for q in range(num_qubits):
        cap = len(nodes)
        nodes.append([frontier[q]])
        nodes[frontier[q]].append(cap)
    return nodes, 0


# ------------------------------------------------------------------ container
@dataclasses.dataclass(frozen=True)
class TensorNetwork:
    """Host-side tensor network: per-edge endpoints, ban edges last.

    `edge_nodes[e] = (n0, n1)`; edges with id >= run_edges are never
    contracted. Edge ids follow `get_edges_ary` (`TNCO_simulator.py:594-624`):
    node pairs enumerated from the last node backwards, ids then flipped
    (`max - id`) so the dangling edges land on the largest ids."""

    num_nodes: int
    edge_nodes: np.ndarray  # [E, 2] int32
    ban_edges: int
    name: str = ""

    @property
    def num_edges(self) -> int:
        return int(self.edge_nodes.shape[0])

    @property
    def run_edges(self) -> int:
        return self.num_edges - self.ban_edges

    @property
    def num_bases(self) -> int:
        """Bits per edge in the binary rank codec (`TNCO_simulator.py:684`)."""
        return max(1, math.ceil(math.log2(self.num_edges)))

    @property
    def num_bits(self) -> int:
        return self.run_edges * self.num_bases

    @staticmethod
    def from_nodes_list(nodes_list: Sequence[Sequence[int]], ban_edges: int, name: str = "") -> "TensorNetwork":
        num_nodes = len(nodes_list)
        seen = {}
        raw_id = 0
        for i in range(num_nodes - 1, -1, -1):
            for j in nodes_list[i]:
                a, b = (i, j) if i < j else (j, i)
                if (a, b) not in seen:
                    seen[(a, b)] = raw_id
                    raw_id += 1
        num_edges = raw_id
        edge_nodes = np.zeros((num_edges, 2), np.int32)
        for (a, b), rid in seen.items():
            edge_nodes[num_edges - 1 - rid] = (a, b)
        return TensorNetwork(num_nodes, edge_nodes, ban_edges, name)

    def node2s_to_edge_sort(self, node2s: Sequence[Sequence[int]]) -> np.ndarray:
        """A node-pair contraction sequence -> an edge order
        (`convert_node2s_to_edge_sort`, `TNCO_env.py:914-958`): for each pair
        the smallest shared edge id, then the other shared edges still to
        contract (parallel bonds), merging the two edge sets."""
        edges_tmp = [set() for _ in range(self.num_nodes)]
        for e, (a, b) in enumerate(self.edge_nodes):
            edges_tmp[a].add(int(e))
            edges_tmp[b].add(int(e))
        edge_sort: List[int] = []
        edge_rest = set(range(self.run_edges))
        for i0, i1 in node2s:
            inter = edges_tmp[i0] & edges_tmp[i1]
            e = sorted(inter)[0]
            edge_sort.append(e)
            ejs = sorted(edge_rest & (inter - {e}))
            edge_sort.extend(ejs)
            edge_rest.discard(e)
            edge_rest -= set(ejs)
            union = edges_tmp[i0] | edges_tmp[i1]
            edges_tmp[i0] = union
            edges_tmp[i1] = union
        if len(edge_sort) != self.run_edges:
            raise ValueError(f"node2s covers {len(edge_sort)} of {self.run_edges} run edges")
        return np.asarray(edge_sort, np.int32)


def reference_tnco_env_path() -> str:
    """RLSolver's `methods_problem_specific/tensor_train/TNCO_env.py` in the
    checkout that `$RLSOLVER_REFERENCE` names. Raises OSError when the
    variable is unset."""
    root = os.environ.get("RLSOLVER_REFERENCE")
    if not root:
        raise OSError("no reference checkout: pass `path` or set $RLSOLVER_REFERENCE")
    return os.path.join(root, "rlsolver", "methods_problem_specific", "tensor_train", "TNCO_env.py")


def load_reference_tnco_constant(name: str, path: Optional[str] = None):
    """A list constant (e.g. 'NodesSycamoreN53M12', 'Node2sSycamoreN53N20Test1')
    of RLSolver's TNCO_env.py (`TNCO_env.py:30-525`: the shipped Sycamore
    circuits), read by AST literal extraction without running the file, from
    `path` or else `reference_tnco_env_path()`. Raises OSError when the file
    is absent or neither names it, KeyError when it lacks `name`."""
    path = path or reference_tnco_env_path()
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == name:
                    return ast.literal_eval(node.value)
    raise KeyError(f"{name} not found in {path}")


def sycamore_network(m: int = 12) -> TensorNetwork:
    """RLSolver's circuit_n53_m<m> Sycamore network (ban_edges = 0, as in
    its unit tests `TNCO_env.py:1005,1040`)."""
    nodes_list = load_reference_tnco_constant(f"NodesSycamoreN53M{m}")
    return TensorNetwork.from_nodes_list(nodes_list, 0, name=f"sycamore_n53_m{m}")


# ------------------------------------------------------------------------ env
class LocalSearchDraws(NamedTuple):
    """`local_search`'s draws, injected in place of the generator's: the
    perturbed edges idx int [I, B, S] and the standard normals [I, B, S]
    (scaled by noise_std in the search) of I iterations."""

    idx: torch.Tensor
    normal: torch.Tensor


class TncoEnv:
    """Static per-network tensors (on `cuda` unless `device="cpu"`) and the
    codecs, objective and local search (minimization)."""

    def __init__(self, network: TensorNetwork, device=None):
        self.device = resolve_device(device)
        self.network = network
        self.num_nodes = network.num_nodes
        self.num_edges = network.num_edges
        self.ban_edges = network.ban_edges
        self.run_edges = network.run_edges
        self.num_bases = network.num_bases
        self.num_bits = network.num_bits
        self.if_maximize = False

        self.edge_nodes = torch.from_numpy(network.edge_nodes.astype(np.int64)).to(self.device)
        # dims0[i][j]: log2 of the bonds between node i's cluster and node j
        # (`get_node_dims_arys`, `TNCO_simulator.py:627-635`)
        dims0 = np.zeros((network.num_nodes, network.num_nodes), np.float32)
        for n0, n1 in network.edge_nodes:
            dims0[n0, n1] += 1.0
            dims0[n1, n0] += 1.0
        self.dims0 = torch.from_numpy(dims0).to(self.device)
        self._shifts = torch.arange(self.num_bases - 1, -1, -1, device=self.device)
        self._graphs = {}  # batch size -> its CapturedCall

    # ----------------------------------------------------------------- codecs
    def bits_to_edge_sorts(self, xs: torch.Tensor) -> torch.Tensor:
        """bits [B, num_bits] -> order int64 [B, run_edges]: each edge's
        `num_bases` bits are its big-endian rank, the order the stable
        argsort of the ranks (ties keep edge order, as `jnp.argsort`)."""
        b = xs.shape[0]
        view = xs.reshape(b, self.run_edges, self.num_bases).long()
        ranks = (view << self._shifts).sum(dim=2)
        return torch.argsort(ranks, dim=1, stable=True)

    def edge_sorts_to_bits(self, edge_sorts: torch.Tensor) -> torch.Tensor:
        """order [B, R] -> canonical bits bool [B, num_bits]: edge e's rank
        is its position in the order, written big-endian."""
        b, r = edge_sorts.shape
        pos = torch.arange(r, device=edge_sorts.device).expand(b, r)
        ranks = torch.zeros(b, r, dtype=torch.long, device=edge_sorts.device).scatter(1, edge_sorts.long(), pos)
        bits = (ranks[:, :, None] >> self._shifts) & 1
        return bits.reshape(b, self.num_bits).bool()

    def priorities_to_edge_sorts(self, fs: torch.Tensor) -> torch.Tensor:
        """Priorities f32 [B, R] -> order (the local search's codec)."""
        return torch.argsort(fs, dim=1, stable=True)

    def ranks_to_priorities(self, edge_sorts: torch.Tensor) -> torch.Tensor:
        """Rank priorities, position / R (`TNCO_local_search.py:56-57`), as
        the compiled JAX step rounds it: position * f32(1 / R)."""
        b, r = edge_sorts.shape
        pos = torch.arange(r, dtype=torch.float32, device=edge_sorts.device).expand(b, r)
        ranks = torch.zeros(b, r, dtype=torch.float32, device=edge_sorts.device).scatter(1, edge_sorts.long(), pos)
        return ranks * np.float32(1.0 / r)

    # -------------------------------------------------------------- objective
    def contraction_pow_counts(self, edge_sorts: torch.Tensor) -> torch.Tensor:
        """Per-step log2 multiplication counts f32 [B, R] (exact).

        Contracting an edge merges its endpoints' clusters; the step's
        exponent is the merged cluster's external log2 dims plus half its
        internal ones (`update_pow_vectorized`, `TNCO_simulator.py:869-883`);
        an edge inside one cluster costs nothing. On the card the R steps
        (about 15 small kernels each) replay as one CUDA graph, captured
        once per batch size."""
        b = edge_sorts.shape[0]
        if b not in self._graphs:
            self._graphs[b] = CapturedCall(self._pow_counts_steps)
        return self._graphs[b](edge_sorts).clone()

    def _pow_counts_steps(self, edge_sorts: torch.Tensor) -> torch.Tensor:
        """The step loop. `rows[b, c]` is cluster c's row (c = the id its
        members carry in `cid`); every cluster's row is 0 at its members, so
        an edge inside one cluster rewrites its row and ids unchanged. The
        exponent, sum(ct) - sum(ct at members) / 2 in the JAX package, is
        (sum(ct) + sum(ct off members)) / 2 here: the same value, exact."""
        b = edge_sorts.shape[0]
        ends = self.edge_nodes[edge_sorts.long()]  # [B, R, 2]
        rows = self.dims0.expand(b, -1, -1).clone()
        cid = torch.arange(self.num_nodes, device=edge_sorts.device).expand(b, -1).clone()
        ar = torch.arange(b, device=edge_sorts.device)
        pows = []
        for t in range(edge_sorts.shape[1]):
            cc = cid.gather(1, ends[:, t])  # [B, 2] the endpoints' clusters
            d = rows[ar[:, None], cc]  # [B, 2, N]
            diff = cc[:, 0] != cc[:, 1]
            ct = torch.where(diff[:, None], d[:, 0] + d[:, 1], d[:, 0])
            members = (cid == cc[:, 0:1]) | (cid == cc[:, 1:2])
            new_row = ct.masked_fill(members, 0.0)
            pows.append(torch.where(diff, (ct + new_row).sum(dim=1) * 0.5, 0.0))
            rows[ar, cc[:, 0]] = new_row
            cid = torch.where(members, cc[:, 0:1], cid)
        return torch.stack(pows, dim=1)

    def log10_multiple_times(self, edge_sorts: torch.Tensor) -> torch.Tensor:
        """log10 of the total multiplication count, f32 [B], max-shifted
        (`get_multiple_times_vectorized`, `TNCO_simulator.py:797-804`)."""
        return self._log10_sum(self.contraction_pow_counts(edge_sorts))

    @staticmethod
    def _log10_sum(pows: torch.Tensor) -> torch.Tensor:
        shift = pows.max(dim=1).values
        total = torch.exp2(pows - shift[:, None]).sum(dim=1)
        return torch.log10(total) + shift * np.float32(1.0 / np.log2(10.0))

    def obj(self, xs: torch.Tensor) -> torch.Tensor:
        """The objective from the bits codec (lower is better)."""
        return self.log10_multiple_times(self.bits_to_edge_sorts(xs))

    def obj_priorities(self, fs: torch.Tensor) -> torch.Tensor:
        return self.log10_multiple_times(self.priorities_to_edge_sorts(fs))

    def log10_multiple_times_accurate(self, edge_sorts) -> np.ndarray:
        """The float64 host twin (`get_multiple_times_accurately`,
        `TNCO_simulator.py:785-795`) of this env's own counts."""
        pows = self.contraction_pow_counts(torch.as_tensor(np.asarray(edge_sorts), device=self.device))
        out = np.zeros(pows.shape[0], np.float64)
        for i, row in enumerate(pows.cpu().numpy().astype(np.float64)):
            shift = row.max()
            out[i] = math.log10(np.exp2(row - shift).sum()) + shift * math.log10(2.0)
        return out

    # ------------------------------------------------------------------ state
    def random_edge_sorts(self, gen: torch.Generator, num_sims: int) -> torch.Tensor:
        """Uniform random orders int64 [num_sims, R] (argsort of uniforms)."""
        return torch.argsort(torch.rand(num_sims, self.run_edges, generator=gen, device=self.device), dim=1)

    def random_xs(self, gen: torch.Generator, num_sims: int) -> torch.Tensor:
        """Random orders in the bits codec (`generate_xs_randomly`)."""
        return self.edge_sorts_to_bits(self.random_edge_sorts(gen, num_sims))

    # ----------------------------------------------------------- local search
    def local_search(self, gen: Optional[torch.Generator], fs: torch.Tensor, vs: Optional[torch.Tensor] = None,
                     num_iters: int = 8, num_spin: int = 8, noise_std: float = 0.3,
                     draws: Optional[LocalSearchDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Priority-space random search (`SolverLocalSearch.random_search`,
        `TNCO_local_search.py:46-73`): per iteration add noise_std x N(0, 1)
        to `num_spin` random edges' priorities of each sim (a repeated edge
        gets its noises added in draw order), re-evaluate, keep where
        better. Returns (fs, vs), vs the log10 cost. The draws come from
        `gen` unless `draws` gives them."""
        if vs is None:
            vs = self.obj_priorities(fs)
        b = fs.shape[0]
        ar = torch.arange(b, device=fs.device)
        for it in range(num_iters):
            if draws is None:
                idx = torch.randint(0, self.run_edges, (b, num_spin), generator=gen, device=fs.device)
                normal = torch.randn(b, num_spin, generator=gen, device=fs.device)
            else:
                idx, normal = draws.idx[it].to(fs.device).long(), draws.normal[it].to(fs.device)
            noise = normal * np.float32(noise_std)
            fs_try = fs.clone()
            for j in range(num_spin):
                fs_try[ar, idx[:, j]] += noise[:, j]
            vs_try = self.obj_priorities(fs_try)
            better = vs_try < vs
            fs = torch.where(better[:, None], fs_try, fs)
            vs = torch.where(better, vs_try, vs)
        return fs, vs
