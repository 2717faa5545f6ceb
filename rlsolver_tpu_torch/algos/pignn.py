"""PI-GNN: a physics-inspired GNN trained on a relaxed problem Hamiltonian
(counterpart of `rlsolver_tpu/algos/pignn.py`).

A GCN over learnable node embeddings, plus a direct embedding -> logit
readout (`skip`, which keeps per-node identity where the GCN over-smooths),
gives per-node probabilities p; Adam minimizes the relaxed Hamiltonian with
early stopping on the loss; the solution is p > 0.5.

  maxcut: L = -(expected cut) / total weight
          = -(p . deg_w - p^T A p) / tw
  MIS:    L = -sum_i p_i + penalty * sum_{ij in E} p_i p_j

The JAX package sums the edge form, sum_e w_e (p_i + p_j - 2 p_i p_j); its
backward pass on the card would be an atomic scatter-add over the edges,
whose f32 sums vary from run to run. Here the same function is taken on
the dense adjacency (the edge sum written as p . deg_w - p^T A p, and for
MIS sum_e p_i p_j = p^T A p / 2), which is deterministic; a test holds it
to the edge form.

The parameters are a dict {"gcn.gcn0.kernel", ..., "gcn.out.bias",
"embed", "skip"} (`convert.gcn_state_dict` of the JAX tree). The cell
variant trains G instances at once on parameters with a leading instance
axis, tracks each instance's best probabilities on the device and reads
the host once per `chunk` steps, as the JAX package does; on the card its
steps replay as CUDA graphs of `GRAPH_STEPS` (`capture.CapturedCall`, each
step's Adam bias corrections an input) unless `train_pignn_cell(...,
cuda_graph=False)`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.core.graph import Graph
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.gcn import GCN, gcn_apply, normalized_adjacency
from rlsolver_tpu_torch.ops import cut as cut_ops
from rlsolver_tpu_torch.optim import ClippedAdam

Params = Dict[str, torch.Tensor]
GRAPH_STEPS = 100  # the cell's training steps one CUDA graph replays


@dataclasses.dataclass
class PIGNNConfig:
    hidden: tuple = (64, 64)
    embed_dim: int = 16  # learnable node-id embedding input
    lr: float = 1e-3
    max_steps: int = 2000
    patience: int = 200  # early stopping
    tol: float = 1e-5
    penalty: float = 2.0  # MIS constraint weight
    seed: int = 0


def init_params(num_nodes: int, cfg: PIGNNConfig, gen: torch.Generator) -> Params:
    """Random parameters from a CPU generator: N(0, 0.1^2) embeddings and
    skip readout, flax's initialization of the GCN."""
    embed = torch.randn(num_nodes, cfg.embed_dim, generator=gen) * 0.1
    gcn = GCN(cfg.embed_dim, cfg.hidden, 1, seed=int(torch.randint(0, 2**31 - 1, (1,), generator=gen)), device="cpu")
    params = {"gcn." + k: v.detach() for k, v in gcn.named_parameters()}
    params.update(embed=embed, skip=torch.randn(cfg.embed_dim, generator=gen) * 0.1)
    return params


def pignn_probs(params: Params, a_norm: torch.Tensor, num_layers: int) -> torch.Tensor:
    """Per-node probabilities [..., N] (sigmoid of the GCN's logit plus
    embed @ skip)."""
    gcn = {k[4:]: v for k, v in params.items() if k.startswith("gcn.")}
    embed = params["embed"]
    logits = gcn_apply(gcn, embed, a_norm, num_layers)[..., 0]
    return torch.sigmoid(logits + (embed @ params["skip"].unsqueeze(-1))[..., 0])


def maxcut_loss(probs: torch.Tensor, adj: torch.Tensor, deg_w: torch.Tensor, total_w: torch.Tensor) -> torch.Tensor:
    """-(expected cut) / tw = -(p . deg_w - p^T A p) / tw, over [..., N]."""
    ap = (adj @ probs.unsqueeze(-1))[..., 0]
    return -(torch.sum(probs * deg_w, dim=-1) - torch.sum(probs * ap, dim=-1)) / total_w


def _leaf_params(params: Params, dev) -> Params:
    return {k: torch.as_tensor(v).to(dev, torch.float32).clone().requires_grad_(True) for k, v in params.items()}


def _train(graph: Graph, loss_of_probs: Callable[[torch.Tensor], torch.Tensor], cfg: PIGNNConfig, dev,
           params: Optional[Params] = None) -> np.ndarray:
    """Adam on the loss, early-stopped; returns the probabilities at the
    least loss."""
    a_norm = torch.from_numpy(normalized_adjacency(graph)).to(dev)
    if params is None:
        params = init_params(graph.num_nodes, cfg, torch.Generator().manual_seed(cfg.seed))
    params = _leaf_params(params, dev)
    opt = ClippedAdam(list(params.values()), cfg.lr, max_norm=None)
    best_loss, best_probs, since_best = np.inf, None, 0
    for _ in range(cfg.max_steps):
        opt.zero_grad()
        probs = pignn_probs(params, a_norm, len(cfg.hidden))
        loss = loss_of_probs(probs)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        if loss < best_loss - cfg.tol:
            best_loss, best_probs, since_best = loss, probs.detach(), 0
        else:
            since_best += 1
            if since_best >= cfg.patience:
                break
    return best_probs.cpu().numpy()


def solve_maxcut_pignn(graph: Graph, cfg: PIGNNConfig = PIGNNConfig(), device=None,
                       params: Optional[Params] = None) -> Tuple[np.ndarray, float]:
    """-> (bits, cut). `params` replace the random initialization."""
    dev = resolve_device(device)
    cg = cut_ops.CutGraph.build(graph, dev)
    tw = max(graph.total_weight, 1e-9)  # total-weight normalization (see the cell)
    probs = _train(graph, lambda p: maxcut_loss(p, cg.adj, cg.deg_w, tw), cfg, dev, params)
    bits = probs > 0.5
    return bits, float(cut_ops.cut_dense(torch.from_numpy(bits[None]).to(dev), cg)[0])


def train_pignn_cell(graphs: Sequence[Graph], cfg: PIGNNConfig = PIGNNConfig(), chunk: int = 500, device=None,
                     params: Optional[Params] = None, cuda_graph: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trains PI-GNN on a cell of same-size instances at once -> (best probs
    [G, N], best loss [G]). Parameters, Adam's moments and the adjacencies
    carry a leading instance axis (the instances share no parameter, so the
    summed loss gives each its own gradient). Training runs `chunk` steps
    between host reads, with the best loss and probabilities tracked on the
    device; it stops after a chunk in which no instance improved. `params`
    ([G, ...] each) replace the random initialization."""
    dev = resolve_device(device)
    n, g_cnt = graphs[0].num_nodes, len(graphs)
    adj = torch.stack([torch.from_numpy(g.adjacency_dense()) for g in graphs]).to(dev)
    deg_w = torch.stack([torch.from_numpy(g.weighted_degrees()) for g in graphs]).to(dev)
    # normalized by the total weight: the raw Hamiltonian's gradient grows
    # with the edge count and saturates the sigmoid on dense cells
    total_w = torch.clamp(torch.tensor([float(g.weights.sum()) for g in graphs], dtype=torch.float32), min=1e-9).to(dev)
    a_norm = torch.from_numpy(np.stack([normalized_adjacency(g) for g in graphs])).to(dev)
    if params is None:
        gen = torch.Generator().manual_seed(cfg.seed)
        per = [init_params(n, cfg, gen) for _ in graphs]
        params = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    params = _leaf_params(params, dev)
    opt = ClippedAdam(list(params.values()), cfg.lr, max_norm=None)
    best_loss = torch.full((g_cnt,), float("inf"), device=dev)
    best_probs = torch.zeros(g_cnt, n, device=dev)

    def steps(best_loss, best_probs, corr):  # one step per row of the bias corrections corr [K, 2]
        for i in range(corr.shape[0]):
            opt.zero_grad()
            probs = pignn_probs(params, a_norm, len(cfg.hidden))
            loss = maxcut_loss(probs, adj, deg_w, total_w)  # [G]
            loss.sum().backward()
            opt.step(corr=corr[i])
            with torch.no_grad():
                better = loss < best_loss - cfg.tol
                best_loss = torch.where(better, loss, best_loss)
                best_probs = torch.where(better[:, None], probs, best_probs)
        return best_loss, best_probs

    block = GRAPH_STEPS if chunk % GRAPH_STEPS == 0 else chunk
    call = CapturedCall(steps, cuda_graph, restore=opt.state_tensors())
    prev = np.full((g_cnt,), np.inf)
    for _ in range(max(1, cfg.max_steps // chunk)):
        for _ in range(chunk // block):
            best_loss, best_probs = call(best_loss, best_probs, torch.stack([opt.corrections() for _ in range(block)]))
        cur = best_loss.cpu().numpy()
        if np.all(cur > prev - cfg.tol):  # no instance improved this chunk
            break
        prev = cur
    return best_probs.clone(), best_loss.clone()  # a graph's outputs are overwritten by its next replay


def solve_maxcut_pignn_cell(graphs: Sequence[Graph], cfg: PIGNNConfig = PIGNNConfig(), chunk: int = 500,
                            device=None, params: Optional[Params] = None) -> Tuple[np.ndarray, np.ndarray]:
    """PI-GNN on a cell of same-size instances at once (`train_pignn_cell`)
    -> (bits [G, N], cut [G])."""
    best_probs, _ = train_pignn_cell(graphs, cfg, chunk, device, params)
    bits = best_probs.cpu().numpy() > 0.5
    vals = np.empty(len(graphs), np.float32)
    for k, g in enumerate(graphs):
        n0, n1, w = g.edge_arrays()
        xb = bits[k].astype(np.int8)
        vals[k] = ((xb[n0] ^ xb[n1]) * w).sum()
    return bits, vals


def solve_mis_pignn(graph: Graph, cfg: PIGNNConfig = PIGNNConfig(), device=None,
                    params: Optional[Params] = None) -> Tuple[np.ndarray, float]:
    """-> (a maximal independent set's bits, its size): the rounded
    probabilities, any violated edge's later endpoint dropped, then nodes
    added greedily in probability order while they conflict with none."""
    dev = resolve_device(device)
    adj = torch.from_numpy((graph.adjacency_dense() != 0).astype(np.float32)).to(dev)

    def loss_of_probs(p):
        return -torch.sum(p) + cfg.penalty * (0.5 * torch.sum(p * (adj @ p)))

    probs = _train(graph, loss_of_probs, cfg, dev, params)
    bits = (probs > 0.5).copy()
    n0, n1, _ = graph.edge_arrays()
    for a, b in zip(n0, n1):
        if bits[a] and bits[b]:
            bits[b] = False
    nbrs, _, deg = graph.padded_neighbors()
    for v in np.argsort(-probs):
        if not bits[v] and not bits[nbrs[v, : deg[v]]].any():
            bits[v] = True
    return bits, float(bits.sum())
