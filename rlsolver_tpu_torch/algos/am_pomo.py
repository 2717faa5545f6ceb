"""POMO training and inference for the TSP attention model (counterpart of
`rlsolver_tpu/algos/am_pomo.py`; RLSolver's
`methods/attention_model/AM_TSP/trainer.py`, `DistributedPOMOTrainer`).

A rollout encodes each instance once and then decodes N-1 steps for P
starts at once (rollout p starts at city p). A sampled step takes
argmax(logits + Gumbel noise), JAX's `categorical`, with the noise from a
generator or injected ([N-1, B, P, N]); a greedy step takes the argmax.
Training is REINFORCE with POMO's shared baseline (the mean over the
starts) and log-probabilities clipped at -5 N (`trainer.py:192-196`), then
global-norm clipping and Adam (`optim.ClippedAdam`). Inference adds the x8
coordinate-symmetry augmentation; `beam_search` keeps the `beam_width` best
partial tours by total log-probability, ties to the lower flat index as
`jax.lax.top_k` breaks them (a stable sort).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlsolver_tpu_torch.capture import CapturedCall
from rlsolver_tpu_torch.device import resolve_device
from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP
from rlsolver_tpu_torch.ops.sampling import gumbel_noise
from rlsolver_tpu_torch.optim import ClippedAdam
from rlsolver_tpu_torch.parallel import mesh as mesh_lib


def tour_lengths(nodes: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """nodes [B, N, 2], actions [B, P, N] permutations -> lengths [B, P]."""
    b, p, n = actions.shape
    coords = torch.gather(nodes[:, None, :, :].expand(b, p, n, 2), 2, actions[..., None].expand(b, p, n, 2))
    diffs = coords - torch.roll(coords, -1, dims=2)
    return torch.sqrt((diffs ** 2).sum(-1) + 1e-10).sum(-1)


def rollout_pomo(model: AttentionTSP, nodes: torch.Tensor, pomo_size: Optional[int] = None, greedy: bool = False,
                 gen: Optional[torch.Generator] = None,
                 gumbel: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """POMO rollout: P rollouts per instance, rollout p starting at city
    p mod N. Returns (actions [B, P, N], log-probs [B, P] summed over the
    steps, lengths [B, P]). Differentiable in the model's parameters
    through the log-probs."""
    b, n, _ = nodes.shape
    p = pomo_size or n
    dev = nodes.device
    cache = model.decoder_cache(model.encode(nodes))
    first = (torch.arange(p, device=dev) % n)[None, :].expand(b, p)
    # scatters of a host scalar: no host tensor copied to the card (a CUDA graph can hold the rollout)
    visited = torch.zeros(b, p, n, dtype=torch.bool, device=dev).scatter(2, first[..., None], True)
    current, logp_sum, actions = first, torch.zeros(b, p, device=dev), [first]
    for t in range(n - 1):
        logits = model.decode(cache, current, first, ~visited)
        with torch.no_grad():
            if greedy:
                action = logits.argmax(dim=-1)
            else:
                noise = gumbel_noise(logits.shape, gen, dev) if gumbel is None else gumbel[t].to(dev)
                action = (logits + noise).argmax(dim=-1)
        logp = torch.log_softmax(logits, dim=-1)
        logp_sum = logp_sum + torch.gather(logp, 2, action[..., None])[..., 0]
        visited = visited.scatter(2, action[..., None], True)
        current = action
        actions.append(action)
    actions = torch.stack(actions, dim=2)
    return actions, logp_sum, tour_lengths(nodes, actions)


@dataclasses.dataclass
class POMOConfig:
    num_cities: int = 20
    embed_dim: int = 128
    num_heads: int = 4
    num_layers: int = 3
    batch_size: int = 64
    pomo_size: Optional[int] = None  # default = num_cities
    num_steps: int = 200
    lr: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 0


class POMODraws(NamedTuple):
    """One training step's randomness: the instances [B, N, 2] and the
    rollout's Gumbel noise [N-1, B, P, N]."""

    nodes: torch.Tensor
    gumbel: torch.Tensor


def make_pomo_step(model: AttentionTSP, cfg: POMOConfig, cuda_graph: bool = True, group=None):
    """(optimizer, step): step(gen=None, draws=None) samples a fresh uniform
    batch and the rollout's Gumbel noise (or takes `draws`), runs a POMO
    rollout and applies the shared-baseline REINFORCE update; it returns the
    metrics (loss, mean_length, best_length) as device scalars, valid until
    the next step, and keeps the step's instances and tours in
    `step.last_tours` ((nodes [B, N, 2], actions [B, P, N]), as long).

    On the card (unless `cuda_graph=False`) the step after the draws is two
    CUDA graph replays (`capture.CapturedCall`; a step is about 3,000 small
    launches, host-bound when eager): the rollout and backward pass, which
    leaves the gradients in one flat buffer, and the clip and Adam step.
    The gradients' reduction runs eagerly between the two, since a gloo
    collective cannot be captured; with no group, or a group of one, it is
    the identity.

    `group` (a `parallel` mesh or process group) makes it the data-parallel
    step: each rank draws `cfg.batch_size` instances and its rollout from
    its own generator (JAX's `fold_in` of the shard index on the data and
    rollout keys), and the gradients and the three metrics are `pmean`'d."""
    opt = ClippedAdam(model.parameters(), cfg.lr, max_norm=cfg.grad_clip)
    dev = next(model.parameters()).device
    pomo = cfg.pomo_size or cfg.num_cities

    def grads(nodes, gumbel):
        actions, logp, lengths = rollout_pomo(model, nodes, cfg.pomo_size, gumbel=gumbel)
        advantage = lengths - lengths.mean(dim=1, keepdim=True)  # POMO's shared baseline
        loss = torch.mean(advantage * torch.clamp(logp, min=-5.0 * cfg.num_cities))  # `trainer.py:194`
        gs = torch.autograd.grad(loss, opt.params, allow_unused=True)
        flat = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1) for g, p in zip(gs, opt.params)])
        return flat, torch.stack([loss.detach(), lengths.mean(), lengths.min(dim=1).values.mean()]), actions

    def apply(flat, corr):
        at = 0
        for p in opt.params:
            p.grad = flat[at : at + p.numel()].view_as(p)
            at += p.numel()
        opt.step(corr=corr)
        return ()

    grads_call = CapturedCall(grads, cuda_graph)
    apply_call = CapturedCall(apply, cuda_graph, restore=opt.state_tensors())

    def step(gen: Optional[torch.Generator] = None, draws: Optional[POMODraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            nodes = torch.rand(cfg.batch_size, cfg.num_cities, 2, generator=gen, device=dev)
            gumbel = gumbel_noise((cfg.num_cities - 1, cfg.batch_size, pomo, cfg.num_cities), gen, dev)
        else:
            nodes, gumbel = draws.nodes.to(dev), draws.gumbel.to(dev)
        flat, metrics, actions = grads_call(nodes, gumbel)
        apply_call(mesh_lib.pmean(flat, group), opt.corrections())
        step.last_tours = (nodes, actions)
        return dict(zip(("loss", "mean_length", "best_length"), mesh_lib.pmean(metrics, group)))

    step.last_tours = None
    return opt, step


def train_pomo(cfg: POMOConfig = POMOConfig(), device=None, timings: Optional[List[float]] = None,
               cuda_graph: bool = True) -> Tuple[AttentionTSP, List[Dict[str, float]]]:
    """Single-device POMO training from `cfg.seed`; returns (model,
    history). With `timings`, each step's seconds are appended (the host
    reads each step's metrics, so a step ends on the card). `cuda_graph`:
    see `make_pomo_step`."""
    import time

    dev = resolve_device(device)
    model = AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers, seed=cfg.seed, device=dev)
    _, step = make_pomo_step(model, cfg, cuda_graph=cuda_graph)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    history = []
    for _ in range(cfg.num_steps):
        t0 = time.time()
        metrics = step(gen)
        history.append({k: float(v) for k, v in metrics.items()})
        if timings is not None:
            timings.append(time.time() - t0)
    return model, history


@torch.no_grad()
def beam_search(model: AttentionTSP, nodes: torch.Tensor, beam_width: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search (the rl4co beam strategy): the `beam_width` best
    partial tours by total log-probability, all from city 0 (beam 0 alone
    alive at first; dead beams score -1e9, finite so that the sums stay
    ordered). Returns (tours [B, N], lengths [B]): the shortest of the final
    live beams."""
    b, n, _ = nodes.shape
    k = beam_width
    dev = nodes.device
    cache = model.decoder_cache(model.encode(nodes))
    first = torch.zeros(b, k, dtype=torch.long, device=dev)
    visited = torch.zeros(b, k, n, dtype=torch.bool, device=dev)
    visited[:, :, 0] = True
    dead = -1e9
    scores = torch.where(torch.arange(k, device=dev)[None, :] == 0, 0.0, dead).expand(b, k).contiguous()
    tours = torch.zeros(b, k, n, dtype=torch.long, device=dev)
    current = torch.zeros(b, k, dtype=torch.long, device=dev)
    bidx, kidx = torch.arange(b, device=dev)[:, None], torch.arange(k, device=dev)[None, :]
    for t in range(1, n):
        logp = torch.log_softmax(model.decode(cache, current, first, ~visited), dim=-1)
        flat = (scores[:, :, None] + logp).reshape(b, k * n)
        top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        beam_idx, city = top_idx // n, top_idx % n
        visited = visited[bidx, beam_idx]
        tours = tours[bidx, beam_idx]
        visited[bidx, kidx, city] = True
        tours[:, :, t] = city
        current, scores = city, top_scores
    lengths = torch.where(scores > dead / 2, tour_lengths(nodes, tours), torch.inf)
    best = lengths.argmin(dim=1)
    rows = torch.arange(b, device=dev)
    return tours[rows, best], lengths[rows, best]


def augment_coords_x8(nodes: torch.Tensor) -> torch.Tensor:
    """POMO's x8 augmentation (reflections and swaps of x and y):
    [B, N, 2] -> [8B, N, 2]."""
    x, y = nodes[..., 0], nodes[..., 1]
    variants = [(x, y), (1 - x, y), (x, 1 - y), (1 - x, 1 - y), (y, x), (1 - y, x), (y, 1 - x), (1 - y, 1 - x)]
    return torch.cat([torch.stack(v, dim=-1) for v in variants], dim=0)


@torch.no_grad()
def infer_pomo(model: AttentionTSP, nodes: torch.Tensor, augment: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy POMO inference, x8 augmented unless `augment=False`; returns
    (best tours [B, N], best lengths [B]) over the augmentations and starts."""
    b, n, _ = nodes.shape
    inp = augment_coords_x8(nodes) if augment else nodes
    actions, _, lengths = rollout_pomo(model, inp, greedy=True)
    reps = 8 if augment else 1
    lengths = lengths.reshape(reps, b, n)
    actions = actions.reshape(reps, b, n, n)
    best = lengths.permute(1, 0, 2).reshape(b, -1).argmin(dim=1)
    rep_idx, pomo_idx = best // n, best % n
    rows = torch.arange(b, device=nodes.device)
    return actions[rep_idx, rows, pomo_idx], lengths[rep_idx, rows, pomo_idx]


def eval_nodes(num: int, num_cities: int, seed: int, device=None) -> torch.Tensor:
    """A fixed evaluation set: `generate_tsp_coords(num, num_cities,
    seed=seed)` as f32 [num, N, 2] on the device."""
    from rlsolver_tpu_torch.core.generate import generate_tsp_coords

    coords = generate_tsp_coords(num, num_cities, seed=seed).astype(np.float32)
    return torch.from_numpy(coords).to(resolve_device(device))
