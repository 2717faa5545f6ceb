"""Time POMO's training step of the PyTorch/CUDA port as
`rlsolver_tpu_torch.algos.am_pomo.make_pomo_step` runs it, two CUDA graphs
(the rollout and backward pass into one flat gradient buffer, then the clip
and Adam step, the gradients' reduction between them), against the whole
step captured as one graph (the gradients left in the parameters' own
`.grad` by `backward`), which this script builds from the same pieces.

    python3 scripts/torch_pomo_step_paths.py [--steps 50] [--blocks 4]

Needs one CUDA card. Both steps start from the same `AttentionTSP` at
`POMOConfig`'s widths (20 cities, 128 features, 3 layers, batch 64) and
draw from generators of the same seed; after the first three steps (the
captures) their metrics and parameters must be equal bit for bit. Then
each step runs `--steps` steps a block, the paths in turn over `--blocks`
blocks (split, one, one, split, ...), each step ending on the host's read
of its metrics as `train_pomo` ends one; a block's seconds over its steps
is its s/step. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.algos import am_pomo as ap  # noqa: E402
from rlsolver_tpu_torch.capture import CapturedCall  # noqa: E402
from rlsolver_tpu_torch.models.attention_tsp import AttentionTSP  # noqa: E402
from rlsolver_tpu_torch.ops.sampling import gumbel_noise  # noqa: E402
from rlsolver_tpu_torch.optim import ClippedAdam  # noqa: E402

NAMES = ("loss", "mean_length", "best_length")


def one_graph_step(model: AttentionTSP, cfg: ap.POMOConfig):
    """The whole step (rollout, backward, clip, Adam) as one captured call."""
    opt = ClippedAdam(model.parameters(), cfg.lr, max_norm=cfg.grad_clip)
    dev = next(model.parameters()).device

    def update(nodes, gumbel, corr):
        opt.zero_grad()
        _, logp, lengths = ap.rollout_pomo(model, nodes, cfg.pomo_size, gumbel=gumbel)
        advantage = lengths - lengths.mean(dim=1, keepdim=True)
        loss = torch.mean(advantage * torch.clamp(logp, min=-5.0 * cfg.num_cities))
        loss.backward()
        opt.step(corr=corr)
        return loss.detach(), lengths.mean(), lengths.min(dim=1).values.mean()

    call = CapturedCall(update, restore=opt.state_tensors())

    def step(gen):
        nodes = torch.rand(cfg.batch_size, cfg.num_cities, 2, generator=gen, device=dev)
        gumbel = gumbel_noise((cfg.num_cities - 1, cfg.batch_size, cfg.num_cities, cfg.num_cities), gen, dev)
        return dict(zip(NAMES, call(nodes, gumbel, opt.corrections())))

    return step


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--blocks", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_pomo_step_paths: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = ap.POMOConfig()
    paths = {}
    for name in ("split", "one"):
        model = AttentionTSP(cfg.embed_dim, cfg.num_heads, cfg.num_layers, seed=cfg.seed, device=dev)
        step = ap.make_pomo_step(model, cfg)[1] if name == "split" else one_graph_step(model, cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        paths[name] = (model, step, gen, [])
    for _ in range(3):
        got = {name: {k: float(v) for k, v in step(gen).items()} for name, (_, step, gen, _) in paths.items()}
        if got["split"] != got["one"]:
            raise AssertionError(f"the two paths' metrics differ: {got}")
    for a, b in zip(paths["split"][0].parameters(), paths["one"][0].parameters()):
        if not torch.equal(a, b):
            raise AssertionError("the two paths' parameters differ")
    order = ("split", "one", "one", "split") * ((args.blocks + 1) // 2)
    for name in order[: 2 * args.blocks]:
        _, step, gen, secs = paths[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            float(step(gen)["loss"])
        secs.append((time.perf_counter() - t0) / args.steps)
    out = {name: {"s_per_step_by_block": paths[name][3],
                  "mean_s_per_step": sum(paths[name][3]) / len(paths[name][3])} for name in paths}
    out["split_over_one"] = out["split"]["mean_s_per_step"] / out["one"]["mean_s_per_step"]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi, "steps": args.steps,
                      "bit_for_bit_after_3_steps": True, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
