"""Time K11 (`mh_onehot`) and K12 (`mh_packed`) of the PyTorch/CUDA port,
whose streams are staged through one ring kernel in shared memory, at
several chain tiles: the numbers behind their tile `kOnehotTile` in
rlsolver_tpu_torch/csrc/mh_sampler.cu.

    python3 scripts/torch_mh_tile.py [--chains 8192,32768,131072] [--tiles 32,64,128]
                                     [--rounds 1024]

Needs one CUDA card. For each tile, a copy of rlsolver_tpu_torch/csrc/ with
the ring kernel's chains per block (`kOnehotTile`) set to the tile is built
with the library's nvcc flags, all builds at once. On the G22-like graph
(N = 2000) and each chain count (a multiple of 4), seeded (node, u) draws of
`--rounds` rounds and their acc2 go through K11 and K12 of every build; all
builds must give the same bits as the plain versions. Each build's K11 and
K12 are timed with CUDA events, the builds in the order given and then
reversed, and the two times averaged. One JSON line per chain count; the
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rlsolver_tpu_torch.core.generate import build_g22_like  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import build, codec  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import mh_sampler as mh  # noqa: E402

TILE_CONSTANT = re.compile(r"(constexpr\s+int\s+kOnehotTile\s*=\s*)\d+")


def build_tile(tile: int, work: str) -> subprocess.Popen:
    """Starts nvcc on a copy of csrc/ whose K11 tile is `tile`."""
    src = os.path.join(work, f"csrc_{tile}")
    shutil.copytree(build.CSRC, src)
    source = os.path.join(src, "mh_sampler.cu")
    with open(source) as f:
        text, found = TILE_CONSTANT.subn(rf"\g<1>{tile}", f.read())
    if found != 1:
        raise RuntimeError("kOnehotTile not found in mh_sampler.cu")
    with open(source, "w") as f:
        f.write(text)
    out = os.path.join(work, f"libmh_{tile}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", src, "-o", out, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(lib: ctypes.CDLL, kernel: build.Kernel):
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = [build.Kernel._CTYPES[c] for c in kernel.argtypes] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(*args):
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        code = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{kernel.symbol} failed to launch: CUDA error {code}")

    return launch


def event_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chains", default="8192,32768,131072")
    p.add_argument("--tiles", default="32,64,128")
    p.add_argument("--rounds", type=int, default=1024)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_mh_tile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tiles = [int(t) for t in args.tiles.split(",")]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        procs = {t: build_tile(t, work) for t in tiles}
        for t, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for tile {t}:\n{log}")
        libs = {t: ctypes.CDLL(os.path.join(work, f"libmh_{t}.so")) for t in tiles}
        k11 = {t: bind(lib, mh.MH_ONEHOT) for t, lib in libs.items()}
        k12 = {t: bind(lib, mh.MH_PACKED) for t, lib in libs.items()}

        dev = torch.device("cuda")
        g = build_g22_like()
        n, w = g.num_nodes, codec.num_words(g.num_nodes)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2026)
        probs = torch.rand(n, generator=gen, device=dev) * 0.6 + 0.2
        for chains in (int(c) for c in args.chains.split(",")):
            if chains % 4:
                raise ValueError(f"--chains: {chains} is not a multiple of 4 (the ring's rows)")
            words0 = codec.pack_bits(torch.rand(chains, n, generator=gen, device=dev) < 0.5)
            nodes, u = mh.make_round_randoms(gen, args.rounds, chains, n)
            acc2 = mh.make_round_accepts(nodes, u, probs)

            runs = {"mh_sample_onehot": lambda t, words: k11[t](nodes, u, probs, words, chains, chains, w, n,
                                                                args.rounds),
                    "mh_sample_packed": lambda t, words: k12[t](nodes, acc2, words, chains, chains, w, n,
                                                                args.rounds)}
            plains = {"mh_sample_onehot": mh.mh_onehot_plain(nodes, u, probs, words0, n),
                      "mh_sample_packed": mh.mh_packed_plain(nodes, acc2, words0, n)}
            row = {"chains": chains, "rounds": args.rounds, "nodes": n}
            for name, run in runs.items():
                for t in tiles:
                    out = words0.clone()
                    run(t, out)
                    if not torch.equal(out, plains[name]):
                        raise AssertionError(f"{name} with a tile of {t} differs from the plain version at "
                                             f"{chains} chains")
                scratch = words0.clone()
                times = {t: [] for t in tiles}
                for t in tiles + tiles[::-1]:
                    times[t].append(event_ms(lambda: run(t, scratch)))
                row[name] = {str(t): sum(v) / len(v) for t, v in times.items()}
            print(json.dumps(row), flush=True)
        del libs, k11, k12
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
