"""Time the stream kernels of the PyTorch/CUDA port, K2 (`mh_stream`), K11
(`mh_onehot`) and K12 (`mh_packed`), whose streams are staged through one
ring kernel in shared memory, at several ring shapes: the numbers behind
the rings' constants in rlsolver_tpu_torch/csrc/mh_sampler.cu. With `--k3`,
also time K3's two forms across chain counts and widths: the numbers behind
`fused_form` in rlsolver_tpu_torch/ops/kernels/mh_sampler.py.

    python3 scripts/torch_mh_tile.py [--chains 8192,32768,131072] [--vary kOnehotTile=32,64,128 ...]
                                     [--rounds 1024] [--stream-chains 1048576]
                                     [--stream-rounds 400] [--k3] [--no-ring]
                                     [--k3-chains 128,1024,...] [--k3-lanes 8,16,32]
                                     [--k3-shapes 2000:400,6770:64]

Needs one CUDA card. For each combination of the values that `--vary`
gives the rings' constants (K11's and K12's `kOnehotTile`, `kOnehotChunk`,
`kOnehotStages`, `kOnehotBatch`; K2's `kStreamTile` and so on), a copy of
rlsolver_tpu_torch/csrc/ with those values is built with the library's
nvcc flags, all builds at once. On the G22-like graph (N = 2000) and each
chain count (a multiple of 4), seeded (node, u) draws of `--rounds` rounds
and their acc2 go through K11 and K12 of every build, and K2 takes a
proposal stream of `--stream-rounds` rounds on `--stream-chains` chains,
as K3's chain form does on the same chains (an empty `--chains` leaves K11
and K12 out); all builds must give the same
bits as the plain versions. Each build's kernels are timed with CUDA
events, the builds in the order given and then reversed, and the two times
averaged. One JSON line per chain count; the card's name and power limit
come first.

`--k3` times K3 (the library as built for the package) at each N:rounds of
`--k3-shapes` (by default N = 2000 with 400 rounds, gset_22's MH rounds,
and TNCO's N = 6770 with 64 rounds, Sycamore N53's 12-layer shape), on
each of `--k3-chains` chains: the chain form and the split form at each of
`--k3-lanes`, each held bit for bit against the plain version on the same
chains, timed in the order given and then reversed (20 launches captured
in a CUDA graph and replayed, so that the host's launch time does not hide
a short kernel's). One JSON line per shape, with the form `fused_form`
picks; then, per N, one chain's launch at R and 2R rounds in each form,
whose difference over R is a round's dependent latency.
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

from chip_smoke import graph_ms  # noqa: E402
from rlsolver_tpu_torch.core.generate import build_g22_like  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import build, codec  # noqa: E402
from rlsolver_tpu_torch.ops.kernels import mh_sampler as mh  # noqa: E402

RING_CONSTANT = r"(constexpr\s+int\s+{}\s*=\s*)\d+"


def build_variant(values: dict, key: str, work: str) -> subprocess.Popen:
    """Starts nvcc on a copy of csrc/ whose mh_sampler.cu has each integer
    constant of `values` (name -> value) set to its value."""
    src = os.path.join(work, f"csrc_{key}")
    shutil.copytree(build.CSRC, src)
    source = os.path.join(src, "mh_sampler.cu")
    with open(source) as f:
        text = f.read()
    for name, value in values.items():
        text, found = re.subn(RING_CONSTANT.format(name), rf"\g<1>{value}", text)
        if found != 1:
            raise RuntimeError(f"{name} not found in mh_sampler.cu")
    with open(source, "w") as f:
        f.write(text)
    out = os.path.join(work, f"libmh_{key}.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", src, "-o", out, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def variants(vary) -> dict:
    """{key: {constant: value}} for every combination of the `--vary`
    options (NAME=v1,v2,...); a key is "NAME=v,NAME=v"."""
    combos = [{}]
    for spec in vary:
        name, values = spec.split("=")
        combos = [{**c, name: int(v)} for c in combos for v in values.split(",")]
    return {",".join(f"{k}={v}" for k, v in c.items()): c for c in combos}


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


def k3_forms(probs, n, chains, rounds, lanes_list, gen):
    """K3's chain form and split form at each lane count on `chains` chains
    of N = n: each bit for bit against the plain version, then timed."""
    dev = probs.device
    w = codec.num_words(n)
    thr = mh.fused_thresholds(probs)
    words0 = codec.pack_bits(torch.rand(chains, n, generator=gen, device=dev) < 0.5)
    plain = mh.mh_fused_plain(2468, thr, words0, n, rounds)
    runs = {"chain": lambda out: mh.MH_FUSED.launch(thr, out, chains, w, n, rounds, 2468)}
    for lanes in lanes_list:
        runs[f"split{lanes}"] = (lambda out, lanes=lanes:
                                 mh.MH_FUSED_SPLIT.launch(thr, out, chains, w, n, rounds, 2468, lanes))
    for name, run in runs.items():
        out = words0.clone()
        run(out)
        if not torch.equal(out, plain):
            raise AssertionError(f"K3 {name} differs from the plain version at {chains} chains, N = {n}")
    scratch = words0.clone()
    times = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        times[k].append(graph_ms(lambda: runs[k](scratch)))
    return {k: sum(v) / len(v) for k, v in times.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chains", default="8192,32768,131072")
    p.add_argument("--vary", action="append", help="NAME=v1,v2: a constant of mh_sampler.cu to build at each value "
                   "(repeatable; every combination is built); default kOnehotTile=32,64,128")
    p.add_argument("--k3-shapes", default="2000:400,6770:64", help="N:rounds pairs for --k3")
    p.add_argument("--rounds", type=int, default=1024)
    p.add_argument("--stream-chains", type=int, default=1 << 20)
    p.add_argument("--stream-rounds", type=int, default=400)
    p.add_argument("--k3", action="store_true", help="time K3's two forms")
    p.add_argument("--no-ring", action="store_true", help="skip K2, K11 and K12")
    p.add_argument("--k3-chains", default="128,1024,8192,32768,131072,458752,1048576")
    p.add_argument("--k3-lanes", default="8,16,32")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_mh_tile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if not args.no_ring:
        ring(args)
    if args.k3:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(2027)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lanes_list = [int(x) for x in args.k3_lanes.split(",")]
        for n, rounds in (tuple(int(x) for x in sh.split(":")) for sh in args.k3_shapes.split(",")):
            probs = torch.rand(n, generator=gen, device=dev) * 0.6 + 0.2
            for chains in (int(c) for c in args.k3_chains.split(",")):
                ms = k3_forms(probs, n, chains, rounds, lanes_list, gen)
                print(json.dumps({"k3": True, "chains": chains, "n": n, "rounds": rounds, "ms": ms,
                                  "fused_form": mh.fused_form(chains, codec.num_words(n), sms)}), flush=True)
            one = {k: k3_forms(probs, n, 1, r, lanes_list, gen) for k, r in (("r", rounds), ("2r", 2 * rounds))}
            print(json.dumps({"k3_serial": True, "n": n, "rounds": rounds, "one_chain_ms": one,
                              "round_latency_us": {k: 1e3 * (one["2r"][k] - one["r"][k]) / rounds
                                                   for k in one["r"]}}), flush=True)
    print(smi)
    return 0


def ring(args) -> None:
    """K2, K11 and K12 in each build of `--vary` (see the module's doc)."""
    builds = variants(args.vary or ["kOnehotTile=32,64,128"])
    tiles = list(builds)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        procs = {t: build_variant(builds[t], str(i), work) for i, t in enumerate(tiles)}
        for t, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {t}:\n{log}")
        libs = {t: ctypes.CDLL(os.path.join(work, f"libmh_{i}.so")) for i, t in enumerate(tiles)}
        k2 = {t: bind(lib, mh.MH_STREAM) for t, lib in libs.items()}
        k3 = {t: bind(lib, mh.MH_FUSED) for t, lib in libs.items()}
        k11 = {t: bind(lib, mh.MH_ONEHOT) for t, lib in libs.items()}
        k12 = {t: bind(lib, mh.MH_PACKED) for t, lib in libs.items()}

        dev = torch.device("cuda")
        g = build_g22_like()
        n, w = g.num_nodes, codec.num_words(g.num_nodes)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2026)
        probs = torch.rand(n, generator=gen, device=dev) * 0.6 + 0.2
        bs, rs = args.stream_chains, args.stream_rounds
        if bs % 4:
            raise ValueError(f"--stream-chains: {bs} is not a multiple of 4 (the ring's rows)")
        stream = torch.cat([mh.make_proposal_stream(
            torch.randint(0, 2**32, (min(16, rs - r), bs), generator=gen, device=dev, dtype=torch.int64), probs)
            for r in range(0, rs, 16)])
        words0 = codec.pack_bits(torch.rand(bs, n, generator=gen, device=dev) < 0.5)
        plain = mh.mh_stream_plain(stream, words0)
        row = {"chains": bs, "rounds": rs, "nodes": n}
        for t in tiles:
            out = words0.clone()
            k2[t](stream, out, bs, bs, w, rs)
            if not torch.equal(out, plain):
                raise AssertionError(f"mh_sample_stream in the build {t} differs from the plain version")
        scratch = words0.clone()
        times = {t: [] for t in tiles}
        for t in tiles + tiles[::-1]:
            times[t].append(event_ms(lambda: [k2[t](stream, scratch, bs, bs, w, rs) for _ in range(5)]) / 5)
        row["mh_sample_stream"] = {t: sum(v) / len(v) for t, v in times.items()}
        # K3's chain form on the same chains (the builds may change how a block loads them)
        thr = mh.fused_thresholds(probs)
        plain = mh.mh_fused_plain(1357, thr, words0, n, rs)
        for t in tiles:
            out = words0.clone()
            k3[t](thr, out, bs, w, n, rs, 1357)
            if not torch.equal(out, plain):
                raise AssertionError(f"mh_sample_fused in the build {t} differs from the plain version")
        times = {t: [] for t in tiles}
        for t in tiles + tiles[::-1]:
            times[t].append(event_ms(lambda: [k3[t](thr, scratch, bs, w, n, rs, 1357) for _ in range(5)]) / 5)
        row["mh_sample_fused"] = {t: sum(v) / len(v) for t, v in times.items()}
        print(json.dumps(row), flush=True)
        del stream, words0, plain, scratch
        for chains in (int(c) for c in args.chains.split(",") if c):
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
                        raise AssertionError(f"{name} in the build {t} differs from the plain version at "
                                             f"{chains} chains")
                scratch = words0.clone()
                times = {t: [] for t in tiles}
                for t in tiles + tiles[::-1]:
                    times[t].append(event_ms(lambda: run(t, scratch)))
                row[name] = {t: sum(v) / len(v) for t, v in times.items()}
            print(json.dumps(row), flush=True)
        del libs, k2, k3, k11, k12


if __name__ == "__main__":
    sys.exit(main())
