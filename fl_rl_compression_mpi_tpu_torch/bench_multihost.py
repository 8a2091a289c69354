"""Multi-process benchmark of the PyTorch package: wall time and peak
resident memory per process, the counterpart of the JAX package's
``scripts/bench_multihost.py``.

It runs the CLI (``c`` then ``d``) in P processes of its own for each P of
``--np-list``, with ``--coordinator localhost:PORT --num-processes P
--process-id i`` (P = 1 goes through the same multi-process path, so the
rows are comparable), and writes one JSON row a P: the walls, each
process's peak resident memory, whether the container is byte-identical to
the first P's, and whether the decoded file is the input.

    python -m fl_rl_compression_mpi_tpu_torch.bench_multihost
        [--size-mb 1024] [--np-list 1 2 4] [--method fl] [--shared-fs]
        [--synth-codec] [--device cuda] [--out logs/bench_multihost_torch.jsonl]

``--shared-fs`` sets ``FLRL_SHARED_FS=1`` (every process writes its own
ranges), ``--synth-codec`` ``FLRL_SYNTH_CODEC=1`` (a width-8 identity
container, so the row measures the merge and write path apart from the
codec).  Process i takes card ``i % cards`` and NCCL, which refuses two
processes on one card, so a row of P processes on the default ``--device
cuda`` needs P cards, and is an ``error`` row otherwise.  ``--device cpu``
runs every process on the CPU with gloo, as the JAX script ran with
``JAX_PLATFORMS=cpu``.  Each row names its device.

Peak memory is sampled from ``/proc/self/statm`` every 2 ms in each process
and reported over the process's base (its resident memory after importing
the package and, on a card, creating its context and loading the kernels):
``ru_maxrss`` reads the CUDA start-up's peak in every process on a card
machine, whatever the run does.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 3600

# One process of a row: the CLI with the device named in argv[1], its base
# and peak resident memory (bytes) written as JSON to FLRL_RSS_OUT.
CHILD = r"""
import json, os, sys, threading
import torch
from fl_rl_compression_mpi_tpu_torch import cli
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.parallel import multihost

PAGE = os.sysconf("SC_PAGE_SIZE")


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


device, argv = sys.argv[1], sys.argv[2:]
if device == "cpu":
    registry.default_device = lambda: torch.device("cpu")
else:
    from fl_rl_compression_mpi_tpu_torch.ops import _build
    pid = int(argv[argv.index("--process-id") + 1])
    torch.zeros(1, device=multihost.local_device(pid))
    _build.lib()
base = rss()
peak = [base]
done = threading.Event()


def sample():
    while not done.wait(0.002):
        peak[0] = max(peak[0], rss())


threading.Thread(target=sample, daemon=True).start()
rc = cli.main(argv)
done.set()
with open(os.environ["FLRL_RSS_OUT"], "w") as f:
    json.dump({"base": base, "peak": max(peak[0], rss())}, f)
sys.exit(rc)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cli(nproc: int, cli_args: list, tmp: str, tag: str, device: str,
            env: dict):
    """``(wall seconds, [(base, peak) bytes a process])`` of the CLI in
    ``nproc`` processes with ``env`` added to this one's environment;
    raises when one fails."""
    env = dict(os.environ, PYTHONPATH=REPO, **env)
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for i in range(nproc):
        e = dict(env, FLRL_RSS_OUT=os.path.join(tmp, f"{tag}_{i}.rss"))
        extra = ["--coordinator", f"localhost:{port}",
                 "--num-processes", str(nproc), "--process-id", str(i)]
        log = open(os.path.join(tmp, f"{tag}_{i}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, device, *cli_args, *extra],
            env=e, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(rcs):
        bad = next(i for i, rc in enumerate(rcs) if rc)
        with open(os.path.join(tmp, f"{tag}_{bad}.log")) as f:
            tail = f.read()[-2000:]
        raise RuntimeError(f"{' '.join(cli_args)} at {nproc} processes "
                           f"exited {rcs}: {tail}")
    mem = []
    for i in range(nproc):
        with open(os.path.join(tmp, f"{tag}_{i}.rss")) as f:
            got = json.load(f)
        mem.append((got["base"], got["peak"]))
    return wall, mem


def synthetic(n: int, method: str) -> np.ndarray:
    """The JAX script's stream: runs for RL, bytes below 16 for FL."""
    g = np.random.default_rng(0)
    if method.startswith("rl"):
        k = n // 32
        return np.repeat(g.integers(0, 256, k, np.uint8),
                         g.integers(16, 112, k))[:n]
    return g.integers(0, 16, n, np.uint8)


def same_file(a: str, b: str) -> bool:
    return (os.path.getsize(a) == os.path.getsize(b)
            and subprocess.run(["cmp", "-s", a, b]).returncode == 0)


def mib(nbytes: int) -> float:
    return nbytes / (1 << 20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fl_rl_compression_mpi_tpu_torch.bench_multihost")
    ap.add_argument("--size-mb", type=int, default=1024)
    ap.add_argument("--np-list", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--method", default="fl")
    ap.add_argument("--out", default="logs/bench_multihost_torch.jsonl")
    ap.add_argument("--shared-fs", action="store_true",
                    help="FLRL_SHARED_FS=1: every process writes its own "
                         "ranges of the output")
    ap.add_argument("--synth-codec", action="store_true",
                    help="FLRL_SYNTH_CODEC=1: a width-8 identity container, "
                         "so the row measures the merge and write path")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: one card a process, NCCL (default); cpu: "
                         "gloo, the plain versions")
    args = ap.parse_args(argv)
    env = {}
    if args.shared_fs:
        env["FLRL_SHARED_FS"] = "1"
    if args.synth_codec:
        env["FLRL_SYNTH_CODEC"] = "1"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and not cards:
        print("[ERROR] no CUDA device (pass --device cpu for gloo on the "
              "CPU)", file=sys.stderr)
        return 1
    device_name = (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n = args.size_mb << 20
    rows = []
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.bin")
        synthetic(n, args.method).tofile(src)
        ref = None
        for nproc in args.np_list:
            row = {"np": nproc, "method": args.method, "device": device_name,
                   "shared_fs": bool(args.shared_fs),
                   "synth_codec": bool(args.synth_codec),
                   "size_mb": args.size_mb}
            if args.device == "cuda" and nproc > cards:
                row["error"] = (f"{nproc} processes need {nproc} cards "
                                f"(NCCL takes one a process), {cards} here; "
                                "--device cpu runs them on gloo")
                rows.append(row)
                print(json.dumps(row), flush=True)
                continue
            comp = os.path.join(td, f"out_{nproc}.c")
            dec = os.path.join(td, f"dec_{nproc}.bin")
            wall_c, mem_c = run_cli(nproc, ["c", args.method, src, comp], td,
                                    f"c{nproc}", args.device, env)
            ref = ref or comp
            wall_d, mem_d = run_cli(nproc, ["d", args.method, comp, dec], td,
                                    f"d{nproc}", args.device, env)
            row.update({
                "compress_s": wall_c, "compress_gbps": n / 1e9 / wall_c,
                "decompress_s": wall_d, "decompress_gbps": n / 1e9 / wall_d,
                "maxrss_mb_compress": [mib(p - b) for b, p in mem_c],
                "maxrss_mb_decompress": [mib(p - b) for b, p in mem_d],
                "base_rss_mb": [mib(b) for b, _ in mem_c],
                "container_identical": same_file(comp, ref),
                "roundtrip_ok": same_file(src, dec)})
            rows.append(row)
            print(json.dumps(row), flush=True)
            os.unlink(dec)
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    bad = [r for r in rows if "error" not in r
           and not (r["container_identical"] and r["roundtrip_ok"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
