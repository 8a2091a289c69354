"""Benchmark matrix of the PyTorch package: the counterpart of the JAX
package's ``scripts/bench_matrix.py``, the reference's ``on_cluster.sh``
analog.

The reference's only benchmark harness is a SLURM script running
``mpirun ./compress c {fl-nccl, fl-mpi}`` over {512, 2048, 3124} MB inputs
(``reference/on_cluster.sh:18-34``).  This program runs the same matrix in
one process: synthetic inputs of those sizes, each from
``numpy.random.default_rng(size_mb)`` as the JAX script draws them (bytes
below 16 for FL, runs of 16..111 bytes for RL), through the codecs of this
package's registry, one JSON row a (size, method), printed and appended to
``--out``.

    python -m fl_rl_compression_mpi_tpu_torch.bench_matrix
        [--sizes-mb 512 2048 3124] [--methods fl fl-cpu fl-dist rl-cpu]
        [--reps 3] [--host-verify] [--device cuda]
        [--out logs/bench_matrix_torch.jsonl]

Each call is timed on the host clock around work that ends in
``torch.cuda.synchronize()`` (the codecs return host arrays, so they have
waited for the card already): the median of ``--reps`` calls after one
warm-up.  ``fl-dist`` runs at one rank with no process group.  ``--device
cpu`` runs the device methods' plain versions (the tests use it); the
default is the current card.  A row whose codec raises (``MemoryError``
at the largest sizes) carries ``error`` instead of rates.  Every row names
the ``device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .bench import resolve_device
from .models.registry import resolve
from .native import get_native


def synthetic(size_mb: int) -> dict:
    """The JAX script's streams of ``size_mb`` MiB, by family."""
    n = size_mb * (1 << 20)
    rng = np.random.default_rng(size_mb)
    fl_host = rng.integers(0, 16, n, np.uint8)
    nruns = n // 32
    rl_host = np.repeat(rng.integers(0, 256, nruns, np.uint8),
                        rng.integers(16, 112, nruns))[:n].copy()
    return {"fl": fl_host, "rl": rl_host}


def check_host_memory(n: int) -> None:
    """Raise MemoryError unless the host has room for a row on an n-byte
    stream: the input, the container, the output and the codecs' buffers,
    about 4n bytes."""
    try:
        with open("/proc/meminfo") as f:
            avail = next(int(line.split()[1]) << 10 for line in f
                         if line.startswith("MemAvailable:"))
    except (OSError, StopIteration):
        return
    if avail < 4 * n:
        raise MemoryError(f"{avail} bytes of host memory available, about "
                          f"{4 * n} needed")


def timed(fn, dev: torch.device, reps: int):
    """``(result, median seconds)`` of ``fn()`` over ``reps`` calls after
    one warm-up, each ending in a device synchronize."""
    out = fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def run_row(method: str, size_mb: int, host: np.ndarray, dev: torch.device,
            reps: int, host_verify: bool) -> dict:
    codec = resolve(method)
    device_method = method not in ("fl-cpu", "rl-cpu")
    opts = {"device": dev} if device_method else {}
    n = host.size
    rec = {"method": method, "size_mb": size_mb,
           "device": device_name(dev) if device_method else "cpu"}
    check_host_memory(n)
    comp, t_enc = timed(lambda: codec.compress(host, **opts), dev, reps)
    rec["encode_gbps"] = n / 1e9 / t_enc
    if host_verify and device_method:
        nat = get_native()
        if codec.family == "fl":
            out = nat.fl_decode(n, comp.bits, comp.values)
        else:
            out = nat.rl_decode(comp.counts, comp.values)
        rec["verify"] = "host-decode"
    else:
        out, t_dec = timed(lambda: codec.decompress(comp, **opts), dev, reps)
        rec["decode_gbps"] = n / 1e9 / t_dec
    first = comp.bits if codec.family == "fl" else comp.counts
    csize = first.size + comp.values.size + 24
    rec.update(ratio=round(csize / n, 4),
               roundtrip_ok=bool(np.array_equal(out, host)))
    return rec


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fl_rl_compression_mpi_tpu_torch.bench_matrix")
    ap.add_argument("--sizes-mb", type=int, nargs="+",
                    default=[512, 2048, 3124])
    ap.add_argument("--methods", nargs="+",
                    default=["fl", "fl-cpu", "fl-dist", "rl-cpu"])
    ap.add_argument("--out", default="logs/bench_matrix_torch.jsonl")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host-verify", action="store_true",
                    help="verify device-method round trips with the native "
                         "host decoder instead of timing the device decode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu for the plain "
                         "versions")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[ERROR] {e} (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 1

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    for size_mb in args.sizes_mb:
        streams = synthetic(size_mb)
        for method in args.methods:
            try:
                rec = run_row(method, size_mb,
                              streams[resolve(method).family], dev,
                              args.reps, args.host_verify)
            except (MemoryError, RuntimeError, ValueError) as e:
                rec = {"method": method, "size_mb": size_mb,
                       "device": device_name(dev),
                       "error": f"{type(e).__name__}: {e}"[:200]}
            results.append(rec)
            print(json.dumps(rec), flush=True)
        del streams
    with open(args.out, "a") as f:
        for rec in results:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
