#!/usr/bin/env python3
"""The sweep that fixed the tile-packed encode's cluster-route geometry
(csrc/tile_packed.cuh's FLRL_TP_GEOMETRY: threads a block, bytes of words
a block aims to hold) on one CUDA GPU (an H100).

Run from the repository root:  python3 chip_tile_packed.py [--out FILE]

csrc/tile_packed.cu is built once a geometry in VARIANTS, all builds at
once, and ptxas's registers and spills of each build's cluster kernels
are printed.  Each build's encode is checked against ``encode_ref`` (and
its decode against the words) at R = 1024 and 2048, both layouts, with
``chip_smoke.check_tile_packed``, then timed with ``chip_smoke.launch_ms``
(a launch over a run of 20) and ``cuda_ms`` (a single call) on 256 MiB of
words: width 4 at R = 1024 in both layouts and at R = 2048 (cursor),
widths 1 and 8 at R = 1024 (cursor).  The builds run in the order of
VARIANTS and then backwards.  Prints the card's name and power limit
first; with ``--out FILE`` writes every number to FILE as JSON.  Exits
nonzero without a CUDA device or on any difference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as smoke
from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import tile_packed_cuda as tp

MIB = 1 << 20
N = 256 * MIB                  # exp21 / exp22's stream
# (threads a block, bytes of words a block): the shipped geometry first;
# 131072 gives C = 4 at R = 1024 and C = 8 at 2048 (one block an SM)
VARIANTS = ((256, 65536), (256, 32768), (512, 65536), (128, 65536),
            (256, 131072))
CASES = ((4, 1024, "cursor"), (4, 1024, "sparse"), (4, 2048, "cursor"),
         (1, 1024, "cursor"), (8, 1024, "cursor"))
DEVICE = torch.device("cuda", 0)


def say(msg: str) -> None:
    print(msg, flush=True)


class Variant:
    """The kernel library with csrc/tile_packed.cu's entry points taken
    from another build."""

    def __init__(self, path: str, base):
        self.handle = ctypes.CDLL(path)
        self.base = base
        for name in _build._SIGNATURES:
            if name.startswith("flrl_tile_packed"):
                fn = getattr(self.handle, name)
                fn.restype, fn.argtypes = _build._SIGNATURES[name]

    def __getattr__(self, name):
        if name.startswith("flrl_tile_packed"):
            return getattr(self.handle, name)
        return getattr(self.base, name)


def build_variants(out_dir: str) -> dict:
    """``{(threads, bytes): (library path, nvcc's output)}``, one nvcc a
    geometry, all at once.  The geometry comes in by a pre-included file,
    since nvcc splits a -D value at its commas."""
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "tile_packed.cu")
    cmds = {}
    for threads, nbytes in VARIANTS:
        stem = os.path.join(out_dir, f"tp_{threads}_{nbytes}")
        with open(stem + ".h", "w") as f:
            f.write(f"#define FLRL_TP_GEOMETRY {threads}, {nbytes}\n")
        cmds[threads, nbytes] = (stem + ".so", [
            _build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
            _build.CSRC_DIR, "--pre-include", stem + ".h", src, "-o",
            stem + ".so"])
    with ThreadPoolExecutor(len(cmds)) as pool:
        logs = pool.map(lambda c: _build._run([c[1]]), cmds.values())
        return {v: (c[0], log) for (v, c), log in zip(cmds.items(), logs)}


def cluster_ptxas(log: str) -> str:
    """ptxas's registers and spills of the cluster kernels in a log."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"entry function '.*cluster_encode_kernelILb(\d)E",
                          line)
        if entry:
            name = "<true>" if entry.group(1) == "1" else "<false>"
        elif "entry function" in line:
            name = None
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name} " + re.sub(r"^ptxas info\s*:\s*", "",
                                           line.strip()))
    return "; ".join(out)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("[FAIL] no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"[device] {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)
    base = _build.lib()
    builds = build_variants(os.path.join(_build.BUILD_DIR, "sweep"))
    for v, (_, log) in builds.items():
        say(f"[sweep] ptxas, threads {v[0]}, {v[1]} bytes a block: "
            f"{cluster_ptxas(log)}")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2027)
    words = {b: torch.randint(0, 1 << b, (N,), generator=gen, device=DEVICE,
                              dtype=torch.uint8).view(torch.int32).view(-1,
                                                                        128)
             for b in (1, 4, 8)}
    small = smoke.tile_words(gen, 1024)
    rows = []
    for v in VARIANTS + VARIANTS[::-1]:
        _build._LIB = Variant(builds[v][0], base)
        try:
            for layout in tp.LAYOUTS:
                smoke.check_tile_packed(small, 1024, layout)
                for R in (1024, 2048):
                    smoke.check_tile_packed(words[4][:R * 64], R, layout)
            for b, R, layout in CASES:
                route = tp.route_of(R)
                fn = lambda: tp.encode(words[b], R, layout)  # noqa: E731
                t = {"launch_ms": smoke.launch_ms(fn), "ms": smoke.cuda_ms(fn)}
                rows.append({"threads": v[0], "block_bytes": v[1],
                             "width": b, "R": R, "layout": layout,
                             "route": route, **t})
                say(f"[sweep] threads {v[0]}, {v[1]} bytes a block: w{b} "
                    f"R={R} {layout} ({route}) {t['launch_ms']:.4f} ms a "
                    f"launch, {t['ms']:.4f} single")
        finally:
            _build._LIB = base
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "sweep": rows}, f, indent=1)
    say("[done]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
