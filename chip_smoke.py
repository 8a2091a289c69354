#!/usr/bin/env python3
"""Smoke test of the PyTorch package on one CUDA GPU (an H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing a line and failing the run on any error:

1. device   — needs a CUDA device; prints nvidia-smi's name and power limit.
2. build    — builds the kernels from csrc/ with nvcc (ops/_build.py).
3. kernels  — every FL kernel against its plain PyTorch version on the
              card, byte for byte: widths 1..8, per-frame random widths,
              tails n mod 128 in {0, 1, 77, 127}, L in {128, 64, 1024}, a
              64 MiB mixed stream, general and uniform mode, the widths flag;
              then both versions timed at the main path's shapes (CUDA
              events).  Then every RL kernel the same way: few runs, runs of
              300, dense bytes (R = n), one long zero run, runs of 254, 255,
              256 and 510, constant tiles between varying regions, tails
              n mod 4096 in {0, 1, 77, 4095}, a 64 MiB mixed stream, chunk
              carries (mid-piece, at a cap boundary, on a new value), zero
              counts; timed on the 512 MiB rl_mixed stream.
4. goldens  — the CLI's `c fl` reproduces every tests/golden/reference
              container; `d fl` of every container equals the fl-cpu decode;
              `c rl` reproduces tests/golden/input.rl and `d rl` restores it.
5. main     — the CLI's `c fl --verify` and `d fl` on two 512 MiB streams
              (mixed widths; uniform width 4), then `c rl --verify` and
              `d rl` on the 512 MiB rl_mixed stream: restored bytes equal the
              input, containers equal the native fl-cpu / rl-cpu encoder's,
              and every kernel of each path was launched in its run.
6. chunks   — the API's fl and rl on 1 GiB + 4,173 bytes, across the 1 GiB
              chunk cap, against fl-cpu and rl-cpu.

The next-to-last line of stdout is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Nothing is printed there on failure.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fl_rl_compression_mpi_tpu_torch import cli
from fl_rl_compression_mpi_tpu_torch import compress, decompress
from fl_rl_compression_mpi_tpu_torch import load_fl, load_rl
from fl_rl_compression_mpi_tpu_torch.models.registry import CODECS
from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda as k
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch
from fl_rl_compression_mpi_tpu_torch.ops import rl_cuda as rk

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "reference")
SEED = 1234
MIB = 1 << 20
SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/fl_dense.cu"
PALLAS = "fl_rl_compression_mpi_tpu/ops/fl_dense_pallas.py"
# kernel (launch-counter key) -> TPU kernel entry point it replaces
REPLACES = {
    "fl_frame_widths": f"{PALLAS}:732",
    "fl_frame_offsets": f"{PALLAS}:732",
    "fl_pack": f"{PALLAS}:732",
    "fl_pack_uniform": f"{PALLAS}:1312",
    "fl_unpack": f"{PALLAS}:1074",
    "fl_unpack_uniform": f"{PALLAS}:1488",
}
RL_SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/rl.cu"
RL_PALLAS = "fl_rl_compression_mpi_tpu/ops/rl_pallas.py"
RL_REPLACES = {
    "rl_flags": f"{RL_PALLAS}:302",
    "rl_scan": f"{RL_PALLAS}:302",
    "rl_compact": f"{RL_PALLAS}:302",
    "rl_counts": f"{RL_PALLAS}:302",
    "rl_offsets": f"{RL_PALLAS}:579",
    "rl_expand": f"{RL_PALLAS}:579",
}
MAX_ERR = {name: 0 for name in (*REPLACES, *RL_REPLACES)}


def say(msg: str) -> None:
    print(msg, flush=True)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Kernel output vs plain output: same shape, every element equal."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = 0
    if got.numel():
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    MAX_ERR[name] = max(MAX_ERR[name], err)
    if err:
        bad = int((got != want).nonzero()[0, 0])
        raise AssertionError(f"{name}: max |kernel - plain| = {err}, first "
                             f"difference at {bad}")


def frames_of_widths(rng, widths: np.ndarray, L: int) -> np.ndarray:
    """Frames of L random bytes, frame f of width exactly widths[f]."""
    masks = ((1 << widths.astype(np.int64)) - 1).astype(np.uint8)
    data = rng.integers(0, 256, (widths.size, L), np.uint8) & masks[:, None]
    data[:, 0] = masks
    return data.reshape(-1)


def random_width_stream(rng, n: int, L: int) -> np.ndarray:
    frames = -(-n // L)
    return frames_of_widths(rng, rng.integers(1, 9, frames), L)[:n]


def uniform_stream(rng, n: int, L: int, b: int) -> np.ndarray:
    return frames_of_widths(rng, np.full(-(-n // L), b), L)[:n]


def mixed_main_stream(rng) -> np.ndarray:
    """512 MiB: a uniform-w4 head (the host probe speculates width 4 and the
    flag must catch the rest), per-frame random widths, zeros, all-w8."""
    L = 128
    parts = [uniform_stream(rng, 96 * MIB, L, 4),
             random_width_stream(rng, 256 * MIB, L),
             np.zeros(64 * MIB, np.uint8),
             uniform_stream(rng, 96 * MIB, L, 8)]
    return np.concatenate(parts)


def check_kernels(data: np.ndarray, L: int) -> None:
    """Each kernel against its plain version on one input, both modes."""
    x = torch.from_numpy(data).cuda()
    n = x.numel()
    bits, flag = k.frame_widths(x, L)
    compare("fl_frame_widths", bits, k.frame_widths_ref(x, L)[0])
    offs = k.frame_offsets(bits, n, L)
    compare("fl_frame_offsets", offs, k.frame_offsets_ref(bits, n, L))
    vals = k.pack(x, L, bits=bits, offs=offs)
    compare("fl_pack", vals, k.pack_ref(x, L, bits=bits, offs=offs))
    out = k.unpack(vals, n, L, bits=bits, offs=offs)
    compare("fl_unpack", out, k.unpack_ref(vals, n, L, bits=bits, offs=offs))
    compare("fl_unpack", out, x)
    fb = int(bits[0])
    _, flag = k.frame_widths(x, L, fb_expect=fb)
    uniform = bool((bits == fb).all())
    if int(flag.item()) != (0 if uniform else 1):
        raise AssertionError(f"widths flag {int(flag.item())} on a "
                             f"{'uniform' if uniform else 'mixed'} stream")
    if uniform:
        vu = k.pack(x, L, fb=fb)
        compare("fl_pack_uniform", vu, k.pack_ref(x, L, fb=fb))
        compare("fl_pack_uniform", vu, vals)
        ou = k.unpack(vu, n, L, fb=fb)
        compare("fl_unpack_uniform", ou, k.unpack_ref(vu, n, L, fb=fb))
        compare("fl_unpack_uniform", ou, x)
    # and the container is the native host codec's
    comp = CODECS["fl-cpu"].compress(data, frame_length=L)
    if not (np.array_equal(bits.cpu().numpy(), comp.bits)
            and np.array_equal(vals.cpu().numpy(), comp.values)):
        raise AssertionError("kernel container differs from fl-cpu")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_kernels(mixed: np.ndarray, uniform4: np.ndarray) -> dict:
    """Kernel and plain times at the main path's shapes (one 512 MiB chunk),
    each compared once more at that shape."""
    L = 128
    timings = {}
    x = torch.from_numpy(mixed).cuda()
    n = x.numel()
    bits, _ = k.frame_widths(x, L)
    offs = k.frame_offsets(bits, n, L)
    vals = k.pack(x, L, bits=bits, offs=offs)
    compare("fl_frame_widths", bits, k.frame_widths_ref(x, L)[0])
    compare("fl_frame_offsets", offs, k.frame_offsets_ref(bits, n, L))
    compare("fl_pack", vals, k.pack_ref(x, L, bits=bits, offs=offs))
    compare("fl_unpack", k.unpack(vals, n, L, bits=bits, offs=offs),
            k.unpack_ref(vals, n, L, bits=bits, offs=offs))
    timings["fl_frame_widths"] = (
        cuda_ms(lambda: k.frame_widths(x, L, fb_expect=4)),
        cuda_ms(lambda: k.frame_widths_ref(x, L, fb_expect=4)))
    timings["fl_frame_offsets"] = (
        cuda_ms(lambda: k.frame_offsets(bits, n, L)),
        cuda_ms(lambda: k.frame_offsets_ref(bits, n, L)))
    timings["fl_pack"] = (
        cuda_ms(lambda: k.pack(x, L, bits=bits, offs=offs)),
        cuda_ms(lambda: k.pack_ref(x, L, bits=bits, offs=offs)))
    timings["fl_unpack"] = (
        cuda_ms(lambda: k.unpack(vals, n, L, bits=bits, offs=offs)),
        cuda_ms(lambda: k.unpack_ref(vals, n, L, bits=bits, offs=offs)))
    del x, bits, offs, vals
    x = torch.from_numpy(uniform4).cuda()
    n = x.numel()
    vu = k.pack(x, L, fb=4)
    compare("fl_pack_uniform", vu, k.pack_ref(x, L, fb=4))
    compare("fl_unpack_uniform", k.unpack(vu, n, L, fb=4),
            k.unpack_ref(vu, n, L, fb=4))
    timings["fl_pack_uniform"] = (
        cuda_ms(lambda: k.pack(x, L, fb=4)),
        cuda_ms(lambda: k.pack_ref(x, L, fb=4)))
    timings["fl_unpack_uniform"] = (
        cuda_ms(lambda: k.unpack(vu, n, L, fb=4)),
        cuda_ms(lambda: k.unpack_ref(vu, n, L, fb=4)))
    del x, vu
    torch.cuda.empty_cache()
    return timings


def run_cli(*argv: str) -> None:
    rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")


def same_file(a: str, b: str) -> bool:
    return np.array_equal(np.fromfile(a, np.uint8), np.fromfile(b, np.uint8))


def phase_goldens(tmp: str) -> None:
    fl_cpu = CODECS["fl-cpu"]
    bins = sorted(glob.glob(os.path.join(GOLDEN, "case_*.bin")))
    for src in bins:
        out = os.path.join(tmp, "g.fl")
        run_cli("c", "fl", src, out)
        if not same_file(out, src[:-4] + ".fl"):
            raise AssertionError(f"c fl {os.path.basename(src)} differs "
                                 "from the reference container")
    fls = sorted(glob.glob(os.path.join(GOLDEN, "*.fl")))
    for comp_path in fls:
        out = os.path.join(tmp, "g.bin")
        run_cli("d", "fl", comp_path, out)
        want = fl_cpu.decompress(load_fl(comp_path))
        if not np.array_equal(np.fromfile(out, np.uint8), want):
            raise AssertionError(f"d fl {os.path.basename(comp_path)} "
                                 "differs from the fl-cpu decode")
    # the module entry point, as a user runs it
    src = bins[-1]
    out = os.path.join(tmp, "m.fl")
    proc = subprocess.run(
        [sys.executable, "-m", "fl_rl_compression_mpi_tpu_torch", "c", "fl",
         src, out, "--verify"], cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0 or not same_file(out, src[:-4] + ".fl"):
        raise AssertionError(f"python -m ... c fl failed: {proc.stderr}")
    say(f"[goldens] {len(bins)} reference containers reproduced, "
        f"{len(fls)} decoded like fl-cpu, python -m entry OK")


def phase_main(tmp: str, streams: dict) -> dict:
    """The main path through the CLI; returns the kernels' launch counts."""
    fl_cpu = CODECS["fl-cpu"]
    paths = {}
    for name, data in streams.items():
        paths[name] = os.path.join(tmp, f"{name}.bin")
        data.tofile(paths[name])
    k.reset_launches()
    for name in streams:
        src = paths[name]
        comp_path = os.path.join(tmp, f"{name}.fl")
        back = os.path.join(tmp, f"{name}.out")
        t0 = time.perf_counter()
        run_cli("c", "fl", src, comp_path, "--verify", "--timers")
        t1 = time.perf_counter()
        run_cli("d", "fl", comp_path, back, "--timers")
        t2 = time.perf_counter()
        streams[name] = (streams[name], t1 - t0, t2 - t1, comp_path, back)
    launches = dict(k.LAUNCHES)
    for name, (data, tc, td, comp_path, back) in streams.items():
        if not same_file(back, paths[name]):
            raise AssertionError(f"{name}: d fl did not restore the input")
        comp = load_fl(comp_path)
        ref = fl_cpu.compress(data)
        if not (np.array_equal(comp.bits, ref.bits)
                and np.array_equal(comp.values, ref.values)):
            raise AssertionError(f"{name}: container differs from fl-cpu")
        say(f"[main] {name}: {data.size} bytes -> "
            f"{os.path.getsize(comp_path)} bytes; c fl --verify "
            f"{tc:.3f} s, d fl {td:.3f} s (wall, host clock)")
    say(f"[main] kernel launches {json.dumps(launches)}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return launches


def phase_chunks(rng) -> None:
    n = fl_torch.MAX_DEVICE_CHUNK + 4096 + 77
    data = random_width_stream(rng, n, 128)
    t0 = time.perf_counter()
    comp = compress(data, method="fl")
    t1 = time.perf_counter()
    back = decompress(comp, method="fl")
    t2 = time.perf_counter()
    ref = CODECS["fl-cpu"].compress(data)
    if not (np.array_equal(comp.bits, ref.bits)
            and np.array_equal(comp.values, ref.values)):
        raise AssertionError("chunk walk: container differs from fl-cpu")
    if not np.array_equal(back, data):
        raise AssertionError("chunk walk: decode did not restore the input")
    say(f"[chunks] {n} bytes in 2 chunks: container equals fl-cpu, "
        f"round trip exact; encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s")


# ---------------------------------------------------------------------------
# RL
# ---------------------------------------------------------------------------

def runs_stream(rng, n: int, lo: int, hi: int, vmax: int) -> np.ndarray:
    """n bytes of runs of random length lo..hi over values 0..vmax-1,
    neighbouring runs of different values."""
    count = (n // lo + 1 if lo == hi
             else 2 * n // (lo + hi) * 11 // 10 + 1024)
    steps = rng.integers(1, vmax, count) if vmax > 1 else np.zeros(count)
    values = (np.cumsum(steps) % vmax).astype(np.uint8)
    return np.repeat(values, rng.integers(lo, hi + 1, count))[:n].copy()


def rl_mixed_stream(rng, part: int | None = None) -> np.ndarray:
    """Four parts (128 MiB each by default): image-like runs of 1..8 over
    0..15; cap-straddling runs of 200..900; random bytes (each a run: the
    worst case); zeros (a long constant region inside a non-constant
    file)."""
    part = 128 * MIB if part is None else part
    return np.concatenate([runs_stream(rng, part, 1, 8, 16),
                           runs_stream(rng, part, 200, 900, 256),
                           rng.integers(0, 256, part, np.uint8),
                           np.zeros(part, np.uint8)])


def check_rl_encode(x: torch.Tensor, prev: int = -1, d0: int = 0) -> dict:
    """The four encode kernels on one chunk, each against its plain
    version on the kernel's own inputs; returns their outputs."""
    n = x.numel()
    summ = rk.piece_tiles(x, prev)
    compare("rl_flags", summ, rk.piece_tiles_ref(x, prev))
    tstart, offs = rk.piece_offsets(summ, n, d0)
    want_t, want_o = rk.piece_offsets_ref(summ, n, d0)
    compare("rl_scan", tstart, want_t)
    compare("rl_scan", offs, want_o)
    values, starts8 = rk.compact(x, prev, tstart, offs)
    want_v, want_s = rk.compact_ref(x, prev, tstart, offs)
    compare("rl_compact", values, want_v)
    compare("rl_compact", starts8, want_s)
    counts = rk.piece_counts(starts8, n)
    compare("rl_counts", counts, rk.piece_counts_ref(starts8, n))
    return {"summ": summ, "tstart": tstart, "offs": offs, "values": values,
            "starts8": starts8, "counts": counts}


def check_rl_decode(counts: torch.Tensor, values: torch.Tensor):
    offs = rk.run_offsets(counts)
    compare("rl_offsets", offs, rk.run_offsets_ref(counts))
    n = int(offs[-1])
    out = rk.expand(counts, values, offs, n)
    compare("rl_expand", out, rk.expand_ref(counts, values, offs, n))
    return offs, out


def check_rl(data: np.ndarray) -> None:
    """A whole stream through the RL kernels: each against its plain
    version, the round trip, and the container against rl-cpu's."""
    x = torch.from_numpy(data).cuda()
    enc = check_rl_encode(x)
    _, out = check_rl_decode(enc["counts"], enc["values"])
    compare("rl_expand", out, x)
    ref = CODECS["rl-cpu"].compress(data)
    if not (np.array_equal(enc["counts"].cpu().numpy(), ref.counts)
            and np.array_equal(enc["values"].cpu().numpy(), ref.values)):
        raise AssertionError("RL kernel container differs from rl-cpu")


def phase_rl_kernels(rng) -> int:
    tile = rk.TILE
    alt = np.arange(4096, dtype=np.uint8) % 2
    cases = [
        rng.integers(0, 4, MIB + 77, np.uint8),
        np.repeat(rng.integers(0, 8, 4000, np.uint8), 300),
        runs_stream(rng, 4 * MIB, 1, 1, 256),
        np.zeros(16 * MIB, np.uint8),
        *(np.repeat(alt, length) for length in (254, 255, 256, 510)),
        np.concatenate([rng.integers(0, 9, 700, np.uint8),
                        np.full(3 * tile, 42, np.uint8),
                        rng.integers(0, 9, 900, np.uint8),
                        np.full(2 * tile + 77, 42, np.uint8),
                        np.full(tile, 43, np.uint8)]),
        *(runs_stream(rng, 4 * MIB + tail, 1, 8, 16)
          for tail in (0, 1, 77, 4095)),
        rl_mixed_stream(rng, 16 * MIB),
    ]
    for data in cases:
        check_rl(data)
    # chunk carries: byte 0 continues a run of 5 mid-piece, at a cap
    # boundary, and starts a new value
    data = np.concatenate([np.full(600, 5, np.uint8),
                           runs_stream(rng, 3 * MIB, 1, 600, 256)])
    x = torch.from_numpy(data).cuda()
    for prev, d0 in ((5, 100), (5, 255), (5, 510), (6, 40)):
        check_rl_encode(x, prev, d0)
    # zero counts (a corrupt but loadable container) take no output
    counts = rng.integers(0, 256, 4 * MIB).astype(np.uint8)
    counts[::3] = 0
    counts[-1] = 0
    values = rng.integers(0, 256, counts.size, np.uint8)
    _, out = check_rl_decode(torch.from_numpy(counts).cuda(),
                             torch.from_numpy(values).cuda())
    if not np.array_equal(out.cpu().numpy(), np.repeat(values, counts)):
        raise AssertionError("zero-count decode differs from np.repeat")
    return len(cases) + 2


def time_rl_kernels(data: np.ndarray) -> dict:
    """Kernel and plain times on one 512 MiB chunk, each compared once
    more at that shape."""
    x = torch.from_numpy(data).cuda()
    n = x.numel()
    e = check_rl_encode(x)
    offs, _ = check_rl_decode(e["counts"], e["values"])
    summ, tstart, eoffs = e["summ"], e["tstart"], e["offs"]
    starts8, counts, values = e["starts8"], e["counts"], e["values"]
    timings = {
        "rl_flags": (cuda_ms(lambda: rk.piece_tiles(x)),
                     cuda_ms(lambda: rk.piece_tiles_ref(x))),
        "rl_scan": (cuda_ms(lambda: rk.piece_offsets(summ, n)),
                    cuda_ms(lambda: rk.piece_offsets_ref(summ, n))),
        "rl_compact": (
            cuda_ms(lambda: rk.compact(x, -1, tstart, eoffs)),
            cuda_ms(lambda: rk.compact_ref(x, -1, tstart, eoffs))),
        "rl_counts": (cuda_ms(lambda: rk.piece_counts(starts8, n)),
                      cuda_ms(lambda: rk.piece_counts_ref(starts8, n))),
        "rl_offsets": (cuda_ms(lambda: rk.run_offsets(counts)),
                       cuda_ms(lambda: rk.run_offsets_ref(counts))),
        "rl_expand": (
            cuda_ms(lambda: rk.expand(counts, values, offs, n)),
            cuda_ms(lambda: rk.expand_ref(counts, values, offs, n))),
    }
    say(f"[kernels] rl_mixed: {n} bytes, {counts.numel()} pieces")
    del x, e, offs, summ, tstart, eoffs, starts8, counts, values
    torch.cuda.empty_cache()
    return timings


def phase_rl_goldens(tmp: str) -> None:
    src = os.path.join(REPO, "tests", "golden", "input.bin")
    want = src[:-4] + ".rl"
    out, back = os.path.join(tmp, "g.rl"), os.path.join(tmp, "g.bin")
    run_cli("c", "rl", src, out)
    if not same_file(out, want):
        raise AssertionError("c rl input.bin differs from input.rl")
    run_cli("d", "rl", want, back)
    if not same_file(back, src):
        raise AssertionError("d rl input.rl did not restore input.bin")
    out = os.path.join(tmp, "m.rl")
    proc = subprocess.run(
        [sys.executable, "-m", "fl_rl_compression_mpi_tpu_torch", "c", "rl",
         src, out, "--verify"], cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0 or not same_file(out, want):
        raise AssertionError(f"python -m ... c rl failed: {proc.stderr}")
    say("[goldens] c rl reproduces input.rl, d rl restores input.bin, "
        "python -m entry OK")


def phase_rl_main(tmp: str, data: np.ndarray) -> dict:
    """The rl path through the CLI; returns its kernels' launch counts."""
    src = os.path.join(tmp, "rl_mixed.bin")
    comp_path = os.path.join(tmp, "rl_mixed.rl")
    back = os.path.join(tmp, "rl_mixed.out")
    data.tofile(src)
    k.reset_launches()
    rk.reset_launches()
    t0 = time.perf_counter()
    run_cli("c", "rl", src, comp_path, "--verify", "--timers")
    t1 = time.perf_counter()
    run_cli("d", "rl", comp_path, back, "--timers")
    t2 = time.perf_counter()
    launches = dict(rk.LAUNCHES)
    if not same_file(back, src):
        raise AssertionError("rl_mixed: d rl did not restore the input")
    comp = load_rl(comp_path)
    ref = CODECS["rl-cpu"].compress(data)
    if not (np.array_equal(comp.counts, ref.counts)
            and np.array_equal(comp.values, ref.values)):
        raise AssertionError("rl_mixed: container differs from rl-cpu")
    say(f"[main] rl_mixed: {data.size} bytes -> "
        f"{os.path.getsize(comp_path)} bytes; c rl --verify "
        f"{t1 - t0:.3f} s, d rl {t2 - t1:.3f} s (wall, host clock)")
    say(f"[main] rl kernel launches {json.dumps(launches)}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"rl kernels not launched on the main path: "
                             f"{missing}")
    return launches


def phase_rl_chunks(rng) -> None:
    """1 GiB + 4,173 bytes; a run of 700 crosses the 1 GiB chunk boundary
    mid-piece (its pieces start 300 and 45 bytes before it)."""
    cap = fl_torch.MAX_DEVICE_CHUNK
    data = runs_stream(rng, cap + 4096 + 77, 1, 8, 16)
    data[cap - 300:cap + 400] = 200
    t0 = time.perf_counter()
    comp = compress(data, method="rl")
    t1 = time.perf_counter()
    back = decompress(comp, method="rl")
    t2 = time.perf_counter()
    rl_cpu = CODECS["rl-cpu"]
    ref = rl_cpu.compress(data)
    if not (np.array_equal(comp.counts, ref.counts)
            and np.array_equal(comp.values, ref.values)):
        raise AssertionError("rl chunk walk: container differs from rl-cpu")
    if not (np.array_equal(back, data)
            and np.array_equal(decompress(ref, method="rl"), data)):
        raise AssertionError("rl chunk walk: decode did not restore the "
                             "input")
    say(f"[chunks] rl: {data.size} bytes in 2 chunks: container equals "
        f"rl-cpu, round trip exact; encode {t1 - t0:.3f} s, decode "
        f"{t2 - t1:.3f} s")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("[FAIL] no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    say(f"[device] {kind}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    say(smi)

    t0 = time.perf_counter()
    _build.lib()
    say(f"[build] {os.path.relpath(_build.library_path(), REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line:
            say(f"[build] {line.strip()}")

    rng = np.random.default_rng(SEED)
    cases = 0
    for L in (128, 64, 1024):
        for b in range(1, 9):
            tail = (0, 1, 77, 127)[b % 4]
            check_kernels(uniform_stream(rng, MIB + tail, L, b), L)
            cases += 1
        for tail in (0, 1, 77, 127):
            check_kernels(random_width_stream(rng, 4 * MIB + tail, L), L)
            cases += 1
    check_kernels(random_width_stream(rng, 64 * MIB, 128), 128)
    cases += 1
    say(f"[kernels] {cases} inputs: kernels equal their plain versions "
        f"byte for byte; max |err| {json.dumps(MAX_ERR)}")

    mixed = mixed_main_stream(rng)
    uniform4 = uniform_stream(rng, 512 * MIB, 128, 4)
    timings = time_kernels(mixed, uniform4)

    t0 = time.perf_counter()
    cases = phase_rl_kernels(rng)
    say(f"[kernels] {cases} RL inputs: kernels equal their plain versions "
        f"byte for byte")
    rl_mixed = rl_mixed_stream(rng)
    timings.update(time_rl_kernels(rl_mixed))
    for name, (ms, plain) in timings.items():
        say(f"[kernels] {name}: {ms:.3f} ms kernel, {plain:.3f} ms plain "
            f"(512 MiB stream, median of 5)")
    say(f"[kernels] max |err| {json.dumps(MAX_ERR)}")
    t_rl = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        phase_goldens(tmp)
        launches = phase_main(tmp, {"mixed": mixed, "uniform4": uniform4})
        del mixed, uniform4
        t0 = time.perf_counter()
        phase_rl_goldens(tmp)
        launches.update(phase_rl_main(tmp, rl_mixed))
        del rl_mixed
        t_rl += time.perf_counter() - t0
    phase_chunks(rng)
    t0 = time.perf_counter()
    phase_rl_chunks(rng)
    t_rl += time.perf_counter() - t0
    say(f"[done] RL phases took {t_rl:.1f} s")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = [{"name": name, "route": "cuda",
                "source": SOURCE if name in REPLACES else RL_SOURCE,
                "replaces": {**REPLACES, **RL_REPLACES}[name],
                "launches": launches[name],
                "max_abs_err": MAX_ERR[name], "ms": timings[name][0],
                "plain_ms": timings[name][1]}
               for name in (*REPLACES, *RL_REPLACES)]
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
