#!/usr/bin/env python3
"""Smoke test of the PyTorch package on one CUDA GPU (an H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing a line and failing the run on any error:

1. device   — needs a CUDA device; prints nvidia-smi's name and power limit.
2. build    — builds the kernels from csrc/ with nvcc (ops/_build.py).
3. kernels  — every FL kernel against its plain PyTorch version on the
              card, byte for byte: widths 1..8, per-frame random widths,
              tails n mod 128 in {0, 1, 77, 127}, L in {128, 64, 1024}, a
              64 MiB mixed stream, general and uniform mode, the widths flag.
              The offsets scan on frame counts 1, tile-1, tile, tile+1,
              2·tile+1 and 2^27 (1 GiB at L = 8) of random widths, and twenty
              calls in a row on other widths of one size, each result freed
              before the next (the allocator hands back the block with the
              last call's status words); the pack on widths cycling with
              periods 3, 5 and 7 at L in {8, 24, 40, 64, 128, 136, 1024} with
              tails n mod L in {0, 1, 7, 8, 9, 15, 16, 17, L-1}, uniform mode
              at widths 1..8 there, and data at a 16-byte, frame-aligned
              offset inside a larger buffer.  The widths and the unpack on
              frame counts around a widths step, a block and the resident
              grid's pass and byte counts around the unpack's two-span
              step, twenty widths calls in a row on reused memory, the
              flag with one frame of another width first, in the middle
              and last at each fb_expect, 1 GiB at L = 8 in both modes,
              the payload at every 16-byte phase with values_size exact,
              last frames of 1..17 bytes, and the refusal past 2^31 bytes
              (drawn from a generator of their own).  Then both versions
              timed at the main path's shapes (CUDA events), the widths and
              unpack on each part of the mixed stream beside its bound,
              and torch.amax over the mixed stream's frames as a yardstick
              for the widths.  Then every RL kernel the
              same way: few runs, runs of 300, dense bytes (R = n), one long
              zero run, runs of 254, 255, 256 and 510, constant tiles
              between varying regions, tails
              n mod 4096 in {0, 1, 77, 4095}, a 64 MiB mixed stream; the
              encode at 1, 31, 32, 33 and 1024 tiles, a run of one byte
              over 40 tiles inside a non-constant chunk, twenty calls in a
              row on reused memory, one launch of exactly 2^30 bytes
              (against rl-cpu), the refusal of 2^30 + 16 bytes, chunk
              carries (mid-piece, at a cap boundary, on a new value, d0 in
              {254, 255, 256, 2^31 + 7}, a chunk with no natural start);
              the expand on output sizes 1..33, runs of 1, 15, 16, 17 and
              255, tile outputs at every 16-byte phase, zero counts; timed
              on the 512 MiB rl_mixed stream, the run offsets beside a
              yardstick (each whole tile's sum in int64, then cumsum; each
              of the two calls also timed alone).  Then the FL field kernels
              (base and pack-2 mode) the same way: widths 1..8, random
              widths, tails n mod L in {0, 1, 77, L-1}, L in {8, 24, 64, 128,
              512, 1024}, pack-2 at tile_r 16 and 2048 on width <= 4
              streams, a 64 MiB stream; each container from the native host
              fold equal to fl-cpu's; timed on the 512 MiB mixed (base) and
              uniform4 (base and pack-2) streams, and the encode and the
              decode in both modes on each part of the mixed stream.  Then the
              constant-stream kernels: c in {0, 1, 3, 15, 255}, c = 0 with
              tails {1, 77, 127}, unaligned starts, the flags on flipped
              input and payload bytes (not on the pad past the payload),
              64 MiB of 0x00 and 0x0F; timed on 512 MiB of zeros.  Every
              timed kernel is reported with its bound (bytes moved over
              3.35 TB/s) and, where one PyTorch call computes the same
              function (torch.cumsum, torch.repeat_interleave), that call's
              time.  Each kernel and library call is timed two ways: the
              median of 5 single calls, each between its own event pair
              (`ms`, which counts the wrapper's host work while the card
              waits), and the time a launch over a run of 20 calls between
              one event pair, queued behind a device sleep so that the
              host's enqueue stays out of it (`launch_ms`; a wrapper that
              reads a size back, as the general pack does, still waits).
4. goldens  — the CLI's `c fl` reproduces every tests/golden/reference
              container; `d fl` of every container equals the fl-cpu decode;
              `c rl` reproduces tests/golden/input.rl and `d rl` restores it.
5. main     — the CLI's `c fl --verify` and `d fl` on two 512 MiB streams
              (mixed widths; uniform width 4), then `c rl --verify` and
              `d rl` on the 512 MiB rl_mixed stream: restored bytes equal the
              input, containers equal the native fl-cpu / rl-cpu encoder's,
              and every kernel of each path was launched in its run.
6. fields   — the FL field route (FLRL_NO_DENSE=1): the goldens through the
              CLI, then `c fl --verify` and `d fl` on the two 512 MiB streams
              (mixed: a pack-2 miss, then the base kernels; uniform4: a
              pack-2 hit), an L = 1024 run on 64 MiB (no pack-2 layout:
              the base kernels only), and an L = 64 run on 64 MiB through
              `python -m` in a subprocess: containers equal
              fl-cpu's and the dense route's, every field kernel launched on
              this route and no dense kernel (and the reverse on the dense
              route's run).  The host fold must be the native one.
7. dist     — parallel/dist.py: the CLI's `c --verify` and `d` of fl-dist
              and fl-ici on the two 512 MiB FL files and of rl-dist on
              rl_mixed at --devices 1 (one rank in this process, with no
              process group): containers equal the main phase's (fl-cpu's;
              rl's, which is rl-cpu's at one shard), round trips exact, the
              path's kernels launched in each run, no process group left
              after them; walls of each beside `fl`/`rl`, two rounds; a
              one-file CLI process (`python -m ... c fl-dist --devices 1`
              and `c fl` on mixed, a fresh process each, three each, in
              turns), process start included; the device-resident constant
              programs on 512 MiB of 0x00 and 0x0F at world size 1 (bytes
              exact, flags clean, a flipped byte trips each flag; the only
              launches of the constant kernels counted for the path); two
              gloo ranks spawned on card 0 over 64 MiB (fl-dist through the
              API, then fl-ici, the FL decode, rl-dist and its decode in one
              group): FL containers equal fl-cpu's, RL equals rl-cpu's
              per-shard containers concatenated, every rank launched its
              kernels.
   multihost — parallel/multihost.py, right after the dist phase's walls:
              one process under torchrun running the CLI with
              `--coordinator env://` on the main phases' 512 MiB files
              (`c fl-dist --verify` and `d` on mixed and uniform4, `c
              rl-dist --verify` and `d` on rl_mixed, then two rounds of
              walls beside phase 7's `fl`/`rl`): containers equal the main
              phases', outputs the input, every path's kernels launched; one
              `python -m` run with `--coordinator 127.0.0.1:<port>
              --num-processes 1 --process-id 0`; `c fl --profile`, whose
              trace must name a `flrl_` kernel; two gloo processes on card
              0 over 64 MiB (generator SEED + 7) through the module
              functions in one spawned group, merged to rank 0 in 1 MiB
              rounds and then under FLRL_SHARED_FS=1: FL equals fl-cpu's
              container, RL rl-cpu's per-shard containers concatenated,
              every rank launched its kernels.
8. chunks   — the API's fl and rl on 1 GiB + 4,173 bytes, across the 1 GiB
              chunk cap, against fl-cpu and rl-cpu; the field route's fl on
              512 MiB + 4,173 bytes across a 256 MiB cap (a pack-2 hit, then
              a miss).
   stream   — stream.py through the CLI's --stream-chunk-mb, after the
              chunk phases, from a generator of its own (SEED + 8): a
              1.25 GiB + 77 byte file (w4, random widths, zeros, w8, a
              ragged tail) at 64 and 256 MiB chunks, c and d beside the
              whole-file c fl / d fl (whose container equals fl-cpu's):
              every stream container equals the whole-file one on both
              routes, the decodes restore the input, --verify passes, the
              dense kernels launched; one pipelined encode and decode of
              512 MiB in 96 MiB chunks (a uniform hit, the flag's miss,
              random widths) under torch.cuda.set_sync_debug_mode("error");
              each copy stage's rate a chunk from a --timers run, and a
              torch.profiler trace of c and d at 256 MiB (the device's busy
              time, its copies and kernels, and their overlap); the
              resident memory of a streaming CLI process (a fresh process
              for each chunk size and file): its base, and its peak during
              c and during d, on 384 MiB + 77 bytes and on the whole file.
   bench    — the copy-ceiling probe (csrc/copy_probe.cu) against x + 1 on
              int32 bit-views, byte for byte: word counts 1, 3, 4, 5,
              2048·128 and 512 MiB, words at 0xFFFFFFFF, starts 4 to 12
              bytes into a larger buffer (its word path), from a generator
              of its own (SEED + 9); timed at 512 MiB beside its bound,
              x + 1 (its library row) and copy_; then `python -m
              fl_rl_compression_mpi_tpu_torch.bench --size-mb 256
              --json-only` in a process of its own with a
              100 s arm budget: it must exit 0 having run every arm but
              the --full ones, with host_roundtrip_ok, dense_ok* and rl_ok
              true and no key ending in _error or _flag; its last line is
              printed on a [bench] line, and the copy probe's launches are
              the ones that run reports.
9. classes  — after every timed phase, since their large buffers, freed
              with empty_cache(), slowed the timed phases that came after
              them: the run offsets on run counts around a tile, a group of
              kRunGroup tiles and 40 groups (a look-back past its window),
              tail tiles of 1 and 4095 runs, random, zero and all-255
              counts, twenty calls in a row on reused memory, and 2^30 zero
              counts followed by 2^30 counts of 255; the field encode on
              frame counts around a warp step, a block and the resident
              grid's pass (L = 8, 24, 128, 512, 1024; pack-2 packed rows at
              L = 8, 128, 512), pack-2 tiles at tile_r 16 and 2048 with a
              width-5 frame in the last tile, every uniform width, 1 GiB at
              L = 128 in both modes, and the refusal past 2^31 bytes; the
              field decode on frame counts around a warp step, a block and
              the grid's pass (L = 8, 24, 128, 512, 1024), pack-2 streams
              at L = 8, 128, 512 and tile_r 16 and 2048 that end in the
              first half of the last tile, mid-row and (L = 8) mid-group,
              every uniform width, twenty calls on reused memory, 1 GiB at
              L = 128 in both modes, and the refusals past 2^31 bytes and
              of a misaligned view; each against its plain version, byte
              for byte, drawn from generators of their own.

The next-to-last line of stdout is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  Nothing is printed there on failure.

`python3 chip_smoke.py --torchrun-cli SPEC` is the multihost phase's
process under torchrun (see `torchrun_child`), not a smoke run.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fl_rl_compression_mpi_tpu_torch import cli
from fl_rl_compression_mpi_tpu_torch import compress, decompress
from fl_rl_compression_mpi_tpu_torch import RLCompressed, load_fl, load_rl
from fl_rl_compression_mpi_tpu_torch.models.registry import CODECS
from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import fields
from fl_rl_compression_mpi_tpu_torch.ops import copy_probe_cuda as cpk
from fl_rl_compression_mpi_tpu_torch.ops import fl_constant_cuda as ck
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda as k
from fl_rl_compression_mpi_tpu_torch.ops import fl_fields_cuda as fk
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch
from fl_rl_compression_mpi_tpu_torch.ops import rl_cuda as rk
from fl_rl_compression_mpi_tpu_torch.parallel import dist
from fl_rl_compression_mpi_tpu_torch.utils.timers import set_stage_timers

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "reference")
SEED = 1234
MIB = 1 << 20
DEVICE = torch.device("cuda", 0)   # the card every phase runs on
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
    "rl_encode": f"{RL_PALLAS}:302",
    "rl_offsets": f"{RL_PALLAS}:579",
    "rl_expand": f"{RL_PALLAS}:579",
}
FIELDS_SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/fl_fields.cu"
FIELDS_PALLAS = "fl_rl_compression_mpi_tpu/ops/fl_pallas.py"
FIELDS_REPLACES = {
    "fl_fields_encode": f"{FIELDS_PALLAS}:190",
    "fl_fields_encode_p2": f"{FIELDS_PALLAS}:358",
    "fl_fields_decode": f"{FIELDS_PALLAS}:237",
    "fl_fields_decode_p2": f"{FIELDS_PALLAS}:399",
}
CONST_SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/fl_constant.cu"
CONST_REPLACES = {
    "fl_const_encode": f"{PALLAS}:1720",
    "fl_const_decode": f"{PALLAS}:1796",
}
COPY_SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/copy_probe.cu"
COPY_REPLACES = {"copy_probe": "bench.py:421"}
SOURCES = {**{name: SOURCE for name in REPLACES},
           **{name: FIELDS_SOURCE for name in FIELDS_REPLACES},
           **{name: RL_SOURCE for name in RL_REPLACES},
           **{name: CONST_SOURCE for name in CONST_REPLACES},
           **{name: COPY_SOURCE for name in COPY_REPLACES}}
ALL_REPLACES = {**REPLACES, **FIELDS_REPLACES, **RL_REPLACES,
                **CONST_REPLACES, **COPY_REPLACES}
MAX_ERR = {name: 0 for name in ALL_REPLACES}
# Bytes each timed kernel call must move (every input read once, every
# output written once), and the time of one PyTorch call that computes the
# same function on the same inputs, where there is one.
MOVED: dict = {}
LIBRARY_MS: dict = {}
# Milliseconds a launch over a run of RUN calls, of each kernel and library
# call (see launch_ms).
LAUNCH_MS: dict = {}
LIBRARY_LAUNCH_MS: dict = {}
RUN = 20
SLEEP_CYCLES = 20_000_000          # about 10 ms of device sleep at 1.98 GHz
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
DENSE_MAX_BYTES = 1 << 31          # kDenseMaxBytes: the most a launch takes
HALF_RUNS = 1 << 30                # zero counts, then as many of 255


def say(msg: str) -> None:
    print(msg, flush=True)


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Kernel output vs plain output: same shape, every element equal
    (int32 tensors are u32 bit-views and compare as u32)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = 0
    if got.numel():
        mask = 0xFFFFFFFF if got.dtype == torch.int32 else -1
        err = int(((got.to(torch.int64) & mask)
                   - (want.to(torch.int64) & mask)).abs().max())
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


def random_width_stream(rng, n: int, L: int, top: int = 8) -> np.ndarray:
    """Frames of random widths 1..top."""
    frames = -(-n // L)
    return frames_of_widths(rng, rng.integers(1, top + 1, frames), L)[:n]


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


# mixed_main_stream's parts: name, MiB
MIXED_PARTS = (("w4 head", 96), ("random widths", 256), ("zeros", 64),
               ("w8", 96))


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


# The offsets scan's classes: frame counts around its tile and a 1 GiB chunk
# at L = 8.  The pack's: frame lengths with L % 16 in {0, 8}, tails around
# its 8- and 16-byte lane groups, widths that change inside a warp's span.
PACK_LENGTHS = (8, 24, 40, 64, 128, 136, 1024)
PACK_TAILS = (0, 1, 7, 8, 9, 15, 16, 17)


def check_offsets(bits: torch.Tensor, n: int, L: int,
                  want: torch.Tensor | None = None) -> None:
    if want is None:
        want = k.frame_offsets_ref(bits, n, L)
    compare("fl_frame_offsets", k.frame_offsets(bits, n, L), want)


def phase_offsets_classes(rng) -> int:
    """The offsets scan on random widths 1..8 at frame counts 1, tile-1,
    tile, tile+1, 2·tile+1 (L = 8, 24, 128 with tails) and 2^27 (1 GiB at
    L = 8); then twenty calls in a row on other widths of one size (the
    main path's 2^22 frames), each compared and freed before the next."""
    T = k.OFFSETS_TILE
    cases = 0
    for F in (1, T - 1, T, T + 1, 2 * T + 1):
        for L, tail in ((8, 0), (24, 5), (128, 77)):
            bits = torch.from_numpy(rng.integers(1, 9, F, np.uint8)).cuda()
            check_offsets(bits, (F - 1) * L + (tail or L), L)
            cases += 1
    F = 1024 * MIB // 8
    bits = torch.from_numpy(rng.integers(1, 9, F, np.uint8)).cuda()
    check_offsets(bits, F * 8, 8)
    del bits
    torch.cuda.empty_cache()
    F = 512 * MIB // 128
    widths = [torch.from_numpy(rng.integers(1, 9, F, np.uint8)).cuda()
              for _ in range(20)]
    wants = [k.frame_offsets_ref(b, F * 128, 128) for b in widths]
    for b, want in zip(widths, wants):
        check_offsets(b, F * 128, 128, want)
    return cases + 21


def cycling_stream(rng, frames: int, L: int, period: int,
                   tail: int) -> np.ndarray:
    """Frames whose widths cycle through ``period`` distinct widths, so every
    group of four frames mixes widths; the last frame holds ``tail`` bytes
    (0: a whole frame)."""
    cycle = rng.permutation(8)[:period] + 1
    data = frames_of_widths(rng, np.resize(cycle, frames), L)
    return data[:(frames - 1) * L + tail] if tail else data


def phase_pack_classes(rng) -> int:
    """The pack (general and uniform mode, through check_kernels) on widths
    cycling with periods 3, 5 and 7 and on every width 1..8, at each frame
    length of PACK_LENGTHS and each tail of PACK_TAILS and L-1; then data at
    a 16-byte, frame-aligned offset inside a larger buffer, as a chunk
    walk's slice would be."""
    cases = 0
    for L in PACK_LENGTHS:
        tails = sorted({t % L for t in PACK_TAILS} | {L - 1})
        for period in (3, 5, 7):
            for tail in tails:
                check_kernels(cycling_stream(rng, 67, L, period, tail), L)
                cases += 1
        for b in range(1, 9):
            tail = tails[b % len(tails)]
            check_kernels(uniform_stream(rng, 66 * L + tail, L, b), L)
            cases += 1
    for L in (24, 128):
        for b in (0, 5):
            data = (uniform_stream(rng, MIB + 9, L, b) if b
                    else random_width_stream(rng, MIB + 9, L))
            buf = torch.from_numpy(np.concatenate(
                [np.zeros(16 * L, np.uint8), data])).cuda()
            x = buf[16 * L:]
            bits, _ = k.frame_widths(x, L)
            offs = k.frame_offsets(bits, x.numel(), L)
            vals = k.pack(x, L, bits=bits, offs=offs)
            compare("fl_pack", vals, k.pack_ref(x, L, bits=bits, offs=offs))
            compare("fl_pack", vals, k.pack(x.clone(), L, bits=bits,
                                            offs=offs))
            if b:
                compare("fl_pack_uniform", k.pack(x, L, fb=b), vals)
            cases += 1
    # streams no longer than one frame (the launcher takes a shorter L)
    for L in (1024, 1032):
        for n in (1, 17, 1000, L):
            check_kernels(random_width_stream(rng, n, L), L)
            check_kernels(uniform_stream(rng, n, L, 1 + n % 8), L)
            cases += 2
    # the kernel's 32-bit positions: more than 2^31 bytes must raise
    big = torch.empty(DENSE_MAX_BYTES + 16, dtype=torch.uint8, device=DEVICE)
    try:
        k.pack(big, 128, fb=4)
    except RuntimeError:
        cases += 1
    else:
        raise AssertionError("flrl_pack took more than 2^31 bytes")
    del big
    torch.cuda.empty_cache()
    return cases


def dense_constant(name: str, header: str = "fl_dense.cuh") -> int:
    """A constant of csrc/fl_dense.cuh (or of another header there)."""
    path = os.path.join(REPO, "fl_rl_compression_mpi_tpu_torch", "csrc",
                        header)
    with open(path) as f:
        return int(re.search(rf"{name} = (\d+);", f.read()).group(1))


def check_widths(x: torch.Tensor, L: int, fb: int = 0) -> int:
    """Widths and flag against the plain version; returns the flag."""
    bits, flag = k.frame_widths(x, L, fb_expect=fb)
    want_bits, want_flag = k.frame_widths_ref(x, L, fb_expect=fb)
    compare("fl_frame_widths", bits, want_bits)
    compare("fl_frame_widths", flag, want_flag)
    return int(flag.item())


def check_unpack(values: torch.Tensor, n: int, L: int, want: torch.Tensor,
                 bits=None, offs=None, fb: int = 0) -> None:
    """The unpack against its plain version and the bytes it restores."""
    name = "fl_unpack_uniform" if fb else "fl_unpack"
    out = k.unpack(values, n, L, bits=bits, offs=offs, fb=fb)
    compare(name, out, k.unpack_ref(values, n, L, bits=bits, offs=offs,
                                    fb=fb))
    compare(name, out, want)


def widths_stream(F: int, L: int, fb: int) -> torch.Tensor:
    """F frames of L random bytes on the card, each of width fb (0: random
    widths 1..8), drawn on the card (1 GiB at L = 8 in seconds)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 3)
    widths = (torch.full((F,), fb, dtype=torch.int32, device=DEVICE) if fb
              else torch.randint(1, 9, (F,), dtype=torch.int32,
                                 device=DEVICE, generator=g))
    masks = ((1 << widths) - 1).to(torch.uint8)
    x = torch.randint(0, 256, (F, L), dtype=torch.uint8, device=DEVICE,
                      generator=g) & masks[:, None]
    x[:, 0] = masks
    return x.view(-1)


def phase_widths_unpack_classes(rng) -> int:
    """flrl_frame_widths and flrl_unpack on the classes of their layout.
    Frame counts around a widths step (kWidthsSpans warp spans), a block's
    steps and the resident grid's pass, and byte counts around the unpack's
    two-span step and its pass, at L = 8, 128 (the widths' span path) and
    24, 1024 (a warp a frame), through check_kernels; twenty widths calls
    in a row on reused memory with the flag; the flag on uniform streams
    with one frame of another width first, in the middle and last, at each
    fb_expect 1..8 (and at L = 8, 24, 1024), clean without it; the 1 GiB
    chunk at L = 8 (2^27 frames) in both modes; the unpack of payloads at
    every 16-byte phase inside a larger buffer with values_size exactly the
    payload (both modes, L = 24 and 128), and of streams whose last frame
    holds 1, 7, 8, 9, 15, 16 or 17 bytes; more than 2^31 bytes refused."""
    cases = 0
    warps = (torch.cuda.get_device_properties(DEVICE).multi_processor_count
             * dense_constant("kDenseBlocksPerSm")
             * dense_constant("kDenseWarps"))
    spans = dense_constant("kWidthsSpans")
    for L in (8, 128, 24, 1024):
        U = 16 if L % 16 == 0 else 8
        per_step = spans * 32 * U // L if 32 * U % L == 0 else 1
        frames = {1, per_step - 1, per_step + 1, 8 * per_step + 1,
                  warps * per_step - 1, warps * per_step,
                  warps * per_step + 1, 2 * warps * per_step + 1}
        # the unpack: 2 spans a warp step, a pass of 2 * warps spans
        frames |= {-(-2 * warps * 32 * U // L) + d for d in (-1, 0, 1)}
        for F in sorted(frames - {0}):
            tail = L - 3 if F > 1 else L // 2
            check_kernels(random_width_stream(rng, (F - 1) * L + tail, L), L)
            cases += 1
    x = torch.from_numpy(uniform_stream(rng, 16 * MIB, 128, 4)).cuda()
    xs = [x.clone() for _ in range(20)]
    for i, y in enumerate(xs):
        y[(i * 977_003) % y.numel()] = 200 if i % 2 else 15
    wants = [k.frame_widths_ref(y, 128, fb_expect=4) for y in xs]
    for y, (want_bits, want_flag) in zip(xs, wants):
        bits, flag = k.frame_widths(y, 128, fb_expect=4)
        compare("fl_frame_widths", bits, want_bits)
        compare("fl_frame_widths", flag, want_flag)
        del bits, flag
    cases += 20
    del x, xs, wants
    for L, fbs in ((128, range(1, 9)), (8, (3,)), (24, (3,)), (1024, (3,))):
        for fb in fbs:
            base = uniform_stream(rng, 300 * L + L // 2 + 1, L, fb)
            if check_widths(torch.from_numpy(base).cuda(), L, fb) != 0:
                raise AssertionError(f"widths flag on a uniform stream "
                                     f"(L={L}, fb={fb})")
            w = fb % 8 + 1
            for f in (0, 150, 300):
                d = base.copy()
                frame = d[f * L:(f + 1) * L]
                frame &= (1 << w) - 1
                frame[0] = (1 << w) - 1
                if check_widths(torch.from_numpy(d).cuda(), L, fb) != 1:
                    raise AssertionError(f"widths flag missed frame {f} of "
                                         f"width {w} (L={L}, fb={fb})")
            cases += 4
    F = 1024 * MIB // 8
    for fb in (0, 5):
        x = widths_stream(F, 8, fb)
        check_widths(x, 8, fb)
        if fb:
            check_unpack(k.pack(x, 8, fb=fb), x.numel(), 8, x, fb=fb)
        else:
            bits, _ = k.frame_widths(x, 8)
            offs = k.frame_offsets(bits, x.numel(), 8)
            check_unpack(k.pack(x, 8, bits=bits, offs=offs), x.numel(), 8,
                         x, bits=bits, offs=offs)
            del bits, offs
        del x
        torch.cuda.empty_cache()
        cases += 1
    for L in (24, 128):
        n = 4 * MIB + 77
        x = torch.from_numpy(random_width_stream(rng, n, L)).cuda()
        bits, _ = k.frame_widths(x, L)
        offs = k.frame_offsets(bits, n, L)
        xu = torch.from_numpy(uniform_stream(rng, n, L, 3)).cuda()
        for values, want, mode in (
                (k.pack(x, L, bits=bits, offs=offs), x,
                 dict(bits=bits, offs=offs)),
                (k.pack(xu, L, fb=3), xu, dict(fb=3))):
            for phase in range(16):
                buf = torch.full((values.numel() + 32,), 0xFF,
                                 dtype=torch.uint8, device=DEVICE)
                at = (phase - buf.data_ptr()) % 16
                view = buf[at:at + values.numel()]
                view.copy_(values)
                check_unpack(view, n, L, want, **mode)
                cases += 1
        for tail in (1, 7, 8, 9, 15, 16, 17):
            check_kernels(random_width_stream(rng, 40 * L + tail, L), L)
            check_kernels(uniform_stream(rng, 40 * L + tail, L, tail % 8 + 1),
                          L)
            cases += 2
    big = torch.empty(DENSE_MAX_BYTES + 16, dtype=torch.uint8, device=DEVICE)
    for name, fn in (
            ("flrl_frame_widths", lambda: k.frame_widths(big, 128)),
            ("flrl_unpack", lambda: k.unpack(big[:64], big.numel(), 128,
                                             fb=4))):
        try:
            fn()
        except RuntimeError:
            cases += 1
        else:
            raise AssertionError(f"{name} took more than 2^31 bytes")
    del big
    torch.cuda.empty_cache()
    return cases


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


def launch_ms(fn, runs: int = RUN) -> float:
    """Milliseconds a call of fn() over ``runs`` calls in a row between one
    event pair, after one warm-up.  A device sleep queued ahead of the run
    lets the host enqueue it before the card starts, so the run measures
    the card's work, unless fn() itself waits on the card."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def kernel_ms(name: str, fn) -> float:
    """The single-call median of a kernel's wrapper (cuda_ms); its time a
    launch over a run goes to LAUNCH_MS[name]."""
    LAUNCH_MS[name] = launch_ms(fn)
    return cuda_ms(fn)


def library_ms(name: str, fn) -> None:
    """Both times of the PyTorch call that computes ``name``'s function."""
    LIBRARY_LAUNCH_MS[name] = launch_ms(fn)
    LIBRARY_MS[name] = cuda_ms(fn)


def moved(name: str, *tensors: torch.Tensor) -> None:
    """Record the bytes of ``name``'s timed call: its inputs and outputs."""
    MOVED[name] = sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(name: str) -> float:
    """The least time the card could take for ``name``'s timed call: its
    bytes over the card's memory rate (every kernel here does a few integer
    operations a byte, far below the card's operation rate)."""
    return MOVED[name] / HBM_BYTES_PER_S * 1e3


def time_mixed_parts(x: torch.Tensor) -> None:
    """flrl_frame_widths (fb_expect 4, as on the whole stream) and the
    general flrl_unpack on each part of the mixed stream alone, a launch
    over a run of RUN calls, beside each part's bound: where the time of
    the whole goes."""
    L = 128
    at = 0
    for i, (name, mib) in enumerate(MIXED_PARTS):
        xp = x[at:at + mib * MIB]
        at += mib * MIB
        n = xp.numel()
        bits, _ = k.frame_widths(xp, L)
        offs = k.frame_offsets(bits, n, L)
        vals = k.pack(xp, L, bits=bits, offs=offs)
        widths = launch_ms(lambda: k.frame_widths(xp, L, fb_expect=4))
        unpack = launch_ms(lambda: k.unpack(vals, n, L, bits=bits, offs=offs))
        moved_w = n + bits.numel()
        moved_u = vals.numel() + bits.numel() + 8 * offs.numel() + n
        say(f"[kernels] mixed part {i} ({name}, {mib} MiB, {vals.numel()} "
            f"payload bytes): fl_frame_widths {widths:.4f} ms (bound "
            f"{moved_w / HBM_BYTES_PER_S * 1e3:.4f}), fl_unpack "
            f"{unpack:.4f} ms (bound {moved_u / HBM_BYTES_PER_S * 1e3:.4f}) "
            f"a launch over a run of {RUN}")
        del bits, offs, vals


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
        kernel_ms("fl_frame_widths",
                  lambda: k.frame_widths(x, L, fb_expect=4)),
        cuda_ms(lambda: k.frame_widths_ref(x, L, fb_expect=4)))
    timings["fl_frame_offsets"] = (
        kernel_ms("fl_frame_offsets", lambda: k.frame_offsets(bits, n, L)),
        cuda_ms(lambda: k.frame_offsets_ref(bits, n, L)))
    timings["fl_pack"] = (
        kernel_ms("fl_pack", lambda: k.pack(x, L, bits=bits, offs=offs)),
        cuda_ms(lambda: k.pack_ref(x, L, bits=bits, offs=offs)))
    timings["fl_unpack"] = (
        kernel_ms("fl_unpack",
                  lambda: k.unpack(vals, n, L, bits=bits, offs=offs)),
        cuda_ms(lambda: k.unpack_ref(vals, n, L, bits=bits, offs=offs)))
    moved("fl_frame_widths", x, bits)
    moved("fl_frame_offsets", bits, offs)
    moved("fl_pack", x, bits, offs, vals)
    moved("fl_unpack", vals, bits, offs, x)
    library_ms("fl_frame_offsets",
               lambda: torch.cumsum(bits, 0, dtype=torch.int64))
    rows = x.view(-1, L)
    say(f"[kernels] yardstick torch.amax(x.view(-1, {L}), dim=1) on the "
        f"mixed stream (the frames' max, not their width): "
        f"{cuda_ms(lambda: torch.amax(rows, dim=1)):.3f} ms single "
        f"(median of 5), {launch_ms(lambda: torch.amax(rows, dim=1)):.4f} "
        f"ms a launch over a run of {RUN}")
    time_mixed_parts(x)
    del x, bits, offs, vals, rows
    x = torch.from_numpy(uniform4).cuda()
    n = x.numel()
    vu = k.pack(x, L, fb=4)
    compare("fl_pack_uniform", vu, k.pack_ref(x, L, fb=4))
    compare("fl_unpack_uniform", k.unpack(vu, n, L, fb=4),
            k.unpack_ref(vu, n, L, fb=4))
    timings["fl_pack_uniform"] = (
        kernel_ms("fl_pack_uniform", lambda: k.pack(x, L, fb=4)),
        cuda_ms(lambda: k.pack_ref(x, L, fb=4)))
    timings["fl_unpack_uniform"] = (
        kernel_ms("fl_unpack_uniform", lambda: k.unpack(vu, n, L, fb=4)),
        cuda_ms(lambda: k.unpack_ref(vu, n, L, fb=4)))
    moved("fl_pack_uniform", x, vu)
    moved("fl_unpack_uniform", vu, x)
    del x, vu
    torch.cuda.empty_cache()
    return timings


# ---------------------------------------------------------------------------
# FL field route
# ---------------------------------------------------------------------------

def staged_words(data: np.ndarray, unit: int) -> torch.Tensor:
    """``data`` on the card, zero-padded to a multiple of ``unit`` bytes,
    as int32 words (the field encoders carry no tail mask)."""
    n = data.size
    x = torch.from_numpy(data).cuda()
    buf = torch.zeros(-(-n // unit) * unit, dtype=torch.uint8,
                      device=x.device)
    buf[:n] = x
    return buf.view(torch.int32)


def check_fields(data: np.ndarray, L: int, tile_r: int = 0):
    """The field kernels of one mode against their plain versions on one
    stream, the round trip, and the container the native host fold makes
    of the kernel's fields against fl-cpu's.  Returns the kernels' outputs
    (words, bits, fields)."""
    n = data.size
    frames = -(-n // L)
    wpf = L // 4
    enc = "fl_fields_encode_p2" if tile_r else "fl_fields_encode"
    dec = "fl_fields_decode_p2" if tile_r else "fl_fields_decode"
    words = staged_words(data, tile_r * 512 if tile_r else L)
    bits, out = fk.encode_fields(words, L, tile_r)
    want_bits, want_out = fk.encode_fields_ref(words, L, tile_r)
    compare(enc, bits, want_bits)
    compare(enc, out, want_out)
    back = fk.decode_fields(out, bits, L, tile_r)
    compare(dec, back, fk.decode_fields_ref(out, bits, L, tile_r))
    compare(dec, back.view(torch.uint8)[:n], words.view(torch.uint8)[:n])
    bits_h = bits[:frames].cpu().numpy()
    if tile_r:
        if int(bits_h.max()) > 4:
            raise AssertionError("pack-2 case with a width above 4")
        need = fk.packed_words(frames * wpf, tile_r)
        values = fields.fold_p2(out[:need].cpu().numpy().view(np.uint32),
                                bits_h, n, L, tile_r)
    else:
        values = fields.fold(out[:frames * wpf].cpu().numpy().view(np.uint32),
                             bits_h, n, L)
    ref = CODECS["fl-cpu"].compress(data, frame_length=L)
    if not (np.array_equal(bits_h, ref.bits)
            and np.array_equal(values, ref.values)):
        raise AssertionError(f"field kernels + host fold differ from fl-cpu "
                             f"(L={L}, tile_r={tile_r})")
    return words, bits, out


def phase_field_kernels(rng) -> int:
    cases = 0
    for L in (8, 24, 64, 128, 512, 1024):
        tails = (0, 1, 77 % L, L - 1)
        for b in range(1, 9):
            check_fields(uniform_stream(rng, MIB + tails[b % 4], L, b), L)
            cases += 1
        for tail in tails:
            check_fields(random_width_stream(rng, 2 * MIB + tail, L), L)
            cases += 1
        if 128 % (L // 4):
            continue
        for tile_r in (16, fl_torch.PACK_TILE_R):
            for tail in (tails[2], tails[3]):
                check_fields(random_width_stream(rng, 3 * MIB + tail, L, 4),
                             L, tile_r)
            check_fields(uniform_stream(rng, MIB + tails[1], L, 4), L, tile_r)
            cases += 3
    check_fields(random_width_stream(rng, 64 * MIB, 128), 128)
    return cases + 1


def time_field_kernels(mixed: np.ndarray, uniform4: np.ndarray) -> dict:
    """Field kernel and plain times on the 512 MiB streams, after one more
    comparison at that shape: base mode on mixed, pack-2 on uniform4."""
    L, tr = 128, fl_torch.PACK_TILE_R
    timings = {}
    words, bits, out = check_fields(mixed, L)
    timings["fl_fields_encode"] = (
        kernel_ms("fl_fields_encode", lambda: fk.encode_fields(words, L)),
        cuda_ms(lambda: fk.encode_fields_ref(words, L)))
    timings["fl_fields_decode"] = (
        kernel_ms("fl_fields_decode", lambda: fk.decode_fields(out, bits, L)),
        cuda_ms(lambda: fk.decode_fields_ref(out, bits, L)))
    moved("fl_fields_encode", words, bits, out)
    moved("fl_fields_decode", out, bits, words)
    del words, bits, out
    check_fields(uniform4, L)
    words, bits, out = check_fields(uniform4, L, tr)
    timings["fl_fields_encode_p2"] = (
        kernel_ms("fl_fields_encode_p2",
                  lambda: fk.encode_fields(words, L, tr)),
        cuda_ms(lambda: fk.encode_fields_ref(words, L, tr)))
    timings["fl_fields_decode_p2"] = (
        kernel_ms("fl_fields_decode_p2",
                  lambda: fk.decode_fields(out, bits, L, tr)),
        cuda_ms(lambda: fk.decode_fields_ref(out, bits, L, tr)))
    moved("fl_fields_encode_p2", words, bits, out)
    moved("fl_fields_decode_p2", out, bits, words)
    del words, bits, out
    time_fields_parts(staged_words(mixed, L))
    torch.cuda.empty_cache()
    return timings


def time_fields_parts(words: torch.Tensor) -> None:
    """The field encode and decode in both modes on each part of the mixed
    stream alone, a launch over a run of RUN calls, beside each part's
    bound (the part's bytes, its fields: all of them in base mode, half in
    pack-2, and its widths)."""
    L, tr = 128, fl_torch.PACK_TILE_R
    at = 0
    for i, (name, mib) in enumerate(MIXED_PARTS):
        wp = words[at // 4:(at + mib * MIB) // 4]
        at += mib * MIB
        n = 4 * wp.numel()
        base = launch_ms(lambda: fk.encode_fields(wp, L))
        pack2 = launch_ms(lambda: fk.encode_fields(wp, L, tr))
        say(f"[kernels] mixed part {i} ({name}, {mib} MiB): fl_fields_encode "
            f"{base:.4f} ms (bound "
            f"{(2 * n + n // L) / HBM_BYTES_PER_S * 1e3:.4f}), "
            f"fl_fields_encode_p2 {pack2:.4f} ms (bound "
            f"{(n + n // 2 + n // L) / HBM_BYTES_PER_S * 1e3:.4f}) a launch "
            f"over a run of {RUN}")
        bits, fields_b = fk.encode_fields(wp, L)
        _, slots = fk.encode_fields(wp, L, tr)
        compare("fl_fields_decode", fk.decode_fields(fields_b, bits, L), wp)
        # the parts with widths above 4 have no valid pack-2 layout: their
        # pack-2 decode is timed only, not round-tripped
        base = launch_ms(lambda: fk.decode_fields(fields_b, bits, L))
        pack2 = launch_ms(lambda: fk.decode_fields(slots, bits, L, tr))
        say(f"[kernels] mixed part {i} ({name}, {mib} MiB): fl_fields_decode "
            f"{base:.4f} ms (bound "
            f"{(2 * n + n // L) / HBM_BYTES_PER_S * 1e3:.4f}), "
            f"fl_fields_decode_p2 {pack2:.4f} ms (bound "
            f"{(n // 2 + n + n // L) / HBM_BYTES_PER_S * 1e3:.4f}) a launch "
            f"over a run of {RUN}")
        del bits, fields_b, slots


def check_encode_fields(words: torch.Tensor, L: int, tile_r: int = 0) -> None:
    """The field encode of one mode against its plain version alone (any
    widths: pack-2 keeps each field's low 16 bits, as the twin does)."""
    name = "fl_fields_encode_p2" if tile_r else "fl_fields_encode"
    bits, out = fk.encode_fields(words, L, tile_r)
    want_bits, want_out = fk.encode_fields_ref(words, L, tile_r)
    compare(name, bits, want_bits)
    compare(name, out, want_out)


def phase_fields_encode_classes(rng) -> int:
    """flrl_fields_encode on the classes of its layout (drawn from a
    generator of their own).  Frame counts around a base-mode warp step
    (kFieldsStep bytes), a block's steps and the resident grid's pass at
    L = 8, 24, 128, 512, 1024 (24 and 1024: a warp a frame), through
    check_fields; packed rows around a block and a pass in pack-2 mode at
    L = 8, 128, 512; the pack-2 tiles at tile_r 16 and 2048 with one frame
    of width 5 in the last tile (against the twin: no container); every
    uniform width at L = 128 in both modes; 1 GiB at L = 128 in both modes;
    more than 2^31 bytes refused."""
    cases = 0
    warps = (torch.cuda.get_device_properties(DEVICE).multi_processor_count
             * dense_constant("kDenseBlocksPerSm")
             * dense_constant("kDenseWarps"))
    step = dense_constant("kFieldsStep", "fl_fields.cuh")
    for L in (8, 24, 128, 512, 1024):
        U = 16 if L % 16 == 0 else 8
        per_step = step // L if 32 * U % L == 0 else 1
        frames = {1, per_step - 1, per_step + 1, 8 * per_step + 1,
                  warps * per_step - 1, warps * per_step,
                  warps * per_step + 1, 2 * warps * per_step + 1}
        for F in sorted(frames - {0}):
            check_fields(random_width_stream(rng, F * L, L), L)
            cases += 1
    # pack-2: a warp step is one packed row (512 bytes out, 1 KiB in)
    for L in (8, 128, 512):
        for rows in (8, warps - 8, warps + 8, 2 * warps + 24):
            tr = 16
            n = -(-rows * 1024 // (tr * 512)) * tr * 512
            check_fields(random_width_stream(rng, n - L // 2, L, 4), L, tr)
            cases += 1
    for L in (8, 16, 32, 64, 128, 256, 512):
        for tr in (16, fl_torch.PACK_TILE_R):
            data = random_width_stream(rng, 3 * tr * 512, L, 4)
            data[-L - 3] = 17                # width 5, in the last tile
            words = staged_words(data, tr * 512)
            check_encode_fields(words, L, tr)
            check_encode_fields(words, L)
            cases += 1
    for b in range(1, 9):
        data = uniform_stream(rng, 3 * MIB + 128 * b, 128, b)
        check_fields(data, 128)
        if b <= 4:
            check_fields(data, 128, fl_torch.PACK_TILE_R)
        else:
            check_encode_fields(staged_words(data, fl_torch.PACK_TILE_R * 512),
                                128, fl_torch.PACK_TILE_R)
        cases += 1
    words = widths_stream(1024 * MIB // 128, 128, 0).view(torch.int32)
    check_encode_fields(words, 128)
    check_encode_fields(words, 128, fl_torch.PACK_TILE_R)
    del words
    torch.cuda.empty_cache()
    cases += 1
    # the kernel's 32-bit positions: more than 2^31 bytes must raise
    big = torch.empty((DENSE_MAX_BYTES + 512) // 4, dtype=torch.int32,
                      device=DEVICE)
    try:
        fk.encode_fields(big, 128)
    except RuntimeError:
        cases += 1
    else:
        raise AssertionError("flrl_fields_encode took more than 2^31 bytes")
    del big
    torch.cuda.empty_cache()
    return cases


def check_decode(words: torch.Tensor, L: int, tile_r: int,
                 frames: int) -> None:
    """The field decode of the first ``frames`` frames of ``words`` (whole
    tiles in pack-2 mode, every width ≤ 4 there) against its plain version
    and the words, from the kernel's fields: the field route's last chunk
    ends mid-tile the same way."""
    name = "fl_fields_decode_p2" if tile_r else "fl_fields_decode"
    nw = frames * (L // 4)
    bits, out = fk.encode_fields(words, L, tile_r)
    bits = bits[:frames]
    fields = out[:fk.packed_words(nw, tile_r) if tile_r else nw]
    back = fk.decode_fields(fields, bits, L, tile_r)
    compare(name, back, fk.decode_fields_ref(fields, bits, L, tile_r))
    compare(name, back, words[:nw])


def phase_fields_decode_classes(rng) -> int:
    """flrl_fields_decode on the classes of its layout (drawn from a
    generator of their own).  Frame counts around a base-mode warp step
    (kFieldsStep bytes), a block's steps and the resident grid's pass at
    L = 8, 24, 128, 512, 1024, through check_fields; pack-2 at L = 8, 128,
    512 and tile_r 16 and 2048 where nw ends in the first half of the last
    tile, mid-row in either half and (L = 8) mid-group; every uniform width
    at L = 128 (pack-2 for widths ≤ 4); twenty calls in a row on reused
    output memory; 1 GiB at L = 128 in both modes; more than 2^31 bytes
    and a misaligned ``fields`` view refused."""
    cases = 0
    warps = (torch.cuda.get_device_properties(DEVICE).multi_processor_count
             * dense_constant("kDenseBlocksPerSm")
             * dense_constant("kDenseWarps"))
    step = dense_constant("kFieldsStep", "fl_fields.cuh")
    for L in (8, 24, 128, 512, 1024):
        per_step = max(1, step // L)
        frames = {1, per_step - 1, per_step + 1, 8 * per_step + 1,
                  warps * per_step - 1, warps * per_step + 1,
                  2 * warps * per_step + 3}
        for F in sorted(frames - {0}):
            check_fields(random_width_stream(rng, F * L, L), L)
            cases += 1
    for L in (8, 128, 512):
        wpf = L // 4
        for tr in (16, fl_torch.PACK_TILE_R):
            tw = tr * 128
            words = staged_words(random_width_stream(rng, 3 * tw * 4, L, 4),
                                 tr * 512)
            ends = [2 * tw + tw // 2 - 3 * 128,     # first half, row end
                    2 * tw + 5 * 128 + 64,          # mid-row, first half
                    2 * tw + tw // 2 + 128 + 96]    # mid-row, second half
            if L == 8:
                ends.append(2 * tw + 7 * 128 + 42)  # mid-group
            for nw in ends:
                check_decode(words, L, tr, nw // wpf)
                cases += 1
    for b in range(1, 9):
        data = uniform_stream(rng, 3 * MIB + 128 * b, 128, b)
        check_fields(data, 128)
        if b <= 4:
            check_decode(staged_words(data, fl_torch.PACK_TILE_R * 512), 128,
                         fl_torch.PACK_TILE_R, -(-data.size // 128))
        cases += 1
    # the allocator hands each call the block the last one freed
    words = staged_words(random_width_stream(rng, 8 * MIB, 128, 4), MIB)
    for tr in (0, fl_torch.PACK_TILE_R):
        bits, out = fk.encode_fields(words, 128, tr)
        for _ in range(20):
            back = fk.decode_fields(out, bits, 128, tr)
            compare("fl_fields_decode_p2" if tr else "fl_fields_decode",
                    back, words)
            del back
        cases += 1
    del words, bits, out
    for fb, tr in ((0, 0), (4, fl_torch.PACK_TILE_R)):
        words = widths_stream(1024 * MIB // 128, 128, fb).view(torch.int32)
        check_decode(words, 128, tr, words.numel() // 32)
        del words
        torch.cuda.empty_cache()
        cases += 1
    # the kernel's 32-bit positions: more than 2^31 bytes out must raise
    F = DENSE_MAX_BYTES // 128 + 1
    big = torch.empty(F * 32, dtype=torch.int32, device=DEVICE)
    bits = torch.ones(F, dtype=torch.uint8, device=DEVICE)
    try:
        fk.decode_fields(big, bits, 128)
    except RuntimeError:
        cases += 1
    else:
        raise AssertionError("flrl_fields_decode took more than 2^31 bytes")
    del big, bits
    torch.cuda.empty_cache()
    buf = torch.zeros(4 * 128 + 4, dtype=torch.int32, device=DEVICE)
    bits = torch.ones(16, dtype=torch.uint8, device=DEVICE)
    try:
        fk.decode_fields(buf[1:1 + 4 * 128], bits, 128)
    except ValueError:
        cases += 1
    else:
        raise AssertionError("flrl_fields_decode took a misaligned view")
    return cases


# ---------------------------------------------------------------------------
# FL constant-stream kernels (#5/#6)
# ---------------------------------------------------------------------------

def check_constant(data: np.ndarray, c: int, offset: int = 0) -> tuple:
    """Both constant kernels against their plain versions on one stream
    (from ``offset`` bytes into a card buffer, so unaligned starts too):
    outputs and flags equal; on a clean stream the payload is fl-cpu's and
    the decode restores it; a pad byte past values_size is not read.
    Returns the kernels' (bits, values, flag)."""
    fb = max(1, c.bit_length())
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.uint8),
                                           data])).cuda()
    x = buf[offset:]
    got = ck.encode_constant(x, c, fb)
    for out, want in zip(got, ck.encode_constant_ref(x, c, fb)):
        compare("fl_const_encode", out, want)
    bits, values, flag = got
    vsz = values.numel()
    pad = torch.full((vsz + 8 + offset,), 0xA5, dtype=torch.uint8,
                     device=x.device)
    v = pad[offset:]
    v[:vsz] = values
    dec = ck.decode_constant(v, vsz, c, fb, x.numel())
    for out, want in zip(dec, ck.decode_constant_ref(v, vsz, c, fb,
                                                     x.numel())):
        compare("fl_const_decode", out, want)
    if int(flag) == 0:
        compare("fl_const_decode", dec[0], x)
        if int(dec[1]) != 0:
            raise AssertionError(f"c={c}: decode flag on a clean payload")
        ref = CODECS["fl-cpu"].compress(data)
        if not (np.array_equal(bits.cpu().numpy(), ref.bits)
                and np.array_equal(values.cpu().numpy(), ref.values)):
            raise AssertionError(f"c={c}, n={data.size}: constant kernel "
                                 "container differs from fl-cpu")
    return got


def phase_constant_kernels() -> int:
    """Every class: c in {0, 1, 3, 15, 255} with n % 128 == 0, c = 0 with
    tails {1, 77, 127}, unaligned starts; the encode flag on a flipped
    first, middle and last byte; the decode flag on a flipped first,
    middle and last payload byte (the straddling tail word's real bytes)
    and not on its pad; 64 MiB streams of 0x00 and 0x0F."""
    cases = 0
    classes = ([(c, MIB) for c in (0, 1, 3, 15, 255)]
               + [(0, MIB + t) for t in (1, 77, 127)])
    for c, n in classes:
        data = np.full(n, c, np.uint8)
        for offset in (0, 1, 13):
            check_constant(data, c, offset)
            cases += 1
        for pos in (0, n // 2, n - 1):
            bad = data.copy()
            bad[pos] ^= 0x40
            if int(check_constant(bad, c)[2]) != 1:
                raise AssertionError(f"c={c}: encode flag missed byte {pos}")
            cases += 1
        fb = max(1, c.bit_length())
        values = ck.encode_constant(torch.from_numpy(data).cuda(), c, fb)[1]
        vsz = values.numel()
        for pos in (0, vsz // 2, vsz - 1):
            bad = values.clone()
            bad[pos] ^= 0x10
            got = ck.decode_constant(bad, vsz, c, fb, n)
            compare("fl_const_decode", got[1],
                    ck.decode_constant_ref(bad, vsz, c, fb, n)[1])
            if int(got[1]) != 1:
                raise AssertionError(f"c={c}: decode flag missed payload "
                                     f"byte {pos}")
            cases += 1
    for c in (0, 15):
        check_constant(np.full(64 * MIB, c, np.uint8), c)
        cases += 1
    return cases


def time_constant_kernels() -> dict:
    """Kernel and plain times on 512 MiB of zeros (width 1), after one
    more comparison at that shape, and a check on 512 MiB of 0x0F."""
    n = 512 * MIB
    check_constant(np.full(n, 15, np.uint8), 15)
    x = torch.zeros(n, dtype=torch.uint8, device=DEVICE)
    bits, values, _ = ck.encode_constant(x, 0, 1)
    for out, want in zip((bits, values), ck.encode_constant_ref(x, 0, 1)):
        compare("fl_const_encode", out, want)
    timings = {
        "fl_const_encode": (
            kernel_ms("fl_const_encode",
                      lambda: ck.encode_constant(x, 0, 1)),
            cuda_ms(lambda: ck.encode_constant_ref(x, 0, 1))),
        "fl_const_decode": (
            kernel_ms("fl_const_decode",
                      lambda: ck.decode_constant(values, values.numel(), 0,
                                                 1, n)),
            cuda_ms(lambda: ck.decode_constant_ref(values, values.numel(), 0,
                                                   1, n))),
    }
    moved("fl_const_encode", x, bits, values)
    moved("fl_const_decode", values, x)
    del x, bits, values
    torch.cuda.empty_cache()
    return timings


def run_cli(*argv: str) -> None:
    rc = cli.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")


def same_file(a: str, b: str) -> bool:
    return np.array_equal(np.fromfile(a, np.uint8), np.fromfile(b, np.uint8))


@contextlib.contextmanager
def field_route():
    """The FL field route, as an operator selects it: FLRL_NO_DENSE=1, read
    by fl_torch at each call and inherited by subprocesses."""
    saved = os.environ.get("FLRL_NO_DENSE")
    os.environ["FLRL_NO_DENSE"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("FLRL_NO_DENSE", None)
        else:
            os.environ["FLRL_NO_DENSE"] = saved


def reset_fl_launches() -> None:
    k.reset_launches()
    fk.reset_launches()


def check_route(launches: dict, route: str, where: str) -> None:
    """On the dense route only dense FL kernels ran, on the field route
    only field kernels."""
    dense = {n: launches[n] for n in REPLACES}
    field = {n: launches[n] for n in FIELDS_REPLACES}
    ran, idle = (field, dense) if route == "fields" else (dense, field)
    if not any(ran.values()) or any(idle.values()):
        raise AssertionError(f"{where}: the {route} route launched "
                             f"{json.dumps(launches)}")


def subprocess_launches(argv: list) -> dict:
    """Run the CLI as a user does, ``python -m`` with ``--timers``, and
    return the launch counts it reports."""
    proc = subprocess.run(
        [sys.executable, "-m", "fl_rl_compression_mpi_tpu_torch", *argv,
         "--timers"], cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"python -m ... {' '.join(argv)} failed: "
                             f"{proc.stderr}")
    tag = "[INFO] kernel launches "
    for line in proc.stderr.splitlines():
        if line.startswith(tag):
            return json.loads(line[len(tag):])
    raise AssertionError(f"python -m ... {' '.join(argv)}: no launch counts")


def phase_goldens(tmp: str, route: str) -> None:
    fl_cpu = CODECS["fl-cpu"]
    bins = sorted(glob.glob(os.path.join(GOLDEN, "case_*.bin")))
    for src in bins:
        out = os.path.join(tmp, "g.fl")
        run_cli("c", "fl", src, out)
        if not same_file(out, src[:-4] + ".fl"):
            raise AssertionError(f"{route}: c fl {os.path.basename(src)} "
                                 "differs from the reference container")
    fls = sorted(glob.glob(os.path.join(GOLDEN, "*.fl")))
    for comp_path in fls:
        out = os.path.join(tmp, "g.bin")
        run_cli("d", "fl", comp_path, out)
        want = fl_cpu.decompress(load_fl(comp_path))
        if not np.array_equal(np.fromfile(out, np.uint8), want):
            raise AssertionError(f"{route}: d fl {os.path.basename(comp_path)}"
                                 " differs from the fl-cpu decode")
    # the module entry point, as a user runs it (it inherits the route's
    # environment variables)
    src = bins[-1]
    out = os.path.join(tmp, "m.fl")
    launches = subprocess_launches(["c", "fl", src, out, "--verify"])
    if not same_file(out, src[:-4] + ".fl"):
        raise AssertionError(f"{route}: python -m ... c fl differs from the "
                             "reference container")
    check_route(launches, route, f"python -m ... c fl {os.path.basename(src)}")
    say(f"[goldens] {route} route: {len(bins)} reference containers "
        f"reproduced, {len(fls)} decoded like fl-cpu, python -m entry OK")


def phase_main(tmp: str, streams: dict) -> dict:
    """The main path through the CLI; returns the kernels' launch counts."""
    fl_cpu = CODECS["fl-cpu"]
    paths = {}
    for name, data in streams.items():
        paths[name] = os.path.join(tmp, f"{name}.bin")
        data.tofile(paths[name])
    reset_fl_launches()
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
    check_route({**launches, **fk.LAUNCHES}, "dense", "main")
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


def phase_fields_main(tmp: str, streams: dict) -> dict:
    """The field route through the CLI on the main phase's files, whose
    dense-route containers it must reproduce; returns the field kernels'
    launch counts."""
    fl_cpu = CODECS["fl-cpu"]
    walls = {}
    with field_route():
        reset_fl_launches()
        for name in streams:
            src = os.path.join(tmp, f"{name}.bin")
            t0 = time.perf_counter()
            run_cli("c", "fl", src, os.path.join(tmp, f"{name}.f.fl"),
                    "--verify", "--timers")
            t1 = time.perf_counter()
            run_cli("d", "fl", os.path.join(tmp, f"{name}.f.fl"),
                    os.path.join(tmp, f"{name}.f.out"), "--timers")
            walls[name] = (t1 - t0, time.perf_counter() - t1)
        launches = {**k.LAUNCHES, **fk.LAUNCHES}
    check_route(launches, "fields", "fields main")
    for name, (tc, td) in walls.items():
        src = os.path.join(tmp, f"{name}.bin")
        comp_path = os.path.join(tmp, f"{name}.f.fl")
        if not same_file(os.path.join(tmp, f"{name}.f.out"), src):
            raise AssertionError(f"{name}: field route d fl did not restore "
                                 "the input")
        if not same_file(comp_path, os.path.join(tmp, f"{name}.fl")):
            raise AssertionError(f"{name}: field route container differs "
                                 "from the dense route's")
        comp, ref = load_fl(comp_path), fl_cpu.compress(np.fromfile(src,
                                                                    np.uint8))
        if not (np.array_equal(comp.bits, ref.bits)
                and np.array_equal(comp.values, ref.values)):
            raise AssertionError(f"{name}: field route container differs "
                                 "from fl-cpu")
        say(f"[fields] {name}: c fl --verify {tc:.3f} s, d fl {td:.3f} s "
            f"(wall, host clock); container equals fl-cpu's and the dense "
            f"route's")
    say(f"[fields] kernel launches {json.dumps(launches)}")
    missing = [n for n in FIELDS_REPLACES if launches[n] == 0]
    if missing:
        raise AssertionError(f"field kernels not launched on the field "
                             f"route: {missing}")
    return {n: launches[n] for n in FIELDS_REPLACES}


def phase_fields_variants(tmp: str, rng) -> None:
    """An L = 1024 run on a 64 MiB width <= 4 stream (no pack-2 layout at
    256 words a frame: the base kernels only), and an L = 64 run on a 64 MiB
    width <= 4 stream through ``python -m`` (pack-2 at 16 words a frame);
    both against fl-cpu and the dense route."""
    fl_cpu = CODECS["fl-cpu"]
    cases = (("L1024", random_width_stream(rng, 64 * MIB + 77, 1024, 4), 1024),
             ("L64", random_width_stream(rng, 64 * MIB + 77, 64, 4), 64))
    for name, data, L in cases:
        src = os.path.join(tmp, f"{name}.bin")
        comp_path = os.path.join(tmp, f"{name}.fl")
        back = os.path.join(tmp, f"{name}.out")
        data.tofile(src)
        argv_c = ["c", "fl", src, comp_path, "--verify", "--frame-length",
                  str(L)]
        argv_d = ["d", "fl", comp_path, back, "--frame-length", str(L)]
        if name == "L1024":
            with field_route():
                reset_fl_launches()
                run_cli(*argv_c)
                run_cli(*argv_d)
                launches = {**k.LAUNCHES, **fk.LAUNCHES}
            if (launches["fl_fields_encode_p2"] or launches["fl_fields_decode_p2"]
                    or not launches["fl_fields_encode"]
                    or not launches["fl_fields_decode"]):
                raise AssertionError(f"L = 1024 launched "
                                     f"{json.dumps(launches)}")
        else:
            with field_route():
                launches = subprocess_launches(argv_c)
                for key, v in subprocess_launches(argv_d).items():
                    launches[key] += v
            if not (launches["fl_fields_encode_p2"]
                    and launches["fl_fields_decode_p2"]):
                raise AssertionError(f"L = 64 width <= 4 stream did not take "
                                     f"pack-2: {json.dumps(launches)}")
        check_route(launches, "fields", name)
        if not same_file(back, src):
            raise AssertionError(f"{name}: d fl did not restore the input")
        comp = load_fl(comp_path)
        ref = fl_cpu.compress(data, frame_length=L)
        dense = compress(data, method="fl", frame_length=L)
        if not all(np.array_equal(a, b) for a, b in (
                (comp.bits, ref.bits), (comp.values, ref.values),
                (dense.bits, ref.bits), (dense.values, ref.values))):
            raise AssertionError(f"{name}: field route container differs "
                                 "from fl-cpu's or the dense route's")
        say(f"[fields] {name} (L = {L}, {data.size} bytes): container equals "
            f"fl-cpu's and the dense route's, round trip exact; launches "
            f"{json.dumps({n: launches[n] for n in FIELDS_REPLACES})}")


def phase_fields_chunks(rng) -> None:
    """The API's field route across a 256 MiB cap: a width <= 4 chunk (a
    pack-2 hit), a mixed one (a miss), and a 4,173-byte tail."""
    cap = 256 * MIB
    data = np.concatenate([random_width_stream(rng, cap, 128, 4),
                           random_width_stream(rng, cap, 128),
                           random_width_stream(rng, 4096 + 77, 128, 4)])
    saved = fl_torch.MAX_DEVICE_CHUNK
    fl_torch.MAX_DEVICE_CHUNK = cap
    try:
        with field_route():
            reset_fl_launches()
            t0 = time.perf_counter()
            comp = compress(data, method="fl")
            t1 = time.perf_counter()
            back = decompress(comp, method="fl")
            t2 = time.perf_counter()
            launches = {**k.LAUNCHES, **fk.LAUNCHES}
    finally:
        fl_torch.MAX_DEVICE_CHUNK = saved
    check_route(launches, "fields", "field chunk walk")
    want = {"fl_fields_encode_p2": 3, "fl_fields_encode": 1,
            "fl_fields_decode_p2": 2, "fl_fields_decode": 1}
    if {n: launches[n] for n in want} != want:
        raise AssertionError(f"field chunk walk launched "
                             f"{json.dumps(launches)}, expected {want}")
    ref = CODECS["fl-cpu"].compress(data)
    if not (np.array_equal(comp.bits, ref.bits)
            and np.array_equal(comp.values, ref.values)):
        raise AssertionError("field chunk walk: container differs from "
                             "fl-cpu")
    if not np.array_equal(back, data):
        raise AssertionError("field chunk walk: decode did not restore the "
                             "input")
    say(f"[chunks] fields: {data.size} bytes in 3 chunks (pack-2 hit, miss, "
        f"hit): container equals fl-cpu, round trip exact; encode "
        f"{t1 - t0:.3f} s, decode {t2 - t1:.3f} s")


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


def check_rl_encode(x: torch.Tensor, prev: int = -1, d0: int = 0,
                    want: tuple | None = None) -> dict:
    """The encode kernel on one chunk against its plain version (``want``,
    if the caller has it); returns its outputs."""
    values, counts, run_start = rk.encode_chunk(x, prev, d0)
    want_v, want_c, want_s = (rk.encode_chunk_ref(x, prev, d0)
                              if want is None else want)
    compare("rl_encode", values, want_v)
    compare("rl_encode", counts, want_c)
    if run_start != want_s:
        raise AssertionError(f"rl_encode: run start {run_start} != "
                             f"{want_s} (prev {prev}, d0 {d0})")
    return {"values": values, "counts": counts, "run_start": run_start}


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


def phase_rl_kernels(rng, classes_rng) -> int:
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
    cases = len(cases)
    # chunk carries: byte 0 continues a run of 5 mid-piece, at a cap
    # boundary, and starts a new value; d0 only counts mod 255
    data = np.concatenate([np.full(600, 5, np.uint8),
                           runs_stream(rng, 3 * MIB, 1, 600, 256)])
    x = torch.from_numpy(data).cuda()
    for prev, d0 in ((5, 100), (5, 255), (5, 510), (6, 40), (5, 254),
                     (5, 256), (5, 2**31 + 7)):
        check_rl_encode(x, prev, d0)
        check_rl_encode(x[:600], prev, d0)   # no natural start: -d0 back
        cases += 2
    # zero counts (a corrupt but loadable container) take no output
    counts = rng.integers(0, 256, 4 * MIB).astype(np.uint8)
    counts[::3] = 0
    counts[-1] = 0
    values = rng.integers(0, 256, counts.size, np.uint8)
    _, out = check_rl_decode(torch.from_numpy(counts).cuda(),
                             torch.from_numpy(values).cuda())
    if not np.array_equal(out.cpu().numpy(), np.repeat(values, counts)):
        raise AssertionError("zero-count decode differs from np.repeat")
    # the classes below draw from a generator of their own, so that the
    # streams drawn from `rng` after this phase stay the bytes earlier runs
    # of this script timed
    return (cases + 1 + phase_rl_encode_classes(classes_rng)
            + phase_rl_expand_classes(classes_rng))


def phase_rl_offsets_classes(rng) -> int:
    """flrl_rl_run_offsets on R around a tile, a group of RUN_GROUP tiles
    and 40 groups (a look-back past its 32-group window), tail groups whose
    last tile holds R mod 4096 in {0, 1, 4095} runs, of random, zero and
    all-255 counts; twenty calls in a row on reused memory (each result
    freed before the next: the status words are cleared on the stream); and
    2^30 zero counts followed by 2^30 counts of 255 (positions and sums past
    32 bits)."""
    T, K = rk.TILE, rk.RUN_GROUP
    cases = 0
    for R in sorted({0, 1, 15, 17, T - 1, T, T + 1, K * T - 1, K * T,
                     K * T + 1, 40 * K * T, (40 * K - 1) * T + 1,
                     (40 * K - 1) * T + T - 1, (3 * K + 2) * T + 1}):
        for counts in (rng.integers(0, 256, R, np.uint8),
                       np.zeros(R, np.uint8), np.full(R, 255, np.uint8)):
            c = torch.from_numpy(counts).cuda()
            compare("rl_offsets", rk.run_offsets(c), rk.run_offsets_ref(c))
            cases += 1
    R = 41 * K * T + 5
    counts = [torch.from_numpy(rng.integers(0, 256, R, np.uint8)).cuda()
              for _ in range(20)]
    wants = [rk.run_offsets_ref(c) for c in counts]
    for c, want in zip(counts, wants):
        compare("rl_offsets", rk.run_offsets(c), want)
    cases += 20
    del counts, wants
    big = torch.zeros(2 * HALF_RUNS, dtype=torch.uint8, device=DEVICE)
    big[HALF_RUNS:] = 255
    compare("rl_offsets", rk.run_offsets(big), rk.run_offsets_ref(big))
    del big
    torch.cuda.empty_cache()
    return cases + 1


ENCODE_TILE_COUNTS = (1, 31, 32, 33, 1024)
ENCODE_MAX_BYTES = 1 << 30       # kEncodeMaxBytes in csrc/rl.cuh


def phase_rl_encode_classes(rng) -> int:
    """The encode kernel at tile counts around its look-back window, a run
    of one byte over more than 32 tiles inside a non-constant chunk, twenty
    calls in a row on reused memory (each result freed before the next),
    one launch of ENCODE_MAX_BYTES (2^30) bytes, against rl-cpu, and the
    refusal of 16 bytes more."""
    T = rk.ENCODE_TILE
    cases = 0
    for tiles in ENCODE_TILE_COUNTS:
        for tail in (0, 5):
            x = torch.from_numpy(
                runs_stream(rng, tiles * T - tail, 1, 600, 256)).cuda()
            check_rl_encode(x)
            cases += 1
    data = np.concatenate([rng.integers(0, 9, 700, np.uint8),
                           np.full(40 * T + 11, 42, np.uint8),
                           rng.integers(0, 9, 900, np.uint8)])
    check_rl_encode(torch.from_numpy(data).cuda())
    x = torch.from_numpy(rl_mixed_stream(rng, 16 * MIB)).cuda()
    streams = [torch.roll(x, 4099 * i) for i in range(20)]
    wants = [rk.encode_chunk_ref(s) for s in streams]
    for s, want in zip(streams, wants):
        check_rl_encode(s, want=want)
    del x, streams, wants
    # 2^30 bytes, the chunk walk's largest launch: the kernel's container is
    # rl-cpu's of the same bytes
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    runs = torch.randint(1, 600, (ENCODE_MAX_BYTES // 256,), generator=g,
                         device=DEVICE)
    vals = torch.randint(0, 256, (runs.numel(),), generator=g,
                         device=DEVICE).to(torch.uint8)
    big = torch.repeat_interleave(vals, runs)[:ENCODE_MAX_BYTES]
    if big.numel() != ENCODE_MAX_BYTES:
        raise AssertionError("the 2^30-byte stream came out short")
    values, counts, _ = rk.encode_chunk(big)
    ref = CODECS["rl-cpu"].compress(big.cpu().numpy())
    if not (np.array_equal(counts.cpu().numpy(), ref.counts)
            and np.array_equal(values.cpu().numpy(), ref.values)):
        raise AssertionError("rl_encode of 2^30 bytes differs from rl-cpu")
    del big, values, counts, runs, vals
    # the kernel's 32-bit positions: more than 2^30 bytes must raise
    over = torch.zeros(ENCODE_MAX_BYTES + 16, dtype=torch.uint8,
                       device=DEVICE)
    try:
        rk.encode_chunk(over)
    except RuntimeError:
        pass
    else:
        raise AssertionError("flrl_rl_encode took more than 2^30 bytes")
    del over
    torch.cuda.empty_cache()
    return cases + 23


def phase_rl_expand_classes(rng) -> int:
    """The expand kernel on output sizes 1..33, runs of 1, 15, 16, 17 and
    255, runs of 1..8, 5..6 and 6..7 (tile outputs around the size the
    kernel stages in shared memory), tiles whose outputs start at every
    16-byte phase, and zero counts in short runs, each against np.repeat
    too."""
    classes = []
    for size in range(1, 34):
        cuts = (np.sort(rng.choice(np.arange(1, size), min(size - 1, 5),
                                   replace=False)) if size > 1 else [])
        classes.append(np.diff(np.concatenate([[0], cuts, [size]])))
    for length in (1, 15, 16, 17, 255):
        classes.append(np.full(3 * rk.TILE + 100, length))
    # tiles whose output fits the expand's shared stage, near its end, and
    # just past it
    for lo, hi in ((1, 8), (5, 6), (6, 7)):
        classes.append(rng.integers(lo, hi + 1, 5 * rk.TILE + 77))
    # tile t's output starts at phase t mod 16: tiles of 4097 bytes (staged
    # in shared memory) and of 65537 bytes (filled by 16-byte groups)
    for length in (1, 16):
        phased = np.full(17 * rk.TILE, length, np.int64)
        phased[::rk.TILE] = length + 1
        classes.append(phased)
    # zero counts in staged tiles (the zero-count case of the 16-byte
    # groups is phase_rl_kernels')
    zeros = rng.integers(0, 3, 5 * rk.TILE + 9)
    zeros[-1] = 0
    classes.append(zeros)
    for counts in classes:
        counts = counts.astype(np.uint8)
        values = rng.integers(0, 256, counts.size, np.uint8)
        _, out = check_rl_decode(torch.from_numpy(counts).cuda(),
                                 torch.from_numpy(values).cuda())
        if not np.array_equal(out.cpu().numpy(), np.repeat(values, counts)):
            raise AssertionError("rl_expand differs from np.repeat")
    return len(classes)


def time_rl_kernels(data: np.ndarray) -> dict:
    """Kernel and plain times on one 512 MiB chunk, each compared once
    more at that shape."""
    x = torch.from_numpy(data).cuda()
    n = x.numel()
    e = check_rl_encode(x)
    counts, values = e["counts"], e["values"]
    offs, _ = check_rl_decode(counts, values)
    timings = {
        "rl_encode": (kernel_ms("rl_encode", lambda: rk.encode_chunk(x)),
                      cuda_ms(lambda: rk.encode_chunk_ref(x))),
        "rl_offsets": (kernel_ms("rl_offsets", lambda: rk.run_offsets(counts)),
                       cuda_ms(lambda: rk.run_offsets_ref(counts))),
        "rl_expand": (
            kernel_ms("rl_expand", lambda: rk.expand(counts, values, offs, n)),
            cuda_ms(lambda: rk.expand_ref(counts, values, offs, n))),
    }
    moved("rl_encode", x, values, counts)
    moved("rl_offsets", counts, offs)
    moved("rl_expand", counts, values, offs, x)
    time_rl_offsets_yardstick(counts)
    counts64 = counts.to(torch.int64)     # repeat_interleave's repeats type
    library_ms("rl_expand", lambda: torch.repeat_interleave(
        values, counts64, output_size=n))
    say(f"[kernels] rl_mixed: {n} bytes, {counts.numel()} pieces")
    del e, offs, counts, values, counts64
    time_rl_parts(x)
    del x
    torch.cuda.empty_cache()
    return timings


def time_rl_offsets_yardstick(counts: torch.Tensor) -> None:
    """A yardstick for flrl_rl_run_offsets, not a library time (no one
    PyTorch call computes the per-tile scan): the sum of each whole tile of
    4096 counts in int64, then its cumsum; the pair, then each call alone."""
    T = counts.numel() // rk.TILE
    rows = counts[:T * rk.TILE].view(T, rk.TILE)
    sums = rows.sum(1, dtype=torch.int64)
    calls = (("both", lambda: torch.cumsum(rows.sum(1, dtype=torch.int64), 0)),
             ("the row sums", lambda: rows.sum(1, dtype=torch.int64)),
             ("the cumsum", lambda: torch.cumsum(sums, 0)))
    times = [f"{what} {cuda_ms(f):.3f} ms single (median of 5), "
             f"{launch_ms(f):.4f} ms a launch over a run of {RUN}"
             for what, f in calls]
    say(f"[kernels] yardstick torch.cumsum(counts[:T*4096].view(T, 4096)"
        f".sum(1, dtype=torch.int64), 0) on rl_mixed's {T} whole tiles: "
        f"{'; '.join(times)}")


RL_PARTS = ("runs of 1..8", "runs of 200..900", "random bytes", "zeros")


def time_rl_parts(x: torch.Tensor) -> None:
    """The encode and expand on each quarter of rl_mixed (rl_mixed_stream's
    parts) alone, a launch over a run of RUN calls, beside each part's
    bound: where the time of the whole goes."""
    part = x.numel() // len(RL_PARTS)
    for i, name in enumerate(RL_PARTS):
        xp = x[i * part:(i + 1) * part]
        values, counts, _ = rk.encode_chunk(xp)
        offs = rk.run_offsets(counts)
        bound = (part + 2 * counts.numel()) / HBM_BYTES_PER_S * 1e3
        enc = launch_ms(lambda: rk.encode_chunk(xp))
        exp = launch_ms(lambda: rk.expand(counts, values, offs, part))
        say(f"[kernels] rl_mixed part {i} ({name}): {counts.numel()} pieces; "
            f"rl_encode {enc:.4f} ms, rl_expand {exp:.4f} ms a launch over a "
            f"run of {RUN}, bound {bound:.4f} ms each")
        del values, counts, offs


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


# ---------------------------------------------------------------------------
# Streaming (stream.py) and the pipelined walk
# ---------------------------------------------------------------------------

STREAM_CHUNKS_MB = (64, 256)
# the stream phase's file: past one 1 GiB chunk, with a ragged tail
STREAM_PARTS_MIB = (("w4", 256), ("random widths", 512), ("zeros", 128),
                    ("w8", 384))
STREAM_TAIL = 77
# the child that reports a streaming CLI process's resident memory: after
# the CUDA context and the kernels are up (its base), then the peak that a
# thread sampling /proc/self/statm every 2 ms saw during `c` and during `d`
# of one file at one chunk size, in bytes.  (ru_maxrss read 17,248 MiB in
# every such process on the card's machine, whatever the chunk and the
# file: a peak of the CUDA start-up, not of the stream.)  A fresh process
# for each file and chunk size: freed host memory stays in the process.
RSS_CHILD = """
import os
import sys
import threading

import torch

from fl_rl_compression_mpi_tpu_torch import cli
from fl_rl_compression_mpi_tpu_torch.ops import _build

PAGE = os.sysconf("SC_PAGE_SIZE")


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE


peak = [0]
done = threading.Event()


def sample():
    while not done.wait(0.002):
        peak[0] = max(peak[0], rss())


torch.zeros(1, device="cuda")
_build.lib()
print("base", rss())
threading.Thread(target=sample, daemon=True).start()
mb, src, comp, back = sys.argv[1:]
peaks = []
for argv in (["c", "fl", src, comp], ["d", "fl", comp, back]):
    peak[0] = rss()
    if cli.main([*argv, "--stream-chunk-mb", mb]) != 0:
        sys.exit(1)
    peaks.append(max(peak[0], rss()))
done.set()
print("rss", *peaks)
"""


def stream_file(rng) -> np.ndarray:
    """1.25 GiB + 77 bytes: at 256 MiB chunks a uniform-w4 chunk (the
    speculation's hit), random widths, a chunk of zeros then w8 (the
    probe sees width 1: a miss), a w8 chunk and the tail; at 64 MiB also
    constant chunks (the host closed form)."""
    parts = {"w4": lambda m: uniform_stream(rng, m, 128, 4),
             "random widths": lambda m: random_width_stream(rng, m, 128),
             "zeros": lambda m: np.zeros(m, np.uint8),
             "w8": lambda m: uniform_stream(rng, m, 128, 8)}
    return np.concatenate([parts[name](mib * MIB)
                           for name, mib in STREAM_PARTS_MIB]
                          + [random_width_stream(rng, STREAM_TAIL, 128)])


def stream_rss(src: str, tmp: str, mb: int) -> tuple:
    """Resident memory of a streaming CLI process that runs ``c`` then
    ``d`` of ``src`` at ``mb`` MiB chunks, in a fresh process: ``(base,
    peak during c, peak during d)``, in bytes.  A peak that does not grow
    with the file is bounded by the chunk."""
    back = os.path.join(tmp, "r.out")
    proc = subprocess.run(
        [sys.executable, "-c", RSS_CHILD, str(mb), src,
         os.path.join(tmp, "r.fl"), back], cwd=REPO, capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise AssertionError(f"stream RSS child failed: {proc.stderr}")
    if not same_file(back, src):
        raise AssertionError("stream RSS child: d did not restore the input")
    got = {line.split()[0]: [int(x) for x in line.split()[1:]]
           for line in proc.stdout.splitlines()
           if line.startswith(("base ", "rss "))}
    if len(got.get("base", ())) != 1 or len(got.get("rss", ())) != 2:
        raise AssertionError(f"stream RSS child: no peaks in {proc.stdout}")
    return got["base"][0], *got["rss"]


def timer_rates(argv: list) -> dict:
    """Run the CLI in this process with ``--timers``; each copy stage's
    rates (GB/s), one a chunk, by stage name."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_cli(*argv, "--timers")
    rates = {}
    for line in out.getvalue().splitlines():
        got = re.search(r"\[TIMER\] ((?:Copy|Host copy)[^:]*): [0-9.]+ ms "
                        r"\(([0-9.]+) (GB|MB|KB)/s\)", line)
        if got:
            scale = {"GB": 1, "MB": 1e-3, "KB": 1e-6}[got.group(3)]
            rates.setdefault(got.group(1), []).append(
                float(got.group(2)) * scale)
    return rates


def _union(spans: list) -> list:
    """The union of [start, end) spans, as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(spans: list) -> float:
    return sum(b - a for a, b in spans)


def _meet(x: list, y: list) -> float:
    """The length of the intersection of two unions of spans."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_trace(argv: list) -> str:
    """One CLI run under torch.profiler: its wall, and from the device's
    own events (ms) the time the device was busy, the copies up, the
    copies down, the kernels, and how much the copies up and down, and
    the copies and the kernels, overlapped."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(*argv)
        wall = (time.perf_counter() - t0) * 1e3
    spans = {"up": [], "down": [], "kernels": [], "other": []}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("up" if "HtoD" in e.name else "down" if "DtoH" in e.name
                else "other" if "Memcpy" in e.name or "Memset" in e.name
                else "kernels")
        spans[kind].append((e.time_range.start / 1e3,
                            e.time_range.end / 1e3))
    u = {k: _union(v) for k, v in spans.items()}
    busy = _length(_union([x for v in spans.values() for x in v]))
    copies = _union(u["up"] + u["down"])
    return (f"wall {wall:.1f} ms, device busy {busy:.1f} ms (idle share "
            f"{1 - busy / wall:.3f}): copies up {_length(u['up']):.1f}, "
            f"down {_length(u['down']):.1f}, kernels "
            f"{_length(u['kernels']):.1f}; up and down overlapped "
            f"{_meet(u['up'], u['down']):.1f}, copies and kernels "
            f"{_meet(copies, u['kernels']):.1f}")


def phase_stream(tmp: str, rng) -> dict:
    """The CLI's `--stream-chunk-mb` on a 1.25 GiB + 77 byte file (its own
    generator): `c` and `d` at 64 and 256 MiB chunks beside the whole-file
    `c fl` / `d fl`, whose container equals fl-cpu's; every stream
    container equals the whole-file one on both routes, the decodes
    restore the input, `--verify` passes; the dense kernels launched.  One
    pipelined encode and decode through fl_torch's walk under
    torch.cuda.set_sync_debug_mode("error"), so that a read-back in a
    submit fails the run (the drain waits on events, which that mode does
    not watch).  Each copy stage's rates, one a chunk, from a `--timers`
    run, and a profiler trace of the streamed c and d at 256 MiB; the
    resident memory of a streaming CLI process at both chunk
    sizes on 384 MiB + 77 bytes and on the whole file, a fresh process
    each.  Returns the dense kernels' launches."""
    data = stream_file(rng)
    src = os.path.join(tmp, "s.bin")
    data.tofile(src)
    whole, back = os.path.join(tmp, "s.fl"), os.path.join(tmp, "s.out")
    t0 = time.perf_counter()
    run_cli("c", "fl", src, whole)
    t1 = time.perf_counter()
    run_cli("d", "fl", whole, back)
    t2 = time.perf_counter()
    walls = {"whole": (t1 - t0, t2 - t1)}
    ref = CODECS["fl-cpu"].compress(data)
    comp = load_fl(whole)
    if not (np.array_equal(comp.bits, ref.bits)
            and np.array_equal(comp.values, ref.values)):
        raise AssertionError("stream file: the whole-file c fl container "
                             "differs from fl-cpu's")
    del ref, comp
    if not same_file(back, src):
        raise AssertionError("stream file: d fl did not restore the input")
    reset_fl_launches()
    for mb in STREAM_CHUNKS_MB:
        out = os.path.join(tmp, f"s.{mb}.fl")
        t0 = time.perf_counter()
        run_cli("c", "fl", src, out, "--stream-chunk-mb", str(mb))
        t1 = time.perf_counter()
        run_cli("d", "fl", out, back, "--stream-chunk-mb", str(mb))
        t2 = time.perf_counter()
        walls[mb] = (t1 - t0, t2 - t1)
        if not same_file(out, whole):
            raise AssertionError(f"stream {mb} MiB: container differs from "
                                 "the whole-file c fl's")
        if not same_file(back, src):
            raise AssertionError(f"stream {mb} MiB: d did not restore the "
                                 "input")
    launches = dict(k.LAUNCHES)
    check_route({**launches, **fk.LAUNCHES}, "dense", "stream")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"stream: dense kernels not launched: {missing}")
    run_cli("c", "fl", src, os.path.join(tmp, "s.v.fl"), "--stream-chunk-mb",
            "256", "--verify")
    for name, (tc, td) in walls.items():
        say(f"[stream] {'whole file' if name == 'whole' else f'{name} MiB'}"
            f": c {tc:.3f} s, d {td:.3f} s ({data.size} bytes, wall, host "
            f"clock)")
    say(f"[stream] containers equal the whole-file c fl's (= fl-cpu's) at "
        f"{STREAM_CHUNKS_MB} MiB, round trips exact, --verify OK; launches "
        f"{json.dumps(launches)}")
    with field_route():
        reset_fl_launches()
        for mb in STREAM_CHUNKS_MB:
            out = os.path.join(tmp, f"s.f{mb}.fl")
            t0 = time.perf_counter()
            run_cli("c", "fl", src, out, "--stream-chunk-mb", str(mb))
            t1 = time.perf_counter()
            if not same_file(out, whole):
                raise AssertionError(f"field route, stream {mb} MiB: "
                                     "container differs")
            say(f"[stream] field route {mb} MiB: container equals the "
                f"whole-file c fl's; c {t1 - t0:.3f} s")
        run_cli("d", "fl", whole, back, "--stream-chunk-mb", "256")
        if not same_file(back, src):
            raise AssertionError("field route stream: d did not restore the "
                                 "input")
        check_route({**k.LAUNCHES, **fk.LAUNCHES}, "fields", "field stream")
    stream_sync_free(data, whole)
    for argv in (("c", "fl", src, os.path.join(tmp, "s.t.fl")),
                 ("d", "fl", whole, back)):
        rates = timer_rates([*argv, "--stream-chunk-mb", "256"])
        say(f"[stream] {argv[0]} 256 MiB, copy stages a chunk (GB/s, "
            f"--timers, each stage synchronised): "
            + "; ".join(f"{name} " + ", ".join(f"{r:.2f}" for r in rs)
                        for name, rs in rates.items()))
        say(f"[stream] {argv[0]} 256 MiB under torch.profiler: "
            f"{stream_trace([*argv, '--stream-chunk-mb', '256'])}")
    small = os.path.join(tmp, "s.small.bin")
    data[:3 * 128 * MIB + STREAM_TAIL].tofile(small)
    del data
    for mb in STREAM_CHUNKS_MB:
        for path in (small, src):
            base, c, d = (x / (1 << 20) for x in stream_rss(path, tmp, mb))
            say(f"[stream] resident memory of a streaming CLI process, "
                f"{os.path.getsize(path)} bytes at {mb} MiB chunks (MiB, "
                f"/proc/self/statm sampled every 2 ms): base {base:.1f}, "
                f"peak during c {c:.1f} (+{c - base:.1f}), during d "
                f"{d:.1f} (+{d - base:.1f})")
    return launches


def stream_sync_free(data: np.ndarray, whole: str) -> None:
    """One pipelined encode and decode of the first 512 MiB in 96 MiB
    chunks (a w4 chunk, a chunk that starts w4 and goes on in random
    widths: the flag's miss, random widths) under sync-debug "error": any
    call that waits for the device outside an event wait raises."""
    n = 512 * MIB
    step = 96 * MIB
    head = data[:n]
    comp = load_fl(whole)
    frames = n // 128
    want_bits = comp.bits[:frames]
    want_values = comp.values[:fl_torch.payload_size(want_bits, n, 128)]
    set_stage_timers(False)     # a stage timer synchronises the device
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        parts = [(b, v.copy()) for b, v in fl_torch.encode_chunks(
            (head[off:off + step] for off in range(0, n, step)),
            device=DEVICE)]
        got_bits = np.concatenate([b for b, _ in parts])
        got_values = np.concatenate([v for _, v in parts])
        out = np.concatenate([o.copy() for o in fl_torch.decode_chunks(
            ((min(step, n - off), b, v) for off, (b, v)
             in zip(range(0, n, step), parts)), device=DEVICE)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (np.array_equal(got_bits, want_bits)
            and np.array_equal(got_values, want_values)):
        raise AssertionError("sync-free walk: container differs")
    if not np.array_equal(out, head):
        raise AssertionError("sync-free walk: decode did not restore the "
                             "input")
    say("[stream] pipelined encode and decode of 512 MiB in 96 MiB chunks "
        "under set_sync_debug_mode('error'): no read-back in a submit; "
        "bytes exact")


# ---------------------------------------------------------------------------
# Distribution (parallel/dist.py)
# ---------------------------------------------------------------------------

# Kernels each distributed run must launch, by stream
DIST_EXPECT = {
    "mixed": ("fl_frame_widths", "fl_frame_offsets", "fl_pack", "fl_unpack"),
    "uniform4": ("fl_frame_widths", "fl_pack_uniform", "fl_unpack_uniform"),
    "rl_mixed": tuple(RL_REPLACES),
}


def reset_all_launches() -> None:
    for mod in (k, fk, rk, ck, cpk):
        mod.reset_launches()


def all_launches() -> dict:
    return {**k.LAUNCHES, **fk.LAUNCHES, **rk.LAUNCHES, **ck.LAUNCHES,
            **cpk.LAUNCHES}


def cli_process_walls(tmp: str) -> dict:
    """A one-file CLI process at --devices 1, as a user runs it: ``python
    -m ... c fl-dist --devices 1`` and ``c fl`` on the 512 MiB mixed file,
    each in a fresh process, in turns, three times each.  Wall
    seconds of each run, the process's start included; every container
    equals the main phase's."""
    src = os.path.join(tmp, "mixed.bin")
    walls = {"fl-dist": [], "fl": []}
    for _ in range(3):
        for m in walls:
            out = os.path.join(tmp, f"p.{m}")
            extra = ["--devices", "1"] if m == "fl-dist" else []
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "fl_rl_compression_mpi_tpu_torch",
                 "c", m, src, out, *extra], cwd=REPO, capture_output=True,
                text=True)
            walls[m].append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError(f"python -m ... c {m} failed: "
                                     f"{proc.stderr}")
            if not same_file(out, os.path.join(tmp, "mixed.fl")):
                raise AssertionError(f"python -m ... c {m}: container "
                                     "differs from the main phase's")
    return walls


def median_range(xs: list) -> str:
    return f"{np.median(xs):.3f} ({min(xs):.3f}-{max(xs):.3f})"


def phase_dist(tmp: str) -> tuple:
    """fl-dist, fl-ici and rl-dist through the CLI at --devices 1 (one rank
    in this process, with no process group) on the main phases' 512 MiB
    files: c --verify and d, each with the counts set to 0 just before and
    read just after; the containers equal the main phases' (fl-cpu's, and
    rl's, which is rl-cpu's at one shard), and no process group exists
    after them.  Then walls, two rounds, each stream's single-device
    method beside its distributed ones, and a one-file CLI process at
    --devices 1 beside ``c fl``'s.  Returns the launches of the
    distributed runs and the walls."""
    plan = (("mixed", "fl", ("fl-dist", "fl-ici")),
            ("uniform4", "fl", ("fl-dist", "fl-ici")),
            ("rl_mixed", "rl", ("rl-dist",)))
    launches = {}
    for name, base, methods in plan:
        src = os.path.join(tmp, f"{name}.bin")
        want = os.path.join(tmp, f"{name}.{base}")
        for m in methods:
            comp_path = os.path.join(tmp, f"{name}.{m}")
            back = os.path.join(tmp, f"{name}.{m}.out")
            reset_all_launches()
            run_cli("c", m, src, comp_path, "--verify", "--devices", "1")
            run_cli("d", m, comp_path, back, "--devices", "1")
            ran = all_launches()
            missing = [key for key in DIST_EXPECT[name] if ran[key] == 0]
            if missing:
                raise AssertionError(f"{m} on {name}: kernels not launched: "
                                     f"{missing} ({json.dumps(ran)})")
            if not same_file(comp_path, want):
                raise AssertionError(f"{m} on {name}: container differs from "
                                     f"the {base} main phase's")
            if not same_file(back, src):
                raise AssertionError(f"{m} on {name}: d did not restore the "
                                     "input")
            say(f"[dist] {m} --devices 1 on {name}: container equals "
                f"{'fl-cpu' if base == 'fl' else 'rl and rl-cpu'}'s, round "
                f"trip exact; launches "
                f"{json.dumps({key: v for key, v in ran.items() if v})}")
            for key, v in ran.items():
                launches[key] = launches.get(key, 0) + v
    if torch.distributed.is_initialized():
        raise AssertionError("a world-1 call left a process group behind")
    say("[dist] no process group exists after the world-1 calls")
    walls = {}
    for _ in range(2):
        for name, base, methods in plan:
            src = os.path.join(tmp, f"{name}.bin")
            for m in (base, *methods):
                out = os.path.join(tmp, f"{name}.w.{base}")
                back = os.path.join(tmp, f"{name}.w.out")
                extra = () if m == base else ("--devices", "1")
                t0 = time.perf_counter()
                run_cli("c", m, src, out, *extra)
                t1 = time.perf_counter()
                run_cli("d", m, out, back, *extra)
                t2 = time.perf_counter()
                walls.setdefault((name, m), []).append((t1 - t0, t2 - t1))
    for (name, m), ws in walls.items():
        say(f"[dist] wall {name} {m}: c {median_range([w[0] for w in ws])} "
            f"s, d {median_range([w[1] for w in ws])} s (median (min-max) "
            f"of 2, host clock)")
    for m, ws in cli_process_walls(tmp).items():
        say(f"[dist] one-file CLI process, python -m ... c {m} on mixed"
            f"{' --devices 1' if m == 'fl-dist' else ''}: "
            f"{median_range(ws)} s (median (min-max) of 3, process start "
            f"included, host clock)")
    return launches, walls


def two_rank_cases(fl_data, rl_data, *, group=None, device):
    """Rank side of the two-rank run: fl-ici, the FL decode, rl-dist and
    its decode; every rank's launch counts."""
    rank = torch.distributed.get_rank(group)
    world = torch.distributed.get_world_size(group)
    reset_all_launches()
    ici = dist.compress_fl_ici(fl_data, group=group, device=device)
    back = dist.decompress_fl(ici, group=group, device=device)
    box = [dist.compress_rl(rl_data, group=group, device=device)]
    torch.distributed.broadcast_object_list(box, src=0, group=group)
    rback = dist.decompress_rl(box[0], group=group, device=device)
    counts = [None] * world
    torch.distributed.all_gather_object(counts, all_launches(), group=group)
    return (ici, back, box[0], rback, counts) if rank == 0 else None


def phase_dist_two_ranks(rng) -> None:
    """Two gloo ranks spawned on card 0 (NCCL refuses two ranks on one
    card), 64 MiB: fl-dist through the API, then one spawned group for
    fl-ici, the FL decode, rl-dist and its decode.  FL containers equal
    fl-cpu's; RL equals rl-cpu's per-shard containers concatenated; every
    rank launched the kernels of its path."""
    dev = DEVICE
    fl_data = random_width_stream(rng, 64 * MIB + 77, 128)
    rl_data = rl_mixed_stream(rng, 16 * MIB)
    ref = CODECS["fl-cpu"].compress(fl_data)
    t0 = time.perf_counter()
    comp = compress(fl_data, method="fl-dist", devices=2, device=dev,
                    backend="gloo")
    t1 = time.perf_counter()
    ici, back, rl, rback, counts = dist.run_collective(
        two_rank_cases, fl_data, rl_data, devices=2, device=dev,
        backend="gloo")
    t2 = time.perf_counter()
    for what, c in (("fl-dist", comp), ("fl-ici", ici)):
        if not (np.array_equal(c.bits, ref.bits)
                and np.array_equal(c.values, ref.values)):
            raise AssertionError(f"two ranks: {what} container differs from "
                                 "fl-cpu's")
    plan = dist.plan_shards(rl_data.size, 2)
    parts = [CODECS["rl-cpu"].compress(plan.shard(rl_data, i))
             for i in range(2)]
    if not (np.array_equal(rl.counts,
                           np.concatenate([p.counts for p in parts]))
            and np.array_equal(rl.values,
                               np.concatenate([p.values for p in parts]))):
        raise AssertionError("two ranks: rl-dist container differs from "
                             "rl-cpu's per-shard containers")
    if not (np.array_equal(back, fl_data) and np.array_equal(rback, rl_data)):
        raise AssertionError("two ranks: decode did not restore the input")
    for rank, ran in enumerate(counts):
        missing = [key for key in DIST_EXPECT["mixed"] + DIST_EXPECT[
            "rl_mixed"] if ran[key] == 0]
        if missing:
            raise AssertionError(f"two ranks: rank {rank} did not launch "
                                 f"{missing}")
    say(f"[dist] two gloo ranks on cuda:0, 64 MiB: fl-dist (API) and fl-ici "
        f"equal fl-cpu's, rl-dist equals rl-cpu's per-shard containers, round "
        f"trips exact, every rank launched its kernels; fl-dist "
        f"{t1 - t0:.3f} s, the rest in one group {t2 - t1:.3f} s (walls with "
        f"the spawn)")


def constant_programs(cbyte: int, n: int, *, group=None, device):
    """Rank side of the device-resident constant programs on n bytes of
    cbyte made on the card: launches of the clean encode and decode,
    their flags, the outputs' checks, and the flags of a flipped input
    byte and of a flipped payload byte."""
    data = torch.full((n,), cbyte, dtype=torch.uint8, device=device)
    head = data[:ck.DENSE_UNIFORM_TILE_R * 512].cpu().numpy()
    cb, fb = ck.host_probe_constant(head, n)
    reset_all_launches()
    bits, values, flags = dist.fl_compress_sharded_dense_constant(
        data, cb, fb, group=group)
    out, dflags = dist.fl_decompress_sharded_dense_constant(
        values, values.numel(), n, cb, fb, group=group)
    launches = {key: ck.LAUNCHES[key] for key in CONST_REPLACES}
    ref = CODECS["fl-cpu"].compress(np.full(n, cbyte, np.uint8))
    exact = (np.array_equal(bits.cpu().numpy(), ref.bits)
             and np.array_equal(values.cpu().numpy(), ref.values)
             and bool(torch.equal(out, data)))
    data[n // 2] ^= 0x40
    bad = dist.fl_compress_sharded_dense_constant(data, cb, fb,
                                                  group=group)[2]
    values[values.numel() - 1] ^= 0x01
    bad_d = dist.fl_decompress_sharded_dense_constant(
        values, values.numel(), n, cb, fb, group=group)[1]
    return (launches, exact, [int(f.sum()) for f in (flags, dflags, bad,
                                                     bad_d)])


def phase_constant_programs() -> dict:
    """The constant programs at world size 1 (no process group) on 512 MiB of
    0x00 and of 0x0F; returns their launches."""
    launches = {key: 0 for key in CONST_REPLACES}
    for c in (0x00, 0x0F):
        ran, exact, flags = dist.run_collective(
            constant_programs, c, 512 * MIB, devices=1, device=DEVICE)
        if not exact or flags[:2] != [0, 0] or 0 in flags[2:]:
            raise AssertionError(f"constant programs on 0x{c:02X}: exact "
                                 f"{exact}, flags {flags}")
        for key, v in ran.items():
            launches[key] += v
        say(f"[dist] constant programs, one rank, 512 MiB of 0x{c:02X}:"
            f" bytes exact, flags clean, a flipped byte trips each flag; "
            f"launches {json.dumps(ran)}")
    missing = [key for key, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"constant kernels not launched: {missing}")
    return launches


# ---------------------------------------------------------------------------
# Multi-process (parallel/multihost.py)
# ---------------------------------------------------------------------------

def torchrun(nproc: int, spec: list, tmp: str, timeout: int = 900) -> tuple:
    """Each of ``nproc`` processes that torchrun starts runs the CLI calls
    of ``spec`` (``[label, argv, env]`` each) in-process, one after the
    other (this script's ``--torchrun-cli`` mode).  Returns every rank's
    results (``torchrun_child``) and torchrun's own wall."""
    path = os.path.join(tmp, "torchrun.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    # torchrun gives each process one OpenMP thread unless told otherwise
    env = dict(os.environ,
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // nproc)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), os.path.join(REPO, "chip_smoke.py"),
         "--torchrun-cli", path], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun --nproc-per-node {nproc} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-5000:]}")
    ranks = []
    for rank in range(nproc):
        with open(f"{path}.{rank}") as f:
            ranks.append(json.load(f))
    return ranks, wall


def torchrun_child(path: str) -> int:
    """This script as one process of torchrun: every CLI call of the spec
    at ``path`` in this process, one after the other.  Each call's wall
    starts at a barrier (but the first's, which makes the group) and its
    launch counts start at 0; at the end the group's destroy is timed,
    which the exit hook would do.  Writes this rank's results to
    ``<path>.<rank>``."""
    from fl_rl_compression_mpi_tpu_torch.parallel import multihost
    with open(path) as f:
        spec = json.load(f)
    results = []
    for label, argv, env in spec:
        saved = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        if torch.distributed.is_initialized():
            multihost._barrier()
        reset_all_launches()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
        results.append({"label": label, "rc": rc, "wall": wall,
                        "launches": all_launches()})
        if rc:
            break
    rank = torch.distributed.get_rank()
    t0 = time.perf_counter()
    torch.distributed.destroy_process_group()
    results.append({"label": "destroy", "rc": 0,
                    "wall": time.perf_counter() - t0, "launches": {}})
    with open(f"{path}.{rank}", "w") as f:
        json.dump(results, f)
    return max(r["rc"] for r in results)


MULTIHOST_FILES = (("mixed", "fl"), ("uniform4", "fl"), ("rl_mixed", "rl"))


def multihost_spec(tmp: str, rounds: int, coordinator: list) -> list:
    """The torchrun phase's CLI calls: ``c <family>-dist --verify`` and
    ``d`` on each file (outputs ``<name>.mh.*``), then ``rounds`` rounds
    of ``c`` and ``d`` for walls."""
    spec = []
    for name, family in MULTIHOST_FILES:
        src = os.path.join(tmp, f"{name}.bin")
        comp = os.path.join(tmp, f"{name}.mh.{family}")
        spec.append([f"{name} c --verify", [
            "c", f"{family}-dist", src, comp, *coordinator, "--verify"], {}])
        spec.append([f"{name} d", ["d", f"{family}-dist", comp,
                                   comp + ".out", *coordinator], {}])
    for _ in range(rounds):
        for name, family in MULTIHOST_FILES:
            src = os.path.join(tmp, f"{name}.bin")
            comp = os.path.join(tmp, f"{name}.mh.w")
            spec.append([f"{name} c", ["c", f"{family}-dist", src, comp,
                                       *coordinator], {}])
            spec.append([f"{name} d", ["d", f"{family}-dist", comp,
                                       comp + ".out", *coordinator], {}])
    return spec


def check_multihost_calls(results: list, where: str,
                          names=tuple(n for n, _ in MULTIHOST_FILES)) -> dict:
    """Every call exited 0 and launched its path's kernels (the c and d
    calls of each file of ``names`` together, a call's label starting
    with its file's name); returns the walls by label."""
    walls: dict = {}
    ran: dict = {}
    for r in results:
        if r["rc"] != 0:
            raise AssertionError(f"{where}: {r['label']} exited {r['rc']}")
        walls.setdefault(r["label"], []).append(r["wall"])
        name = r["label"].split()[0]
        for key, v in r["launches"].items():
            ran.setdefault(name, {}).setdefault(key, 0)
            ran[name][key] += v
    for name in names:
        missing = [key for key in DIST_EXPECT[name] if ran[name][key] == 0]
        if missing:
            raise AssertionError(f"{where}: {name}: kernels not launched: "
                                 f"{missing}")
    return walls


def multihost_two_ranks(fl_src: str, rl_src: str, out: str, *, group=None,
                        device):
    """Rank side of the two-rank module run: compress and decompress both
    files through the module functions, first merged to rank 0 in rounds
    of 1 MiB (FLRL_DCN_CHUNK_MB=1), then written by every rank
    (FLRL_SHARED_FS=1); rank 0's walls and every rank's launches."""
    from fl_rl_compression_mpi_tpu_torch.parallel import multihost as mh
    rank = torch.distributed.get_rank(group)
    opts = {"group": group, "device": device}
    reset_all_launches()
    walls = {}
    for mode, env in (("merge", {"FLRL_DCN_CHUNK_MB": "1"}),
                      ("shared fs", {"FLRL_SHARED_FS": "1"})):
        os.environ.update(env)
        tag = mode.replace(" ", "")
        steps = (("c fl", mh.compress_fl_file, fl_src, f"{out}.{tag}.fl"),
                 ("d fl", mh.decompress_fl_file, f"{out}.{tag}.fl",
                  f"{out}.{tag}.fl.out"),
                 ("c rl", mh.compress_rl_file, rl_src, f"{out}.{tag}.rl"),
                 ("d rl", mh.decompress_rl_file, f"{out}.{tag}.rl",
                  f"{out}.{tag}.rl.out"))
        try:
            for label, fn, src, dst in steps:
                mh._barrier(group)
                t0 = time.perf_counter()
                fn(src, dst, **opts)
                walls[f"{mode} {label}"] = time.perf_counter() - t0
        finally:
            for key in env:
                os.environ.pop(key)
    counts = [None] * torch.distributed.get_world_size(group)
    torch.distributed.all_gather_object(counts, all_launches(), group=group)
    return (walls, counts) if rank == 0 else None


def check_trace_names_a_kernel(logdir: str) -> tuple:
    """The ``--profile`` trace parses as JSON and holds a ``flrl_`` range;
    returns the ``flrl_`` names and the device kernels it recorded."""
    traces = glob.glob(os.path.join(logdir, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = sorted({e.get("name", "") for e in events
                    if e.get("name", "").startswith("flrl_")})
    kernels = sorted({e.get("name", "")[:40] for e in events
                      if e.get("cat") == "kernel"})
    if not names:
        raise AssertionError("the --profile trace names no flrl_ kernel")
    return names, kernels


def phase_multihost(tmp: str, walls: dict) -> None:
    """parallel/multihost.py on the card, after the timed phases.

    One process under torchrun (``--coordinator env://``), the CLI on the
    main phases' 512 MiB files: ``c fl-dist --verify`` and ``d fl-dist``
    on mixed and uniform4, ``c rl-dist --verify`` and ``d rl-dist`` on
    rl_mixed, then two rounds of walls; the containers equal the main
    phases', outputs the input, every path's kernels launched.  One run
    with ``--coordinator 127.0.0.1:<port> --num-processes 1 --process-id
    0`` through ``python -m``.  ``c fl --profile``: a trace naming a
    ``flrl_`` kernel.  Two gloo processes on card 0 over 64 MiB (their
    own generator, SEED + 7) through the module functions in one spawned
    group, merged in 1 MiB rounds, then under FLRL_SHARED_FS=1: FL equals
    fl-cpu's container, RL rl-cpu's per-shard containers concatenated,
    every rank launched its kernels."""
    ranks, wall = torchrun(1, multihost_spec(tmp, 2, ["--coordinator",
                                                      "env://"]), tmp)
    got = check_multihost_calls(ranks[0], "torchrun, one process")
    for name, family in MULTIHOST_FILES:
        comp = os.path.join(tmp, f"{name}.mh.{family}")
        if not same_file(comp, os.path.join(tmp, f"{name}.{family}")):
            raise AssertionError(f"torchrun: {name} container differs from "
                                 f"the {family} main phase's")
        if not same_file(comp + ".out", os.path.join(tmp, f"{name}.bin")):
            raise AssertionError(f"torchrun: d {family}-dist did not restore "
                                 f"{name}")
        base = walls[(name, family)]
        say(f"[multihost] torchrun, one process, env://, {name}: container "
            f"equals the main phase's, round trip exact; first c --verify "
            f"{got[f'{name} c --verify'][0]:.3f} s, d {got[f'{name} d'][0]:.3f}"
            f" s; walls c {median_range(got[f'{name} c'])} s, d "
            f"{median_range(got[f'{name} d'][1:])} s (median (min-max) of 2);"
            f" {family} in phase 7: c {median_range([w[0] for w in base])} s,"
            f" d {median_range([w[1] for w in base])} s")
    say(f"[multihost] torchrun: {len(ranks[0]) - 1} CLI calls in one process,"
        f" group destroy {got['destroy'][0]:.3f} s, torchrun's wall "
        f"{wall:.1f} s")

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    src = os.path.join(tmp, "mixed.bin")
    comp = os.path.join(tmp, "mixed.tcp.fl")
    t0 = time.perf_counter()
    launches = subprocess_launches(
        ["c", "fl-dist", src, comp, "--verify", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0"])
    t1 = time.perf_counter()
    missing = [key for key in ("fl_frame_widths", "fl_pack", "fl_unpack")
               if launches[key] == 0]
    if missing or not same_file(comp, os.path.join(tmp, "mixed.fl")):
        raise AssertionError(f"--coordinator 127.0.0.1:{port}: kernels not "
                             f"launched {missing}, or the container differs")
    say(f"[multihost] python -m ... c fl-dist --verify --coordinator "
        f"127.0.0.1:{port} --num-processes 1 --process-id 0: container "
        f"equals the main phase's; {t1 - t0:.3f} s with the process's start")

    logdir = os.path.join(tmp, "profile")
    run_cli("c", "fl", src, os.path.join(tmp, "mixed.prof.fl"), "--profile",
            logdir)
    names, kernels = check_trace_names_a_kernel(logdir)
    say(f"[multihost] c fl --profile: the trace names {names}; device "
        f"kernels {kernels}")

    rng = np.random.default_rng(SEED + 7)
    fl_data = random_width_stream(rng, 64 * MIB + 77, 128)
    rl_data = rl_mixed_stream(rng, 16 * MIB)
    fl_src, rl_src = (os.path.join(tmp, f) for f in ("mh2.fl.bin",
                                                     "mh2.rl.bin"))
    fl_data.tofile(fl_src)
    rl_data.tofile(rl_src)
    out = os.path.join(tmp, "mh2")
    t0 = time.perf_counter()
    two_walls, counts = dist.run_collective(
        multihost_two_ranks, fl_src, rl_src, out, devices=2, device=DEVICE,
        backend="gloo")
    t1 = time.perf_counter()
    ref = CODECS["fl-cpu"].compress(fl_data)
    plan = dist.plan_shards(rl_data.size, 2)
    parts = [CODECS["rl-cpu"].compress(plan.shard(rl_data, i))
             for i in range(2)]
    want_rl = RLCompressed(np.concatenate([p.counts for p in parts]),
                           np.concatenate([p.values for p in parts]),
                           rl_data.size)
    for tag in ("merge", "sharedfs"):
        fl = load_fl(f"{out}.{tag}.fl")
        rl = load_rl(f"{out}.{tag}.rl")
        if not (np.array_equal(fl.bits, ref.bits)
                and np.array_equal(fl.values, ref.values)):
            raise AssertionError(f"two processes, {tag}: FL container "
                                 "differs from fl-cpu's")
        if not (np.array_equal(rl.counts, want_rl.counts)
                and np.array_equal(rl.values, want_rl.values)):
            raise AssertionError(f"two processes, {tag}: RL container "
                                 "differs from rl-cpu's per-shard containers")
        if not (same_file(f"{out}.{tag}.fl.out", fl_src)
                and same_file(f"{out}.{tag}.rl.out", rl_src)):
            raise AssertionError(f"two processes, {tag}: a round trip is not "
                                 "exact")
    for rank, ran in enumerate(counts):
        missing = [key for key in DIST_EXPECT["mixed"] + DIST_EXPECT[
            "rl_mixed"] if ran[key] == 0]
        if missing:
            raise AssertionError(f"two processes: rank {rank} did not launch "
                                 f"{missing}")
    rounds = -(-(fl_data.size - int(plan.ns[0])) // MIB)
    say(f"[multihost] two gloo processes on cuda:0, 64 MiB, module "
        f"functions: merged in 1 MiB rounds ({rounds} rounds of the FL "
        f"decode) and under FLRL_SHARED_FS=1, FL equals fl-cpu's, RL equals "
        f"rl-cpu's per-shard containers, round trips exact, every rank "
        f"launched its kernels; rank 0's walls "
        + ", ".join(f"{k} {v:.3f} s" for k, v in two_walls.items())
        + f"; {t1 - t0:.1f} s with the spawn")


# ---------------------------------------------------------------------------
# The benchmark entry point (fl_rl_compression_mpi_tpu_torch/bench.py) and
# its copy-ceiling probe
# ---------------------------------------------------------------------------

COPY_WORDS = (1, 3, 4, 5, 2048 * 128)
BENCH_MIB = 256
BENCH_BUDGET_S = 100               # the bench's arm budget in this phase
# the arms a run without --full skips, and none besides them
BENCH_FULL_ONLY = {"dense_w3", "dense_mixed", "dense_bmp", "rl_half", "e2e"}
BENCH_OKS = ("host_roundtrip_ok", "dense_ok", "dense_ok_zeros", "dense_ok_w8",
             "rl_ok")


def check_copy_probe(x: torch.Tensor) -> None:
    compare("copy_probe", cpk.add_one(x), cpk.add_one_ref(x))


def phase_copy_probe(rng) -> tuple:
    """The copy probe against x + 1 on int32 bit-views, byte for byte:
    word counts 1, 3, 4, 5, 2048·128 and 512 MiB, words at 0xFFFFFFFF (the
    wrap), and a start 4 bytes into a larger buffer (the word path); then
    its times at 512 MiB beside its bound, x + 1 and ``copy_``.  Returns
    ``(kernel ms, plain ms)``."""
    cases = 0
    for nw in COPY_WORDS:
        words = rng.integers(-(1 << 31), 1 << 31, nw, dtype=np.int64)
        words[::3] = -1                         # 0xFFFFFFFF wraps to 0
        check_copy_probe(torch.from_numpy(words.astype(np.int32)).to(DEVICE))
        cases += 1
    big = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 4099,
                                        dtype=np.int64).astype(np.int32))
    big = big.to(DEVICE)
    for off, nw in ((1, 4096), (3, 5), (2, 2048)):
        check_copy_probe(big[off:off + nw])
        cases += 1
    check_copy_probe(torch.full((2048 * 128,), -1, dtype=torch.int32,
                                device=DEVICE))
    x = torch.randint(0, 1 << 32, (128 * MIB,), dtype=torch.int64,
                      device=DEVICE).to(torch.int32)
    check_copy_probe(x)
    cases += 2
    say(f"[bench] {cases} copy-probe inputs equal x + 1 byte for byte")
    y = torch.empty_like(x)
    timing = (kernel_ms("copy_probe", lambda: cpk.add_one(x)),
              cuda_ms(lambda: cpk.add_one_ref(x)))
    # the library row is x + 1, the one PyTorch call of the same function;
    # copy_ (cudaMemcpy device to device) beside it moves the same bytes
    library_ms("copy_probe", lambda: x + 1)
    copy_ms = (cuda_ms(lambda: y.copy_(x)), launch_ms(lambda: y.copy_(x)))
    moved("copy_probe", x, y)
    say(f"[kernels] copy_probe: {timing[0]:.4f} ms kernel, {timing[1]:.4f} "
        f"ms plain (x + 1), {bound_ms('copy_probe'):.4f} ms bound "
        f"({MOVED['copy_probe']} bytes), {LIBRARY_MS['copy_probe']:.4f} ms "
        f"x + 1, {copy_ms[0]:.4f} ms copy_ (512 MiB, median of 5 single "
        f"calls); a launch over a run of {RUN}: "
        f"{LAUNCH_MS['copy_probe']:.4f} ms kernel, "
        f"{LIBRARY_LAUNCH_MS['copy_probe']:.4f} ms x + 1, "
        f"{copy_ms[1]:.4f} ms copy_")
    del x, y, big
    torch.cuda.empty_cache()
    return timing


def phase_bench() -> dict:
    """``python -m fl_rl_compression_mpi_tpu_torch.bench --size-mb 256
    --json-only`` as a user runs it, within a budget: it must exit 0 with a
    last line that parses, every default arm run (``skipped_arms`` exactly
    the ``--full`` ones), ``host_roundtrip_ok``, ``dense_ok*`` and
    ``rl_ok`` true and no key that ends in ``_error`` or ``_flag`` (a run
    cut by a signal or the watchdog exits 1 with ``interrupted_error``).
    Returns the launch counts it reports (the copy probe's main path)."""
    t0 = time.perf_counter()
    env = dict(os.environ, FLRL_BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    proc = subprocess.run(
        [sys.executable, "-m", "fl_rl_compression_mpi_tpu_torch.bench",
         "--size-mb", str(BENCH_MIB), "--json-only"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=BENCH_BUDGET_S + 300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    rec = json.loads(lines[-1])
    bad = [key for key in rec if key.endswith(("_error", "_flag"))]
    bad += [key for key in BENCH_OKS if rec.get(key) is not True]
    if set(rec.get("skipped_arms", [])) != BENCH_FULL_ONLY:
        bad.append(f"skipped_arms {rec.get('skipped_arms')}")
    if bad:
        raise AssertionError(f"bench: {bad}: {lines[-1]}")
    say(f"[bench] {lines[-1]}")
    tag = "kernel launches "
    counts = [json.loads(line.split(tag, 1)[1])
              for line in proc.stderr.splitlines() if tag in line]
    if not counts or not counts[-1].get("copy_probe"):
        raise AssertionError(f"bench: the copy probe was not launched "
                             f"({counts})")
    say(f"[bench] kernel launches {json.dumps(counts[-1])}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return counts[-1]


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
        entry = re.search(r"entry function '.*?([a-z][a-z_]*_kernel)"
                          r"(?:ILi(\d+)E)?", line)
        if entry:
            name, arg = entry.groups()
            say(f"[build] {name}" + (f"<{arg}>" if arg else "") + ":")
        elif "Used" in line or "spill" in line:
            say(f"[build] {line.strip()}")
    fold = fields.host_fold_kind()
    say(f"[build] host fold: {fold}")
    if fold != "native":
        raise AssertionError(
            "the native host fold (csrc/flrlio.cpp, built with g++ at first "
            "use) is not available; the NumPy fold of a 512 MiB stream would "
            "take minutes")

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
    t0 = time.perf_counter()
    # a generator of their own, so that the streams below stay the bytes
    # earlier runs of this script timed
    classes_rng = np.random.default_rng(SEED + 1)
    cases = phase_offsets_classes(classes_rng)
    say(f"[kernels] {cases} offsets-scan inputs equal their plain version")
    cases = phase_pack_classes(classes_rng)
    say(f"[kernels] {cases} pack inputs equal their plain version, the "
        f"containers fl-cpu's ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = phase_widths_unpack_classes(np.random.default_rng(SEED + 2))
    say(f"[kernels] {cases} widths and unpack inputs equal their plain "
        f"versions ({time.perf_counter() - t0:.1f} s)")

    mixed = mixed_main_stream(rng)
    uniform4 = uniform_stream(rng, 512 * MIB, 128, 4)
    timings = time_kernels(mixed, uniform4)

    t0 = time.perf_counter()
    cases = phase_field_kernels(rng)
    say(f"[kernels] {cases} field inputs: kernels equal their plain versions "
        f"byte for byte, host-folded containers equal fl-cpu's")
    timings.update(time_field_kernels(mixed, uniform4))
    t_fields = time.perf_counter() - t0

    t0 = time.perf_counter()
    cases = phase_rl_kernels(rng, classes_rng)
    say(f"[kernels] {cases} RL inputs: kernels equal their plain versions "
        f"byte for byte")
    rl_mixed = rl_mixed_stream(rng)
    timings.update(time_rl_kernels(rl_mixed))
    t_rl = time.perf_counter() - t0
    t0 = time.perf_counter()
    cases = phase_constant_kernels()
    say(f"[kernels] {cases} constant-stream inputs: kernels equal their "
        f"plain versions byte for byte, flags equal")
    timings.update(time_constant_kernels())
    t_dist = time.perf_counter() - t0
    for name, (ms, plain) in timings.items():
        lib = LIBRARY_MS.get(name)
        say(f"[kernels] {name}: {ms:.3f} ms kernel, {plain:.3f} ms plain, "
            f"{bound_ms(name):.3f} ms bound ({MOVED[name]} bytes)"
            + (f", {lib:.3f} ms one PyTorch call" if lib is not None else "")
            + f" (512 MiB stream, median of 5 single calls); a launch over a "
            f"run of {RUN}: {LAUNCH_MS[name]:.4f} ms kernel"
            + (f", {LIBRARY_LAUNCH_MS[name]:.4f} ms PyTorch call"
               if lib is not None else ""))
    say(f"[kernels] max |err| {json.dumps(MAX_ERR)}")

    with tempfile.TemporaryDirectory() as tmp:
        phase_goldens(tmp, "dense")
        launches = phase_main(tmp, {"mixed": mixed, "uniform4": uniform4})
        t0 = time.perf_counter()
        with field_route():
            phase_goldens(tmp, "fields")
        launches.update(phase_fields_main(tmp, ("mixed", "uniform4")))
        phase_fields_variants(tmp, rng)
        t_fields += time.perf_counter() - t0
        del mixed, uniform4
        t0 = time.perf_counter()
        phase_rl_goldens(tmp)
        launches.update(phase_rl_main(tmp, rl_mixed))
        del rl_mixed
        t_rl += time.perf_counter() - t0
        t0 = time.perf_counter()
        dist_launches, walls = phase_dist(tmp)
        t_dist += time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_multihost(tmp, walls)
        t_dist += time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(phase_constant_programs())
    phase_dist_two_ranks(rng)
    t_dist += time.perf_counter() - t0
    say(f"[dist] launches of the distributed CLI runs "
        f"{json.dumps({key: v for key, v in dist_launches.items() if v})}")
    phase_chunks(rng)
    t0 = time.perf_counter()
    phase_fields_chunks(rng)
    t_fields += time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_rl_chunks(rng)
    t_rl += time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase_stream(tmp, np.random.default_rng(SEED + 8))
    say(f"[stream] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timings["copy_probe"] = phase_copy_probe(np.random.default_rng(SEED + 9))
    launches["copy_probe"] = phase_bench()["copy_probe"]
    say(f"[bench] phase took {time.perf_counter() - t0:.1f} s")
    # after every timed phase: ahead of them, the 1 GiB field encodes and
    # the plain run offsets' 16 GiB buffer (2^31 counts in int64) slowed
    # the first Compression stages of the main and field phases
    t0 = time.perf_counter()
    cases = phase_fields_encode_classes(np.random.default_rng(SEED + 4))
    t_fields += time.perf_counter() - t0
    say(f"[classes] {cases} field-encode inputs equal their plain version, "
        f"the containers fl-cpu's ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = phase_fields_decode_classes(np.random.default_rng(SEED + 6))
    t_fields += time.perf_counter() - t0
    say(f"[classes] {cases} field-decode inputs equal their plain version, "
        f"the containers fl-cpu's ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = phase_rl_offsets_classes(np.random.default_rng(SEED + 5))
    t_rl += time.perf_counter() - t0
    say(f"[classes] {cases} run-offsets inputs equal their plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    say(f"[done] field route phases took {t_fields:.1f} s, RL phases "
        f"{t_rl:.1f} s, constant kernels and distribution {t_dist:.1f} s")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": ALL_REPLACES[name], "launches": launches[name],
                "max_abs_err": MAX_ERR[name], "ms": timings[name][0],
                "plain_ms": timings[name][1], "bound_ms": bound_ms(name),
                "bound_by": "bytes", "library_ms": LIBRARY_MS.get(name),
                "launch_ms": LAUNCH_MS[name],
                "library_launch_ms": LIBRARY_LAUNCH_MS.get(name)}
               for name in ALL_REPLACES]
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-cli"]:
        sys.exit(torchrun_child(sys.argv[2]))
    sys.exit(main())
