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
              rl_mixed at --devices 1 (a one-device mesh in this process,
              with no process group): containers equal the main phase's
              (fl-cpu's; rl's, which is rl-cpu's at one shard), round trips
              exact, the path's kernels launched in each run, no process
              group left after them; walls of each beside `fl`/`rl`, two
              rounds; a one-file CLI process (`python -m ... c fl-dist
              --devices 1` and `c fl` on mixed, a fresh process each, three
              each, in turns), process start included.  Then the mesh of
              two shards on card 0, driven from this one process (the API
              at devices=2, device=cuda:0; starting a process refused
              meanwhile): c and d of fl-dist and fl-ici on mixed and
              uniform4 and of rl-dist on rl_mixed, the counts set to 0 just
              before and read just after, by shard: containers equal
              fl-cpu's (FL) and rl-cpu's per-shard containers concatenated
              (RL), round trips exact, both shards launched their path's
              kernels, no process group and no child process after them;
              walls, two rounds, beside the same calls on one shard.  The
              device-resident constant programs on a mesh of two shards on
              card 0 over 512 MiB of 0x00 and 0x0F (bytes exact, flags
              clean, a flipped byte trips its shard's flag; the only
              launches of the constant kernels counted for the path); the
              group path on two gloo ranks spawned on card 0
              (`dist.spawn_group`; NCCL refuses two ranks on one card) over
              64 MiB: fl-ici, the FL decode, rl-dist and its decode, FL
              containers equal fl-cpu's, RL equals rl-cpu's per-shard
              containers concatenated, every rank launched its kernels.
   sharded  — the device-resident sharded programs of parallel/dist.py
              (after the RL main phase, before the dist phase), on the
              512 MiB mixed, uniform4 and rl_mixed streams put on the card
              by dist.shard_host_data, on a one-card mesh and on two shards
              on card 0: fl_compress_sharded and its decode,
              fl_compress_merged, the dense and single-width programs and
              their decodes, and rl_compress_sharded and its decode, all
              under set_sync_debug_mode("error"), then
              fl_compress_merged_dense (it reads its payload sizes back
              once): every result equals fl_torch.encode's container
              (the fields folded on the host), compress_rl's container at
              the same N, and the input; a uniform flag is raised exactly
              on the shards with another width; the RL encode's memory
              held 0xAB first, and the counts past its runs are zero; every
              kernel of the programs launched on the card, and by each of
              the two shards, every launch counted under its shard.
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
              functions in one group (`dist.spawn_group`), merged to rank 0
              in 1 MiB rounds and then under FLRL_SHARED_FS=1: FL equals
              fl-cpu's container, RL rl-cpu's per-shard containers
              concatenated, every rank launched its kernels.
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
10. lanes   — the flat-tile primitives (csrc/lanes.cu, flrl_tile_op), last:
              the nine functions tests/test_lanes.py drives through its
              Pallas harness, each once on one (8, 128) tile with that
              file's seeds, against NumPy, the counts set to 0 just before
              (9 launches: the kernel's path); then every op at rows 8, 64
              and 256 over 1 and 4096 tiles, twenty calls a case on reused
              memory (static shifts from 0 to past the tile, dynamic ones
              under set_sync_debug_mode("error") with m from 0 to N - 1,
              prefix sums that wrap, routes that drop words at the tile's
              edge and keep dist bits above nbits), element for element
              against the plain versions, from a generator of their own
              (SEED + 10); then each op on 2^14 tiles of 8 rows (64 MiB in;
              the shifts by 129) both ways beside its bound, and torch.cumsum(..., dtype=
              torch.int32) beside the prefix sum, whose times fill the
              kernel's row (every op's under its "ops" key).
11. experiments — the port's experiment entry points (package
              `experiments/`) and the kernels they run: the tile-packed
              codec (csrc/tile_packed.cu), the RL encode's starts mode, the
              flat-tile kernel's rounds op and the copy (the copy probe's
              kernel with addend 0).  First their path: exp21's and exp22's
              packed round trip, exp30's encode and decode, exp33's rounds
              and exp6's copy, each once, the counts set to 0 just before
              and read just after (each call exactly its launches), every
              output against its plain version or its input (exp21 and
              exp22 at R = 1024 on the encode's cluster route); then the
              tile-packed codec at R in {8, 64, 1024, 2048, 6144, 6152}
              (6144 the cluster route's last R, 6152 the first past it) on
              tiles of widths 0, 1, 2, 3, 4, 5 and 8 and a mixed tile (every
              depth),
              both layouts, the encode on the route R takes (each call
              counting one launch of its route's key), 3,077 tiles of 8
              rows (the cursor's look-back past many tickets, and the
              two-pass route's offsets scan past 1024 tiles), and twenty
              round trips on reused memory; the
              starts encode on exp30's five kinds at 4 MiB + 13 bytes and on
              small streams; the rounds at 8 and 512 rows; the copy on word
              counts 1, 3, 4, 5 and 2048·128, at an unaligned start and on
              64 MiB, each against its plain version, from a generator of
              their own (SEED + 11); then each timed at its script's size
              both ways beside its bound: the codec (R = 1024) on 256 MiB of
              width-4 words (its encode also at widths 1 and 8 on
              `[experiments]` lines), the starts encode on 64 MiB of
              exp30's `long`, the rounds on 32 MiB (64 rounds; bound by operations,
              int32 multiply-adds at 64 a clock an SM), the copy on 256 MiB
              beside `clone` (its library row) and `copy_`.

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
import multiprocessing
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
from fl_rl_compression_mpi_tpu_torch.fileio import load_file
from fl_rl_compression_mpi_tpu_torch.models.registry import CODECS
from fl_rl_compression_mpi_tpu_torch.ops import _build
from fl_rl_compression_mpi_tpu_torch.ops import fields
from fl_rl_compression_mpi_tpu_torch.ops import copy_probe_cuda as cpk
from fl_rl_compression_mpi_tpu_torch.ops import fl_constant_cuda as ck
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda as k
from fl_rl_compression_mpi_tpu_torch.ops import fl_fields_cuda as fk
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch
from fl_rl_compression_mpi_tpu_torch.ops import lanes_cuda as lk
from fl_rl_compression_mpi_tpu_torch.ops import rl_cuda as rk
from fl_rl_compression_mpi_tpu_torch.ops import rl_torch
from fl_rl_compression_mpi_tpu_torch.ops import tile_packed_cuda as tpk
from fl_rl_compression_mpi_tpu_torch.experiments import exp6_r2_tuning as exp6
from fl_rl_compression_mpi_tpu_torch.experiments import (
    exp21_tile_packed as exp21)
from fl_rl_compression_mpi_tpu_torch.experiments import (
    exp22_tile_packed2 as exp22)
from fl_rl_compression_mpi_tpu_torch.experiments import (
    exp30_rl_starts as exp30)
from fl_rl_compression_mpi_tpu_torch.experiments import (
    exp33_round_latency as exp33)
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
LANES_SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/lanes.cu"
LANES_REPLACES = {"tile_op": "tests/test_lanes.py:27"}
TILE_PACKED_SOURCE = "fl_rl_compression_mpi_tpu_torch/csrc/tile_packed.cu"
EXP21 = "experiments/exp21_tile_packed.py"
EXP22 = "experiments/exp22_tile_packed2.py"
EXP_REPLACES = {
    "tile_packed_encode": f"{EXP21}:166, {EXP22}:161",
    "tile_packed_decode": f"{EXP21}:226, {EXP22}:251",
    "rl_encode_starts": "experiments/exp30_rl_starts.py:197",
    "tile_rounds": "experiments/exp33_round_latency.py:54",
    "copy_words": "experiments/exp6_r2_tuning.py:83",
}
EXP_SOURCES = {"tile_packed_encode": TILE_PACKED_SOURCE,
               "tile_packed_decode": TILE_PACKED_SOURCE,
               "rl_encode_starts": RL_SOURCE, "tile_rounds": LANES_SOURCE,
               "copy_words": COPY_SOURCE}
SOURCES = {**{name: SOURCE for name in REPLACES},
           **{name: FIELDS_SOURCE for name in FIELDS_REPLACES},
           **{name: RL_SOURCE for name in RL_REPLACES},
           **{name: CONST_SOURCE for name in CONST_REPLACES},
           **{name: COPY_SOURCE for name in COPY_REPLACES},
           **{name: LANES_SOURCE for name in LANES_REPLACES},
           **EXP_SOURCES}
ALL_REPLACES = {**REPLACES, **FIELDS_REPLACES, **RL_REPLACES,
                **CONST_REPLACES, **COPY_REPLACES, **LANES_REPLACES,
                **EXP_REPLACES}
MAX_ERR = {name: 0 for name in ALL_REPLACES}
MAX_ERR["tile_packed_encode_2pass"] = 0   # the encode's route past R = 6,144
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
    bytes over the card's memory rate, or its operations over their peak
    rate where those take longer (OPS_BOUND_MS: the rounds; every other
    kernel here does a few integer operations a byte, far below the card's
    operation rate)."""
    return max(MOVED[name] / HBM_BYTES_PER_S * 1e3,
               OPS_BOUND_MS.get(name, 0.0))


def bound_by(name: str) -> str:
    return ("operations" if OPS_BOUND_MS.get(name, 0.0)
            > MOVED[name] / HBM_BYTES_PER_S * 1e3 else "bytes")


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
    missing = [name for name in RL_REPLACES if launches[name] == 0]
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
    set_stage_timers(False)     # no [TIMER] lines in this check
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
    for mod in (k, fk, rk, ck, cpk, lk, tpk):
        mod.reset_launches()


def all_launches() -> dict:
    return {**k.LAUNCHES, **fk.LAUNCHES, **rk.LAUNCHES, **ck.LAUNCHES,
            **cpk.LAUNCHES, **lk.LAUNCHES, **tpk.LAUNCHES}


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


@contextlib.contextmanager
def no_process_started():
    """Starting a process refused inside (``torch.multiprocessing``'s
    ``start_processes``, which ``dist.spawn_group`` uses); after it, no
    child process and no process group."""
    import multiprocessing
    mp = torch.multiprocessing
    saved = mp.start_processes

    def refuse(*args, **kwargs):
        raise AssertionError("a mesh run started a process")

    mp.start_processes = refuse
    try:
        yield
    finally:
        mp.start_processes = saved
    if multiprocessing.active_children() or torch.distributed.is_initialized():
        raise AssertionError("a child process or a process group outlived "
                             "the mesh runs")


def rl_shards(data: np.ndarray, shards: int) -> RLCompressed:
    """rl-cpu's containers of the FL shard plan's shards, concatenated: the
    rl-dist container at that many shards."""
    plan = dist.plan_shards(data.size, shards)
    parts = [CODECS["rl-cpu"].compress(plan.shard(data, i))
             for i in range(shards)]
    return RLCompressed(np.concatenate([p.counts for p in parts]),
                        np.concatenate([p.values for p in parts]), data.size)


def phase_dist_mesh(tmp: str) -> dict:
    """The mesh of two shards on card 0, driven from this one process, on
    the main phases' 512 MiB files: the API's fl-dist and fl-ici on mixed
    and uniform4 and rl-dist on rl_mixed at devices=2, device=cuda:0, c
    then d, with the counts set to 0 just before and read just after, by
    shard.  FL containers equal the main phase's (fl-cpu's), RL rl-cpu's
    per-shard containers concatenated, round trips exact, both shards
    launched their path's kernels, no process started.  Then walls, two
    rounds: each call on the two shards beside the same call on one
    shard.  Returns the launches of the checked runs."""
    plan = (("mixed", "fl", ("fl-dist", "fl-ici")),
            ("uniform4", "fl", ("fl-dist", "fl-ici")),
            ("rl_mixed", "rl", ("rl-dist",)))
    files = {name: load_file(os.path.join(tmp, f"{name}.bin"))
             for name, _, _ in plan}
    with no_process_started():
        reset_all_launches()
        for name, base, methods in plan:
            data = files[name]
            want = (load_fl(os.path.join(tmp, f"{name}.fl")) if base == "fl"
                    else rl_shards(data, 2))
            for m in methods:
                comp = compress(data, method=m, devices=2, device=DEVICE)
                back = decompress(comp, method=m, devices=2, device=DEVICE)
                fields = ("bits", "values") if base == "fl" else ("counts",
                                                                  "values")
                if not all(np.array_equal(getattr(comp, f), getattr(want, f))
                           for f in fields):
                    raise AssertionError(f"two shards, {m} on {name}: the "
                                         "container differs")
                if not np.array_equal(back, data):
                    raise AssertionError(f"two shards, {m} on {name}: d did "
                                         "not restore the input")
        ran = all_launches()
        shards = k.launches_by("shard")
    expect = sorted({key for name, _, _ in plan for key in DIST_EXPECT[name]})
    for i in (0, 1):
        missing = [key for key in expect if shards.get(i, {}).get(key, 0) == 0]
        if missing:
            raise AssertionError(f"two shards: shard {i} did not launch "
                                 f"{missing} ({json.dumps(shards)})")
    say(f"[dist] two shards on cuda:0 from one process, API at devices=2: "
        f"fl-dist and fl-ici equal fl-cpu's on mixed and uniform4, rl-dist "
        f"rl-cpu's per-shard containers on rl_mixed, round trips exact, no "
        f"process started and no group made; launches by shard "
        f"{json.dumps({i: shards[i] for i in (0, 1)})}")
    walls = {}
    timed_calls = (("mixed", "fl-dist"), ("mixed", "fl-ici"),
                   ("rl_mixed", "rl-dist"))
    for _ in range(2):
        for name, m in timed_calls:
            for devices in (1, 2):
                t0 = time.perf_counter()
                comp = compress(files[name], method=m, devices=devices,
                                device=DEVICE)
                t1 = time.perf_counter()
                decompress(comp, method=m, devices=devices, device=DEVICE)
                t2 = time.perf_counter()
                walls.setdefault((name, m, devices), []).append(
                    (t1 - t0, t2 - t1))
    for (name, m, devices), ws in walls.items():
        say(f"[dist] wall {name} {m}, API, {devices} shard(s) on cuda:0: c "
            f"{median_range([w[0] for w in ws])} s, d "
            f"{median_range([w[1] for w in ws])} s (median (min-max) of 2, "
            f"host clock)")
    return ran


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
    """The group path: two gloo ranks spawned on card 0 by
    ``dist.spawn_group`` (NCCL refuses two ranks on one card), 64 MiB, one
    group for fl-ici, the FL decode, rl-dist and its decode.  FL containers
    equal fl-cpu's; RL equals rl-cpu's per-shard containers concatenated;
    every rank launched the kernels of its path."""
    fl_data = random_width_stream(rng, 64 * MIB + 77, 128)
    rl_data = rl_mixed_stream(rng, 16 * MIB)
    ref = CODECS["fl-cpu"].compress(fl_data)
    t0 = time.perf_counter()
    ici, back, rl, rback, counts = dist.spawn_group(
        two_rank_cases, fl_data, rl_data, world=2, device=DEVICE,
        backend="gloo")
    t1 = time.perf_counter()
    if not (np.array_equal(ici.bits, ref.bits)
            and np.array_equal(ici.values, ref.values)):
        raise AssertionError("two ranks: fl-ici container differs from "
                             "fl-cpu's")
    want = rl_shards(rl_data, 2)
    if not (np.array_equal(rl.counts, want.counts)
            and np.array_equal(rl.values, want.values)):
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
    say(f"[dist] two gloo ranks spawned on cuda:0 (the group path), 64 MiB: "
        f"fl-ici equals fl-cpu's, rl-dist rl-cpu's per-shard containers, "
        f"round trips exact, every rank launched its kernels; "
        f"{t1 - t0:.3f} s with the spawn")


def phase_constant_programs() -> dict:
    """The device-resident constant programs on a mesh of two shards on
    card 0 (the shards made on the card), 512 MiB of 0x00 and of 0x0F: the
    clean encode and decode launched once a shard, their bytes exact and
    their flags clean; a flipped input byte in shard 1, and a flipped
    payload byte in it, trip shard 1's flag alone.  Returns the launches of
    the clean runs."""
    mesh = dist.make_mesh(2, DEVICE)
    launches = {key: 0 for key in CONST_REPLACES}
    for c in (0x00, 0x0F):
        n = 512 * MIB
        plan = dist.plan_shards(n, 2)
        xs = [torch.full((int(m),), c, dtype=torch.uint8, device=DEVICE)
              for m in plan.ns]
        cb, fb = ck.host_probe_constant(np.full(ck.DENSE_UNIFORM_TILE_R * 512,
                                                c, np.uint8), n)
        reset_all_launches()
        bits, values, flags = dist.fl_compress_sharded_dense_constant(
            xs, cb, fb, mesh=mesh)
        sizes = [v.numel() for v in values]
        ns = [x.numel() for x in xs]
        out, dflags = dist.fl_decompress_sharded_dense_constant(
            values, sizes, ns, cb, fb, mesh=mesh)
        torch.cuda.synchronize()
        ran = {key: ck.LAUNCHES[key] for key in CONST_REPLACES}
        ref = CODECS["fl-cpu"].compress(np.full(n, c, np.uint8))
        exact = (np.array_equal(torch.cat(bits).cpu().numpy(), ref.bits)
                 and np.array_equal(torch.cat(values).cpu().numpy(),
                                    ref.values)
                 and all(bool(torch.equal(o, x)) for o, x in zip(out, xs)))
        xs[1][xs[1].numel() // 2] ^= 0x40
        bad = dist.fl_compress_sharded_dense_constant(xs, cb, fb,
                                                      mesh=mesh)[2]
        values[1][values[1].numel() - 1] ^= 0x01
        bad_d = dist.fl_decompress_sharded_dense_constant(
            values, sizes, ns, cb, fb, mesh=mesh)[1]
        got = [f.tolist() for f in (flags, dflags, bad, bad_d)]
        if (not exact or got != [[0, 0], [0, 0], [0, 1], [0, 1]]
                or ran != {key: 2 for key in CONST_REPLACES}):
            raise AssertionError(f"constant programs on 0x{c:02X}: exact "
                                 f"{exact}, flags {got}, launches {ran}")
        for key, v in ran.items():
            launches[key] += v
        say(f"[dist] constant programs, two shards on cuda:0, 512 MiB of "
            f"0x{c:02X}: bytes exact, flags clean, a flipped byte trips its "
            f"shard's flag; launches {json.dumps(ran)}")
    return launches


# Each device-resident program's launches on one shard a call, by kernel
PROGRAM_LAUNCHES = {
    "fl_compress_sharded": {"fl_fields_encode": 1},
    "fl_compress_merged": {"fl_fields_encode": 1},
    "fl_decompress_sharded": {"fl_fields_decode": 1},
    "fl_compress_sharded_dense": {"fl_frame_widths": 1, "fl_frame_offsets": 1,
                                  "fl_pack": 1},
    "fl_compress_merged_dense": {"fl_frame_widths": 1, "fl_frame_offsets": 1,
                                 "fl_pack": 1},
    "fl_decompress_sharded_dense": {"fl_frame_offsets": 1, "fl_unpack": 1},
    "fl_compress_sharded_dense_uniform": {"fl_frame_widths": 1,
                                          "fl_pack_uniform": 1},
    "fl_decompress_sharded_dense_uniform": {"fl_unpack_uniform": 1},
    "rl_compress_sharded": {"rl_encode": 1},
    "rl_decompress_sharded": {"rl_offsets": 1, "rl_expand": 1},
}
SHARDED_KERNELS = sorted({key for per in PROGRAM_LAUNCHES.values()
                          for key in per})


@contextlib.contextmanager
def sync_error():
    """Every call that waits for the device raises inside (sync-debug
    "error"; it does not watch ``Event.synchronize()``)."""
    set_stage_timers(False)     # no [TIMER] lines in this check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _cat_host(parts: list, sizes: list) -> np.ndarray:
    """The first ``sizes[i]`` elements of each device tensor, concatenated
    on the host."""
    return np.concatenate([p[:int(m)].cpu().numpy()
                           for p, m in zip(parts, sizes)])


def _call(name: str, fn):
    return fn()


def run_sharded_fl(xs: list, ns: list, mesh, call=_call, fb: int = 4) -> dict:
    """Every FL program of parallel/dist.py on the shards ``xs`` (sizes
    ``ns``) over ``mesh``, in the order of the JAX package's
    ``__graft_entry__.dryrun_multichip``: {program: its outputs}.  The
    single-width programs speculate on width ``fb``; their decode runs
    only where no shard's flag is set (the flags read back between the
    two).  ``call(program, fn)`` runs each program, ``fn()``."""
    r = {}

    def run(program: str, fn):
        r[program] = call(program, fn)
        return r[program]

    bits, flds = run("fl_compress_sharded",
                     lambda: dist.fl_compress_sharded(xs, mesh=mesh))
    run("fl_compress_merged", lambda: dist.fl_compress_merged(xs, mesh=mesh))
    run("fl_decompress_sharded",
        lambda: dist.fl_decompress_sharded(flds, bits, mesh=mesh))
    dbits, dense, _ = run(
        "fl_compress_sharded_dense",
        lambda: dist.fl_compress_sharded_dense(xs, ns, mesh=mesh))
    run("fl_compress_merged_dense",
        lambda: dist.fl_compress_merged_dense(xs, ns, mesh=mesh))
    run("fl_decompress_sharded_dense",
        lambda: dist.fl_decompress_sharded_dense(dense, dbits, ns, mesh=mesh))
    _, udense, flags = run(
        "fl_compress_sharded_dense_uniform",
        lambda: dist.fl_compress_sharded_dense_uniform(xs, ns, fb,
                                                       mesh=mesh))
    if not any(flags.tolist()):
        run("fl_decompress_sharded_dense_uniform",
            lambda: dist.fl_decompress_sharded_dense_uniform(udense, ns, fb,
                                                             mesh=mesh))
    return r


def run_sharded_rl(xs: list, ns: list, mesh, call=_call) -> dict:
    """rl_compress_sharded, then rl_decompress_sharded of its runs, on the
    shards ``xs`` (sizes ``ns``) over ``mesh``: {program: its outputs}."""
    counts, values, runs = call(
        "rl_compress_sharded",
        lambda: dist.rl_compress_sharded(xs, ns, mesh=mesh))
    out = call("rl_decompress_sharded",
               lambda: dist.rl_decompress_sharded(counts, values, ns,
                                                  mesh=mesh))
    return {"rl_compress_sharded": (counts, values, runs),
            "rl_decompress_sharded": out}


def sharded_launches(r: dict) -> dict:
    """{kernel: launches} on each shard of one run of the programs in
    ``r``."""
    out: dict = {}
    for program in r:
        for key, v in PROGRAM_LAUNCHES[program].items():
            out[key] = out.get(key, 0) + v
    return out


def compare_sharded(r: dict, xs: list, ns: list, want: tuple,
                    fb: int = 4) -> list:
    """The programs of ``r`` (``run_sharded_fl``'s or ``run_sharded_rl``'s
    outputs on the shards ``xs`` of sizes ``ns``) whose results disagree
    with the host path: ``want`` is the stream's container (FL: its widths
    and payload; RL: its counts and values at the same N), every decode
    must restore its shard, the single-width flags must be set on exactly
    the shards with a frame of another width than ``fb``, and the RL
    counts past each shard's runs must be zero."""
    frames = [-(-m // 128) for m in ns]
    bad = []

    def check(program: str, ok) -> None:
        if program in r and not ok():
            bad.append(program)

    def restores(outs) -> bool:
        return all(torch.equal(o[:m], x[:m]) for o, x, m in zip(outs, xs, ns))

    if "rl_compress_sharded" in r:
        counts, values, runs = r["rl_compress_sharded"]
        n_runs = [int(t[0]) for t in runs]
        check("rl_compress_sharded",
              lambda: np.array_equal(_cat_host(counts, n_runs), want[0])
              and np.array_equal(_cat_host(values, n_runs), want[1])
              and not any(bool(c[m:].any())
                          for c, m in zip(counts, n_runs)))
        check("rl_decompress_sharded",
              lambda: restores(r["rl_decompress_sharded"]))
        return bad
    bits, flds = r["fl_compress_sharded"]

    def fields_ok() -> bool:
        folded = [fields.fold(f.cpu().numpy().view(np.uint32)[:fr * 32],
                              b[:fr].cpu().numpy(), m, 128)
                  for f, b, fr, m in zip(flds, bits, frames, ns)]
        return (np.array_equal(_cat_host(bits, frames), want[0])
                and np.array_equal(np.concatenate(folded), want[1]))

    def payload_ok(wbits, payload, sizes) -> bool:
        return (np.array_equal(_cat_host(wbits, frames), want[0])
                and np.array_equal(_cat_host(payload, sizes), want[1]))

    check("fl_compress_sharded", fields_ok)
    check("fl_compress_merged", lambda: all(
        torch.equal(bg[j], bits[j].to(bg.device))
        and torch.equal(fg[j], flds[j].to(fg.device))
        for bg, fg in zip(*r["fl_compress_merged"])
        for j in range(len(xs))))
    check("fl_decompress_sharded",
          lambda: restores(r["fl_decompress_sharded"]))
    dbits, dense, totals = r["fl_compress_sharded_dense"]
    check("fl_compress_sharded_dense", lambda: payload_ok(
        dbits, dense, [int(t[0]) for t in totals]))
    check("fl_compress_merged_dense", lambda: all(
        np.array_equal(b.cpu().numpy(), want[0])
        and np.array_equal(v.cpu().numpy(), want[1])
        and t.tolist() == [int(x[0]) for x in totals]
        for b, v, t in zip(*r["fl_compress_merged_dense"])))
    check("fl_decompress_sharded_dense",
          lambda: restores(r["fl_decompress_sharded_dense"]))
    ubits, udense, flags = r["fl_compress_sharded_dense_uniform"]
    edges = np.cumsum([0] + frames)
    misses = [int(bool((want[0][a:b] != fb).any()))
              for a, b in zip(edges[:-1], edges[1:])]
    check("fl_compress_sharded_dense_uniform", lambda: (
        flags.tolist() == misses
        and (any(misses) or payload_ok(ubits, udense,
                                       [u.numel() for u in udense]))))
    check("fl_decompress_sharded_dense_uniform",
          lambda: restores(r["fl_decompress_sharded_dense_uniform"]))
    return bad


def _no_read_back(program: str, fn):
    """``fn()`` under sync-debug "error", but for the merged dense program,
    which reads its payload sizes back once, by design."""
    if program == "fl_compress_merged_dense":
        return fn()
    with sync_error():
        return fn()


def check_sharded(name: str, data: np.ndarray, want: tuple, mesh) -> dict:
    """The FL programs (RL for ``name`` "rl_mixed") on ``data`` over
    ``mesh``, nothing read back inside them (``_no_read_back``), the RL
    encode's memory filled with a nonzero byte first; each result against
    ``want``, the host path's container (``compare_sharded``).  Returns
    the launches each shard must count (``sharded_launches``)."""
    shards = len(mesh)
    plan = dist.plan_shards(data.size, shards)
    ns = [int(m) for m in plan.ns]
    xs = dist.shard_host_data(data, plan, mesh)
    if name == "rl_mixed":
        junk = [torch.full((2 * m,), 0xAB, dtype=torch.uint8, device=DEVICE)
                for m in ns]
        del junk                # the allocator hands these blocks back
        r = run_sharded_rl(xs, ns, mesh, _no_read_back)
    else:
        r = run_sharded_fl(xs, ns, mesh, _no_read_back)
    torch.cuda.synchronize()
    bad = compare_sharded(r, xs, ns, want)
    if bad:
        raise AssertionError(f"sharded programs, {shards} shard(s), {name}: "
                             f"{bad}")
    say(f"[sharded] {name}, {shards} shard(s) on cuda:0: {', '.join(r)} "
        f"equal the host path's container and restore the input; no "
        f"read-back inside them"
        + ("" if name == "rl_mixed" else
           f" (uniform flags "
           f"{r['fl_compress_sharded_dense_uniform'][2].tolist()})")
        + ("; zero counts past the runs on memory that held 0xAB"
           if name == "rl_mixed" else ""))
    return sharded_launches(r)


def phase_sharded_programs(streams: dict) -> dict:
    """The device-resident sharded programs of parallel/dist.py on the
    512 MiB main-path streams, on a one-card mesh and on two shards on
    card 0, driven from this process: every result equal to the host
    path's bytes (fl_torch.encode's container, compress_rl's at the same
    N, the input); the host path's containers made before the counts are
    set to 0, so that the counts are the programs' alone, and every kernel
    of the programs launched on each shard exactly as often as its
    programs' calls launch it (``PROGRAM_LAUNCHES``), on the card and, on
    two shards, under each shard.  Returns the launches by shard of the
    two-shard run."""
    want = {name: fl_torch.encode(streams[name], device=DEVICE)
            for name in ("mixed", "uniform4")}
    for shards in (1, 2):
        mesh = dist.make_mesh(shards, DEVICE)
        rl = dist.compress_rl(streams["rl_mixed"], mesh=mesh)
        want["rl_mixed"] = (rl.counts, rl.values)
        reset_all_launches()
        expect: dict = {}
        for name in ("mixed", "uniform4", "rl_mixed"):
            for key, v in check_sharded(name, streams[name], want[name],
                                        mesh).items():
                expect[key] = expect.get(key, 0) + v
        card = k.launches_by("device").get(0, {})
        by_shard = k.launches_by("shard")
        bad = []
        if sorted(expect) != SHARDED_KERNELS:
            bad.append(f"kernels not run: "
                       f"{sorted(set(SHARDED_KERNELS) - set(expect))}")
        if card != {key: v * shards for key, v in expect.items()}:
            bad.append(f"on the card {json.dumps(card)}")
        if shards == 2:
            bad += [f"shard {i}: {json.dumps(by_shard.get(i))}"
                    for i in (0, 1) if by_shard.get(i) != expect]
        if bad:
            raise AssertionError(f"sharded programs, {shards} shard(s): "
                                 f"launches {bad}, each shard must launch "
                                 f"{json.dumps(expect)}")
        per = {i: by_shard.get(i) for i in (0, 1)}
        say(f"[sharded] {shards} shard(s) on cuda:0: launches on the card "
            f"{json.dumps(card)}, each shard's exactly its programs' "
            f"{json.dumps(expect)}"
            + (f", by shard {json.dumps(per)}" if shards == 2 else ""))
    return by_shard


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
    two_walls, counts = dist.spawn_group(
        multihost_two_ranks, fl_src, rl_src, out, world=2, device=DEVICE,
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


# ---------------------------------------------------------------------------
# Flat-tile primitives (csrc/lanes.cu)
# ---------------------------------------------------------------------------

LANES_ROWS = (8, 64, 256)
LANES_TILE_COUNTS = (1, 4096)
LANES_CALLS = 20                   # calls a case, on reused memory
LANES_TIMED_TILES = 1 << 14        # 8-row tiles: 64 MiB of int32 in
LANES_TIMED_M = 129
LANES_OPS_MS: dict = {}            # op -> its times on the timed tiles
# the harness's first seven calls, in order (lanes_harness)
OPS_HARNESS = ("shift_down", "shift_up", "shift_up_dyn", "shift_down_dyn",
               "prefix_max", "prefix_sum", "suffix_min")


def lanes_harness() -> int:
    """The path ``flrl_tile_op`` serves: the nine functions that
    tests/test_lanes.py drives through its Pallas harness, each once
    through its wrapper on one (8, 128) tile on the card, with that file's
    seeds and one of its parameters each, held against NumPy as that file
    holds them.  The counts are set to 0 just before and read just after;
    returns the launches."""
    N = 8 * 128

    def tile(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.int32)
                                ).reshape(8, 128).to(DEVICE)

    def rng(seed: int):
        return np.random.default_rng(seed)

    x1 = rng(1).integers(0, 1 << 20, N)
    x2 = rng(2).integers(0, 1 << 20, N)
    x3 = rng(3).integers(0, 1 << 20, N)
    xmax = rng(3).integers(-1000, 1000, N)
    xsum = rng(4).integers(0, 100, N)
    xmin = rng(5).integers(-1000, 1000, N)
    g = rng(7)
    keep = g.random(N) < 0.3
    keep[0] = True
    cpay = g.integers(0, 1 << 16, N)
    cdist = np.where(keep, np.arange(N) - (np.cumsum(keep) - 1), 0)
    g = rng(11)
    targets = np.sort(g.choice(N, 300, replace=False))
    epay = g.integers(0, 1 << 16, N)
    edist = np.zeros(N, np.int64)
    edist[:300] = targets - np.arange(300)
    elive = np.arange(N) < 300
    m_dev = torch.tensor([129], dtype=torch.int32, device=DEVICE)
    inputs = [tile(a) for a in (x1, x2, x3, xmax, xsum, xmin)]
    cw = lk.pack_route(tile(keep) != 0, tile(cdist), tile(cpay))
    ew = lk.pack_route(tile(elive) != 0, tile(edist), tile(epay))
    torch.cuda.synchronize()
    lk.reset_launches()
    outs = [lk.flat_shift_down(inputs[0], 4, -7),
            lk.flat_shift_up(inputs[1], 384, -3),
            lk.flat_shift_up_dyn(inputs[2], m_dev, -3),
            lk.flat_shift_down_dyn(inputs[2], m_dev, -7),
            lk.prefix_max_flat(inputs[3]), lk.prefix_sum_flat(inputs[4]),
            lk.suffix_min_flat(inputs[5]), lk.compact_lsb(cw, 10),
            lk.expand_msb(ew, 10)]
    launches = lk.LAUNCHES["tile_op"]
    got = [o.cpu().numpy().reshape(-1).astype(np.int64) for o in outs]
    want = [np.concatenate([x1[4:], np.full(4, -7)]),
            np.concatenate([np.full(384, -3), x2[:N - 384]]),
            np.concatenate([np.full(129, -3), x3[:N - 129]]),
            np.concatenate([x3[129:], np.full(129, -7)]),
            np.maximum.accumulate(xmax), np.cumsum(xsum),
            np.minimum.accumulate(xmin[::-1])[::-1]]
    for name, a, b in zip(OPS_HARNESS, got, want):
        if not np.array_equal(a, b):
            raise AssertionError(f"lanes harness: {name} differs from NumPy")
    K = int(keep.sum())
    c = got[7]
    if not (np.array_equal(c[:K] & 0xFFFF, cpay[keep]) and (c[:K] < 0).all()
            and (c[K:] >= 0).all()):
        raise AssertionError("lanes harness: compact differs from NumPy")
    e = got[8]
    if not (np.array_equal(e[targets] & 0xFFFF, epay[:300])
            and np.array_equal(np.flatnonzero(e < 0), targets)):
        raise AssertionError("lanes harness: expand differs from NumPy")
    return launches


def lanes_words(gen, tiles: int, rows: int) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, (tiles, rows, 128),
                         generator=gen, dtype=torch.int64,
                         device=DEVICE).to(torch.int32)


def lanes_nbits(rows: int) -> int:
    """One bit more than a tile's distances need, up to the cap."""
    return min(lk.MAX_NBITS, (rows * 128).bit_length())


def lanes_routes(gen, tiles: int, rows: int) -> tuple:
    """Route words on the routes' domain, ``(compact input, expand input,
    nbits)``: each tile at a density of its own; compaction distances
    p − (live words before p) and expansion distances target − i, each
    plus an offset of 0..7 a tile, so that the first (last) words leave
    the tile, where nbits leaves the room; random bits above nbits in the
    dist field (which the routes keep); random payloads."""
    n = rows * 128
    nbits = lanes_nbits(rows)
    spare = nbits > (n - 1).bit_length()
    shape = (tiles, n)
    kw = {"generator": gen, "device": DEVICE}
    p = torch.arange(n, device=DEVICE)
    offset = (torch.randint(0, 8, (tiles, 1), **kw) if spare
              else torch.zeros((tiles, 1), dtype=torch.int64, device=DEVICE))
    high = (torch.randint(0, 1 << (lk.MAX_NBITS - nbits), shape, **kw)
            << nbits)
    pay = torch.randint(0, 1 << 16, shape, **kw)

    def dens():
        return torch.rand(shape, **kw) < torch.rand((tiles, 1), **kw)

    keep = dens()
    dist = p - (keep.cumsum(1) - 1) + offset
    cw = lk.pack_route(keep, dist | high, pay)
    hit = dens()
    i = hit.cumsum(1) - 1
    t_idx, target = hit.nonzero(as_tuple=True)
    ew = torch.zeros(shape, dtype=torch.int32, device=DEVICE)
    src = i[t_idx, target]
    ew[t_idx, src] = lk.pack_route(
        torch.ones_like(src, dtype=torch.bool),
        (target - src + offset[t_idx, 0]) | high[t_idx, src],
        pay[t_idx, src])
    return (cw.view(tiles, rows, 128), ew.view(tiles, rows, 128), nbits)


def lanes_calls(x, cw, ew, nbits: int, m_dev, ms: tuple) -> dict:
    """op -> (kernel call, plain call), each taking the call's index c: the
    static shifts walk the amounts ``ms``, the dynamic ones the rows of
    ``m_dev``, the scans their fills."""
    fills = (-7, 0, 123456, lk.I32MIN, lk.I32MAX)
    return {
        "shift_down": (lambda c: lk.flat_shift_down(x, ms[c % len(ms)], -7),
                       lambda c: lk.flat_shift_down_ref(x, ms[c % len(ms)],
                                                        -7)),
        "shift_up": (lambda c: lk.flat_shift_up(x, ms[c % len(ms)], -3),
                     lambda c: lk.flat_shift_up_ref(x, ms[c % len(ms)], -3)),
        "shift_down_dyn": (lambda c: lk.flat_shift_down_dyn(x, m_dev[c], -7),
                           lambda c: lk.flat_shift_down_dyn_ref(
                               x, m_dev[c], -7)),
        "shift_up_dyn": (lambda c: lk.flat_shift_up_dyn(x, m_dev[c], -3),
                         lambda c: lk.flat_shift_up_dyn_ref(x, m_dev[c], -3)),
        "prefix_max": (lambda c: lk.prefix_max_flat(x, fills[c % 5]),
                       lambda c: lk.prefix_max_flat_ref(x, fills[c % 5])),
        "prefix_sum": (lambda c: lk.prefix_sum_flat(x),
                       lambda c: lk.prefix_sum_flat_ref(x)),
        "suffix_min": (lambda c: lk.suffix_min_flat(x, fills[c % 5]),
                       lambda c: lk.suffix_min_flat_ref(x, fills[c % 5])),
        "compact": (lambda c: lk.compact_lsb(cw, nbits),
                    lambda c: lk.compact_lsb_ref(cw, nbits)),
        "expand": (lambda c: lk.expand_msb(ew, nbits),
                   lambda c: lk.expand_msb_ref(ew, nbits)),
    }


def phase_lanes_classes(gen) -> int:
    """Every op at rows 8, 64 and 256 over 1 and 4096 tiles, LANES_CALLS
    calls a case on reused memory (each result compared, then freed), the
    dynamic shifts under sync-debug "error" with m from 0 to N − 1.  The
    prefix sums wrap (full-range words); the routes drop words at the
    tile's edge and keep the dist bits above nbits (lanes_routes)."""
    cases = 0
    for rows in LANES_ROWS:
        n = rows * 128
        for tiles in LANES_TILE_COUNTS:
            x = lanes_words(gen, tiles, rows)
            cw, ew, nbits = lanes_routes(gen, tiles, rows)
            m_dev = torch.randint(0, n, (LANES_CALLS, 1), generator=gen,
                                  device=DEVICE).to(torch.int32)
            m_dev[0], m_dev[1] = 0, n - 1
            ms = (0, 1, 4, 127, 128, 129, n // 2 + 3, n - 1, n, n + 5)
            for op, (kernel, plain) in lanes_calls(
                    x, cw, ew, nbits, m_dev, ms).items():
                for c in range(LANES_CALLS):
                    if op.endswith("_dyn"):
                        with sync_error():
                            got = kernel(c)
                    else:
                        got = kernel(c)
                    compare("tile_op", got, plain(c))
                    del got
                    cases += 1
            del x, cw, ew, m_dev
    torch.cuda.empty_cache()
    return cases


def time_lanes(gen) -> tuple:
    """Each op on LANES_TIMED_TILES tiles of 8 rows (the shifts, static and
    dynamic, by LANES_TIMED_M), both ways, beside its bound (each word read
    once and written once) and its plain version;
    ``torch.cumsum(..., dtype=torch.int32)`` beside the prefix sum.  The
    prefix sum's numbers fill tile_op's row of the kernels line; every
    op's go to LANES_OPS_MS.  Returns ``(kernel ms, plain ms)`` of the
    prefix sum."""
    T, rows = LANES_TIMED_TILES, 8
    n = rows * 128
    x = lanes_words(gen, T, rows)
    cw, ew, nbits = lanes_routes(gen, T, rows)
    m_dev = torch.full((1, 1), LANES_TIMED_M, dtype=torch.int32,
                       device=DEVICE)
    calls = lanes_calls(x, cw, ew, nbits, m_dev, (LANES_TIMED_M,))
    bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    for op, (kernel, plain) in calls.items():
        compare("tile_op", kernel(0), plain(0))
        ms = {"ms": cuda_ms(lambda: kernel(0)),
              "launch_ms": launch_ms(lambda: kernel(0)),
              "plain_ms": cuda_ms(lambda: plain(0)), "bound_ms": bound}
        LANES_OPS_MS[op] = ms
        say(f"[kernels] tile_op {op}: {ms['ms']:.4f} ms kernel, "
            f"{ms['plain_ms']:.4f} ms plain, {bound:.4f} ms bound "
            f"({2 * x.numel() * 4} bytes; {T} tiles of {rows} rows, median "
            f"of 5 single calls); a launch over a run of {RUN}: "
            f"{ms['launch_ms']:.4f} ms")
    flat = x.view(T, n)
    out = lk.prefix_sum_flat(x)
    moved("tile_op", x, out)
    LAUNCH_MS["tile_op"] = LANES_OPS_MS["prefix_sum"]["launch_ms"]
    library_ms("tile_op", lambda: torch.cumsum(flat, 1, dtype=torch.int32))
    LANES_OPS_MS["prefix_sum"]["library_ms"] = LIBRARY_MS["tile_op"]
    LANES_OPS_MS["prefix_sum"]["library_launch_ms"] = \
        LIBRARY_LAUNCH_MS["tile_op"]
    say(f"[kernels] tile_op prefix_sum yardstick torch.cumsum(x.view({T}, "
        f"{n}), 1, dtype=torch.int32): {LIBRARY_MS['tile_op']:.4f} ms "
        f"single (median of 5), {LIBRARY_LAUNCH_MS['tile_op']:.4f} ms a "
        f"launch over a run of {RUN}")
    timing = (LANES_OPS_MS["prefix_sum"]["ms"],
              LANES_OPS_MS["prefix_sum"]["plain_ms"])
    del x, cw, ew, flat, out
    torch.cuda.empty_cache()
    return timing


def phase_lanes() -> tuple:
    """The lanes phase: the harness's path (its launches), the classes,
    then the times.  Returns ``(launches, (kernel ms, plain ms))``."""
    t0 = time.perf_counter()
    launches = lanes_harness()
    if launches != 9:
        raise AssertionError(f"lanes harness: {launches} tile_op launches, "
                             f"expected 9")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 10)
    cases = phase_lanes_classes(gen)
    say(f"[lanes] harness: 9 functions equal NumPy, {launches} launches; "
        f"{cases} calls equal their plain versions element for element")
    timing = time_lanes(gen)
    say(f"[lanes] phase took {time.perf_counter() - t0:.1f} s")
    return launches, timing


# ---------------------------------------------------------------------------
# Experiment entry points (phase 11): csrc/tile_packed.cu, the RL encode's
# starts mode, the flat-tile kernel's rounds op and the copy
# ---------------------------------------------------------------------------

# 6144 the cluster route's last R (csrc/tile_packed.cuh's cluster_fits),
# 6152 the first past it
EXP_R = (8, 64, 1024, 2048, 6144, 6152)
# a tile's widths (tile_words): 0 all zero bytes, b random bytes of width b,
# "mix" a width-1 tile with one frame of width 3
EXP_TILE_KINDS = ("0", "1", "2", "3", "4", "5", "8", "mix")
EXP_DEPTHS = [3, 3, 2, 1, 1, 0, 0, 1]
EXP_CALLS = 20                     # calls on reused memory
EXP_PACKED_MIB = 256               # exp21 / exp22's N
EXP_PACKED_R = 1024                # their parity tile and first chain's
EXP_RL_MIB = 64                    # exp30's pair
EXP_RL_PARITY = 4 * MIB + 13       # exp30's parity streams
EXP_ROUNDS_MIB = 32                # exp33's N
EXP_COPY_MIB = 256                 # exp6's N
# int32 multiply-adds a second on the H100 SXM: 64 a clock an SM (the
# CUDA C++ Programming Guide's throughput table, compute capability 9.0)
# on 132 SMs at the 1.98 GHz maximum boost clock
INT32_MAD_PER_S = 64 * 132 * 1.98e9
OPS_BOUND_MS: dict = {}            # name -> operations over their peak rate
EXP_SCAN_TILES = 3 * 1024 + 5      # past the offsets scan's 1024-tile step


def tile_words(gen, R: int, kinds=EXP_TILE_KINDS) -> torch.Tensor:
    """int32 words (tiles·R, 128) on the card, one tile of each kind."""
    tiles = []
    for kind in kinds:
        if kind == "0":
            t = torch.zeros((R, 512), dtype=torch.uint8, device=DEVICE)
        elif kind == "mix":
            t = torch.randint(0, 2, (R, 512), generator=gen, device=DEVICE,
                              dtype=torch.uint8)
            t[0, :128] = torch.randint(0, 8, (128,), generator=gen,
                                       device=DEVICE, dtype=torch.uint8)
            t[0, 0] = 4
        else:
            b = int(kind)
            t = torch.randint(0, 1 << b, (R, 512), generator=gen,
                              device=DEVICE, dtype=torch.uint8)
            t[-1, -1] = 1 << (b - 1)
        tiles.append(t)
    return torch.cat(tiles).view(torch.int32).view(-1, 128)


def many_tiles(gen, R: int, tiles: int) -> torch.Tensor:
    """int32 words (tiles·R, 128) on the card, each tile of a random width
    in 0, 1, 2, 3, 4, 5, 8, so the tiles' row counts vary."""
    widths = torch.tensor((0, 1, 2, 3, 4, 5, 8), device=DEVICE)
    b = widths[torch.randint(0, 7, (tiles, 1), generator=gen, device=DEVICE)]
    t = torch.randint(0, 256, (tiles, R * 512), generator=gen, device=DEVICE,
                      dtype=torch.int32) & ((1 << b) - 1)
    return t.to(torch.uint8).view(torch.int32).view(-1, 128)


def check_tile_packed(words: torch.Tensor, R: int, layout: str,
                      two_pass: bool = False) -> None:
    """Encode (on the route R takes, or with ``two_pass`` on the two-pass
    route at any R) and decode against their plain versions: widths,
    offsets, the packed rows the layout defines, and the round trip; the
    encode counts one launch of its route's key and nothing else."""
    name = tpk.ROUTE_KEYS["2pass" if two_pass else tpk.route_of(R)]
    before = all_launches()
    bits, packed, offs = (tpk._encode_2pass if two_pass else tpk.encode)(
        words, R, layout)
    got = {key: v - before[key] for key, v in all_launches().items()
           if v != before[key]}
    if got != {name: 1}:
        raise AssertionError(f"tile_packed: R={R} launched {got}, not "
                             f"{name}")
    want_b, want_p, want_o = tpk.encode_ref(words, R, layout)
    compare(name, bits, want_b)
    if layout == "cursor":
        compare(name, offs, want_o)
    rows = tpk.defined_rows(want_b, R, want_o)
    compare(name, packed[rows], want_p[rows])
    out = tpk.decode(bits, packed, R, offs)
    compare("tile_packed_decode", out, tpk.decode_ref(bits, packed, R, offs))
    compare("tile_packed_decode", out, words)


def check_starts(x: torch.Tensor) -> None:
    """The starts encode against its plain version (the pieces before the
    total) and its decode against the stream."""
    packed, total = rk.encode_starts(x)
    want_p, want_t = rk.encode_starts_ref(x)
    compare("rl_encode_starts", total, want_t)
    R = int(want_t)
    compare("rl_encode_starts", packed[:R], want_p[:R])
    if not torch.equal(rl_torch.decode_starts(packed, total, x.numel()), x):
        raise AssertionError("decode_starts differs from the stream")


def experiments_path(gen) -> dict:
    """The path these kernels serve: each experiment entry point once, at
    its script's size (exp21's and exp22's packed round trip at R = 1024 on
    256 MiB of width-4 words, exp30's encode and decode on 64 MiB of
    exp30's ``long`` kind, exp33's rounds on 32 MiB, exp6's copy on
    256 MiB), every output held against its plain version or the input.
    The counts are set to 0 just before and read just after; each call
    must count exactly its own launches (exp21 and exp22: the encode's
    cluster route, ``tile_packed_encode``).  Returns the counts."""
    words = torch.randint(0, 16, (EXP_PACKED_MIB * MIB,), generator=gen,
                          device=DEVICE, dtype=torch.uint8).view(torch.int32)
    nrows = words.numel() // 128
    host = exp30.gen(10, EXP_RL_MIB * MIB, "long")
    x30 = torch.from_numpy(host).to(DEVICE)
    x33 = torch.randint(-(1 << 31), 1 << 31,
                        (EXP_ROUNDS_MIB * MIB // 512, 128), generator=gen,
                        dtype=torch.int64, device=DEVICE).to(torch.int32)

    def exp30_pair():
        packed, total = exp30.rl_encode_v2(x30.view(-1, 128), host.size)
        return exp30.rl_decode_packed_v2(packed, total, host.size)

    pair = {"tile_packed_encode": 1, "tile_packed_decode": 1}
    calls = (
        ("exp21", lambda: exp21.make_packed_rt(EXP_PACKED_R, nrows)(words, 1),
         pair),
        ("exp22", lambda: exp22.make_packed_rt(EXP_PACKED_R, nrows)(words, 1),
         pair),
        ("exp30", exp30_pair,
         {"rl_encode_starts": 1, "rl_offsets": 1, "rl_expand": 1}),
        ("exp33", lambda: exp33.make(8, x33.shape[0], 1)(x33, 1),
         {"tile_rounds": 1}),
        ("exp6", lambda: exp6.copy_words(words), {"copy_words": 1}),
    )
    torch.cuda.synchronize()
    reset_all_launches()
    outs = {}
    for name, call, want in calls:
        before = all_launches()
        outs[name] = call()
        got = {key: v - before[key] for key, v in all_launches().items()
               if v != before[key]}
        if got != want:
            raise AssertionError(f"experiments path: {name} launched {got}, "
                                 f"expected {want}")
    torch.cuda.synchronize()
    launches = {key: v for key, v in all_launches().items() if v}
    for name in ("exp21", "exp22"):
        if not torch.equal(outs[name].view(-1), words):
            raise AssertionError(f"{name}: the packed round trip differs")
    if not np.array_equal(outs["exp30"].cpu().numpy(), host):
        raise AssertionError("exp30: the starts round trip differs")
    compare("tile_rounds", outs["exp33"], lk.rounds_ref(x33, exp33.D))
    compare("copy_words", outs["exp6"].view(-1), words)
    del words, x30, x33, outs
    torch.cuda.empty_cache()
    return launches


def phase_experiments_classes(gen, rng) -> int:
    """Each new kernel against its plain version: the tile-packed codec at
    R in EXP_R on tiles of widths 0, 1, 2, 3, 4, 5 and 8 and a mixed tile
    (every depth), both layouts, the encode on the route R takes (6152 the
    two-pass one), then EXP_SCAN_TILES tiles of 8 rows and random widths
    (the cursor layout's look-back carries its sum past many tickets; the
    two-pass route, reached through ``tpk._encode_2pass``, carries its
    offsets scan past 1024 tiles), then EXP_CALLS round trips on
    reused memory; the starts encode on exp30's five kinds at 4 MiB + 13 bytes
    and on small streams; the rounds at 8 and 512 rows (0, 1 and 64
    rounds); the copy on word counts 1, 3, 4, 5 and 2048·128, at an
    unaligned start, and on 64 MiB."""
    cases = 0
    for R in EXP_R:
        words = tile_words(gen, R)
        for layout in tpk.LAYOUTS:
            check_tile_packed(words, R, layout)
            cases += 1
        if tpk.depths(tpk.encode(words, R)[0], R).tolist() != EXP_DEPTHS:
            raise AssertionError(f"tile_packed: R={R} missed a depth")
    if tpk.route_of(EXP_R[-2]) != "cluster" or tpk.route_of(EXP_R[-1]) != \
            "2pass":
        raise AssertionError("tile_packed: EXP_R no longer straddles the "
                             "cluster route's limit")
    words = many_tiles(gen, 8, EXP_SCAN_TILES)
    for layout in tpk.LAYOUTS:
        for two_pass in (False, True):
            check_tile_packed(words, 8, layout, two_pass)
            cases += 1
    words = tile_words(gen, 64, EXP_TILE_KINDS * 4)
    for c in range(EXP_CALLS):
        # another order of the tiles each call, each result freed first
        check_tile_packed(words.roll(64 * (c + 1), 0).contiguous(), 64,
                          tpk.LAYOUTS[c % 2])
        cases += 1
    for kind, seed in exp30.KINDS:
        check_starts(torch.from_numpy(exp30.gen(seed, EXP_RL_PARITY,
                                                kind)).to(DEVICE))
        cases += 1
    for n in (1, 255, 256, 259, 16384 + 1):
        check_starts(torch.from_numpy(exp30.gen(n, n, "cap")).to(DEVICE))
        cases += 1
    for rows in (8, 512):
        x = torch.randint(-(1 << 31), 1 << 31, (rows, 128), generator=gen,
                          dtype=torch.int64, device=DEVICE).to(torch.int32)
        for d in (0, 1, exp33.D):
            compare("tile_rounds", lk.rounds(x, d), lk.rounds_ref(x, d))
            cases += 1
    for nw in COPY_WORDS:
        w = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, nw,
                                          dtype=np.int64).astype(np.int32))
        w = w.to(DEVICE)
        compare("copy_words", cpk.copy(w), cpk.copy_ref(w))
        compare("copy_words", cpk.copy(w[1:]), w[1:])
        cases += 2
    w = torch.randint(-(1 << 31), 1 << 31, (16 * MIB,), generator=gen,
                      dtype=torch.int64, device=DEVICE).to(torch.int32)
    compare("copy_words", cpk.copy(w), w)
    del words, w
    torch.cuda.empty_cache()
    return cases + 1


def time_pair(name: str, kernel, plain, nbytes: int, check) -> tuple:
    """Both times of the kernel and the plain version's single call, after
    ``check(kernel(), plain())`` has held the two outputs against each
    other on the same inputs; records the bytes its call must move."""
    check(kernel(), plain())
    MOVED[name] = nbytes
    return kernel_ms(name, kernel), cuda_ms(plain)


def time_tile_packed_widths(gen, R: int, layout: str) -> None:
    """The tile-packed encode at widths 1 and 8 (the kernels line holds
    width 4) on 256 MiB of words, a launch over a run of RUN and a single
    call beside its bound, its output first held against the plain
    version's."""
    name = tpk.ROUTE_KEYS[tpk.route_of(R)]
    for b in (1, 8):
        words = torch.randint(0, 1 << b, (EXP_PACKED_MIB * MIB,),
                              generator=gen, device=DEVICE,
                              dtype=torch.uint8).view(torch.int32).view(-1,
                                                                        128)
        want_b, want_p, want_o = tpk.encode_ref(words, R, layout)
        rows = tpk.defined_rows(want_b, R, want_o)
        nbytes = (words.numel() * 4 + want_b.numel() + rows.numel() * 512
                  + want_o.numel() * 4)
        got = tpk.encode(words, R, layout)
        compare(name, got[0], want_b)
        compare(name, got[2], want_o)
        compare(name, got[1][rows], want_p[rows])
        del got, want_b, want_p, want_o, rows
        fn = lambda: tpk.encode(words, R, layout)  # noqa: E731
        a, c = launch_ms(fn), cuda_ms(fn)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        say(f"[experiments] tile_packed_encode width {b} ({layout}, R = {R}, "
            f"256 MiB, {tpk.route_of(R)} route; bound {bound:.4f} ms, "
            f"{nbytes} bytes): {a:.4f} ms a launch over a run of {RUN}, "
            f"{c:.4f} single, {bound / a:.3f} of the bound a launch; output "
            f"equals the plain version's")
        del words
        torch.cuda.empty_cache()


def time_experiments(gen) -> dict:
    """Each new kernel at its script's size, both ways, beside its bound
    and its plain version, whose output it must equal there: the
    tile-packed encode and decode (cursor layout, R = 1024) on 256 MiB of
    width-4 words (exp21's first chain; the bound counts this run's packed
    rows), the starts encode on 64 MiB of exp30's ``long``, the rounds on
    32 MiB (64 rounds), the copy on 256 MiB beside ``clone`` (its library
    row) and ``copy_``; the encode also at widths 1 and 8
    (``time_tile_packed_widths``).  The exp21 and exp22 mains time the
    round trips at each width and the sparse layout."""
    timings = {}
    N = EXP_PACKED_MIB * MIB
    R = EXP_PACKED_R
    layout = "cursor"
    words = torch.randint(0, 16, (N,), generator=gen, device=DEVICE,
                          dtype=torch.uint8).view(torch.int32).view(-1, 128)
    bits, packed, offs = tpk.encode(words, R, layout)
    # words in (out), widths, offsets and this run's packed rows
    nbytes = (N + bits.numel() + int(tpk.tile_rows(bits, R).sum()) * 512
              + offs.numel() * 4)

    def check_encode(got, want):
        compare("tile_packed_encode", got[0], want[0])
        compare("tile_packed_encode", got[2], want[2])
        rows = tpk.defined_rows(want[0], R, want[2])
        compare("tile_packed_encode", got[1][rows], want[1][rows])

    def check_decode(got, want):
        compare("tile_packed_decode", got, want)
        compare("tile_packed_decode", got, words)

    timings["tile_packed_encode"] = time_pair(
        "tile_packed_encode", lambda: tpk.encode(words, R, layout),
        lambda: tpk.encode_ref(words, R, layout), nbytes, check_encode)
    timings["tile_packed_decode"] = time_pair(
        "tile_packed_decode", lambda: tpk.decode(bits, packed, R, offs),
        lambda: tpk.decode_ref(bits, packed, R, offs), nbytes, check_decode)
    del words, bits, packed, offs
    torch.cuda.empty_cache()
    time_tile_packed_widths(gen, R, layout)
    host = exp30.gen(10, EXP_RL_MIB * MIB, "long")
    x = torch.from_numpy(host).to(DEVICE)
    _, total = rk.encode_starts(x)

    def check_starts_out(got, want):
        compare("rl_encode_starts", got[1], want[1])
        T = int(want[1])
        compare("rl_encode_starts", got[0][:T], want[0][:T])

    timings["rl_encode_starts"] = time_pair(
        "rl_encode_starts", lambda: rk.encode_starts(x),
        lambda: rk.encode_starts_ref(x), x.numel() + 4 * int(total),
        check_starts_out)
    del x
    rows = EXP_ROUNDS_MIB * MIB // 512
    y = torch.randint(0, 1 << 30, (rows, 128), generator=gen,
                      dtype=torch.int64, device=DEVICE).to(torch.int32)
    timings["tile_rounds"] = time_pair(
        "tile_rounds", lambda: lk.rounds(y, exp33.D),
        lambda: lk.rounds_ref(y, exp33.D), 2 * y.numel() * 4,
        lambda got, want: compare("tile_rounds", got, want))
    OPS_BOUND_MS["tile_rounds"] = y.numel() * exp33.D / INT32_MAD_PER_S * 1e3
    del y
    w = torch.randint(0, 16, (EXP_COPY_MIB * MIB,), generator=gen,
                      device=DEVICE, dtype=torch.uint8).view(torch.int32)
    out = torch.empty_like(w)

    def check_copy(got, want):
        compare("copy_words", got, want)
        compare("copy_words", got, w)

    timings["copy_words"] = time_pair(
        "copy_words", lambda: cpk.copy(w), lambda: cpk.copy_ref(w),
        2 * w.numel() * 4, check_copy)
    library_ms("copy_words", lambda: w.clone())
    copy_ms = (cuda_ms(lambda: out.copy_(w)), launch_ms(lambda: out.copy_(w)))
    del w, out
    torch.cuda.empty_cache()
    for name, (ms, plain) in timings.items():
        lib = LIBRARY_MS.get(name)
        say(f"[experiments] {name}: {ms:.4f} ms kernel, {plain:.4f} ms "
            f"plain, {bound_ms(name):.4f} ms bound ({bound_by(name)}; "
            f"{MOVED[name]} bytes)"
            + (f", {lib:.4f} ms clone" if lib is not None else "")
            + f" (median of 5 single calls); a launch over a run of {RUN}: "
            f"{LAUNCH_MS[name]:.4f} ms kernel"
            + (f", {LIBRARY_LAUNCH_MS[name]:.4f} ms clone"
               if lib is not None else "")
            + "; its output equals the plain version's")
    say(f"[experiments] copy_words beside copy_: {copy_ms[0]:.4f} ms single, "
        f"{copy_ms[1]:.4f} ms a launch over a run of {RUN}")
    return timings


def phase_experiments() -> tuple:
    """The experiments phase: the entry points' path (its launches), the
    classes, then the times.  Returns ``(launches, timings)``."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 11)
    launches = experiments_path(gen)
    cases = phase_experiments_classes(gen, np.random.default_rng(SEED + 11))
    say(f"[experiments] path: launches {json.dumps(launches)}; {cases} "
        f"calls equal their plain versions")
    timings = time_experiments(gen)
    say(f"[experiments] phase took {time.perf_counter() - t0:.1f} s")
    return launches, timings


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
        t0 = time.perf_counter()
        phase_rl_goldens(tmp)
        launches.update(phase_rl_main(tmp, rl_mixed))
        t_rl += time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_sharded_programs({"mixed": mixed, "uniform4": uniform4,
                                "rl_mixed": rl_mixed})
        say(f"[sharded] phase took {time.perf_counter() - t0:.1f} s")
        t_dist += time.perf_counter() - t0
        del mixed, uniform4, rl_mixed
        t0 = time.perf_counter()
        dist_launches, walls = phase_dist(tmp)
        mesh_launches = phase_dist_mesh(tmp)
        t_dist += time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_multihost(tmp, walls)
        t_dist += time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(phase_constant_programs())
    phase_dist_two_ranks(rng)
    t_dist += time.perf_counter() - t0
    say(f"[dist] launches of the distributed CLI runs "
        f"{json.dumps({key: v for key, v in dist_launches.items() if v})}; "
        f"of the two-shard mesh runs "
        f"{json.dumps({key: v for key, v in mesh_launches.items() if v})}")
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
    launches["tile_op"], timings["tile_op"] = phase_lanes()
    exp_launches, exp_timings = phase_experiments()
    launches.update({name: exp_launches[name] for name in EXP_REPLACES})
    timings.update(exp_timings)
    say(f"[done] field route phases took {t_fields:.1f} s, RL phases "
        f"{t_rl:.1f} s, constant kernels and distribution {t_dist:.1f} s")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": ALL_REPLACES[name], "launches": launches[name],
                "max_abs_err": MAX_ERR[name], "ms": timings[name][0],
                "plain_ms": timings[name][1], "bound_ms": bound_ms(name),
                "bound_by": bound_by(name), "library_ms": LIBRARY_MS.get(name),
                "launch_ms": LAUNCH_MS[name],
                "library_launch_ms": LIBRARY_LAUNCH_MS.get(name),
                **({"ops": LANES_OPS_MS} if name in LANES_REPLACES else {})}
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
