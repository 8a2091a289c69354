#!/usr/bin/env python3
"""The distributed methods across several CUDA devices: a mesh of the cards
driven from one process, and a process group of one rank a card.

Run from the repository root on a machine with N cards:

    python3 chip_dist.py [--devices N] [--mib 512] [--rounds 3]

``chip_smoke.py`` runs the distributed path on one card (a one-device mesh,
and two shards on card 0); this script runs it on N cards:

1. single device — ``fl`` and ``rl`` through the API on card 0, the walls
   the distributed ones are compared with;
2. the mesh — ``compress_fl`` (fl-dist), ``compress_fl_ici`` (fl-ici),
   ``decompress_fl``, ``compress_rl`` and ``decompress_rl`` on a mesh of the
   N cards in this process (``dist.make_mesh``), on the 512 MiB streams of
   ``chip_smoke.py`` from the same seed (mixed, uniform4, rl_mixed),
   ``--rounds`` times each, host-clock walls; containers equal fl-cpu's
   (FL) and the concatenation of rl-cpu's per-shard containers (RL),
   outputs equal the input, every card launched its path's kernels (the
   counts by card); the constant programs on 512 MiB of 0x00 and of 0x0F
   split over the cards (bytes exact, flags clean, a flipped byte on the
   last card trips its flag alone).  Then one ``c``/``d`` of fl-dist on
   mixed under ``torch.profiler``: from the device events each card's busy
   and kernel time and how long k of the cards were busy, and ran
   kernels, at once, and each shard's walk on the host clock; and the
   rate of a 1 GiB copy from each card to card
   0 (fl-ici's gather) beside card 0's copy down to pinned host memory;
   the group path — the same functions and checks on one process group of
   N NCCL ranks spawned by ``dist.spawn_group``, timed on rank 0 between
   barriers;
3. the CLI — ``c fl-dist`` and ``d fl-dist`` at ``--devices N`` on a 64 MiB
   file, N cards driven from this process, the container equal to
   fl-cpu's;
4. torchrun — ``python -m torch.distributed.run --standalone
   --nproc-per-node N`` starts N processes, one a card, each running the
   CLI with ``--coordinator env://`` (``parallel/multihost.py``) on a
   2048 MiB file (``TORCHRUN_MIB``, the reference matrix's 2048 MB
   point): ``c fl-dist --verify`` and ``d fl-dist`` merged to rank 0
   and under ``FLRL_SHARED_FS=1``, ``c rl-dist`` and ``d rl-dist``, then
   ``--rounds`` rounds of each for walls.  The FL containers equal the
   single-card ``fl`` CLI's container of the same file, the RL container
   rl-cpu's over the sharded loads, concatenated; every output equals the
   input and every rank launched its path's kernels.  Beside them, the
   walls of one card's ``fl``/``rl`` CLI and of the one-process
   ``--devices N`` CLI (``--rounds`` rounds each) on the same files, and
   the ``--timers`` stages of one ``c`` and ``d`` of the latter (the
   process's own, and the most any card spent in each of its threads'
   stages).  Not run with ``--device cpu``.

5. the device-resident programs — the counterpart of the JAX package's
   ``__graft_entry__.dryrun_multichip`` on the mesh of the N cards: the
   sharded field encode (``dist.fl_compress_sharded``), ``fl_compress_merged``
   (every card's widths and fields gathered onto every card), the sharded
   decode, the dense and merged-dense programs and the dense decode, the
   single-width programs (their decode where no shard's flag is set), each
   on mixed and uniform4, and the RL sharded encode and decode on
   rl_mixed, on the ``--mib`` streams put on the cards by
   ``dist.shard_host_data`` (at 2048 MiB on four cards, 512 MiB a card):
   each checked against the mesh's ``compress_fl``/``compress_rl``
   containers and the input, and timed with a CUDA event pair on each
   card after a warm call (the most any card's pair spans, median of 3),
   printed with its GB/s and the host's time to enqueue it beside the
   same program's time on card 0 alone with shard 0's inputs, measured in
   the same run.  ``--programs`` runs this phase alone; otherwise it runs
   after phase 2's copy rates.

``--spawn-cli-trees DIR...`` runs phase 3 alone, once from each DIR in the
order given (a checkout of another commit beside this one, such as
``parent . . parent``, compares the two in one call): a process started in
DIR builds its kernels, then times ``c fl-dist`` and ``d fl-dist`` at
``--devices N`` through ``cli.main`` as phase 3 does.

Prints ``{"dist": {...}}`` (every wall, host clock, seconds) on the line
before the last and ``{"ok": true, "device": {...}}`` last.  ``--device
cpu`` runs the same flow with every shard on the CPU and gloo ranks to
check the script itself; its times are not device times.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as smoke
from fl_rl_compression_mpi_tpu_torch import cli, compress, decompress, fileio
from fl_rl_compression_mpi_tpu_torch.models.registry import CODECS
from fl_rl_compression_mpi_tpu_torch.ops import fl_constant_cuda as ck
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda, fl_torch
from fl_rl_compression_mpi_tpu_torch.parallel import dist
from fl_rl_compression_mpi_tpu_torch.utils import constant_byte_probe
from fl_rl_compression_mpi_tpu_torch.utils.timers import current_card

SEED = 2026
TORCHRUN_MIB = 2048    # phase 4's file size


def streams(mib: int) -> dict:
    """The 512 MiB streams of chip_smoke.py (scaled by ``mib``), the same
    bytes on every rank."""
    saved = smoke.MIB
    smoke.MIB = (mib << 20) // 512
    try:
        rng = np.random.default_rng(SEED)
        return {"mixed": smoke.mixed_main_stream(rng),
                "uniform4": smoke.uniform_stream(rng, 512 * smoke.MIB, 128,
                                                 4),
                "rl_mixed": smoke.rl_mixed_stream(rng)}
    finally:
        smoke.MIB = saved


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, group, device):
    """(result, wall seconds) of fn() on every rank, between barriers."""
    torch.distributed.barrier(group)
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    torch.distributed.barrier(group)
    return out, time.perf_counter() - t0


def _all_true(flag: bool, group) -> bool:
    got = [None] * torch.distributed.get_world_size(group)
    torch.distributed.all_gather_object(got, bool(flag), group=group)
    return all(got)


def rank_main(mib: int, rounds: int, *, group=None, device):
    """Every distributed function on this rank's group; rank 0 returns the
    walls, the checks and every rank's launch counts."""
    rank = torch.distributed.get_rank(group)
    world = torch.distributed.get_world_size(group)
    data = streams(mib)
    walls, checks = {}, {}
    smoke.reset_all_launches()
    for name, x in data.items():
        if name == "rl_mixed":
            enc = (("rl-dist", lambda: dist.compress_rl(
                x, group=group, device=device)),)
        else:
            enc = (("fl-dist", lambda: dist.compress_fl(
                x, group=group, device=device)),
                   ("fl-ici", lambda: dist.compress_fl_ici(
                       x, group=group, device=device)))
        for method, fn in enc:
            for _ in range(rounds):
                comp, t = _timed(fn, group, device)
                walls.setdefault(f"{name} {method} c, group", []).append(t)
            # every rank decodes the container rank 0 holds
            box = [comp]
            torch.distributed.broadcast_object_list(box, src=0, group=group)
            comp = box[0]
            dec = (dist.decompress_rl if name == "rl_mixed"
                   else dist.decompress_fl)
            for _ in range(rounds):
                out, t = _timed(lambda: dec(comp, group=group, device=device),
                                group, device)
                walls.setdefault(f"{name} {method} d, group", []).append(t)
            if rank == 0:
                checks[f"{name} {method}, group"] = (
                    _container_ok(name, x, comp, world)
                    and np.array_equal(out, x))
    launches = [None] * world
    torch.distributed.all_gather_object(launches, smoke.all_launches(),
                                        group=group)
    del data
    checks.update(_constant_programs(mib, group, device, rank, world))
    return (walls, checks, launches) if rank == 0 else None


def _container_ok(name: str, x: np.ndarray, comp, world: int) -> bool:
    if name != "rl_mixed":
        ref = CODECS["fl-cpu"].compress(x)
        return (np.array_equal(comp.bits, ref.bits)
                and np.array_equal(comp.values, ref.values))
    plan = dist.plan_shards(x.size, world)
    parts = [CODECS["rl-cpu"].compress(plan.shard(x, i))
             for i in range(world)]
    return (np.array_equal(comp.counts,
                           np.concatenate([p.counts for p in parts]))
            and np.array_equal(comp.values,
                               np.concatenate([p.values for p in parts])))


def _constant_programs(mib, group, device, rank, world) -> dict:
    """The device-resident constant programs, each rank's shard made on
    its card; a flipped byte on the last rank must trip every rank's
    view of the flags."""
    checks = {}
    n = mib << 20
    for c in (0x00, 0x0F):
        plan = dist.plan_shards(n, world)
        x = torch.full((int(plan.ns[rank]),), c, dtype=torch.uint8,
                       device=device)
        cb, fb = ck.host_probe_constant(np.full(ck.DENSE_UNIFORM_TILE_R * 512,
                                                c, np.uint8), n)
        smoke.reset_all_launches()
        bits, values, flags = dist.fl_compress_sharded_dense_constant(
            x, cb, fb, group=group)
        out, dflags = dist.fl_decompress_sharded_dense_constant(
            values, values.numel(), x.numel(), cb, fb, group=group)
        launched = all(ck.LAUNCHES[key] == 1 for key in ck.LAUNCHES)
        exact = (bool((bits == fb).all())
                 and bool((values == ck.pattern_byte(cb, fb)).all())
                 and bool(torch.equal(out, x)))
        if rank == world - 1:
            x[x.numel() // 2] ^= 0x40
            values[values.numel() - 1] ^= 0x01
        bad = dist.fl_compress_sharded_dense_constant(x, cb, fb,
                                                      group=group)[2]
        bad_d = dist.fl_decompress_sharded_dense_constant(
            values, values.numel(), x.numel(), cb, fb, group=group)[1]
        ok = (exact and launched and int(flags.sum()) == 0
              and int(dflags.sum()) == 0
              and bad.cpu().tolist()[-1] == 1 and int(bad.sum()) == 1
              and bad_d.cpu().tolist()[-1] == 1 and int(bad_d.sum()) == 1)
        checks[f"constant 0x{c:02X}, group"] = _all_true(ok, group)
    return checks


def mesh_main(mesh: tuple, mib: int, rounds: int) -> tuple:
    """Phase 2 on the mesh: every distributed function on the cards of
    ``mesh``, from this process; returns the walls, the checks and the
    launches by card."""
    world = len(mesh)
    data = streams(mib)
    walls, checks = {}, {}
    smoke.reset_all_launches()
    for name, x in data.items():
        if name == "rl_mixed":
            enc = (("rl-dist", dist.compress_rl, dist.decompress_rl),)
        else:
            enc = (("fl-dist", dist.compress_fl, dist.decompress_fl),
                   ("fl-ici", dist.compress_fl_ici, dist.decompress_fl))
        for method, fn, dec in enc:
            for _ in range(rounds):
                t0 = time.perf_counter()
                comp = fn(x, mesh=mesh)
                walls.setdefault(f"{name} {method} c, mesh", []).append(
                    time.perf_counter() - t0)
            for _ in range(rounds):
                t0 = time.perf_counter()
                out = dec(comp, mesh=mesh)
                walls.setdefault(f"{name} {method} d, mesh", []).append(
                    time.perf_counter() - t0)
            checks[f"{name} {method}, mesh"] = (
                _container_ok(name, x, comp, world)
                and np.array_equal(out, x))
    launches = fl_dense_cuda.launches_by("device")
    del data
    checks.update(_mesh_constant_programs(mib, mesh))
    return walls, checks, launches


def _mesh_constant_programs(mib: int, mesh: tuple) -> dict:
    """The device-resident constant programs on the mesh, each card's
    shard made on it; a flipped byte on the last card must trip its flag
    alone."""
    checks = {}
    n = mib << 20
    world = len(mesh)
    plan = dist.plan_shards(n, world)
    for c in (0x00, 0x0F):
        xs = [torch.full((int(m),), c, dtype=torch.uint8, device=dev)
              for m, dev in zip(plan.ns, mesh)]
        cb, fb = ck.host_probe_constant(np.full(ck.DENSE_UNIFORM_TILE_R * 512,
                                                c, np.uint8), n)
        smoke.reset_all_launches()
        bits, values, flags = dist.fl_compress_sharded_dense_constant(
            xs, cb, fb, mesh=mesh)
        sizes = [v.numel() for v in values]
        ns = [x.numel() for x in xs]
        out, dflags = dist.fl_decompress_sharded_dense_constant(
            values, sizes, ns, cb, fb, mesh=mesh)
        by_card = fl_dense_cuda.launches_by("device")
        launched = all(by_card.get(d.index, {}).get(key) == world
                       if d.type == "cpu" else
                       by_card.get(d.index, {}).get(key) == 1
                       for d in mesh for key in ck.LAUNCHES)
        exact = all(bool((b == fb).all())
                    and bool((v == ck.pattern_byte(cb, fb)).all())
                    and bool(torch.equal(o, x))
                    for b, v, o, x in zip(bits, values, out, xs))
        xs[-1][xs[-1].numel() // 2] ^= 0x40
        values[-1][values[-1].numel() - 1] ^= 0x01
        bad = dist.fl_compress_sharded_dense_constant(xs, cb, fb,
                                                      mesh=mesh)[2]
        bad_d = dist.fl_decompress_sharded_dense_constant(
            values, sizes, ns, cb, fb, mesh=mesh)[1]
        last = [0] * (world - 1) + [1]
        checks[f"constant 0x{c:02X}, mesh"] = (
            exact and launched and flags.tolist() == [0] * world
            and dflags.tolist() == [0] * world and bad.tolist() == last
            and bad_d.tolist() == last)
    return checks


def _cards_at_once(cards: dict) -> dict:
    """ms during which exactly k cards were busy, for k = 1 .. N, from
    each card's union of spans."""
    edges = sorted((t, d) for spans in cards.values() for a, b in spans
                   for t, d in ((a, 1), (b, -1)))
    out, busy, last = {}, 0, None
    for t, d in edges:
        if busy:
            out[busy] = out.get(busy, 0.0) + t - last
        busy, last = busy + d, t
    return {k: out[k] for k in sorted(out)}


def mesh_overlap(mesh: tuple, x: np.ndarray) -> dict:
    """One ``c`` and ``d`` of fl-dist on the mesh under ``torch.profiler``:
    from the device events, each card's busy time (ms, the union of its
    kernels' and copies' spans) and its kernel time, and the ms during
    which exactly k cards were busy, and ran kernels, at once; from the
    host clock, each shard's encode walk (ms from the call's start)."""
    from torch.profiler import ProfilerActivity, profile
    host = {}
    orig = fl_torch.encode_walk

    def walk(data, L, dev, *args, **kwargs):
        t0 = time.perf_counter()
        out = orig(data, L, dev, *args, **kwargs)
        host[current_card()] = (t0, time.perf_counter())
        return out

    fl_torch.encode_walk = walk
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            comp = dist.compress_fl(x, mesh=mesh)
            t1 = time.perf_counter()
            dist.decompress_fl(comp, mesh=mesh)
            t2 = time.perf_counter()
    finally:
        fl_torch.encode_walk = orig
    busy, kernels = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start / 1e3, e.time_range.end / 1e3)
        busy.setdefault(e.device_index, []).append(span)
        if "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.setdefault(e.device_index, []).append(span)
    busy = {i: smoke._union(v) for i, v in sorted(busy.items())}
    kernels = {i: smoke._union(v) for i, v in sorted(kernels.items())}
    return {"c wall ms": (t1 - t0) * 1e3, "d wall ms": (t2 - t1) * 1e3,
            "busy ms by card": {i: smoke._length(u) for i, u in busy.items()},
            "kernel ms by card": {i: smoke._length(u)
                                  for i, u in kernels.items()},
            "ms with k cards busy at once": _cards_at_once(busy),
            "ms with k cards in kernels at once": _cards_at_once(kernels),
            "encode walk by shard, host ms from c's start": {
                i: [(a - t0) * 1e3, (b - t0) * 1e3]
                for i, (a, b) in sorted(host.items())}}


def copy_rates(mesh: tuple, mib: int = 1024, reps: int = 5) -> dict:
    """GB/s (median of ``reps``, host clock around copies that end in a
    synchronise) of a ``mib`` MiB copy from each card to card 0, which is
    fl-ici's gather, beside card 0's copy of the same bytes down to pinned
    host memory; and whether each card can reach card 0 directly."""
    n = mib << 20
    dst = torch.empty(n, dtype=torch.uint8, device=mesh[0])
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    out = {}

    def rate(copy, devs) -> float:
        ts = []
        for _ in range(reps + 1):
            for d in devs:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            copy()
            for d in devs:
                torch.cuda.synchronize(d)
            ts.append(time.perf_counter() - t0)
        return n / float(np.median(ts[1:])) / 1e9

    for dev in mesh[1:]:
        src = torch.full((n,), 7, dtype=torch.uint8, device=dev)
        out[f"{dev} -> {mesh[0]} GB/s"] = rate(lambda: dst.copy_(src),
                                              (dev, mesh[0]))
        out[f"{dev} peer access to {mesh[0]}"] = \
            torch.cuda.can_device_access_peer(dev.index, mesh[0].index)
        del src
    out[f"{mesh[0]} -> pinned host GB/s"] = rate(lambda: pinned.copy_(dst),
                                                 (mesh[0],))
    return out


def program_ms(mesh: tuple, fn, reps: int = 3) -> tuple:
    """``(ms, host ms, out)`` of ``fn()`` on the mesh after a warm call,
    medians of ``reps``, and the last call's outputs: on cards, a CUDA
    event pair on each card's current stream around the call and the most
    any card's pair spans, and the host's time until the call returned
    (its launches enqueued, one card after another); on the CPU, the host
    clock for both."""
    cards = sorted({d for d in mesh if d.type == "cuda"}, key=str)
    out = fn()
    for d in cards:
        torch.cuda.synchronize(d)
    ts, hs = [], []
    for _ in range(reps):
        del out
        pairs = []
        for d in cards:
            with torch.cuda.device(d):
                a = torch.cuda.Event(enable_timing=True)
                a.record()
                pairs.append([a, torch.cuda.Event(enable_timing=True)])
        t0 = time.perf_counter()
        out = fn()
        hs.append((time.perf_counter() - t0) * 1e3)
        for d, pair in zip(cards, pairs):
            with torch.cuda.device(d):
                pair[1].record()
        for a, b in pairs:
            b.synchronize()
        ts.append(max(a.elapsed_time(b) for a, b in pairs) if cards
                  else hs[-1])
    return float(np.median(ts)), float(np.median(hs)), out


def phase_programs(mesh: tuple, mib: int) -> tuple:
    """The device-resident sharded programs on the cards of ``mesh``, the
    counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
    (``chip_smoke.run_sharded_fl`` on mixed and uniform4, ``run_sharded_rl``
    on rl_mixed), on the ``mib`` MiB streams put on the cards by
    ``dist.shard_host_data``.  Each result is checked against the
    one-process mesh's containers (``compress_fl`` / ``compress_rl`` on
    the same mesh) and the input (``chip_smoke.compare_sharded``).  Each
    program is timed (``program_ms``) on the N cards, and again on
    ``mesh[0]`` alone with shard 0's inputs: the same work a card, on one
    card, in this run.  Returns ``{stream: {program: [ms, host ms,
    one-card ms]}}`` and the checks ``{"stream/program": ok}``."""
    world = len(mesh)
    ms, checks = {}, {}
    for name, x in streams(mib).items():
        plan = dist.plan_shards(x.size, world)
        ns = [int(m) for m in plan.ns]
        xs = dist.shard_host_data(x, plan, mesh)
        times = ms[name] = {}

        def timed(program: str, fn):
            t, host, out = program_ms(mesh, fn)
            times[program] = [t, host]
            return out

        def one_card(program: str, fn):
            t, _, out = program_ms(mesh[:1], fn)
            times.setdefault(program, [None, None]).append(t)
            return out

        if name == "rl_mixed":
            want = dist.compress_rl(x, mesh=mesh)
            want = (want.counts, want.values)
            r = smoke.run_sharded_rl(xs, ns, mesh, timed)
            smoke.run_sharded_rl(xs[:1], ns[:1], mesh[:1], one_card)
        else:
            want = dist.compress_fl(x, mesh=mesh)
            want = (want.bits, want.values)
            r = smoke.run_sharded_fl(xs, ns, mesh, timed)
            smoke.run_sharded_fl(xs[:1], ns[:1], mesh[:1], one_card)
        bad = smoke.compare_sharded(r, xs, ns, want)
        checks.update({f"{name}/{program}": program not in bad
                       for program in r})
        del r, xs
    n = mib << 20
    clock = "CUDA events" if mesh[0].type == "cuda" else "host clock"
    for name, times in ms.items():
        for program, (t, host, *one) in times.items():
            if t is None:
                continue
            alone = f"{one[0]:.3f} ms" if one else "not run"
            print(f"[programs] {name}: {program}, {world} shard(s) on "
                  f"{mesh[0]}{' ...' if world > 1 else ''}, {mib} MiB: "
                  f"{t:.3f} ms, {n / 1e6 / t:.1f} GB/s ({clock}, median of "
                  f"3 after a warm call), the host's enqueue {host:.3f} ms; "
                  f"on {mesh[0]} alone with shard 0's inputs (the same work "
                  f"a card, this run): {alone}", flush=True)
    return ms, checks


def median_range(xs: list) -> str:
    return f"{np.median(xs):.3f} ({min(xs):.3f}-{max(xs):.3f})"


def timed_cli(*argv: str) -> float:
    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    if rc:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def timer_stages(argv: list) -> dict:
    """The CLI in this process with ``--timers``: its own stages (ms), and
    for each stage of the cards' threads the most any card spent in it
    (the sum of its lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        timed_cli(*argv, "--timers")
    whole, cards = {}, {}
    for line in out.getvalue().splitlines():
        got = re.match(r"^(?:\[card (\d+)\] )?\[TIMER\] (.+?): ([0-9.]+) ms",
                       line)
        if not got:
            continue
        card, name, ms = got.group(1), got.group(2), float(got.group(3))
        if card is None:
            whole[name] = whole.get(name, 0.0) + ms
        else:
            per = cards.setdefault(name, {})
            per[card] = per.get(card, 0.0) + ms
    return {"process": whole,
            "most of any card": {k: max(v.values()) for k, v in cards.items()}}


def phase_torchrun(world: int, mib: int, rounds: int) -> tuple:
    """The CLI under torchrun, N processes, one a card, on a ``mib`` MiB FL
    file and a ``mib`` MiB RL file (chip_smoke.py's mixed and rl_mixed
    streams, scaled); returns the walls, and the ``--timers`` stages of the
    ``--devices N`` CLI's ``c`` and ``d`` by operation."""
    saved = smoke.MIB
    smoke.MIB = (mib << 20) // 512
    try:
        rng = np.random.default_rng(SEED + 1)
        files = {"mixed": smoke.mixed_main_stream(rng),
                 "rl_mixed": smoke.rl_mixed_stream(rng)}
    finally:
        smoke.MIB = saved
    walls, stages_of = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src = {name: os.path.join(tmp, f"{name}.bin") for name in files}
        for name, data in files.items():
            data.tofile(src[name])
        one = {"mixed": os.path.join(tmp, "one.fl"),
               "rl_mixed": os.path.join(tmp, "one.rl")}
        # one card, and the N cards from this one process, each round
        for _ in range(rounds):
            for name, method in (("mixed", "fl"), ("rl_mixed", "rl")):
                for m, extra in ((method, ()),
                                 (f"{method}-dist", ("--devices",
                                                     str(world)))):
                    out = os.path.join(tmp, f"w.{m}")
                    comp = one[name] if m == method else out
                    walls.setdefault(f"{name} {m} c", []).append(
                        timed_cli("c", m, src[name], comp, *extra))
                    walls.setdefault(f"{name} {m} d", []).append(
                        timed_cli("d", m, comp, out + ".out", *extra))
        for op, argv in (("c", ["c", "fl-dist", src["mixed"],
                                os.path.join(tmp, "t.fl")]),
                         ("d", ["d", "fl-dist", os.path.join(tmp, "t.fl"),
                                os.path.join(tmp, "t.out")])):
            stages = timer_stages([*argv, "--devices", str(world)])
            print(f"[dist] --devices {world} CLI, {op} fl-dist on {mib} MiB "
                  f"mixed, --timers (ms): {json.dumps(stages)}", flush=True)
            stages_of[op] = stages
        torch.cuda.empty_cache()

        coord = ["--coordinator", "env://"]
        spec = []
        for label, env in (("merge", {}), ("sharedfs", {"FLRL_SHARED_FS":
                                                        "1"})):
            comp = os.path.join(tmp, f"mh.{label}.fl")
            spec += [[f"mixed c --verify {label}", [
                "c", "fl-dist", src["mixed"], comp, "--verify", *coord], env],
                     [f"mixed d {label}", [
                         "d", "fl-dist", comp, comp + ".out", *coord], env]]
        comp = os.path.join(tmp, "mh.rl")
        spec += [["rl_mixed c", ["c", "rl-dist", src["rl_mixed"], comp,
                                 *coord], {}],
                 ["rl_mixed d", ["d", "rl-dist", comp, comp + ".out",
                                 *coord], {}]]
        for _ in range(rounds):
            for label, env in (("merge", {}),
                               ("sharedfs", {"FLRL_SHARED_FS": "1"})):
                comp = os.path.join(tmp, f"mh.w.{label}.fl")
                spec += [[f"mixed c {label}", ["c", "fl-dist", src["mixed"],
                                              comp, *coord], env],
                         [f"mixed d {label}", ["d", "fl-dist", comp,
                                              comp + ".out", *coord], env]]
            comp = os.path.join(tmp, "mh.w.rl")
            spec += [["rl_mixed c", ["c", "rl-dist", src["rl_mixed"], comp,
                                     *coord], {}],
                     ["rl_mixed d", ["d", "rl-dist", comp, comp + ".out",
                                     *coord], {}]]
        ranks, wall = smoke.torchrun(world, spec, tmp, timeout=1800)
        for i, r in enumerate(ranks):
            print(f"[dist] torchrun rank {i}: " + ", ".join(
                f"{x['label']} {x['wall']:.3f} s" for x in r), flush=True)
        # a rank whose shard is one byte throughout takes the host closed
        # form and launches no kernel (rl_mixed's last quarter is zeros)
        plans = {name: dist.plan_shards(x.size, world)
                 for name, x in files.items()}
        got = [smoke.check_multihost_calls(r, f"torchrun rank {i}", [
            name for name, x in files.items() if constant_byte_probe(
                plans[name].shard(x, i)) is None])
            for i, r in enumerate(ranks)]
        for label in ("merge", "sharedfs"):
            comp = os.path.join(tmp, f"mh.{label}.fl")
            if not smoke.same_file(comp, one["mixed"]):
                raise AssertionError(f"torchrun, {label}: the FL container "
                                     "differs from the fl CLI's")
            if not smoke.same_file(comp + ".out", src["mixed"]):
                raise AssertionError(f"torchrun, {label}: d fl-dist did not "
                                     "restore the input")
        parts = [CODECS["rl-cpu"].compress(
            fileio.load_file_sharded(src["rl_mixed"], i, world)[0])
            for i in range(world)]
        comp = smoke.load_rl(os.path.join(tmp, "mh.rl"))
        if not (np.array_equal(comp.counts,
                               np.concatenate([p.counts for p in parts]))
                and np.array_equal(comp.values,
                                   np.concatenate([p.values for p in parts]))
                and smoke.same_file(os.path.join(tmp, "mh.rl.out"),
                                    src["rl_mixed"])):
            raise AssertionError("torchrun: the RL container differs from "
                                 "rl-cpu's over the sharded loads, or d "
                                 "rl-dist did not restore the input")
    for label, ws in got[0].items():
        if label != "destroy":
            # each round's wall is rank 0's; the first call of a label is
            # the checked one (with --verify where the label says so)
            walls[f"torchrun {label}"] = ws
    walls["torchrun destroy (max over ranks)"] = [
        max(g["destroy"][0] for g in got)]
    walls["torchrun process (whole torchrun call)"] = [wall]
    return walls, stages_of


# phase 3's calls in a process of their own, from the tree it starts in
_SPAWN_CLI = """
import json, sys, time
from fl_rl_compression_mpi_tpu_torch import cli
from fl_rl_compression_mpi_tpu_torch.ops import _build
_build.lib()
src, comp, back, world = sys.argv[1:]
walls = []
for argv in (["c", "fl-dist", src, comp], ["d", "fl-dist", comp, back]):
    t0 = time.perf_counter()
    if cli.main([*argv, "--devices", world]):
        sys.exit(1)
    walls.append(time.perf_counter() - t0)
print(json.dumps(walls))
"""


def phase_cli_trees(world: int, trees: list) -> dict:
    """Phase 3 from each of ``trees`` in turn, on the same 64 MiB file: the
    container equals fl-cpu's, the output the input; returns the walls by
    tree."""
    rng = np.random.default_rng(SEED)
    small = smoke.random_width_stream(rng, 64 * (1 << 20) + 77, 128)
    ref = CODECS["fl-cpu"].compress(small)
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, comp_path, back = (os.path.join(tmp, f) for f in
                                ("in.bin", "out.fl", "out.bin"))
        small.tofile(src)
        for tree in trees:
            for path in (comp_path, back):
                if os.path.exists(path):
                    os.remove(path)
            got = subprocess.run(
                [sys.executable, "-c", _SPAWN_CLI, src, comp_path, back,
                 str(world)], cwd=tree, capture_output=True, text=True,
                timeout=600)
            if got.returncode:
                raise AssertionError(f"{tree}: phase 3 exited "
                                     f"{got.returncode}: {got.stderr[-2000:]}")
            c, d = json.loads(got.stdout.splitlines()[-1])
            comp = smoke.load_fl(comp_path)
            if not (np.array_equal(comp.bits, ref.bits)
                    and np.array_equal(comp.values, ref.values)
                    and smoke.same_file(back, src)):
                raise AssertionError(f"{tree}: CLI fl-dist at {world} ranks: "
                                     "container or output differs")
            print(f"[dist] --devices {world} CLI from {tree}: c "
                  f"{c:.3f} s, d {d:.3f} s", flush=True)
            walls.setdefault(f"cli 64MiB fl-dist c, {tree}", []).append(c)
            walls.setdefault(f"cli 64MiB fl-dist d, {tree}", []).append(d)
    return walls


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=None,
                   help="cards (mesh shards, and ranks of the group path; "
                        "default: every card)")
    p.add_argument("--mib", type=int, default=512,
                   help="stream size in MiB (default 512)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="'cpu' checks the script on CPU shards and gloo "
                        "ranks")
    p.add_argument("--spawn-cli-trees", nargs="+", metavar="DIR",
                   default=None,
                   help="run phase 3 alone, from each DIR in turn")
    p.add_argument("--programs", action="store_true",
                   help="run phase 5 (the device-resident programs) alone")
    args = p.parse_args()
    on_cpu = args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        print("[FAIL] no CUDA device", file=sys.stderr)
        return 1
    world = args.devices or (1 if on_cpu else torch.cuda.device_count())
    one = torch.device("cpu") if on_cpu else torch.device("cuda", 0)
    rank_device = one if on_cpu else None
    if not on_cpu:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(smi, flush=True)
    kind = "cpu" if on_cpu else torch.cuda.get_device_name(0)
    print(f"[dist] {world} ranks, {kind}, torch {torch.__version__}",
          flush=True)
    t_start = time.perf_counter()
    if args.spawn_cli_trees:
        walls = phase_cli_trees(world, args.spawn_cli_trees)
        print(json.dumps({"dist": {"ranks": world, "walls": walls}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "cpu" if on_cpu else "gpu", "kind": kind,
            "count": 0 if on_cpu else torch.cuda.device_count()}}))
        return 0

    if args.programs:
        mesh = dist.make_mesh(world, rank_device)
        ms, checks = phase_programs(mesh, args.mib)
        failed = [key for key, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"failed checks {failed}")
        print(f"[programs] checks {json.dumps(checks)}; all in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"dist": {"ranks": world, "mib": args.mib,
                                   "programs ms": ms, "checks": checks}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "cpu" if on_cpu else "gpu", "kind": kind,
            "count": 0 if on_cpu else torch.cuda.device_count()}}))
        return 0

    data = streams(args.mib)
    walls = {}
    for _ in range(args.rounds):
        for name, x in data.items():
            method = "rl" if name == "rl_mixed" else "fl"
            t0 = time.perf_counter()
            comp = compress(x, method=method, device=one)
            t1 = time.perf_counter()
            decompress(comp, method=method, device=one)
            t2 = time.perf_counter()
            walls.setdefault(f"{name} {method} c", []).append(t1 - t0)
            walls.setdefault(f"{name} {method} d", []).append(t2 - t1)
    del data, comp
    if not on_cpu:
        torch.cuda.empty_cache()

    expect = (smoke.DIST_EXPECT["mixed"] + smoke.DIST_EXPECT["uniform4"]
              + smoke.DIST_EXPECT["rl_mixed"])
    mesh = dist.make_mesh(world, rank_device)
    t0 = time.perf_counter()
    mesh_walls, checks, by_card = mesh_main(mesh, args.mib, args.rounds)
    t_mesh = time.perf_counter() - t0
    walls.update(mesh_walls)
    missing = {str(d): [key for key in expect
                        if by_card.get(d.index, {}).get(key, 0) == 0]
               for d in mesh}
    overlap = mesh_overlap(mesh, streams(args.mib)["mixed"])
    print(f"[dist] mesh, c and d of fl-dist on mixed under torch.profiler: "
          f"{json.dumps(overlap)}", flush=True)
    rates = {} if on_cpu else copy_rates(mesh)
    print(f"[dist] copy rates {json.dumps(rates)}", flush=True)
    programs_ms, programs_checks = phase_programs(mesh, args.mib)
    checks.update(programs_checks)

    t0 = time.perf_counter()
    group_walls, group_checks, launches = dist.spawn_group(
        rank_main, args.mib, args.rounds, world=world, device=rank_device)
    t_group = time.perf_counter() - t0
    walls.update(group_walls)
    checks.update(group_checks)
    missing.update({f"rank {r}": [key for key in expect if ran[key] == 0]
                    for r, ran in enumerate(launches)})
    missing = {r: keys for r, keys in missing.items() if keys}
    failed = [key for key, ok in checks.items() if not ok]
    if failed or missing:
        raise AssertionError(f"failed checks {failed}, kernels not launched "
                             f"{missing}")

    rng = np.random.default_rng(SEED)
    small = smoke.random_width_stream(rng, 64 * (1 << 20) + 77, 128)
    with tempfile.TemporaryDirectory() as tmp:
        src, comp_path, back = (os.path.join(tmp, f) for f in
                                ("in.bin", "out.fl", "out.bin"))
        small.tofile(src)
        extra = ["--devices", str(world)]
        t0 = time.perf_counter()
        rc_c = cli.main(["c", "fl-dist", src, comp_path, *extra])
        t1 = time.perf_counter()
        rc_d = cli.main(["d", "fl-dist", comp_path, back, *extra])
        t2 = time.perf_counter()
        ref = CODECS["fl-cpu"].compress(small)
        comp = smoke.load_fl(comp_path)
        if (rc_c or rc_d or not np.array_equal(comp.bits, ref.bits)
                or not np.array_equal(comp.values, ref.values)
                or not smoke.same_file(back, src)):
            raise AssertionError(f"CLI fl-dist at {world} ranks: rc {rc_c}, "
                                 f"{rc_d}, or container/output differ")
    walls["cli 64MiB fl-dist c"] = [t1 - t0]
    walls["cli 64MiB fl-dist d"] = [t2 - t1]
    stages = {}
    if not on_cpu:
        tr_walls, stages = phase_torchrun(world, TORCHRUN_MIB, args.rounds)
        walls.update({f"{TORCHRUN_MIB}MiB {key}": ws
                      for key, ws in tr_walls.items()})

    for key, ws in walls.items():
        print(f"[dist] wall {key}: {median_range(ws)} s", flush=True)
    print(f"[dist] checks {json.dumps(checks)}; every card of the mesh and "
          f"every rank launched {sorted(set(expect))}; the mesh phase took "
          f"{t_mesh:.1f} s, the group's spawn and run {t_group:.1f} s; all "
          f"in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"dist": {"ranks": world, "mib": args.mib,
                               "walls": walls, "checks": checks,
                               "overlap": overlap, "copy rates": rates,
                               "programs ms": programs_ms,
                               "cli stages": stages}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "cpu" if on_cpu else "gpu", "kind": kind,
        "count": 0 if on_cpu else torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
