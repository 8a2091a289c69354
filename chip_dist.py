#!/usr/bin/env python3
"""The distributed methods across several CUDA devices, one rank a card.

Run from the repository root on a machine with N cards:

    python3 chip_dist.py [--devices N] [--mib 512] [--rounds 3]

``chip_smoke.py`` runs the distributed path at one NCCL rank (a machine
with one card); this script runs it at N ranks over NCCL:

1. single device — ``fl`` and ``rl`` through the API on card 0, the walls
   the distributed ones are compared with;
2. one process group of N spawned ranks (``dist.run_collective``), each
   making the 512 MiB streams of ``chip_smoke.py`` from the same seed:
   ``compress_fl`` (fl-dist), ``compress_fl_ici`` (fl-ici),
   ``decompress_fl``, ``compress_rl`` and ``decompress_rl`` on the mixed,
   uniform4 and rl_mixed streams, ``--rounds`` times each, timed on rank 0
   between barriers; containers equal fl-cpu's (FL) and the concatenation
   of rl-cpu's per-shard containers (RL), outputs equal the input, every
   rank launched its path's kernels; then the constant programs on 512 MiB
   of 0x00 and of 0x0F split over the ranks (bytes exact, flags clean, a
   flipped byte on the last rank trips each flag);
3. the CLI — ``c fl-dist`` and ``d fl-dist`` at ``--devices N`` on a 64 MiB
   file: N ranks spawned by the CLI, the container equal to fl-cpu's;
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
   walls of one card's ``fl``/``rl`` CLI (``--rounds`` rounds) and of the
   CLI's spawned ``--devices N`` (once) on the same files.  Not run with
   ``--device cpu``.

``--spawn-cli-trees DIR...`` runs phase 3 alone, once from each DIR in the
order given (a checkout of another commit beside this one, such as
``parent . . parent``, compares the two in one call): a process started in
DIR builds its kernels, then times ``c fl-dist`` and ``d fl-dist`` at
``--devices N`` through ``cli.main`` as phase 3 does.

Prints ``{"dist": {...}}`` (every wall, host clock, seconds) on the line
before the last and ``{"ok": true, "device": {...}}`` last.  ``--device
cpu`` runs the same flow on gloo ranks on the CPU to check the script
itself; its times are not device times.
"""

from __future__ import annotations

import argparse
import json
import os
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
from fl_rl_compression_mpi_tpu_torch.parallel import dist
from fl_rl_compression_mpi_tpu_torch.utils import constant_byte_probe

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
                walls.setdefault(f"{name} {method} c", []).append(t)
            # every rank decodes the container rank 0 holds
            box = [comp]
            torch.distributed.broadcast_object_list(box, src=0, group=group)
            comp = box[0]
            dec = (dist.decompress_rl if name == "rl_mixed"
                   else dist.decompress_fl)
            for _ in range(rounds):
                out, t = _timed(lambda: dec(comp, group=group, device=device),
                                group, device)
                walls.setdefault(f"{name} {method} d", []).append(t)
            if rank == 0:
                checks[f"{name} {method}"] = (_container_ok(name, x, comp,
                                                            world)
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
        checks[f"constant 0x{c:02X}"] = _all_true(ok, group)
    return checks


def median_range(xs: list) -> str:
    return f"{np.median(xs):.3f} ({min(xs):.3f}-{max(xs):.3f})"


def timed_cli(*argv: str) -> float:
    t0 = time.perf_counter()
    rc = cli.main(list(argv))
    if rc:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def phase_torchrun(world: int, mib: int, rounds: int) -> dict:
    """The CLI under torchrun, N processes, one a card, on a ``mib`` MiB FL
    file and a ``mib`` MiB RL file (chip_smoke.py's mixed and rl_mixed
    streams, scaled); returns the walls."""
    saved = smoke.MIB
    smoke.MIB = (mib << 20) // 512
    try:
        rng = np.random.default_rng(SEED + 1)
        files = {"mixed": smoke.mixed_main_stream(rng),
                 "rl_mixed": smoke.rl_mixed_stream(rng)}
    finally:
        smoke.MIB = saved
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = {name: os.path.join(tmp, f"{name}.bin") for name in files}
        for name, data in files.items():
            data.tofile(src[name])
        one = {"mixed": os.path.join(tmp, "one.fl"),
               "rl_mixed": os.path.join(tmp, "one.rl")}
        # one card each round; the spawned ranks once, their spawn alone
        # takes seconds, and only where shared memory holds the input
        # they are handed and the container (the input's size again)
        shm = os.statvfs("/dev/shm")
        spawn = shm.f_bavail * shm.f_frsize >= 2 * (mib << 20)
        if not spawn:
            print(f"[dist] torchrun phase: the spawned --devices {world} CLI "
                  f"not measured: /dev/shm has "
                  f"{shm.f_bavail * shm.f_frsize} bytes free", flush=True)
        for r in range(rounds):
            for name, method in (("mixed", "fl"), ("rl_mixed", "rl")):
                for m, extra in ((method, ()),
                                 (f"{method}-dist", ("--devices",
                                                     str(world)))):
                    if m != method and (r or not spawn):
                        continue
                    out = os.path.join(tmp, f"w.{m}")
                    comp = one[name] if m == method else out
                    walls.setdefault(f"{name} {m} c", []).append(
                        timed_cli("c", m, src[name], comp, *extra))
                    walls.setdefault(f"{name} {m} d", []).append(
                        timed_cli("d", m, comp, out + ".out", *extra))
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
    return walls


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


def phase_spawn_cli(world: int, trees: list) -> dict:
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
            print(f"[dist] spawned --devices {world} CLI from {tree}: c "
                  f"{c:.3f} s, d {d:.3f} s", flush=True)
            walls.setdefault(f"cli 64MiB fl-dist c, {tree}", []).append(c)
            walls.setdefault(f"cli 64MiB fl-dist d, {tree}", []).append(d)
    return walls


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=None,
                   help="ranks, one card each (default: every card)")
    p.add_argument("--mib", type=int, default=512,
                   help="stream size in MiB (default 512)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="'cpu' checks the script on gloo ranks")
    p.add_argument("--spawn-cli-trees", nargs="+", metavar="DIR",
                   default=None,
                   help="run phase 3 alone, from each DIR in turn")
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
        walls = phase_spawn_cli(world, args.spawn_cli_trees)
        print(json.dumps({"dist": {"ranks": world, "walls": walls}}))
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

    t0 = time.perf_counter()
    group_walls, checks, launches = dist.run_collective(
        rank_main, args.mib, args.rounds, devices=world, device=rank_device)
    t_group = time.perf_counter() - t0
    walls.update(group_walls)
    expect = (smoke.DIST_EXPECT["mixed"] + smoke.DIST_EXPECT["uniform4"]
              + smoke.DIST_EXPECT["rl_mixed"])
    missing = {r: [key for key in expect if ran[key] == 0]
               for r, ran in enumerate(launches)}
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
    if not on_cpu:
        walls.update({f"{TORCHRUN_MIB}MiB {key}": ws for key, ws in
                      phase_torchrun(world, TORCHRUN_MIB,
                                     args.rounds).items()})

    for key, ws in walls.items():
        print(f"[dist] wall {key}: {median_range(ws)} s", flush=True)
    print(f"[dist] checks {json.dumps(checks)}; every rank launched "
          f"{sorted(set(expect))}; the group's spawn and run took "
          f"{t_group:.1f} s; all in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"dist": {"ranks": world, "mib": args.mib,
                               "walls": walls, "checks": checks}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "cpu" if on_cpu else "gpu", "kind": kind,
        "count": 0 if on_cpu else torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
