"""Distributed FL and RL over a ``torch.distributed`` process group.

Counterpart of ``fl_rl_compression_mpi_tpu/parallel/dist.py``.  The
reference runs one MPI rank a GPU and gathers to rank 0 (MPI point to
point, ``reference/src/fl/fl_gpu.cu:41-74``) or all-gathers the
payloads with a max-padded ``ncclAllGather`` (``fl_gpu.cu:76-287``).  The
JAX package folds both into one SPMD program over a device mesh; here, as in
the reference, each rank is a process that owns one device, and the
functions below are collective over a process group (the default group when
``group`` is None):

* the split is :func:`plan_shards`, the reference's rule ``chunk = (S //
  (L·N))·L`` with the last shard taking the remainder (``file_io.cu:46-51``),
  in 64-bit arithmetic.  Every rank passes the same host input and takes
  its own shard;
* each rank encodes or decodes its shard through the single-device chunk
  walks (``fl_torch.encode_walk``/``decode_walk``, ``rl_torch``'s), on the
  route ``FLRL_NO_DENSE`` selects, exactly as on one GPU;
* ``fl-dist`` (:func:`compress_fl`): each rank's widths and exact payload go
  to the host and then to rank 0 in rank order.  Shard boundaries are
  frame-aligned, so the concatenation is the single-device container;
* ``fl-ici`` (:func:`compress_fl_ici`): an all-gather of the sizes, then an
  all-gather on the device of each rank's widths and payload, padded to the
  largest rank's; every rank builds the container;
* :func:`decompress_fl`: the host closed forms first (constant container,
  all-8 widths); else each rank decodes its shard's frames from its slice of
  the payload, found from the widths by one cumsum, and the outputs go to
  rank 0;
* :func:`compress_rl` / :func:`decompress_rl`: per-shard runs over the same
  plan (a run that crosses a shard boundary splits, so the container depends
  on N); decode splits the run list evenly over the ranks;
* :func:`fl_compress_sharded_dense_constant` /
  :func:`fl_decompress_sharded_dense_constant`: the device-resident
  constant-stream programs, each rank's flag gathered to every rank.

Collectives take tensors on :func:`comm_device`: the rank's CUDA device
under NCCL, the CPU under gloo.  The backend is the group's; nothing
switches it.  Functions that gather to rank 0 return None on the other
ranks.  :func:`run_collective` runs one of them on an existing default
group, at one rank with no group at all, or on spawned ranks.

With ``group`` None and no default group, a function runs as rank 0 of a
world of one: every collective helper returns its input, or its one-rank
equivalent, and no process group is made.  A one-rank call leaves no
state in the caller's process, as the JAX package leaves none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from ..container import FLCompressed, RLCompressed
from ..ops import fl_constant_cuda as ckern
from ..ops import fl_dense_cuda, fl_torch, rl_torch
from ..ops.bitpack import FRAME_LENGTH
from ..utils import constant_byte_probe
from ..utils.timers import stage


class ShardPlan(NamedTuple):
    """Host-side split of an input into frame-aligned shards (the
    reference's ``loadFileMpi`` split, ``file_io.cu:46-51``)."""
    num_shards: int
    ns: np.ndarray           # i64[num_shards] bytes per shard

    @property
    def starts(self) -> np.ndarray:
        """i64[num_shards] offset of each shard in the input."""
        return np.concatenate([[0], np.cumsum(self.ns)[:-1]]).astype(
            np.int64)

    def shard(self, data: np.ndarray, i: int) -> np.ndarray:
        start = int(self.starts[i])
        return data[start:start + int(self.ns[i])]


def plan_shards(total: int, num_shards: int,
                frame_length: int = FRAME_LENGTH) -> ShardPlan:
    """Every shard but the last takes ``(total // (L·N))·L`` bytes, the last
    the rest; with fewer than L·N bytes every shard but the last is
    empty."""
    chunk = (total // (frame_length * num_shards)) * frame_length
    ns = np.full(num_shards, chunk, np.int64)
    ns[-1] = total - chunk * (num_shards - 1)
    return ShardPlan(num_shards, ns)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _no_group(group) -> bool:
    """True where a function runs with no process group: ``group`` None
    and no default group, so this process is rank 0 of a world of one."""
    return group is None and not (dist.is_available()
                                  and dist.is_initialized())


def _rank_world(group) -> tuple[int, int]:
    if _no_group(group):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def comm_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the current CUDA
    device under NCCL, the CPU under any other backend (gloo).  With no
    group, the rank's own device: the current CUDA device where there is
    one, else the CPU."""
    if _no_group(group):
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else torch.device("cpu"))
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _all_gather_ints(values: list[int], group) -> np.ndarray:
    """i64[world, len(values)]: every rank's ``values``, in rank order."""
    _, world = _rank_world(group)
    if world == 1:
        return np.asarray(values, np.int64).reshape(1, -1)
    t = torch.tensor(values, dtype=torch.int64, device=comm_device(group))
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).cpu().numpy()


def _gather_to_rank0(arrays: list[np.ndarray], group):
    """Every rank's u8 host ``arrays`` on rank 0, in rank order (a list per
    rank); None on the other ranks.  Sizes first (an all-gather), then one
    send a non-empty array, the reference's gather to rank 0.  The sends
    and receives go as one batch on the group's own communicator: NCCL
    would make a two-rank communicator for each unbatched pair."""
    rank, world = _rank_world(group)
    if world == 1:
        return [list(arrays)]
    sizes = _all_gather_ints([a.size for a in arrays], group)
    comm = comm_device(group)
    with stage("Gather to rank 0", int(sizes[1:].sum())):
        if rank == 0:
            got = [[torch.empty(int(n), dtype=torch.uint8, device=comm)
                    for n in sizes[r]] for r in range(1, world)]
            ops = [dist.P2POp(dist.irecv, t, _global_rank(group, r), group)
                   for r, ts in enumerate(got, 1) for t in ts if t.numel()]
        else:
            ops = [dist.P2POp(dist.isend, fl_torch._host_tensor(a).to(comm),
                              _global_rank(group, 0), group)
                   for a in arrays if a.size]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if rank != 0:
            return None
        return [list(arrays)] + [[t.cpu().numpy() for t in ts]
                                 for ts in got]


def _cat(parts: list[np.ndarray]) -> np.ndarray:
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _all_gather_payloads(bits_d: torch.Tensor, values_d: torch.Tensor,
                         group):
    """``(bits, values)`` of every rank in rank order, on every rank: an
    all-gather of the sizes (the reference's ``MPI_Allgather`` of sizes,
    ``fl_gpu.cu:101-106``), then one all-gather on the communication device
    of each rank's widths and payload in one buffer padded to the largest
    rank's (``fl_gpu.cu:144-194``).  One rank: its own widths and payload,
    copied to the host."""
    rank, world = _rank_world(group)
    if world == 1:
        with stage("Copy results to CPU", bits_d.numel() + values_d.numel()):
            return bits_d.cpu().numpy(), values_d.cpu().numpy()
    sizes = _all_gather_ints([bits_d.numel(), values_d.numel()], group)
    width = int(sizes.sum(1).max())
    comm = comm_device(group)
    moved = []
    with stage("All-gather payloads", width * world, result=moved):
        buf = torch.empty(width, dtype=torch.uint8, device=comm)
        nb, nv = (int(x) for x in sizes[rank])
        buf[:nb].copy_(bits_d)
        buf[nb:nb + nv].copy_(values_d)
        gathered = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(gathered, buf, group=group)
        moved += gathered
    bits = np.empty(int(sizes[:, 0].sum()), np.uint8)
    values = np.empty(int(sizes[:, 1].sum()), np.uint8)
    with stage("Copy results to CPU", bits.size + values.size):
        ob = ov = 0
        for g, (nb, nv) in zip(gathered, sizes.tolist()):
            torch.from_numpy(bits[ob:ob + nb]).copy_(g[:nb])
            torch.from_numpy(values[ov:ov + nv]).copy_(g[nb:nb + nv])
            ob, ov = ob + nb, ov + nv
    return bits, values


# ---------------------------------------------------------------------------
# FL
# ---------------------------------------------------------------------------

def _fl_closed_form(data: np.ndarray, frame_length: int):
    """The whole-stream host closed forms of the JAX package's
    ``compress_fl`` (``parallel/dist.py:529-539``): the empty container, and
    the constant container with no device work, since the merge of N
    constant shards is the constant container."""
    fl_dense_cuda.check_frame_length(frame_length)
    n = data.size
    if n == 0:
        return FLCompressed(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0)
    c = constant_byte_probe(data)
    if c is None:
        return None
    with stage("Compression", n):
        return FLCompressed(*fl_torch._constant_container(c, n, frame_length),
                            n)


def compress_fl(data, frame_length: int = FRAME_LENGTH, *, group=None,
                device) -> FLCompressed | None:
    """``fl-dist``: the container of ``data`` on rank 0, byte-identical to
    the single-device encode; None on the other ranks."""
    data = np.asarray(data, np.uint8).reshape(-1)
    rank, world = _rank_world(group)
    comp = _fl_closed_form(data, frame_length)
    if comp is None:
        plan = plan_shards(data.size, world, frame_length)
        bits, values = fl_torch.encode_walk(plan.shard(data, rank),
                                            frame_length, device)
        parts = _gather_to_rank0([bits, values], group)
        if parts is None:
            return None
        comp = FLCompressed(_cat([p[0] for p in parts]),
                            _cat([p[1] for p in parts]), data.size)
    return comp if rank == 0 else None


def compress_fl_ici(data, frame_length: int = FRAME_LENGTH, *, group=None,
                    device) -> FLCompressed:
    """``fl-ici``: as :func:`compress_fl`, but the shards' outputs stay on
    the device and are all-gathered there; every rank returns the
    container."""
    data = np.asarray(data, np.uint8).reshape(-1)
    rank, world = _rank_world(group)
    comp = _fl_closed_form(data, frame_length)
    if comp is None:
        plan = plan_shards(data.size, world, frame_length)
        bits_d, values_d = fl_torch.encode_walk(
            plan.shard(data, rank), frame_length, device, to_host=False)
        comp = FLCompressed(*_all_gather_payloads(bits_d, values_d, group),
                            data.size)
    return comp


def decompress_fl(comp, frame_length: int = FRAME_LENGTH, *, group=None,
                  device) -> np.ndarray | None:
    """The decoded bytes on rank 0, None on the other ranks.  Each rank
    decodes the frames of its shard of the output; the container is
    checked on every rank before any device work, as ``fl_torch.decode``
    checks it."""
    fl_dense_cuda.check_frame_length(frame_length)
    rank, world = _rank_world(group)
    n = int(comp.input_size)
    bits = np.asarray(comp.bits, np.uint8).reshape(-1)
    values = np.asarray(comp.values, np.uint8).reshape(-1)
    out = (np.zeros(0, np.uint8) if n == 0 else
           fl_torch.decode_closed_form(n, bits, values, frame_length))
    if out is None:
        widths, voffs = fl_torch.container_layout(n, bits, values.size,
                                                  frame_length)
        plan = plan_shards(n, world, frame_length)
        f0 = int(plan.starts[rank]) // frame_length
        f1 = f0 + -(-int(plan.ns[rank]) // frame_length)
        mine = fl_torch.decode_walk(
            int(plan.ns[rank]), widths[f0:f1],
            values[voffs[f0]:voffs[f1]], voffs[f0:f1 + 1] - voffs[f0],
            frame_length, device)
        parts = _gather_to_rank0([mine], group)
        if parts is None:
            return None
        out = _cat([p[0] for p in parts])
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# RL
# ---------------------------------------------------------------------------

def compress_rl(data, *, group=None, device) -> RLCompressed | None:
    """``rl-dist``: each rank's runs of its shard of the FL shard plan (L =
    128), concatenated in rank order on rank 0; None on the other ranks.
    Equal to ``rl-cpu``'s container of each shard, concatenated."""
    data = np.asarray(data, np.uint8).reshape(-1)
    rank, world = _rank_world(group)
    if data.size == 0:
        comp = RLCompressed(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0)
    else:
        plan = plan_shards(data.size, world, FRAME_LENGTH)
        counts, values = rl_torch.encode_walk(plan.shard(data, rank), device)
        parts = _gather_to_rank0([counts, values], group)
        if parts is None:
            return None
        comp = RLCompressed(_cat([p[0] for p in parts]),
                            _cat([p[1] for p in parts]), data.size)
    return comp if rank == 0 else None


def decompress_rl(comp, *, group=None, device) -> np.ndarray | None:
    """The decoded bytes on rank 0, None on the other ranks.  Run
    boundaries are not shard-aligned, so the run list is split evenly over
    the ranks; each decodes its runs and the outputs go to rank 0."""
    rank, world = _rank_world(group)
    counts = np.asarray(comp.counts, np.uint8).reshape(-1)
    values = np.asarray(comp.values, np.uint8).reshape(-1)
    if counts.size != values.size:
        raise ValueError("rl decode: corrupt container (counts/values size "
                         f"mismatch: {counts.size} != {values.size})")
    if counts.size == 0:
        out = np.zeros(0, np.uint8)
    else:
        per = -(-counts.size // world)
        lo = min(rank * per, counts.size)
        hi = min(lo + per, counts.size)
        mine = rl_torch.decode_walk(counts[lo:hi], values[lo:hi], device)
        parts = _gather_to_rank0([mine], group)
        if parts is None:
            return None
        out = _cat([p[0] for p in parts])
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# Device-resident constant-stream programs
# ---------------------------------------------------------------------------

def _all_gather_flag(flag: torch.Tensor, group) -> torch.Tensor:
    """i32[world]: every rank's flag, in rank order (one rank: its own)."""
    _, world = _rank_world(group)
    if world == 1:
        return flag
    t = flag.to(comm_device(group))
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t, group=group)
    return torch.cat(out)


def fl_compress_sharded_dense_constant(shard: torch.Tensor, cbyte: int,
                                       fb: int, *, group=None):
    """Per-shard constant-stream encode (TPU kernel #5 on every rank):
    ``shard`` is this rank's u8 bytes on its device, speculated all
    ``cbyte`` at width ``fb`` (the caller probes with
    ``fl_constant_cuda.host_probe_constant``).  Returns this rank's ``(bits,
    values)`` on its device and ``flags`` i32[world], every rank's flag, on
    every rank.  The flags are authoritative: a nonzero flag on any rank
    means the outputs are junk and the caller re-runs the uniform or
    general encode (``compress_fl``).  The host API takes the closed form
    instead; this is the device-resident pipeline's path."""
    bits, values, flag = ckern.encode_constant(shard, cbyte, fb)
    return bits, values, _all_gather_flag(flag, group)


def fl_decompress_sharded_dense_constant(values: torch.Tensor,
                                         values_size: int, n: int,
                                         cbyte: int, fb: int, *,
                                         group=None):
    """Per-shard constant-stream decode (TPU kernel #6 on every rank):
    this rank's payload slice ``values`` (at least ``values_size`` bytes, on
    its device) verified against the pattern, and its ``n`` output bytes of
    ``cbyte``.  Returns ``(out, flags)``, the flags as on encode."""
    out, flag = ckern.decode_constant(values, values_size, cbyte, fb, n)
    return out, _all_gather_flag(flag, group)


# ---------------------------------------------------------------------------
# Running a collective function
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _process_group(backend: str, init_file: str, world: int, rank: int,
                  device: torch.device):
    """This process as ``rank`` of a ``world``-rank default group that
    meets at ``init_file`` (a file store), on ``device``; destroyed on
    exit."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + init_file,
                            world_size=world, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _map_arrays(x, fn):
    """``x`` with every array in it (NumPy or torch, also inside
    containers, tuples and lists) replaced by ``fn(array)``."""
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_arrays(getattr(x, f.name), fn)
            for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_map_arrays(v, fn) for v in x)
    return x


def _to_shared(a: np.ndarray) -> torch.Tensor:
    """A copy of ``a`` in shared memory, passed to spawned ranks by
    handle."""
    a = np.ascontiguousarray(a)
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    t = torch.empty(a.shape, dtype=dtype)
    t.share_memory_()
    t.numpy()[...] = a
    return t


def _rank_main(rank: int, world: int, init_file: str, backend: str,
               device: torch.device | None, fn: Callable, args: tuple,
               results) -> None:
    dev = torch.device("cuda", rank) if device is None else device
    args = _map_arrays(args, lambda t: t.numpy())
    with _process_group(backend, init_file, world, rank, dev):
        out = fn(*args, group=None, device=dev)
        if rank == 0:
            results.put(out)


def _spawn(fn: Callable, args: tuple, world: int,
           device: torch.device | None, backend: str):
    mp = torch.multiprocessing
    results = mp.get_context("spawn").SimpleQueue()
    shared = _map_arrays(args, _to_shared)
    with tempfile.TemporaryDirectory() as tmp:
        procs = mp.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "rendezvous"),
                              backend, device, fn, shared, results),
            nprocs=world, join=False, start_method="spawn")
        try:
            while results.empty():
                if procs.join(timeout=0.05):
                    raise RuntimeError("rank 0 ended without a result")
            out = results.get()
            while not procs.join():
                pass
        except ProcessException as e:
            raise RuntimeError(f"a rank failed: {e}") from e
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return out


def release_kept_group() -> None:
    """Does nothing.  A one-rank :func:`run_collective` call makes no
    process group, so there is none to release, and a default group that
    anyone else made is left alone.  Kept for callers of earlier versions,
    which kept a one-rank group across calls."""


def run_collective(fn: Callable, *args, devices: int | None = None,
                   device: torch.device | None = None,
                   backend: str | None = None):
    """``fn(*args, group=None, device=<the rank's device>)`` on every rank
    of a process group; returns rank 0's result.

    Where a default process group that a caller (or ``torchrun``, through
    ``multihost.init_distributed``) made exists, ``fn`` runs on it in this
    process, on ``device`` or else ``cuda:LOCAL_RANK`` (the launcher's
    variable, else the rank modulo the card count); the port never
    destroys such a group.  Otherwise on ``devices`` ranks: by default one
    a CUDA device, or one rank where ``device`` is given.  One rank runs in
    this process with no process group (``group=None`` and none made: the
    collective helpers return their inputs).  More ranks are spawned
    (``torch.multiprocessing``, spawn start method, a file-store rendezvous
    in a temporary directory); they read the input from shared memory, and
    rank 0's result comes back through a queue.

    ``device`` None puts rank r on ``cuda:r``; an explicit device (the CPU,
    or one card) serves every rank.  ``backend`` defaults to NCCL on CUDA
    devices and gloo on the CPU; two ranks on one card need gloo, which
    NCCL refuses."""
    if dist.is_available() and dist.is_initialized():
        if devices is not None and devices != dist.get_world_size():
            raise ValueError(f"devices={devices}, but the process group has "
                             f"{dist.get_world_size()} ranks")
        if device is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local) if local is not None
                                  else dist.get_rank()
                                  % torch.cuda.device_count())
        return fn(*args, group=None, device=device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        count = torch.cuda.device_count()
        world = count if devices is None else devices
        if world > count:
            raise ValueError(f"devices={world}: more than the {count} CUDA "
                             f"devices of this machine")
    else:
        world = 1 if devices is None else devices
    if world < 1:
        raise ValueError(f"devices={world}: need at least one rank")
    if world > 1:
        if backend is None:
            backend = ("gloo" if device is not None and device.type == "cpu"
                       else "nccl")
        return _spawn(fn, args, world, device, backend)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device is None else torch.device(device))
    return fn(*args, group=None, device=dev)
