"""Distributed FL and RL: a mesh of devices driven from one process, or
the ranks of a ``torch.distributed`` process group.

Counterpart of ``fl_rl_compression_mpi_tpu/parallel/dist.py``.  The
reference runs one MPI rank a GPU and gathers to rank 0 (MPI point to
point, ``reference/src/fl/fl_gpu.cu:41-74``) or all-gathers the payloads
with a max-padded ``ncclAllGather`` (``fl_gpu.cu:76-287``).  The JAX package
folds both into one SPMD program over a device mesh that one process drives
(``make_mesh``, ``shard_map``).  Here, as there, a **mesh** is the devices
one process drives (:func:`make_mesh`): shard *i* runs on ``mesh[i]``, each
in a host thread of its own (:func:`on_mesh`), all at once, with no process
started and no process group made.  A rank of a caller's process group
(``torchrun``, ``multihost.py``) runs the same functions as one shard of
that group's split instead (``group``, ``device``):

* the split is :func:`plan_shards`, the reference's rule ``chunk = (S //
  (L·N))·L`` with the last shard taking the remainder (``file_io.cu:46-51``),
  in 64-bit arithmetic;
* each shard is encoded or decoded through the single-device chunk walks
  (``fl_torch.encode_walk``/``decode_walk``, ``rl_torch``'s), on the route
  ``FLRL_NO_DENSE`` selects, exactly as on one GPU;
* ``fl-dist`` (:func:`compress_fl`): each shard's widths and exact payload
  are copied down and concatenated in shard order (the JAX package's
  ``compress_fl``; on a group, sent to rank 0).  Shard boundaries are
  frame-aligned, so the concatenation is the single-device container;
* ``fl-ici`` (:func:`compress_fl_ici`): each card's widths and payload stay
  on it and are copied card to card into one buffer on ``mesh[0]``, then
  copied down once into pinned memory, whose two halves are the container
  (the JAX package's on-device ``all_gather``; on a group,
  an all-gather padded to the largest rank's, and every rank builds the
  container);
* :func:`decompress_fl`: the host closed forms first (constant container,
  all-8 widths); else each shard decodes its frames from its slice of the
  payload, found from the widths by one cumsum, straight into its slice of
  the one host output (on a group, the outputs go to rank 0);
* :func:`compress_rl` / :func:`decompress_rl`: per-shard runs over the same
  plan (a run that crosses a shard boundary splits, so the container depends
  on N); decode splits the run list evenly over the shards;
* the device-resident programs, named as the JAX package's sharded
  programs (:func:`shard_host_data` puts each shard on its device): the
  field encode and decode (:func:`fl_compress_sharded`,
  :func:`fl_decompress_sharded`, and :func:`fl_compress_merged`, which
  gathers every shard's widths and fields onto every device), the dense,
  single-width and constant encodes and decodes
  (:func:`fl_compress_sharded_dense` …, :func:`fl_compress_merged_dense`,
  the container gathered onto every device) and the RL encode and decode
  (:func:`rl_compress_sharded`, :func:`rl_decompress_sharded`): results
  stay on the devices, and only the merged dense program reads anything
  back (its payload sizes, once).

The host closed forms (empty and constant containers, the all-8 decode) run
once, on the host, before any device.  A mesh of one device runs in the
calling thread, on its current stream; ``group`` None and no default group
with a ``device`` is that one-device mesh.  :func:`run_collective` runs one
of these functions on a caller's default group, else on a mesh.

On a group, collectives take tensors on :func:`comm_device`: the rank's
CUDA device under NCCL, the CPU under gloo.  The backend is the group's;
nothing switches it.  Functions that gather to rank 0 return None on the
other ranks.  :func:`spawn_group` starts the ranks of a new group, for
tests and scripts that need a group's ranks on one machine; no entry point
of the package calls it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import math
import os
import tempfile
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from ..container import FLCompressed, RLCompressed
from ..ops import fl_constant_cuda as ckern
from ..ops import fl_dense_cuda, fl_torch, rl_cuda, rl_torch
from ..ops.bitpack import FRAME_LENGTH
from ..utils import constant_byte_probe
from ..utils import thread_state
from ..utils.timers import card_scope, stage


class ShardPlan(NamedTuple):
    """Host-side split of an input into frame-aligned shards (the
    reference's ``loadFileMpi`` split, ``file_io.cu:46-51``)."""
    num_shards: int
    ns: np.ndarray           # i64[num_shards] bytes per shard
    frame_length: int = FRAME_LENGTH

    @property
    def shard_npad(self) -> int:
        """Bytes of every shard's buffer on its device
        (:func:`shard_host_data`): the largest shard rounded up to whole
        frames and to 16 bytes, the alignment the kernels' wrappers check;
        at least one such unit.  The JAX package's also rounds up to its
        compile-cache bucket and its TPU tiles, which change no output."""
        unit = math.lcm(self.frame_length, 16)
        return max(1, -(-int(self.ns.max()) // unit)) * unit

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
    return ShardPlan(num_shards, ns, frame_length)


# ---------------------------------------------------------------------------
# The mesh: several devices driven from this process
# ---------------------------------------------------------------------------

Mesh = Sequence[torch.device]


def make_mesh(num_devices: int | None = None,
              device: str | torch.device | None = None
              ) -> tuple[torch.device, ...]:
    """The devices of a one-process mesh, in shard order (named after the
    JAX package's ``make_mesh``): ``cuda:0`` … ``cuda:N-1`` (by default
    every card), or ``num_devices`` (default 1) times one explicit device
    (the CPU, or one card for N shards on it).  Raises for a count below 1
    or above the cards present."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        world = 1 if num_devices is None else num_devices
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device")
        count = torch.cuda.device_count()
        world = count if num_devices is None else num_devices
        if world > count:
            raise ValueError(f"devices={world}: more than the {count} CUDA "
                             f"devices of this machine")
    if world < 1:
        raise ValueError(f"devices={world}: need at least one device")
    if device is not None:
        return (device,) * world
    return tuple(torch.device("cuda", i) for i in range(world))


def _shard_main(index: int, device: torch.device, work: Callable, state):
    """``work(index, device)`` in a per-card thread: tagged as shard
    ``index`` (stage lines, launch counts), holding the starting thread's
    profiler state (``state``, :func:`thread_state.capture`), on ``device``
    as the thread's current device and on a stream of its own there.
    Returns the result and an event after the stream's work (None on the
    CPU)."""
    with card_scope(index, state):
        if device.type != "cuda":
            return work(index, device), None
        with torch.cuda.device(device), \
                torch.cuda.stream(torch.cuda.Stream(device)):
            out = work(index, device)
            done = torch.cuda.Event()
            done.record()
        return out, done


def on_mesh(mesh: Mesh, work: Callable) -> list:
    """``[work(i, mesh[i]) for every shard i]``, every shard at once.

    One device runs in the calling thread, on its current stream.  More run
    one host thread a shard (:func:`_shard_main`): the kernels' ``ctypes``
    launches and PyTorch's copies release the interpreter lock, so the
    cards work together.  Every shard's stream work is ordered before
    whatever the caller enqueues next on its devices' current streams.  An
    exception reaches the caller only once every shard's thread has ended
    (the lowest shard's first); nothing falls back to fewer devices."""
    if len(mesh) == 1:
        dev = mesh[0]
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return [work(0, dev)]
        return [work(0, dev)]
    state = thread_state.capture()
    try:
        with concurrent.futures.ThreadPoolExecutor(
                len(mesh), thread_name_prefix="flrl-card") as pool:
            futures = [pool.submit(_shard_main, i, dev, work, state)
                       for i, dev in enumerate(mesh)]
    finally:
        thread_state.release(state)
    # the pool has joined every thread; result() raises a shard's error
    results = [f.result() for f in futures]
    for dev, (_, done) in zip(mesh, results):
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
    return [out for out, _ in results]


def _local_mesh(group, device, mesh) -> tuple[torch.device, ...] | None:
    """The mesh a call runs on in this process: ``mesh``, or the one-device
    mesh of ``device`` where there is no process group; None for a rank of
    a group."""
    if mesh is not None:
        if group is not None or device is not None:
            raise ValueError("mesh= runs in this process: give no group= or "
                             "device= with it")
        return tuple(torch.device(d) for d in mesh)
    if _no_group(group):
        if device is None:
            raise ValueError("give device= (one device) or mesh=")
        return (torch.device(device),)
    return None


def _fill(dst: torch.Tensor, parts: list,
          non_blocking: bool = False) -> torch.Tensor:
    """``dst`` holding the tensors ``parts`` one after another."""
    pos = 0
    for t in parts:
        dst[pos:pos + t.numel()].copy_(t, non_blocking=non_blocking)
        pos += t.numel()
    return dst


def _gather_on_card(dev: torch.device, parts: list) -> np.ndarray:
    """The bytes of the u8 device tensors ``parts``, in order, in one host
    array.  Where some lie on other cards than ``dev``, all are first
    copied card to card into one buffer on ``dev`` (over NVLink where the
    cards have it), which is then copied down once; where all lie on
    ``dev``, each is copied down into its slice.

    From a CUDA device the array is a view of a block of PyTorch's
    pinned-memory cache, as the one-card walk's container is: each call
    takes a block of its own, which returns to the cache once every view
    of it is dropped (and its copy's event has passed), so a later call
    never writes into an array that a caller still holds.  From the CPU it
    is plain host memory."""
    total = sum(t.numel() for t in parts)
    if any(t.device != dev for t in parts):
        with stage("Gather payloads on card 0", total,
                   span="flrl.gather.p2p", on=dev):
            parts = [_fill(torch.empty(total, dtype=torch.uint8, device=dev),
                           parts)]
    with stage("Copy results to CPU", total, span="flrl.gather.d2h"):
        cuda = dev.type == "cuda"
        host = _fill(fl_torch._host_block(total, dev), parts, cuda)
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()
    return host.numpy()


# ---------------------------------------------------------------------------
# Collectives of a process group
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
    with stage("Gather to rank 0", int(sizes[1:].sum()),
               span="flrl.gather.p2p"):
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
    if len(parts) == 1:
        return parts[0]
    with stage(span="flrl.host.join"):
        return np.concatenate(parts)


def _all_gather_payloads(bits_d: torch.Tensor, values_d: torch.Tensor,
                         group):
    """``(bits, values)`` of every rank in rank order, on every rank: an
    all-gather of the sizes (the reference's ``MPI_Allgather`` of sizes,
    ``fl_gpu.cu:101-106``), then one all-gather on the communication device
    of each rank's widths and payload in one buffer padded to the largest
    rank's (``fl_gpu.cu:144-194``)."""
    rank, world = _rank_world(group)
    sizes = _all_gather_ints([bits_d.numel(), values_d.numel()], group)
    width = int(sizes.sum(1).max())
    comm = comm_device(group)
    with stage("All-gather payloads", width * world, span="flrl.gather.p2p",
               on=comm):
        buf = torch.empty(width, dtype=torch.uint8, device=comm)
        nb, nv = (int(x) for x in sizes[rank])
        buf[:nb].copy_(bits_d)
        buf[nb:nb + nv].copy_(values_d)
        gathered = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(gathered, buf, group=group)
    with stage(span="flrl.host.out"):
        bits = np.empty(int(sizes[:, 0].sum()), np.uint8)
        values = np.empty(int(sizes[:, 1].sum()), np.uint8)
    with stage("Copy results to CPU", bits.size + values.size,
               span="flrl.gather.d2h"):
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
    with stage(span="flrl.host.probe"):
        c = constant_byte_probe(data)
    if c is None:
        return None
    with stage("Compression", n, span="flrl.host.out"):
        return FLCompressed(*fl_torch._constant_container(c, n, frame_length),
                            n)


def compress_fl(data, frame_length: int = FRAME_LENGTH, *, group=None,
                device=None, mesh: Mesh | None = None) -> FLCompressed | None:
    """``fl-dist``: the container of ``data``, byte-identical to the
    single-device encode; on a group, on rank 0 and None on the other
    ranks."""
    data = np.asarray(data, np.uint8).reshape(-1)
    mesh = _local_mesh(group, device, mesh)
    rank, world = (0, len(mesh)) if mesh else _rank_world(group)
    comp = _fl_closed_form(data, frame_length)
    if comp is None:
        plan = plan_shards(data.size, world, frame_length)

        def encode(i, dev):
            return fl_torch.encode_walk(plan.shard(data, i), frame_length,
                                        dev)

        parts = (on_mesh(mesh, encode) if mesh else
                 _gather_to_rank0(list(encode(rank, device)), group))
        if parts is None:
            return None
        comp = FLCompressed(_cat([p[0] for p in parts]),
                            _cat([p[1] for p in parts]), data.size)
    return comp if rank == 0 else None


def compress_fl_ici(data, frame_length: int = FRAME_LENGTH, *, group=None,
                    device=None, mesh: Mesh | None = None) -> FLCompressed:
    """``fl-ici``: as :func:`compress_fl`, but the shards' outputs stay on
    their devices and are gathered there: card to card onto ``mesh[0]``,
    or all-gathered over the group, where every rank returns the
    container.  On a mesh the container's widths and payload are the two
    halves of the one host array that :func:`_gather_on_card` lands (in
    pinned memory from a card), with no copy between them; the block is
    the container's until both are dropped."""
    data = np.asarray(data, np.uint8).reshape(-1)
    mesh = _local_mesh(group, device, mesh)
    rank, world = (0, len(mesh)) if mesh else _rank_world(group)
    comp = _fl_closed_form(data, frame_length)
    if comp is None:
        plan = plan_shards(data.size, world, frame_length)

        def encode(i, dev):
            return fl_torch.encode_walk(plan.shard(data, i), frame_length,
                                        dev, to_host=False)

        if mesh:
            outs = on_mesh(mesh, encode)
            nb = sum(b.numel() for b, _ in outs)
            host = _gather_on_card(
                mesh[0], [b for b, _ in outs] + [v for _, v in outs])
            comp = FLCompressed(host[:nb], host[nb:], data.size)
        else:
            comp = FLCompressed(
                *_all_gather_payloads(*encode(rank, device), group),
                data.size)
    return comp


def decompress_fl(comp, frame_length: int = FRAME_LENGTH, *, group=None,
                  device=None, mesh: Mesh | None = None) -> np.ndarray | None:
    """The decoded bytes (on a group, on rank 0 and None on the other
    ranks).  Each shard decodes the frames of its shard of the output; the
    container is checked before any device work, as ``fl_torch.decode``
    checks it (on every rank of a group)."""
    fl_dense_cuda.check_frame_length(frame_length)
    mesh = _local_mesh(group, device, mesh)
    rank, world = (0, len(mesh)) if mesh else _rank_world(group)
    n = int(comp.input_size)
    bits = np.asarray(comp.bits, np.uint8).reshape(-1)
    values = np.asarray(comp.values, np.uint8).reshape(-1)
    out = (np.zeros(0, np.uint8) if n == 0 else
           fl_torch.decode_closed_form(n, bits, values, frame_length))
    if out is None:
        plan = plan_shards(n, world, frame_length)
        ns, L = plan.ns.tolist(), frame_length
        # each shard's widths and the walk's parts over them, all checked
        # before any shard starts; a shard's payload starts after the
        # payloads of the shards before it
        widths = [bits[s // L:s // L + -(-k // L)]
                  for s, k in zip(plan.starts.tolist(), ns)]
        layouts = [fl_torch.walk_layout(k, w, L)
                   for k, w in zip(ns, widths)]
        fl_torch.check_layouts(layouts, values.size)
        vstarts = np.cumsum([0] + [lay[-1].v1 if lay else 0
                                   for lay in layouts]).tolist()

        def decode(i, dev, dest=None):
            return fl_torch.decode_walk(
                ns[i], widths[i], values[vstarts[i]:vstarts[i + 1]],
                layouts[i], L, dev, out=dest)

        if mesh:
            with stage(span="flrl.host.out"):
                out = np.empty(n, np.uint8)
            on_mesh(mesh, lambda i, dev: decode(i, dev, plan.shard(out, i)))
        else:
            parts = _gather_to_rank0([decode(rank, device)], group)
            if parts is None:
                return None
            out = _cat([p[0] for p in parts])
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# RL
# ---------------------------------------------------------------------------

def compress_rl(data, *, group=None, device=None,
                mesh: Mesh | None = None) -> RLCompressed | None:
    """``rl-dist``: each shard's runs of its shard of the FL shard plan (L
    = 128), concatenated in shard order (on a group, on rank 0 and None on
    the other ranks).  Equal to ``rl-cpu``'s container of each shard,
    concatenated."""
    data = np.asarray(data, np.uint8).reshape(-1)
    mesh = _local_mesh(group, device, mesh)
    rank, world = (0, len(mesh)) if mesh else _rank_world(group)
    if data.size == 0:
        comp = RLCompressed(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0)
    else:
        plan = plan_shards(data.size, world, FRAME_LENGTH)

        def encode(i, dev):
            return rl_torch.encode_walk(plan.shard(data, i), dev)

        parts = (on_mesh(mesh, encode) if mesh else
                 _gather_to_rank0(list(encode(rank, device)), group))
        if parts is None:
            return None
        comp = RLCompressed(_cat([p[0] for p in parts]),
                            _cat([p[1] for p in parts]), data.size)
    return comp if rank == 0 else None


def decompress_rl(comp, *, group=None, device=None,
                  mesh: Mesh | None = None) -> np.ndarray | None:
    """The decoded bytes (on a group, on rank 0 and None on the other
    ranks).  Run boundaries are not shard-aligned, so the run list is split
    evenly over the shards; each decodes its runs, on a mesh straight into
    the output at the sum of the counts before them."""
    mesh = _local_mesh(group, device, mesh)
    rank, world = (0, len(mesh)) if mesh else _rank_world(group)
    counts = np.asarray(comp.counts, np.uint8).reshape(-1)
    values = np.asarray(comp.values, np.uint8).reshape(-1)
    if counts.size != values.size:
        raise ValueError("rl decode: corrupt container (counts/values size "
                         f"mismatch: {counts.size} != {values.size})")
    if counts.size == 0:
        return np.zeros(0, np.uint8) if rank == 0 else None
    per = -(-counts.size // world)
    runs = [(min(i * per, counts.size), min(i * per + per, counts.size))
            for i in range(world)]

    def decode(i, dev, dest=None):
        lo, hi = runs[i]
        return rl_torch.decode_walk(counts[lo:hi], values[lo:hi], dev,
                                    out=dest)

    if mesh:
        with stage(span="flrl.host.split"):
            starts = np.cumsum([0] + [int(counts[lo:hi].sum(dtype=np.int64))
                                      for lo, hi in runs])
        with stage(span="flrl.host.out"):
            out = np.empty(int(starts[-1]), np.uint8)
        on_mesh(mesh, lambda i, dev: decode(
            i, dev, out[starts[i]:starts[i + 1]]))
        return out
    parts = _gather_to_rank0([decode(rank, device)], group)
    if parts is None:
        return None
    return _cat([p[0] for p in parts])


# ---------------------------------------------------------------------------
# Device-resident programs: the mesh's launches, the constant streams
# ---------------------------------------------------------------------------

def _each_card(mesh: Mesh, tensors: Sequence[torch.Tensor],
               launch: Callable) -> list:
    """``launch(i, tensors[i])`` for every shard i, from this thread, each
    under its card as the current device and, on a mesh of two or more,
    tagged as shard i (``card_scope``: its launches counted by shard, as a
    mesh's per-card threads count theirs).  The launches are asynchronous,
    so the cards run them together."""
    if len(tensors) != len(mesh):
        raise ValueError(f"{len(tensors)} shards for a mesh of {len(mesh)} "
                         "devices")
    outs = []
    for i, (dev, t) in enumerate(zip(mesh, tensors)):
        if t.device != dev:
            raise ValueError(f"shard {i} lies on {t.device}, not on the "
                             f"mesh's {dev}")
        scope = (card_scope(i) if len(mesh) > 1
                 else contextlib.nullcontext())
        with scope, (torch.cuda.device(dev) if dev.type == "cuda"
                     else contextlib.nullcontext()):
            outs.append(launch(i, t))
    return outs


def _flags(mesh: Mesh | None, flag, group) -> torch.Tensor:
    """i32[N]: every shard's flag, in shard order: on ``mesh[0]`` with a
    mesh (``flag`` a list, one a shard), on every rank of a group; a lone
    shard with no group: its own."""
    if mesh is not None:
        return torch.cat([f.to(mesh[0]) for f in flag])
    return _all_gather_rows(flag, group).reshape(-1)


def fl_compress_sharded_dense_constant(shard, cbyte: int, fb: int, *,
                                       group=None, mesh: Mesh | None = None):
    """Per-shard constant-stream encode (TPU kernel #5 on every shard):
    ``shard`` is this rank's u8 bytes on its device (with ``mesh``, a
    sequence of them, shard i on ``mesh[i]``), speculated all ``cbyte`` at
    width ``fb`` (the caller probes with
    ``fl_constant_cuda.host_probe_constant``).  Returns ``(bits, values,
    flags)``: the shard's widths and payload on its device (with ``mesh``,
    a list of each), and ``flags`` i32[N], every shard's flag in order (on
    every rank of a group, on ``mesh[0]`` with a mesh; a lone shard with no
    group: its own).  The flags are authoritative: a nonzero flag on any
    shard means the outputs are junk and the caller re-runs the uniform or
    general encode (``compress_fl``).  The host API takes the closed form
    instead; this is the device-resident pipeline's path."""
    bits, values, flag = _sharded(
        mesh, shard, lambda _, x: ckern.encode_constant(x, cbyte, fb))
    return bits, values, _flags(mesh, flag, group)


def fl_decompress_sharded_dense_constant(values, values_size, n,
                                         cbyte: int, fb: int, *,
                                         group=None,
                                         mesh: Mesh | None = None):
    """Per-shard constant-stream decode (TPU kernel #6 on every shard):
    this rank's payload slice ``values`` (at least ``values_size`` bytes, on
    its device) verified against the pattern, and its ``n`` output bytes of
    ``cbyte``; with ``mesh``, ``values``, ``values_size`` and ``n`` are
    sequences, one entry a shard.  Returns ``(out, flags)``, ``out`` a list
    with ``mesh``, the flags as on encode."""
    out, flag = _sharded(
        mesh, values, lambda _, v, size, m: ckern.decode_constant(
            v, size, cbyte, fb, m), values_size, n)
    return out, _flags(mesh, flag, group)


# ---------------------------------------------------------------------------
# Device-resident sharded programs
# ---------------------------------------------------------------------------
#
# The JAX package's ``shard_map`` programs: arrays already on the devices,
# shard by shard, in; results left there.  Here a shard is a tensor on its
# device: with ``mesh``, a sequence of them (shard i on ``mesh[i]``), the
# launches going out from this thread, and results come back as lists in
# the same layout; on a process group, a rank passes its own tensor and
# gets its own results.  Only the programs that gather (the merged ones,
# and the flags of the single-width and constant encodes) take ``group``;
# the others work on the rank's own tensor alone.  Sizes are host ints: a
# sequence, one a shard, with ``mesh``; this rank's own on a group.  Widths
# are u8[F] and offsets i64[F+1], as in ``fl_dense_cuda``.  Not ported, as
# TPU mechanisms: the stream plan (``wmin``/``route_nbits``), the tiles
# (``tile_r``/``nref``), ``prep_decode_bits``'s widths layout and the
# compile-cache bucket ``_GATHER_ROW_BUCKET``.  A shard above a kernel's
# limit raises: a device-resident shard has no chunk walk.

def make_local_mesh(num_devices: int | None = None,
                    device: str | torch.device | None = None
                    ) -> tuple[torch.device, ...]:
    """The devices this process drives (the JAX package's
    ``make_local_mesh``): under a process group, its rank's card
    (``multihost.local_device``), or ``device``; otherwise
    :func:`make_mesh`.  A rank on a machine with no card must name its
    ``device``."""
    if _no_group(None):
        return make_mesh(num_devices, device)
    if num_devices not in (None, 1):
        raise ValueError(f"devices={num_devices}: a rank of a process group "
                         "drives one device")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh: no CUDA device for this "
                               "rank; pass device= (e.g. 'cpu')")
        from .multihost import local_device
        device = local_device(dist.get_rank())
    return (torch.device(device),)


def shard_host_data(data, plan: ShardPlan, mesh: Mesh | None = None,
                    device=None, *, group=None):
    """``data``'s shards on their devices, each u8[``plan.shard_npad``]: the
    shard's bytes, then zeros (the field kernel reads its words to the
    buffer's end).  With ``mesh``, a list, shard i on ``mesh[i]``; else this
    rank's shard of ``group`` (or of the default group) on ``device``."""
    data = np.asarray(data, np.uint8).reshape(-1)
    npad = plan.shard_npad

    def up(i: int, dev) -> torch.Tensor:
        t = torch.zeros(npad, dtype=torch.uint8, device=dev)
        t[:int(plan.ns[i])].copy_(fl_torch._host_tensor(plan.shard(data, i)))
        return t

    if mesh is not None:
        if len(mesh) != plan.num_shards:
            raise ValueError(f"a plan of {plan.num_shards} shards for a mesh "
                             f"of {len(mesh)} devices")
        return [up(i, dev) for i, dev in enumerate(mesh)]
    if device is None:
        raise ValueError("give mesh= or device= (this rank's device)")
    rank, world = _rank_world(group)
    if world != plan.num_shards:
        raise ValueError(f"a plan of {plan.num_shards} shards for a group of "
                         f"{world} ranks")
    return up(rank, device)


def _sharded(mesh: Mesh | None, shard, launch: Callable, *args):
    """``launch(i, t, *a)`` on each shard ``t`` (i its index, ``a`` its
    entries of ``args``).  With ``mesh``, ``shard`` and every entry of
    ``args`` are sequences, one entry a shard, and each output comes back as
    a list; else it is this rank's, and so are its outputs."""
    if mesh is None:
        return launch(None, shard, *args)
    outs = _each_card(mesh, shard,
                      lambda i, t: launch(i, t, *(a[i] for a in args)))
    if isinstance(outs[0], tuple):
        return tuple(list(o) for o in zip(*outs))
    return outs


def _within(i, nbytes: int, limit: int, kernel: str) -> None:
    if nbytes > limit:
        where = "this rank's shard" if i is None else f"shard {i}"
        raise ValueError(f"{where}: {nbytes} bytes, "
                         f"more than the {limit} (2^{limit.bit_length() - 1})"
                         f" bytes one {kernel} launch takes; a "
                         "device-resident shard has no chunk walk")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The shard's buffer as ``dtype`` (u8 bytes or their int32 view)."""
    return t if t.dtype == dtype else t.view(dtype)


def _concat_on(mesh: Mesh, parts: list, sizes) -> list:
    """The first ``sizes[j]`` elements of each of ``parts`` (1-D, shard j's
    on ``mesh[j]``), concatenated in shard order on every device of the
    mesh: entry d on ``mesh[d]``, copied card to card.  A copy between
    cards is ordered against both cards' current streams, where
    ``_each_card`` launched."""
    bounds = np.cumsum([0] + [int(x) for x in sizes])
    out = []
    for dev in mesh:
        g = torch.empty(int(bounds[-1]), dtype=parts[0].dtype, device=dev)
        for j, p in enumerate(parts):
            g[bounds[j]:bounds[j + 1]].copy_(p[:bounds[j + 1] - bounds[j]])
        out.append(g)
    return out


def _all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """[world, *t.shape]: every rank's ``t`` (one shape on every rank), in
    rank order, on ``t``'s device; a lone shard with no group: its own."""
    if _no_group(group):
        return t.unsqueeze(0)
    _, world = _rank_world(group)
    c = t.to(comm_device(group))
    out = [torch.empty_like(c) for _ in range(world)]
    dist.all_gather(out, c, group=group)
    return torch.stack(out).to(t.device)


def _all_gather_concat(t: torch.Tensor, sizes, group) -> torch.Tensor:
    """Every rank's 1-D ``t`` (rank r's first ``sizes[r]`` elements),
    concatenated in rank order on ``t``'s device: one all-gather of each
    padded to the largest, the reference's max-padded ``ncclAllGather``
    (``fl_gpu.cu:144-194``), then compacted on the device."""
    width = int(max(sizes))
    if _no_group(group) or width == 0:
        return t[:int(sizes[0])].clone()
    rank, _ = _rank_world(group)
    buf = torch.zeros(width, dtype=t.dtype, device=comm_device(group))
    buf[:int(sizes[rank])].copy_(t[:int(sizes[rank])])
    rows = _all_gather_rows(buf, group)
    return torch.cat([r[:int(n)] for r, n in zip(rows, sizes)]).to(t.device)


def fl_compress_sharded(shard, frame_length: int = FRAME_LENGTH, *,
                        mesh: Mesh | None = None):
    """Per-shard field encode (TPU kernel #7 on every shard; the JAX
    ``fl_compress_sharded``, ``parallel/dist.py:153``): ``shard`` is a
    buffer of :func:`shard_host_data` (u8, or its int32 view).  Returns
    ``(bits u8[F_pad], fields int32[NW])`` per shard, F_pad the buffer's
    frames, nothing read back.  The JAX program also takes ``ns`` for the
    kernel's tail mask; the field kernel here has none and reads the zeros
    past each shard's bytes instead, so it takes no sizes."""
    def encode(i, t):
        _within(i, t.numel() * t.element_size(), fl_dense_cuda.MAX_BYTES,
                "field encode")
        return fl_torch.encode_fields_device(_as(t, torch.int32),
                                             frame_length)
    return _sharded(mesh, shard, encode)


def fl_decompress_sharded(fields, bits, frame_length: int = FRAME_LENGTH, *,
                          mesh: Mesh | None = None):
    """Per-shard field decode (TPU kernel #8 on every shard; JAX
    ``parallel/dist.py:447``): each shard's ``fields`` int32[NW] and widths
    ``bits`` u8[F_pad] (:func:`fl_compress_sharded`'s) → its u8[NW·4]
    buffer, the shard's bytes first; bytes past them are unspecified (the
    JAX program zeroes them from its ``ns``).  Nothing is read back."""
    def decode(i, f, b):
        _within(i, f.numel() * 4, fl_dense_cuda.MAX_BYTES, "field decode")
        return fl_torch.decode_fields_device(f, b, frame_length).view(
            torch.uint8)
    return _sharded(mesh, fields, decode, bits)


def fl_compress_merged(shard, frame_length: int = FRAME_LENGTH, *,
                       group=None, mesh: Mesh | None = None):
    """:func:`fl_compress_sharded`, then every shard's widths and fields in
    shard order on every device, as the JAX program's replicated
    ``all_gather`` (``parallel/dist.py:396``): ``(bits u8[N, F_pad], fields
    int32[N, NW])``.  With ``mesh``, a list of each, entry d on ``mesh[d]``
    (card-to-card copies); on a group, this rank's, all-gathered."""
    bits, fields = fl_compress_sharded(shard, frame_length, mesh=mesh)
    if mesh is None:
        return _all_gather_rows(bits, group), _all_gather_rows(fields, group)
    return tuple([g.view(len(mesh), -1) for g in _concat_on(
        mesh, parts, [p.numel() for p in parts])] for parts in (bits, fields))


def _dense_encode(i, t: torch.Tensor, n: int, L: int):
    """The general dense encode of the shard's first n bytes: widths,
    offsets and the pack into a buffer of the shard's size, its payload's
    size left on the device."""
    x = _as(t, torch.uint8)
    _within(i, n, fl_dense_cuda.MAX_BYTES, "dense")
    bits, _ = fl_dense_cuda.frame_widths(x[:n], L)
    offs = fl_dense_cuda.frame_offsets(bits, n, L)
    dense = fl_dense_cuda.pack(x[:n], L, bits=bits, offs=offs,
                               size=max(n, x.numel()))
    return bits, dense, offs[-1:]


def fl_compress_sharded_dense(shard, ns, frame_length: int = FRAME_LENGTH,
                              *, mesh: Mesh | None = None):
    """Per-shard dense encode (TPU kernel #1 on every shard; JAX
    ``parallel/dist.py:189``): ``frame_widths``, ``frame_offsets`` and the
    general ``pack`` of each shard's first ``ns`` bytes, on its device.
    Returns ``(bits u8[F], dense u8[shard_npad], totals i64[1])`` per shard:
    its widths, its buffer with the payload first and its payload's size,
    nothing read back.  The JAX program takes frame counts and packs whole
    frames; the kernels here place a partial last frame exactly, so the
    widths and payload prefixes, in shard order, are the container's."""
    return _sharded(mesh, shard,
                    lambda i, t, n: _dense_encode(i, t, int(n), frame_length),
                    ns)


def fl_decompress_sharded_dense(dense, bits, ns,
                                frame_length: int = FRAME_LENGTH, *,
                                mesh: Mesh | None = None):
    """Per-shard dense decode (TPU kernel #2 on every shard; JAX
    ``parallel/dist.py:419``): each shard's payload ``dense`` (at least its
    payload's bytes), its widths ``bits`` (at least its frames') and its
    size ``ns``: the offsets computed on the device, then ``unpack`` →
    u8[ns].  Nothing is read back."""
    def decode(i, v, b, n):
        n = int(n)
        _within(i, n, fl_dense_cuda.MAX_BYTES, "dense")
        b = b[:-(-n // frame_length)]
        offs = fl_dense_cuda.frame_offsets(b, n, frame_length)
        return fl_dense_cuda.unpack(v, n, frame_length, bits=b, offs=offs)
    return _sharded(mesh, dense, decode, bits, ns)


def fl_compress_sharded_dense_uniform(shard, ns, fb: int,
                                      frame_length: int = FRAME_LENGTH, *,
                                      group=None, mesh: Mesh | None = None):
    """Per-shard single-width dense encode (TPU kernel #3 on every shard;
    JAX ``parallel/dist.py:226``), speculated at width ``fb``: the widths
    of each shard's first ``ns`` bytes with the flag of any other width,
    and the uniform ``pack``.  Returns ``(bits u8[F], dense, flags)``: per
    shard its widths and payload, and ``flags`` i32[N], every shard's flag
    in order, gathered as the constant programs gather theirs.  A nonzero
    flag means that shard's payload is junk; the caller re-runs
    :func:`fl_compress_sharded_dense`."""
    def encode(i, t, n):
        n = int(n)
        x = _as(t, torch.uint8)[:n]
        _within(i, n, fl_dense_cuda.MAX_BYTES, "dense")
        bits, flag = fl_dense_cuda.frame_widths(x, frame_length,
                                                fb_expect=fb)
        return bits, fl_dense_cuda.pack(x, frame_length, fb=fb), flag

    bits, dense, flag = _sharded(mesh, shard, encode, ns)
    return bits, dense, _flags(mesh, flag, group)


def fl_decompress_sharded_dense_uniform(dense, ns, fb: int,
                                        frame_length: int = FRAME_LENGTH, *,
                                        mesh: Mesh | None = None):
    """Per-shard single-width dense decode (TPU kernel #4 on every shard;
    JAX ``parallel/dist.py:254``): each shard's payload at width ``fb`` →
    u8[ns].  Exact: the caller knows every width is fb.  Nothing is read
    back."""
    def decode(i, v, n):
        n = int(n)
        _within(i, n, fl_dense_cuda.MAX_BYTES, "dense")
        return fl_dense_cuda.unpack(v, n, frame_length, fb=fb)
    return _sharded(mesh, dense, decode, ns)


def fl_compress_merged_dense(shard, ns, frame_length: int = FRAME_LENGTH, *,
                             group=None, mesh: Mesh | None = None):
    """:func:`fl_compress_sharded_dense`, then the container on every
    device (JAX ``parallel/dist.py:348``), in two steps: the widths and the
    payload sizes (small) gathered, the sizes read to the host once, then
    only each shard's exact payload gathered.  Returns ``(bits u8[F], values
    u8[V], totals i64[N])``: every shard's widths and payload concatenated
    in shard order, which is the whole stream's container (shard boundaries
    are frame-aligned), and each shard's payload size.  With ``mesh``, a
    list of each, entry d on ``mesh[d]`` (card-to-card copies); on a group,
    on this rank's device (all-gathers padded to the largest rank's)."""
    bits, dense, totals = fl_compress_sharded_dense(shard, ns, frame_length,
                                                    mesh=mesh)
    if mesh is not None:
        sizes = torch.cat([t.to(mesh[0]) for t in totals]).tolist()
        return (_concat_on(mesh, bits, [b.numel() for b in bits]),
                _concat_on(mesh, dense, sizes),
                [torch.tensor(sizes, dtype=torch.int64, device=dev)
                 for dev in mesh])
    sizes = _all_gather_ints([bits.numel(), int(totals[0])], group)
    return (_all_gather_concat(bits, sizes[:, 0], group),
            _all_gather_concat(dense, sizes[:, 1], group),
            torch.as_tensor(sizes[:, 1], device=dense.device))


def rl_compress_sharded(shard, ns, *, mesh: Mesh | None = None):
    """Per-shard RL encode (TPU kernel #11 on every shard; JAX
    ``parallel/dist.py:475``): ``rl_torch.encode_device`` of each shard's
    first ``ns`` bytes → ``(counts u8[ns], values u8[ns], num_runs
    i64[1])`` per shard, nothing read back.  A run that crosses a shard
    boundary splits, as in the JAX package, so the first ``num_runs`` runs
    of each shard, concatenated, are its container at the same N."""
    def encode(i, t, n):
        n = int(n)
        _within(i, n, rl_cuda.ENCODE_MAX_BYTES, "RL encode")
        return rl_torch.encode_device(_as(t, torch.uint8)[:n])
    return _sharded(mesh, shard, encode, ns)


def rl_decompress_sharded(counts, values, ns, *,
                          mesh: Mesh | None = None):
    """Per-shard RL decode (TPU kernel #12 on every shard; JAX
    ``parallel/dist.py:498``): ``rl_torch.decode_device`` of each shard's
    runs → its u8[ns] (the JAX program's static ``out_pad`` is a
    compile-cache shape; its ``nrs`` are not needed, since the counts past
    a shard's runs are zero, as :func:`rl_compress_sharded` leaves them).
    Nothing is read back."""
    return _sharded(mesh, counts,
                    lambda i, c, v, n: rl_torch.decode_device(c, v, int(n)),
                    values, ns)


# ---------------------------------------------------------------------------
# Running a function: on a caller's group, else on a mesh
# ---------------------------------------------------------------------------

def release_kept_group() -> None:
    """Does nothing.  No call of this module makes a process group, so
    there is none to release, and a default group that anyone else made is
    left alone.  Kept for callers of earlier versions, which kept a
    one-rank group across calls."""


def run_collective(fn: Callable, *args, devices: int | None = None,
                   device: torch.device | None = None):
    """``fn`` on a caller's default process group, else on a mesh of this
    process's devices; returns its result (rank 0's on a group).

    Where a default process group that a caller (or ``torchrun``, through
    ``multihost.init_distributed``) made exists, ``fn(*args, group=None,
    device=...)`` runs on it in this process, on ``device`` or else
    ``cuda:LOCAL_RANK`` (the launcher's variable, else the rank modulo the
    card count); the port never destroys such a group.  Otherwise
    ``fn(*args, mesh=make_mesh(devices, device))``: ``devices`` shards, by
    default one a card on ``cuda:0`` …, or one shard where ``device`` is
    given; an explicit device (the CPU, or one card) takes every shard.  No
    process is started and no process group made."""
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
    return fn(*args, mesh=make_mesh(devices, device))


# ---------------------------------------------------------------------------
# Spawned ranks of a new process group (tests and chip scripts)
# ---------------------------------------------------------------------------

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
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="file://" + init_file,
                            world_size=world, rank=rank)
    try:
        out = fn(*args, group=None, device=dev)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def spawn_group(fn: Callable, *args, world: int,
                device: torch.device | None = None,
                backend: str | None = None):
    """``fn(*args, group=None, device=<the rank's device>)`` on every rank
    of a new ``world``-rank default group, one spawned process a rank
    (``torch.multiprocessing``, spawn start method, a file-store rendezvous
    in a temporary directory, the arrays of ``args`` handed over in shared
    memory); returns rank 0's result, which comes back through a queue.

    For tests and scripts that need the ranks of a process group on one
    machine: the package's API and CLI never call it (they run a mesh in
    the calling process).  ``device`` None puts rank r on ``cuda:r``; an
    explicit device (the CPU, or one card) serves every rank.  ``backend``
    defaults to NCCL on CUDA devices and gloo on the CPU; two ranks on one
    card need gloo, which NCCL refuses."""
    if world < 1:
        raise ValueError(f"world={world}: need at least one rank")
    if backend is None:
        backend = ("gloo" if device is not None
                   and torch.device(device).type == "cpu" else "nccl")
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
