"""Multi-process runs: one process a card, started by a launcher.

Counterpart of ``fl_rl_compression_mpi_tpu/parallel/multihost.py``, with its
names.  The reference bootstraps multi-node runs with ``MPI_Init`` and an
``ncclUniqueId`` broadcast (``reference/src/main.cu:35-70``), gives each
rank a disjoint file chunk (``file_io.cu:28-71``) and gathers the compressed
payloads to rank 0 (``fl_gpu.cu:41-74`` MPI, ``:76-287`` NCCL).  Here:

* process bootstrap → :func:`init_distributed`: ``torchrun``'s rendezvous
  (``env://``) or a TCP one at ``HOST:PORT``; a ``torch.distributed`` default
  group, NCCL between cards and gloo on the CPU, one process a device;
* each process's chunk → :func:`fileio.load_file_sharded`, the reference's
  frame-aligned split, encoded on the process's device by the single-device
  codec (``fl_torch.encode``, ``rl_torch.encode``, host closed forms
  included);
* metadata exchange (the reference's ``MPI_Allgather`` of sizes,
  ``fl_gpu.cu:101-106``) → an all-gather of int64 sizes;
* payload gather → **rank-ordered streaming to rank 0**: only the sizes
  are exchanged up front; the payloads then travel in bounded rounds
  (``FLRL_DCN_CHUNK_MB``, default 16) and rank 0 ``pwrite``s each rank's
  piece at its container offset.  Rank 0 holds at most (P−1)·chunk received
  bytes, any other rank one chunk beyond its payload.  With
  ``FLRL_SHARED_FS=1`` every process ``pwrite``s its own ranges instead.

Decompression is distributed too (the reference has none,
``main.cu:131-169``): every process reads the header and the widths, decodes
only its slice of the container and sends or writes its bytes.

The JAX module also splits a process's shard across its local chips
(``dist.make_local_mesh``).  A process here owns one card, so that split
has no counterpart.  The FL containers do not depend on it: every split is
frame-aligned, so they are the single-device container.  The RL container
at P processes is the JAX module's at P processes of one chip each: the
concatenation of each process's shard's runs, a run that crosses a shard
boundary split there.

Every function that moves data takes ``group`` (None: the default group)
and an explicit ``device``; rank and world size come from the group.
Without a default group the process is rank 0 of 1.
"""

from __future__ import annotations

import atexit
import os
import sys

import numpy as np
import torch
import torch.distributed as tdist

from .. import container, fileio
from ..container import _HEADER
from ..ops import fl_torch, rl_torch
from ..ops.bitpack import FRAME_LENGTH
from ..utils.timers import stage, stage_timers_enabled
from . import dist


_rank_world = dist._rank_world


def _load_shard_timed(input_path: str, pid: int, nproc: int,
                      frame_length: int = FRAME_LENGTH):
    """Rank-tagged sharded load (the reference prints a per-rank loader
    line and a 'Load data from file' timer from ``loadFileMpi``,
    ``file_io.cu:28-71``)."""
    with stage("Load data from file") as t:
        data, off = fileio.load_file_sharded(input_path, pid, nproc,
                                             frame_length)
        if t:
            t.add_transfer_size(data.size)
    if stage_timers_enabled():
        print(f"[Rank {pid}] Loaded {data.size} bytes starting from "
              f"offset {off}")
    return data, off


# Bytes a round of the streaming merge moves from each process, unless
# FLRL_DCN_CHUNK_MB (read at each call) or a caller's ``chunk`` says
# otherwise.
STREAM_CHUNK = 16 << 20


def _round_bytes(chunk: int) -> int:
    if chunk:
        return int(chunk)
    mb = os.environ.get("FLRL_DCN_CHUNK_MB")
    return int(mb) << 20 if mb else STREAM_CHUNK


def _synth_codec() -> bool:
    """FLRL_SYNTH_CODEC=1 replaces each process's FL encode with the
    width-8 identity container (every width 8, the payload the raw bytes):
    a valid, decodable container at almost no codec cost, so that the
    merge and write path can be measured apart from the codec."""
    return os.environ.get("FLRL_SYNTH_CODEC") == "1"


def _shared_fs() -> bool:
    """FLRL_SHARED_FS=1: every process ``pwrite``s its own disjoint byte
    ranges of the output (the MPI-IO pattern) instead of streaming them to
    rank 0.  Correct wherever all processes see one filesystem.  The
    default stays the portable streaming merge."""
    return os.environ.get("FLRL_SHARED_FS") == "1"


def _direct_write_pieces(path: str, total_size: int, header: bytes | None,
                         pieces, *, group=None) -> None:
    """Shared-filesystem writer: process 0 creates and sizes the file (and
    writes the header), a barrier publishes it, then every process
    ``pwrite``s its own ``(offset, bytes)`` pieces; a final barrier orders
    completion before any caller reads the file back."""
    pid, _ = _rank_world(group)
    if pid == 0:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(fd, total_size)
            # extents reserved once: concurrent pwrites into a fresh sparse
            # file serialize on block allocation
            if total_size:
                try:
                    os.posix_fallocate(fd, 0, total_size)
                except OSError:
                    pass            # no fallocate here: the file stays sparse
            if header is not None:
                _pwrite(fd, 0, np.frombuffer(header, np.uint8))
        finally:
            os.close(fd)
    with stage("Write: publish barrier"):
        _barrier(group)             # the file exists before anyone writes
    fd = os.open(path, os.O_WRONLY)
    try:
        with stage("Write: pwrite own ranges",
                   sum(len(d) for _, d in pieces)):
            for off, data in pieces:
                if len(data):
                    _pwrite(fd, int(off), data)
    finally:
        os.close(fd)
    with stage("Write: completion barrier"):
        _barrier(group)             # writes complete before any read-back


def process_layout(num_processes: int | None = None,
                   process_id: int | None = None) -> tuple[int, int]:
    """``(world size, rank)`` from the arguments, else from ``WORLD_SIZE``
    and ``RANK`` (which ``torchrun`` sets).  Raises ValueError where
    neither gives one of them."""
    world = (num_processes if num_processes is not None
             else os.environ.get("WORLD_SIZE"))
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if world is None or rank is None:
        raise ValueError("the process count and this process's id are "
                         "needed: pass --num-processes and --process-id, or "
                         "set WORLD_SIZE and RANK")
    world, rank = int(world), int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not in 0..{world - 1}")
    return world, rank


def local_device(rank: int) -> torch.device:
    """The card of this process: ``cuda:LOCAL_RANK`` where the launcher set
    that variable, else ``cuda:(rank % device_count)``."""
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device) -> None:
    """Join the processes' default group (a no-op without an address).

    ``env://`` joins the launcher's rendezvous (``torchrun`` sets
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK``); ``HOST:PORT`` is a TCP rendezvous at rank
    ``process_id`` of ``num_processes``, each taken from ``RANK`` /
    ``WORLD_SIZE`` where it is not given.  NCCL where ``device`` is a CUDA
    device, gloo on the CPU.  A default group that exists with the same
    world size and rank is used as it is; one that conflicts raises.  A
    group made here is destroyed at exit."""
    if coordinator_address is None:
        return
    world, rank = process_layout(num_processes, process_id)
    if tdist.is_initialized():
        have = (tdist.get_world_size(), tdist.get_rank())
        if have != (world, rank):
            raise RuntimeError(f"a default process group of {have[0]} ranks "
                               f"(this one rank {have[1]}) exists; "
                               f"wanted rank {rank} of {world}")
        return
    method = (coordinator_address if coordinator_address == "env://"
              else "tcp://" + coordinator_address)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                             init_method=method, world_size=world, rank=rank)
    made = tdist.group.WORLD

    def _destroy() -> None:
        if tdist.is_initialized() and tdist.group.WORLD is made:
            tdist.destroy_process_group()

    atexit.register(_destroy)


def _process_allgather(values, group=None) -> np.ndarray:
    """i64[world, len(values)]: every process's small integer ``values``
    in rank order.  One process: ``values[None]``."""
    return dist._all_gather_ints([int(v) for v in values], group)


def _post_round(ops):
    """Start one round's batched sends and receives on the group's own
    communicator; returns the requests."""
    return tdist.batch_isend_irecv(ops) if ops else []


def _stream_to_host0(payload: np.ndarray, sizes, write_piece,
                     chunk: int = 0, *, group=None) -> None:
    """Move every process's ``payload`` (``sizes[pid]`` valid bytes) to
    rank 0 in bounded rounds.

    Round ``k`` moves bytes ``[k·chunk, (k+1)·chunk)`` of every process's
    payload to rank 0 only: each process sends its live bytes of the round,
    rank 0 writes its own piece straight from its payload while it
    receives, then calls ``write_piece(rank, pos, piece)`` for each other
    process's piece.  The receive buffers are allocated once and reused
    (on the device under NCCL, with one pinned host buffer for the
    writes), so rank 0 holds at most (P−1)·chunk received bytes and any
    other process one chunk beyond its payload."""
    chunk = _round_bytes(chunk)
    rank, world = _rank_world(group)
    sizes = [int(s) for s in sizes]
    comm = dist.comm_device(group)
    on_card = comm.type == "cuda"
    if rank == 0:
        recv = {p: torch.empty(min(chunk, sizes[p]), dtype=torch.uint8,
                               device=comm)
                for p in range(1, world) if sizes[p]}
        host = (torch.empty(min(chunk, max(sizes[1:], default=0)),
                            dtype=torch.uint8, pin_memory=True)
                if on_card and recv else None)
    elif on_card and sizes[rank]:
        send = torch.empty(min(chunk, sizes[rank]), dtype=torch.uint8,
                           device=comm)
    peer0 = dist._global_rank(group, 0)
    for lo in range(0, max(sizes), chunk):
        live = [max(0, min(chunk, s - lo)) for s in sizes]
        if rank == 0:
            reqs = _post_round([
                tdist.P2POp(tdist.irecv, buf[:live[p]],
                            dist._global_rank(group, p), group)
                for p, buf in recv.items() if live[p]])
            if live[0]:
                write_piece(0, lo, payload[lo:lo + live[0]])
            for req in reqs:
                req.wait()
            for p, buf in recv.items():
                if not live[p]:
                    continue
                if on_card:
                    host[:live[p]].copy_(buf[:live[p]])
                    piece = host[:live[p]].numpy()
                else:
                    piece = buf[:live[p]].numpy()
                write_piece(p, lo, piece)
        elif live[rank]:
            src = fl_torch._host_tensor(payload[lo:lo + live[rank]])
            if on_card:
                send[:live[rank]].copy_(src)
                src = send[:live[rank]]
            for req in _post_round([tdist.P2POp(tdist.isend, src, peer0,
                                                group)]):
                req.wait()


def _pwrite(fd: int, off: int, data: np.ndarray) -> None:
    view = memoryview(np.ascontiguousarray(data, np.uint8)).cast("B")
    while view:                 # a pwrite may write fewer bytes than asked
        done = os.pwrite(fd, view, off)
        view, off = view[done:], off + done


def _barrier(group=None) -> None:
    """Completion barrier (the reference's ``MPI_Barrier``,
    ``fl_gpu.cu:266``): without it, a process other than 0 returns from a
    compress or decompress function right after its last round, while rank 0
    is still ``pwrite``-ing that round's pieces, and a caller that reads
    the output at once (a compress → decompress round trip) sees a
    half-written container.  The JAX package saw it happen: an RL round
    trip read back correct run counts with values still zero.  A
    one-element all-gather completes only once every process, rank 0
    after its writes, takes part."""
    if _rank_world(group)[1] > 1:
        _process_allgather([0], group)


def verify_file_roundtrip(input_path: str, container_path: str,
                          family: str, frame_length: int = FRAME_LENGTH,
                          chunk: int = 0, *, group=None,
                          device: torch.device) -> bool:
    """Round-trip self-check: decompress the container, distributed, to
    ``<container>.verify.tmp``, compare it with the input on rank 0 in
    16 MiB blocks, and give every process the verdict, so that all of them
    agree on the exit code."""
    tmp = container_path + ".verify.tmp"
    pid, _ = _rank_world(group)
    try:
        if family == "fl":
            decompress_fl_file(container_path, tmp, frame_length,
                               chunk=chunk, group=group, device=device)
        else:
            decompress_rl_file(container_path, tmp, chunk=chunk,
                               group=group, device=device)
        ok = True
        if pid == 0:
            ok = os.path.getsize(tmp) == os.path.getsize(input_path)
            if ok:
                with open(input_path, "rb") as fa, open(tmp, "rb") as fb:
                    while True:
                        a = fa.read(1 << 24)
                        b = fb.read(1 << 24)
                        if a != b:
                            ok = False
                            break
                        if not a:
                            break
        return bool(_process_allgather([int(ok)], group).min())
    finally:
        if pid == 0 and os.path.exists(tmp):
            os.unlink(tmp)


def _open_for_rank0(pid: int, path: str, size: int,
                    header: bytes | None = None) -> int | None:
    """Rank 0's descriptor of the output, created at ``size`` bytes with
    its header; None on every other rank."""
    if pid != 0:
        return None
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.ftruncate(fd, size)
    if header is not None:
        _pwrite(fd, 0, np.frombuffer(header, np.uint8))
    return fd


def _merge_to_rank0(path: str, size: int, header: bytes | None,
                    streams, what: str, chunk: int, group) -> None:
    """Rank 0 writes the output from every process's ``streams``
    ``(payload, sizes, offsets)``, each streamed to it in bounded rounds;
    then the completion barrier."""
    pid, _ = _rank_world(group)
    fd = _open_for_rank0(pid, path, size, header)
    try:
        with stage(f"Stream {what} data to node 0",
                   sum(len(payload) for payload, _, _ in streams)):
            for payload, sizes, offs in streams:
                _stream_to_host0(
                    payload, sizes,
                    lambda p, pos, piece, offs=offs: _pwrite(
                        fd, int(offs[p]) + pos, piece),
                    chunk, group=group)
    finally:
        if fd is not None:
            os.close(fd)
    _barrier(group)


def _exclusive(sizes: np.ndarray, base: int = 0) -> np.ndarray:
    return base + np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
        np.int64)


def compress_fl_file(input_path: str, output_path: str,
                     frame_length: int = FRAME_LENGTH, chunk: int = 0, *,
                     group=None, device: torch.device) -> None:
    """Compress a shared input file across all processes; rank 0 writes
    the container (rank-ordered streaming merge, bounded memory), or with
    ``FLRL_SHARED_FS=1`` every process writes its own ranges."""
    pid, nproc = _rank_world(group)
    data, _ = _load_shard_timed(input_path, pid, nproc, frame_length)
    total_size = os.path.getsize(input_path)
    if _synth_codec():
        print(f"[WARN] [Rank {pid}] FLRL_SYNTH_CODEC=1: the FL encode is "
              "replaced by the width-8 identity container; the container "
              "is valid but NOT COMPRESSED", file=sys.stderr)
        frames = -(-data.size // frame_length)
        bits, values = np.full(frames, 8, np.uint8), np.asarray(data)
    else:
        bits, values = fl_torch.encode(data, frame_length, device=device)

    if nproc == 1:
        with stage("Save data to file", bits.size + values.size):
            container.save_fl(output_path, container.FLCompressed(
                bits, values, data.size))
        return

    # sizes-only exchange (MPI_Allgather analog, fl_gpu.cu:101-106)
    with stage("Gather metadata from all nodes", 24 * nproc):
        sizes = _process_allgather([bits.size, values.size, data.size],
                                   group)
    bsizes, vsizes = sizes[:, 0], sizes[:, 1]
    boffs = _exclusive(bsizes, _HEADER.size)
    voffs = _exclusive(vsizes, _HEADER.size + int(bsizes.sum()))
    total = _HEADER.size + int(bsizes.sum()) + int(vsizes.sum())
    if int(sizes[:, 2].sum()) != total_size:
        raise IOError(f"[FileIO] the shards hold {int(sizes[:, 2].sum())} "
                      f"bytes of a {total_size}-byte input")
    header = _HEADER.pack(total_size, int(bsizes.sum()), int(vsizes.sum()))
    if _shared_fs():
        with stage("Write own byte range (shared fs)",
                   bits.size + values.size):
            _direct_write_pieces(output_path, total, header,
                                 [(boffs[pid], bits), (voffs[pid], values)],
                                 group=group)
        return
    _merge_to_rank0(output_path, total, header,
                    [(bits, bsizes, boffs), (values, vsizes, voffs)],
                    "compressed", chunk, group)


def compress_rl_file(input_path: str, output_path: str, chunk: int = 0, *,
                     group=None, device: torch.device) -> None:
    """RL counterpart of :func:`compress_fl_file`: each process's runs of
    its shard, the sizes exchanged, then the merge or the shared-fs
    writes.  A run that crosses a shard boundary splits there, as in
    ``rl-dist``."""
    pid, nproc = _rank_world(group)
    data, _ = _load_shard_timed(input_path, pid, nproc, FRAME_LENGTH)
    counts, values = rl_torch.encode(data, device=device)

    if nproc == 1:
        with stage("Save data to file", 2 * counts.size):
            container.save_rl(output_path, container.RLCompressed(
                counts, values, data.size))
        return

    with stage("Gather metadata from all nodes", 16 * nproc):
        sizes = _process_allgather([counts.size, data.size], group)
    rsizes = sizes[:, 0]
    r_total = int(rsizes.sum())
    coffs = _exclusive(rsizes, _HEADER.size)
    voffs = coffs + r_total
    total = _HEADER.size + 2 * r_total
    header = _HEADER.pack(int(sizes[:, 1].sum()), r_total, r_total)
    if _shared_fs():
        with stage("Write own byte range (shared fs)", 2 * counts.size):
            _direct_write_pieces(output_path, total, header,
                                 [(coffs[pid], counts), (voffs[pid], values)],
                                 group=group)
        return
    _merge_to_rank0(output_path, total, header,
                    [(counts, rsizes, coffs), (values, rsizes, voffs)],
                    "compressed", chunk, group)


def _check_file_size(path: str, size: int) -> None:
    """Raise on every process where the container is shorter than its
    header says: a process whose slice lies past the end would fail alone
    and leave the others waiting in the next collective."""
    have = os.path.getsize(path)
    if have < size:
        raise IOError(f"[FileIO] truncated container: {have} bytes, the "
                      f"header implies {size}")


def decompress_fl_file(input_path: str, output_path: str,
                       frame_length: int = FRAME_LENGTH, chunk: int = 0, *,
                       group=None, device: torch.device) -> None:
    """Distributed FL decompression (the reference decompresses on one CPU
    thread for every distributed method, ``main.cu:131-169``).

    Every process reads the header and the widths, derives its
    frame-aligned byte range (the sharded load's split, applied to the
    output) and that range's payload offset (one sum over the widths),
    reads only its slice of the container, decodes it on its device, and
    then sends or writes its bytes."""
    pid, nproc = _rank_world(group)
    if nproc == 1:
        with stage("Load data from file"):
            comp = container.load_fl(input_path)
        out = fl_torch.decode(comp.input_size, comp.bits, comp.values,
                              frame_length, device=device)
        with stage("Save data to file", out.size):
            fileio.save_file(output_path, out)
        return

    with open(input_path, "rb") as f:
        n, bits_size, values_size = _HEADER.unpack(
            container._read_exact(f, _HEADER.size))
        bits_all = np.frombuffer(container._read_exact(f, bits_size),
                                 np.uint8)
    frames = -(-n // frame_length)
    # checked on every process, so that all of them raise together
    if bits_size < frames:
        raise IOError("[FileIO] corrupt FL container: widths array "
                      "shorter than frame count")
    widths = bits_all[:frames]
    if frames and not 1 <= int(widths.min()) <= int(widths.max()) <= 8:
        raise IOError("[FileIO] corrupt FL container: width byte outside "
                      "1..8")

    # the payload the widths imply, checked on every process (each one's
    # own slice would fail on the last process alone): every frame is full
    # but the last
    need = 0
    if frames:
        tail = n - (frames - 1) * frame_length
        need = (int(widths[:-1].sum(dtype=np.int64)) * frame_length // 8
                + (int(widths[-1]) * tail + 7) // 8)
    if need > values_size:
        raise IOError("[FileIO] corrupt FL container: packed stream "
                      "shorter than the widths imply")
    _check_file_size(input_path, _HEADER.size + bits_size + values_size)

    # frame-aligned byte split (the loadFileMpi rule on the output)
    bchunk = (n // (frame_length * nproc)) * frame_length
    my_off = pid * bchunk
    my_n = (n - my_off) if pid == nproc - 1 else bchunk
    f0 = my_off // frame_length
    f1 = f0 + -(-my_n // frame_length)
    v0 = int(widths[:f0].sum(dtype=np.int64)) * frame_length // 8
    lengths = np.minimum(
        my_n - np.arange(f1 - f0, dtype=np.int64) * frame_length,
        frame_length)
    my_vbytes = int(((widths[f0:f1].astype(np.int64) * lengths + 7)
                     // 8).sum())

    with stage("Load data from file", my_vbytes):
        values = fileio.load_range(input_path, _HEADER.size + bits_size + v0,
                                   my_vbytes)
    out = fl_torch.decode(my_n, widths[f0:f1], values, frame_length,
                          device=device)
    if _shared_fs():
        with stage("Write own byte range (shared fs)", out.size):
            _direct_write_pieces(output_path, n, None, [(my_off, out)],
                                 group=group)
        return
    sizes = _process_allgather([my_n, my_off], group)
    _merge_to_rank0(output_path, n, None, [(out, sizes[:, 0], sizes[:, 1])],
                    "decoded", chunk, group)


def decompress_rl_file(input_path: str, output_path: str, chunk: int = 0,
                       *, group=None, device: torch.device) -> None:
    """Distributed RL decompression: the run list is split evenly; each
    process reads only its counts and values slices, decodes them on its
    device, places itself by an all-gather of the decoded sizes (their
    total checked against the header), and sends or writes its bytes."""
    pid, nproc = _rank_world(group)
    if nproc == 1:
        with stage("Load data from file"):
            comp = container.load_rl(input_path)
        out = rl_torch.decode(comp.counts, comp.values, device=device)
        with stage("Save data to file", out.size):
            fileio.save_file(output_path, out)
        return

    with open(input_path, "rb") as f:
        n, counts_size, values_size = _HEADER.unpack(
            container._read_exact(f, _HEADER.size))
    if counts_size != values_size:
        raise IOError("[FileIO] corrupt RL container: counts/values size "
                      f"mismatch ({counts_size} != {values_size})")
    _check_file_size(input_path, _HEADER.size + 2 * counts_size)
    per = -(-counts_size // nproc)
    lo = min(pid * per, counts_size)
    hi = min(lo + per, counts_size)
    with stage("Load data from file", 2 * (hi - lo)):
        counts = fileio.load_range(input_path, _HEADER.size + lo, hi - lo)
        values = fileio.load_range(
            input_path, _HEADER.size + counts_size + lo, hi - lo)
    out = rl_torch.decode(counts, values, device=device)

    sizes = _process_allgather([out.size], group)[:, 0]
    offs = _exclusive(sizes)
    total = int(sizes.sum())
    if total != n:
        raise IOError("[FileIO] corrupt RL container: counts sum to "
                      f"{total}, header claims {n}")
    if _shared_fs():
        with stage("Write own byte range (shared fs)", out.size):
            _direct_write_pieces(output_path, n, None, [(offs[pid], out)],
                                 group=group)
        return
    _merge_to_rank0(output_path, n, None, [(out, sizes, offs)], "decoded",
                    chunk, group)
