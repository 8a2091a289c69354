"""RL kernels on the GPU, each beside its plain PyTorch version.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/rl_pallas.py``.  The
kernels live in ``csrc/rl.cu``; their wrappers here are

==================  =================================================
``encode_chunk``    one chunk → each piece's value and count, and the
                    start of the natural run its last byte belongs to
                    (one launch, one pass over the chunk)
``encode_device``   a whole stream → its runs, their number left on the
                    device (the same launch, nothing read back)
``run_offsets``     per 4096-run tile: its output offset; the output size
                    (one launch, a single-pass look-back scan)
``expand``          counts + values → bytes
``encode_starts``   a whole stream → each piece as one int32
                    ``value | (start & 0xFF) << 8`` and their number
                    (the encode's kernel in its starts mode)
==================  =================================================

The first two (one kernel) replace ``rl_encode_pallas`` (+
``rl_split_packed``), the next two ``_decode_impl`` behind
``rl_decode_pallas`` and ``rl_decode_packed_pallas``, and
``encode_starts`` the starts-routing encode ``rl_encode_v2`` of
``experiments/exp30_rl_starts.py:189``.

Encode works on one chunk of the stream with a carry-in from the chunk
before it: ``prev``, that chunk's last byte (-1 for none), and ``d0``, the
distance of this chunk's first byte from the start of the natural run it
continues (0 for none; at least 1 when ``prev`` is given, a run that does
not continue being recognised by its first byte).  Position i starts a
piece when its distance from its natural run start is a multiple of 255,
as in ``rl_numpy.encode``.  The chunk's last count is measured to the
chunk's end; the caller closes it with the next piece start.

A wrapper given CPU tensors returns its plain PyTorch version
(``*_ref``); given CUDA tensors it launches its kernel on the current
stream or raises.  It never falls back from one to the other.  Each
launch adds one to ``LAUNCHES[<kernel>]``.  The plain versions work on
uint8/int64 tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fl_dense_cuda import (_aligned, _check, _launch, _on_cuda, _stream,
                            count_launch, reset_table)

RUN_CAP = 255
# The most bytes one encode launch takes (kEncodeMaxBytes in csrc/rl.cuh).
ENCODE_MAX_BYTES = 1 << 30
# Bytes of an encode tile (kEncodeTile in csrc/rl.cuh) and runs of a decode
# tile (kScanTile in csrc/scan.cuh).
ENCODE_TILE = 16384
TILE = 4096
# Tiles a block of ``flrl_rl_run_offsets`` takes (kRunGroup in csrc/rl.cuh):
# the kernel's scratch holds a status word a group of tiles and a ticket.
RUN_GROUP = 16
_NONE = torch.iinfo(torch.int64).min   # meta[1]: no natural start in the chunk

LAUNCHES = {"rl_encode": 0, "rl_offsets": 0, "rl_expand": 0,
            "rl_encode_starts": 0}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def _tiles(items: int, tile: int = TILE) -> int:
    return -(-items // tile)


def _check_carry(prev: int, d0: int) -> None:
    if not -1 <= prev <= 255:
        raise ValueError(f"prev must be in -1..255, got {prev}")
    if d0 < 0:
        raise ValueError(f"d0 must be >= 0, got {d0}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions.
# ---------------------------------------------------------------------------

def _natural(x: torch.Tensor, prev: int) -> torch.Tensor:
    """bool[n]: byte i differs from the byte before it (prev for i = 0)."""
    xi = x.to(torch.int64)
    return xi != torch.cat([xi.new_tensor([prev]), xi[:-1]])


def _pieces(x: torch.Tensor, prev: int, seed: int) -> torch.Tensor:
    """Piece start positions, as ``rl_jax.rl_encode`` finds them: the
    running max of natural run starts (``seed`` before the first) and a
    boundary every 255 bytes of a run."""
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    start = torch.cummax(torch.where(_natural(x, prev), idx, seed), 0).values
    return ((idx - start) % RUN_CAP == 0).nonzero().squeeze(1)


def encode_chunk_ref(x: torch.Tensor, prev: int = -1, d0: int = 0):
    """``(values u8[R], counts u8[R], run_start)`` of the chunk ``x``
    u8[n]: each piece's byte and length (the last measured to n), and the
    start of the natural run x[n-1] belongs to, relative to the chunk
    (-d0 when that run began before it)."""
    n = x.numel()
    if n == 0:
        empty = torch.zeros(0, dtype=torch.uint8, device=x.device)
        return empty, empty.clone(), -d0
    pos = _pieces(x, prev, -d0)
    counts = torch.diff(pos, append=pos.new_tensor([n])).to(torch.uint8)
    natural = _natural(x, prev).nonzero()
    run_start = int(natural[-1]) if natural.numel() else -d0
    return x[pos], counts, run_start


def encode_starts_ref(x: torch.Tensor):
    """``(packed int32[n], total int64[1])`` of the stream ``x`` u8[n]:
    each piece as ``value | (start & 0xFF) << 8``, start its position in
    x, then zeros; total the number of pieces."""
    n = x.numel()
    packed = torch.zeros(n, dtype=torch.int32, device=x.device)
    pos = (_pieces(x, -1, 0) if n
           else torch.zeros(0, dtype=torch.int64, device=x.device))
    packed[:pos.numel()] = (x[pos].to(torch.int32)
                            | ((pos & 0xFF) << 8).to(torch.int32))
    return packed, torch.tensor([pos.numel()], dtype=torch.int64,
                                device=x.device)


def run_offsets_ref(counts: torch.Tensor) -> torch.Tensor:
    """``offs i64[T+1]``: exclusive scan of the output bytes per tile of
    4096 runs; offs[T] = sum of counts."""
    R = counts.numel()
    T = _tiles(R)
    c = torch.zeros(T * TILE, dtype=torch.int64, device=counts.device)
    c[:R] = counts
    offs = torch.zeros(T + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(c.view(T, TILE).sum(1), 0, out=offs[1:])
    return offs


def expand_ref(counts: torch.Tensor, values: torch.Tensor,
               offs: torch.Tensor, n: int) -> torch.Tensor:
    """Each value repeated its count, the first n bytes: u8[n] (zeros past
    the runs' end where n is larger; the kernel leaves those unwritten)."""
    out = torch.repeat_interleave(values, counts.to(torch.int64))[:n]
    if out.numel() < n:
        out = torch.cat([out, out.new_zeros(n - out.numel())])
    return out


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def encode_chunk(x: torch.Tensor, prev: int = -1, d0: int = 0):
    """``(values u8[R], counts u8[R], run_start)`` of the chunk ``x``
    u8[n]; see :func:`encode_chunk_ref`.  The kernel takes at most 2^30
    bytes a call; R and the run start come back in one small copy."""
    _check(x, "x", torch.uint8)
    _check_carry(prev, d0)
    if not _on_cuda(x):
        return encode_chunk_ref(x, prev, d0)
    _aligned(x, "x")
    if x.numel() == 0:
        return encode_chunk_ref(x, prev, d0)
    counts = torch.empty(x.numel(), dtype=torch.uint8, device=x.device)
    values, meta = _encode(x, prev, d0, counts)
    R, start = meta[:2].tolist()
    return values[:R], counts[:R], -d0 if start == _NONE else start


def _encode(x: torch.Tensor, prev: int, d0: int, counts: torch.Tensor):
    """One ``flrl_rl_encode`` launch on ``x`` (n > 0 bytes) with the carry,
    its counts into ``counts`` u8[n]: ``(values u8[n], meta i64)``, meta
    holding R and the run start, nothing read back."""
    n = x.numel()
    values = torch.empty(n, dtype=torch.uint8, device=x.device)
    # R, the run start, then the tiles' status words and the ticket (the
    # launcher clears those on the stream)
    meta = torch.empty(2 + _tiles(n, ENCODE_TILE) + 1, dtype=torch.int64,
                       device=x.device)
    _launch("flrl_rl_encode", x.data_ptr(), n, prev, d0, values.data_ptr(),
            counts.data_ptr(), meta.data_ptr(), x.device.index, _stream(x))
    count_launch(LAUNCHES, "rl_encode", x.device)
    return values, meta


def encode_device(x: torch.Tensor):
    """``(counts u8[n], values u8[n], num_runs i64[1])`` of the whole
    stream ``x`` u8[n] (no carry), in ``rl_jax.rl_encode_device``'s order,
    with nothing read back from the device: the first ``num_runs`` entries
    are the runs, the last one closed at n; ``counts`` past them are zero
    (cleared before the launch, as the JAX package zeroes them), ``values``
    past them unspecified.  The kernel takes at most ``ENCODE_MAX_BYTES``
    bytes a call; more raises a ValueError."""
    _check(x, "x", torch.uint8)
    n = x.numel()
    if n > ENCODE_MAX_BYTES:
        raise ValueError(f"x: {n} bytes, more than the {ENCODE_MAX_BYTES} "
                         "(2^30) one RL encode launch takes")
    if not _on_cuda(x) or n == 0:
        values, counts, _ = encode_chunk_ref(x)
        R = counts.numel()
        return (F.pad(counts, (0, n - R)), F.pad(values, (0, n - R)),
                torch.tensor([R], dtype=torch.int64, device=x.device))
    _aligned(x, "x")
    counts = torch.zeros(n, dtype=torch.uint8, device=x.device)
    values, meta = _encode(x, -1, 0, counts)
    return counts, values, meta[:1]


def encode_starts(x: torch.Tensor):
    """``(packed int32[n], total int64[1])`` of the whole stream ``x``
    u8[n]; see :func:`encode_starts_ref`.  Entries at and past ``total``
    are unspecified; nothing is read back.  One launch of at most
    ``ENCODE_MAX_BYTES`` bytes; more raises a ValueError."""
    _check(x, "x", torch.uint8)
    n = x.numel()
    if n > ENCODE_MAX_BYTES:
        raise ValueError(f"x: {n} bytes, more than the {ENCODE_MAX_BYTES} "
                         "(2^30) one RL encode launch takes")
    if not _on_cuda(x) or n == 0:
        return encode_starts_ref(x)
    _aligned(x, "x")
    packed = torch.empty(n, dtype=torch.int32, device=x.device)
    # R, an unused word, then the tiles' status words and the ticket (the
    # launcher clears those on the stream)
    meta = torch.empty(2 + _tiles(n, ENCODE_TILE) + 1, dtype=torch.int64,
                       device=x.device)
    _launch("flrl_rl_encode_starts", x.data_ptr(), n, packed.data_ptr(),
            meta.data_ptr(), x.device.index, _stream(x))
    count_launch(LAUNCHES, "rl_encode_starts", x.device)
    return packed, meta[:1]


def run_offsets(counts: torch.Tensor) -> torch.Tensor:
    """``offs i64[T+1]`` of the run counts ``counts`` u8[R]; see
    :func:`run_offsets_ref`."""
    _check(counts, "counts", torch.uint8)
    if not _on_cuda(counts):
        return run_offsets_ref(counts)
    _aligned(counts, "counts")
    T = _tiles(counts.numel())
    # one allocation: the offsets, then the scan's status words and ticket
    # (the launcher clears those on the stream)
    buf = torch.empty(T + 1 + _tiles(T, RUN_GROUP) + 1, dtype=torch.int64,
                      device=counts.device)
    _launch("flrl_rl_run_offsets", counts.data_ptr(), counts.numel(),
            buf.data_ptr(), counts.device.index, _stream(counts))
    count_launch(LAUNCHES, "rl_offsets", counts.device)
    return buf[:T + 1]


def expand(counts: torch.Tensor, values: torch.Tensor, offs: torch.Tensor,
           n: int) -> torch.Tensor:
    """The n decoded bytes u8[n] of the runs ``counts``/``values`` u8[R]
    (n = ``offs[-1]``, which the caller knows); see :func:`expand_ref`."""
    _check(counts, "counts", torch.uint8)
    R = counts.numel()
    _check(values, "values", torch.uint8, R)
    _check(offs, "offs", torch.int64, _tiles(R) + 1)
    if not _on_cuda(counts, values, offs):
        return expand_ref(counts, values, offs, n)
    _aligned(counts, "counts")
    _aligned(values, "values")
    out = torch.empty(n, dtype=torch.uint8, device=counts.device)
    _launch("flrl_rl_expand", counts.data_ptr(), values.data_ptr(), R,
            offs.data_ptr(), n, out.data_ptr(), counts.device.index,
            _stream(counts))
    count_launch(LAUNCHES, "rl_expand", counts.device)
    return out
