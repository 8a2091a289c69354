"""RL kernels on the GPU, each beside its plain PyTorch version.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/rl_pallas.py``.  The
kernels live in ``csrc/rl.cu``; their wrappers here are

==================  =================================================
``piece_tiles``     per 4096-byte tile: first and last natural run
                    start, pieces from the first one on
``piece_offsets``   per tile: the run start it continues and its
                    output offset; the piece count R and the carry-out
``compact``         each piece's value and start byte
``piece_counts``    counts from consecutive start bytes
``run_offsets``     per 4096-run tile: its output offset; the output size
``expand``          counts + values → bytes
==================  =================================================

The first four replace ``rl_encode_pallas`` (+ ``rl_split_packed``), the
last two ``_decode_impl`` behind ``rl_decode_pallas`` and
``rl_decode_packed_pallas``.

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

from .fl_dense_cuda import _aligned, _check, _launch, _on_cuda, _stream

RUN_CAP = 255
# Bytes of an encode tile and runs of a decode tile (kScanTile in
# csrc/scan.cuh).
TILE = 4096
_NONE = torch.iinfo(torch.int64).min
_NONE_HI = torch.iinfo(torch.int64).max

LAUNCHES = {"rl_flags": 0, "rl_scan": 0, "rl_compact": 0, "rl_counts": 0,
            "rl_offsets": 0, "rl_expand": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tiles(items: int) -> int:
    return -(-items // TILE)


def _check_prev(prev: int) -> None:
    if not -1 <= prev <= 255:
        raise ValueError(f"prev must be in -1..255, got {prev}")


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


def piece_tiles_ref(x: torch.Tensor, prev: int = -1) -> torch.Tensor:
    """``summ i64[T, 3]``: per tile its first natural run start (the
    tile's end if none), its last (INT64_MIN if none) and the pieces at
    or after its first."""
    n = x.numel()
    T = _tiles(n)
    nat = torch.zeros(T * TILE, dtype=torch.bool, device=x.device)
    nat[:n] = _natural(x, prev)
    nat = nat.view(T, TILE)
    pos = torch.arange(T * TILE, dtype=torch.int64,
                       device=x.device).view(T, TILE)
    ends = ((torch.arange(T, device=x.device) + 1) * TILE).clamp(max=n)
    first = torch.minimum(torch.where(nat, pos, _NONE_HI).amin(1), ends)
    last = torch.where(nat, pos, _NONE).amax(1)
    local = torch.cummax(torch.where(nat, pos, -1), 1).values
    after = ((local >= 0) & (pos < n)
             & ((pos - local) % RUN_CAP == 0)).sum(1)
    return torch.stack([first, last, after], 1)


def piece_offsets_ref(summ: torch.Tensor, n: int, d0: int = 0):
    """``(tstart i64[T+1], offs i64[T+1])`` from the tile summaries:
    tstart[t] = the natural run start in progress at tile t's first byte
    (tstart[T]: at the chunk's last byte); offs = exclusive scan of the
    pieces per tile, offs[T] = R."""
    first, last, after = summ.unbind(1)
    T = summ.shape[0]
    tstart = torch.cummax(torch.cat([last.new_tensor([-d0]), last]),
                          0).values
    s = tstart[:T]
    b0 = torch.arange(T, dtype=torch.int64, device=summ.device) * TILE
    caps = torch.where(first > b0,
                       (first - 1 - s) // RUN_CAP - (b0 - 1 - s) // RUN_CAP,
                       0)
    offs = torch.zeros(T + 1, dtype=torch.int64, device=summ.device)
    torch.cumsum(after + caps, 0, out=offs[1:])
    return tstart, offs


def compact_ref(x: torch.Tensor, prev: int, tstart: torch.Tensor,
                offs: torch.Tensor):
    """``(values u8[R], starts8 u8[R])``: each piece's byte and the low
    byte of its start position."""
    if x.numel() == 0:
        empty = torch.zeros(0, dtype=torch.uint8, device=x.device)
        return empty, empty.clone()
    pos = _pieces(x, prev, int(tstart[0]))
    return x[pos], (pos & 0xFF).to(torch.uint8)


def piece_counts_ref(starts8: torch.Tensor, n: int) -> torch.Tensor:
    """``counts u8[R]``: start-byte differences mod 256, the last piece
    measured to n."""
    s = starts8.to(torch.int64)
    nxt = torch.cat([s[1:], s.new_tensor([n & 0xFF])])
    return ((nxt - s) & 0xFF).to(torch.uint8)


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
    """Each value repeated its count: u8[n]."""
    return torch.repeat_interleave(values, counts.to(torch.int64))


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def piece_tiles(x: torch.Tensor, prev: int = -1) -> torch.Tensor:
    """Tile summaries ``summ i64[T, 3]`` of the chunk ``x`` u8[n]; see
    :func:`piece_tiles_ref`."""
    _check(x, "x", torch.uint8)
    _check_prev(prev)
    if not _on_cuda(x):
        return piece_tiles_ref(x, prev)
    _aligned(x, "x")
    n = x.numel()
    summ = torch.empty((_tiles(n), 3), dtype=torch.int64, device=x.device)
    _launch("flrl_rl_piece_tiles", x.data_ptr(), n, prev, summ.data_ptr(),
            x.device.index, _stream(x))
    LAUNCHES["rl_flags"] += 1
    return summ


def piece_offsets(summ: torch.Tensor, n: int, d0: int = 0):
    """``(tstart i64[T+1], offs i64[T+1])``; see :func:`piece_offsets_ref`."""
    T = _tiles(n)
    if (summ.dtype != torch.int64 or tuple(summ.shape) != (T, 3)
            or not summ.is_contiguous()):
        raise ValueError(f"summ: expected a contiguous ({T}, 3) int64 "
                         f"tensor, got {summ.dtype} {tuple(summ.shape)}")
    if d0 < 0:
        raise ValueError(f"d0 must be >= 0, got {d0}")
    if not _on_cuda(summ):
        return piece_offsets_ref(summ, n, d0)
    tstart = torch.empty(T + 1, dtype=torch.int64, device=summ.device)
    offs = torch.empty(T + 1, dtype=torch.int64, device=summ.device)
    _launch("flrl_rl_piece_offsets", summ.data_ptr(), n, d0,
            tstart.data_ptr(), offs.data_ptr(), summ.device.index,
            _stream(summ))
    LAUNCHES["rl_scan"] += 1
    return tstart, offs


def compact(x: torch.Tensor, prev: int, tstart: torch.Tensor,
            offs: torch.Tensor):
    """``(values u8[R], starts8 u8[R])`` of the chunk ``x``, R =
    ``offs[-1]``; see :func:`compact_ref`."""
    _check(x, "x", torch.uint8)
    _check_prev(prev)
    T = _tiles(x.numel())
    _check(tstart, "tstart", torch.int64, T + 1)
    _check(offs, "offs", torch.int64, T + 1)
    if not _on_cuda(x, tstart, offs):
        return compact_ref(x, prev, tstart, offs)
    _aligned(x, "x")
    R = int(offs[-1])
    values = torch.empty(R, dtype=torch.uint8, device=x.device)
    starts8 = torch.empty(R, dtype=torch.uint8, device=x.device)
    _launch("flrl_rl_compact", x.data_ptr(), x.numel(), prev,
            tstart.data_ptr(), offs.data_ptr(), values.data_ptr(),
            starts8.data_ptr(), x.device.index, _stream(x))
    LAUNCHES["rl_compact"] += 1
    return values, starts8


def piece_counts(starts8: torch.Tensor, n: int) -> torch.Tensor:
    """``counts u8[R]`` of a chunk of n bytes; see
    :func:`piece_counts_ref`."""
    _check(starts8, "starts8", torch.uint8)
    R = starts8.numel()
    if n < R:
        raise ValueError(f"{R} pieces cannot come from {n} bytes")
    if not _on_cuda(starts8):
        return piece_counts_ref(starts8, n)
    counts = torch.empty(R, dtype=torch.uint8, device=starts8.device)
    _launch("flrl_rl_counts", starts8.data_ptr(), R, n, counts.data_ptr(),
            starts8.device.index, _stream(starts8))
    LAUNCHES["rl_counts"] += 1
    return counts


def run_offsets(counts: torch.Tensor) -> torch.Tensor:
    """``offs i64[T+1]`` of the run counts ``counts`` u8[R]; see
    :func:`run_offsets_ref`."""
    _check(counts, "counts", torch.uint8)
    if not _on_cuda(counts):
        return run_offsets_ref(counts)
    _aligned(counts, "counts")
    offs = torch.empty(_tiles(counts.numel()) + 1, dtype=torch.int64,
                       device=counts.device)
    _launch("flrl_rl_run_offsets", counts.data_ptr(), counts.numel(),
            offs.data_ptr(), counts.device.index, _stream(counts))
    LAUNCHES["rl_offsets"] += 1
    return offs


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
    LAUNCHES["rl_expand"] += 1
    return out
