"""Flat-tile primitives on the GPU, beside their plain PyTorch versions.

Counterpart of the JAX package's ``ops/lanes.py`` as its test harness runs
it (the Pallas kernel ``_run`` of ``tests/test_lanes.py:18``, one lane
function over an ``(R, 128)`` int32 tile), and of the round-latency probe
``make`` of ``experiments/exp33_round_latency.py:42``.  A tile is
``rows × 128`` int32 in flat row-major order, ``rows`` a power of two from
8 to 256; a tensor of shape ``(..., rows, 128)`` holds any number of
independent tiles.  One
kernel, ``flrl_tile_op`` in ``csrc/lanes.cu``, computes every op; the
wrappers keep ``ops/lanes.py``'s names:

=========================  ===============================================
``flat_shift_down``        y[p] = x[p+m], ``fill`` past the end (m static)
``flat_shift_up``          y[p] = x[p−m], ``fill`` before the start
``flat_shift_down_dyn``    as ``flat_shift_down``, m an int32 on the device
``flat_shift_up_dyn``      as ``flat_shift_up``, m an int32 on the device
``prefix_max_flat``        inclusive prefix max (from ``fill``)
``prefix_sum_flat``        inclusive prefix sum, wrapping as int32 does
``suffix_min_flat``        inclusive suffix min (from ``fill``)
``compact_lsb``            each live route word down by its distance
``expand_msb``             each live route word up by its distance
``rounds``                 d rounds of y = 3·y + roll(y, 1) on each row
=========================  ===============================================

A route word is ``live<<31 | dist<<16 | payload16`` (``pack_route``); a live
word with ``r = dist & (2^nbits − 1)`` moves to p ∓ r with r·2^16
subtracted, every other slot becomes 0, and a word that would leave the
tile is dropped.  The JAX networks consume the same low ``nbits`` bits in
``nbits`` rounds; on their domain (dead words 0, monotone distances, so no
two words meet) the direct scatter gives the same words.

A wrapper given CPU tensors returns its plain version (``*_ref``); given
CUDA tensors it launches the kernel on the current stream or raises.  Each
launch adds one to ``LAUNCHES["tile_op"]``, a launch of ``rounds`` to
``LAUNCHES["tile_rounds"]``.  A tensor of no tiles launches
nothing.  A dynamic shift reads its m on the device: nothing is read back.
"""

from __future__ import annotations

import torch

from .fl_dense_cuda import (_aligned, _launch, _on_cuda, _stream,
                            count_launch, reset_table)

LANES = 128
MIN_ROWS = 8                 # kTileMinRows in csrc/lanes.cuh
MAX_ROWS = 256               # kTileMaxRows: 2^15 elements, the routing cap
I32MIN = -(2 ** 31)
I32MAX = 2 ** 31 - 1
LIVE = I32MIN                # the sign bit: w < 0 ⇔ live
DIST_SHIFT = 16
MAX_NBITS = 15               # the dist field is bits 16..30
# op names in the order of csrc/lanes.cuh's FlrlTileOp
OPS = ("shift_down", "shift_up", "shift_down_dyn", "shift_up_dyn",
       "prefix_max", "prefix_sum", "suffix_min", "compact", "expand",
       "rounds")

LAUNCHES = {"tile_op": 0, "tile_rounds": 0}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def _rows(x: torch.Tensor, name: str = "x") -> int:
    """The tile rows of ``x``, int32 ``(..., rows, 128)``, contiguous."""
    if (x.dtype != torch.int32 or x.dim() < 2 or x.shape[-1] != LANES
            or not x.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous int32 tensor of "
                         f"shape (..., rows, {LANES}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    rows = x.shape[-2]
    if not MIN_ROWS <= rows <= MAX_ROWS or rows & (rows - 1):
        raise ValueError(f"{name}: rows must be a power of two in "
                         f"{MIN_ROWS}..{MAX_ROWS}, got {rows}")
    return rows


def _int32(v: int, name: str) -> int:
    if not isinstance(v, int) or not I32MIN <= v <= I32MAX:
        raise ValueError(f"{name} must be an int32, got {v!r}")
    return v


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``x`` as (tiles, N)."""
    return x.reshape(-1, x.shape[-2] * LANES)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32, mod 2^32 (two's complement)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _tile_op(op: str, x: torch.Tensor, aux: int = 0, fill: int = 0,
             m_dev: torch.Tensor | None = None) -> torch.Tensor:
    rows = x.shape[-2]
    _aligned(x, "x")
    out = torch.empty_like(x)
    tiles = x.numel() // (rows * LANES)
    if tiles:
        _launch("flrl_tile_op", OPS.index(op), x.data_ptr(), aux, fill,
                None if m_dev is None else m_dev.data_ptr(), out.data_ptr(),
                rows, tiles, x.device.index, _stream(x))
        count_launch(LAUNCHES, "tile_op", x.device)
    return out


# ---------------------------------------------------------------------------
# Shifts
# ---------------------------------------------------------------------------

def _shift_ref(x: torch.Tensor, by, fill: int) -> torch.Tensor:
    """y[p] = x[p + by] where it lies in the tile, else fill; ``by`` an int
    or a one-element tensor."""
    xf = _flat(x)
    n = xf.shape[1]
    src = torch.arange(n, device=x.device) + by
    inside = (src >= 0) & (src < n)
    y = xf[:, src.clamp(0, n - 1)]
    return torch.where(inside, y, torch.full_like(y, fill)).reshape(x.shape)


def _check_m(m: torch.Tensor) -> None:
    if m.dtype != torch.int32 or m.numel() != 1:
        raise ValueError(f"m: expected a one-element int32 tensor, got "
                         f"{m.dtype} {tuple(m.shape)}")


def flat_shift_down_ref(x: torch.Tensor, m: int, fill: int) -> torch.Tensor:
    return _shift_ref(x, m, fill)


def flat_shift_up_ref(x: torch.Tensor, m: int, fill: int) -> torch.Tensor:
    return _shift_ref(x, -m, fill)


def flat_shift_down_dyn_ref(x: torch.Tensor, m: torch.Tensor,
                            fill: int) -> torch.Tensor:
    return _shift_ref(x, m.reshape(1).to(torch.int64), fill)


def flat_shift_up_dyn_ref(x: torch.Tensor, m: torch.Tensor,
                          fill: int) -> torch.Tensor:
    return _shift_ref(x, -m.reshape(1).to(torch.int64), fill)


def flat_shift_down(x: torch.Tensor, m: int, fill: int) -> torch.Tensor:
    """y_flat[p] = x_flat[p+m] within each tile; the tail is ``fill``."""
    _rows(x)
    _int32(fill, "fill")
    if not isinstance(m, int) or m < 0:
        raise ValueError(f"m must be a non-negative int, got {m!r}")
    if not _on_cuda(x):
        return flat_shift_down_ref(x, m, fill)
    return _tile_op("shift_down", x, m, fill)


def flat_shift_up(x: torch.Tensor, m: int, fill: int) -> torch.Tensor:
    """y_flat[p] = x_flat[p−m] within each tile; the head is ``fill``."""
    _rows(x)
    _int32(fill, "fill")
    if not isinstance(m, int) or m < 0:
        raise ValueError(f"m must be a non-negative int, got {m!r}")
    if not _on_cuda(x):
        return flat_shift_up_ref(x, m, fill)
    return _tile_op("shift_up", x, m, fill)


def flat_shift_down_dyn(x: torch.Tensor, m: torch.Tensor,
                        fill: int) -> torch.Tensor:
    """:func:`flat_shift_down` with ``m`` a one-element int32 tensor on
    ``x``'s device, 0 ≤ m < N, read by the kernel."""
    _rows(x)
    _int32(fill, "fill")
    _check_m(m)
    if not _on_cuda(x, m):
        return flat_shift_down_dyn_ref(x, m, fill)
    return _tile_op("shift_down_dyn", x, 0, fill, m)


def flat_shift_up_dyn(x: torch.Tensor, m: torch.Tensor,
                      fill: int) -> torch.Tensor:
    """:func:`flat_shift_up` with ``m`` a one-element int32 tensor on
    ``x``'s device, 0 ≤ m < N, read by the kernel."""
    _rows(x)
    _int32(fill, "fill")
    _check_m(m)
    if not _on_cuda(x, m):
        return flat_shift_up_dyn_ref(x, m, fill)
    return _tile_op("shift_up_dyn", x, 0, fill, m)


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def prefix_max_flat_ref(x: torch.Tensor, fill: int = I32MIN) -> torch.Tensor:
    y = torch.cummax(_flat(x), dim=1).values
    return torch.clamp(y, min=fill).reshape(x.shape)


def prefix_sum_flat_ref(x: torch.Tensor) -> torch.Tensor:
    y = torch.cumsum(_flat(x), dim=1, dtype=torch.int64)
    return _wrap32(y).reshape(x.shape)


def suffix_min_flat_ref(x: torch.Tensor, fill: int = I32MAX) -> torch.Tensor:
    y = torch.cummin(_flat(x).flip(1), dim=1).values.flip(1)
    return torch.clamp(y, max=fill).reshape(x.shape)


def prefix_max_flat(x: torch.Tensor, fill: int = I32MIN) -> torch.Tensor:
    """Inclusive prefix max over each tile's flat order, from ``fill``."""
    _rows(x)
    _int32(fill, "fill")
    if not _on_cuda(x):
        return prefix_max_flat_ref(x, fill)
    return _tile_op("prefix_max", x, 0, fill)


def prefix_sum_flat(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over each tile's flat order, mod 2^32."""
    _rows(x)
    if not _on_cuda(x):
        return prefix_sum_flat_ref(x)
    return _tile_op("prefix_sum", x)


def suffix_min_flat(x: torch.Tensor, fill: int = I32MAX) -> torch.Tensor:
    """Inclusive suffix min over each tile's flat order, from ``fill``."""
    _rows(x)
    _int32(fill, "fill")
    if not _on_cuda(x):
        return suffix_min_flat_ref(x, fill)
    return _tile_op("suffix_min", x, 0, fill)


# ---------------------------------------------------------------------------
# Monotone routes
# ---------------------------------------------------------------------------

def pack_route(live: torch.Tensor, dist: torch.Tensor,
               payload16: torch.Tensor) -> torch.Tensor:
    """``live<<31 | dist<<16 | payload16`` where live, else 0 (int32)."""
    word = ((dist.to(torch.int32) << DIST_SHIFT) | payload16.to(torch.int32)
            | LIVE)
    return torch.where(live, word, torch.zeros_like(word))


def _check_nbits(nbits: int) -> None:
    if not isinstance(nbits, int) or not 0 <= nbits <= MAX_NBITS:
        raise ValueError(f"nbits must be in 0..{MAX_NBITS}, got {nbits!r}")


def _route_ref(w: torch.Tensor, nbits: int, sign: int) -> torch.Tensor:
    wf = _flat(w)
    tiles, n = wf.shape
    r = (wf >> DIST_SHIFT) & ((1 << nbits) - 1)
    dest = torch.arange(n, device=w.device) + sign * r
    keep = (wf < 0) & (dest >= 0) & (dest < n)
    tile = torch.arange(tiles, device=w.device).unsqueeze(1).expand_as(wf)
    out = torch.zeros_like(wf)
    out.index_put_((tile[keep], dest[keep]),
                   (wf - (r << DIST_SHIFT))[keep])
    return out.reshape(w.shape)


def compact_lsb_ref(w: torch.Tensor, nbits: int) -> torch.Tensor:
    return _route_ref(w, nbits, -1)


def expand_msb_ref(w: torch.Tensor, nbits: int) -> torch.Tensor:
    return _route_ref(w, nbits, 1)


def compact_lsb(w: torch.Tensor, nbits: int) -> torch.Tensor:
    """Every live word down by its distance's low ``nbits`` bits."""
    _rows(w, "w")
    _check_nbits(nbits)
    if not _on_cuda(w):
        return compact_lsb_ref(w, nbits)
    return _tile_op("compact", w, nbits)


def expand_msb(w: torch.Tensor, nbits: int) -> torch.Tensor:
    """Every live word up by its distance's low ``nbits`` bits."""
    _rows(w, "w")
    _check_nbits(nbits)
    if not _on_cuda(w):
        return expand_msb_ref(w, nbits)
    return _tile_op("expand", w, nbits)


# ---------------------------------------------------------------------------
# Dependent rounds
# ---------------------------------------------------------------------------

def _check_rounds(x: torch.Tensor, d: int) -> None:
    if (x.dtype != torch.int32 or x.dim() < 2 or x.shape[-1] != LANES
            or not x.is_contiguous() or (x.numel() // LANES) % MIN_ROWS):
        raise ValueError(f"x: expected a contiguous int32 tensor of shape "
                         f"(..., rows, {LANES}), rows in all a multiple of "
                         f"{MIN_ROWS}, got {x.dtype} {tuple(x.shape)}")
    if not isinstance(d, int) or not 0 <= d <= I32MAX:
        raise ValueError(f"d must be a non-negative int32, got {d!r}")


def rounds_ref(x: torch.Tensor, d: int) -> torch.Tensor:
    y = x.to(torch.int64)
    for _ in range(d):
        y = (y * 3 + torch.roll(y, 1, dims=-1)) & 0xFFFFFFFF
    return _wrap32(y)


def rounds(x: torch.Tensor, d: int) -> torch.Tensor:
    """``d`` rounds of y[l] = 3·y[l] + y[l − 1 mod 128] on each row of 128,
    wrapping as int32 does; any number of rows that is a multiple of 8 (the
    kernel takes them as 8-row tiles)."""
    _check_rounds(x, d)
    if not _on_cuda(x):
        return rounds_ref(x, d)
    _aligned(x, "x")
    out = torch.empty_like(x)
    tiles = x.numel() // (MIN_ROWS * LANES)
    if tiles:
        _launch("flrl_tile_op", OPS.index("rounds"), x.data_ptr(), d, 0, None,
                out.data_ptr(), MIN_ROWS, tiles, x.device.index, _stream(x))
        count_launch(LAUNCHES, "tile_rounds", x.device)
    return out
