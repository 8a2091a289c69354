"""The tile-packed field codec on the GPU, beside its plain PyTorch version.

Counterpart of the TPU kernels ``enc_packed`` and ``dec_packed`` of
``experiments/exp21_tile_packed.py`` (the cursor layout) and
``experiments/exp22_tile_packed2.py`` (the sparse layout), a codec layout
the product never kept.  The kernels live in ``csrc/tile_packed.cu``; their
wrappers here are

==========  ======================================================
``encode``  words → (widths, packed rows, row offsets or None)
``decode``  widths + packed rows (+ row offsets) → words
==========  ======================================================

Words are u32 in rows of 128, four frames of 32 words a row, carried as
int32 bit-views (on the CPU ``torch.uint32`` has no shifts or comparisons,
so the plain versions compute in int64).  The stream is ``nrows`` rows cut
into tiles of ``R`` rows (R % 8 == 0, nrows % R == 0).  A frame's width b
is max(1, bitlen(OR of its bytes)) and each word's field
e0 | e1<<b | e2<<2b | e3<<3b, as in ``fl_fields_cuda``.  A tile whose
widest frame has width bt packs 2^d fields a word, d = 3, 2, 1, 0 for
bt ≤ 1, 2, 4, else, by d halvings ``x[:m/2] | x[m/2:] << (16 >> i)`` into
R >> d packed rows.  The cursor layout puts tile t's rows at ``offs[t]``
(``offs[tiles]`` the total); the sparse layout at row t·R.  Packed rows
outside the tiles' rows are unspecified (the kernel leaves them unwritten;
the plain version zeroes them).

A wrapper given CPU tensors returns its plain version (``*_ref``); given
CUDA tensors it launches on the current stream or raises.  Each call of
``encode`` adds one to ``LAUNCHES["tile_packed_encode"]`` (its entry point
runs two kernels, or three in the cursor layout), each call of ``decode``
one to ``LAUNCHES["tile_packed_decode"]`` (two kernels).
"""

from __future__ import annotations

import torch

from .fl_dense_cuda import (_aligned, _launch, _on_cuda, _stream,
                            count_launch, reset_table)

LANES = 128
FRAMES = 4                      # frames a row
WPF = LANES // FRAMES           # words a frame
LAYOUTS = ("cursor", "sparse")
_MASKS = {0: 0xFFFF, 1: 0x00FF00FF, 2: 0x0F0F0F0F}

LAUNCHES = {"tile_packed_encode": 0, "tile_packed_decode": 0}


def reset_launches() -> None:
    reset_table(LAUNCHES)


def _rows(words: torch.Tensor, R: int, name: str = "words") -> int:
    """The rows of ``words`` (int32, contiguous, a multiple of 128
    elements), checked against the tile size R."""
    if (words.dtype != torch.int32 or not words.is_contiguous()
            or words.numel() % LANES):
        raise ValueError(f"{name}: expected a contiguous int32 tensor of rows "
                         f"of {LANES}, got {words.dtype} "
                         f"{tuple(words.shape)}")
    nrows = words.numel() // LANES
    if not isinstance(R, int) or R <= 0 or R % 8 or nrows % R:
        raise ValueError(f"R must be a positive multiple of 8 dividing the "
                         f"{nrows} rows, got {R!r}")
    return nrows


def _check_bits(bits: torch.Tensor, nrows: int) -> None:
    if (bits.dtype != torch.uint8 or not bits.is_contiguous()
            or bits.numel() != nrows * FRAMES):
        raise ValueError(f"bits: expected a contiguous uint8 tensor of "
                         f"{nrows * FRAMES} widths, got {bits.dtype} "
                         f"{tuple(bits.shape)}")


def _check_offs(offs: torch.Tensor | None, tiles: int) -> None:
    if offs is not None and (offs.dtype != torch.int32 or offs.dim() != 1
                             or offs.numel() != tiles + 1
                             or not offs.is_contiguous()):
        raise ValueError(f"offs: expected int32[{tiles + 1}], got "
                         f"{offs.dtype} {tuple(offs.shape)}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (int64 arithmetic on u32 values).
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def depths(bits: torch.Tensor, R: int) -> torch.Tensor:
    """int64[tiles]: each tile's pack depth from its widest frame."""
    bt = bits.reshape(-1, R * FRAMES).to(torch.int64).amax(dim=1)
    return torch.where(bt <= 1, 3, torch.where(bt <= 2, 2,
                                               torch.where(bt <= 4, 1, 0)))


def tile_rows(bits: torch.Tensor, R: int) -> torch.Tensor:
    """int64[tiles]: each tile's packed rows, R >> d."""
    return R >> depths(bits, R)


def defined_rows(bits: torch.Tensor, R: int,
                 offs: torch.Tensor | None = None) -> torch.Tensor:
    """int64 indices of the packed rows that hold the tiles' rows: [0,
    total) in the cursor layout (``offs`` given), each tile's first R >> d
    rows from t·R in the sparse layout."""
    rows = tile_rows(bits, R)
    if offs is not None:
        return torch.arange(int(rows.sum()), device=bits.device)
    start = torch.arange(rows.numel(), device=bits.device) * R
    return torch.repeat_interleave(start, rows) + (
        torch.arange(int(rows.sum()), device=bits.device)
        - torch.repeat_interleave(torch.cumsum(rows, 0) - rows, rows))


def _widths(w: torch.Tensor) -> torch.Tensor:
    """int64 (nrows, 4): max(1, bitlen(OR of the frame's bytes))."""
    o = w | (w >> 16)
    o = (o | (o >> 8)) & 0xFF
    fo = o.view(-1, FRAMES, WPF).amax(dim=2)
    bits = torch.ones_like(fo)
    for k in range(1, 8):
        bits += (fo >= (1 << k)).to(torch.int64)
    return bits


def _per_lane(bits: torch.Tensor) -> torch.Tensor:
    """(rows, 4) widths → (rows, 128), each frame's width on its words."""
    return bits.repeat_interleave(WPF, dim=1)


def _starts(rows: torch.Tensor, R: int, cursor: bool) -> torch.Tensor:
    """int64[tiles + 1]: each tile's first packed row (cursor: the
    exclusive scan of the row counts, the total last; sparse: t·R)."""
    tiles = rows.numel()
    if not cursor:
        return torch.arange(tiles + 1, device=rows.device) * R
    offs = torch.zeros(tiles + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(rows, 0, out=offs[1:])
    return offs


def encode_ref(words: torch.Tensor, R: int, layout: str = "cursor"):
    """``(bits u8 (nrows, 4), packed int32 (nrows, 128), offs int32
    (tiles + 1,) or None)`` of ``words`` (nrows·128 int32); rows of
    ``packed`` outside the tiles' rows are 0."""
    nrows = _rows(words, R)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    w = _u32(words).view(nrows, LANES)
    bits = _widths(w)
    b = _per_lane(bits)
    fields = ((w & 0xFF) | (((w >> 8) & 0xFF) << b)
              | (((w >> 16) & 0xFF) << 2 * b) | ((w >> 24) << 3 * b))
    bits = bits.to(torch.uint8)
    d = depths(bits, R)
    start = _starts(R >> d, R, layout == "cursor")
    packed = torch.zeros(nrows, LANES, dtype=torch.int64, device=words.device)
    tiled = fields.view(-1, R, LANES)
    for dd in range(4):
        sel = (d == dd).nonzero().squeeze(1)
        if not sel.numel():
            continue
        x = tiled[sel]
        for i in range(dd):
            m = x.shape[1]
            x = x[:, :m // 2] | (x[:, m // 2:] << (16 >> i))
        rows = start[sel].unsqueeze(1) + torch.arange(R >> dd,
                                                      device=words.device)
        packed[rows.reshape(-1)] = x.reshape(-1, LANES)
    offs = start.to(torch.int32) if layout == "cursor" else None
    return bits, _i32(packed), offs


def decode_ref(bits: torch.Tensor, packed: torch.Tensor, R: int,
               offs: torch.Tensor | None = None) -> torch.Tensor:
    """Words int32 (nrows, 128) of the widths ``bits`` (nrows·4 u8) and
    ``packed`` (nrows·128 int32), the tiles' rows at ``offs[t]`` (cursor)
    or at t·R (sparse, ``offs`` None)."""
    nrows = _rows(packed, R, "packed")
    _check_bits(bits, nrows)
    _check_offs(offs, nrows // R)
    p = _u32(packed).view(nrows, LANES)
    d = depths(bits, R)
    start = (offs.to(torch.int64) if offs is not None
             else _starts(R >> d, R, False))
    out = torch.empty(nrows, LANES, dtype=torch.int64, device=packed.device)
    tiled = out.view(-1, R, LANES)
    for dd in range(4):
        sel = (d == dd).nonzero().squeeze(1)
        if not sel.numel():
            continue
        z = p[start[sel].unsqueeze(1) + torch.arange(R >> dd,
                                                     device=p.device)]
        for s in reversed(range(dd)):
            M = _MASKS[s]
            z = torch.cat([z & M, (z >> (16 >> s)) & M], dim=1)
        tiled[sel] = z
    b = _per_lane(bits.view(nrows, FRAMES).to(torch.int64))
    m = (1 << b) - 1
    w = ((out & m) | (((out >> b) & m) << 8) | (((out >> 2 * b) & m) << 16)
         | (((out >> 3 * b) & m) << 24))
    return _i32(w)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def encode(words: torch.Tensor, R: int, layout: str = "cursor"):
    """``(bits u8 (nrows, 4), packed int32 (nrows, 128), offs int32
    (tiles + 1,) or None)`` of ``words``; see :func:`encode_ref`.  Rows of
    ``packed`` outside the tiles' rows are unspecified."""
    nrows = _rows(words, R)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if not _on_cuda(words):
        return encode_ref(words, R, layout)
    _aligned(words, "words")
    dev = words.device
    tiles = nrows // R
    bits = torch.empty(nrows, FRAMES, dtype=torch.uint8, device=dev)
    packed = torch.empty(nrows, LANES, dtype=torch.int32, device=dev)
    cursor = layout == "cursor"
    # the offsets (cursor layout), then the tiles' keys (scratch the
    # launcher clears on the stream)
    buf = torch.empty((tiles + 1 if cursor else 0) + tiles, dtype=torch.int32,
                      device=dev)
    offs = buf[:tiles + 1] if cursor else None
    key = buf[tiles + 1:] if cursor else buf
    _launch("flrl_tile_packed_encode", words.data_ptr(), nrows, R,
            bits.data_ptr(), packed.data_ptr(),
            None if offs is None else offs.data_ptr(), key.data_ptr(),
            dev.index, _stream(words))
    count_launch(LAUNCHES, "tile_packed_encode", dev)
    return bits, packed, offs


def decode(bits: torch.Tensor, packed: torch.Tensor, R: int,
           offs: torch.Tensor | None = None) -> torch.Tensor:
    """Words int32 (nrows, 128) of ``bits`` and ``packed``; see
    :func:`decode_ref`."""
    nrows = _rows(packed, R, "packed")
    _check_bits(bits, nrows)
    tiles = nrows // R
    _check_offs(offs, tiles)
    if not _on_cuda(packed, bits, offs):
        return decode_ref(bits, packed, R, offs)
    _aligned(packed, "packed")
    dev = packed.device
    out = torch.empty(nrows, LANES, dtype=torch.int32, device=dev)
    key = torch.empty(tiles, dtype=torch.int32, device=dev)
    _launch("flrl_tile_packed_decode", bits.data_ptr(), packed.data_ptr(),
            None if offs is None else offs.data_ptr(), nrows, R,
            out.data_ptr(), key.data_ptr(), dev.index, _stream(packed))
    count_launch(LAUNCHES, "tile_packed_decode", dev)
    return out
