"""The plain reference that decides ``correct``: the FL and RL codecs
written out from their definitions in plain PyTorch, importing nothing of
the program.  It runs wherever its input lies (the card after the window,
the CPU in the tests) and is written for clarity, not speed.

FL (the reference binary's CPU codec, ``fl_cpu.cu:9-90``): the stream is
cut into frames of L bytes; a frame's width is the bit length of its
largest byte, at least 1; every byte of the frame is written in that many
bits, least significant bit first, frame after frame, from bit 0 of the
payload; the payload is rounded up to whole bytes.  The container is
``[n u64][frames u64][payload bytes u64][widths][payload]``, little-endian.

RL (``IMPLEMENTATION-PLAN.md:81-179``): the stream's maximal runs of one
byte value, each cut into pieces of 255 and a remainder; a piece is its
count and its value.  The container is ``[n u64][pieces u64][pieces u64]
[counts][values]``.

Both are computed here from the bit positions and run boundaries
themselves, not from any table or kernel of the program.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import torch

RUN_CAP = 255
# input bytes a block of the FL encode: its int64 and int32 temporaries
# take about 60 bytes an input byte, so a block needs about 8 GiB
BLOCK_BYTES = 1 << 27


@dataclass
class Container:
    """A container's three fields as tensors (on any device)."""
    input_size: int
    first: torch.Tensor    # FL widths / RL counts, u8
    second: torch.Tensor   # FL payload / RL values, u8

    def header(self) -> bytes:
        return struct.pack("<QQQ", self.input_size, self.first.numel(),
                           self.second.numel())


def fl_widths(x: torch.Tensor, L: int) -> torch.Tensor:
    """u8[F]: each frame's width, the bit length of its largest byte, at
    least 1 (the last frame may be short)."""
    n = x.numel()
    frames = -(-n // L)
    padded = torch.zeros(frames * L, dtype=torch.uint8, device=x.device)
    padded[:n] = x
    top = padded.view(frames, L).amax(1).to(torch.int32)
    width = torch.ones_like(top)
    for b in range(1, 8):
        width += (top >> b) > 0
    return width.to(torch.uint8)


def fl_encode(x: torch.Tensor, L: int) -> Container:
    """The FL container of the u8 stream ``x``."""
    n = x.numel()
    if n == 0:
        empty = torch.zeros(0, dtype=torch.uint8, device=x.device)
        return Container(0, empty, empty.clone())
    widths = fl_widths(x, L)
    frames = widths.numel()
    counts = torch.full((frames,), L, dtype=torch.int64, device=x.device)
    counts[-1] = n - L * (frames - 1)
    frame_bits = counts * widths.to(torch.int64)
    start = torch.zeros(frames, dtype=torch.int64, device=x.device)
    start[1:] = torch.cumsum(frame_bits, 0)[:-1]
    total_bits = int(frame_bits.sum())
    # payload bytes held as int32 sums: the values' bit fields never
    # overlap, so adding them is OR-ing them
    acc = torch.zeros(-(-total_bits // 8) + 1, dtype=torch.int32,
                      device=x.device)
    step = max(1, BLOCK_BYTES // L)
    for f0 in range(0, frames, step):
        f1 = min(frames, f0 + step)
        a, b = f0 * L, min(n, f1 * L)
        pos = torch.arange(a, b, dtype=torch.int64, device=x.device)
        frame = pos // L
        w = widths[frame].to(torch.int64)
        bit = start[frame] + (pos - frame * L) * w
        v = x[a:b].to(torch.int32)
        byte, off = bit // 8, (bit % 8).to(torch.int32)
        acc.index_add_(0, byte, (v << off) & 0xFF)
        spill = (off + w.to(torch.int32)) > 8
        acc.index_add_(0, byte[spill] + 1, v[spill] >> (8 - off[spill]))
    payload = acc[:-(-total_bits // 8)].to(torch.uint8)
    return Container(n, widths, payload)


def rl_encode(x: torch.Tensor) -> Container:
    """The RL container of the u8 stream ``x``."""
    n = x.numel()
    if n == 0:
        empty = torch.zeros(0, dtype=torch.uint8, device=x.device)
        return Container(0, empty, empty.clone())
    change = torch.nonzero(x[1:] != x[:-1]).reshape(-1) + 1
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=x.device),
                        change])
    ends = torch.cat([change, torch.full((1,), n, dtype=torch.int64,
                                         device=x.device)])
    lengths = ends - starts
    pieces = (lengths + RUN_CAP - 1) // RUN_CAP
    total = int(pieces.sum())
    values = torch.repeat_interleave(x[starts], pieces, output_size=total)
    counts = torch.full((total,), RUN_CAP, dtype=torch.int64,
                        device=x.device)
    last = torch.cumsum(pieces, 0) - 1
    counts[last] = lengths - RUN_CAP * (pieces - 1)
    return Container(n, counts.to(torch.uint8), values)


def encode(family: str, x: torch.Tensor, L: int) -> Container:
    return fl_encode(x, L) if family == "fl" else rl_encode(x)


def count_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Bytes that differ between two u8 streams, a missing or extra byte
    counted as differing."""
    m = min(a.numel(), b.numel())
    return int((a[:m] != b[:m]).sum()) + abs(a.numel() - b.numel())


def container_bytes_wrong(got: Container, want: Container) -> int:
    """Bytes of the saved container ``got`` that differ from ``want``'s:
    the 24-byte header, then each field."""
    dev = want.first.device
    heads = [torch.tensor(list(c.header()), dtype=torch.uint8, device=dev)
             for c in (got, want)]
    return (count_differing(*heads)
            + count_differing(got.first.to(dev), want.first)
            + count_differing(got.second.to(dev), want.second))


def to_bytes(c: Container) -> bytes:
    """The container as its file holds it."""
    return (c.header() + c.first.cpu().numpy().tobytes()
            + c.second.cpu().numpy().tobytes())
