"""Streaming (chunked) FL compression: bounded host memory for any file
size.

Counterpart of ``fl_rl_compression_mpi_tpu/stream.py``, with its names,
defaults and file layout.  Frames are byte-aligned, so any frame-aligned
chunking of the input gives the container of the whole-file encode, byte
for byte.  The encode reads fixed-size chunks into one reused buffer and
hands them to ``fl_torch.encode_chunks``, the walk that every FL encode of
this package takes (pipelined: a chunk's copy down and payload write
overlap the next chunk's copy up and kernels).  The container stores the
widths before the payload, so the widths are held in RAM (1/L of the
input) while the payload spools to a ``.flrl.tmp`` file beside the output,
copied behind the header and widths at the end.  The decode reads the
widths once, checks the whole container against them before it writes an
output byte, and walks the payload chunk by chunk through
``fl_torch.decode_chunks``.  Temporary files are removed on every exit.

``device`` is explicit: a CUDA device runs the kernels, the CPU their
plain PyTorch versions.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from .container import _HEADER
from .ops import fl_torch
from .ops.bitpack import FRAME_LENGTH

# frame-aligned chunk
DEFAULT_CHUNK = 256 << 20


def _chunk_bytes(chunk_mb: int | None, frame_length: int) -> int:
    c = DEFAULT_CHUNK if chunk_mb is None else chunk_mb << 20
    c = max(c, frame_length)
    return (c // frame_length) * frame_length


def _read_full(f, buf: np.ndarray) -> int:
    """Fill ``buf`` from ``f``; returns the bytes read (fewer at EOF)."""
    view = memoryview(buf)
    got = 0
    while got < buf.size:
        k = f.readinto(view[got:])
        if not k:
            break
        got += k
    return got


def _tmp_beside(path: str, suffix: str) -> str:
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=suffix)
    os.close(fd)
    return tmp


def compress_fl_stream(input_path: str, output_path: str,
                       frame_length: int = FRAME_LENGTH,
                       chunk_mb: int | None = None, *,
                       device: str | torch.device) -> None:
    """Stream-compress ``input_path`` → FL container, bounded memory."""
    chunk = _chunk_bytes(chunk_mb, frame_length)
    buf = np.empty(min(chunk, os.path.getsize(input_path)), np.uint8)
    total = 0

    def chunks(fin):
        nonlocal total
        while True:
            k = _read_full(fin, buf)
            if not k:
                return
            total += k
            yield buf[:k]           # the walk copies it before the next read

    bits_parts, values_size = [], 0
    tmp_path = _tmp_beside(output_path, ".flrl.tmp")
    try:
        with open(input_path, "rb") as fin, open(tmp_path, "wb") as ftmp:
            for bits, values in fl_torch.encode_chunks(
                    chunks(fin), frame_length, device=device):
                bits_parts.append(bits)
                ftmp.write(values)
                values_size += values.size
        bits_all = (np.concatenate(bits_parts) if bits_parts
                    else np.zeros(0, np.uint8))
        with open(output_path, "wb") as fout:
            fout.write(_HEADER.pack(total, bits_all.size, values_size))
            fout.write(bits_all)
            with open(tmp_path, "rb") as ftmp:
                shutil.copyfileobj(ftmp, fout, 1 << 24)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def verify_fl_stream(input_path: str, container_path: str,
                     frame_length: int = FRAME_LENGTH,
                     chunk_mb: int | None = None, *,
                     device: str | torch.device) -> bool:
    """Round-trip self-check for the streaming path (bounded memory):
    stream-decompress ``container_path`` to a temporary file and compare it
    with ``input_path`` block by block."""
    tmp_path = _tmp_beside(container_path, ".flrl.verify")
    try:
        decompress_fl_stream(container_path, tmp_path, frame_length,
                             chunk_mb, device=device)
        if os.path.getsize(tmp_path) != os.path.getsize(input_path):
            return False
        with open(input_path, "rb") as fa, open(tmp_path, "rb") as fb:
            while True:
                a = fa.read(1 << 24)
                b = fb.read(1 << 24)
                if a != b:
                    return False
                if not a:
                    return True
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def decompress_fl_stream(input_path: str, output_path: str,
                         frame_length: int = FRAME_LENGTH,
                         chunk_mb: int | None = None, *,
                         device: str | torch.device) -> None:
    """Stream-decompress an FL container, bounded memory.

    Reads the widths once (``ceil(n/L)`` bytes), rejects a widths array
    shorter than the frame count, a width byte outside 1..8 and a payload
    shorter than the widths imply before it writes an output byte, then
    walks the payload chunk by chunk."""
    chunk = _chunk_bytes(chunk_mb, frame_length)
    with open(input_path, "rb") as fin:
        head = fin.read(_HEADER.size)
        if len(head) < _HEADER.size:
            raise IOError("[FileIO] corrupt FL container: shorter than its "
                          "header")
        input_size, bits_size, values_size = _HEADER.unpack(head)
        bits_all = np.frombuffer(fin.read(bits_size), np.uint8)
        frames = -(-input_size // frame_length)
        if bits_all.size < frames:
            raise IOError(
                "[FileIO] corrupt FL container: widths array shorter "
                f"than frame count ({bits_all.size} < {frames})")
        if input_size == 0:
            open(output_path, "wb").close()
            return
        # the payload the file holds, past its header and widths
        held = min(values_size,
                   os.fstat(fin.fileno()).st_size - _HEADER.size - bits_size)
        widths = fl_torch.check_widths(input_size, bits_all, held,
                                       frame_length)
        fpc = chunk // frame_length
        # a chunk's payload is at most its bytes (no frame packs to more)
        buf = np.empty(min(chunk, input_size), np.uint8)

        def parts():
            for off in range(0, input_size, chunk):
                n = min(chunk, input_size - off)
                w = widths[off // frame_length:][:fpc]
                size = fl_torch.payload_size(w, n, frame_length)
                if _read_full(fin, buf[:size]) != size:
                    raise IOError("[FileIO] container truncated")
                yield n, w, buf[:size]

        with open(output_path, "wb") as fout:
            for out in fl_torch.decode_chunks(parts(), frame_length,
                                              device=device):
                fout.write(out)
