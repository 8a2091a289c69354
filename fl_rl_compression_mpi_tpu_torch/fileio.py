"""Raw file I/O (reference component #3-4).

``load_file``/``save_file`` mirror ``FileIO::loadFile``/``saveFile``
(``reference/src/file_io.cu:73-115,194-220``).  ``load_file_sharded``
is the analog of the per-rank ``loadFileMpi`` (``file_io.cu:28-71``): read
one frame-aligned chunk of a shared input — used by the multi-host path
where each host reads only its slice.  All size math is 64-bit (the
reference's ``int`` arithmetic overflows past 2 GB/rank, ``file_io.cu:46-51``
— documented defect, not replicated).

When the optional native helper library (``csrc/flrlio.cpp``, built to
``_build/libflrlio.so``) is present, bulk reads/writes go through it
(mmap + madvise readahead); otherwise NumPy's buffered I/O is used.  Both
paths produce identical bytes.
"""

from __future__ import annotations

import os

import numpy as np

from .native import get_native


def load_file(path: str) -> np.ndarray:
    """Whole file → u8 array."""
    nat = get_native()
    if nat is not None:
        return nat.read_file(path)
    return np.fromfile(path, np.uint8)


def load_file_sharded(path: str, shard: int, num_shards: int,
                      frame_length: int = 128):
    """Read this shard's frame-aligned chunk of a shared file.

    Split rule is the reference's (``file_io.cu:46-51``):
    ``chunk = (size // (L·N)) · L``; the last shard takes the remainder.
    Returns ``(data u8[chunk_i], offset)``.
    """
    size = os.path.getsize(path)
    chunk = (size // (frame_length * num_shards)) * frame_length
    off = shard * chunk
    length = size - off if shard == num_shards - 1 else chunk
    nat = get_native()
    if nat is not None:
        return nat.read_range(path, off, length), off
    with open(path, "rb") as f:
        f.seek(off)
        return np.frombuffer(f.read(length), np.uint8), off


def load_range(path: str, off: int, length: int) -> np.ndarray:
    """Read ``[off, off+length)`` of a file (multi-host processes pull only
    their own container/input slices — nothing reads O(total) remotely)."""
    if length <= 0:
        return np.zeros(0, np.uint8)
    nat = get_native()
    if nat is not None:
        return nat.read_range(path, off, length)
    with open(path, "rb") as f:
        f.seek(off)
        return np.frombuffer(f.read(length), np.uint8)


def save_file(path: str, data: np.ndarray) -> None:
    data = np.ascontiguousarray(data, np.uint8)
    nat = get_native()
    if nat is not None:
        nat.write_file(path, data)
        return
    data.tofile(path)
