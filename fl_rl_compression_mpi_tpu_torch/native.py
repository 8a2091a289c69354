"""ctypes bindings for the native host runtime (``csrc/flrlio.cpp``).

The PyTorch package's own copy of ``fl_rl_compression_mpi_tpu/native.py``
and of its C++ source, so that the port imports nothing of the JAX
package.  Loads ``_build/libflrlio.so`` beside this package; if absent or
older than the source, builds it once with g++ (no CUDA toolkit needed)
and caches the handle.  ``FLRL_NO_NATIVE=1`` disables it.  Every entry
point has a pure-NumPy fallback in the callers, so `get_native()`
returning ``None`` (no toolchain, build failure) only costs speed, never
correctness.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_NATIVE = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_PKG_DIR, "_build", "libflrlio.so")
_SRC_PATH = os.path.join(_PKG_DIR, "csrc", "flrlio.cpp")

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


class Native:
    """Typed wrapper over the C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.flrl_file_size.restype = ctypes.c_int64
        lib.flrl_file_size.argtypes = [ctypes.c_char_p]
        lib.flrl_read_file.restype = ctypes.c_int
        lib.flrl_read_file.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int64]
        lib.flrl_read_range.restype = ctypes.c_int
        lib.flrl_read_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _u8p]
        lib.flrl_write_file.restype = ctypes.c_int
        lib.flrl_write_file.argtypes = [ctypes.c_char_p, _u8p,
                                        ctypes.c_int64]
        lib.flrl_write_container.restype = ctypes.c_int
        lib.flrl_write_container.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
            _u8p, ctypes.c_uint64]
        lib.flrl_fl_encode.restype = ctypes.c_int64
        lib.flrl_fl_encode.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int, _u8p, _u8p]
        lib.flrl_fl_decode.restype = ctypes.c_int
        lib.flrl_fl_decode.argtypes = [
            _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, ctypes.c_int,
            _u8p, ctypes.c_int64]
        lib.flrl_fl_fold.restype = ctypes.c_int64
        lib.flrl_fl_fold.argtypes = [_u32p, _u8p, ctypes.c_int64,
                                     ctypes.c_int, _u8p]
        lib.flrl_fl_unfold.restype = ctypes.c_int
        lib.flrl_fl_unfold.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, _u32p]
        lib.flrl_fl_fold_p2.restype = ctypes.c_int64
        lib.flrl_fl_fold_p2.argtypes = [_u16p, _u8p, ctypes.c_int64,
                                        ctypes.c_int, ctypes.c_int, _u8p]
        lib.flrl_fl_unfold_p2.restype = ctypes.c_int
        lib.flrl_fl_unfold_p2.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                          ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int, ctypes.c_int,
                                          _u16p]
        lib.flrl_rl_encode.restype = ctypes.c_int64
        lib.flrl_rl_encode.argtypes = [_u8p, ctypes.c_int64, _u8p, _u8p]
        lib.flrl_rl_decode.restype = ctypes.c_int64
        lib.flrl_rl_decode.argtypes = [_u8p, _u8p, ctypes.c_int64, _u8p,
                                       ctypes.c_int64]

    # -- file I/O ----------------------------------------------------------

    def read_file(self, path: str) -> np.ndarray:
        size = self._lib.flrl_file_size(path.encode())
        if size < 0:
            raise IOError(f"[FileIO] Cannot open file {path}")
        out = np.empty(size, np.uint8)
        if size and self._lib.flrl_read_file(path.encode(), out, size) != 0:
            raise IOError(f"[FileIO] Cannot read file content {path}")
        return out

    def read_range(self, path: str, off: int, length: int) -> np.ndarray:
        out = np.empty(length, np.uint8)
        if length and self._lib.flrl_read_range(
                path.encode(), off, length, out) != 0:
            raise IOError(f"[FileIO] Cannot read file content {path}")
        return out

    def write_file(self, path: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data, np.uint8)
        if self._lib.flrl_write_file(path.encode(), data, data.size) != 0:
            raise IOError(f"[FileIO] Cannot write file {path}")

    def write_container(self, path: str, input_size: int, a: np.ndarray,
                        b: np.ndarray) -> None:
        a = np.ascontiguousarray(a, np.uint8)
        b = np.ascontiguousarray(b, np.uint8)
        if self._lib.flrl_write_container(
                path.encode(), input_size, a, a.size, b, b.size) != 0:
            raise IOError(f"[FileIO] Cannot write file {path}")

    # -- host codecs -------------------------------------------------------

    def fl_encode(self, data: np.ndarray, frame_length: int = 128):
        data = np.ascontiguousarray(data, np.uint8)
        n = data.size
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        frames = -(-n // frame_length)
        bits = np.empty(frames, np.uint8)
        values = np.empty(n + frame_length, np.uint8)
        vsz = self._lib.flrl_fl_encode(data, n, frame_length, bits, values)
        if vsz < 0:
            raise ValueError("fl_encode: bad arguments")
        return bits, values[:vsz].copy()

    def fl_decode(self, output_size: int, bits: np.ndarray,
                  values: np.ndarray, frame_length: int = 128) -> np.ndarray:
        bits = np.ascontiguousarray(bits, np.uint8)
        values = np.ascontiguousarray(values, np.uint8)
        if output_size == 0:
            return np.zeros(0, np.uint8)
        if bits.size == 0 or values.size == 0:
            # A nonzero claimed size with empty payload must be a tagged
            # error, not a silently empty output.
            raise ValueError(
                "fl_decode: corrupt container (empty bits/values for "
                f"claimed size {output_size})")
        out = np.empty(output_size, np.uint8)
        rc = self._lib.flrl_fl_decode(bits, bits.size, values, values.size,
                                      frame_length, out, output_size)
        if rc != 0:
            raise ValueError(f"fl_decode: corrupt stream (rc={rc})")
        return out

    def fl_fold(self, fields: np.ndarray, bits: np.ndarray, n: int,
                frame_length: int = 128) -> np.ndarray:
        """Fields (u32) + bits → byte-exact packed stream."""
        fields = np.ascontiguousarray(fields, np.uint32)
        bits = np.ascontiguousarray(bits, np.uint8)
        if n == 0:
            return np.zeros(0, np.uint8)
        values = np.empty(n + frame_length, np.uint8)
        vsz = self._lib.flrl_fl_fold(fields, bits, n, frame_length, values)
        if vsz < 0:
            raise ValueError("fl_fold: bad arguments")
        return values[:vsz].copy()

    def fl_unfold(self, values: np.ndarray, bits: np.ndarray, n: int,
                  frame_length: int = 128) -> np.ndarray:
        """Packed stream + bits → fields (u32), zero-padded tail."""
        values = np.ascontiguousarray(values, np.uint8)
        bits = np.ascontiguousarray(bits, np.uint8)
        if n == 0:
            return np.zeros(0, np.uint32)
        frames = -(-n // frame_length)
        if bits.size < frames:
            raise ValueError(
                "fl_unfold: corrupt container (bits array shorter than "
                f"frame count: {bits.size} < {frames})")
        fields = np.empty(frames * (frame_length // 4), np.uint32)
        rc = self._lib.flrl_fl_unfold(values, values.size, bits, bits.size,
                                      n, frame_length, fields)
        if rc != 0:
            raise ValueError(f"fl_unfold: corrupt stream (rc={rc})")
        return fields

    def fl_fold_p2(self, packed: np.ndarray, bits: np.ndarray, n: int,
                   frame_length: int, tile_r: int) -> np.ndarray:
        """Pack-2 fields (u32, two 16-bit fields per word — the layout of
        ``fl_pallas.fl_encode_fields_packed_pallas``) + bits → byte-exact
        packed stream.  Every frame width must be <= 4."""
        packed = np.ascontiguousarray(packed, np.uint32)
        bits = np.ascontiguousarray(bits, np.uint8)
        if n == 0:
            return np.zeros(0, np.uint8)
        frames = -(-n // frame_length)
        wpf = frame_length // 4
        tile_words = tile_r * 128
        need = -(-(frames * wpf) // tile_words) * (tile_words // 2)
        if bits.size < frames or packed.size < need:
            raise ValueError("fl_fold_p2: undersized bits/packed arrays")
        values = np.empty(n + frame_length, np.uint8)
        vsz = self._lib.flrl_fl_fold_p2(packed.view(np.uint16), bits, n,
                                        frame_length, tile_r, values)
        if vsz < 0:
            raise ValueError(f"fl_fold_p2: bad arguments (rc={vsz})")
        return values[:vsz].copy()

    def fl_unfold_p2(self, values: np.ndarray, bits: np.ndarray, n: int,
                     frame_length: int, tile_r: int,
                     packed_words: int) -> np.ndarray:
        """Packed stream + bits → pack-2 fields (u32[packed_words],
        zero beyond the live frames).  Every frame width must be <= 4
        (host callers check ``bits.max()`` before dispatching here)."""
        values = np.ascontiguousarray(values, np.uint8)
        bits = np.ascontiguousarray(bits, np.uint8)
        if n == 0:
            return np.zeros(0, np.uint32)
        frames = -(-n // frame_length)
        wpf = frame_length // 4
        tile_words = tile_r * 128
        need = -(-(frames * wpf) // tile_words) * (tile_words // 2)
        if bits.size < frames:
            raise ValueError(
                "fl_unfold_p2: corrupt container (bits array shorter "
                f"than frame count: {bits.size} < {frames})")
        if packed_words < need:
            raise ValueError("fl_unfold_p2: undersized output buffer")
        out = np.zeros(packed_words, np.uint32)
        rc = self._lib.flrl_fl_unfold_p2(values, values.size, bits,
                                         bits.size, n, frame_length,
                                         tile_r, out.view(np.uint16))
        if rc != 0:
            raise ValueError(f"fl_unfold_p2: corrupt stream (rc={rc})")
        return out

    def rl_encode(self, data: np.ndarray):
        data = np.ascontiguousarray(data, np.uint8)
        n = data.size
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        counts = np.empty(n, np.uint8)
        values = np.empty(n, np.uint8)
        r = self._lib.flrl_rl_encode(data, n, counts, values)
        return counts[:r].copy(), values[:r].copy()

    def rl_decode(self, counts: np.ndarray, values: np.ndarray) -> np.ndarray:
        counts = np.ascontiguousarray(counts, np.uint8)
        values = np.ascontiguousarray(values, np.uint8)
        if counts.size != values.size:
            raise ValueError(
                "rl_decode: corrupt container (counts/values length "
                f"mismatch: {counts.size} != {values.size})")
        cap = int(counts.astype(np.int64).sum())
        out = np.empty(cap, np.uint8)
        n = self._lib.flrl_rl_decode(counts, values, counts.size, out, cap)
        if n < 0:
            raise ValueError("rl_decode: corrupt stream")
        return out[:n]


def build_cxx(src: str, out: str, flags=(), libs=()) -> bool:
    """Build the shared library ``out`` from the C++ source ``src`` with
    g++ (``flags`` before the source, ``libs`` after it) where it is
    missing or older than ``src``; False where that build failed.  A
    missing source builds nothing (an installed package may ship only the
    library)."""
    if not os.path.exists(src) or (
            os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return True
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # built under a private name, then renamed: a process building at the
    # same time never loads a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-std=c++17", "-fPIC", "-shared", *flags,
                        "-o", tmp, src, *libs],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


_LOADED: dict = {}


def load_cxx(src: str, out: str, flags=(), libs=()) -> ctypes.CDLL | None:
    """The shared library ``out``, built first by :func:`build_cxx`; None
    where it can be neither built nor loaded.  Tried once a process."""
    with _LOCK:
        if out not in _LOADED:
            handle = None
            if build_cxx(src, out, flags, libs):
                try:
                    handle = ctypes.CDLL(out)
                except OSError:
                    pass
            _LOADED[out] = handle
        return _LOADED[out]


def get_native() -> Native | None:
    """Load (building on first use) the native library, or None."""
    global _NATIVE, _TRIED
    if not _TRIED:
        handle = (None if os.environ.get("FLRL_NO_NATIVE") else
                  load_cxx(_SRC_PATH, _SO_PATH,
                           ["-O3", "-march=native", "-fopenmp"]))
        _NATIVE = None if handle is None else Native(handle)
        _TRIED = True
    return _NATIVE
