"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (``csrc/fl_dense.cuh``,
``csrc/rl.cuh``), so ``nvcc``
compiles them straight into a shared library in seconds, and ``ctypes``
loads it.  No PyTorch headers are involved.  The library lands in
``_build/libflrl_cuda_<srchash>.so`` beside the package, keyed by a hash of
every file in ``csrc/``, at first use.  A failed build raises with
``nvcc``'s output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_log = ""            # nvcc's output (ptxas register/spill report)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes)
    "flrl_frame_widths": (_INT, [_P, _I64, _I64, _INT, _P, _P, _INT, _P]),
    "flrl_frame_offsets": (_INT, [_P, _I64, _I64, _P, _P, _INT, _P]),
    "flrl_scan_carries_size": (_I64, [_I64]),
    "flrl_pack": (_INT, [_P, _I64, _I64, _P, _P, _INT, _P, _INT, _P]),
    "flrl_unpack": (_INT, [_P, _I64, _I64, _I64, _P, _P, _INT, _P, _INT,
                           _P]),
    "flrl_rl_piece_tiles": (_INT, [_P, _I64, _INT, _P, _INT, _P]),
    "flrl_rl_piece_offsets": (_INT, [_P, _I64, _I64, _P, _P, _INT, _P]),
    "flrl_rl_compact": (_INT, [_P, _I64, _INT, _P, _P, _P, _P, _INT, _P]),
    "flrl_rl_counts": (_INT, [_P, _I64, _I64, _P, _INT, _P]),
    "flrl_rl_run_offsets": (_INT, [_P, _I64, _P, _INT, _P]),
    "flrl_rl_expand": (_INT, [_P, _P, _I64, _P, _I64, _P, _INT, _P]),
    "flrl_cuda_error_string": (ctypes.c_char_p, [_INT]),
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libflrl_cuda_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    return its path."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [p for p in _sources() if p.endswith(".cu")]
    # write to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}"
                f"{proc.stdout}")
        build_log = proc.stderr + proc.stdout
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = handle
        return _LIB
