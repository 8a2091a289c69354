"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (``csrc/fl_dense.cuh``,
``csrc/fl_fields.cuh``, ``csrc/fl_constant.cuh``, ``csrc/rl.cuh``,
``csrc/copy_probe.cuh``, ``csrc/lanes.cuh``, ``csrc/tile_packed.cuh``), so
``nvcc`` compiles them in seconds, one process per source, all started
together, and links the objects into one shared library that ``ctypes``
loads.  No PyTorch headers are involved.  The library lands in
``_build/libflrl_cuda_<srchash>.so`` beside the package, keyed by a hash of
every ``*.cu`` and ``*.cuh`` file in ``csrc/``, at first use.  A failed
build raises with ``nvcc``'s output: there is no fallback.  The C++
sources there (``csrc/flrlio.cpp`` and ``csrc/thread_state.cpp``, built
with g++ through ``native.py``) are neither hashed nor given to ``nvcc``;
the second is built here too, beside ``nvcc`` (``utils/thread_state.py``),
so that no traced call builds it.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    "flrl_pack": (_INT, [_P, _I64, _I64, _P, _P, _INT, _P, _INT, _P]),
    "flrl_unpack": (_INT, [_P, _I64, _I64, _I64, _P, _P, _INT, _P, _INT,
                           _P]),
    "flrl_fields_encode": (_INT, [_P, _I64, _I64, _INT, _P, _P, _INT, _P]),
    "flrl_fields_decode": (_INT, [_P, _P, _I64, _I64, _INT, _P, _INT, _P]),
    "flrl_rl_encode": (_INT, [_P, _I64, _INT, _I64, _P, _P, _P, _INT, _P]),
    "flrl_rl_run_offsets": (_INT, [_P, _I64, _P, _INT, _P]),
    "flrl_rl_expand": (_INT, [_P, _P, _I64, _P, _I64, _P, _INT, _P]),
    "flrl_const_encode": (_INT, [_P, _I64, _INT, _INT, _P, _P, _P, _INT,
                                 _P]),
    "flrl_const_decode": (_INT, [_P, _I64, _INT, _INT, _P, _I64, _P, _INT,
                                 _P]),
    "flrl_rl_encode_starts": (_INT, [_P, _I64, _P, _P, _INT, _P]),
    "flrl_copy_probe": (_INT, [_P, _P, _I64, _INT, _INT, _P]),
    "flrl_tile_op": (_INT, [_INT, _P, _I64, _INT, _P, _P, _INT, _I64, _INT,
                            _P]),
    "flrl_tile_packed_route": (_INT, [_INT]),
    "flrl_tile_packed_encode": (_INT, [_P, _I64, _INT, _P, _P, _P, _P, _INT,
                                       _P]),
    "flrl_tile_packed_encode_2pass": (_INT, [_P, _I64, _INT, _P, _P, _P, _P,
                                             _INT, _P]),
    "flrl_tile_packed_decode": (_INT, [_P, _P, _P, _I64, _INT, _P, _P, _INT,
                                       _P]),
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


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with the first failure's output,
    else return everything they printed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for text, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed (exit {rc}):\n{text}")
    return "".join(text for text, _ in outs)


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library for these sources exists;
    return its path."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [p for p in _sources() if p.endswith(".cu")]
    nvcc = _nvcc()
    from ..utils import thread_state
    beside = threading.Thread(target=thread_state.build, daemon=True)
    beside.start()
    # objects and the library go to private names, then the library is
    # renamed: a concurrent build never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in srcs]
        log = _run([[nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
                    for src, obj in zip(srcs, objs)])
        lib_tmp = os.path.join(tmp, "lib.so")
        log += _run([[nvcc, "-shared", "-o", lib_tmp, *objs]])
        build_log = log
        os.replace(lib_tmp, out)
    beside.join()
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
