"""The tile-packed encode's route and cluster geometry, compiled from their
one source, ``csrc/tile_packed.cuh``, with the host's C++ compiler, so that
CPU tests hold the wrapper and the NumPy models to the rule the launcher
uses.

``header()`` returns a namespace of callables (``cluster_blocks``,
``cluster_tiles``, ``cluster_fits``, ``tile_packed_route``) and the
constants ``kClusterMax``, ``kClusterMaxRows``, ``kClusterTiles``; its
``flrl_tile_packed_route`` stands in for the kernel library's."""

import atexit
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import types

from fl_rl_compression_mpi_tpu_torch.ops import _build

_FUNCTIONS = ("cluster_blocks", "cluster_tiles", "cluster_fits",
              "tile_packed_route")
_CONSTANTS = ("kClusterMax", "kClusterMaxRows", "kClusterTiles")

_SOURCE = '#include "tile_packed.cuh"\nextern "C" {\n' + "".join(
    f"int tp_{f}(int R) {{ return {f}(R); }}\n" for f in _FUNCTIONS) + "".join(
    f"int tp_{c}() {{ return {c}; }}\n" for c in _CONSTANTS) + "}\n"


@functools.lru_cache(maxsize=None)
def header() -> types.SimpleNamespace:
    tmp = tempfile.mkdtemp(prefix="tile_packed_header_")
    atexit.register(shutil.rmtree, tmp, True)
    src, lib = os.path.join(tmp, "geometry.cpp"), os.path.join(tmp, "g.so")
    with open(src, "w") as f:
        f.write(_SOURCE)
    subprocess.run([os.environ.get("CXX", "g++"), "-std=c++17", "-O1",
                    "-shared", "-fPIC", "-I", _build.CSRC_DIR, src, "-o",
                    lib], check=True, capture_output=True)
    handle = ctypes.CDLL(lib)
    ns = types.SimpleNamespace()
    for name in _FUNCTIONS:
        fn = getattr(handle, "tp_" + name)
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        setattr(ns, name, fn)
    for name in _CONSTANTS:
        fn = getattr(handle, "tp_" + name)
        fn.restype, fn.argtypes = ctypes.c_int, []
        setattr(ns, name, fn())
    ns.flrl_tile_packed_route = ns.tile_packed_route
    return ns
