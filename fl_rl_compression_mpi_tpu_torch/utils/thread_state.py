"""PyTorch's thread-local state, carried into a mesh's per-card threads.

``torch.profiler`` records the ranges of a thread only where that thread
holds the profiler's thread-local state: the thread that started it, and
the worker threads that PyTorch starts itself.  A mesh's per-card threads
(``parallel/dist.py``'s ``on_mesh``) are Python threads, so under a
profiler the calling thread's state is taken with :func:`capture` and
entered in each card thread with :func:`entered`, as PyTorch's own
``at::ThreadLocalStateGuard`` does for its workers.

The calls go through a small library, ``csrc/thread_state.cpp``, built
with g++ against the running PyTorch's headers and libraries into
``_build/libflrl_thread_state_<torch version>.so`` (``native.py``'s
:func:`~..native.build_cxx`).  :func:`build` makes it beside the CUDA
kernels' library (``ops/_build.py``), so a traced call only loads it.
Where it cannot be built or loaded (no g++, no headers, no source),
:func:`capture` returns None and the card threads' ranges are left out of
the trace; nothing else changes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import warnings

import torch

from .. import native

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG_DIR, "csrc", "thread_state.cpp")
_SO_PATH = os.path.join(_PKG_DIR, "_build",
                        f"libflrl_thread_state_{torch.__version__}.so")


def _flags() -> tuple[list[str], list[str]]:
    torch_dir = os.path.dirname(torch.__file__)
    lib_dir = os.path.join(torch_dir, "lib")
    abi = int(torch.compiled_with_cxx11_abi())
    return ([f"-D_GLIBCXX_USE_CXX11_ABI={abi}", "-O2", "-w",
             "-I", os.path.join(torch_dir, "include")],
            ["-L", lib_dir, "-ltorch_cpu", "-lc10", f"-Wl,-rpath,{lib_dir}"])


def build() -> bool:
    """Build the library unless it is there; False where that failed."""
    return native.build_cxx(_SRC_PATH, _SO_PATH, *_flags())


@functools.cache
def _lib() -> ctypes.CDLL | None:
    handle = native.load_cxx(_SRC_PATH, _SO_PATH, *_flags())
    if handle is None:
        warnings.warn("thread_state: the per-card threads' ranges stay out "
                      f"of the profiler's trace ({_SO_PATH} could be "
                      "neither built nor loaded)")
        return None
    handle.flrl_state_capture.restype = ctypes.c_void_p
    handle.flrl_state_capture.argtypes = []
    handle.flrl_state_enter.restype = ctypes.c_void_p
    handle.flrl_state_enter.argtypes = [ctypes.c_void_p]
    for name in ("flrl_state_free", "flrl_state_exit"):
        getattr(handle, name).restype = None
        getattr(handle, name).argtypes = [ctypes.c_void_p]
    return handle


def capture() -> int | None:
    """Under a profiler, the calling thread's PyTorch state (a handle for
    :func:`entered` and :func:`release`); else, or where the library is
    missing, None."""
    if not torch.autograd._profiler_enabled():
        return None
    handle = _lib()
    return None if handle is None else handle.flrl_state_capture()


def release(state: int | None) -> None:
    if state is not None:
        _lib().flrl_state_free(state)


@contextlib.contextmanager
def entered(state: int | None):
    """The state ``state`` (from :func:`capture`) held by the calling thread
    for the block; its own state afterwards.  None enters nothing."""
    if state is None:
        yield
        return
    guard = _lib().flrl_state_enter(state)
    try:
        yield
    finally:
        _lib().flrl_state_exit(guard)
