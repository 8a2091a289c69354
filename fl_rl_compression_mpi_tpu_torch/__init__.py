"""FL and RL lossless compression on NVIDIA GPUs: the PyTorch + CUDA
port of ``fl_rl_compression_mpi_tpu``.

The ``fl`` and ``rl`` methods run hand-written Hopper kernels
(``csrc/*.cu``, built with ``nvcc`` at first use by ``ops/_build.py``)
behind the same container format, CLI and library API as the JAX package,
which stays the reference.  ``fl-dist``, ``fl-ici`` and ``rl-dist`` run
them on every rank of a ``torch.distributed`` process group
(``parallel/dist.py``).  The framework-free host modules (container, file
I/O, the native C++ host codec, the NumPy goldens) are this package's own
copies of the JAX package's, with the same names and contents: this
package imports ``torch`` and nothing of JAX or of the JAX package.

Layout: ``ops/`` kernels and dispatch, ``parallel/`` the process-group
layer, ``models/`` the codec registry, ``utils/`` timers.
"""

__version__ = "0.1.0"


def _retain_arena() -> None:
    """Keep freed large allocations inside the process.

    The JAX package sets the same glibc thresholds when it is imported
    (``fl_rl_compression_mpi_tpu/__init__.py``); this package imports
    nothing of it and sets them itself, so host memory behaves the same in
    both.  Raising glibc's mmap and trim thresholds routes big mallocs
    through the brk arena and never returns them to the OS, so a fresh
    large ``np.empty`` (a host fold buffer, a decoded output) reuses pages
    already faulted in instead of faulting new ones.  The high-water cost
    is bounded by peak simultaneous usage, which the codecs already pay.
    """
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):  # pragma: no cover
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except OSError:  # pragma: no cover - non-glibc libc
        pass


_retain_arena()

from .container import (  # noqa: F401,E402
    FLCompressed,
    RLCompressed,
    load_fl,
    load_rl,
    save_fl,
    save_rl,
)
from .api import (  # noqa: F401,E402
    compress,
    compress_file,
    decompress,
    decompress_file,
    methods,
)
