"""FL and RL lossless compression on an NVIDIA GPU: the PyTorch + CUDA
port of ``fl_rl_compression_mpi_tpu``.

The ``fl`` and ``rl`` methods run hand-written Hopper kernels
(``csrc/fl_dense.cu``, ``csrc/rl.cu``, built with ``nvcc`` at first use by
``ops/_build.py``) behind the same
container format, CLI and library API as the JAX package, which stays the
reference.  Framework-free host modules (container, file I/O, native
codec, NumPy golden) are imported from the JAX package, not copied; this
package imports ``torch`` and never ``jax``.

Layout: ``ops/`` kernels and dispatch, ``models/`` the codec registry,
``utils/`` timers.
"""

__version__ = "0.1.0"

from fl_rl_compression_mpi_tpu.container import (  # noqa: F401
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
