"""The PyTorch package's CLI with the CPU as its device, for tests that
start it in processes of their own (``torchrun``, or one process a rank
with ``--coordinator HOST:PORT``):

    python tests/torch_cli_runner.py c fl-dist in.bin out.fl ...

``fl`` and the multi-process path run only on a CUDA device unless the
registry's default device is the CPU, as the in-process CLI tests patch
it.  Imports nothing of JAX."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from fl_rl_compression_mpi_tpu_torch.cli import main  # noqa: E402
from fl_rl_compression_mpi_tpu_torch.models import registry  # noqa: E402

if __name__ == "__main__":
    registry.default_device = lambda: torch.device("cpu")
    sys.exit(main(sys.argv[1:]))
