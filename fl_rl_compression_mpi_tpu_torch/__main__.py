"""``python -m fl_rl_compression_mpi_tpu_torch`` — the `compress` CLI."""

import sys

from .cli import main

sys.exit(main())
