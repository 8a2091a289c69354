"""Experiment 33 on the card: dependent rounds of y·3 + roll(y, 1).

The port of ``experiments/exp33_round_latency.py``, a probe of the TPU's
vector pipeline: D = 64 dependent rounds of ``y = y*3 + roll(y, 1)`` on
int32 rows of 128 lanes (wrapping), on (R, 128) tiles, as one chain or as
``parts`` interleaved independent chains.  R and ``parts`` change only the
TPU's schedule, not the function; on the card every variant is one
launch of ``flrl_tile_op``'s rounds op (``lanes_cuda.rounds``), a warp a
row.

Measures the round throughput, bytes·D over the time of one pass, on
32 MiB of int32, three cycles.

Usage: python -m fl_rl_compression_mpi_tpu_torch.experiments.exp33_round_latency \
       [--device cpu] [--smoke]
"""

from __future__ import annotations

import numpy as np

from ..ops import lanes_cuda
from . import common

LANES = 128
D = 64


def make(R: int, rows_total: int, parts: int):
    """``chain(x, k)``: k passes of D rounds over ``x`` (rows_total, 128)
    int32 (tiles of R rows in ``parts`` interleaved chains on the TPU)."""
    if R % 8 or rows_total % R or R % parts:
        raise ValueError(f"R={R} must be a multiple of 8 dividing "
                         f"rows_total={rows_total}, and parts={parts} must "
                         f"divide R")

    def chain(x, k):
        y = x.reshape(rows_total, LANES)
        for _ in range(k):
            y = lanes_cuda.rounds(y, D)
        return y
    return chain


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev, clock = common.setup(args)
    n = (1 << 16) if args.smoke else (32 << 20)
    rows_total = n // 4 // LANES
    x = common.to_device(np.random.default_rng(0).integers(
        0, 1 << 30, (rows_total, LANES), np.int32), dev)
    f = make(8, rows_total, 1)
    inner = 2 if args.smoke else 16
    for cycle in range(1 if args.smoke else 3):
        t = common.time_chain(clock, f, x, inner,
                              reps=1 if args.smoke else 3)
        print(f"cycle{cycle} rounds: {t * 1e3:.4f} ms  "
              f"round-tput {n * D / 1e9 / t:.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
