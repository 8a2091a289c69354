"""Experiment 22 on the card: tile-packed fields in a tile-aligned layout.

The port of ``experiments/exp22_tile_packed2.py``: exp21's packing with
tile t's R >> d packed rows at row t·R (no cursor and no row offsets), the
layout that took exp21's cursor serialisation out of the TPU kernel.  The
kernels are ``ops/tile_packed_cuda.py``'s in their sparse layout.

Measures as exp21 (``exp21_tile_packed``), the packed chains named
``pk2_rt_1024`` and ``pk2_rt_2048``.

Usage: python -m fl_rl_compression_mpi_tpu_torch.experiments.exp22_tile_packed2 \
       [--device cpu] [--smoke]
"""

from __future__ import annotations

from ..ops import tile_packed_cuda as tp
from . import exp21_tile_packed as exp21
from .exp21_tile_packed import LANES

LAYOUT = "sparse"


def enc_packed(R: int, nrows: int):
    """``go(w) -> (bits u8 (nrows, 4), packed int32 (nrows, 128))``."""
    ego = exp21.enc_packed(R, nrows, LAYOUT)

    def go(w):
        bits, packed, _ = ego(w)
        return bits, packed
    return go


def dec_packed(R: int, nrows: int):
    """``go(bits2d, packed) -> words int32 (nrows, 128)``."""
    def go(bits2d, packed):
        return tp.decode(bits2d, packed.reshape(nrows, LANES), R)
    return go


def make_packed_rt(R: int, nrows: int):
    """``chain(w, k)``: k sparse-layout round trips of the flat words."""
    return exp21.make_packed_rt(R, nrows, LAYOUT)


def main(argv=None) -> int:
    return exp21.run(argv, LAYOUT, "pk2_rt", __doc__)


if __name__ == "__main__":
    raise SystemExit(main())
