"""Experiment 21 on the card: tile-packed fields behind a cursor.

The port of ``experiments/exp21_tile_packed.py``.  A field word at frame
width b uses 4b of its 32 bits; a tile of R rows whose widest frame has
width bt packs 2^d fields a word (d = 3, 2, 1, 0 for bt <= 1, 2, 4, else)
by d static halvings, and its R >> d packed rows go out behind a cursor,
with the tiles' row offsets beside them.  The kernels are
``ops/tile_packed_cuda.py``'s (``csrc/tile_packed.cu``), cursor layout.

Measures what the JAX script measured: the round trip of the parity sets
``w1``, ``w4``, ``w8`` and ``mix`` (256 MiB each) and the widths against
the base field encode's (``fl_fields_cuda.encode_fields``), then credited
GB/s (2N over a round trip's time) of three chains, interleaved for three
cycles: the packed round trip at R = 1024 and 2048, the base field round
trip, and the x + 1 copy pair (``copy_probe_cuda.add_one`` twice).

Usage: python -m fl_rl_compression_mpi_tpu_torch.experiments.exp21_tile_packed \
       [--device cpu] [--smoke]
"""

from __future__ import annotations

import json

import numpy as np

from ..ops import copy_probe_cuda, fl_fields_cuda
from ..ops import tile_packed_cuda as tp
from . import common

LANES = 128
WPF = 32
FPR = 4
LAYOUT = "cursor"


def sizes(smoke: bool) -> tuple:
    """``(N bytes, rows of 128 words)`` of the script's streams."""
    n = (1 << 19) if smoke else (256 << 20)
    return n, n // 4 // LANES


# ------------------------------------------------------------- encode
def enc_packed(R: int, nrows: int, layout: str = LAYOUT):
    """``go(w) -> (bits u8 (nrows, 4), packed int32 (nrows, 128), offs
    int32 (nrows / R + 1,), None in the sparse layout)``."""
    def go(w):
        return tp.encode(w.reshape(nrows, LANES), R, layout)
    return go


# ------------------------------------------------------------- decode
def dec_packed(R: int, nrows: int):
    """``go(bits2d, packed, offs) -> words int32 (nrows, 128)``."""
    def go(bits2d, packed, offs):
        return tp.decode(bits2d, packed.reshape(nrows, LANES), R, offs)
    return go


# ------------------------------------------------------------- harness
def make_packed_rt(R: int, nrows: int, layout: str = LAYOUT):
    """``chain(w, k)``: k packed round trips of the flat words ``w``."""
    ego = enc_packed(R, nrows, layout)
    dgo = dec_packed(R, nrows)

    def roundtrip(w):
        bits, packed, offs = ego(w)
        return dgo(bits, packed, offs).reshape(-1)

    def chain(w, k):
        for _ in range(k):
            w = roundtrip(w)
        return w
    return chain


def make_base_rt():
    """``chain(w, k)``: k round trips through the base field kernels
    (L = 128).  The JAX script's tile sizes only shaped the TPU's grid."""
    def roundtrip(w):
        b, f = fl_fields_cuda.encode_fields(w)
        return fl_fields_cuda.decode_fields(f, b)

    def chain(w, k):
        for _ in range(k):
            w = roundtrip(w)
        return w
    return chain


def make_copy_chain():
    """``chain(w, k)``: k steps of two x + 1 copies."""
    def chain(w, k):
        for _ in range(k):
            w = copy_probe_cuda.add_one(copy_probe_cuda.add_one(w))
        return w
    return chain


def datasets(n: int) -> dict:
    """The script's streams, from ``default_rng(0)``: widths 4, 8 and 1,
    and ``mix`` (a third width 1, a third width 4, a third width 8)."""
    rng = np.random.default_rng(0)
    out = {
        "w4": rng.integers(0, 16, n, np.uint8),
        "w8": rng.integers(0, 256, n, np.uint8),
        "w1": rng.integers(0, 2, n, np.uint8),
    }
    mix = rng.integers(0, 16, n, np.uint8)
    k3 = n // 3
    mix[:k3] &= 1
    mix[n - k3:] = rng.integers(0, 256, k3, np.uint8)
    out["mix"] = mix
    return out


def run(argv, layout: str, prefix: str, doc: str) -> int:
    """The script's main for either layout; the chains of the packed round
    trip are named ``<prefix>_1024`` and ``<prefix>_2048``."""
    args = common.parser(doc).parse_args(argv)
    dev, clock = common.setup(args)
    n, nrows = sizes(args.smoke)
    cycles = 1 if args.smoke else 3
    results: dict = {}
    data = datasets(n)

    # ---- parity (small R so several tiles and every depth run)
    rp = 256 if args.smoke else 1024
    ego = enc_packed(rp, nrows, layout)
    dgo = dec_packed(rp, nrows)
    for name, hostd in data.items():
        w = common.to_device(hostd.view(np.int32), dev)
        bits, packed, offs = ego(w)
        out = dgo(bits, packed, offs)
        ok = bool(np.array_equal(
            out.cpu().numpy().reshape(-1).view(np.uint8), hostd))
        # widths parity with the base field encode
        bprod, _ = fl_fields_cuda.encode_fields(w)
        bok = bool((bits.reshape(-1) == bprod).all())
        results[f"parity_{name}"] = ok
        results[f"bits_parity_{name}"] = bok
        rows = int(tp.tile_rows(bits, rp).sum())
        results[f"rows_frac_{name}"] = round(rows / nrows, 3)
        print(f"parity {name}: rt={ok} bits={bok} rows={rows}/{nrows}",
              flush=True)
        if not (ok and bok):
            print(json.dumps(results), flush=True)
            return 1

    s = 16 if args.smoke else 1
    chains = {
        "copy_pair": (make_copy_chain(), 48 // s),
        "base_rt": (make_base_rt(), 64 // s),
        f"{prefix}_1024": (make_packed_rt(1024, nrows, layout), 64 // s),
        f"{prefix}_2048": (make_packed_rt(2048, nrows, layout), 64 // s),
    }
    if args.smoke:
        chains.pop(f"{prefix}_2048")
        chains[f"{prefix}_1024"] = (make_packed_rt(256, nrows, layout), 4)

    words = {k: common.to_device(v.view(np.int32), dev)
             for k, v in data.items() if k != "mix"}
    for cyc in range(cycles):
        for name, (chain, inner) in chains.items():
            for dn, w in (words.items() if name != "copy_pair"
                          else [("w4", words["w4"])]):
                t = common.time_chain(clock, chain, w, inner,
                                      reps=1 if args.smoke or cyc else 3)
                # credited basis: 2N per round trip (the bench headline)
                r = 2 * n / 1e9 / t
                results.setdefault(f"{name}_{dn}", []).append(round(r, 1))
                print(f"cycle {cyc} {name}/{dn}: {r:.1f} GB/s (credited)",
                      flush=True)
    print(json.dumps(results), flush=True)
    return 0


def main(argv=None) -> int:
    return run(argv, LAYOUT, "pk_rt", __doc__)


if __name__ == "__main__":
    raise SystemExit(main())
