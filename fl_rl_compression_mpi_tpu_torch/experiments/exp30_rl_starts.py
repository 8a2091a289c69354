"""Experiment 30 on the card: the RL encode routing piece starts.

The port of ``experiments/exp30_rl_starts.py``.  Its encode emits each
piece as the int32 ``value | (start & 0xFF) << 8``, start the piece's
position in the stream, so that counts come later as differences of
consecutive starts mod 256 (every piece is at most 255 bytes; the last is
closed by the stream's length).  The kernel is ``flrl_rl_encode`` in its
starts mode (``rl_cuda.encode_starts``); the decode turns the starts into
counts by a few byte-wise tensor passes and runs the RL decode's kernels
(``rl_torch.decode_starts``).

Measures what the JAX script measured: parity of the encode (against
``rl_numpy.encode``) and of the round trip on the kinds ``long``,
``short``, ``cap``, ``const`` and ``rand`` at 4 MiB + 13 bytes, then the
round-trip pair in GB/s (2n over a round trip) at 64 MiB of ``long``:
``pair_v1``, the product's encode and decode (``rl_cuda.encode_device``,
``rl_torch.decode_device``), against ``pair_v2``, the starts-routed pair;
and each pair's encode alone (``enc_v1``, ``enc_v2``, GB/s of input).
The JAX script's third pair (``mxu_psum``) differs from the second only
in how the TPU sums, so it has no counterpart here.

Usage: python -m fl_rl_compression_mpi_tpu_torch.experiments.exp30_rl_starts \
       [--device cpu] [--smoke]
"""

from __future__ import annotations

import json

import numpy as np

from ..ops import rl_cuda, rl_numpy, rl_torch
from . import common

LANES = 128
KINDS = (("long", 0), ("short", 1), ("cap", 2), ("const", 3), ("rand", 4))


def rl_encode_v2(x2d, n: int):
    """``(packed int32[n], total int64[1])`` of the first n bytes of
    ``x2d``: each piece as ``value | (start & 0xFF) << 8``, entries past
    ``total`` unspecified.  Counts come from mod-256 differences of
    consecutive starts (exact: the 255 cap bounds every gap at 255)."""
    return rl_cuda.encode_starts(x2d.reshape(-1)[:n])


def split_v2_numpy(packed, total, n):
    """Host conversion of the v2 stream → (counts, values) for parity."""
    p = np.asarray(packed)[:total]
    vals = (p & 0xFF).astype(np.uint8)
    s8 = (p >> 8) & 0xFF
    nxt = np.roll(s8, -1)
    if total:
        nxt[-1] = n & 0xFF
    cnts = ((nxt - s8) & 0xFF).astype(np.uint8)
    return cnts, vals


def rl_decode_packed_v2(packed, num_runs, n: int):
    """The n bytes u8[n] of the v2 stream ``packed`` with ``num_runs``
    pieces.  The JAX function took the output's rows and left the last
    count unclosed; this one takes the stream's length n and closes it, as
    ``split_v2_numpy`` does."""
    return rl_torch.decode_starts(packed, num_runs, n)


def gen(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "long":
        nr = max(1, n // 32)
        x = np.repeat(rng.integers(0, 256, nr, np.uint8),
                      rng.integers(16, 112, nr))
    elif kind == "short":
        nr = max(1, n // 3)
        x = np.repeat(rng.integers(0, 256, nr, np.uint8),
                      rng.integers(1, 6, nr))
    elif kind == "cap":
        nr = max(1, n // 700)
        x = np.repeat(rng.integers(0, 256, nr, np.uint8),
                      rng.integers(200, 1200, nr))
    elif kind == "const":
        x = np.zeros(2 * n, np.uint8)
    else:
        x = rng.integers(0, 256, n, np.uint8)
    while x.size < n:
        x = np.concatenate([x, x])
    return x[:n].copy()


def _padded(host: np.ndarray, dev):
    """``host`` zero-padded to whole rows of 128, as (rows, 128) on dev."""
    rows = -(-host.size // LANES)
    buf = np.zeros(rows * LANES, np.uint8)
    buf[:host.size] = host
    return common.to_device(buf.reshape(rows, LANES), dev)


def parity(n_bytes, seed, kind, dev) -> bool:
    host = gen(seed, n_bytes, kind)
    packed, total = rl_encode_v2(_padded(host, dev), n_bytes)
    total = int(total)
    c2, v2 = split_v2_numpy(packed.cpu().numpy(), total, n_bytes)
    cg, vg = rl_numpy.encode(host)
    ok = (total == cg.size and np.array_equal(c2, cg)
          and np.array_equal(v2, vg))
    if not ok:
        print(f"parity FAIL {kind} seed={seed}: total={total} want "
              f"{cg.size}", flush=True)
        return False
    out = rl_decode_packed_v2(packed, total, n_bytes)
    ok2 = np.array_equal(out.cpu().numpy(), host)
    if not ok2:
        print(f"decode FAIL {kind} seed={seed}", flush=True)
    return ok2


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev, clock = common.setup(args)
    results: dict = {}
    nb = (1 << 16) + 13 if args.smoke else (4 << 20) + 13
    allok = all([parity(nb, seed, kind, dev) for kind, seed in KINDS])
    results["parity"] = bool(allok)
    print(f"parity={allok}", flush=True)
    if not allok:
        print(json.dumps(results), flush=True)
        return 1

    n = (1 << 18) if args.smoke else (64 << 20)
    host = gen(10, n, "long")
    x = common.to_device(host, dev)

    def pair_v1(v):
        counts, values, _ = rl_cuda.encode_device(v)
        return rl_torch.decode_device(counts, values, n)

    def pair_v2(v):
        packed, total = rl_cuda.encode_starts(v)
        return rl_torch.decode_starts(packed, total, n)

    def enc_v1(v):
        rl_cuda.encode_device(v)
        return v

    def enc_v2(v):
        rl_cuda.encode_starts(v)
        return v

    chains = {}
    for name, fn in (("pair_v1", pair_v1), ("pair_v2", pair_v2),
                     ("enc_v1", enc_v1), ("enc_v2", enc_v2)):
        def chain(v, k, fn=fn):
            for _ in range(k):
                v = fn(v)
            return v
        chains[name] = chain
        if not name.startswith("pair"):
            continue
        ok = bool(np.array_equal(chain(x, 1).cpu().numpy(), host))
        results[name + "_ok"] = ok
        print(f"{name} roundtrip ok={ok}", flush=True)
        if not ok:
            print(json.dumps(results), flush=True)
            return 1

    inner = 2 if args.smoke else 8
    for cyc in range(1 if args.smoke else 3):
        for name, chain in chains.items():
            t = common.time_chain(clock, chain, x, inner,
                                  reps=1 if args.smoke or cyc else 3)
            pair = name.startswith("pair")
            r = (2 if pair else 1) * n / 1e9 / t
            results.setdefault(name, []).append(round(r, 2))
            print(f"cycle {cyc} {name}: {r:.2f} GB/s "
                  f"{'pair' if pair else 'in'}", flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
