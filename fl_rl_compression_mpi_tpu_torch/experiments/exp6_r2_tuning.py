"""Experiment 6 on the card: the copy ceiling.

The port of the copy arm of ``experiments/exp6_r2_tuning.py``: a pure copy
of the stream's u32 words, the card's streaming yardstick.  The JAX
script's ``copy_pallas`` swept TPU tile sizes and grid semantics, which
change only the TPU's schedule; here the copy is ``flrl_copy_probe`` with
addend 0 (``copy_probe_cuda.copy``).  The script's other arms are the
field encode and decode, which the port runs as ``fl_fields_cuda``.

Measures GB/s of input (N over a call's time) on 256 MiB: the copy beside
x + 1 (``copy_probe_cuda.add_one``) and ``Tensor.copy_``.

Usage: python -m fl_rl_compression_mpi_tpu_torch.experiments.exp6_r2_tuning \
       [--device cpu] [--smoke]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import copy_probe_cuda
from . import common

LANES = 128


def copy_words(x):
    """A copy of the u32 words ``x`` (int32 bit-views, a multiple of 128),
    as (nw / 128, 128)."""
    return copy_probe_cuda.copy(x.reshape(-1)).view(-1, LANES)


def main(argv=None) -> int:
    args = common.parser(__doc__).parse_args(argv)
    dev, clock = common.setup(args)
    n = (1 << 18) if args.smoke else (256 << 20)
    host = np.random.default_rng(0).integers(0, 16, n, np.uint8)
    words = common.to_device(host.view(np.int32), dev)
    print("data staged", flush=True)
    out = torch.empty_like(words)
    ok = bool(torch.equal(copy_words(words).reshape(-1), words))
    results = {"copy_ok": ok}
    inner = 2 if args.smoke else 8
    arms = {"copy": lambda: copy_words(words),
            "add_one": lambda: copy_probe_cuda.add_one(words),
            "copy_": lambda: out.copy_(words)}
    for name, fn in arms.items():
        def chain(_, k, fn=fn):
            for _ in range(k):
                fn()
        t = common.time_chain(clock, chain, None, inner,
                              reps=1 if args.smoke else 5)
        results[f"{name}_gbps"] = round(n / 1e9 / t, 1)
        print(f"{name}: {n / 1e9 / t:.1f} GB/s-in", flush=True)
    print(json.dumps(results), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
