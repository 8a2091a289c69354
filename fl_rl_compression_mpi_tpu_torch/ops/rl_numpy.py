"""NumPy golden implementation of the RL (run-length) codec.

The reference contains no RL code — only the algorithm spec in
``reference/IMPLEMENTATION-PLAN.md:81-179``: flag run starts, scan the
flags, compact (value, count) pairs with run lengths capped at 255 (counts
are stored as u8).  Note the spec's fix-up pass (``:125-148``) re-flags long
runs and *rescans*; we cap directly in one pass — boundaries at
``start + k*255`` — which yields identical output (pieces of 255 plus a
remainder) without the iterate-until-clean loop.  The literal spec even has
an off-by-one for runs of exactly 256 (its ``k`` starts at 0, so no boundary
would be added); the intent (cap at 255) is unambiguous and is what both
variants here implement.

Like `fl_numpy`, both a literal sequential oracle and a vectorized
scan-based version (mirroring the device formulation) are provided.
"""

from __future__ import annotations

import numpy as np

RUN_CAP = 255  # counts are u8 (IMPLEMENTATION-PLAN.md:125)


# ---------------------------------------------------------------------------
# Sequential oracle.
# ---------------------------------------------------------------------------

def encode_seq(data: np.ndarray):
    data = np.asarray(data, np.uint8)
    counts, values = [], []
    run = 0
    prev = None
    for v in data:
        v = int(v)
        if v == prev and run < RUN_CAP:
            run += 1
        else:
            if run:
                counts.append(run)
                values.append(prev)
            prev, run = v, 1
    if run:
        counts.append(run)
        values.append(prev)
    return np.asarray(counts, np.uint8), np.asarray(values, np.uint8)


def decode_seq(counts: np.ndarray, values: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(values, np.uint8),
                     np.asarray(counts, np.uint8).astype(np.int64))


# ---------------------------------------------------------------------------
# Vectorized golden (flag → scan → compact, as on device).
# ---------------------------------------------------------------------------

def encode(data: np.ndarray):
    """Vectorized RL encode.  Returns ``(counts u8[R], values u8[R])``."""
    data = np.asarray(data, np.uint8)
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    idx = np.arange(n, dtype=np.int64)
    flags = np.ones(n, bool)
    flags[1:] = data[1:] != data[:-1]
    # Start index of each element's (uncapped) run: running max of flagged
    # positions — the TPU-native replacement for the spec's rescan loop.
    start = np.maximum.accumulate(np.where(flags, idx, 0))
    flags |= ((idx - start) % RUN_CAP == 0) & (idx != start)
    starts = np.nonzero(flags)[0]
    values = data[starts]
    counts = np.diff(np.append(starts, n))
    return counts.astype(np.uint8), values


def decode(counts: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Vectorized RL decode: exclusive scan of counts → run starts; each
    output element gathers its run's value (IMPLEMENTATION-PLAN.md:154-179,
    with the binary search replaced by a mark+cumsum run-id assignment)."""
    counts = np.asarray(counts, np.uint8).astype(np.int64)
    values = np.asarray(values, np.uint8)
    if counts.size == 0:
        return np.zeros(0, np.uint8)
    n = int(counts.sum())
    starts = np.zeros(counts.size, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    mark = np.zeros(n, np.int64)
    np.add.at(mark, starts, 1)
    run_id = np.cumsum(mark) - 1
    return values[run_id]


def compressed_size(data: np.ndarray) -> int:
    """Container payload size (counts + values) the encoder will produce."""
    counts, values = encode(data)
    return int(counts.size + values.size)
