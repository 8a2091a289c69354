"""A NumPy model of the index math of the RL run-offsets kernel
(``csrc/rl.cu`` ``run_offsets_kernel``), held against its plain PyTorch
version (``rl_cuda.run_offsets_ref``) and the host's tile sums
(``rl_torch._block_ends``).

A CUDA kernel cannot run here, so the model repeats the kernel's
arithmetic step for step: groups of K (``kRunGroup`` in ``csrc/rl.cuh``)
tiles of 4096 runs taken by ticket, a thread's 16-byte load of counts a
tile (none past R; the stream's last, cut load summed byte by byte),
``byte_sum``, the warp and block sums, warp 0's scan of the K tile totals,
and the decoupled look-back over one 64-bit status word a group, 32 groups
a window (``scan.cuh`` ``look_back``).
Blocks run in ticket order; a group's prefix may be published late, so
that later look-backs fold windows of aggregates and step back past them.
Tolerance: byte equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

from fl_rl_compression_mpi_tpu_torch.ops import rl_cuda, rl_torch

WARP = 32
CSRC = os.path.join(os.path.dirname(rl_cuda.__file__), "..", "csrc")


def _constant(header: str, name: str) -> int:
    with open(os.path.join(CSRC, header)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


THREADS = _constant("scan.cuh", "kScanThreads")
ITEMS = _constant("scan.cuh", "kScanItems")
TILE = THREADS * ITEMS
WARPS = THREADS // WARP
AGGREGATE, PREFIX = 1 << 62, 2 << 62
VALUE = (1 << 62) - 1


K = _constant("rl.cuh", "kRunGroup")      # tiles a block


def _byte_sum(w: np.ndarray) -> np.ndarray:
    """rl.cu's byte_sum: the four bytes of each u32, summed."""
    w = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)
    return (w & 0xFFFF) + (w >> 16)


def _look_back(status: list, g: int):
    """scan.cuh's look_back with SumLookBack: lane i reads group g-1-i's
    word (a zero prefix before group 0), every word up to the nearest
    prefix must be published, and the warp folds those, or all 32
    aggregates and steps 32 groups back.  Returns (carry, windows)."""
    carry, windows, end = 0, 0, g
    while True:
        windows += 1
        words = [status[j] if j >= 0 else PREFIX
                 for j in range(end - 1, end - 1 - WARP, -1)]
        flags = [s >> 62 for s in words]
        prefixes = [i for i, f in enumerate(flags) if f == 2]
        wanted = range(prefixes[0] + 1) if prefixes else range(WARP)
        assert all(flags[i] != 0 for i in wanted), "read an unpublished word"
        carry += sum(words[i] & VALUE for i in wanted)
        if prefixes:
            return carry, windows
        end -= WARP


def _model_run_offsets(counts: np.ndarray, prefix_every: int = 1):
    """flrl_rl_run_offsets: (offs, the most windows a look-back took).
    Groups j with j % prefix_every != 0 publish their prefix only after
    every group has looked back."""
    R = counts.size
    T = -(-R // TILE)
    if T == 0:                                  # the launcher's memset
        return np.zeros(1, np.int64), 0
    G = -(-T // K)
    buf = np.zeros(G * K * TILE, np.uint8)
    buf[:R] = counts
    r = (np.arange(G * K * THREADS, dtype=np.int64) * ITEMS).reshape(
        G, K, THREADS)
    q = buf.view("<u4").reshape(G, K, THREADS, 4).astype(np.int64)
    q = np.where((r + ITEMS <= R)[..., None], q, 0)   # no full load past R
    sums = _byte_sum(q).sum(-1)
    cut = (r < R) & (r + ITEMS > R)
    assert cut.sum() == (R % ITEMS != 0)
    for gi, ki, ti in zip(*np.nonzero(cut)):
        sums[gi, ki, ti] += int(counts[r[gi, ki, ti]:].sum(dtype=np.int64))
    assert sums.max() <= ITEMS * 255
    warp = sums.reshape(G, K, WARPS, WARP).sum(-1)    # __reduce_add_sync
    assert warp.max() < 2**32
    total = warp.sum(-1)                               # lane k: tile g·K + k
    inc = np.cumsum(total, axis=1)
    status = [0] * G
    late = []
    offs = np.full(T + 1, -1, np.int64)
    writes = np.zeros(T + 1, np.int64)
    most = 0
    for g in range(G):                          # ticket order
        group = int(inc[g, -1])
        if g == 0:
            carry = 0
            status[0] = PREFIX | group
        else:
            status[g] = AGGREGATE | group
            carry, windows = _look_back(status, g)
            most = max(most, windows)
            if g % prefix_every == 0:
                status[g] = PREFIX | (carry + group)
            else:
                late.append((g, carry + group))
        t = g * K + np.arange(K)
        keep = t < T
        offs[t[keep]] = carry + (inc[g] - total[g])[keep]
        writes[t[keep]] += 1
        if g == (T - 1) // K:
            offs[T] = carry + group
            writes[T] += 1
    for g, value in late:
        status[g] = PREFIX | value
    assert (writes == 1).all(), "every offset written once"
    return offs, most


def _counts(kind: str, R: int, seed: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(R, np.uint8)
    if kind == "full":
        return np.full(R, 255, np.uint8)
    return np.random.default_rng(seed).integers(0, 256, R, np.uint8)


# R around a tile, a group, a look-back window (33 and 34 groups) and 40
# groups, and tail groups whose last tile holds R mod 4096 in {0, 1, 4095}
# runs.
SIZES = sorted({0, 1, ITEMS - 1, ITEMS + 1, TILE - 1, TILE, TILE + 1,
                K * TILE - 1, K * TILE, K * TILE + 1, 32 * K * TILE + 1,
                33 * K * TILE + 1, 40 * K * TILE, (40 * K - 1) * TILE + 1,
                (40 * K - 1) * TILE + TILE - 1, (3 * K + 2) * TILE + 1})


@pytest.mark.parametrize("kind", ["random", "zeros", "full"])
@pytest.mark.parametrize("R", SIZES)
def test_model_matches_the_twin_and_the_block_ends(R, kind):
    counts = _counts(kind, R, R + K)
    offs, _ = _model_run_offsets(counts)
    want = rl_cuda.run_offsets_ref(torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(offs, want)
    if R:
        np.testing.assert_array_equal(offs[1:], rl_torch._block_ends(counts))


@pytest.mark.parametrize("prefix_every,windows",
                         [(1, 1), (5, 1), (1000, 2)])
def test_look_back_steps_past_its_window(prefix_every, windows):
    """40 groups, every group's prefix published at once, every fifth's,
    or only group 0's: in the last case the last group folds a whole
    window of 32 aggregates, steps back, and meets group 0's prefix in the
    next."""
    R = 40 * K * TILE - 77
    counts = _counts("random", R, K)
    want = rl_cuda.run_offsets_ref(torch.from_numpy(counts)).numpy()
    offs, most = _model_run_offsets(counts, prefix_every)
    np.testing.assert_array_equal(offs, want)
    assert most == windows


def test_wrapper_group_and_tile_match_the_headers():
    assert rl_cuda.RUN_GROUP == K
    assert TILE == rl_cuda.TILE
    assert WARPS * WARP == THREADS


def test_wrapper_returns_the_twin_on_the_cpu():
    counts = _counts("random", 3 * TILE + 5, 3)
    c = torch.from_numpy(counts)
    before = rl_cuda.LAUNCHES["rl_offsets"]
    np.testing.assert_array_equal(rl_cuda.run_offsets(c).numpy(),
                                  rl_cuda.run_offsets_ref(c).numpy())
    assert rl_cuda.LAUNCHES["rl_offsets"] == before
