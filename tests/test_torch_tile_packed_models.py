"""NumPy models of the index math of the tile-packed encode's cluster route
(``csrc/tile_packed.cu`` ``cluster_encode_kernel``), held against the
plain version ``ops/tile_packed_cuda.py:encode_ref``, and that against the
JAX kernel it replaces (``enc_packed`` of ``experiments/exp21_tile_packed.py``
and ``exp22_tile_packed2.py``, in interpret mode).

The route rests on three facts, each checked here on the CPU:

- with R = 8·Q, every slot source of packed row pr at every depth lies in
  pr's class mod Q, so a block that holds the 8 rows q + j·Q of its
  classes q needs no other block's rows;
- the split of a tile's classes over C blocks (``block_classes``, the
  kernel's ``c0`` and ``ncls``) covers each row exactly once, also where Q
  is not a multiple of C;
- blocks that each see only their classes, one OR a tile across the
  cluster, then each unit's first packed row from a decoupled look-back
  over its ticket's predecessors (``scan.cuh``'s, a window of 32 status
  words; prefixes published late, in a random order of events) give
  ``encode_ref``'s widths, offsets and defined packed rows, at every depth
  and in both layouts.

Tolerance: exact (integer functions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_exp_scripts
from torch_tile_packed_header import header
from fl_rl_compression_mpi_tpu_torch.ops import tile_packed_cuda as tp

R_VALUES = (8, 16, 24, 40, 64, 1024, 2048)
AGGREGATE, PREFIX = 1, 2
WINDOW = 32                 # status words a look-back step reads (a warp)


def slot_rows(D: int, k: int, R: int) -> int:
    """Slot k's source offset in the tile at depth D (``slot_rows<D>``)."""
    return sum(R >> (s + 1) for s in range(D) if (k >> s) & 1)


def slot_shift(D: int, k: int) -> int:
    return sum(16 >> s for s in range(D) if (k >> s) & 1)


def class_slot(D: int, k: int) -> int:
    """Slot k's source row j within a class (``class_slot<D>``)."""
    return sum(4 >> s for s in range(D) if (k >> s) & 1)


def block_classes(R: int, C: int, rank: int) -> range:
    """The classes q (rows q + j·R/8, j < 8) that block ``rank`` of a
    cluster of C blocks holds of each tile: [rank·Q/C, (rank+1)·Q/C)."""
    Q = R // 8
    return range(rank * Q // C, (rank + 1) * Q // C)


def depth_of(tile_or: int) -> int:
    bt = max(1, int(tile_or).bit_length())
    return 3 if bt <= 1 else 2 if bt <= 2 else 1 if bt <= 4 else 0


@pytest.mark.parametrize("R", R_VALUES)
@pytest.mark.parametrize("D", range(4))
def test_slot_sources_stay_in_the_class(D, R):
    Q = R // 8
    pr = np.arange(R >> D)
    for k in range(1 << D):
        src = pr + slot_rows(D, k, R)
        assert (src < R).all()
        np.testing.assert_array_equal(src % Q, pr % Q)
        # row j of the class: pr's own row index in the class plus the slot
        np.testing.assert_array_equal(src // Q, pr // Q + class_slot(D, k))
    # the class's packed rows q + i·Q, i < 8 >> D, are the tile's R >> D
    assert (8 >> D) * Q == R >> D


_SPLITS = [(R, C) for R in R_VALUES for C in (1, 2, 3, 4, 8, 16)
           if C <= R // 8]


@pytest.mark.parametrize("R,C", _SPLITS)
def test_class_split_covers_each_row_once(R, C):
    Q = R // 8
    seen = np.zeros(R, np.int64)
    for rank in range(C):
        classes = block_classes(R, C, rank)
        assert len(classes) >= 1
        assert len(classes) <= -(-Q // C)
        for j in range(8):
            seen[[q + j * Q for q in classes]] += 1
    np.testing.assert_array_equal(seen, 1)


def test_the_route_splits_every_tile_it_takes():
    """Every R the cluster route takes, to 6,144: the launcher's C divides
    no more classes than a block may hold."""
    h = header()
    last = h.kClusterMax * h.kClusterMaxRows
    assert last == 6144
    for R in range(8, last + 16, 8):
        C, T = h.cluster_blocks(R), h.cluster_tiles(R)
        assert h.cluster_fits(R) == (R <= last)
        assert h.tile_packed_route(R) == h.cluster_fits(R)
        if not h.cluster_fits(R):
            continue
        assert C <= R // 8 and (C == 1 or T == 1)
        assert T * 8 * max(len(block_classes(R, C, r))
                           for r in range(C)) <= h.kClusterMaxRows


# --------------------------------------------------------------------------
# A model of the cluster route
# --------------------------------------------------------------------------

def tile_words(g, R: int, kinds) -> np.ndarray:
    """u32 words (tiles·R, 128), one tile of each kind: "0" all zero bytes,
    b random bytes of width b (one byte at the top of the width), "mix" a
    width-1 tile with one frame of width 3."""
    tiles = []
    for kind in kinds:
        if kind == "0":
            t = np.zeros((R, 512), np.uint8)
        elif kind == "mix":
            t = g.integers(0, 2, (R, 512), np.uint8)
            t[0, :128] = g.integers(0, 8, 128, np.uint8)
            t[0, 0] = 4
        else:
            b = int(kind)
            t = g.integers(0, 1 << b, (R, 512), np.uint8)
            t[g.integers(0, R), g.integers(0, 512)] = 1 << (b - 1)
        tiles.append(t)
    return np.concatenate(tiles).view(np.uint32).reshape(-1, 128)


def spread(w: np.ndarray, b: np.ndarray) -> np.ndarray:
    w = w.astype(np.uint64)
    b = b.astype(np.uint64)
    return ((w & 0xFF) | (((w >> 8) & 0xFF) << b)
            | (((w >> 16) & 0xFF) << (2 * b)) | ((w >> 24) << (3 * b)))


def block_widths(x: np.ndarray) -> np.ndarray:
    """(rows, 4) widths of (rows, 128) words: max(1, bitlen(OR of the
    frame's bytes))."""
    o = np.bitwise_or.reduce(x.reshape(-1, 4, 32), axis=2)
    o = (o | (o >> 16)) & 0xFFFF
    o = ((o | (o >> 8)) & 0xFF).astype(np.int64)
    return 1 + sum((o >= (1 << k)).astype(np.int64) for k in range(1, 8))


def look_back(status: list, u: int):
    """``scan.cuh``'s look_back for unit u >= 1 on a snapshot of the status
    words: None where the warp would still wait, else the exclusive
    prefix."""
    prefix, end = 0, u
    while True:
        window = [(status[j] if j >= 0 else (PREFIX, 0))
                  for j in range(end - 1, end - 1 - WINDOW, -1)]
        near = next((i for i, s in enumerate(window) if s[0] == PREFIX), None)
        wanted = window if near is None else window[:near + 1]
        if any(s[0] == 0 for s in wanted):
            return None
        prefix += sum(v for _, v in wanted)
        if near is not None:
            return prefix
        end -= WINDOW


def schedule(units: int, g) -> list:
    """The order in which units publish and look back: tickets in order,
    each unit's steps after its own start, any interleaving across units
    (a unit's aggregate, look-back and prefix may all come late)."""
    steps, started, pending = [], 0, {}
    while started < units or pending:
        if started < units and (not pending or g.random() < 0.3):
            pending[started] = 0
            started += 1
            continue
        u = list(pending)[g.integers(0, len(pending))]
        steps.append(u)
        pending[u] += 1
        if pending[u] == 2:
            del pending[u]
    return steps


def cluster_model(words: np.ndarray, R: int, layout: str, C: int, T: int,
                  g):
    """(bits, packed, offs) of the cluster route, block by block."""
    nrows = words.shape[0]
    tiles, Q = nrows // R, R // 8
    units = -(-tiles // T)
    bits = np.zeros((nrows, 4), np.uint8)
    packed = np.zeros((nrows, 128), np.uint64)
    tile_or = np.zeros(tiles, np.int64)
    stage = {}
    # 1-2: each block sees only its classes of its unit's tiles
    for u in range(units):
        for rank in range(C):
            cl = np.array(block_classes(R, C, rank))
            for t in range(u * T, min(tiles, u * T + T)):
                rows = t * R + np.arange(8)[:, None] * Q + cl[None, :]
                x = words[rows.reshape(-1)]             # j-major, as staged
                b = block_widths(x)
                bits[rows.reshape(-1)] = b
                o = int(np.bitwise_or.reduce(x.reshape(-1)))
                o |= o >> 16
                tile_or[t] |= (o | (o >> 8)) & 0xFF
                stage[t, rank] = (cl, x.reshape(8, len(cl), 128),
                                  b.reshape(8, len(cl), 4))
    depth = np.array([depth_of(o) for o in tile_or], np.int64)
    # 4: each unit's first packed row
    base = np.arange(tiles, dtype=np.int64) * R
    offs = None
    if layout == "cursor":
        status = [(0, 0)] * units
        rows_of = [int(sum(R >> depth[t]
                           for t in range(u * T, min(tiles, u * T + T))))
                   for u in range(units)]
        first = [None] * units
        for u in schedule(units, g):
            if status[u][0] == 0:          # the aggregate, or tile 0's prefix
                status[u] = (PREFIX if u == 0 else AGGREGATE, rows_of[u])
                if u == 0:
                    first[0] = 0
                continue
            while first[u] is None:        # waits, then the prefix
                p = look_back(status, u)
                if p is None:              # publish the units it waits on
                    j = next(j for j in range(u - 1, -1, -1)
                             if status[j][0] == 0)
                    status[j] = (PREFIX if j == 0 else AGGREGATE, rows_of[j])
                    if j == 0:
                        first[0] = 0
                    continue
                first[u] = p
                status[u] = (PREFIX, p + rows_of[u])
        offs = np.zeros(tiles + 1, np.int64)
        for u in range(units):
            at = first[u]
            for t in range(u * T, min(tiles, u * T + T)):
                offs[t] = at
                at += R >> depth[t]
        offs[tiles] = first[-1] + rows_of[-1] if units else 0
        base = offs[:tiles]
    # 3, 5: each class packed from its own rows, stored at its packed rows
    for (t, rank), (cl, x, b) in stage.items():
        D = int(depth[t])
        lanes_b = np.repeat(b, 32, axis=2)            # (8, ncls, 128)
        for i in range(8 >> D):
            acc = np.zeros((len(cl), 128), np.uint64)
            for k in range(1 << D):
                j = i + class_slot(D, k)
                acc |= spread(x[j], lanes_b[j]) << np.uint64(slot_shift(D, k))
            packed[base[t] + i * Q + cl] = acc
    return bits, packed.astype(np.uint32), offs


KINDS = ("0", "1", "2", "3", "4", "5", "8", "mix")
# (R, C, T): each R's own geometry, and splits where Q is not a multiple
# of C, one-block units with a short last unit, and tickets past 32 units
_GEOMETRIES = sorted({(R, header().cluster_blocks(R),
                       header().cluster_tiles(R)) for R in R_VALUES} | {
    (24, 2, 1), (40, 4, 1), (40, 1, 3), (64, 8, 1), (136, 2, 1),
    (136, 16, 1), (8, 1, 1), (16, 1, 5)})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", tp.LAYOUTS)
@pytest.mark.parametrize("R,C,T", _GEOMETRIES)
def test_cluster_model_matches_encode_ref(R, C, T, layout, seed):
    g = np.random.default_rng(100 * R + 10 * C + seed)
    # 8 tiles at R >= 1024, 16 at 24..136, 72 at 8 and 16 (tickets past
    # two look-back windows where a unit is a tile)
    reps = 1 if R >= 1024 else 2 if R > 16 else 9
    kinds = tuple(g.permutation(np.array(KINDS * reps)))
    words = tile_words(g, R, kinds)
    bits, packed, offs = cluster_model(words, R, layout, C, T, g)
    w = torch.from_numpy(words.view(np.int32).copy())
    rb, rp, ro = tp.encode_ref(w, R, layout)
    np.testing.assert_array_equal(bits, rb.numpy())
    assert sorted(set(tp.depths(rb, R).tolist())) == [0, 1, 2, 3]
    if layout == "cursor":
        np.testing.assert_array_equal(offs, ro.numpy())
    else:
        assert offs is None and ro is None
    rows = tp.defined_rows(rb, R, ro).numpy()
    np.testing.assert_array_equal(packed[rows], rp.numpy().view(np.uint32)[rows])


@pytest.mark.parametrize("units", [1, 2, 31, 32, 33, 70, 200])
def test_look_back_over_late_prefixes(units):
    """Each unit's prefix from the model's look-back equals the exclusive
    sum of its predecessors' rows, whatever the order of events."""
    g = np.random.default_rng(units)
    rows = g.integers(1, 1 << 10, units)
    status = [(0, 0)] * units
    first = [None] * units
    for u in schedule(units, g):
        if status[u][0] == 0:
            status[u] = (PREFIX if u == 0 else AGGREGATE, int(rows[u]))
            if u == 0:
                first[0] = 0
        elif first[u] is None:
            p = look_back(status, u)
            if p is not None:
                first[u] = p
                status[u] = (PREFIX, p + int(rows[u]))
    # the units still waiting finish once the rest have published
    while None in first:
        for u in range(units):
            if first[u] is None and status[u][0]:
                p = look_back(status, u)
                if p is not None:
                    first[u] = p
                    status[u] = (PREFIX, p + int(rows[u]))
    np.testing.assert_array_equal(first, np.cumsum(rows) - rows)


_JAX = [(layout, R) for layout in tp.LAYOUTS for R in (16, 24)]
SCRIPTS = {"cursor": "exp21_tile_packed", "sparse": "exp22_tile_packed2"}


@pytest.mark.parametrize("layout,R", _JAX)
def test_model_and_encode_ref_match_the_jax_kernel(layout, R):
    g = np.random.default_rng(R + (layout == "sparse"))
    words = tile_words(g, R, KINDS)
    script = torch_exp_scripts.load(SCRIPTS[layout])
    out = script.enc_packed(R, words.shape[0])(jnp.asarray(words))
    jbits, jpacked = np.array(out[0]), np.array(out[1])
    w = torch.from_numpy(words.view(np.int32).copy())
    rb, rp, ro = tp.encode_ref(w, R, layout)
    h = header()
    bits, packed, offs = cluster_model(words, R, layout, h.cluster_blocks(R),
                                       h.cluster_tiles(R), g)
    np.testing.assert_array_equal(rb.numpy(), jbits)
    np.testing.assert_array_equal(bits, jbits)
    if layout == "cursor":
        np.testing.assert_array_equal(ro.numpy(), np.array(out[2]))
        np.testing.assert_array_equal(offs, np.array(out[2]))
    rows = tp.defined_rows(rb, R, ro).numpy()
    np.testing.assert_array_equal(rp.numpy().view(np.uint32)[rows],
                                  jpacked[rows])
    np.testing.assert_array_equal(packed[rows], jpacked[rows])
