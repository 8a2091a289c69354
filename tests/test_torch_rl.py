"""The PyTorch package's RL codec on the CPU: the plain versions of the RL
kernels (``rl_cuda``) and the dispatch (``rl_torch``) against
``rl_numpy``, the JAX package's ``rl_jax`` and the golden container.
Tolerance: byte equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

from fuzz_battery import battery
from test_rl_pallas import _cases
from fl_rl_compression_mpi_tpu import container
from fl_rl_compression_mpi_tpu.models.registry import CODECS as JAX_CODECS
from fl_rl_compression_mpi_tpu.ops import rl_jax, rl_numpy
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.ops import fl_torch, rl_cuda, rl_torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BATTERY = battery()
CASES = _cases()
INPUTS = ([(f"battery{i}", d) for i, d in enumerate(BATTERY)]
          + [(name, d) for name, d in CASES])


def _plain_encode(data, prev=-1, d0=0):
    """The encode kernel's plain version, through its wrapper, on one
    chunk."""
    x = torch.from_numpy(np.ascontiguousarray(data))
    values, counts, run_start = rl_cuda.encode_chunk(x, prev, d0)
    assert values.numel() == counts.numel() <= x.numel()
    return counts.numpy(), values.numpy(), run_start


def _plain_decode(counts, values):
    c, v = torch.from_numpy(counts), torch.from_numpy(values)
    offs = rl_cuda.run_offsets_ref(c)
    out = rl_cuda.expand_ref(c, v, offs, int(offs[-1]))
    assert out.numel() == int(offs[-1])
    return out.numpy()


def _enc(data):
    return rl_torch.encode(data, device="cpu")


def _dec(counts, values):
    return rl_torch.decode(counts, values, device="cpu")


@pytest.mark.parametrize("name,data", INPUTS, ids=[n for n, _ in INPUTS])
def test_plain_kernels_match_rl_numpy(name, data):
    counts, values, run_start = _plain_encode(data)
    cg, vg = rl_numpy.encode(data)
    np.testing.assert_array_equal(counts, cg)
    np.testing.assert_array_equal(values, vg)
    jc, jv = rl_jax.encode(data)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(values, jv)
    natural = np.flatnonzero(np.diff(data.astype(np.int16))) + 1
    assert run_start == (natural[-1] if natural.size else 0)
    np.testing.assert_array_equal(_plain_decode(cg, vg), data)


@pytest.mark.parametrize("name,data", INPUTS, ids=[n for n, _ in INPUTS])
def test_dispatch_matches_rl_jax(name, data):
    counts, values = _enc(data)
    jc, jv = rl_jax.encode(data)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(values, jv)
    np.testing.assert_array_equal(_dec(counts, values),
                                  rl_jax.decode(jc, jv))


def test_golden_container_reproduced_and_decoded(tmp_path):
    data = np.fromfile(os.path.join(GOLDEN, "input.bin"), np.uint8)
    out = str(tmp_path / "o.rl")
    container.save_rl(out, container.RLCompressed(*_enc(data), data.size))
    with open(out, "rb") as a, open(os.path.join(GOLDEN, "input.rl"),
                                    "rb") as b:
        assert a.read() == b.read()
    ref = container.load_rl(os.path.join(GOLDEN, "input.rl"))
    np.testing.assert_array_equal(_dec(ref.counts, ref.values), data)


@pytest.mark.parametrize("n", [1, 254, 255, 256, 510, 255 * 300 + 17])
@pytest.mark.parametrize("c", [0, 7, 255])
def test_constant_closed_forms_match_rl_jax(n, c):
    data = np.full(n, c, np.uint8)
    counts, values = _enc(data)
    jc, jv = rl_jax.encode(data)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(values, jv)
    np.testing.assert_array_equal(_dec(counts, values), data)
    np.testing.assert_array_equal(_dec(counts, values),
                                  rl_jax.decode(jc, jv))


def _walk_stream():
    """Runs that put chunk boundaries mid-piece, at a distance ≡ 0 (mod
    255) from a run start and on a new value, for the caps below."""
    g = np.random.default_rng(5)
    lens = [700, 1, 255, 510, 3, 254, 256, 1200, 2, 765, 97]
    vals = g.integers(0, 4, len(lens)).astype(np.uint8)
    vals[1::2] = 9                          # neighbours always differ
    return np.concatenate([np.repeat(vals, lens),
                           g.integers(0, 3, 5000, np.uint8)])


def _long_walk_stream():
    """300,000 bytes of runs of 1 to 599 over four values: several 64 KiB
    chunks, or one whole one."""
    g = np.random.default_rng(5)
    return np.repeat(g.integers(0, 4, 9000, np.uint8),
                     g.integers(1, 600, 9000))[:300_000].copy()


CAPS = [100, 255, 256, 510, 700, 701, 4096, 5000]
STREAMS = {"walk": _walk_stream, "long": _long_walk_stream}


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("cap", CAPS + [1 << 16, 1 << 30])
def test_chunk_walk_equals_one_pass(stream, cap, monkeypatch):
    data = STREAMS[stream]()
    one_c, one_v = _enc(data)
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap)
    counts, values = _enc(data)
    np.testing.assert_array_equal(counts, one_c)
    np.testing.assert_array_equal(values, one_v)
    want_c, want_v = rl_numpy.encode(data)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(values, want_v)
    out = _dec(counts, values)
    np.testing.assert_array_equal(out, data)
    block_end = rl_torch._block_ends(counts)
    chunks = list(rl_torch._run_chunks(counts, block_end, cap))
    assert (len(chunks) > 1) == (cap < data.size)
    for r0, r1, o0, o1 in chunks:
        assert r1 > r0 and (o1 - o0 <= cap or r1 == r0 + 1)


def test_chunk_boundaries_fall_on_each_class():
    """The caps above do put chunk boundaries mid-piece, on a piece start
    inside a run and on a new value."""
    data = _walk_stream()
    counts, _ = rl_numpy.encode(data)
    starts = set(np.cumsum(counts.astype(np.int64)) - counts)
    natural = {0} | set(np.flatnonzero(data[1:] != data[:-1]) + 1)
    classes = set()
    for b in (b for cap in CAPS for b in range(cap, data.size, cap)):
        classes.add("new value" if b in natural
                    else "cap boundary" if b in starts else "mid-piece")
    assert classes == {"new value", "cap boundary", "mid-piece"}


def test_carry_in_matches_rl_numpy_on_the_whole_stream():
    """One chunk encoded with a carry-in yields the pieces the whole
    stream has there (the last count measured to the chunk's end)."""
    data = _walk_stream()
    whole_c, whole_v = rl_numpy.encode(data)
    starts = np.cumsum(whole_c.astype(np.int64)) - whole_c
    for cut in (700, 955, 1210, 1466, 2036):
        head = data[:cut]
        prev = int(head[-1])
        run = cut - 1
        while run > 0 and data[run - 1] == prev:
            run -= 1
        counts, values, run_start = _plain_encode(data[cut:], prev, cut - run)
        sel = starts >= cut
        np.testing.assert_array_equal(values, whole_v[sel])
        np.testing.assert_array_equal(counts, whole_c[sel])
        _, _, head_start = _plain_encode(head)
        assert head_start == run


@pytest.mark.parametrize("cap", [None, 3, 300])
def test_zero_count_containers(cap, monkeypatch):
    g = np.random.default_rng(8)
    counts = g.integers(0, 256, 2000).astype(np.uint8)
    counts[::3] = 0
    counts[-1] = 0
    values = g.integers(0, 256, 2000, np.uint8)
    if cap:
        monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap)
    # the sequential oracle and the native host codec; rl_numpy.decode
    # agrees while no zero count ends the container.  (rl_jax's XLA decode
    # places the values after an interior zero count wrongly, so it is not
    # the reference here.)
    want = rl_numpy.decode_seq(counts, values)
    np.testing.assert_array_equal(
        JAX_CODECS["rl-cpu"].decompress(
            container.RLCompressed(counts, values, 0)), want)
    live = np.flatnonzero(counts)[-1] + 1
    np.testing.assert_array_equal(
        rl_numpy.decode(counts[:live], values[:live]), want)
    np.testing.assert_array_equal(_dec(counts, values), want)
    np.testing.assert_array_equal(_plain_decode(counts, values), want)
    # all-zero counts decode to nothing
    assert _dec(np.zeros(5, np.uint8), values[:5]).size == 0


def test_decode_ignores_input_size_like_rl_jax(monkeypatch):
    monkeypatch.setattr(registry, "default_device",
                        lambda: torch.device("cpu"))
    data = _walk_stream()
    for size in (0, data.size - 1, data.size + 1000):
        comp = container.RLCompressed(*rl_numpy.encode(data), size)
        got = registry.CODECS["rl"].decompress(comp)
        np.testing.assert_array_equal(got, JAX_CODECS["rl"].decompress(comp))
        np.testing.assert_array_equal(got, data)


def test_decode_rejects_mismatched_lengths():
    with pytest.raises(ValueError, match="counts/values size mismatch"):
        _dec(np.ones(3, np.uint8), np.ones(2, np.uint8))


def test_wrappers_check_their_arguments():
    x = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="prev"):
        rl_cuda.encode_chunk(x, 256)
    with pytest.raises(ValueError, match="prev"):
        rl_cuda.encode_chunk(x, -2, 1)
    with pytest.raises(ValueError, match="d0"):
        rl_cuda.encode_chunk(x, 5, -1)
    with pytest.raises(ValueError, match="x"):
        rl_cuda.encode_chunk(x.to(torch.int32))
    with pytest.raises(ValueError, match="x"):
        rl_cuda.encode_chunk(x.view(2, 5))
    with pytest.raises(ValueError, match="counts"):
        rl_cuda.run_offsets(x.to(torch.int64))
    with pytest.raises(ValueError, match="values"):
        rl_cuda.expand(x, x[:5].clone(), torch.zeros(2, dtype=torch.int64),
                       0)
    with pytest.raises(ValueError, match="offs"):
        rl_cuda.expand(x, x.clone(), torch.zeros(3, dtype=torch.int64), 0)


def test_tiles_match_the_kernel_headers():
    csrc = os.path.join(os.path.dirname(rl_cuda.__file__), "..", "csrc")
    rl_h = open(os.path.join(csrc, "rl.cuh")).read()
    scan_h = open(os.path.join(csrc, "scan.cuh")).read()

    def const(src, name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert (const(rl_h, "kEncodeThreads") * const(rl_h, "kEncodeItems")
            == rl_cuda.ENCODE_TILE)
    assert const(rl_h, "kEncodeItems") == ITEMS
    assert (const(rl_h, "kExpandThreads") * const(rl_h, "kExpandRuns")
            == rl_cuda.TILE
            == const(scan_h, "kScanThreads") * const(scan_h, "kScanItems"))


# ---------------------------------------------------------------------------
# A model of the encode kernel's fold (csrc/rl.cu), held against the twin:
# thread elements (f, l, a) of ITEMS bytes joined over a tile, tiles'
# prefixes from a look-back over windows of 32 that stops at a published
# prefix.
# ---------------------------------------------------------------------------

CAP = rl_cuda.RUN_CAP
ITEMS = 64                      # kEncodeItems in csrc/rl.cuh: a thread's bytes
MODEL_TILES = (64, 256, 4096, rl_cuda.ENCODE_TILE)


def _ceil_cap(d):
    return -(-d // CAP)


def _join(x, y):
    """x followed by y; None: a range with no natural run start."""
    if y is None:
        return x
    if x is None:
        return y
    return (x[0], y[1], x[2] + _ceil_cap(y[0] - x[1]) + y[2])


def _carry_in(d0):
    r = d0 % CAP
    return (-r - CAP, -r - CAP, -1 - (r > 0))


def _pieces_before(prefix, p):
    return prefix[2] + _ceil_cap(p - prefix[1])


def _element(nat, p0):
    """One thread's (f, l, a) from its natural-start flags (fewer than 255:
    each segment between two starts is one piece)."""
    idx = np.flatnonzero(nat)
    if not idx.size:
        return None
    return (p0 + int(idx[0]), p0 + int(idx[-1]), idx.size - 1)


def _range(nat, lo, hi):
    """(f, l, a) of positions [lo, hi): its ITEMS-byte elements joined."""
    agg = None
    for p in range(lo, hi, ITEMS):
        agg = _join(agg, _element(nat[p:min(p + ITEMS, hi)], p))
    return agg


def _look_back(inclusive, aggs, t, published):
    """The exclusive prefix of tile t: fold 32 tiles a window, latest
    first, up to the nearest tile that has published its prefix (tile 0
    and every ``published``-th tile), else all 32 and step back."""
    acc = None
    for end in range(t, -32, -32):
        fold = None
        for j in range(end - 1, end - 33, -1):
            if j == 0 or j % published == 0:
                return _join(_join(inclusive[j], fold), acc)
            fold = _join(aggs[j], fold)
        acc = _join(fold, acc)
    raise AssertionError("no prefix found")


def _model_encode(data, prev, d0, tile, published=37):
    """(piece starts, counts, run start) of the chunk through the kernel's
    fold: per tile, the body (pieces from its first natural start f on,
    placed by the threads after f from their exclusive join, by the thread
    holding f from its natural starts) before the look-back, then the head
    (the pieces before f, 255 apart from the run in progress at b0); a
    piece's count runs to the next natural start, at most 255."""
    x = torch.from_numpy(np.ascontiguousarray(data))
    nat = rl_cuda._natural(x, prev).numpy()
    n = data.size
    T = -(-n // tile)
    elems = [[_element(nat[p0:min(p0 + ITEMS, n)], p0)
              for p0 in range(t * tile, min(n, (t + 1) * tile), ITEMS)]
             for t in range(T)]
    aggs, inclusive, starts = [], [], []
    for t in range(T):
        agg = None
        for e in elems[t]:
            agg = _join(agg, e)
        aggs.append(agg)
        b0, end = t * tile, min(n, (t + 1) * tile)
        body, exc = [], None
        for i, e in enumerate(elems[t]):
            p0 = b0 + ITEMS * i
            q = np.arange(p0, min(p0 + ITEMS, end))
            if exc is not None:
                assert len(body) == exc[2] + _ceil_cap(p0 - exc[1])
                s = np.maximum.accumulate(np.where(nat[q], q, exc[1]))
                body.extend(q[(q - s) % CAP == 0].tolist())
            elif e is not None:
                body.extend(q[nat[q]].tolist())
            exc = _join(exc, e)
        prefix = (_carry_in(d0) if t == 0
                  else _look_back(inclusive, aggs, t, published))
        inclusive.append(_join(prefix, agg))
        P = _pieces_before(prefix, b0)
        assert len(starts) == P
        head_end = agg[0] if agg is not None else end
        h = _pieces_before(prefix, head_end) - P
        cap0 = (CAP - (b0 - prefix[1]) % CAP) % CAP
        head = [b0 + cap0 + CAP * j for j in range(h)]
        assert all(b0 <= s < head_end for s in head)
        starts.extend(head + body)
        assert len(starts) == _pieces_before(inclusive[t], end)
    starts = np.array(starts, np.int64)
    natural = np.append(np.flatnonzero(nat), n)
    counts = np.minimum(CAP, natural[np.searchsorted(natural, starts,
                                                     side="right")] - starts)
    last = inclusive[-1][1] if T else -d0
    return starts, counts, (last if last >= 0 else -d0)


def _check_model(data, prev=-1, d0=0, tile=rl_cuda.ENCODE_TILE):
    counts, values, run_start = _plain_encode(data, prev, d0)
    starts, model_counts, model_start = _model_encode(data, prev, d0, tile)
    # the pieces end at the chunk's end; the first may start past byte 0
    c = counts.astype(np.int64)
    np.testing.assert_array_equal(starts, data.size - c.sum() + np.cumsum(c)
                                  - c)
    np.testing.assert_array_equal(model_counts, c)
    np.testing.assert_array_equal(values, data[starts])
    assert model_start == run_start


@pytest.mark.parametrize("tile", MODEL_TILES)
@pytest.mark.parametrize("name,data", INPUTS, ids=[n for n, _ in INPUTS])
def test_scan_model_matches_the_twin(name, data, tile):
    if data.size:
        _check_model(data, tile=tile)


@pytest.mark.parametrize("tile", MODEL_TILES)
def test_scan_model_on_the_walk_stream_with_carries(tile):
    data = _walk_stream()
    _check_model(data, tile=tile)
    for cut in (700, 955, 1210, 1466, 2036):
        prev = int(data[cut - 1])
        for d0 in (1, 254, 255, 256, 2**31 + 7):
            _check_model(data[cut:], prev, d0, tile)


def test_scan_model_steps_back_past_a_window():
    """A run of one byte over more than 32 tiles inside a non-constant
    chunk: the look-back folds whole windows of aggregates."""
    g = np.random.default_rng(12)
    data = np.concatenate([g.integers(0, 4, 300, np.uint8),
                           np.full(64 * 40 + 5, 7, np.uint8),
                           g.integers(0, 4, 300, np.uint8)])
    for published in (1000, 37):
        starts, _, _ = _model_encode(data, -1, 0, 64, published)
        counts, _ = rl_numpy.encode(data)
        np.testing.assert_array_equal(
            starts, np.cumsum(counts.astype(np.int64)) - counts)


def test_join_is_associative_and_matches_the_whole_range():
    g = np.random.default_rng(13)
    for _ in range(300):
        n = int(g.integers(3, 2000))
        data = np.repeat(g.integers(0, 3, n, np.uint8),
                         g.integers(1, 400, n))[:n]
        nat = rl_cuda._natural(torch.from_numpy(data), -1).numpy()
        i, j = sorted(g.choice(np.arange(1, n), 2, replace=False))
        a, b, c = (_range(nat, lo, hi) for lo, hi in ((0, i), (i, j), (j, n)))
        left = _join(_join(a, b), c)
        assert left == _join(a, _join(b, c)) == _range(nat, 0, n)
        # the whole range directly: pieces in [f, l), segment by segment
        s = np.flatnonzero(nat)
        assert left == (int(s[0]), int(s[-1]),
                        int(sum(_ceil_cap(int(d)) for d in np.diff(s))))


@pytest.mark.parametrize("d0", [1, 100, 254, 255, 256, 509, 2**31 + 7])
def test_carry_in_depends_on_d0_mod_255(d0):
    data = np.concatenate([np.full(600, 5, np.uint8), _walk_stream()])
    want = _plain_encode(data, 5, d0)
    for k in (1, 3, 2**24):
        got = _plain_encode(data, 5, d0 + 255 * k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] >= 0
    # a chunk that continues its run to the end returns the carried start
    counts, values, run_start = _plain_encode(data[:600], 5, d0)
    assert run_start == -d0
    first = (CAP - d0 % CAP) % CAP
    assert (values == 5).all() and counts.sum() == 600 - first
    assert counts[0] == min(CAP, 600 - first)


# ---------------------------------------------------------------------------
# The expand kernel's 16-byte output groups, modelled, against np.repeat.
# ---------------------------------------------------------------------------

def _expand_model(counts, values, tile, stage_max=0):
    """The expand kernel's walk: per tile of runs, a tile of at most
    ``stage_max`` output bytes run by run (its stage); a larger one by
    aligned 16-byte groups of its output range, one binary search a group
    for the run holding its first byte (among the runs of its 256 bytes,
    from the run holding each 256-byte mark), then forward over the runs;
    every byte written once."""
    R = counts.size
    T = -(-R // tile)
    c = np.zeros(T * tile, np.int64)
    c[:R] = counts
    base = np.concatenate([[0], np.cumsum(c.reshape(T, tile).sum(1))])
    out = np.zeros(int(base[-1]), np.uint8)
    writes = np.zeros(out.size, np.int64)
    for t in range(T):
        cc = c[t * tile:(t + 1) * tile]
        starts = np.concatenate([[0], np.cumsum(cc)])
        total = int(starts[-1])
        b, end = int(base[t]), int(base[t + 1])
        if total <= stage_max:
            vals = values[t * tile:(t + 1) * tile]
            out[b:end] = np.repeat(vals, cc[:vals.size])
            writes[b:end] += 1
            continue
        first_run = {}
        for j in range(tile):       # the run holding each 256-byte mark
            mark = -(-int(starts[j]) // 256)
            if mark * 256 < starts[j] + cc[j]:
                first_run[mark] = j
        for grp in range(b // 16, -(-end // 16)):
            q = grp * 16 - b
            k0, k1 = max(0, -q), min(16, end - grp * 16)
            mark = (q + k0) // 256
            lo = first_run[mark]
            hi = (first_run[mark + 1] + 1 if (mark + 1) * 256 < total
                  else tile)
            while hi - lo > 1:
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if starts[mid] <= q + k0 else (lo, mid)
            k = k0
            while k < k1:
                while starts[lo + 1] - q <= k:
                    lo += 1
                stop = min(k1, int(starts[lo + 1]) - q)
                out[grp * 16 + k:grp * 16 + stop] = values[t * tile + lo]
                writes[grp * 16 + k:grp * 16 + stop] += 1
                k = stop
    assert (writes == 1).all()
    return out


def _expand_classes():
    g = np.random.default_rng(14)
    cases = []
    for size in range(1, 34):           # output sizes 1..33
        cuts = np.sort(g.choice(np.arange(1, size), min(size - 1, 5),
                                replace=False)) if size > 1 else []
        cases.append((f"size{size}",
                      np.diff(np.concatenate([[0], cuts, [size]]))))
    for length in (1, 15, 16, 17, 255):
        cases.append((f"runs{length}", np.full(700, length)))
    # each 16-run tile's output 17 bytes on: every 16-byte phase
    phased = np.ones(16 * 40, np.int64)
    phased[::16] = 2
    cases.append(("phases", phased))
    zeros = g.integers(0, 256, 3000)
    zeros[::3] = 0
    zeros[-1] = 0
    cases.append(("zero-counts", zeros))
    return [(name, c.astype(np.uint8)) for name, c in cases]


EXPAND_CASES = _expand_classes()


@pytest.mark.parametrize("tile,stage_max", [(16, 0), (64, 0), (64, 512),
                                            (rl_cuda.TILE, 0),
                                            (rl_cuda.TILE, 8192)])
@pytest.mark.parametrize("name,counts", EXPAND_CASES,
                         ids=[n for n, _ in EXPAND_CASES])
def test_expand_classes(name, counts, tile, stage_max):
    values = np.random.default_rng(counts.size).integers(
        0, 256, counts.size, np.uint8)
    want = np.repeat(values, counts)
    np.testing.assert_array_equal(
        _expand_model(counts, values, tile, stage_max), want)
    np.testing.assert_array_equal(_plain_decode(counts, values), want)
    c = torch.from_numpy(counts)
    offs = rl_cuda.run_offsets(c)
    np.testing.assert_array_equal(
        offs.numpy(), np.concatenate(
            [[0], np.cumsum(np.add.reduceat(
                counts.astype(np.int64),
                np.arange(0, counts.size, rl_cuda.TILE)))]))


@pytest.mark.parametrize("cap", [None, 1 << 16])
def test_round_trip_spans_under_a_profiler(cap, monkeypatch):
    """Under a CPU profiler, an ``rl`` compress and decompress through the
    library API leave each stage's span, nested inside the caller's range:
    the host split of the runs among them; with the walk cut in chunks,
    the join of the chunks' runs too."""
    import fl_rl_compression_mpi_tpu_torch as flrl
    import torch_spans
    if cap:
        monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", cap)
    data = torch_spans.stream()
    with torch_spans.spans() as got:
        comp = flrl.compress(data, method="rl", device="cpu")
        out = flrl.decompress(comp, method="rl", device="cpu")
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(comp.counts, rl_numpy.encode(data)[0])
    want = {"flrl.host.probe", "flrl.h2d.pageable", "flrl.kernels",
            "flrl.d2h.pageable", "flrl.host.split", "flrl.host.out"}
    assert torch_spans.check(got) == want | ({"flrl.host.join"} if cap
                                             else set())
