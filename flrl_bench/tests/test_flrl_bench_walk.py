"""The cell ``fl-files-mixed-3124m`` at a size the CPU can run, cut into
four chunks as the walk cuts a 3124 MiB file (three full chunks and a
short tail): a whole run correct, a fault in the third chunk's part of the
container caught, the control not correct; the readers of the walk's spans
(``metrics/walk_overlap_pct.*``) on synthetic profiler events; and the
plain reference's FL encode over many of its blocks, as the 3124 MiB check
runs it, against the port's NumPy codec."""

import numpy as np
import pytest
import torch

from flrl_bench import control, reference, run, spec, trace
from flrl_bench.run import Group, Run
from test_flrl_bench_metrics import MS, FakeEvent, FakeProf, _events

CELL = "fl-files-mixed-3124m"
L = 128
# frames a chunk, so that small_root's 1 MiB file is three full chunks
# (2,400 frames each) and a tail of 992 frames
CHUNK_FRAMES = 2400


@pytest.fixture
def four_chunks(monkeypatch):
    """The walk's chunk cap cut to CHUNK_FRAMES frames; returns the list
    that counts the dense route's submits."""
    from fl_rl_compression_mpi_tpu_torch.ops import fl_torch
    monkeypatch.setattr(fl_torch, "MAX_DEVICE_CHUNK", CHUNK_FRAMES * L)
    submits = []
    real = fl_torch._submit_dense

    def submit(lanes, data, frame_length):
        submits.append(data.size)
        return real(lanes, data, frame_length)
    monkeypatch.setattr(fl_torch, "_submit_dense", submit)
    return submits


def _run_cell(root, bench_dir, seed=2**33 + 7, seconds=3.0):
    return run.run_cell(spec.cell(CELL, root, bench_dir), seed, seconds,
                        False, 0.0, "cpu", log=lambda *a, **k: None,
                        bench_dir=bench_dir)


def test_four_chunk_cell_is_correct(small_root, four_chunks):
    root, bench_dir = small_root
    cell = spec.cell(CELL, root, bench_dir)
    assert cell.config.file_bytes == 1 << 20 and cell.chips == 1
    assert [m.name for m in cell.metrics if m.kind == "end_to_end"] == [
        "compress_gbps", "decompress_gbps", "setup_s"]
    result = _run_cell(root, bench_dir)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    # every compress call walked four chunks: three full ones and the tail
    chunk = CHUNK_FRAMES * L
    assert four_chunks[:4] == [chunk] * 3 + [(1 << 20) - 3 * chunk]
    assert len(four_chunks) % 4 == 0


def test_fault_in_third_chunk_is_caught(small_root, four_chunks,
                                        monkeypatch):
    """One payload byte flipped inside the third chunk's part of every
    window call's container: ``correct`` false."""
    from fl_rl_compression_mpi_tpu_torch import api
    from fl_rl_compression_mpi_tpu_torch.ops import fl_torch
    root, bench_dir = small_root
    real, calls = api.compress, []

    def compress(data, method="fl", **opts):
        c = real(data, method, **opts)
        calls.append(1)
        if len(calls) <= 2:             # the warm-up's, one a pool file
            return c
        cap = CHUNK_FRAMES * L
        start = fl_torch.payload_size(c.bits[:2 * CHUNK_FRAMES], 2 * cap, L)
        end = start + fl_torch.payload_size(
            c.bits[2 * CHUNK_FRAMES:3 * CHUNK_FRAMES], cap, L)
        values = np.array(c.values, copy=True)
        values[(start + end) // 2] ^= 1
        return type(c)(c.bits, values, c.input_size)
    monkeypatch.setattr(api, "compress", compress)
    result = _run_cell(root, bench_dir)
    assert result["correct"] is False
    assert result["checks"]["container_bytes_wrong"]["value"] > 0


def test_control_is_not_correct_at_four_chunks(small_root, four_chunks):
    root, bench_dir = small_root
    cell = spec.cell(CELL, root, bench_dir)
    for seed in (1, 2**33 + 5):
        numbers = control.readings(cell, seed, torch.device("cpu"))
        assert not control.check.correct(numbers)
        assert numbers["container_bytes_wrong"][0] > 0
        assert numbers["decoded_bytes_wrong"][0] > 0


# ---------------------------------------------------------------------------
# walk_overlap_pct on synthetic traces (test_flrl_bench_metrics's events:
# compress span 0-10 ms, card 0 busy 1-3 and 4-6 ms, card 1 busy 2-5 ms;
# decompress span 20-30 ms, card 0 busy 21-23 and 24-28 ms, card 1 idle)
# ---------------------------------------------------------------------------

US = MS // 1000


def _walk_run(walk):
    r = Run(spec.cell(CELL), 30.0)
    r.groups = [Group("c", 0, 1, 1, 1, 0.010, True, 0),
                Group("d", 0, 1, 1, 1, 0.010, True, 0)]
    r.trace = trace.digest(FakeProf(_events() + walk), (0, 1))
    return r


def _read(name, r):
    return spec.reader(name)(r)


def test_walk_overlap_exact_share_over_two_cards():
    r = _walk_run([
        FakeEvent("flrl.walk.submit", False, 0, 2500 * US),
        FakeEvent("flrl.walk.drain", False, 3 * MS, 1500 * US),
        FakeEvent("flrl.walk.submit", False, 5500 * US, 1500 * US),
        FakeEvent("flrl.walk.drain", False, 7 * MS, 2 * MS),
        # a submit outside the harness's spans counts in neither direction
        FakeEvent("flrl.walk.submit", False, 12 * MS, 6 * MS),
        FakeEvent("flrl.walk.submit", False, 20 * MS, 2 * MS),
        FakeEvent("flrl.walk.drain", False, 23 * MS, 1 * MS),
        FakeEvent("flrl.walk.submit", False, 24500 * US, 500 * US),
    ])
    # c: card 0 has 2 of 4 ms under a submit (1-2.5, 5.5-6), card 1 0.5
    # of 3 ms (2-2.5)
    assert _read("walk_overlap_pct.c", r) == pytest.approx(
        100 * (2 / 4 + 0.5 / 3) / 2)
    # d: card 0 has 1.5 of 6 ms (21-22, 24.5-25); card 1 ran nothing
    assert _read("walk_overlap_pct.d", r) == pytest.approx(25.0)


def test_walk_overlap_zero_where_no_work_is_under_a_submit():
    r = _walk_run([
        FakeEvent("flrl.walk.submit", False, 0, 500 * US),
        FakeEvent("flrl.walk.drain", False, 1 * MS, 5 * MS),
        FakeEvent("flrl.walk.submit", False, 9 * MS, 1 * MS),
        FakeEvent("flrl.walk.drain", False, 21 * MS, 7 * MS),
    ])
    assert _read("walk_overlap_pct.c", r) == 0.0
    assert _read("walk_overlap_pct.d", r) == 0.0


def test_walk_overlap_none_without_walk_spans():
    names = ("walk_overlap_pct.c", "walk_overlap_pct.d")
    r = _walk_run([FakeEvent("flrl.host.stage_in", False, 0, 2 * MS)])
    assert [_read(n, r) for n in names] == [None, None]
    r.trace = None
    assert [_read(n, r) for n in names] == [None, None]


def test_walk_overlap_stays_in_its_range():
    r = _walk_run([FakeEvent("flrl.walk.submit", False, 0, 30 * MS)])
    assert _read("walk_overlap_pct.c", r) == pytest.approx(100.0)
    assert _read("walk_overlap_pct.d", r) == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# the reference over many blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [0, 37])
@pytest.mark.parametrize("frame_length", [128, 24])
def test_reference_fl_encode_over_many_blocks(frame_length, tail,
                                              monkeypatch):
    """With the block cut to 64 frames' bytes, a seeded stream of more than
    ten blocks (and a short last frame where ``tail``) encodes to the port's
    NumPy codec's container."""
    from fl_rl_compression_mpi_tpu_torch.ops import fl_numpy
    monkeypatch.setattr(reference, "BLOCK_BYTES", 64 * frame_length)
    n = 700 * frame_length + tail
    assert n > 10 * reference.BLOCK_BYTES
    g = np.random.default_rng(frame_length + tail)
    shift = g.integers(0, 8, -(-n // frame_length),
                       dtype=np.uint8).repeat(frame_length)[:n]
    data = g.integers(0, 256, n, dtype=np.uint8) >> shift
    got = reference.fl_encode(torch.from_numpy(data), frame_length)
    bits, values = fl_numpy.encode(data, frame_length)
    assert got.input_size == n
    np.testing.assert_array_equal(got.first.numpy(), bits)
    np.testing.assert_array_equal(got.second.numpy(), values)
