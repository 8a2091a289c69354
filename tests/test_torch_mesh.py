"""The one-process mesh of ``parallel/dist.py`` on the CPU.

``compress_fl``, ``compress_fl_ici``, ``compress_rl`` and their decodes at
N = 1, 2, 3 and 4 shards, every shard on the CPU and all driven from this
process, are held against the JAX package's ``parallel.dist`` on
``make_mesh(N)`` of the virtual CPU devices (``bucket_frames=64``) and
against ``fl_numpy``/``rl_numpy``, on every input of ``torch_dist_cases``
and both FL routes; the constant programs' flags are clean and trip on a
flipped byte.  Every call runs with the ways out of this process refused: no
process group, no child process, nothing in shared memory; and each shard's
walk is checked to have received its shard's device.  Tolerance: byte
equality throughout."""

import multiprocessing
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
import fl_rl_compression_mpi_tpu_torch as flrl
from fl_rl_compression_mpi_tpu.ops import fl_numpy, rl_numpy
from fl_rl_compression_mpi_tpu.parallel import dist as jdist
from fl_rl_compression_mpi_tpu_torch.cli import main
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.ops import fl_constant_cuda as ck
from fl_rl_compression_mpi_tpu_torch.ops import fl_dense_cuda, fl_torch
from fl_rl_compression_mpi_tpu_torch.ops import rl_torch
from fl_rl_compression_mpi_tpu_torch.parallel import dist
from fl_rl_compression_mpi_tpu_torch.utils import constant_byte_probe
from fl_rl_compression_mpi_tpu_torch.utils.timers import (
    card_scope, current_card, set_stage_timers)

CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 4)
FL = {name: (data, L) for name, data, L in cases.fl_inputs()}
RL = dict(cases.rl_inputs())
WALKS = ((fl_torch, "encode_walk"), (fl_torch, "decode_walk"),
         (rl_torch, "encode_walk"), (rl_torch, "decode_walk"))
_JAX: dict = {}


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax(fn, data, shards: int, *args):
    """The JAX package's container at the same N, computed once."""
    key = (fn.__name__, id(data), shards)
    if key not in _JAX:
        _JAX[key] = fn(data, jdist.make_mesh(shards), *args,
                       bucket_frames=64)
    return _JAX[key]


@pytest.fixture
def one_process(monkeypatch):
    """Every way out of this process refused during the test: making a
    process group, starting a process, moving a tensor to shared memory,
    ``dist.spawn_group``; after it, no group and no child process."""
    def refuse(what):
        def fn(*args, **kwargs):
            raise AssertionError(f"a mesh run called {what}")
        return fn

    monkeypatch.setattr(torch.distributed, "init_process_group",
                        refuse("init_process_group"))
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        refuse("start_processes"))
    monkeypatch.setattr(torch.Tensor, "share_memory_",
                        refuse("share_memory_"))
    monkeypatch.setattr(dist, "spawn_group", refuse("spawn_group"))
    yield
    assert not torch.distributed.is_initialized()
    assert multiprocessing.active_children() == []


@pytest.fixture
def walks(monkeypatch):
    """Records ``(walk, shard, device)`` of every call of the chunk walks,
    the shard being the per-card thread's (None in the calling thread)."""
    seen = []
    lock = threading.Lock()
    for mod, name in WALKS:
        def record(*args, _orig=getattr(mod, name),
                   _name=f"{mod.__name__.rsplit('.', 1)[1]}.{name}",
                   **kwargs):
            dev = next(a for a in args if isinstance(a, torch.device))
            with lock:
                seen.append((_name, current_card(), dev))
            return _orig(*args, **kwargs)
        monkeypatch.setattr(mod, name, record)
    return seen


def _check_walks(seen, mesh, walk_names, closed_form: bool) -> None:
    """Each named walk ran once a shard, shard i on ``mesh[i]`` (in the
    calling thread for one shard), or not at all for a host closed form."""
    if closed_form:
        assert seen == []
        return
    for name in walk_names:
        got = sorted((card if card is not None else -1, str(dev))
                     for w, card, dev in seen if w == name)
        want = ([(-1, str(mesh[0]))] if len(mesh) == 1 else
                [(i, str(d)) for i, d in enumerate(mesh)])
        assert got == want, (name, got)


FL_IDS = [(n, name, route) for n in SHARDS for name in FL
          for route in cases.ROUTES]


@pytest.mark.parametrize("shards,name,route", FL_IDS,
                         ids=[f"n{n}-{name}-{r}" for n, name, r in FL_IDS])
def test_fl_mesh_equals_jax_and_fl_numpy(shards, name, route, monkeypatch,
                                         one_process, walks):
    """fl-dist and fl-ici on a mesh of N CPU shards equal the JAX package's
    ``compress_fl``/``compress_fl_ici`` on N devices and fl_numpy's; the
    decode of each is exact; every shard's walk ran on its device."""
    if route == "fields":
        monkeypatch.setenv("FLRL_NO_DENSE", "1")
    else:
        monkeypatch.delenv("FLRL_NO_DENSE", raising=False)
    data, L = FL[name]
    mesh = dist.make_mesh(shards, CPU)
    want_b, want_v = fl_numpy.encode(data, L)
    closed = constant_byte_probe(data) is not None or data.size == 0
    for fn, jfn in ((dist.compress_fl, jdist.compress_fl),
                    (dist.compress_fl_ici, jdist.compress_fl_ici)):
        walks.clear()
        comp = fn(data, L, mesh=mesh)
        _check_walks(walks, mesh, ["fl_torch.encode_walk"], closed)
        j = _jax(jfn, data, shards, L)
        _eq(comp.bits, want_b)
        _eq(comp.values, want_v)
        _eq(comp.bits, j.bits)
        _eq(comp.values, j.values)
        assert comp.input_size == data.size
        walks.clear()
        _eq(dist.decompress_fl(comp, L, mesh=mesh), data)
        # the decode's closed forms: a constant container, all-8 widths
        _check_walks(walks, mesh, ["fl_torch.decode_walk"], closed or bool(
            (want_b == 8).all()))


RL_IDS = [(n, name) for n in SHARDS for name in RL]


@pytest.mark.parametrize("shards,name", RL_IDS,
                         ids=[f"n{n}-{name}" for n, name in RL_IDS])
def test_rl_mesh_equals_jax_at_the_same_n(shards, name, one_process, walks):
    """rl-dist on a mesh of N CPU shards equals the JAX package's
    ``compress_rl`` on N devices and the concatenation of rl_numpy's
    per-shard containers; the decode, its run list split over the shards,
    is exact."""
    data = RL[name]
    mesh = dist.make_mesh(shards, CPU)
    comp = dist.compress_rl(data, mesh=mesh)
    _check_walks(walks, mesh, ["rl_torch.encode_walk"], False)
    j = _jax(jdist.compress_rl, data, shards)
    _eq(comp.counts, j.counts)
    _eq(comp.values, j.values)
    plan = dist.plan_shards(data.size, shards)
    parts = [rl_numpy.encode(plan.shard(data, i)) for i in range(shards)]
    _eq(comp.counts, np.concatenate([p[0] for p in parts]))
    _eq(comp.values, np.concatenate([p[1] for p in parts]))
    walks.clear()
    _eq(dist.decompress_rl(comp, mesh=mesh), data)
    _check_walks(walks, mesh, ["rl_torch.decode_walk"], False)


CONST_IDS = [(n, c) for n in SHARDS for c, _ in cases.constant_inputs(1)]


@pytest.mark.parametrize("shards,c", CONST_IDS,
                         ids=[f"n{n}-c{c}" for n, c in CONST_IDS])
def test_mesh_constant_programs_and_their_flags(shards, c, one_process):
    """The device-resident constant programs on a mesh: the shards' widths
    and payloads, concatenated, are fl_numpy's container; decode restores
    every shard; the flags, one a shard, are clean, and a flipped input
    byte trips its shard's alone, a flipped payload byte on the last shard
    the last one."""
    n = dict(cases.constant_inputs(shards))[c]
    data = np.full(n, c, np.uint8)
    cb, fb = ck.host_probe_constant(data, n, tile_r=cases.PROBE_TILE_R)
    mesh = dist.make_mesh(shards, CPU)
    plan = dist.plan_shards(n, shards)
    xs = [torch.from_numpy(plan.shard(data, i).copy())
          for i in range(shards)]
    bits, values, flags = dist.fl_compress_sharded_dense_constant(
        xs, cb, fb, mesh=mesh)
    sizes = [v.numel() for v in values]
    ns = [x.numel() for x in xs]
    back, dflags = dist.fl_decompress_sharded_dense_constant(
        values, sizes, ns, cb, fb, mesh=mesh)
    want_b, want_v = fl_numpy.encode(data)
    _eq(torch.cat(bits), want_b)
    _eq(torch.cat(values), want_v)
    _eq(torch.cat(back), data)
    assert flags.tolist() == dflags.tolist() == [0] * shards
    bad = data.copy()
    bad[n // 2] ^= 0x40
    hit = int(np.searchsorted(np.cumsum(plan.ns), n // 2, side="right"))
    xb = [torch.from_numpy(plan.shard(bad, i).copy()) for i in range(shards)]
    bad_flags = dist.fl_compress_sharded_dense_constant(xb, cb, fb,
                                                        mesh=mesh)[2]
    assert bad_flags.tolist() == [int(i == hit) for i in range(shards)]
    values[-1] = values[-1].clone()
    values[-1][values[-1].numel() // 2] ^= 0x10
    bad_dflags = dist.fl_decompress_sharded_dense_constant(
        values, sizes, ns, cb, fb, mesh=mesh)[1]
    assert bad_dflags.tolist() == [0] * (shards - 1) + [1]


def test_a_failing_shard_is_raised_after_every_shard_ended(monkeypatch,
                                                           one_process):
    """Shard 1's walk raises at once while shards 0 and 2 take longer: the
    caller gets shard 1's error only once the other two have finished, and
    no per-card thread is left."""
    done = []
    orig = fl_torch.encode_walk

    def walk(data, L, device, *args, **kwargs):
        if current_card() == 1:
            raise RuntimeError("shard 1 failed")
        time.sleep(0.3)
        out = orig(data, L, device, *args, **kwargs)
        done.append(current_card())
        return out

    monkeypatch.setattr(fl_torch, "encode_walk", walk)
    data, L = FL["mixed"]
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        dist.compress_fl(data, L, mesh=dist.make_mesh(3, CPU))
    assert sorted(done) == [0, 2]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("flrl-card")]


@pytest.mark.parametrize("method", ["fl-dist", "fl-ici", "rl-dist"])
def test_api_and_cli_run_the_mesh_in_this_process(method, tmp_path,
                                                  monkeypatch, one_process,
                                                  capsys):
    """``api.compress``/``decompress`` and ``cli.main`` at three devices
    (the registry's device patched to the CPU) run a mesh in this process:
    ``spawn_group``, a process group and a child process are all refused,
    and the containers equal the single-device ones."""
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    data, L = FL["mixed"]
    comp = flrl.compress(data, method=method, devices=3)
    if method == "rl-dist":
        plan = dist.plan_shards(data.size, 3)
        parts = [rl_numpy.encode(plan.shard(data, i)) for i in range(3)]
        _eq(comp.counts, np.concatenate([p[0] for p in parts]))
    else:
        _eq(comp.values, fl_numpy.encode(data, L)[1])
    _eq(flrl.decompress(comp, method=method, devices=3), data)
    src, out = str(tmp_path / "in.bin"), str(tmp_path / "o.c")
    data.tofile(src)
    assert main(["c", method, src, out, "--devices", "3", "--verify"]) == 0
    assert "verification OK" in capsys.readouterr().err


_TAGGED = re.compile(r"^\[card (\d)\] \[TIMER\] [A-Za-z0-9 ()-]+: "
                     r"[0-9.]+ ms( \([0-9.]+ [KMG]?B/s\))?$")


def test_timers_tag_each_card_and_leave_one_device_as_it_was(
        tmp_path, monkeypatch, capsys):
    """``--timers`` at ``--devices 2``: the stages of each shard print
    whole lines tagged ``[card 0]`` and ``[card 1]``; at ``--devices 1``
    no line is tagged and the stage lines are those of one device."""
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    data, _ = FL["mixed"]
    src = str(tmp_path / "in.bin")
    data.tofile(src)
    try:
        assert main(["c", "fl-dist", src, str(tmp_path / "a"), "--timers",
                     "--devices", "2"]) == 0
        two = capsys.readouterr().out.splitlines()
        assert main(["c", "fl-dist", src, str(tmp_path / "b"), "--timers",
                     "--devices", "1"]) == 0
        one = capsys.readouterr().out.splitlines()
    finally:
        set_stage_timers(False)
    tagged = [line for line in two if line.startswith("[card")]
    assert all(_TAGGED.match(line) for line in tagged), tagged
    assert {_TAGGED.match(line).group(1) for line in tagged} == {"0", "1"}
    stages = [line.split("] ", 1)[1].split(":")[0] for line in tagged
              if line.startswith("[card 0]")]
    assert not any(line.startswith("[card") for line in one)
    assert [line.split(":")[0] for line in one
            if line.split(":")[0] in stages] == stages


def test_launch_counts_from_many_threads(monkeypatch):
    """Launches counted at once from more threads than cores, with the
    interpreter switching threads as often as it can: no count is lost,
    totals and per-shard counts agree, and a reset clears both."""
    table = {"k": 0}
    threads, per = 16, 2000
    cpu = torch.device("cpu")

    def count(i):
        with card_scope(i):
            for _ in range(per):
                fl_dense_cuda.count_launch(table, "k", cpu)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=count, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert table["k"] == threads * per
    by_shard = fl_dense_cuda.launches_by("shard")
    assert {i: by_shard[i]["k"] for i in range(threads)} == {
        i: per for i in range(threads)}
    assert fl_dense_cuda.launches_by("device")[None]["k"] == threads * per
    fl_dense_cuda.reset_table(table)
    assert table["k"] == 0
    assert all("k" not in c for c in fl_dense_cuda.launches_by(
        "shard").values())


def test_make_mesh(monkeypatch):
    assert dist.make_mesh(3, "cpu") == (CPU,) * 3
    assert dist.make_mesh(device="cpu") == (CPU,)
    with pytest.raises(ValueError, match="at least one device"):
        dist.make_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert dist.make_mesh() == (torch.device("cuda", 0),
                                torch.device("cuda", 1))
    with pytest.raises(ValueError, match="more than the 2 CUDA devices"):
        dist.make_mesh(3)
    with pytest.raises(ValueError, match="give no group= or device="):
        dist.compress_fl(np.zeros(5, np.uint8), mesh=(CPU,), device=CPU)


def test_decode_walks_write_into_out():
    """``out=`` of the FL and RL decode walks: the bytes land in the
    caller's array, and an array of another size is refused."""
    data, L = FL["mixed"]
    bits, values = fl_numpy.encode(data, L)
    widths, voffs = fl_torch.container_layout(data.size, bits, values.size,
                                              L)
    out = np.zeros(data.size, np.uint8)
    assert fl_torch.decode_walk(data.size, widths, values, voffs, L, CPU,
                                out=out) is out
    _eq(out, data)
    with pytest.raises(ValueError, match="out must be"):
        fl_torch.decode_walk(data.size, widths, values, voffs, L, CPU,
                             out=out[1:])
    counts, rvalues = rl_numpy.encode(RL["runs"])
    out = np.zeros(RL["runs"].size, np.uint8)
    assert rl_torch.decode_walk(counts, rvalues, CPU, out=out) is out
    _eq(out, RL["runs"])
    with pytest.raises(ValueError, match="out must be"):
        rl_torch.decode_walk(counts, rvalues, CPU, out=out[1:])


@pytest.mark.parametrize("method", ["fl-ici", "fl-dist", "rl-dist"])
def test_card_threads_spans_reach_the_trace(method, monkeypatch):
    """Under a CPU profiler, a mesh's per-card threads hold the calling
    thread's profiler state, so that their stages' spans reach the trace
    beside the calling thread's (fl-ici's gather among them), all inside
    the caller's range; the containers are unchanged."""
    import torch_spans
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    data, _ = FL["mixed"]
    with torch_spans.spans() as got:
        comp = flrl.compress(data, method=method, devices=3)
        out = flrl.decompress(comp, method=method, devices=3)
    _eq(out, data)
    names = torch_spans.check(got)
    caller = next(r.thread for r in got if r.name == "outer")
    cards = {r.thread for r in got if r.thread != caller}
    # three card threads at once (the profiler may give a later call's
    # threads the ids of an earlier call's, which have ended)
    assert len(cards) >= 3
    assert {r.name for r in got if r.thread in cards} >= {
        "flrl.h2d.pinned" if method != "rl-dist" else "flrl.h2d.pageable",
        "flrl.kernels"}
    if method == "fl-ici":
        assert {"flrl.gather.d2h", "flrl.host.join"} <= names


def _round_trip_without_card_spans(monkeypatch):
    """A profiled fl-ici round trip on a three-card CPU mesh: unchanged,
    with only the calling thread's spans in the trace."""
    import torch_spans
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    data, _ = FL["mixed"]
    with torch_spans.spans() as got:
        comp = flrl.compress(data, method="fl-ici", devices=3)
    _eq(flrl.decompress(comp, method="fl-ici", devices=3), data)
    caller = next(r.thread for r in got if r.name == "outer")
    assert {r.thread for r in got} == {caller}
    assert "flrl.gather.d2h" in torch_spans.check(got)


def test_card_threads_without_the_state_library(monkeypatch):
    """Where the thread-state library cannot be had, the card threads'
    spans stay out of the trace and nothing else changes."""
    from fl_rl_compression_mpi_tpu_torch.utils import thread_state
    monkeypatch.setattr(thread_state, "_lib", lambda: None)
    _round_trip_without_card_spans(monkeypatch)


def test_card_threads_without_the_state_source(tmp_path, monkeypatch):
    """An installed package without ``csrc/thread_state.cpp`` and without
    its built library: a profiled mesh round trip still succeeds, with a
    warning and without the card threads' spans."""
    import functools
    from fl_rl_compression_mpi_tpu_torch import native
    from fl_rl_compression_mpi_tpu_torch.utils import thread_state
    monkeypatch.setattr(thread_state, "_SRC_PATH",
                        str(tmp_path / "csrc" / "thread_state.cpp"))
    monkeypatch.setattr(thread_state, "_SO_PATH",
                        str(tmp_path / "_build" / "libstate.so"))
    monkeypatch.setattr(thread_state, "_lib",
                        functools.cache(thread_state._lib.__wrapped__))
    assert thread_state.build()               # nothing to build from
    assert not (tmp_path / "_build").exists()
    with pytest.warns(UserWarning, match="stay out of the profiler"):
        _round_trip_without_card_spans(monkeypatch)
    assert native._LOADED.pop(thread_state._SO_PATH) is None
