"""``parallel/multihost.py`` of the PyTorch package on gloo (the CPU),
held against the JAX package's ``parallel.multihost`` and the NumPy
codecs.  Tolerance: byte equality throughout.

* one process, no group: the four file functions, the verify and the
  synthetic codec against the JAX module's single-process forms;
* two and three gloo ranks, one spawn a world size, every case inside it
  (``torch_multihost_cases.run_cases``, spawned by ``dist.spawn_group``):
  the cases of
  ``tests/test_multihost_2proc.py``.  FL containers equal ``fl_numpy``'s
  (they do not depend on P); RL containers equal the concatenation of
  ``rl_numpy``'s over the JAX package's ``fileio.load_file_sharded``
  shards, which is what the JAX module computes with one chip a process;
* the CLI in processes of its own, under ``torchrun`` (``env://``) and
  with a TCP rendezvous (``HOST:PORT``);
* ``dist.run_collective`` calls with no default group, which make no
  process group (one shard, and a two-shard mesh in this process)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multihost_cases as cases
from fl_rl_compression_mpi_tpu import fileio as jfileio
from fl_rl_compression_mpi_tpu.ops import fl_numpy, rl_numpy
from fl_rl_compression_mpi_tpu.parallel import dist as jdist
from fl_rl_compression_mpi_tpu.parallel import multihost as jmh
from fl_rl_compression_mpi_tpu_torch import container
from fl_rl_compression_mpi_tpu_torch.cli import main
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.parallel import dist
from fl_rl_compression_mpi_tpu_torch.parallel import multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_cli_runner.py")
CPU = torch.device("cpu")
WORLDS = (2, 3)
FL = cases.fl_inputs()
RL = cases.rl_inputs()
SUBPROCESS_S = 120
_RESULTS: dict = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("multihost"))
    cases.write_inputs(path)
    return path


def results(root: str, world: int) -> dict:
    """Rank 0's results of every case at ``world`` ranks, computed once."""
    if world not in _RESULTS:
        _RESULTS[world] = dist.spawn_group(cases.run_cases, root,
                                           world=world, device=CPU)
    return _RESULTS[world]


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _fl_container(data: np.ndarray, L: int) -> bytes:
    bits, values = fl_numpy.encode(data, L)
    return (container._HEADER.pack(data.size, bits.size, values.size)
            + bits.tobytes() + values.tobytes())


def _rl_sharded_container(path: str, world: int) -> bytes:
    """rl_numpy's containers of the JAX package's sharded loads,
    concatenated."""
    parts = [rl_numpy.encode(jfileio.load_file_sharded(path, i, world)[0])
             for i in range(world)]
    counts = np.concatenate([c for c, _ in parts])
    values = np.concatenate([v for _, v in parts])
    return (container._HEADER.pack(os.path.getsize(path), counts.size,
                                   values.size)
            + counts.tobytes() + values.tobytes())


@pytest.fixture
def no_group():
    assert not torch.distributed.is_initialized()


@pytest.fixture
def one_chip_jax(monkeypatch):
    """The JAX module's process on one chip, as a process here owns one
    card (its RL container depends on its local chips)."""
    monkeypatch.setattr(jdist, "make_local_mesh", lambda: jdist.make_mesh(1))


# ---------------------------------------------------------------------------
# One process, no group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FL))
def test_one_process_fl_files_equal_jax(name, root, tmp_path, no_group):
    data, L = FL[name]
    src = os.path.join(root, f"{name}.fl.bin")
    ours, theirs = str(tmp_path / "torch.fl"), str(tmp_path / "jax.fl")
    mh.compress_fl_file(src, ours, L, device=CPU)
    jmh.compress_fl_file(src, theirs, L, bucket_frames=16)
    assert _bytes(ours) == _bytes(theirs) == _fl_container(data, L)
    for dec, path in ((mh.decompress_fl_file, "torch.out"),
                      (jmh.decompress_fl_file, "jax.out")):
        kw = {"device": CPU} if dec is mh.decompress_fl_file else {}
        dec(ours, str(tmp_path / path), L, **kw)
        assert _bytes(str(tmp_path / path)) == data.tobytes()


@pytest.mark.parametrize("name", list(RL))
def test_one_process_rl_files_equal_jax(name, root, tmp_path, no_group,
                                        one_chip_jax):
    data = RL[name]
    src = os.path.join(root, f"{name}.rl.bin")
    ours, theirs = str(tmp_path / "torch.rl"), str(tmp_path / "jax.rl")
    mh.compress_rl_file(src, ours, device=CPU)
    jmh.compress_rl_file(src, theirs, bucket_frames=16)
    assert _bytes(ours) == _bytes(theirs) == _rl_sharded_container(src, 1)
    mh.decompress_rl_file(theirs, str(tmp_path / "torch.out"), device=CPU)
    jmh.decompress_rl_file(ours, str(tmp_path / "jax.out"))
    for path in ("torch.out", "jax.out"):
        assert _bytes(str(tmp_path / path)) == data.tobytes()


def test_one_process_verify_and_synth_codec(root, tmp_path, no_group,
                                            monkeypatch, capsys):
    data, _ = FL["mixed"]
    src = os.path.join(root, "mixed.fl.bin")
    good, bad = str(tmp_path / "good.fl"), str(tmp_path / "bad.fl")
    mh.compress_fl_file(src, good, device=CPU)
    cases._flip_payload_byte(good, bad)
    assert mh.verify_file_roundtrip(src, good, "fl", device=CPU)
    assert not mh.verify_file_roundtrip(src, bad, "fl", device=CPU)
    assert not os.path.exists(bad + ".verify.tmp")
    # the synthetic codec: the JAX module's width-8 identity container,
    # and a warning on stderr
    monkeypatch.setenv("FLRL_SYNTH_CODEC", "1")
    ours, theirs = str(tmp_path / "synth.fl"), str(tmp_path / "jsynth.fl")
    capsys.readouterr()
    mh.compress_fl_file(src, ours, device=CPU)
    assert "FLRL_SYNTH_CODEC=1" in capsys.readouterr().err
    jmh.compress_fl_file(src, theirs)
    assert _bytes(ours) == _bytes(theirs)
    comp = container.load_fl(ours)
    assert comp.bits.min() == comp.bits.max() == 8
    np.testing.assert_array_equal(comp.values, data)
    monkeypatch.delenv("FLRL_SYNTH_CODEC")
    mh.decompress_fl_file(ours, str(tmp_path / "synth.out"), device=CPU)
    assert _bytes(str(tmp_path / "synth.out")) == data.tobytes()


def test_init_distributed_without_an_address_is_a_noop(no_group):
    mh.init_distributed(None, device=CPU)
    assert not torch.distributed.is_initialized()


def test_process_layout_and_device(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--num-processes"):
        mh.process_layout(2, None)
    assert mh.process_layout(3, 2) == (3, 2)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert mh.process_layout() == (4, 1)
    assert mh.process_layout(None, 3) == (4, 3)
    with pytest.raises(ValueError, match="not in 0..3"):
        mh.process_layout(None, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mh.local_device(3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert mh.local_device(3) == torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# Two and three gloo ranks
# ---------------------------------------------------------------------------

FL_IDS = [(w, name) for w in WORLDS for name in FL]
RL_IDS = [(w, name) for w in WORLDS for name in RL]


@pytest.mark.parametrize("world,name", FL_IDS,
                         ids=[f"w{w}-{n}" for w, n in FL_IDS])
def test_fl_files_merged_to_rank0(world, name, root):
    """compress_fl_file and decompress_fl_file with 4096-byte rounds: the
    container is the single-process one (fl_numpy's), the round trip
    exact."""
    results(root, world)
    data, L = FL[name]
    out = os.path.join(root, f"w{world}", f"{name}.fl")
    assert _bytes(out) == _fl_container(data, L)
    assert _bytes(out + ".out") == data.tobytes()


@pytest.mark.parametrize("world,name", RL_IDS,
                         ids=[f"w{w}-{n}" for w, n in RL_IDS])
def test_rl_files_merged_to_rank0(world, name, root):
    results(root, world)
    src = os.path.join(root, f"{name}.rl.bin")
    out = os.path.join(root, f"w{world}", f"{name}.rl")
    assert _bytes(out) == _rl_sharded_container(src, world)
    assert _bytes(out + ".out") == RL[name].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_verify_agrees_on_every_rank(world, root):
    """True on the good container, False on a flipped payload byte, on
    every rank."""
    assert results(root, world)["verify"] == [(True, False)] * world


@pytest.mark.parametrize("world", WORLDS)
def test_merge_rounds_are_bounded(world, root):
    """No rank sends, and rank 0 receives from no rank, more than the
    round's bytes in a round, both directions; the round trip is exact."""
    peaks = results(root, world)["bounded"]
    assert peaks[0]["send"] == 0 and 0 < peaks[0]["recv"] <= cases.CHUNK
    for peak in peaks[1:]:
        assert 0 < peak["send"] <= cases.CHUNK and peak["recv"] == 0
    data = cases.bounded_input()
    out = os.path.join(root, f"w{world}", "bounded.fl")
    assert _bytes(out) == _fl_container(data, 128)
    assert _bytes(out + ".out") == data.tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_shared_fs_writes_equal_the_merge(world, root):
    results(root, world)
    out = os.path.join(root, f"w{world}")
    for merged, direct, data in (("mixed.fl", "mixed.sfs.fl", FL["mixed"][0]),
                                 ("runs.rl", "runs.sfs.rl", RL["runs"])):
        assert _bytes(os.path.join(out, direct)) == _bytes(
            os.path.join(out, merged))
        assert _bytes(os.path.join(out, direct + ".out")) == data.tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_round_trip_waits_for_slow_rank0_writes(world, root):
    """Rank 0's writes each sleep 0.1 s; every rank reads the container
    at once, and the completion barrier keeps the round trip exact."""
    results(root, world)
    out = os.path.join(root, f"w{world}")
    assert _bytes(os.path.join(out, "slow.rl")) == _bytes(
        os.path.join(out, "runs.rl"))
    assert _bytes(os.path.join(out, "slow.rl.out")) == RL["runs"].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_synth_codec_container_and_warning(world, root):
    warnings = results(root, world)["synth"]
    assert all("FLRL_SYNTH_CODEC=1" in w for w in warnings)
    comp = container.load_fl(os.path.join(root, f"w{world}",
                                          "mixed.synth.fl"))
    assert comp.bits.min() == comp.bits.max() == 8
    np.testing.assert_array_equal(comp.values, FL["mixed"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_field_route_under_no_dense(world, root):
    results(root, world)
    out = os.path.join(root, f"w{world}")
    assert _bytes(os.path.join(out, "mixed.fields.fl")) == _bytes(
        os.path.join(out, "mixed.fl"))
    assert _bytes(os.path.join(out, "mixed.fields.fl.out")) == (
        FL["mixed"][0].tobytes())


CORRUPT = {"fl-widths": "widths array shorter than frame count",
           "fl-payload": "packed stream shorter than the widths imply",
           "fl-width-byte": "width byte outside 1..8",
           "rl-sizes": "counts/values size mismatch",
           "rl-sum": "header claims"}
CORRUPT_IDS = [(w, name) for w in WORLDS for name in CORRUPT]


@pytest.mark.parametrize("world,name", CORRUPT_IDS,
                         ids=[f"w{w}-{n}" for w, n in CORRUPT_IDS])
def test_corrupt_containers_raise_on_every_rank(world, name, root):
    errors = results(root, world)["corrupt"][name]
    assert len(set(errors)) == 1 and CORRUPT[name] in errors[0], errors


# ---------------------------------------------------------------------------
# The CLI in processes of its own
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "FLRL_SHARED_FS", "FLRL_DCN_CHUNK_MB"):
        env.pop(key, None)
    return env


def _torchrun(*argv: str) -> None:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", RUNNER, *argv]
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=SUBPROCESS_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def _tcp(*argv: str, attempts: int = 3) -> None:
    """Two processes with a TCP rendezvous on a free port (retried with
    another port: a probed free port can be taken before rank 0 binds
    it)."""
    for attempt in range(attempts):
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, RUNNER, *argv, "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
             str(i)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        try:
            outs = [p.communicate(timeout=SUBPROCESS_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return
        if attempt == attempts - 1:
            raise AssertionError("\n".join(o[-2000:] for o in outs))


def test_cli_under_torchrun(root, tmp_path):
    """``torchrun --nproc-per-node 2`` runs ``c fl-dist --coordinator
    env:// --verify`` and then ``d``: the container is fl_numpy's, the
    output the input."""
    data, _ = FL["mixed"]
    src = os.path.join(root, "mixed.fl.bin")
    comp, back = str(tmp_path / "o.fl"), str(tmp_path / "o.bin")
    proc = _torchrun("c", "fl-dist", src, comp, "--coordinator", "env://",
                     "--verify", "--timers")
    assert proc.stderr.count("[INFO] verification OK") == 2
    assert "process=1/2 backend=gloo" in proc.stderr
    assert "[Rank 1] Loaded" in proc.stdout
    assert _bytes(comp) == _fl_container(data, 128)
    _torchrun("d", "fl-dist", comp, back, "--coordinator", "env://")
    assert _bytes(back) == data.tobytes()


def test_cli_with_a_tcp_rendezvous(root, tmp_path):
    """Two processes, ``--coordinator 127.0.0.1:<port> --num-processes 2
    --process-id i``: ``c rl-dist --verify`` writes the per-shard RL
    container, ``d`` restores the input."""
    src = os.path.join(root, "runs.rl.bin")
    comp, back = str(tmp_path / "o.rl"), str(tmp_path / "o.bin")
    _tcp("c", "rl-dist", src, comp, "--verify")
    assert _bytes(comp) == _rl_sharded_container(src, 2)
    _tcp("d", "rl-dist", comp, back)
    assert _bytes(back) == RL["runs"].tobytes()


def test_cli_coordinator_needs_the_process_layout(root, tmp_path,
                                                  monkeypatch, capsys):
    monkeypatch.setattr(registry, "default_device", lambda: CPU)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    src = os.path.join(root, "mixed.fl.bin")
    assert main(["c", "fl-dist", src, str(tmp_path / "x"), "--coordinator",
                 "127.0.0.1:1", "--num-processes", "2"]) == 2
    assert "--process-id" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# One-rank calls make no process group
# ---------------------------------------------------------------------------

def test_one_rank_group_is_made_once(monkeypatch, no_group):
    """World-1 calls never call init_process_group and leave no default
    group; a two-shard mesh after them, in this process, makes none either
    and still gives fl-cpu's bytes."""
    made = []
    init = torch.distributed.init_process_group

    def counting(*args, **kwargs):
        made.append(kwargs.get("world_size"))
        return init(*args, **kwargs)

    monkeypatch.setattr(torch.distributed, "init_process_group", counting)
    data, _ = FL["mixed"]
    want = fl_numpy.encode(data)
    for fn in (dist.compress_fl, dist.compress_fl_ici, dist.compress_fl):
        comp = dist.run_collective(fn, data, devices=1, device=CPU)
        np.testing.assert_array_equal(comp.bits, want[0])
        np.testing.assert_array_equal(comp.values, want[1])
        assert not torch.distributed.is_initialized()
    assert made == []
    comp = dist.run_collective(dist.compress_fl, data, devices=2, device=CPU)
    np.testing.assert_array_equal(comp.bits, want[0])
    np.testing.assert_array_equal(comp.values, want[1])
    assert not torch.distributed.is_initialized()
    assert made == []


def test_callers_group_is_used_and_survives(no_group):
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), world_size=1, rank=0)
    try:
        group = torch.distributed.group.WORLD
        data, _ = FL["mixed"]
        comp = dist.run_collective(dist.compress_fl, data, devices=1,
                                   device=CPU)
        np.testing.assert_array_equal(comp.values, fl_numpy.encode(data)[1])
        assert torch.distributed.group.WORLD is group
        dist.release_kept_group()
        assert torch.distributed.is_initialized()
        assert torch.distributed.group.WORLD is group
    finally:
        torch.distributed.destroy_process_group()


def test_caller_makes_its_group_after_release(no_group):
    """Right after a world-1 call, with no release, a caller makes its own
    default group, which the next call then uses."""
    data, _ = FL["mixed"]
    dist.run_collective(dist.compress_fl, data, devices=1, device=CPU)
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.HashStore(), world_size=1, rank=0)
    try:
        group = torch.distributed.group.WORLD
        comp = dist.run_collective(dist.compress_fl, data, devices=1,
                                   device=CPU)
        np.testing.assert_array_equal(comp.values, fl_numpy.encode(data)[1])
        assert torch.distributed.group.WORLD is group
    finally:
        torch.distributed.destroy_process_group()


def test_process_with_a_kept_group_exits(tmp_path):
    """A process that made two world-1 calls exits 0 and holds no
    group."""
    script = tmp_path / "kept.py"
    script.write_text(
        "import numpy as np, torch\n"
        "from fl_rl_compression_mpi_tpu_torch.parallel import dist\n"
        "x = np.arange(5000, dtype=np.uint8)\n"
        "for _ in range(2):\n"
        "    dist.run_collective(dist.compress_fl, x, devices=1,\n"
        "                        device=torch.device('cpu'))\n"
        "print('initialized', torch.distributed.is_initialized())\n")
    proc = subprocess.run([sys.executable, str(script)], env=_env(),
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "initialized False" in proc.stdout


def test_no_jax_in_the_rank_side_modules():
    """Spawned ranks and the CLI runner import these modules; neither JAX
    nor the JAX package may come with them."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None; "
         "sys.path.insert(0, 'tests'); "
         "import torch_multihost_cases, torch_cli_runner; "
         "bad = [m for m in sys.modules if m == 'fl_rl_compression_mpi_tpu'"
         " or m.startswith('fl_rl_compression_mpi_tpu.')]; "
         "sys.exit(1 if bad else 0)"],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=SUBPROCESS_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
