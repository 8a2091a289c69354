"""CLI and library API of the PyTorch package (on the CPU: the registry's
device default is patched, since ``fl`` runs only on a CUDA device)."""

import glob
import json
import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

import fl_rl_compression_mpi_tpu_torch as flrl
from fl_rl_compression_mpi_tpu import api as jax_api
from fl_rl_compression_mpi_tpu import container
from fl_rl_compression_mpi_tpu.models import registry as jax_registry
from fl_rl_compression_mpi_tpu.cli import main as jax_main
from fl_rl_compression_mpi_tpu.ops import fl_numpy, rl_numpy
from fl_rl_compression_mpi_tpu_torch.cli import main
from fl_rl_compression_mpi_tpu_torch.models import registry
from fl_rl_compression_mpi_tpu_torch.utils.timers import set_stage_timers

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference")
GOLDEN_RL = os.path.join(os.path.dirname(__file__), "golden", "input")
GOLDEN_BINS = sorted(glob.glob(os.path.join(GOLDEN, "case_*.bin")))


@pytest.fixture(autouse=True)
def _stage_timers_off():
    """A ``--timers`` run leaves the stage timers on for the process; turn
    them off after each test so no later test inherits them."""
    yield
    set_stage_timers(False)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(registry, "default_device",
                        lambda: torch.device("cpu"))


@pytest.mark.parametrize("src", GOLDEN_BINS,
                         ids=[os.path.basename(p) for p in GOLDEN_BINS])
def test_goldens_roundtrip_through_cli(src, tmp_path, on_cpu, capsys):
    comp = str(tmp_path / "o.fl")
    back = str(tmp_path / "o.bin")
    assert main(["c", "fl", src, comp, "--verify"]) == 0
    assert "verification OK" in capsys.readouterr().err
    with open(comp, "rb") as a, open(src[:-4] + ".fl", "rb") as b:
        assert a.read() == b.read()
    assert main(["d", "fl", src[:-4] + ".fl", back]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8),
                                  np.fromfile(src, np.uint8))


@pytest.fixture
def blob(tmp_path):
    data = np.random.default_rng(0).integers(0, 32, 128 * 300 + 55, np.uint8)
    p = str(tmp_path / "in.bin")
    data.tofile(p)
    return p, data


@pytest.mark.parametrize("method", ["fl", "fl-cpu"])
@pytest.mark.parametrize("L", [64, 128])
def test_roundtrip_methods_and_frame_lengths(method, L, blob, tmp_path,
                                             on_cpu):
    src, data = blob
    comp, back = str(tmp_path / "o.fl"), str(tmp_path / "o.bin")
    assert main(["c", method, src, comp, "--frame-length", str(L),
                 "--verify"]) == 0
    # every FL method reads every other's container
    other = "fl-cpu" if method == "fl" else "fl"
    assert main(["d", other, comp, back, "--frame-length", str(L)]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)


@pytest.mark.parametrize("method", ["fl-dist", "fl-ici", "fl-mpi",
                                    "fl-nccl", "fl-shmem", "rl-dist"])
def test_methods_not_ported_exit_2(method, blob, tmp_path, capsys, on_cpu):
    """The distributed methods and their aliases, which the CLI refused
    with exit 2 until they were ported, now run (one gloo rank on the CPU
    here): exit 0, a verified round trip, the JAX CLI's container."""
    src, data = blob
    ours, theirs = str(tmp_path / "torch.c"), str(tmp_path / "jax.c")
    back = str(tmp_path / "o.bin")
    assert main(["c", method, src, ours, "--verify"]) == 0
    err = capsys.readouterr().err
    assert "verification OK" in err and "[ERROR]" not in err
    assert ("[INFO] fl-shmem:" in err) == (method == "fl-shmem")
    assert main(["d", method, ours, back, "--devices", "1"]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    assert jax_main(["c", method, src, theirs, "--devices", "1"]) == 0
    assert _same_file(ours, theirs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flag", ["--coordinator", "--num-processes",
                                  "--process-id", "--profile",
                                  "--stream-chunk-mb"])
def test_flags_ported_now_run(flag, blob, tmp_path, capsys, on_cpu,
                              monkeypatch):
    """The flags the CLI refused with exit 2 until they were ported now
    run: ``--coordinator`` (one process, a TCP rendezvous; the
    multi-process cases are in test_torch_multihost.py) and ``--profile``
    (a trace that parses as JSON), ``--stream-chunk-mb`` (the streamed
    encode and its streamed verify; the stream cases are in
    test_torch_stream.py); ``--num-processes`` and ``--process-id``
    without ``--coordinator`` are ignored, as in the JAX CLI.  The
    container is fl_numpy's either way."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    src, data = blob
    out = str(tmp_path / "o.fl")
    logdir = str(tmp_path / "trace")
    extra = {"--coordinator": ["--coordinator", f"127.0.0.1:{_free_port()}",
                               "--num-processes", "1", "--process-id", "0"],
             "--num-processes": ["--num-processes", "2"],
             "--process-id": ["--process-id", "1"],
             "--profile": ["--profile", logdir],
             "--stream-chunk-mb": ["--stream-chunk-mb", "0"]}[flag]
    try:
        assert main(["c", "fl", src, out, "--verify", *extra]) == 0
    finally:
        if flag == "--coordinator" and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert "verification OK" in capsys.readouterr().err
    comp = flrl.load_fl(out)
    bits, values = fl_numpy.encode(data)
    np.testing.assert_array_equal(comp.bits, bits)
    np.testing.assert_array_equal(comp.values, values)
    traces = glob.glob(os.path.join(logdir, "*.json"))
    assert len(traces) == (1 if flag == "--profile" else 0)
    for path in traces:
        with open(path) as f:
            assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("method", ["fl-dist", "fl-ici", "rl-dist"])
def test_devices_beyond_the_count_exit_nonzero(method, blob, tmp_path,
                                              capsys, monkeypatch):
    """More ranks than cards is an error (one card here, faked), as is
    fewer than one rank; neither starts any rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(registry, "default_device",
                        lambda: torch.device("cuda", 0))
    src, _ = blob
    assert main(["c", method, src, str(tmp_path / "x"), "--devices",
                 "2"]) == 1
    assert "more than the 1 CUDA devices" in capsys.readouterr().err
    assert main(["c", method, src, str(tmp_path / "x"), "--devices",
                 "0"]) == 2
    assert "--devices must be at least 1" in capsys.readouterr().err


@pytest.mark.parametrize("method", ["fl-dist", "rl-dist"])
def test_two_spawned_ranks_through_the_cli(method, blob, tmp_path, on_cpu,
                                           capsys, monkeypatch):
    """``--devices 2`` on the CPU: two shards driven from this one process
    for c and d, with no child process and no process group; the container
    equals the JAX CLI's at two devices."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CLI started a process")

    monkeypatch.setattr(torch.multiprocessing, "start_processes", refuse)
    src, data = blob
    ours, theirs = str(tmp_path / "torch.c"), str(tmp_path / "jax.c")
    back = str(tmp_path / "o.bin")
    assert main(["c", method, src, ours, "--devices", "2"]) == 0
    assert main(["d", method, ours, back, "--devices", "2"]) == 0
    assert multiprocessing.active_children() == []
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    assert jax_main(["c", method, src, theirs, "--devices", "2"]) == 0
    assert _same_file(ours, theirs)


def test_no_cuda_device_is_an_error(blob, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, _ = blob
    assert main(["c", "fl", src, str(tmp_path / "x")]) == 1
    assert "[ERROR] no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.default_device()


def test_bad_frame_length_and_missing_input(blob, tmp_path, on_cpu):
    src, _ = blob
    assert main(["c", "fl", src, str(tmp_path / "x"),
                 "--frame-length", "100"]) == 2
    assert main(["c", "fl", str(tmp_path / "nope.bin"),
                 str(tmp_path / "x")]) == 1


def test_timers_print_stage_lines_and_launches(blob, tmp_path, on_cpu,
                                               capsys):
    src, _ = blob
    comp = str(tmp_path / "o.fl")
    assert main(["c", "fl", src, comp, "--timers"]) == 0
    cap = capsys.readouterr()
    for line in ("[TIMER] loading input", "[TIMER] Copy input data to device",
                 "[TIMER] Compression:", "[TIMER] Copy results to CPU:",
                 "[TIMER] compression:"):
        assert line in cap.out
    assert "[INFO] kernel launches" in cap.err
    assert main(["d", "fl", comp, str(tmp_path / "o.bin"), "--timers"]) == 0
    assert "[TIMER] Decompression:" in capsys.readouterr().out
    # the switch must not leak into runs without --timers
    assert main(["c", "fl", src, comp]) == 0
    assert "[TIMER]" not in capsys.readouterr().out


@pytest.mark.parametrize("L", [64, 128])
def test_field_route_through_cli(L, blob, tmp_path, on_cpu, monkeypatch,
                                 capsys):
    """FLRL_NO_DENSE=1: containers equal the JAX CLI's, the field route's
    stages and launch counters show in --timers, and d fl round-trips."""
    monkeypatch.setenv("FLRL_NO_DENSE", "1")
    src, data = blob
    ours, theirs = str(tmp_path / "torch.fl"), str(tmp_path / "jax.fl")
    back = str(tmp_path / "o.bin")
    flag = ["--frame-length", str(L)]
    assert main(["c", "fl", src, ours, "--timers", "--verify", *flag]) == 0
    cap = capsys.readouterr()
    for line in ("[TIMER] Compression:", "[TIMER] Copy results to CPU:",
                 "[TIMER] Host fold (ragged placement):",
                 "[TIMER] Host unfold (ragged placement):"):
        assert line in cap.out
    assert '"fl_fields_encode_p2"' in cap.err and "verification OK" in cap.err
    assert jax_main(["c", "fl", src, theirs, *flag]) == 0
    assert _same_file(ours, theirs)
    assert main(["d", "fl", theirs, back, "--timers", *flag]) == 0
    assert "[TIMER] Host unfold (ragged placement):" in capsys.readouterr().out
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)


def test_library_api(tmp_path, on_cpu):
    data = np.random.default_rng(9).integers(0, 32, 128 * 64 + 9, np.uint8)
    # the JAX package's table: the same names, the aliases and the host
    # codecs described alike; a device method names its own device
    theirs = jax_api.methods()
    ours = flrl.methods()
    assert list(ours) == list(theirs)
    assert {"fl-mpi", "fl-nccl"} <= set(ours)
    for name, text in ours.items():
        if name.endswith("-cpu") or name in jax_registry.ALIASES:
            assert text == theirs[name], name
        else:
            assert text.split()[0] == theirs[name].split()[0], name
            assert "TPU" not in text and "CUDA" in text, name
    for method in ("fl", "fl-cpu"):
        comp = flrl.compress(data.tobytes(), method=method)
        np.testing.assert_array_equal(flrl.decompress(comp, method=method),
                                      data)
        src, dst, back = (str(tmp_path / f"{method}.{s}")
                          for s in ("bin", "fl", "out"))
        data.tofile(src)
        flrl.compress_file(src, dst, method=method)
        flrl.decompress_file(dst, back, method=method)
        np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    # an explicit device overrides the default
    comp = flrl.compress(data, method="fl", device="cpu", frame_length=64)
    np.testing.assert_array_equal(
        flrl.decompress(comp, method="fl", device="cpu", frame_length=64),
        data)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("method", ["rl", "rl-cpu"])
def test_rl_golden_through_cli(method, tmp_path, on_cpu, capsys):
    comp, back = str(tmp_path / "o.rl"), str(tmp_path / "o.bin")
    assert main(["c", method, GOLDEN_RL + ".bin", comp, "--verify"]) == 0
    assert "verification OK" in capsys.readouterr().err
    assert _same_file(comp, GOLDEN_RL + ".rl")
    assert main(["d", method, GOLDEN_RL + ".rl", back]) == 0
    assert _same_file(back, GOLDEN_RL + ".bin")


@pytest.mark.parametrize("method", ["rl", "rl-cpu"])
def test_rl_roundtrip_ignores_frame_length(method, blob, tmp_path, on_cpu):
    src, data = blob
    comp, back = str(tmp_path / "o.rl"), str(tmp_path / "o.bin")
    assert main(["c", method, src, comp, "--frame-length", "64",
                 "--verify"]) == 0
    other = "rl-cpu" if method == "rl" else "rl"
    assert main(["d", other, comp, back, "--frame-length", "64"]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    ref = container.RLCompressed(*rl_numpy.encode(data), data.size)
    container.save_rl(str(tmp_path / "ref.rl"), ref)
    assert _same_file(comp, str(tmp_path / "ref.rl"))


def test_rl_containers_cross_with_the_jax_cli(blob, tmp_path, on_cpu):
    src, data = blob
    ours, theirs = str(tmp_path / "torch.rl"), str(tmp_path / "jax.rl")
    assert main(["c", "rl", src, ours]) == 0
    assert jax_main(["c", "rl", src, theirs]) == 0
    assert _same_file(ours, theirs)
    back = str(tmp_path / "b1.bin")
    assert jax_main(["d", "rl-cpu", ours, back]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
    back = str(tmp_path / "b2.bin")
    assert main(["d", "rl", theirs, back]) == 0
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)


def test_rl_timers_print_stages_and_rl_launches(blob, tmp_path, on_cpu,
                                                capsys):
    src, _ = blob
    comp = str(tmp_path / "o.rl")
    assert main(["c", "rl", src, comp, "--timers"]) == 0
    cap = capsys.readouterr()
    for line in ("[TIMER] Copy input data to device", "[TIMER] Compression:",
                 "[TIMER] Copy results to CPU:"):
        assert line in cap.out
    assert "[INFO] compressed" in cap.err and '"rl_expand"' in cap.err
    assert main(["d", "rl", comp, str(tmp_path / "o.bin"), "--timers"]) == 0
    assert "[TIMER] Decompression:" in capsys.readouterr().out


@pytest.mark.parametrize("method", ["rl", "rl-cpu"])
def test_api_files_use_the_rl_container(method, tmp_path, on_cpu):
    """compress_file/decompress_file pick the container by the codec's
    family: an RL method writes and reads RL containers."""
    data = np.random.default_rng(4).integers(0, 3, 9000, np.uint8)
    src, dst, back = (str(tmp_path / s) for s in ("in.bin", "o.rl", "o.out"))
    data.tofile(src)
    flrl.compress_file(src, dst, method=method)
    comp = container.load_rl(dst)
    np.testing.assert_array_equal(comp.counts, rl_numpy.encode(data)[0])
    assert comp.input_size == data.size
    flrl.decompress_file(dst, back, method=method)
    np.testing.assert_array_equal(np.fromfile(back, np.uint8), data)
