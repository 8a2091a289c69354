"""Command-line interface of the PyTorch package.

The same surface as ``python -m fl_rl_compression_mpi_tpu``:
``c|d <method> <input> <output>`` with ``--frame-length``, ``--timers``,
``--verify``, ``--devices`` and ``--profile``.  Methods: ``fl`` and ``rl``
(one CUDA device); ``fl-dist``, ``fl-ici`` and ``rl-dist`` (``--devices N``
cards, by default every card, all driven from this one process, a host
thread a card: no process is started and no process group made; see
``parallel/dist.py``); ``fl-cpu`` and ``rl-cpu`` (host).  ``fl-mpi`` and
``fl-nccl`` are aliases of ``fl-dist`` and ``fl-ici``; ``fl-shmem`` (an
enum value with no implementation in the reference) maps to ``fl-dist``
with a notice, as in the JAX CLI.  RL methods accept ``--frame-length`` and
ignore it, as the JAX CLI does.

Multi-process runs (one process a card, on one machine or several):
every process runs this same CLI with ``--coordinator``, and rank 0 writes
the output (``parallel/multihost.py``):

    torchrun --nproc-per-node 4 -m fl_rl_compression_mpi_tpu_torch \
        c fl-dist in.bin out.fl --coordinator env://
    python -m fl_rl_compression_mpi_tpu_torch c fl in.bin out.fl \
        --coordinator HOST:PORT --num-processes 2 --process-id 0

The method's family picks the FL or the RL file functions, whatever the
method; ``--devices`` is ignored there.

``--stream-chunk-mb N`` compresses or decompresses an FL container in
chunks of N MiB with bounded host memory (``stream.py``), on the default
device whatever the FL method; ``--verify`` then round-trips through a
streamed decode.  RL methods refuse it with exit code 2, as the JAX CLI
does; ``--coordinator`` takes precedence over it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .api import load_container, save_container
from .fileio import load_file, save_file
from .models import registry
from .models.registry import resolve
from .ops.bitpack import FRAME_LENGTH
from .utils.timers import profiler_trace, set_stage_timers, timed

_METHODS = ("fl", "fl-cpu", "fl-dist", "fl-ici", "rl", "rl-cpu", "rl-dist",
            "fl-mpi", "fl-nccl", "fl-shmem")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fl_rl_compression_mpi_tpu_torch",
        description="FL/RL lossless compression on a CUDA device "
                    "(PyTorch)",
        epilog="example: python -m fl_rl_compression_mpi_tpu_torch c fl "
               "in.bin out.fl")
    p.add_argument("operation", choices=("c", "d"),
                   help="c = compress, d = decompress")
    p.add_argument("method", choices=_METHODS)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--frame-length", type=int, default=FRAME_LENGTH,
                   help="FL frame length in bytes (default 128; a positive "
                        "multiple of 8; ignored by RL)")
    p.add_argument("--timers", action="store_true",
                   help="print [TIMER] phase lines, and one a stage of the "
                        "codec's walk; a device stage is timed by CUDA "
                        "events on its stream, so the lines do not "
                        "serialise the walk")
    p.add_argument("--verify", action="store_true",
                   help="after compressing, decompress the output and "
                        "byte-compare against the input")
    p.add_argument("--devices", type=int, default=None,
                   help="cards for the distributed methods, all driven "
                        "from this process (default: every card; ignored "
                        "with --coordinator)")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="write a torch.profiler trace of the codec phase to "
                        "LOGDIR (TensorBoard format), with a span (flrl.*) "
                        "a stage of the walk, the mesh's card threads' too")
    p.add_argument("--coordinator", metavar="env://|HOST:PORT",
                   default=None,
                   help="multi-process mode, one process a card: env:// "
                        "joins torchrun's rendezvous, HOST:PORT a TCP one "
                        "(with --num-processes/--process-id, else WORLD_SIZE"
                        "/RANK)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--stream-chunk-mb", type=int, default=None,
                   help="FL only: stream the file in chunks of this many "
                        "MiB, with bounded host memory")
    return p


def _method(name: str) -> str:
    if name == "fl-shmem":
        print("[INFO] fl-shmem: no SHMEM backend in the PyTorch package; "
              "using fl-dist (the reference silently degraded this to CPU)",
              file=sys.stderr)
        return "fl-dist"
    return name


def _compress(args, codec, data: np.ndarray) -> int:
    with timed("compression", nbytes=data.size, enabled=args.timers), \
            profiler_trace(args.profile):
        comp = codec.compress(data, frame_length=args.frame_length,
                              devices=args.devices)
    with timed("saving output", enabled=args.timers):
        save_container(codec.family, args.output, comp)
    if args.timers:
        size = comp.values.size + 24 + (comp.counts.size
                                        if codec.family == "rl"
                                        else comp.bits.size)
        print(f"[INFO] compressed {data.size} -> {size} bytes "
              f"(ratio {size / data.size if data.size else 0.0:.4f})",
              file=sys.stderr)
    if args.verify:
        with timed("verification", nbytes=data.size, enabled=args.timers):
            out = codec.decompress(load_container(codec.family, args.output),
                                   frame_length=args.frame_length,
                                   devices=args.devices)
        if not np.array_equal(out, data):
            print("[ERROR] verification failed: round-trip mismatch",
                  file=sys.stderr)
            return 1
        print("[INFO] verification OK", file=sys.stderr)
    return 0


def _decompress(args, codec) -> None:
    with timed("loading compressed input", enabled=args.timers):
        comp = load_container(codec.family, args.input)
    with timed("decompression", nbytes=int(comp.input_size),
               enabled=args.timers), profiler_trace(args.profile):
        out = codec.decompress(comp, frame_length=args.frame_length,
                               devices=args.devices)
    with timed("saving output", nbytes=out.size, enabled=args.timers):
        save_file(args.output, out)


def _run_multihost(args) -> int:
    """Every process runs this same CLI, one process a card (one MPI rank
    a GPU in the reference); rank 0 writes the output, or every process
    its own ranges under ``FLRL_SHARED_FS=1``.  See
    ``parallel/multihost.py``."""
    import torch

    from .parallel import multihost
    try:
        world, rank = multihost.process_layout(args.num_processes,
                                               args.process_id)
    except ValueError as e:
        print(f"[ERROR] --coordinator: {e}", file=sys.stderr)
        return 2
    device = registry.default_device()
    if device.type == "cuda":
        device = multihost.local_device(rank)
    multihost.init_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=device)
    # rank-tagged stage lines (reference: file_io.cu:64, cpu_timer.cu:19-27)
    set_stage_timers(args.timers, rank=rank)
    if args.timers:
        print(f"[INFO] cuda devices={torch.cuda.device_count()} "
              f"device={device} process={rank}/{world} "
              f"backend={torch.distributed.get_backend()}", file=sys.stderr)
    family = resolve(_method(args.method)).family
    opts = {"group": None, "device": device}
    if args.operation == "d":
        if family == "fl":
            multihost.decompress_fl_file(args.input, args.output,
                                         args.frame_length, **opts)
        else:
            multihost.decompress_rl_file(args.input, args.output, **opts)
        return 0
    if family == "fl":
        multihost.compress_fl_file(args.input, args.output, args.frame_length,
                                   **opts)
    else:
        multihost.compress_rl_file(args.input, args.output, **opts)
    if args.verify:
        with timed("verification", enabled=args.timers):
            ok = multihost.verify_file_roundtrip(
                args.input, args.output, family, args.frame_length, **opts)
        if not ok:
            print("[ERROR] verification failed: round-trip mismatch",
                  file=sys.stderr)
            return 1
        print("[INFO] verification OK", file=sys.stderr)
    return 0


def _run_stream(args) -> int:
    """``--stream-chunk-mb``: the FL stream functions on the default
    device, whatever the FL method (``stream.py``)."""
    if resolve(_method(args.method)).family != "fl":
        print("[ERROR] --stream-chunk-mb supports FL methods only",
              file=sys.stderr)
        return 2
    from . import stream
    opts = {"device": registry.default_device()}
    with timed("streaming " + ("compression" if args.operation == "c"
                               else "decompression"), enabled=args.timers):
        if args.operation == "c":
            stream.compress_fl_stream(args.input, args.output,
                                      args.frame_length, args.stream_chunk_mb,
                                      **opts)
        else:
            stream.decompress_fl_stream(args.input, args.output,
                                        args.frame_length,
                                        args.stream_chunk_mb, **opts)
    if args.operation == "c" and args.verify:
        with timed("verification", enabled=args.timers):
            ok = stream.verify_fl_stream(args.input, args.output,
                                         args.frame_length,
                                         args.stream_chunk_mb, **opts)
        if not ok:
            print("[ERROR] verification failed: round-trip mismatch",
                  file=sys.stderr)
            return 1
        print("[INFO] verification OK", file=sys.stderr)
    return 0


def _launch_counts() -> dict:
    from .ops import fl_constant_cuda, fl_dense_cuda, fl_fields_cuda, rl_cuda
    return {**fl_dense_cuda.LAUNCHES, **fl_fields_cuda.LAUNCHES,
            **fl_constant_cuda.LAUNCHES, **rl_cuda.LAUNCHES}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # set unconditionally: in-process callers must not inherit a previous
    # run's switch
    set_stage_timers(args.timers)
    if args.frame_length <= 0 or args.frame_length % 8:
        print("[ERROR] --frame-length must be a positive multiple of 8",
              file=sys.stderr)
        return 2
    if args.devices is not None and args.devices < 1:
        print("[ERROR] --devices must be at least 1", file=sys.stderr)
        return 2
    if args.timers:
        before = _launch_counts()
    try:
        if args.coordinator is not None:
            rc = _run_multihost(args)
        elif args.stream_chunk_mb is not None:
            rc = _run_stream(args)
        else:
            rc = _run(args)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    if args.timers:
        ran = {k: v - before[k] for k, v in _launch_counts().items()}
        print(f"[INFO] kernel launches {json.dumps(ran)}", file=sys.stderr)
    return rc


def _run(args) -> int:
    codec = resolve(_method(args.method))
    if args.timers:
        import torch

        name = (torch.cuda.get_device_name() if torch.cuda.is_available()
                else "none")
        print(f"[INFO] cuda devices={torch.cuda.device_count()} "
              f"device0={name}", file=sys.stderr)
    if args.operation == "d":
        _decompress(args, codec)
        return 0
    with timed("loading input", enabled=args.timers) as t:
        data = load_file(args.input)
        t.add_transfer_size(data.size)
    return _compress(args, codec, data)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
