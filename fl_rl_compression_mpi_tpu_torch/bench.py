"""Benchmark of the PyTorch package on one CUDA device: the counterpart of
the JAX package's ``bench.py``, with its flags, its phases and its JSON keys.

    python -m fl_rl_compression_mpi_tpu_torch.bench [--size-mb 256]
        [--method fl|rl] [--reps 7] [--full] [--json-only] [--device cuda]

``--device cpu`` runs the kernels' plain PyTorch versions through the same
arms (the tests use it); without a CUDA device and without it the run
fails.  The stream is the JAX bench's: ``--size-mb`` MiB of bytes below 16
(4-bit frames) from ``numpy.random.default_rng(0)``, and every later arm
draws its stream from the same generator in the same order.

Phases, as in ``bench.py``:

1. **Quick headline** (never skipped): the input copied up once, the
   copy-ceiling probe, the field route's chained encode→decode pair in its
   two modes (base, and pack-2 where the widest frame is at most 4 and the
   words fill whole ``PACK_TILE_R`` tiles), the winner checked on the card,
   then the headline JSON line printed and flushed.
2. **Budget-gated arms**, each skipped (and named in ``skipped_arms``) when
   the wall budget ``FLRL_BENCH_BUDGET_S`` (default 540 s) left cannot
   cover its estimate; the slow ones only under ``--full``.  An arm that
   raises leaves ``<arm>_error`` in the JSON, and a round trip that fails
   leaves its ``*_ok*`` key false; either makes the exit code 1.
3. **Final line**: the JSON with every arm that ran.  SIGTERM, SIGINT,
   SIGALRM and a watchdog thread at budget + 60 s flush the JSON line so
   far, with ``interrupted_error`` naming the cause, and exit 1: arms were
   still left to run.

Timing is the card's own: a chain is k data-dependent round trips queued
with nothing read back, timed with CUDA events, and its time a step is the
difference of k = 1 + inner and k = 1 over inner.  Every chain runs once
under ``torch.cuda.set_sync_debug_mode("error")`` before it is timed, so a
wrapper that reads the device back inside it fails.  The RL pair is the one
exception: ``rl_cuda.encode_chunk`` reads R and the run start back by
design (one small copy), and that call alone runs with the check off.  On
the CPU the host clock times the plain versions, over at most two steps
past the first.

No value is clamped: every primary key holds what was measured.  A rate
above 1.05 times the nominal bound of its traffic (3.35 TB/s, NVIDIA's data
sheet for the H100 SXM) gets a side key ``<key>_flag: "above-bound"`` (on
a card only: a CPU run has no such bound).  The
bounds are the JAX bench's traffic counts: a base field pair moves 4N bytes
(bound 3350/2 GB/s of input), a pack-2 pair 3N (3350·2/3), a dense pair
2N(1 + ratio), a copy-probe step (two passes) 4N.  ``vs_baseline`` is the
headline rate over min(nominal bound, copy ceiling × traffic factor), the
copy ceiling in the JAX package's unit (2N over a step's time).

What differs from the TPU arms, because the mechanism has no meaning on
the card:

* ``tune``: the TPU tile ladder has no counterpart (the port's pack-2 tile
  is the layout constant ``fl_torch.PACK_TILE_R``), so it ranks the base
  pair against the pack-2 pair over long runs;
* the dense arms take the production dispatch (constant probe → uniform
  probe and flag → general), and ``dense_path`` reads ``constant-wN``,
  ``uniform-wN`` or ``general``: the TPU stream plan is not ported;
* ``sharded``: the port has no device-only sharded program, so it times
  ``dist.compress_fl(data, group=None, device=...)`` (one rank, no process
  group) against ``fl_torch.encode`` on the same host array;
* ``dense_bmp`` reads the image that ``--bmp PATH`` names (``bench.py``
  reads the reference's ``sample_1280×853.bmp`` from a fixed path outside
  its checkout), and is skipped, with its reason in ``skip_reasons``,
  without one or where the file is absent.

The JSON also names the ``device``, and on a card its ``power_limit`` as
``nvidia-smi`` reads it.  The last stderr line before the summary lists the
kernel launches of the run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import container, fileio
from .models import registry
from .native import get_native
from .ops import copy_probe_cuda as cp
from .ops import fl_constant_cuda as ck
from .ops import fl_dense_cuda as kern
from .ops import fl_fields_cuda as fkern
from .ops import fl_numpy
from .ops import fl_torch, rl_torch
from .ops import rl_cuda as rk
from .parallel import dist

HBM_GBPS = 3350.0         # H100 SXM memory rate, NVIDIA's data sheet
ABOVE_BOUND = 1.05        # a rate above this share of its bound is flagged
FRAME = 128
RL_ARM_BYTES = 64 << 20   # the RL arms' stream, as in bench.py
PIPE_CHUNK = 32 << 20     # the e2e arm's pipelined chunks

T0 = [time.perf_counter()]
RESULT: dict = {}         # the JSON record; emit() prints the current one
SKIPPED: list = []        # arms skipped for the budget or for --full
REASONS: dict = {}        # arm -> why it was skipped, where not either
_EMITTED = [0]
_KERNEL_MODULES = (cp, kern, fkern, ck, rk)


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T0[0]:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def emit() -> None:
    """Print the current JSON record (once a headline exists)."""
    if "metric" not in RESULT or "value" not in RESULT:
        return
    rec = dict(RESULT)
    if SKIPPED:
        rec["skipped_arms"] = sorted(set(SKIPPED))
    if REASONS:
        rec["skip_reasons"] = dict(REASONS)
    print(json.dumps(rec), flush=True)
    _EMITTED[0] += 1


def _flush_and_exit(signum, frame):
    """Flush the JSON so far and exit 1: the run was cut with arms left
    (signal 0 is the watchdog)."""
    at = f"+{time.perf_counter() - T0[0]:.0f}s"
    log(f"signal {signum} received at {at}: flushing JSON and exiting")
    if "value" not in RESULT:
        RESULT.setdefault("metric", "fl_kernel_throughput")
        RESULT.update(unit="GB/s", value=0.0, vs_baseline=0.0,
                      error=f"killed at {at} before the first measurement")
    RESULT["interrupted_error"] = (f"signal {signum} at {at}" if signum
                                   else f"watchdog at {at}")
    emit()
    os._exit(1)


def launch_counts() -> dict:
    out = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.LAUNCHES)
    return out


def device_info(dev: torch.device) -> dict:
    """The card's name and its power limit as nvidia-smi reads it."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"device": torch.cuda.get_device_name(dev), "power_limit": limit}


def resolve_device(name: str) -> torch.device:
    """``cpu`` runs the plain versions; anything else must be a card."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        return registry.default_device()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return torch.device(name)


class Clock:
    """Seconds of device work: CUDA events on a card, the host clock on
    the CPU (where the plain versions run synchronously)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def seconds(self, fn) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


@contextlib.contextmanager
def sync_debug(mode, cuda: bool):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, on a card."""
    if not cuda:
        yield
        return
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


def run_chain(step, x, k: int):
    for _ in range(k):
        x = step(x)
    return x


def adaptive_inner(t_probe: float, lo: int) -> int:
    """Steps of a long chain: about 0.4 s of differenced work, as
    bench.py takes, at least ``lo`` and at most 64."""
    return int(min(64, max(lo, 0.4 / max(t_probe, 1e-4))))


class Bench:
    def __init__(self, args, dev: torch.device):
        self.args = args
        self.dev = dev
        self.clock = Clock(dev)
        # the plain versions' times say nothing of the card: short runs
        self.max_inner = 64 if self.clock.cuda else 2
        self.budget = float(os.environ.get("FLRL_BENCH_BUDGET_S", "540"))
        self.n = args.size_mb << 20
        self.rng = np.random.default_rng(0)
        self.copy_rate = None
        self.perop = {}
        self.rl = None

    # -- timing ----------------------------------------------------------
    def remaining(self) -> float:
        return self.budget - (time.perf_counter() - T0[0])

    def timed(self, fn, reps: int, inner: int = 16):
        """``(fn(), seconds a call)``: a batch of 1 + inner calls less a
        batch of one, over inner, median of ``reps``."""
        inner = min(inner, self.max_inner)
        out = fn()
        self.clock.sync()
        ts = []
        for _ in range(reps):
            t1 = self.clock.seconds(fn)
            t2 = self.clock.seconds(lambda: [fn() for _ in range(1 + inner)])
            ts.append((t2 - t1) / inner)
        return out, max(float(np.median(ts)), 1e-9)

    def timed_chain(self, step, x, inner: int, reps: int) -> float:
        """Seconds a step of the chain ``step`` from ``x``: k = 1 + inner
        less k = 1, over inner, median of ``reps``, after one run of
        each."""
        inner = min(inner, self.max_inner)
        run_chain(step, x, 1)
        run_chain(step, x, 1 + inner)
        self.clock.sync()
        ts = []
        for _ in range(reps):
            t1 = self.clock.seconds(lambda: run_chain(step, x, 1))
            t2 = self.clock.seconds(lambda: run_chain(step, x, 1 + inner))
            ts.append((t2 - t1) / inner)
        return max(float(np.median(ts)), 1e-9)

    def checked_chain(self, step, x, k: int = 2):
        """k steps of the chain with every device read-back an error."""
        with sync_debug("error", self.clock.cuda):
            out = run_chain(step, x, k)
        self.clock.sync()
        return out

    def flag_above(self, key: str, rate: float, bound: float) -> None:
        """Flag ``RESULT[key]`` when ``rate`` lies above its bound on the
        card (the bounds are the H100's: a CPU run has none)."""
        if self.clock.cuda and rate > ABOVE_BOUND * bound:
            RESULT[key + "_flag"] = "above-bound"
        else:
            RESULT.pop(key + "_flag", None)

    def run_arm(self, name: str, est_s: float, fn,
                full_only: bool = False) -> None:
        if full_only and not self.args.full:
            SKIPPED.append(name)
            return
        if self.remaining() < est_s:
            log(f"skip arm {name}: est {est_s:.0f}s > "
                f"{self.remaining():.0f}s remaining")
            SKIPPED.append(name)
            return
        t0 = time.perf_counter()
        try:
            fn()
            log(f"arm {name} done in {time.perf_counter() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 - recorded, and rc 1
            log(f"arm {name} FAILED: {type(e).__name__}: {e}")
            RESULT[f"{name}_error"] = type(e).__name__

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    # -- RL method ---------------------------------------------------------
    def rl_method(self) -> int:
        """Device-resident encode and decode of the whole stream."""
        n, args = self.n, self.args
        nruns = n // 32
        host = np.repeat(self.rng.integers(0, 256, nruns, np.uint8),
                         self.rng.integers(16, 112, nruns))[:n].copy()
        x = self.to_device(host)
        (counts, values), t_enc = self.timed(
            lambda: rl_encode_device(x, host), args.reps, inner=1)
        counts_h = counts.cpu().numpy()
        block_end = rl_torch._block_ends(counts_h)
        out, t_dec = self.timed(
            lambda: rl_decode_device(counts, values, counts_h, block_end),
            args.reps, inner=1)
        ok = bool(np.array_equal(out.cpu().numpy(), host))
        RESULT["kernel"] = "cuda" if self.clock.cuda else "plain"
        nat = get_native()
        if nat is not None:
            t0 = time.perf_counter()
            c_n, v_n = nat.rl_encode(host)
            RESULT["native_encode_gbps"] = n / 1e9 / (time.perf_counter()
                                                      - t0)
            t0 = time.perf_counter()
            nat.rl_decode(c_n, v_n)
            RESULT["native_decode_gbps"] = n / 1e9 / (time.perf_counter()
                                                      - t0)
        if not ok:
            print(json.dumps({"metric": "rl_codec_throughput", "value": 0.0,
                              "unit": "GB/s", "vs_baseline": 0.0,
                              "error": "round-trip mismatch"}), flush=True)
            return 1
        ratio = 2 * counts.numel() / n
        gb = n / 1e9
        agg = 2 * gb / (t_enc + t_dec)
        RESULT.update({
            "metric": "rl_codec_throughput", "value": agg, "unit": "GB/s",
            "vs_baseline": agg / (HBM_GBPS / (1.0 + ratio)),
            "encode_gbps": gb / t_enc, "decode_gbps": gb / t_dec,
            "ratio": round(ratio, 4)})
        self.flag_above("value", agg, HBM_GBPS / (1.0 + ratio))
        emit()
        return 0

    # -- FL method: set-up and the headline --------------------------------
    def fl_setup(self) -> None:
        n = self.n
        self.host = self.rng.integers(0, 16, n, np.uint8)
        self.frames = -(-n // FRAME)
        self.npad = max(1, self.frames) * FRAME
        self.buf = np.zeros(self.npad, np.uint8)
        self.buf[:n] = self.host
        RESULT.update(metric="fl_kernel_throughput", unit="GB/s",
                      kernel="cuda" if self.clock.cuda else "plain",
                      ratio=round(fl_numpy.compressed_size(self.host) / n, 4))
        self.wmax = int(fl_numpy.frame_bits(self.buf).max())
        log("copy of the input words to the device ...")
        self.words = self.to_device(self.buf.view(np.int32))
        self.clock.sync()

    def p2_ok(self) -> bool:
        return (self.wmax <= 4 and (self.npad // 4)
                % (fl_torch.PACK_TILE_R * fkern.LANES) == 0)

    @staticmethod
    def sol_nominal(pack: bool) -> float:
        return HBM_GBPS * (2.0 / 3.0 if pack else 0.5)

    def sol(self, pack: bool) -> float:
        nominal = self.sol_nominal(pack)
        if self.copy_rate:
            return min(nominal, self.copy_rate * (4.0 / 3.0 if pack else 1.0))
        return nominal

    def pair_rate(self, t: float) -> float:
        return 2 * self.n / 1e9 / t

    def verify_chain(self, step) -> bool:
        out = self.checked_chain(step, self.words)
        return bool(torch.equal(out, self.words))

    def set_headline(self, rate: float, pack: bool) -> None:
        RESULT["chain_pack"] = 2 if pack else 1
        RESULT["chained_pair_gbps"] = rate
        self.flag_above("chained_pair_gbps", rate, self.sol_nominal(pack))
        RESULT["vs_nominal_sol"] = rate / self.sol_nominal(pack)
        if self.copy_rate:
            RESULT["chain_vs_copy"] = (rate * (0.75 if pack else 1.0)
                                       / self.copy_rate)
        RESULT["value"] = rate
        RESULT["vs_baseline"] = rate / self.sol(pack)

    def copy_probe(self) -> None:
        """The copy ceiling: a chain of two probe passes a step."""
        w = self.words
        out = self.checked_chain(copy_step, w, 1)
        if not torch.equal(out, cp.add_one_ref(cp.add_one_ref(w))):
            raise AssertionError("copy probe: words + 2 expected")
        t = min(self.timed_chain(copy_step, w, inner=32, reps=2),
                self.timed_chain(copy_step, w, inner=32, reps=2))
        self.copy_rate = self.pair_rate(t)
        RESULT["copy_ceiling_gbps"] = self.copy_rate
        self.flag_above("copy_ceiling_gbps", self.copy_rate, HBM_GBPS / 2)

    def candidates(self) -> list:
        packs = [True] if self.p2_ok() else []
        return [(pack, field_step(pack)) for pack in packs + [False]]

    def quick_headline(self) -> bool:
        if (self.npad // 4 // FRAME) % 2048 == 0:
            try:
                log("copy-ceiling probe ...")
                self.copy_probe()
            except Exception as e:  # noqa: BLE001 - recorded, and rc 1
                log(f"copy probe FAILED: {type(e).__name__}: {e}")
                RESULT["copy_error"] = type(e).__name__
        scored = []
        for pack, step in self.candidates():
            log(f"quick chain probe pack={2 if pack else 1} ...")
            rate = self.pair_rate(self.timed_chain(step, self.words,
                                                   inner=10, reps=2))
            scored.append((rate / self.sol(pack), pack, step))
        scored.sort(key=lambda s: -s[0])
        for _, pack, step in scored:
            if self.verify_chain(step):
                break
        else:
            print(json.dumps({"metric": "fl_kernel_throughput",
                              "value": 0.0, "unit": "GB/s",
                              "vs_baseline": 0.0,
                              "error": "round-trip mismatch"}), flush=True)
            return False
        rate = self.pair_rate(self.timed_chain(step, self.words, inner=32,
                                               reps=3))
        self.set_headline(rate, pack)
        log(f"HEADLINE (quick): {rate:.1f} GB/s "
            f"vs_baseline={RESULT['vs_baseline']:.4f}")
        emit()
        return True

    # -- FL arms ---------------------------------------------------------
    def arm_tune(self) -> None:
        """Both modes over long runs, each checked on the card; the best
        fraction of its bound becomes the headline."""
        finals = []
        for pack, step in self.candidates():
            if not self.verify_chain(step):
                raise AssertionError(f"pack={2 if pack else 1} chain does "
                                     "not round-trip")
            rate = self.pair_rate(self.timed_chain(
                step, self.words, inner=64, reps=self.args.reps))
            finals.append((rate / self.sol(pack), rate, pack))
        finals.sort(key=lambda f: -f[0])
        self.set_headline(finals[0][1], finals[0][2])
        if len(finals) > 1:
            _, rate, pack = finals[1]
            RESULT["chain_alt_gbps"] = rate
            self.flag_above("chain_alt_gbps", rate, self.sol_nominal(pack))
            RESULT["chain_alt_vs_sol"] = finals[1][0]
            RESULT["chain_alt_pack"] = 2 if pack else 1
        log(f"HEADLINE (tuned): {RESULT['chained_pair_gbps']:.1f} GB/s "
            f"vs_baseline={RESULT['vs_baseline']:.4f}")
        emit()

    def arm_perop(self) -> None:
        """Encode and decode timed apart, the copy down, and the host
        compare behind ``host_roundtrip_ok``."""
        n, w = self.n, self.words
        (bits_d, fields_d), t_enc = self.timed(
            lambda: fl_torch.encode_fields_device(w, FRAME), 3)
        out_w, t_dec = self.timed(
            lambda: fl_torch.decode_fields_device(fields_d, bits_d, FRAME),
            3)
        self.clock.sync()
        t0 = time.perf_counter()
        out_h = out_w.cpu()
        RESULT["d2h_gbps"] = n / 1e9 / (time.perf_counter() - t0)
        host_ok = bool(np.array_equal(out_h.numpy().view(np.uint8)[:n],
                                      self.host))
        self.perop = {"fields": fields_d, "host_ok": host_ok,
                      "bits": bits_d.cpu().numpy()[:self.frames]}
        RESULT["host_roundtrip_ok"] = host_ok
        for key, t in (("encode_gbps", t_enc), ("decode_gbps", t_dec)):
            RESULT[key] = n / 1e9 / t
            self.flag_above(key, RESULT[key], HBM_GBPS / 2)

    def arm_fold(self) -> None:
        nat = get_native()
        if "fields" not in self.perop or nat is None:
            SKIPPED.append("fold")
            return
        n = self.n
        fields_h = self.perop["fields"].cpu().numpy().view(
            np.uint32)[:self.frames * (FRAME // 4)]
        bits_h = self.perop["bits"]
        values = nat.fl_fold(fields_h, bits_h, n, FRAME)      # warm-up
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            values = nat.fl_fold(fields_h, bits_h, n, FRAME)
            ts.append(time.perf_counter() - t0)
        RESULT["fold_gbps"] = n / 1e9 / min(ts)
        nat.fl_unfold(values, bits_h, n, FRAME)               # warm-up
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            nat.fl_unfold(values, bits_h, n, FRAME)
            ts.append(time.perf_counter() - t0)
        RESULT["unfold_gbps"] = n / 1e9 / min(ts)

    def dense_arm(self, tag: str, hbytes: np.ndarray) -> None:
        """One stream (u8[npad], data in [:n]) through the production
        dispatch: the constant kernels where the constant probe and their
        flag agree, else the uniform mode where the uniform probe and the
        widths flag agree, else the general kernels; then its pair timed
        as a chain."""
        n = self.n
        data = hbytes[:n]
        x = self.to_device(data)
        wid = fl_numpy.frame_bits(hbytes)
        step = path = None
        cprob = ck.host_probe_constant(hbytes, n)
        if cprob is not None:
            cb, fbc = cprob
            _, _, flag = ck.encode_constant(x, cb, fbc)
            if int(flag[0]) == 0:
                step, path = constant_step(cb, fbc, n), f"constant-w{fbc}"
        if step is None:
            fb = kern.host_probe_uniform_b(data, FRAME)
            if fb and int(kern.frame_widths(x, FRAME, fb_expect=fb)[1][0]):
                fb = None
            step = dense_step(n, fb)
            path = f"uniform-w{fb}" if fb else "general"
        RESULT[f"dense_path{tag}"] = path
        ok = bool(np.array_equal(self.checked_chain(step, x).cpu().numpy(),
                                 data))
        RESULT[f"dense_ok{tag}"] = ok
        if not ok:
            return
        t_probe = self.timed_chain(step, x, inner=6, reps=2)
        t = self.timed_chain(step, x, inner=adaptive_inner(t_probe, 6),
                             reps=3)
        rate = self.pair_rate(t)
        ratio = (wid.size + 16 * int(wid.sum(dtype=np.int64))) / n
        bound = HBM_GBPS / (1.0 + ratio)
        RESULT[f"dense_pair{tag}_gbps"] = rate
        self.flag_above(f"dense_pair{tag}_gbps", rate, bound)
        RESULT[f"dense_vs_sol{tag}"] = rate / bound

    def arm_dense_main(self) -> None:
        n = self.n
        x = self.to_device(self.host)
        fb = kern.host_probe_uniform_b(self.host, FRAME)
        _, t = self.timed(lambda: dense_encode(x, n, fb), 3, inner=8)
        RESULT["dense_encode_gbps"] = n / 1e9 / t
        self.flag_above("dense_encode_gbps", RESULT["dense_encode_gbps"],
                   HBM_GBPS)
        self.dense_arm("", self.buf)

    def arm_dense_zeros(self) -> None:
        self.dense_arm("_zeros", np.zeros(self.npad, np.uint8))

    def arm_dense_w8(self) -> None:
        w8b = self.rng.integers(0, 256, self.npad, np.uint8)
        w8b[::64] |= 128            # pin every frame at width 8
        w8b[self.n:] = 0
        self.dense_arm("_w8", w8b)

    def arm_dense_w3(self) -> None:
        w3b = (self.rng.integers(0, 4, self.npad) + 4).astype(np.uint8)
        w3b[self.n:] = 0
        self.dense_arm("_w3", w3b)

    def arm_dense_mixed(self) -> None:
        mixed = self.rng.integers(0, 256, self.npad, np.uint8)
        m2 = mixed[:self.n].reshape(-1, FRAME)
        wf = self.rng.integers(1, 9, m2.shape[0])
        m2 &= ((1 << wf) - 1).astype(np.uint8)[:, None]
        m2[:, 0] = (1 << (wf - 1)).astype(np.uint8)
        mixed[self.n:] = 0
        self.dense_arm("_mixed", mixed)

    def arm_dense_bmp(self) -> None:
        path = self.args.bmp
        if not path or not os.path.isfile(path):
            SKIPPED.append("dense_bmp")
            REASONS["dense_bmp"] = (f"no image at {path}" if path else
                                    "no image: pass --bmp PATH")
            return
        bb = np.resize(np.fromfile(path, np.uint8), self.npad)
        bb[self.n:] = 0
        self.dense_arm("_bmp", bb)

    # -- RL arms -----------------------------------------------------------
    def rl_setup(self) -> None:
        if self.rl is None:
            nrl = min(self.n, RL_ARM_BYTES)
            runs = nrl // 32
            host = np.repeat(self.rng.integers(0, 256, runs, np.uint8),
                             self.rng.integers(16, 112, runs))[:nrl].copy()
            self.rl = {"n": nrl, "host": host, "step": rl_step(nrl)}

    def rl_chain(self, key: str, data: np.ndarray) -> None:
        """The RL pair's chain on ``data``: checked, then timed."""
        nrl, step = self.rl["n"], self.rl["step"]
        x = self.to_device(data)
        out = self.checked_chain(step, x)
        ok = bool(np.array_equal(out.cpu().numpy(), data))
        if key == "rl_pair_gbps":
            RESULT["rl_ok"] = ok
        if not ok:
            if key != "rl_pair_gbps":
                raise AssertionError(f"{key}: the RL pair does not "
                                     "round-trip")
            return
        runs = rk.encode_chunk(x)[0].numel()
        t_probe = self.timed_chain(step, x, inner=4, reps=2)
        t = self.timed_chain(step, x, inner=adaptive_inner(t_probe, 8),
                             reps=3)
        RESULT[key] = 2 * nrl / 1e9 / t
        # the pair reads and writes the stream once and the runs twice
        self.flag_above(key, RESULT[key], HBM_GBPS * 2 * nrl / (2 * nrl
                                                           + 4 * runs))

    def arm_rl(self) -> None:
        self.rl_setup()
        self.rl_chain("rl_pair_gbps", self.rl["host"])

    def arm_rl_zeros(self) -> None:
        if self.rl is None or not RESULT.get("rl_ok"):
            SKIPPED.append("rl_zeros")
            return
        self.rl_chain("rl_zeros_gbps", np.zeros(self.rl["n"], np.uint8))

    def arm_rl_half(self) -> None:
        if self.rl is None or not RESULT.get("rl_ok"):
            return
        nrl = self.rl["n"]
        half = self.rl["host"].copy()
        blk = 4 << 20
        for off in range(0, nrl, 2 * blk):
            half[off:off + blk] = half[off]
        self.rl_chain("rl_half_gbps", half)

    # -- one rank without a process group against the bare encode --------
    def arm_sharded(self) -> None:
        host, dev = self.host, self.dev

        def bare():
            return fl_torch.encode(host, device=dev)

        def shd():
            return dist.compress_fl(host, group=None, device=dev)

        def wall(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        bare()
        shd()
        ratios, best = [], None
        for _ in range(5):
            tb, tsh = wall(bare), wall(shd)
            ratios.append(tb / tsh)
            best = tsh if best is None else min(best, tsh)
        RESULT["sharded_enc_gbps"] = self.n / 1e9 / best
        self.flag_above("sharded_enc_gbps", RESULT["sharded_enc_gbps"],
                   HBM_GBPS / 2)
        RESULT["sharded_eff"] = float(np.median(ratios))

    # -- load, copy up, dense encode, copy down, save ----------------------
    def arm_e2e(self) -> None:
        n, dev = self.n, self.dev
        with tempfile.TemporaryDirectory() as td:
            src, dst = os.path.join(td, "in.bin"), os.path.join(td, "out.fl")
            self.host.tofile(src)
            t0 = time.perf_counter()
            data = fileio.load_file(src)
            t_load = time.perf_counter() - t0
            t0 = time.perf_counter()
            x = self.to_device(data)
            self.clock.sync()
            t_h2d = time.perf_counter() - t0
            fb = kern.host_probe_uniform_b(data, FRAME)
            if fb and int(dense_encode(x, n, fb)[2][0]):
                fb = None           # the widths flag: the general kernels
            (bits_d, values_d, _), t_kernel = self.timed(
                lambda: dense_encode(x, n, fb), 3, inner=8)
            t0 = time.perf_counter()
            bits = bits_d.cpu().numpy()
            values = values_d[:fl_torch.payload_size(bits, n, FRAME)]
            values = values.cpu().numpy()
            t_d2h = time.perf_counter() - t0
            RESULT["e2e_h2d_s"] = t_h2d
            RESULT["e2e_kernel_s"] = t_kernel
            RESULT["e2e_kernel_gbps"] = n / 1e9 / t_kernel
            RESULT["e2e_d2h_s"] = t_d2h
            t_codec = t_h2d + t_kernel + t_d2h
            t0 = time.perf_counter()
            container.save_fl(dst, container.FLCompressed(bits, values, n))
            t_write = time.perf_counter() - t0
            RESULT["end_to_end_gbps"] = n / 1e9 / (t_load + t_codec
                                                   + t_write)
            RESULT["e2e_load_s"] = t_load
            RESULT["e2e_codec_s"] = t_codec
            RESULT["e2e_write_s"] = t_write
            # the pipelined walk against the serial codec above, on the
            # same bytes, after a warm-up of one chunk
            ck_ = PIPE_CHUNK
            if n > ck_:
                for _ in fl_torch.encode_chunks([data[:ck_]], device=dev):
                    pass
                t0 = time.perf_counter()
                pbits, pvals = [], []
                for b, v in fl_torch.encode_chunks(
                        (data[o:o + ck_] for o in range(0, n, ck_)),
                        device=dev):
                    pbits.append(b)
                    pvals.append(v.copy())  # valid until the walk advances
                t_pipe = time.perf_counter() - t0
                RESULT["e2e_pipe_s"] = t_pipe
                RESULT["e2e_pipe_gbps"] = n / 1e9 / t_pipe
                RESULT["e2e_pipe_ok"] = bool(
                    np.array_equal(np.concatenate(pbits), bits)
                    and np.array_equal(np.concatenate(pvals), values))

    def fl_method(self) -> int:
        self.fl_setup()
        if not self.quick_headline():
            return 1
        arms = (("tune", 30, self.arm_tune, False),
                ("perop", 15, self.arm_perop, False),
                ("dense_main", 20, self.arm_dense_main, False),
                ("rl", 15, self.arm_rl, False),
                ("sharded", 15, self.arm_sharded, False),
                ("dense_zeros", 10, self.arm_dense_zeros, False),
                ("dense_w8", 15, self.arm_dense_w8, False),
                ("rl_zeros", 10, self.arm_rl_zeros, False),
                ("fold", 10, self.arm_fold, False),
                ("dense_w3", 15, self.arm_dense_w3, True),
                ("dense_mixed", 20, self.arm_dense_mixed, True),
                ("dense_bmp", 15, self.arm_dense_bmp, True),
                ("rl_half", 10, self.arm_rl_half, True),
                ("e2e", 30, self.arm_e2e, True))
        for name, est_s, fn, full_only in arms:
            self.run_arm(name, est_s, fn, full_only)
        if self.perop.get("host_ok") is False:
            print(json.dumps({"metric": "fl_kernel_throughput", "value": 0.0,
                              "unit": "GB/s", "vs_baseline": 0.0,
                              "error": "round-trip mismatch"}), flush=True)
            return 1
        if not self.args.json_only:
            print(f"# fl size={self.args.size_mb}MiB "
                  f"ratio={RESULT['ratio']:.4f} "
                  f"headline={RESULT.get('chained_pair_gbps')} GB/s "
                  f"vs_baseline={RESULT.get('vs_baseline')} extra={RESULT}",
                  file=sys.stderr)
        emit()
        return 0


# ---------------------------------------------------------------------------
# The chains' steps and the device-resident walks.
# ---------------------------------------------------------------------------

def copy_step(w: torch.Tensor) -> torch.Tensor:
    """A copy-ceiling chain step: two probe passes, as bench.py's
    ``cp_chain``."""
    return cp.add_one(cp.add_one(w))


def field_step(pack: bool):
    """The field route's encode→decode pair on int32 words."""
    def step(w):
        bits, fields = fl_torch.encode_fields_device(w, FRAME, pack=pack)
        return fl_torch.decode_fields_device(fields, bits, FRAME, pack=pack)
    return step


def dense_encode(x: torch.Tensor, n: int, fb):
    """The dense encode of ``x`` u8[n]: widths (with the flag where fb is
    speculated) and the uniform pack, or the offsets and the general pack
    sized to n.  Returns ``(bits, values, flag)``."""
    bits, flag = kern.frame_widths(x, FRAME, fb_expect=fb or 0)
    if fb:
        return bits, kern.pack(x, FRAME, fb=fb), flag
    offs = kern.frame_offsets(bits, n, FRAME)
    return bits, kern.pack(x, FRAME, bits=bits, offs=offs, size=n), flag


def dense_step(n: int, fb):
    """The dense pair on u8[n]: encode, then decode from the encoder's
    widths and offsets (uniform mode where fb is given)."""
    def step(x):
        bits, flag = kern.frame_widths(x, FRAME, fb_expect=fb or 0)
        if fb:
            return kern.unpack(kern.pack(x, FRAME, fb=fb), n, FRAME, fb=fb)
        offs = kern.frame_offsets(bits, n, FRAME)
        values = kern.pack(x, FRAME, bits=bits, offs=offs, size=n)
        return kern.unpack(values, n, FRAME, bits=bits, offs=offs)
    return step


def constant_step(cbyte: int, fb: int, n: int):
    """The constant kernels' pair on u8[n] of ``cbyte``."""
    size = ck.payload_size(n, fb)

    def step(x):
        _, values, _ = ck.encode_constant(x, cbyte, fb)
        return ck.decode_constant(values, size, cbyte, fb, n)[0]
    return step


def rl_step(n: int):
    """The RL pair on u8[n]: encode one chunk, the run offsets, expand."""
    def step(x):
        with sync_debug(0, x.is_cuda):      # R is read back by design
            values, counts, _ = rk.encode_chunk(x)
        return rk.expand(counts, values, rk.run_offsets(counts), n)
    return step


def rl_encode_device(x: torch.Tensor, host: np.ndarray):
    """``(counts, values)`` on the device of the stream ``x`` (whose bytes
    ``host`` holds): ``rl_torch``'s encode walk on slices of ``x``, its
    parts kept on the device."""
    parts = rl_torch.encode_parts(
        host, lambda off, chunk: x[off:off + chunk.size],
        lambda counts, values: (counts, values))
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([c for c, _ in parts]),
            torch.cat([v for _, v in parts]))


def rl_decode_device(counts: torch.Tensor, values: torch.Tensor,
                     counts_h: np.ndarray, block_end: np.ndarray):
    """The bytes of the runs on the device: ``rl_torch``'s decode walk on
    the runs ``counts``/``values`` (``counts_h`` the counts on the host,
    ``block_end`` their ``rl_torch._block_ends``)."""
    def runs(r0, r1):
        c, v = counts[r0:r1], values[r0:r1]
        if r0:                      # the kernels take aligned runs
            c, v = c.clone(), v.clone()
        return c, v

    parts = [out for _, _, out in rl_torch.decode_parts(counts_h, block_end,
                                                        runs)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_rl_compression_mpi_tpu_torch.bench",
        description="Benchmark of the FL/RL kernels on one CUDA device")
    ap.add_argument("--size-mb", type=int, default=256)
    ap.add_argument("--method", choices=["fl", "rl"], default="fl")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--full", action="store_true",
                    help="run the slow arms (w3/mixed/bmp/rl_half/e2e)")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--bmp", metavar="PATH",
                    help="the image of the dense_bmp arm (--full): "
                         "bench.py's is the reference's sample_1280×853.bmp")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu for the plain "
                         "versions")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    T0[0] = time.perf_counter()
    RESULT.clear()
    SKIPPED.clear()
    REASONS.clear()
    _EMITTED[0] = 0
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[ERROR] {e} (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    bench = Bench(args, dev)
    saved = {sig: signal.signal(sig, _flush_and_exit)
             for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)}
    signal.alarm(int(bench.budget) + 240)
    done = threading.Event()

    def watchdog():
        if not done.wait(bench.budget + 60):
            log("watchdog fired: the main thread is still busy")
            _flush_and_exit(0, None)

    threading.Thread(target=watchdog, daemon=True).start()
    for mod in _KERNEL_MODULES:
        mod.reset_launches()
    log(f"start method={args.method} size={args.size_mb}MiB device={dev} "
        f"budget={bench.budget:.0f}s full={args.full}")
    try:
        RESULT.update(device_info(dev))
        if args.method == "rl":
            rc = bench.rl_method()
        else:
            rc = bench.fl_method()
    finally:
        done.set()
        signal.alarm(0)
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    log(f"kernel launches {json.dumps(launch_counts())}")
    errors = sorted(k for k in RESULT if k.endswith("_error")
                    or (RESULT[k] is False and "_ok" in k))
    log(f"done, total {time.perf_counter() - T0[0]:.1f}s, "
        f"skipped={sorted(set(SKIPPED))}, failed={errors}")
    return 1 if rc == 0 and errors else rc


if __name__ == "__main__":
    sys.exit(main())
