"""RL codec on one device: the host dispatch around the RL kernels.

Counterpart of ``fl_rl_compression_mpi_tpu/ops/rl_jax.py`` (its host
API).  One dispatch chain serves every input size:

* encode — constant stream → closed-form container on the host; else a
  walk over chunks of at most ``fl_torch.MAX_DEVICE_CHUNK`` bytes, each
  copied to the device, encoded by the kernels with the carry of the
  chunk before it (its last byte and how far into a natural run it
  ended), and copied back (exactly R counts and R values).  A chunk's
  last count runs to the chunk's end; the host closes it with the next
  piece start, in whichever later chunk it falls, or with the stream's
  end;
* decode — empty container → empty output; canonical constant container
  (one value, every count but the last 255) → ``np.full``; else a walk
  over chunks split at run boundaries, each with output ≤ 1 GiB (a chunk
  takes at least one run), each chunk's output copied from the device
  straight into its slice of the output.  The output length is the sum
  of the counts, as in ``rl_jax.decode``; the container's ``input_size``
  is not consulted.

:func:`encode_device` and :func:`decode_device` are the device-level
pieces of the sharded programs (``parallel/dist.py``): a stream already on
the device in, runs (or bytes) left on it, nothing read back.

The codec has no weights: its state is the container.  Encode and decode
read and write the same ``RLCompressed`` fields and file bytes as the JAX
package (this package's ``container.py`` is a copy of
``fl_rl_compression_mpi_tpu/container.py``), so containers cross between
the two packages as they are, with no conversion.

``device`` is explicit: a CUDA device runs the kernels, the CPU runs their
plain PyTorch versions (the tests use it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import constant_byte_probe
from ..utils.timers import stage
from . import fl_torch
from . import rl_cuda as kern
from .fl_torch import _to_device

RUN_CAP = kern.RUN_CAP


def _constant_container(c: int, n: int):
    """ceil(n/255) runs of 255 (the last holds the rest) of the byte c."""
    runs = -(-n // RUN_CAP)
    counts = np.full(runs, RUN_CAP, np.uint8)
    counts[-1] = n - RUN_CAP * (runs - 1)
    return counts, np.full(runs, c, np.uint8)


def _piece_head(chunk: np.ndarray, prev: int, d0: int) -> int:
    """Bytes of ``chunk`` before its first piece start (its size or more
    if none starts in it), given the carry: they extend the piece left
    open by the chunks before.  At most 254, so only a prefix is read."""
    if prev < 0 or int(chunk[0]) != prev or d0 % RUN_CAP == 0:
        return 0
    cap = RUN_CAP - d0 % RUN_CAP
    differ = np.flatnonzero(chunk[:cap] != prev)
    return int(differ[0]) if differ.size else cap


def encode(data, *, device: str | torch.device):
    """u8 bytes → ``(counts u8[R], values u8[R])``, byte-identical to
    ``rl_numpy.encode`` and to the JAX package's ``rl`` and ``rl-cpu``."""
    data = np.asarray(data, np.uint8).reshape(-1)
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    with stage(span="flrl.host.probe"):
        c = constant_byte_probe(data)
    if c is not None:
        with stage("Compression", n, span="flrl.host.out"):
            return _constant_container(c, n)
    return encode_walk(data, device)


def encode_walk(data: np.ndarray, device: str | torch.device):
    """The chunk walk of :func:`encode`, with no host closed form:
    ``(counts, values)`` of ``data`` through the kernels, in chunks of at
    most ``fl_torch.MAX_DEVICE_CHUNK`` bytes, each copied to the device,
    encoded with the carry of the chunk before it and, if it starts a
    run, its counts and values copied back.  Each part's last count is
    closed with the next piece start, in whichever later chunk it falls,
    or with the stream's end."""
    n = data.size
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    device = torch.device(device)
    cap = fl_torch.MAX_DEVICE_CHUNK
    parts = []
    prev, d0 = -1, 0
    open_len = 0          # bytes so far of the last piece of parts[-1]
    for off in range(0, n, cap):
        chunk = data[off:off + cap]
        open_len += min(_piece_head(chunk, prev, d0), chunk.size)
        with stage("Copy input data to device", chunk.size,
                   span="flrl.h2d.pageable", on=device):
            x = _to_device(chunk, device)
        with stage("Compression", chunk.size, span="flrl.kernels",
                   on=x.device):
            values_d, counts_d, run_start = kern.encode_chunk(x, prev, d0)
        if len(counts_d):
            if parts:
                parts[-1][0][-1] = open_len
            with stage("Copy results to CPU", span="flrl.d2h.pageable") as t:
                counts = counts_d.cpu().numpy()
                values = values_d.cpu().numpy()
                if t:
                    t.add_transfer_size(counts.size + values.size)
            parts.append((counts, values))
            open_len = int(counts[-1])
        prev, d0 = int(chunk[-1]), chunk.size - run_start
    parts[-1][0][-1] = open_len
    if len(parts) == 1:
        return parts[0]
    with stage(span="flrl.host.join"):
        return (np.concatenate([c for c, _ in parts]),
                np.concatenate([v for _, v in parts]))


# The device-level encode is the kernel's own wrapper: one
# ``flrl_rl_encode`` launch with no carry, at most 2^30 bytes, the counts
# past the runs zero, nothing read back.
encode_device = kern.encode_device


def decode_device(counts: torch.Tensor, values: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The n decoded bytes u8[n] of the runs ``counts``/``values`` u8[R] on
    their device: ``flrl_rl_run_offsets`` and ``flrl_rl_expand``, nothing
    read back.  The counterpart of ``rl_jax.rl_decode_device`` with ``n``
    for its ``out_pad``; it takes no ``num_runs``: every run is expanded,
    so runs past the stream's must have zero counts, as
    ``encode_device`` leaves them.  Bytes past the runs' end, where n
    is larger, are unspecified."""
    return kern.expand(counts, values, kern.run_offsets(counts), n)


def starts_counts(packed: torch.Tensor, total, n: int):
    """``(counts u8[m], values u8[m])`` of the starts stream ``packed``
    int32[m] (``value | (start & 0xFF) << 8`` a piece, ``total`` of them,
    an int or a one-element tensor on its device) of an n-byte stream:
    each count the next piece's start less its own mod 256, the last one
    from n, and zero counts at and past ``total``.  A few passes on the
    device, in bytes where they can be: nothing is read back."""
    m = packed.numel()
    dev = packed.device
    if m == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.uint8, device=dev))
    total = torch.as_tensor(total, device=dev).reshape(1).to(torch.int64)
    # bytes 0 and 1 of each little-endian int32: the value and the start
    b = packed.reshape(-1).contiguous().view(torch.uint8).view(m, 4)
    s8 = b[:, 1]
    counts = torch.empty(m, dtype=torch.uint8, device=dev)
    torch.sub(s8[1:], s8[:-1], out=counts[:-1])     # wraps mod 256
    counts[-1:] = 0
    last = (total - 1).clamp_(min=0)
    counts.scatter_(0, last, (n & 0xFF) - s8.gather(0, last))
    counts.masked_fill_(
        torch.arange(m, dtype=torch.int32, device=dev) >= total, 0)
    return counts, b[:, 0].contiguous()


def decode_starts(packed: torch.Tensor, total, n: int) -> torch.Tensor:
    """The n bytes u8[n] of the starts stream ``packed`` with ``total``
    pieces (see :func:`starts_counts`): the counts by a few tensor passes,
    then ``flrl_rl_run_offsets`` and ``flrl_rl_expand`` over every entry
    (those at and past ``total`` expand to nothing).  The counterpart of
    ``rl_decode_packed_v2`` of ``experiments/exp30_rl_starts.py``."""
    counts, values = starts_counts(packed, total, n)
    return decode_device(counts, values, n)


def _block_ends(counts: np.ndarray) -> np.ndarray:
    """Output offset after each block of 4096 runs (the last is the
    output size): 8 bytes per 4096 runs, not per run."""
    B = kern.TILE
    full = counts.size // B * B
    with stage(span="flrl.host.split"):
        sums = counts[:full].reshape(-1, B).sum(1, dtype=np.int64)
        if full < counts.size:
            sums = np.append(sums, counts[full:].sum(dtype=np.int64))
        return np.cumsum(sums)


def _run_chunks(counts: np.ndarray, block_end: np.ndarray, cap: int):
    """``(r0, r1, o0, o1)`` per decode chunk: runs r0..r1 write output
    bytes o0..o1, o1 - o0 ≤ cap unless one run alone is longer.  The
    block ends find each split; only the block it falls in is summed run
    by run."""
    r = counts.size
    r0 = o0 = 0
    while r0 < r:
        with stage(span="flrl.host.split"):
            r1, o1 = _run_split(counts, block_end, r0, o0, o0 + cap)
        yield r0, r1, o0, o1
        r0, o0 = r1, o1


def _run_split(counts: np.ndarray, block_end: np.ndarray, r0: int, o0: int,
               limit: int) -> tuple[int, int]:
    """The next split of :func:`_run_chunks` after run r0 (output byte o0):
    the last run r1 and output byte o1 with o1 ≤ ``limit``, at least one
    run past r0."""
    r = counts.size
    B = kern.TILE
    b = int(np.searchsorted(block_end, limit, side="right"))
    if b == block_end.size:
        return r, int(block_end[-1])
    lo, base = b * B, int(block_end[b - 1]) if b else 0
    if lo < r0:
        lo, base = r0, o0
    ends = base + np.cumsum(counts[lo:min(lo + B, r)], dtype=np.int64)
    k = int(np.searchsorted(ends, limit, side="right"))
    r1, o1 = lo + k, int(ends[k - 1]) if k else base
    if r1 == r0:                       # one run longer than cap
        r1, o1 = r0 + 1, o0 + int(counts[r0])
    return r1, o1


def decode(counts, values, *, device: str | torch.device) -> np.ndarray:
    """Container → u8[Σ counts].  Rejects counts and values of different
    lengths before any device work."""
    counts = np.asarray(counts, np.uint8).reshape(-1)
    values = np.asarray(values, np.uint8).reshape(-1)
    if counts.size != values.size:
        raise ValueError("rl decode: corrupt container (counts/values size "
                         f"mismatch: {counts.size} != {values.size})")
    if counts.size == 0:
        return np.zeros(0, np.uint8)
    block_end = _block_ends(counts)
    n = int(block_end[-1])
    with stage(span="flrl.host.probe"):
        c = constant_byte_probe(values)
        constant = c is not None and bool((counts[:-1] == RUN_CAP).all())
    if constant:
        with stage("Decompression", n, span="flrl.host.out"):
            return np.full(n, c, np.uint8)
    return decode_walk(counts, values, device, block_end)


def decode_walk(counts: np.ndarray, values: np.ndarray,
                device: str | torch.device,
                block_end: np.ndarray | None = None,
                out: np.ndarray | None = None) -> np.ndarray:
    """The chunk walk of :func:`decode`, with no host closed form: the
    Σ counts bytes of the runs, in the chunks of :func:`_run_chunks` (at
    most ``fl_torch.MAX_DEVICE_CHUNK`` bytes of output, at least one run),
    each chunk's runs copied to the device, expanded by the kernels and
    its output copied straight into its slice of ``out`` (u8[Σ counts])
    where it is given, else of a new array.  ``block_end`` is
    :func:`_block_ends` of ``counts`` where the caller has it."""
    if counts.size == 0:
        return np.zeros(0, np.uint8) if out is None else out
    if block_end is None:
        block_end = _block_ends(counts)
    n = int(block_end[-1])
    if out is None:
        with stage(span="flrl.host.out"):
            out = np.empty(n, np.uint8)
    elif out.shape != (n,) or out.dtype != np.uint8:
        raise ValueError(f"decode_walk: out must be u8[{n}], got "
                         f"{out.dtype}{list(out.shape)}")
    device = torch.device(device)
    for r0, r1, o0, o1 in _run_chunks(counts, block_end,
                                      fl_torch.MAX_DEVICE_CHUNK):
        with stage("Copy input to device", 2 * (r1 - r0),
                   span="flrl.h2d.pageable", on=device):
            c = _to_device(counts[r0:r1], device)
            v = _to_device(values[r0:r1], device)
        with stage("Decompression", o1 - o0, span="flrl.kernels",
                   on=c.device):
            out_d = kern.expand(c, v, kern.run_offsets(c), o1 - o0)
        with stage("Copy results to CPU", o1 - o0,
                   span="flrl.d2h.pageable"):
            torch.from_numpy(out[o0:o1]).copy_(out_d)
    return out
