"""Timers, and the constant-stream probe the FL and RL host codecs share
(a copy of ``fl_rl_compression_mpi_tpu.utils.constant_byte_probe``)."""


def constant_byte_probe(data) -> "int | None":
    """Two-stage constant-stream check shared by the FL and RL host
    codecs: probe the first 128 KiB, then (only on a probe hit) verify
    the remainder in bounded 8 MiB chunks with early exit on the first
    mismatch — a multi-GB near-constant input (e.g. a zero-prefixed
    checkpoint shard) never materializes an input-sized boolean
    temporary and never scans past its first non-constant block."""
    if data.size == 0:
        return None
    c = int(data[0])
    probe = min(data.size, 128 << 10)
    if not bool((data[:probe] == c).all()):
        return None
    step = 8 << 20
    for off in range(probe, data.size, step):
        if not bool((data[off:off + step] == c).all()):
            return None
    return c
