"""decompress_gbps (GB/s, host clock): decoded bytes of every decompress
call of the window over the summed wall of those calls (host files)."""

from flrl_bench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "d", "bytes_out")
