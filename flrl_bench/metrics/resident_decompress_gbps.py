"""resident_decompress_gbps (GB/s, host clock): decoded bytes of every
decompress call of the window over the summed wall of its groups, each
call of a device-resident program followed by a synchronise."""

from flrl_bench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "d", "bytes_out")
