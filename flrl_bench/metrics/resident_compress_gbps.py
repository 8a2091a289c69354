"""resident_compress_gbps (GB/s, host clock): input bytes of every compress
call of the window over the summed wall of its groups, each call of a
device-resident program followed by a synchronise of every card."""

from flrl_bench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "c", "bytes_in")
