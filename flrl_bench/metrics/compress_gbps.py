"""compress_gbps (GB/s, host clock): input bytes of every compress call of
the window over the summed wall of those calls (host files)."""

from flrl_bench.readers import rate_gbps


def read(run):
    return rate_gbps(run, "c", "bytes_in")
