"""kernels_roofline.d (%, device trace): the least time the card could
take for the traced decompress calls of host files, their bytes over
3.35 TB/s (the container, then the decoded file, each once), over the summed
time of every kernel and memset on any card inside those calls' spans."""

from flrl_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "d")
