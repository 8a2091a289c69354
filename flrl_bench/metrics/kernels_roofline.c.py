"""kernels_roofline.c (%, device trace): the least time the card could
take for the traced compress calls of host files, their bytes over
3.35 TB/s (the file, then its container, each once), over the summed
time of every kernel and memset on any card inside those calls' spans."""

from flrl_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "c")
