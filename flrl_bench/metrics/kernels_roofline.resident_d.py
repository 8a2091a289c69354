"""kernels_roofline.resident_d (%, device trace): as kernels_roofline.d,
for the traced decompress calls of the device-resident programs."""

from flrl_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "d")
