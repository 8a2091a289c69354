"""kernels_roofline.resident_c (%, device trace): as kernels_roofline.c,
for the traced compress calls of the device-resident programs."""

from flrl_bench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "c")
