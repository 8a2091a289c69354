"""h2d_gbps.c (GB/s, device trace): bytes of the host-to-device copies inside
the traced compress calls' spans over those copies' device time, on every
card; None where no such copy ran."""

from flrl_bench.readers import copy_gbps


def read(run):
    return copy_gbps(run, "c", "HtoD")
