"""device_idle_pct.resident_c (%, device trace): as device_idle_pct.c, for
the traced compress calls of the device-resident programs."""

from flrl_bench.readers import idle_pct


def read(run):
    return idle_pct(run, "c")
