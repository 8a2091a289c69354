"""device_idle_pct.resident_d (%, device trace): as device_idle_pct.d, for
the traced decompress calls of the device-resident programs."""

from flrl_bench.readers import idle_pct


def read(run):
    return idle_pct(run, "d")
