"""d2h_gbps.d (GB/s, device trace): bytes of the device-to-host copies inside
the traced decompress calls' spans over those copies' device time, on
every card; None where no such copy ran."""

from flrl_bench.readers import copy_gbps


def read(run):
    return copy_gbps(run, "d", "DtoH")
