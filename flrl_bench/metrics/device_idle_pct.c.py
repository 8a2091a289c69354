"""device_idle_pct.c (%, device trace): the share of the traced compress
calls' spans (host files) in which a card ran no kernel, copy or memset,
averaged over the run's cards."""

from flrl_bench.readers import idle_pct


def read(run):
    return idle_pct(run, "c")
