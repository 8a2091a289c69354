"""idle_host_pct.d (%, program spans and the device trace): of the time a
card ran nothing inside the traced decompress calls' spans, the share during
which one of the program's ``flrl.host.*`` spans was open, averaged over
the run's cards.  None where the program has no such span."""

from flrl_bench.program_spans import idle_pct


def read(run):
    return idle_pct(run, "d", "flrl.host.")
