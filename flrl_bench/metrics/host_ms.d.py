"""host_ms.d (ms, program spans): the union, over every thread, of the
program's ``flrl.host.*`` spans inside the traced decompress calls' spans,
over those calls: the host's own work a call, which the card cannot
overlap.  None where the program has no such span."""

from flrl_bench.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "d", "flrl.host.")
