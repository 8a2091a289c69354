"""gather_ms.c (ms, program spans): the union, over every thread, of the
program's ``flrl.gather.*`` spans (the mesh's card-to-card copies onto the
first card and its one copy down) inside the traced compress calls' spans,
over those calls.  None where the program has no such span."""

from flrl_bench.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "c", "flrl.gather.")
