"""walk_overlap_pct.d (%, program spans and the device trace): of the time
a card ran a kernel, copy or memset inside the traced decompress calls'
spans, the share during which the FL walk's ``flrl.walk.submit`` span was
open on some thread, averaged over the run's cards: the device work hidden
behind the host's submit of a later chunk.  None where the program has no
``flrl.walk.*`` span."""

from flrl_bench.walk_overlap import overlap_pct


def read(run):
    return overlap_pct(run, "d")
