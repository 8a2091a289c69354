"""file_p90_ms (ms, host clock): the 90th percentile (nearest rank), over
every file of the window, of its round trip: its compress call's wall plus
its decompress call's.  Only where a group is one call (a file a turn);
None with fewer than 20 files, where fewer than two lie beyond it."""

import math


def read(run):
    turns = {}
    for g in run.groups:
        if g.calls != 1:
            return None
        turns.setdefault(g.turn, []).append(g.wall_s)
    trips = sorted(sum(w) for w in turns.values() if len(w) == 2)
    if len(trips) < 20:
        return None
    return trips[math.ceil(0.9 * len(trips)) - 1] * 1e3
