"""``python -m flrl_bench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (see ``run.py``)."""

import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux: its start time in
    /proc/self/stat against the boot clock); 0 where that cannot be read."""
    import os
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


if __name__ == "__main__":
    import sys

    from .run import main
    sys.exit(main(t_start=_T0 - _process_age()))
