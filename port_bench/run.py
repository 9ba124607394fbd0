"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``setup_s`` counts from the process's start,
read from the kernel's record of it, so the interpreter's own start is in it.
"""

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


if __name__ == "__main__":
    t_start = time.perf_counter() - _process_age_s()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from port_bench.harness import main

    sys.exit(main(t_start=t_start))
