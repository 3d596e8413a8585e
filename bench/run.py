"""Run one cell of the benchmark once: ``python3 bench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout (see ``bench/harness.py``)."""
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root (for ``bench``) and the port's sources, in place of
# this script's own directory
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
