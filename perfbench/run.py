"""Run one benchmark cell once; see ``perfbench/harness.py``.

    python3 perfbench/run.py --workload cnn-serve-closed8 --seed 1 \
        --seconds 30 --trace 0
"""


def _process_age() -> float:
    """Seconds since this process started (interpreter start-up included),
    from /proc where the system has it, else 0."""
    try:
        import os
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    import sys
    import time
    from pathlib import Path
    started = time.monotonic() - _process_age()
    # the checkout's root in place of this script's directory, whose module
    # names would shadow installed ones
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from perfbench.harness import main
    sys.exit(main(started=started))
