"""What the readers share: the traced window's device operations."""
from __future__ import annotations


def operator_calls(run, op: str) -> list:
    """[(shapes, dtypes, scalar arguments, [device operations])] of each
    call of the program's operator ``op``: the operations launched while
    the call ran, on its thread, by it or by the operators it called."""
    if run.summary is None:
        return []
    out = []
    for start, end, thread, shapes, dtypes, concrete in \
            run.summary.calls.get(op, []):
        ops = [o for o in run.summary.ops if o.thread == thread
               and start <= o.launched <= end]
        out.append((shapes, dtypes, concrete, ops))
    return out


def seconds(ops) -> float:
    return sum(o.end - o.start for o in ops) / 1e9


def idle_share(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
