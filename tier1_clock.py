#!/usr/bin/env python3
"""Where the tier-1 test run's clock goes: each file's junit seconds and
the second its first test started.

Load this file as a pytest plugin in the tier-1 command (ROADMAP.md's
"Tier-1 verify" line), with ``TIER1_CLOCK_OUT`` naming its output, e.g.
from the repository root:

    TIER1_CLOCK_OUT=stamps.json python -m pytest tests/ -q -m 'not slow' \\
        -p xdist -n 6 --dist loadfile -p tier1_clock --junitxml=junit.xml

The controller records, for each test, the wall second (from the
plugin's import) at which a worker started it and at which its teardown
was reported, and writes them with the run's wall.  Then

    python3 tier1_clock.py junit.xml stamps.json

prints one JSON object: the wall, the passed and skipped counts, the
junit seconds of each port file (``tests/test_torch_*.py``;
``tests/test_torch_resume.py`` is a JAX test and is counted apart) and
their total, and each file's first start, ``tests/test_train_loop.py``'s
(the suite's longest file) among them.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time
import xml.etree.ElementTree as ET

_T0 = time.time()
_ROWS: list = []


def pytest_runtest_logstart(nodeid, location):
    _ROWS.append(("start", nodeid, time.time() - _T0))


def pytest_runtest_logreport(report):
    if report.when == "teardown":
        _ROWS.append(("end", report.nodeid, time.time() - _T0))


def pytest_sessionfinish(session):
    path = os.environ.get("TIER1_CLOCK_OUT")
    if path and not os.environ.get("PYTEST_XDIST_WORKER"):
        with open(path, "w") as f:
            json.dump({"wall": time.time() - _T0, "rows": _ROWS}, f)


def summary(junit: str, stamps: str) -> dict:
    """The run's clock from its junit XML and this plugin's stamps."""
    seconds = collections.defaultdict(float)
    outcomes = collections.Counter()
    for case in ET.parse(junit).getroot().iter("testcase"):
        name = next(part for part in case.get("classname", "").split(".")
                    if part.startswith("test_")) + ".py"
        seconds[name] += float(case.get("time", 0))
        kinds = {child.tag for child in case}
        outcomes["skipped" if "skipped" in kinds else
                 "failed" if kinds & {"failure", "error"} else "passed"] += 1
    with open(stamps) as f:
        clock = json.load(f)
    starts: dict = {}
    for kind, nodeid, at, *_ in clock["rows"]:
        if kind == "start":
            starts.setdefault(os.path.basename(nodeid.split("::")[0]), at)
    port = {name: t for name, t in sorted(
        seconds.items(), key=lambda item: -item[1])
        if name.startswith("test_torch_") and name != "test_torch_resume.py"}
    return {"wall_s": round(clock["wall"], 1), **outcomes,
            "junit_s": round(sum(seconds.values()), 1),
            "port_junit_s": round(sum(port.values()), 1),
            "resume_junit_s": round(seconds["test_torch_resume.py"], 1),
            "train_loop_start_s": round(starts.get("test_train_loop.py",
                                                   -1.0), 1),
            "train_loop_junit_s": round(seconds["test_train_loop.py"], 1),
            "port_files": {name: round(t, 1) for name, t in port.items()},
            "starts_s": {name: round(at, 1) for name, at in sorted(
                starts.items(), key=lambda item: item[1])}}


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    print(json.dumps(summary(sys.argv[1], sys.argv[2]), indent=1))
