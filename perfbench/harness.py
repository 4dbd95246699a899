"""The benchmark's harness: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells and the
metrics.  Everything else is found by name under ``perfbench/``:

- ``workloads/<cell>.json``: the configuration, the driver and the
  traffic parameters of the cell, and the limits of its comparison;
- ``configs/<config>.json``: the configuration's sizes, precision and
  flags (the reference YAML's ``model_params`` and ``jaco_net``);
- ``drivers/<driver>.py``: ``run(run)``, which builds the program, warms
  it, measures ``--seconds`` of it and compares what it produced with the
  reference;
- ``metrics/<metric>.py``: ``read(run)``, a per-layer metric from the
  run's spans, counters or trace, or None where there is nothing to read.

A cell, a configuration, a traffic mix or a metric is added by adding
its file and its entry.  The last line on standard output is the result;
the numbers compared for ``correct`` are the last lines on standard
error and the last key of the result.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

from perfbench.tracing import Spans

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "eamm_tpu")


@dataclasses.dataclass
class Run:
    """One run: what the harness hands a driver and a metric reader."""
    root: Path
    name: str
    cell: dict                     # the cell file
    config: dict                   # the configuration file
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float                 # time.monotonic() at the process start
    spans: Spans = dataclasses.field(default_factory=Spans)
    summary: object = None         # tracing.Summary of the traced part
    window_start: float | None = None
    window_s: float | None = None
    attempted: int = 0
    failed: int = 0
    end_to_end: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)  # name: (v, lim)
    memory_peak: int = 0
    facts: dict = dataclasses.field(default_factory=dict)   # for readers

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed on standard error)."""
        self.facts.setdefault("phases", []).append(
            (name, time.monotonic() - self.started))


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics that cell
    ``name`` reports: those listing it under ``workloads``, and the
    end-to-end metrics that list no cells."""
    return [m for m in bench[kind] if name in m.get(
        "workloads", [name] if kind == "end_to_end" else [])]


def load_reader(root: Path, metric: str):
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def prepare(root: Path, workload: str) -> tuple:
    """(BENCHMARK.json, its cell entry, the cell file, the configuration
    file) of ``workload``."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = load_json(root / "perfbench" / "workloads" / f"{workload}.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(root / cfg_entry["file"])
    return bench, entry, cell, config


def set_flags(config: dict) -> None:
    """The configuration's precision flags: TF32 for matrix products and
    cuDNN's convolutions on or off."""
    import torch
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def execute(root: Path, args, device: str, started: float,
            config_override: dict | None = None, cell_override=None,
            calibrate: bool = False) -> tuple:
    """Run cell ``args.workload`` on ``device`` -> (result dict, Run).
    ``config_override`` and ``cell_override`` are merged into the
    configuration and the cell file (the CPU tests' tiny sizes);
    ``calibrate`` has the driver read the control's numbers too."""
    bench, entry, cell, config = prepare(root, args.workload)
    if config_override:
        config = merge(config, config_override)
    if cell_override:
        cell = merge(cell, cell_override)
    set_flags(config)
    run = Run(root, args.workload, cell, config, args.seed, args.seconds,
              bool(args.trace), device, started)
    run.facts["calibrate"] = calibrate
    driver = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    driver.run(run)
    metrics = {}
    if args.trace:
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = load_reader(root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            if m["name"] == "setup_s":
                value = run.window_start - started
            else:
                value = run.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = (run.failed == 0 and bool(run.checks) and all(
        lim is not None and math.isfinite(v) and v <= lim
        for v, lim in run.checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": device_name(device), "count": int(entry["chips"]),
           "memory_peak_bytes": int(run.memory_peak)}
    if args.trace and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
    result = {"correct": correct, "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if args.trace and run.summary is not None:
        from perfbench.tracing import breakdown
        result["breakdown"] = breakdown(run.summary)
    if run.facts.get("diag"):       # what a driver reads of its own run
        result["diag"] = run.facts["diag"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.checks.items()}
    return result, run


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base[k], v) if isinstance(v, dict) and isinstance(
            base.get(k), dict) else v
    return out


def device_name(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return device


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, started: float | None = None) -> int:
    started = time.monotonic() if started is None else started
    args = parse_args(argv)
    # no library may load JAX by itself; the port builds its kernels under
    # build/kernels in the checkout, and any other compiler cache stays
    # there too
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch
    chips = next((w["chips"] for w in load_json(
        ROOT / "BENCHMARK.json")["workloads"] if w["name"] == args.workload),
        1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, run = execute(ROOT, args, "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the benchmark "
              "may not import JAX or the JAX package", file=sys.stderr)
        return 3
    print("phases " + " ".join(f"{n}={t:.2f}" for n, t in
                               run.facts.get("phases", [])), file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
