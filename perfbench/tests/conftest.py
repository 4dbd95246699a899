"""Shared pieces of the benchmark's own tests: tiny widths and traffic at
which a whole run of a cell fits in seconds on the CPU (the kernels'
plain versions).  Run them with ``python -m pytest perfbench/tests``."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"model_params": {
    "kp_detector_params": {"block_expansion": 4, "max_features": 16,
                           "num_blocks": 2},
    "generator_params": {
        "block_expansion": 4, "max_features": 8, "num_bottleneck_blocks": 1,
        "dense_motion_params": {"block_expansion": 4, "max_features": 16,
                                "num_blocks": 2}}}}
F32 = {"precision": {"generator": "float32"}}

CELLS = {
    "cnn-serve-closed8": {
        "server": {"max_batch": 2, "frame_chunk": 8, "time_bucket": 8,
                   "overlap_segments": 1, "segment_frames": None,
                   "stream_policy_frames": None},
        "traffic": {"clients": 2, "identities": 2, "frames": [8, 8]},
        "settle_s": 0.2, "trace": {"after_s": 0.1, "dispatches": 1},
        "check": {"requests": 8}},
    "gan-part1-train": {
        "traffic": {"batch": 2, "frames": 4},
        "trace": {"after_steps": 0, "steps": 1}},
    "cnn-finetune-train": {
        "traffic": {"batch": 2, "frames": 4},
        "train_params": {"scales": [0.25]},
        "trace": {"after_steps": 0, "steps": 1}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips itself without one")


def needs_card():
    """Skip the calling test unless a CUDA device is present (decided when
    the test runs, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU form")


@pytest.fixture
def tiny_run():
    """``tiny_run(cell, seed, trace=0, root=ROOT, config=..., cell_over=...)``
    -> (result, Run) of one CPU run at tiny sizes."""
    import torch
    torch.set_num_threads(4)
    from perfbench import harness

    def go(cell, seed=2 ** 31 + 11, trace=0, root=ROOT, config=None,
           cell_over=None, seconds=1.0):
        args = harness.parse_args(["--workload", cell, "--seed", str(seed),
                                   "--seconds", str(seconds), "--trace",
                                   str(trace)])
        over = harness.merge(CELLS.get(cell, {}), cell_over or {})
        return harness.execute(root, args, "cpu", time.monotonic(),
                               config_override=harness.merge(
                                   TINY, config or {}),
                               cell_override=over)
    return go
