"""The readings the limits of ``correct`` are set from, on the card, in
one process: for each seed, a run of the cell (a short window at the
cell's own load) with the program's numbers, and beside them the
control's (the reference in the next precision down: the decode computed
in fp8 and the keypoint networks in TF32 for a render; TF32 for training)
and, for training, the fault of half of each batch left out (the
reference on the first half, held to the reference on the whole).

    python3 perfbench/calibrate.py --workload gan-part1-train \
        --seeds 12 --first-seed 2147483700 --seconds 2

Prints one JSON line a seed; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # the checkout's root in place of this script's directory, whose module
    # names would shadow installed ones
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from perfbench import harness
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA device")
    for i in range(a.seeds):
        seed = a.first_seed + 7919 * i
        args = harness.parse_args(["--workload", a.workload, "--seed",
                                   str(seed), "--seconds", str(a.seconds),
                                   "--trace", "0"])
        t0 = time.monotonic()
        _, run = harness.execute(harness.ROOT, args, "cuda", t0,
                                 calibrate=True)
        line = {"seed": seed, "program": {k: v for k, (v, _) in
                                           run.checks.items()},
                "gaps": run.facts.get("gaps"),
                "worst_frame_block_abs": run.facts.get(
                    "worst_frame_block_abs"),
                "yardstick_block_abs": run.facts.get("yardstick_block_abs"),
                "control": run.facts.get("control"),
                "fault_half_batch": run.facts.get("fault_half_batch"),
                "attempted": run.attempted, "failed": run.failed,
                "end_to_end": run.end_to_end,
                "seconds": time.monotonic() - t0}
        print(json.dumps(line), flush=True)
