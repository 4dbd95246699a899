"""Training metrics: averaged text log + TensorBoard-style scalar export.

Covers the reference's Logger.log_iter/log_scores averaged ``log.txt``
(ref:logger.py:29-37,91-103) and its tensorboardX per-loss scalars
(ref:train.py:68,81-86).  Scalars are written both as JSONL (one {"step",
"tag", "value"} per line, trivially greppable) and as native TensorBoard
event files (``train/tbevents.py``, no tensorboardX needed).  The port's
copy of ``eamm_tpu/train/logging.py``.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, log_file_name: str = "log.txt",
                 writes: bool = True):
        """``writes`` False keeps the sums and writes nothing (the ranks
        other than 0 of a distributed run)."""
        self.writes = writes
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.log_path = os.path.join(self.log_dir, log_file_name)
        self.scalar_path = os.path.join(self.log_dir, "scalars.jsonl")
        self.names = None
        self.loss_list = []
        self.epoch = 0
        self._t0 = time.time()
        self._events = None

    @property
    def event_writer(self):
        from eamm_tpu_torch.train.tbevents import EventWriter
        if self._events is None:
            self._events = EventWriter(self.log_dir)
        return self._events

    def log_iter(self, losses: dict):
        losses = {k: float(v) for k, v in losses.items()}
        self.names = list(losses.keys())
        self.loss_list.append(list(losses.values()))

    def write_scalars(self, step: int, losses: dict, prefix: str = "train"):
        if not self.writes:
            return
        with open(self.scalar_path, "a") as f:
            for k, v in losses.items():
                f.write(json.dumps({"step": int(step),
                                    "tag": f"{prefix}/{k}",
                                    "value": float(v)}) + "\n")
        self.event_writer.add_scalars(step, losses, prefix=prefix)
        self.event_writer.flush()

    def log_epoch(self, epoch: int):
        """Averaged per-epoch line, reference format '{epoch}) name - value'
        (ref:logger.py:29-37)."""
        self.epoch = epoch
        if not self.loss_list:
            return
        mean = np.asarray(self.loss_list).mean(axis=0)
        line = "; ".join(f"{name} - {value:.5f}"
                         for name, value in zip(self.names, mean))
        line = f"{str(epoch).zfill(8)}) {line} [{time.time() - self._t0:.0f}s]"
        self.loss_list = []
        if not self.writes:
            return
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)


def read_scalars(path: str) -> dict:
    """scalars.jsonl -> {tag: (steps, values)} arrays."""
    out = defaultdict(lambda: ([], []))
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["tag"]][0].append(rec["step"])
            out[rec["tag"]][1].append(rec["value"])
    return {k: (np.asarray(s), np.asarray(v)) for k, (s, v) in out.items()}
