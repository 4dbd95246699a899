"""Training checkpoints: the whole train state in one ``torch.save`` file.

Counterpart of ``eamm_tpu/train/checkpoint.py`` (which writes orbax
directories): ``ckpt_<step>.pt`` under the manager's directory holds every
model's ``state_dict`` (trainable and frozen, BatchNorm statistics and the
discriminator's spectral-norm vectors included), the optimizers' states
and the step.  A file is written to a temporary name and renamed, so a
reader never sees half of one; the oldest files past ``max_to_keep`` are
removed.
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def state_to_tree(state) -> dict:
    """A ``Part1State`` or ``Part2State`` -> the dict a checkpoint holds
    (tensors on the CPU)."""
    tree = {"models": {name: {k: v.detach().cpu()
                              for k, v in m.state_dict().items()}
                       for name, m in state.models.items()},
            "trainable": list(state.trainable),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step)}
    if state.disc_optimizer is not None:
        tree["disc_optimizer"] = state.disc_optimizer.state_dict()
    return tree


def load_tree(state, tree: dict) -> None:
    """Put a checkpoint's dict back into ``state`` in place: weights,
    statistics, optimizer moments and the step."""
    if list(tree["trainable"]) != list(state.trainable):
        raise ValueError(f"checkpoint trains {tree['trainable']}, this run "
                         f"{list(state.trainable)}")
    for name, m in state.models.items():
        m.load_state_dict(tree["models"][name])
    state.optimizer.load_state_dict(tree["optimizer"])
    if state.disc_optimizer is not None:
        state.disc_optimizer.load_state_dict(tree["disc_optimizer"])
    state.step = int(tree["step"])


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def save(self, step: int, state) -> str:
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state_to_tree(state), tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict | None:
        """The dict saved at ``step`` (the latest when None), or None when
        there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=False)
