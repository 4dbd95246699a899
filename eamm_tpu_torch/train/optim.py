"""Adam with the MultiStep schedule, counted in optimizer steps.

Counterpart of ``eamm_tpu/train/optim.py``: Adam(b1 0.5, b2 0.999, eps
1e-8) whose learning rate is multiplied by ``gamma`` at each milestone
(epochs times ``steps_per_epoch``).  The rate of update number ``n``
(0-based) is ``lr * gamma ** (milestones at or below n)``, as optax's
``piecewise_constant_schedule`` gives it at count ``n``.  The fine-tune's
per-module optimizers (generator; audio_feature and kp_detector_a; any
other module at the default rate) are the param groups of one
``torch.optim.Adam``: each parameter keeps its own moments and step count,
so the update is that of separate optimizers stepped together.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn


def multistep_schedule(base_lr: float, milestones_epochs, gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0-based)."""
    boundaries = sorted({int(m * steps_per_epoch) for m in milestones_epochs})

    def schedule(count: int) -> float:
        return base_lr * gamma ** sum(1 for b in boundaries if b <= count)
    return schedule


class ScheduledAdam:
    """``torch.optim.Adam`` over param groups, each with its own schedule,
    the rate set before every update from the updates made so far."""

    def __init__(self, groups: list[tuple[list, Callable[[int], float]]],
                 b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8):
        groups = [(list(params), sched) for params, sched in groups if params]
        self.schedules = [sched for _, sched in groups]
        self.optimizer = torch.optim.Adam(
            [{"params": params, "lr": sched(0)} for params, sched in groups],
            betas=(b1, b2), eps=eps)
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(self.count)
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["adam"])
        self.count = int(state["count"])


def _params(module: nn.Module) -> list:
    return [p for p in module.parameters() if p.requires_grad]


def make_optimizer(modules: dict, lr: float = 2e-4, b1: float = 0.5,
                   b2: float = 0.999, milestones_epochs=(60, 90),
                   gamma: float = 0.1, steps_per_epoch: int = 1
                   ) -> ScheduledAdam:
    """One schedule over every parameter of ``modules`` ({name: module})."""
    sched = multistep_schedule(lr, milestones_epochs, gamma, steps_per_epoch)
    params = [p for m in modules.values() for p in _params(m)]
    return ScheduledAdam([(params, sched)], b1, b2)


def make_module_optimizer(modules: dict, module_lrs: dict,
                          default_lr: float = 2e-4, b1: float = 0.5,
                          b2: float = 0.999, milestones_epochs=(60, 90),
                          gamma: float = 0.1, steps_per_epoch: int = 1
                          ) -> ScheduledAdam:
    """A schedule per module: ``module_lrs`` {name: lr}, ``default_lr`` for
    the modules it does not name."""
    groups = [(_params(m), multistep_schedule(
                  module_lrs.get(name, default_lr), milestones_epochs, gamma,
                  steps_per_epoch))
              for name, m in modules.items()]
    return ScheduledAdam(groups, b1, b2)
