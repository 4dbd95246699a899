"""Training steps: ``eamm_tpu_torch.train.steps.make_part1_step`` on
``init_part1_state``, part1 (ATNet and the audio keypoint detector train)
or the fine-tune (the generator too, under the VGG19 perceptual pyramid),
as the cell's ``train_params`` say.

Set-up draws the weights and a ring of ``traffic.ring`` distinct batches
on the device, builds the models and the optimizer as the training loop
does, and drives the state through its first ``check.steps`` steps by
the window's own call on the first batches of the ring, keeping each
step's loss terms, the norm of each leaf's first gradient as Adam got it
(its first moment over 1 - b1 after the first step) and, after the last,
the norm of each leaf's change.  The window runs steps on the ring until
``--seconds`` have passed, then synchronizes; ``train_samples_per_s`` is
the clips of every step over the time to that synchronization.  After it
the peak memory is read and the program freed; the reference follows the
same steps from the same weights on the same batches, and the gaps are
compared with the cell's limits (``check``).

With ``--trace 1`` the profiler records ``trace.steps`` steps from step
``trace.after_steps`` of the window, synchronized at both ends.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from perfbench import flops, traffic, weights
from perfbench.reference import nets as R
from perfbench.reference.render import tf32
from perfbench.reference.train import follow
from perfbench.tracing import Trace

B1 = 0.5                    # Adam's b1 in the reference YAMLs


def build_state(run, state_dicts: dict):
    from eamm_tpu_torch import config as C
    from eamm_tpu_torch.models.vgg import Vgg19
    from eamm_tpu_torch.train import steps as S
    from eamm_tpu_torch.train.optim import make_module_optimizer, make_optimizer
    tp = run.cell["train_params"]
    fine_tune = tp.get("generator", "not") == "audio"
    models = {"generator": C.build_generator(run.config),
              "kp_detector": C.build_kp_detector(run.config),
              "kp_detector_a": C.build_kp_detector_a(run.config),
              "audio_feature": C.build_atnet(run.config)}
    if fine_tune:
        models["vgg"] = Vgg19()
    for name, m in models.items():
        m.load_state_dict(state_dicts[name])
    models = {n: m.to(run.device) for n, m in models.items()}
    sched = dict(milestones_epochs=tp["epoch_milestones"],
                 steps_per_epoch=int(run.cell["steps_per_epoch"]))
    lr = float(tp["lr_audio_feature"])
    if fine_tune:
        def make_opt(modules):
            return make_module_optimizer(
                modules, {"generator": float(tp["lr_generator"]),
                          "audio_feature": lr, "kp_detector_a": lr},
                default_lr=lr, **sched)
    else:
        def make_opt(modules):
            return make_optimizer(modules, lr=lr, **sched)
    state = S.init_part1_state(models, make_opt, train_generator=fine_tune)
    return state, S.make_part1_step(tp), S


def leaves(state) -> dict:
    return {f"{n}.{k}": p for n in state.trainable
            for k, p in state.models[n].named_parameters()}


def instrument(run, S, state):
    """Spans around the step's loss (forward) and optimizer calls."""
    loss = S.part1_loss
    step = state.optimizer.step

    def timed_loss(*a, **k):
        with run.spans("loss"):
            return loss(*a, **k)

    def timed_step():
        with run.spans("optimizer"):
            return step()

    S.part1_loss = timed_loss
    state.optimizer.step = timed_step
    return lambda: setattr(S, "part1_loss", loss)


def program_steps(run, state, step, ring, n: int) -> dict:
    """The first ``n`` steps of ``state`` by the window's call, with the
    readings the reference is held to."""
    params = leaves(state)
    start = {k: p.detach().clone() for k, p in params.items()}
    out = {"losses": []}
    for i in range(n):
        with run.spans("step", "setup"):
            metrics = step(state, ring[i % len(ring)])
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            adam = state.optimizer.optimizer.state    # empty: no update
            out["first_grad"] = {
                k: float(adam[p]["exp_avg"].norm()) / (1 - B1)
                if "exp_avg" in adam.get(p, {}) else 0.0
                for k, p in params.items()}
    out["change"] = {k: float((p.detach() - start[k]).norm())
                     for k, p in params.items()}
    return out


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative gap of the total
    loss; by the worst leaf, the gap between the program's and the
    reference's norms of the first gradient and of the change over the
    steps, each over the larger of that leaf's and the median leaf's
    reference norm.  Leaves whose reference gradient is under a thousandth
    of the median leaf's move by rounding alone and are left out of the
    change."""
    each = [abs(p["total"] - r["total"]) / abs(r["total"])
            for p, r in zip(prog["losses"], ref["losses"])]
    g_ref = ref["first_grad"]
    med_g = statistics.median(g_ref.values())
    grads = {k: abs(prog["first_grad"][k] - v) / max(v, med_g)
             for k, v in g_ref.items()}
    grad = max(grads.values())
    kept = [k for k, v in g_ref.items() if v >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in kept)
    change = {k: abs(prog["change"][k] - ref["change"][k])
              / max(ref["change"][k], med_c) for k in kept}
    worst = max(change, key=change.get)
    return {"loss_gap": max(each), "loss_gap_first": each[0],
            "grad_gap": grad, "grad_gap_median": statistics.median(
                grads.values()), "grad_gap_leaf": max(grads, key=grads.get),
            "change_gap": change[worst],
            "change_gap_median": statistics.median(change.values()),
            "change_gap_leaf": worst}


def reference(run, sds: dict, ring: list, n: int, control: bool = False):
    """The reference's ``n`` steps from the drawn weights (TF32 with
    ``control``)."""
    tp = run.cell["train_params"]
    nets = R.loaded(run.config, sds)
    trainable = ("audio_feature", "kp_detector_a")
    if tp.get("generator", "not") == "audio":
        trainable += ("generator",)
    with tf32(control):
        return follow(nets, trainable, ring[:n], tp,
                      float(tp["lr_audio_feature"]))


def run(run):
    cell, cfg, dev = run.cell, run.config, run.device
    tp = cell["train_params"]
    run.phase("imports")
    ring = traffic.batches(cell["traffic"], run.seed, dev)
    sds = weights.draw(cfg, run.seed, dev, cell["trained"],
                       with_vgg=tp.get("generator", "not") == "audio")
    run.phase("inputs_weights")
    if dev == "cuda":           # the peak from here on is the program's
        torch.cuda.reset_peak_memory_stats()
    state, step, S = build_state(run, sds)
    run.phase("state")
    restore = instrument(run, S, state)
    n_check = int(cell["check"]["steps"])
    prog = program_steps(run, state, step, ring, n_check)
    run.phase("first_steps")
    batch = int(cell["traffic"]["batch"])
    run.facts["step_flops"] = flops.train_step(
        cfg, tp, batch, int(cell["traffic"]["frames"]))
    run.phase("flops")
    trace = Trace() if run.trace else None
    tc = cell.get("trace", {})
    totals = []
    if dev == "cuda":
        torch.cuda.synchronize()
    run.window_start = t0 = time.monotonic()
    i = 0
    while time.monotonic() < t0 + run.seconds:
        if trace is not None and i == tc.get("after_steps", 2):
            trace.start()
        with run.spans("step", "traced" if trace is not None
                       and trace.prof is not None else "window"):
            metrics = step(state, ring[(n_check + i) % len(ring)])
        totals.append(metrics["total"])
        i += 1
        if trace is not None and trace.prof is not None and \
                i == tc.get("after_steps", 2) + tc.get("steps", 3):
            trace.stop()
    if trace is not None and trace.prof is not None:
        trace.stop()
    if dev == "cuda":
        torch.cuda.synchronize()
    run.window_s = time.monotonic() - t0
    run.memory_peak = (torch.cuda.max_memory_allocated() if dev == "cuda"
                       else 0)
    restore()
    finite = torch.isfinite(torch.stack(totals)) if totals else None
    run.attempted = i
    run.failed = 0 if finite is None else int((~finite).sum())
    run.end_to_end["train_samples_per_s"] = batch * i / run.window_s
    run.facts["steps"] = i
    if trace is not None:
        trace.summarize()
        run.summary = trace.summary

    del state, step, totals
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    ref = reference(run, sds, ring, n_check)
    if run.facts.get("calibrate"):
        run.facts["control"] = gaps(
            reference(run, sds, ring, n_check, control=True), ref)
        half = [{k: v[:batch // 2] for k, v in b.items()} for b in ring]
        run.facts["fault_half_batch"] = gaps(
            reference(run, sds, half, n_check), ref)
    found = gaps(prog, ref)
    run.facts["gaps"] = found
    for name, limit in cell["check"]["limits"].items():
        run.checks[name] = (found[name], limit)
