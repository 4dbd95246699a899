"""Training steps: ``train_part1``, ``train_part1_fine_tune`` and
``train_part2``.

Counterpart of ``eamm_tpu/train/steps.py``.  A state holds the models,
which of them train, the optimizer and the step count; BatchNorm
statistics live in the modules and are updated in place, as JAX's
returned ``batch_stats`` are:

- part1: audio_feature (ATNet) and kp_detector_a train against the frozen
  FOMM kp_detector with the keypoint-mimic losses;
- fine-tune: the generator trains too, under the VGG19 perceptual pyramid
  on every 4th frame (``generator: 'audio'`` or ``'visual'``), and with
  both GAN weights non-zero under LSGAN and feature matching against a
  discriminator that trains in its own step right after;
- part2: emo_detector (EmotionK, or EmotionMap for a ``map`` type) alone
  trains, on the augmented ``transformed_driving`` frames and the frozen
  audio keypoints, to make up the residual between the frozen FOMM
  detector's keypoints on the clean frames and the audio ones; its
  BatchNorm statistics move, the frozen modules run under ``no_grad``.

What the modules see, as in JAX's ``train=True`` applies:
- audio_feature and the generator normalize with batch statistics and
  update their running statistics; ``decode`` starts from the statistics
  that ``encode_source`` has just updated (the two calls run in that
  order);
- the frozen kp_detector (and in part2 ATNet and kp_detector_a)
  normalizes with batch statistics and leaves its running statistics as
  they are (``batch_statistics``); its parameters take no gradient;
- the discriminator's power iteration reads the stored ``u``; only its
  own step stores the next one.

The 16-frame window folds into the batch (BN statistics over B*T, the
JAX package's documented deviation from the reference's per-frame loop).
The fine-tune's generator decodes the F supervised frames as one batch of
F*B rows, frame-major (row f*B + b), from the source features tiled F
times, as JAX does.  ``compute_dtype`` bfloat16 runs the forward under
``torch.autocast``; parameters, optimizer state, BatchNorm statistics and
the spectral-norm iteration stay float32, and the keypoint expectation
takes float32 logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
import torch.nn as nn

from eamm_tpu_torch.ops import tps as T
from eamm_tpu_torch.ops.augment import decode_and_augment
from eamm_tpu_torch.ops.motion import inv2x2
from eamm_tpu_torch.train import losses as L
from eamm_tpu_torch.train.optim import ScheduledAdam


@dataclasses.dataclass
class Part1State:
    """models: {'audio_feature', 'kp_detector_a', 'kp_detector',
    'generator', ['vgg'], ['discriminator']}; ``trainable`` names the
    models the optimizer updates; ``disc_optimizer`` is set for the GAN
    fine-tune."""
    models: dict
    trainable: tuple
    optimizer: ScheduledAdam
    step: int = 0
    disc_optimizer: ScheduledAdam | None = None


class Part2State(Part1State):
    """models: {'kp_detector', 'audio_feature', 'kp_detector_a',
    'emo_detector'}; ``trainable`` is ('emo_detector',)."""


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [B*T, ...]"""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def compute_dtype(train_params: dict) -> torch.dtype:
    """``train_params['compute_dtype']``: 'float32' (default) or
    'bfloat16'."""
    name = train_params.get("compute_dtype", "float32")
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _autocast(device: torch.device, dt: torch.dtype):
    return torch.autocast(device.type, dtype=dt,
                          enabled=dt != torch.float32)


@contextlib.contextmanager
def batch_statistics(module: nn.Module):
    """Run ``module`` in training mode (batch statistics, the literal conv
    forms, the heads' heatmap) with its BatchNorm running statistics left
    as they are: the buffers are set aside for the duration."""
    was = module.training
    saved = []
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            saved.append((m, m.running_mean, m.running_var,
                          m.num_batches_tracked))
            m.running_mean = m.running_var = m.num_batches_tracked = None
    module.train()
    try:
        yield module
    finally:
        for m, mean, var, count in saved:
            m.running_mean, m.running_var, m.num_batches_tracked = \
                mean, var, count
        module.train(was)


def init_part1_state(models: dict, make_optimizer: Callable,
                     train_generator: bool = False,
                     make_disc_optimizer: Callable | None = None
                     ) -> Part1State:
    """The part1 state over ``models``: audio_feature and kp_detector_a
    train (and the generator with ``train_generator``); the rest is
    frozen, parameters without gradients.  ``make_optimizer`` takes
    {name: module} of the trainable models; ``make_disc_optimizer`` the
    discriminator's, for the GAN fine-tune."""
    trainable = ("audio_feature", "kp_detector_a") + (
        ("generator",) if train_generator else ())
    for name, m in models.items():
        m.requires_grad_(name in trainable
                         or (name == "discriminator"
                             and make_disc_optimizer is not None))
    disc_opt = None
    if make_disc_optimizer is not None:
        disc_opt = make_disc_optimizer(
            {"discriminator": models["discriminator"]})
    return Part1State(models, trainable,
                      make_optimizer({n: models[n] for n in trainable}),
                      0, disc_opt)


def _loss_options(train_params: dict) -> dict:
    weights = train_params["loss_weights"]
    gen_mode = train_params.get("generator", "not")
    perceptual_w = tuple(weights.get("perceptual", ()))
    return dict(
        weights=weights, gen_mode=gen_mode,
        scales=tuple(train_params.get("scales", (1, 0.5, 0.25, 0.125))),
        perceptual_w=perceptual_w,
        use_perceptual=(gen_mode in ("visual", "audio")
                        and sum(perceptual_w) != 0),
        gan_w=weights.get("generator_gan", 0),
        fm_w=tuple(weights.get("feature_matching", ())),
        dt=compute_dtype(train_params))


def _param_dtype(batch: dict, module: nn.Module) -> dict:
    """The batch's floating entries in the dtype of ``module``'s
    parameters (float32 unless the models were cast)."""
    dt = next(module.parameters()).dtype
    return {k: v.to(dt) if v.is_floating_point() else v
            for k, v in batch.items()}


def part1_loss(state: Part1State, train_params: dict, batch: dict):
    """(total, metrics, gen_out) of one decoded batch (NHWC images
    ``example_image`` [B,H,W,3], ``driving`` [B,T,H,W,3], ``driving_audio``
    [B,T,28,12], ``driving_pose`` [B,T,6]).  ``gen_out`` (the generated
    frame 0 of each sample and its driving keypoints) feeds the
    discriminator step of the GAN fine-tune, else None.  Updates the
    trained models' BatchNorm statistics."""
    o = _loss_options(train_params)
    m = state.models
    batch = _param_dtype(batch, m["audio_feature"])
    device = batch["driving"].device
    B, T = batch["driving"].shape[:2]
    driving = _fold(batch["driving"])
    example = batch["example_image"]
    for name in state.trainable:
        m[name].train()
    gen_out = None
    with _autocast(device, o["dt"]):
        with batch_statistics(m["kp_detector"]) as kp_detector:
            kp_driving = kp_detector(_nchw(driving))
        deco = m["audio_feature"](_nchw(example), batch["driving_audio"],
                                  batch["driving_pose"])
        kp_audio = m["kp_detector_a"](_fold(deco))
        metrics = L.kp_mimic_loss(kp_driving, kp_audio,
                                  o["weights"]["audio"])
        total = sum(metrics.values())
        if o["use_perceptual"]:
            frames = list(range(0, T, 4))
            F = len(frames)
            kp_branch = kp_audio if o["gen_mode"] == "audio" else kp_driving
            with batch_statistics(m["kp_detector"]) as kp_detector:
                kp_source = kp_detector(_nchw(example))
            # row f*B + b of the folded [B*T] arrays is sample b, frame f
            idx = (torch.tensor(frames, device=device)[:, None]
                   + torch.arange(B, device=device)[None, :] * T).reshape(-1)
            kp_f = {k: v[idx] for k, v in kp_branch.items()
                    if k != "heatmap"}

            def tile_f(v):
                return v.repeat((F,) + (1,) * (v.dim() - 1))

            kp_s = {k: tile_f(v) for k, v in kp_source.items()
                    if k != "heatmap"}
            with (contextlib.nullcontext(m["generator"])
                  if "generator" in state.trainable
                  else batch_statistics(m["generator"])) as generator:
                feats = generator.encode_source(_nchw(example))
                prediction = generator.decode(
                    _nchw(tile_f(example)), tile_f(feats), kp_f, kp_s
                ).permute(0, 2, 3, 1)                      # NHWC
            gen_out = {"prediction": prediction[:B],
                       "kp_driving": {k: v[:B] for k, v in kp_f.items()}}
            pyr_real = L.image_pyramid(driving[idx], o["scales"])
            pyr_gen = L.image_pyramid(prediction, o["scales"])
            vgg = m["vgg"]
            metrics["perceptual"] = L.perceptual_loss(
                lambda x: vgg(_nchw(x)), pyr_real, pyr_gen, o["scales"],
                o["perceptual_w"])
            total = total + metrics["perceptual"]
            if o["gan_w"] != 0 and "discriminator" in m:
                disc = m["discriminator"]
                scales = disc.scales
                kp_det = {k: v.detach() for k, v in kp_f.items()}
                fake_out = disc({f"prediction_{s}": _nchw(
                    pyr_gen[f"prediction_{s}"]) for s in scales}, kp_det)
                metrics["gen_gan"] = L.lsgan_generator_loss(
                    fake_out, scales, o["gan_w"])
                metrics["feature_matching"] = torch.zeros((), device=device)
                if sum(o["fm_w"]) != 0:
                    real_out = disc({f"prediction_{s}": _nchw(
                        pyr_real[f"prediction_{s}"]) for s in scales},
                        kp_det)
                    metrics["feature_matching"] = L.feature_matching_loss(
                        real_out, fake_out, scales, o["fm_w"])
                total = total + metrics["gen_gan"] \
                    + metrics["feature_matching"]
    return total, metrics, gen_out


def _metrics_f32(metrics: dict) -> dict:
    """Detached metrics in float32 at least (bfloat16 ones widened,
    float64 ones kept)."""
    return {k: v.detach().to(torch.promote_types(v.dtype, torch.float32))
            for k, v in metrics.items()}


def _accumulate_grads(state, train_params: dict, batch: dict, loss_fn):
    """Gradients of ``loss_fn(state, train_params, decoded batch) ->
    (total, metrics, extra)`` into the trainable parameters' ``.grad``
    (zeroed first) -> (metrics, the last extra).  With ``grad_accum`` K > 1
    the batch's leaves are stacked [K, B_micro, ...]: the gradients are the
    mean over the K micro-batches, each of which starts from the BatchNorm
    statistics the previous one left, and the metrics are their means."""
    state.optimizer.zero_grad()
    k = max(1, int(train_params.get("grad_accum", 1)))
    micro = ([{n: v[i] for n, v in batch.items()} for i in range(k)]
             if k > 1 else [batch])
    sums: dict = {}
    extra = None
    for mb in micro:
        total, metrics, extra = loss_fn(state, train_params,
                                        decode_and_augment(mb))
        (total / k).backward()
        for name, v in _metrics_f32(metrics).items():
            sums[name] = sums.get(name, 0.0) + v
    return {name: v / k for name, v in sums.items()}, extra


def part1_grads(state: Part1State, train_params: dict, batch: dict):
    """Gradients of the part1 loss into the trainable parameters' ``.grad``
    -> (metrics, gen_out), with ``grad_accum`` as ``_accumulate_grads``."""
    return _accumulate_grads(state, train_params, batch, part1_loss)


def make_part1_step(train_params: dict) -> Callable:
    """The part1 / fine-tune step ``(state, batch) -> metrics``: gradients
    (``part1_grads``), one optimizer update, and with a discriminator
    optimizer in the state the discriminator step on the generated frames.
    ``metrics['total']`` sums the generator-side terms."""
    weights = train_params["loss_weights"]
    use_disc = (weights.get("generator_gan", 0) != 0
                and weights.get("discriminator_gan", 0) != 0)
    if use_disc and int(train_params.get("grad_accum", 1)) > 1:
        raise ValueError(
            "grad_accum is not supported for GAN fine-tune: the alternating "
            "discriminator step consumes each micro-batch's generator "
            "output, so accumulation would change the adversarial game")

    def step(state: Part1State, batch: dict) -> dict:
        disc = state.models.get("discriminator")
        gan = state.disc_optimizer is not None
        if gan:
            batch = decode_and_augment(batch)   # once, for both steps
            disc.requires_grad_(False)          # read, not trained, here
        metrics, gen_out = part1_grads(state, train_params, batch)
        state.optimizer.step()
        metrics["total"] = sum(metrics.values())
        if gan:
            disc.requires_grad_(True)
            metrics.update(discriminator_step(state, train_params, batch,
                                              gen_out))
        state.step += 1
        return metrics

    return step


def discriminator_grads(state: Part1State, train_params: dict, batch: dict,
                        generated: dict) -> dict:
    """The LSGAN discriminator loss on the real frame 0 of each sample and
    the generated one (detached), its gradients into the discriminator's
    ``.grad`` (zeroed first), and the next power-iteration vectors stored
    from the weights just differentiated -> {'disc_gan'}."""
    disc = state.models["discriminator"]
    batch = _param_dtype(batch, disc)
    scales = disc.scales
    weight = train_params["loss_weights"]["discriminator_gan"]
    dt = compute_dtype(train_params)
    state.disc_optimizer.zero_grad()
    with _autocast(batch["driving"].device, dt):
        pyr_real = L.image_pyramid(batch["driving"][:, 0], scales)
        pyr_fake = L.image_pyramid(generated["prediction"].detach(), scales)
        kp = {k: v.detach() for k, v in generated["kp_driving"].items()
              if k != "heatmap"}
        real_out = disc({k: _nchw(v) for k, v in pyr_real.items()}, kp)
        fake_out = disc({k: _nchw(v) for k, v in pyr_fake.items()}, kp)
        loss = L.lsgan_discriminator_loss(real_out, fake_out, scales, weight)
    loss.backward()
    disc.update_spectral_norms()
    return {"disc_gan": loss.detach().float()}


def discriminator_step(state: Part1State, train_params: dict, batch: dict,
                       generated: dict) -> dict:
    """``discriminator_grads`` then the discriminator's update."""
    metrics = discriminator_grads(state, train_params, batch, generated)
    state.disc_optimizer.step()
    return metrics


def equivariance_losses(kp_detector: nn.Module, frames: torch.Tensor,
                        kp_driving: dict, tps, value_weight: float,
                        jacobian_weight: float) -> dict:
    """Equivariance of the detector under the random warp ``tps``
    (``ops/tps.TpsParams``, from ``sample_tps`` over
    ``train_params['transform_params']``): the NHWC ``frames`` warped
    (reflection padding), their keypoints detected with batch statistics,
    then kp_driving == warp(kp_warped) (value) and J_d^-1 J_warp J_warped
    == I (jacobian), each an L1 mean times its weight; a zero weight
    leaves its term out.  The shipped configs weight both 0 and no step
    calls it."""
    warped = T.transform_frame(tps, frames)
    with batch_statistics(kp_detector) as detector:
        kp_t = detector(_nchw(warped))
    out = {}
    if value_weight:
        rewarped = T.warp_coordinates(tps, kp_t["value"])
        out["equivariance_value"] = value_weight * torch.mean(
            torch.abs(kp_driving["value"] - rewarped))
    if jacobian_weight:
        jac_t = T.warp_jacobian(tps, kp_t["value"]) @ kp_t["jacobian"]
        value = inv2x2(kp_driving["jacobian"]) @ jac_t
        eye = torch.eye(2, dtype=value.dtype, device=value.device)
        out["equivariance_jacobian"] = jacobian_weight * torch.mean(
            torch.abs(eye - value))
    return out


# train_params['type'] -> the emotion head the step trains
HEAD_BY_TYPE = {"linear_4": "linear", "linear_4_new": "linear_4",
                "linear_10": "linear_10", "linear_np_4": "linear_np_4",
                "linear_np_10": "linear_np_10", "map": "map",
                "map_4": "map_4"}
PART2_FROZEN = ("kp_detector", "audio_feature", "kp_detector_a")


def init_part2_state(models: dict, make_optimizer: Callable,
                     part1_state: Part1State | None = None) -> Part2State:
    """The part2 state over ``models``: emo_detector trains, the other
    three are frozen (taken, weights and statistics, from ``part1_state``
    when given); ``make_optimizer`` takes {'emo_detector': module}."""
    if part1_state is not None:
        for name in PART2_FROZEN:
            models[name].load_state_dict(
                part1_state.models[name].state_dict())
    for name, m in models.items():
        m.requires_grad_(name == "emo_detector")
    return Part2State(models, ("emo_detector",),
                      make_optimizer({"emo_detector": models["emo_detector"]}))


def part2_loss(state: Part2State, train_params: dict, batch: dict):
    """(total, metrics, None) of one decoded MEAD batch (``driving`` and
    ``transformed_driving`` [B,T,H,W,3], ``example_image``,
    ``driving_audio``, ``driving_pose``, ``emotion`` [B]): the frozen
    detector on the clean frames and the audio keypoints under
    ``no_grad`` with batch statistics, emo_detector on the transformed
    frames from the audio keypoints, ``emotion_residual_loss``, and with
    ``smooth`` the second difference over time of the composed (audio +
    emotion) keypoints, neighbours detached.  Updates emo_detector's
    BatchNorm statistics."""
    tp = train_params
    etype = tp.get("type", "linear_4")
    head, ten_kp = HEAD_BY_TYPE[etype], "10" in etype
    weight = tp["loss_weights"]["emo"]
    m = state.models
    batch = _param_dtype(batch, m["emo_detector"])
    device = batch["driving"].device
    B, T = batch["driving"].shape[:2]
    labels = batch["emotion"].long().repeat_interleave(T)
    with _autocast(device, compute_dtype(tp)):
        with torch.no_grad():
            with batch_statistics(m["kp_detector"]) as kp_detector:
                kp_driving = kp_detector(_nchw(_fold(batch["driving"])))
            with batch_statistics(m["audio_feature"]) as audio_feature:
                deco = audio_feature(_nchw(batch["example_image"]),
                                     batch["driving_audio"],
                                     batch["driving_pose"])
            with batch_statistics(m["kp_detector_a"]) as kp_detector_a:
                kp_audio = kp_detector_a(_fold(deco))
        m["emo_detector"].train()
        kp_emo, logits = m["emo_detector"](
            _nchw(_fold(batch["transformed_driving"])), kp_audio["value"],
            kp_audio["jacobian"], head=head)
        metrics = L.emotion_residual_loss(
            kp_driving, kp_audio, kp_emo, logits, labels, weight, ten_kp,
            bool(tp.get("classify", True)))
        total = sum(metrics.values())
        if tp.get("smooth", False):
            idx = range(10) if ten_kp else L.EMO_KP_INDICES

            def composed(key):
                a = kp_audio[key].clone()
                a[:, list(idx)] += kp_emo[key]
                return a.reshape(B, T, *a.shape[1:]).transpose(0, 1)

            def second_diff(x):
                return torch.mean(torch.abs(
                    x[2:] + x[:-2].detach() - 2 * x[1:-1].detach()))

            metrics["loss_smooth"] = (second_diff(composed("value"))
                                      + second_diff(composed("jacobian"))
                                      ) * weight * 100.0 / T
            total = total + metrics["loss_smooth"]
    return total, metrics, None


def part2_grads(state: Part2State, train_params: dict, batch: dict) -> dict:
    """Gradients of the part2 loss into emo_detector's ``.grad`` ->
    metrics, with ``grad_accum`` as ``_accumulate_grads``."""
    return _accumulate_grads(state, train_params, batch, part2_loss)[0]


def make_part2_step(train_params: dict) -> Callable:
    """The part2 step ``(state, batch) -> metrics``: gradients, one
    optimizer update; ``metrics['total']`` sums the terms."""
    def step(state: Part2State, batch: dict) -> dict:
        metrics = part2_grads(state, train_params, batch)
        state.optimizer.step()
        metrics["total"] = sum(metrics.values())
        state.step += 1
        return metrics

    return step


def make_multi_step(step_fn: Callable) -> Callable:
    """``(state, [batches]) -> [metrics]``: K optimizer steps, one after the
    other, in one call (JAX scans them in one device program)."""
    def multi(state, batches):
        return [step_fn(state, b) for b in batches]
    return multi


def stack_host_batches(batches: list) -> dict:
    """Stack K same-shaped host batches -> one [K, ...] batch."""
    import numpy as np
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def to_device(batch: dict, device) -> dict:
    """A host batch of numpy arrays -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}
