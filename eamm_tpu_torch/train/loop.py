"""Training orchestration: ``train_part1``, ``train_part1_fine_tune`` and
``train_part2``.

Counterpart of ``eamm_tpu/train/loop.py``: dataset -> repeater -> loader
-> per-step optimize, metrics flushed every ``log_every`` steps, a
checkpoint every 500 steps (part2: 1000; epochs at ``checkpoint_freq``),
at ``max_steps`` and at the end, resume from the latest checkpoint, the
SIGTERM/SIGINT emergency checkpoint at the next step boundary,
``grad_accum`` (K loader batches per optimizer step) or
``steps_per_dispatch`` (K steps per call), and the per-epoch held-out
loss when the test split exists.  Frozen weights come from the
reference's ``.pth.tar`` files (``load_frozen_torch``).  With every
checkpoint of a part1 mode, the first sample goes through the generator
into a diagnostic image (``train/visualizer.py``), which never stops
training.

Inside a distributed run (``parallel/mesh.py``: one process per device,
the group joined before ``train`` is called) each rank loads its own
slice of the batch stream (``batch_size`` is per process, as JAX's is per
host), every rank takes the same number of batches an epoch, the models'
BatchNorm layers take their statistics over the global batch
(``sync_batchnorm``), the ranks' model states are checked equal once they
are drawn and loaded, the steps all-reduce their gradients, and the
metrics are averaged over the ranks; rank 0 alone writes the checkpoints,
the logs, the TensorBoard events and the visualizer's images (with its own
batch statistics), the others waiting at a barrier.
"""
from __future__ import annotations

import itertools
import os
import signal
import warnings

import numpy as np
import torch

from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.data.datasets import (AudioDataset, DataLoader,
                                          DatasetRepeater, MeadDataset,
                                          VoxDataset)
from eamm_tpu_torch.models.discriminator import MultiScaleDiscriminator
from eamm_tpu_torch.models.vgg import Vgg19
from eamm_tpu_torch.ops.augment import decode_and_augment
from eamm_tpu_torch.ops.warp import grid_sample, resize_bilinear
from eamm_tpu_torch.parallel.mesh import (all_reduce_mean, any_rank, barrier,
                                          check_replicated, is_distributed,
                                          local_statistics, rank_and_size,
                                          sync_batchnorm)
from eamm_tpu_torch.train import steps as S
from eamm_tpu_torch.train.steps import _nchw, batch_statistics
from eamm_tpu_torch.train.checkpoint import CheckpointManager, load_tree
from eamm_tpu_torch.train.logging import MetricsLogger
from eamm_tpu_torch.train.optim import make_module_optimizer, make_optimizer
from eamm_tpu_torch.train.visualizer import Visualizer

PART1_MODES = ("train_part1", "train_part1_fine_tune")
MODES = PART1_MODES + ("train_part2",)
# the reference's checkpoint intervals, in steps
SAVE_EVERY_STEPS = {"train_part1": 500, "train_part1_fine_tune": 500,
                    "train_part2": 1000}
DATASETS = {"LRW": AudioDataset, "Vox": VoxDataset, "MEAD": MeadDataset}


def build_dataset(config: dict, is_train: bool = True):
    """The dataset ``dataset_params`` names (LRW when it names none)."""
    dp = dict(config["dataset_params"])
    dataset_cls = DATASETS.get(dp.pop("name", "LRW"), AudioDataset)
    return dataset_cls(root_dir=dp.pop("root_dir"),
                       frame_shape=tuple(dp.pop("frame_shape",
                                                (256, 256, 3))),
                       id_sampling=dp.pop("id_sampling", False),
                       is_train=is_train,
                       augmentation_params=dp.pop("augmentation_params", {}),
                       **{k: v for k, v in dp.items()
                          if k in ("video_list", "neutral_dict",
                                   "device_augmentation")})


def build_discriminator(config: dict) -> MultiScaleDiscriminator:
    mp = config["model_params"]
    d, common = mp["discriminator_params"], mp["common_params"]
    return MultiScaleDiscriminator(
        scales=tuple(d.get("scales", (1,))),
        num_channels=common.get("num_channels", 3),
        block_expansion=d["block_expansion"],
        max_features=d["max_features"], num_blocks=d["num_blocks"],
        sn=d.get("sn", False), use_kp=d.get("use_kp", False),
        num_kp=common["num_kp"])


def build_models(config: dict, mode: str, use_gan: bool = False,
                 seed: int = 0, device="cuda") -> dict:
    """The mode's models, drawn from ``seed`` on the CPU (the Jacobian
    heads at the reference's identity initialization), then moved to
    ``device``.  Part1 holds the generator, both detectors and ATNet, the
    fine-tune adds VGG19 and, with GAN, the discriminator; part2 holds
    both detectors, ATNet and emo_detector (EmotionK, or EmotionMap for a
    ``map`` type)."""
    torch.manual_seed(seed)
    models = {} if mode == "train_part2" else {
        "generator": cfg.build_generator(config)}
    models.update(kp_detector=cfg.build_kp_detector(config),
                  kp_detector_a=cfg.build_kp_detector_a(config),
                  audio_feature=cfg.build_atnet(config))
    if mode == "train_part2":
        kind = config["train_params"].get("type", "linear_4").split("_")[0]
        models["emo_detector"] = cfg.build_emotion_detector(config, kind)
    for m in models.values():
        if hasattr(m, "reset_jacobian"):
            m.reset_jacobian()
    if mode == "train_part1_fine_tune":
        models["vgg"] = Vgg19()
        if use_gan:
            models["discriminator"] = build_discriminator(config)
    return {name: m.to(device) for name, m in models.items()}


def load_frozen_torch(models: dict, fomm_checkpoint: str | None = None,
                      audio_checkpoint: str | None = None) -> None:
    """Weights from the reference's checkpoints: the FOMM file's
    kp_detector and generator (where the models hold one) and
    discriminator (when the GAN fine-tune has one and the file carries
    it), the audio file's audio_feature (without the other ``jaco_net``'s
    decoder, ``compat.ATNET_UNUSED``) and kp_detector_a."""
    from eamm_tpu_torch.compat import (load_torch_checkpoint, split_unused,
                                       strip_prefix, unused_prefixes)
    if fomm_checkpoint:
        fomm = load_torch_checkpoint(fomm_checkpoint)
        for name in ("generator", "kp_detector"):
            if name in models:
                models[name].load_state_dict(strip_prefix(fomm[name]))
        if "discriminator" in models and "discriminator" in fomm:
            models["discriminator"].load_reference(
                strip_prefix(fomm["discriminator"]))
    if audio_checkpoint:
        audio = load_torch_checkpoint(audio_checkpoint)
        for name in ("audio_feature", "kp_detector_a"):
            sd, _ = split_unused(strip_prefix(audio[name]), models[name],
                                 unused_prefixes(name, models[name]))
            models[name].load_state_dict(sd)


def _check_options(tp: dict) -> tuple[int, int]:
    k_accum = max(1, int(tp.get("grad_accum", 1)))
    spd = max(1, int(tp.get("steps_per_dispatch", 1)))
    if k_accum > 1 and spd > 1:
        raise ValueError("grad_accum and steps_per_dispatch cannot be "
                         "combined (pick one dispatch-amortization axis)")
    return k_accum, spd


def _device_f32(x, device) -> torch.Tensor:
    """A host array on ``device`` in float32 ([0, 1] for uint8 frames)."""
    t = torch.as_tensor(np.asarray(x)).to(device)
    return t.float() * np.float32(1.0 / 255.0) if t.dtype == torch.uint8 \
        else t.float()


def visualize_checkpoint(state, batch_host: dict, path: str,
                         visualizer: Visualizer, device) -> str | None:
    """The checkpoint's diagnostic image of the first sample of a host
    batch: kp_detector on its example image (the source) and first
    driving frame, the generator from the source to that frame, both in
    training mode with batch statistics (their running ones untouched),
    the panels written to ``path``.  None, and nothing written, when the
    state holds no generator or no kp_detector (part2)."""
    m = state.models
    if "generator" not in m or "kp_detector" not in m:
        return None
    dt = next(m["generator"].parameters()).dtype
    src = _device_f32(batch_host["example_image"][:1], device).to(dt)
    drv = _device_f32(batch_host["driving"][:1, 0], device).to(dt)
    with torch.no_grad(), batch_statistics(m["kp_detector"]) as detector, \
            batch_statistics(m["generator"]) as generator:
        kp_s = {k: v for k, v in detector(_nchw(src)).items()
                if k != "heatmap"}
        kp_d = {k: v for k, v in detector(_nchw(drv)).items()
                if k != "heatmap"}
        aux: dict = {}
        prediction = generator.decode(
            _nchw(src), generator.encode_source(_nchw(src)), kp_d, kp_s,
            aux=aux)
        deformed = grid_sample(src, resize_bilinear(aux["deformation"],
                                                    src.shape[1:3]))
    out = {"prediction": prediction.permute(0, 2, 3, 1),
           "deformed": deformed,
           "mask": aux["mask"].permute(0, 2, 3, 1),
           "sparse_deformed": aux["sparse_deformed"],
           "kp_source": kp_s, "kp_driving": kp_d}
    if "occlusion_map" in aux:
        out["occlusion_map"] = aux["occlusion_map"].permute(0, 2, 3, 1)
    out = {k: ({n: t.float().cpu().numpy() for n, t in v.items()}
               if isinstance(v, dict) else v.float().cpu().numpy())
           for k, v in out.items()}
    return visualizer.save(path, drv.float().cpu().numpy(),
                           src.float().cpu().numpy(), out)


def train(config: dict, mode: str, log_dir: str, checkpoint: str | None = None,
          max_steps: int | None = None, seed: int = 0,
          vgg_state_dict=None, fomm_checkpoint: str | None = None,
          audio_checkpoint: str | None = None, device="cuda"):
    """Train in ``mode`` ('train_part1' | 'train_part1_fine_tune' |
    'train_part2') on ``device``; returns the final state
    (``Part1State`` or ``Part2State``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    device = torch.device(device)
    tp = config["train_params"]
    k_accum, spd = _check_options(tp)
    weights = tp.get("loss_weights", {})
    use_gan = (mode == "train_part1_fine_tune"
               and weights.get("discriminator_gan", 0) != 0
               and weights.get("generator_gan", 0) != 0)
    step_fn = (S.make_part2_step(tp) if mode == "train_part2"
               else S.make_part1_step(tp))     # refuses grad_accum with GAN

    rank, world = rank_and_size()
    dataset = build_dataset(config, is_train=True)
    repeated = DatasetRepeater(dataset, tp.get("num_repeats", 1))
    loader = DataLoader(repeated, batch_size=tp["batch_size"], seed=seed,
                        shard=(rank, world) if world > 1 else None)
    # every rank takes as many batches an epoch (the collectives pair up)
    per_epoch = len(repeated) // tp["batch_size"] // world
    # the schedule counts optimizer steps: K loader batches make one
    steps_per_epoch = max(1, per_epoch // k_accum)
    sched = dict(milestones_epochs=tp.get("epoch_milestones", (60, 90)),
                 steps_per_epoch=steps_per_epoch)
    lr_audio = float(tp.get("lr_audio_feature", 2e-4))

    models = build_models(config, mode, use_gan, seed, device)
    if is_distributed():            # at every world size, 1 included
        for m in models.values():
            sync_batchnorm(m)
    if "vgg" in models:
        if vgg_state_dict is None:
            warnings.warn(
                "fine-tune perceptual loss is using RANDOM VGG19 features; "
                "pass --vgg_checkpoint (torchvision vgg19 state_dict) for "
                "reference-parity quality")
        else:
            models["vgg"].load_torchvision(vgg_state_dict)
    load_frozen_torch(models, fomm_checkpoint, audio_checkpoint)

    if mode == "train_part1_fine_tune":
        def make_opt(modules):
            return make_module_optimizer(
                modules, {"generator": float(tp.get("lr_generator", 2e-4)),
                          "audio_feature": lr_audio,
                          "kp_detector_a": lr_audio},
                default_lr=lr_audio, **sched)
    else:
        def make_opt(modules):
            return make_optimizer(modules, lr=lr_audio, **sched)
    if mode == "train_part2":
        state = S.init_part2_state(models, make_opt)
    else:
        make_disc = None
        if use_gan:
            def make_disc(modules):
                return make_optimizer(modules, lr=float(tp.get(
                    "lr_discriminator", lr_audio)), **sched)
        state = S.init_part1_state(models, make_opt,
                                   train_generator=mode != "train_part1",
                                   make_disc_optimizer=make_disc)

    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    if checkpoint:
        tree = (ckpt.restore() if checkpoint == "latest"
                else torch.load(checkpoint, map_location="cpu",
                                weights_only=False))
        if tree is not None:
            load_tree(state, tree)
    check_replicated(models, device)

    multi_step = S.make_multi_step(step_fn)
    eval_loader = None
    try:
        eval_dataset = build_dataset(config, is_train=False)
        if len(eval_dataset) > 0:
            eval_loader = DataLoader(eval_dataset,
                                     batch_size=tp["batch_size"],
                                     shuffle=False, seed=seed,
                                     shard=(rank, world) if world > 1
                                     else None)
            eval_batches = len(eval_dataset) // tp["batch_size"] // world
    except (FileNotFoundError, OSError):
        pass

    logger = MetricsLogger(log_dir, writes=rank == 0)
    visualizer = Visualizer(**{k: v for k, v in
                               config.get("visualizer_params", {}).items()
                               if k in ("kp_size", "draw_border",
                                        "colormap")})
    checkpoint_freq = tp.get("checkpoint_freq", 1)
    num_epochs = tp.get("num_epochs", 300)
    log_every = max(1, int(tp.get("log_every", 10)))
    start_step = state.step
    total = 0
    pending: list[tuple[int, dict]] = []
    last_host: dict = {}

    def flush_metrics():
        # one device -> host copy for the buffered metrics
        if not pending:
            return
        names = list(pending[0][1])
        values = torch.stack([torch.stack([m[n] for n in names])
                              for _, m in pending])
        values = all_reduce_mean(values).cpu().numpy()
        for (step_num, _), row in zip(pending, values):
            m = {n: float(v) for n, v in zip(names, row)}
            logger.log_iter(m)
            logger.write_scalars(step_num, m)
        pending.clear()

    def save(step_num: int):
        if rank == 0:
            ckpt.save(step_num, state)
            try:
                with local_statistics():
                    visualize_checkpoint(
                        state, last_host,
                        os.path.join(log_dir, f"{step_num:08d}-viz.png"),
                        visualizer, device)
            except Exception as e:      # a diagnostic never stops training
                print(f"visualization failed: {e!r}", flush=True)
        barrier()

    preempted = {"sig": None}
    prev_handlers = {}

    def _on_signal(signum, frame):
        preempted["sig"] = signum

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:      # not in the main thread
            pass

    def batches(it):
        """Loader batches -> step inputs on the device: K stacked
        micro-batches per step with grad_accum (a short tail is dropped,
        since a partial mean would change the step size).  The first
        micro-batch of each step stays in ``last_host`` for the
        visualizer."""
        while True:
            group = list(itertools.islice(it, k_accum))
            if len(group) < k_accum:
                return
            last_host.clear()
            last_host.update(group[0])
            host = group[0] if k_accum == 1 else S.stack_host_batches(group)
            yield S.to_device(host, device)

    try:
        for epoch in range(num_epochs):
            it = batches(itertools.islice(iter(loader), per_epoch))
            while True:
                take = spd if max_steps is None else min(spd,
                                                          max_steps - total)
                group = list(itertools.islice(it, max(1, take)))
                if not group:
                    break
                metrics_list = multi_step(state, group)
                prev_total = total
                total += len(group)
                step_num = start_step + total
                for j, m in enumerate(metrics_list):
                    pending.append((start_step + prev_total + 1 + j, m))

                def crossed(every: int) -> bool:
                    return (total // every) > (prev_total // every)

                if crossed(log_every):
                    flush_metrics()
                if (crossed(SAVE_EVERY_STEPS[mode])
                        and epoch % checkpoint_freq == 0):
                    flush_metrics()
                    save(step_num)
                stop = max_steps is not None and total >= max_steps
                if any_rank(preempted["sig"] is not None, device):
                    print(f"signal {preempted['sig']}: emergency "
                          f"checkpoint at step {step_num}", flush=True)
                    stop = True
                if stop:
                    flush_metrics()
                    logger.log_epoch(epoch)
                    save(step_num)
                    return state
            flush_metrics()
            logger.log_epoch(epoch)
            if eval_loader is not None:
                _eval_epoch(state, mode, tp,
                            itertools.islice(eval_loader, eval_batches),
                            device, logger, start_step + total)
        flush_metrics()
        if rank == 0:
            ckpt.save(start_step + total, state)
        barrier()
        return state
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)


def _eval_epoch(state, mode: str, tp: dict, eval_loader, device, logger,
                step: int):
    """The held-out loss: the mode's loss on plain batches, no update and
    no BatchNorm statistics written; in a distributed run each rank's
    batches, the means averaged over the ranks."""
    loss = S.part2_loss if mode == "train_part2" else S.part1_loss
    eval_tp = dict(tp, grad_accum=1)
    saved = {n: {k: v.clone() for k, v in state.models[n].state_dict().items()}
             for n in state.trainable}
    values = []
    with torch.no_grad():
        for host in eval_loader:
            batch = decode_and_augment(S.to_device(host, device))
            _, metrics, _ = loss(state, eval_tp, batch)
            metrics["total"] = sum(metrics.values())
            values.append({k: float(v) for k, v in metrics.items()})
    for n, sd in saved.items():
        state.models[n].load_state_dict(sd)
    if values:
        names = list(values[0])
        means = all_reduce_mean(torch.tensor(
            [np.mean([v[k] for v in values]) for k in names],
            dtype=torch.float64, device=device)).tolist()
        logger.write_scalars(step, dict(zip(names, means)), prefix="eval")
