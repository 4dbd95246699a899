"""``eamm-torch-run``: the training and evaluation CLI, with the JAX CLI's
flags.

Counterpart of ``eamm_tpu/cli/run.py``:

    python -m eamm_tpu_torch.cli.run --config configs/train_part1.yaml \\
        --mode train_part1 --log_dir log/

runs on the CUDA device unless ``--cpu`` is given.  ``--mode
train_part1_fine_tune`` adds the generator (``--vgg_checkpoint`` a
torchvision ``vgg19`` state_dict for the perceptual loss); ``--mode
train_part2`` trains the emotion displacement on MEAD
(``configs/train_part2.yaml``) against the frozen FOMM and audio models
(``--fomm_checkpoint``, ``--audio_checkpoint``).  ``--mode
reconstruction`` prints the test split's reconstruction metrics as JSON
(AED too with ``--emo_checkpoint``); ``--mode animate`` writes each
pair's frames as ``pair_<i>.npy`` (uint8) under ``<run>/animation/``;
both need ``--fomm_checkpoint``.  A config may be YAML or, where PyYAML
is missing, JSON.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set) a training mode runs data parallel, one process per
device: ``torchrun --nproc_per_node 4 -m eamm_tpu_torch.cli.run ...``.
Each process joins the group (NCCL on CUDA device ``LOCAL_RANK``, gloo with
``--cpu``) before it builds its models and trains on its slice of the
batch stream (``train_params.batch_size`` per process); rank 0 picks the
run's directory and writes the logs and checkpoints.  Without those
variables the run is one process, as before; ``--device_ids`` is accepted
and ignored either way.  The evaluation modes run in one process.
"""
from __future__ import annotations

import os
import shutil
import time
from argparse import ArgumentParser

TRAIN_MODES = ("train_part1", "train_part1_fine_tune", "train_part2")
MODES = TRAIN_MODES + ("reconstruction", "animate")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser("eamm-torch-run", description=__doc__)
    parser.add_argument("--config", required=True, help="path to config")
    parser.add_argument("--mode", default="train_part1", choices=MODES)
    parser.add_argument("--num_videos", type=int, default=10,
                        help="clips/pairs for reconstruction|animate modes")
    parser.add_argument("--log_dir", default="log", help="log directory")
    parser.add_argument("--checkpoint", default=None,
                        help="'latest' or path to resume from")
    parser.add_argument("--fomm_checkpoint", default=None,
                        help="reference FOMM .pth.tar for the frozen "
                             "generator + kp_detector")
    parser.add_argument("--audio_checkpoint", default=None,
                        help="reference audio .pth.tar (audio_feature + "
                             "kp_detector_a)")
    parser.add_argument("--vgg_checkpoint", default=None,
                        help="torchvision vgg19 state_dict (.pth) for the "
                             "fine-tune perceptual loss; random VGG "
                             "features are used (with a warning) otherwise")
    parser.add_argument("--emo_checkpoint", default=None,
                        help="reference EmotionK .pth.tar; in --mode "
                             "reconstruction its trunk embedding adds the "
                             "AED metric")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--compute_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="training compute dtype (parameters, optimizer "
                             "state and BN statistics stay float32)")
    parser.add_argument("--steps_per_dispatch", type=int, default=None,
                        help="K optimizer steps per call")
    parser.add_argument("--grad_accum", type=int, default=None,
                        help="accumulate K micro-batch gradients into one "
                             "optimizer step")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device_ids", default="0", type=str,
                        help="accepted for the reference CLI's flags and "
                             "ignored: a run is data parallel under "
                             "torchrun, one process per device")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    return parser


def _has_checkpoint(run: str) -> bool:
    d = os.path.join(run, "checkpoints")
    return os.path.isdir(d) and any(f.startswith("ckpt_")
                                    for f in os.listdir(d))


def run_dir(opt) -> tuple[str, str | None]:
    """(the run's log directory, what ``train`` resumes from).  A new run
    gets ``<log_dir>/<config name> <timestamp>``.  ``--checkpoint latest``
    continues the newest run of this config under ``--log_dir`` that has a
    checkpoint (a new run when there is none); a run's directory or its
    ``checkpoints`` directory continues that run from its latest
    checkpoint; a checkpoint file is loaded, and the run goes on in the
    directory that holds its ``checkpoints``."""
    base = os.path.basename(opt.config).split(".")[0]
    ckpt = opt.checkpoint
    if ckpt == "latest" and os.path.isdir(opt.log_dir):
        runs = [os.path.join(opt.log_dir, d) for d in os.listdir(opt.log_dir)
                if d.startswith(f"{base} ")]
        runs = [r for r in runs if _has_checkpoint(r)]
        if runs:
            return max(runs, key=os.path.getmtime), "latest"
    elif ckpt is not None and os.path.isdir(ckpt):
        run = os.path.abspath(ckpt)
        if os.path.basename(run) == "checkpoints":
            run = os.path.dirname(run)
        return run, "latest"
    elif ckpt is not None:
        return os.path.dirname(os.path.dirname(os.path.abspath(ckpt))), ckpt
    stamp = time.strftime("%d_%m_%y_%H.%M.%S")
    return os.path.join(opt.log_dir, f"{base} {stamp}"), None


def evaluate(opt, config: dict, log_dir: str, device):
    """``--mode reconstruction``: the metrics dict, printed as JSON;
    ``--mode animate``: the clips, saved as uint8 ``pair_<i>.npy``."""
    import json

    import numpy as np

    from eamm_tpu_torch import config as cfg
    from eamm_tpu_torch.compat import (EMOTION_K_UNUSED,
                                       load_torch_checkpoint, split_unused,
                                       strip_prefix)
    from eamm_tpu_torch.data.datasets import PairedDataset
    from eamm_tpu_torch.infer.animate import animate, reconstruction
    from eamm_tpu_torch.train.loop import build_dataset
    if not opt.fomm_checkpoint:
        raise SystemExit(f"--mode {opt.mode} requires --fomm_checkpoint")
    fomm = load_torch_checkpoint(opt.fomm_checkpoint)
    models = {"kp_detector": cfg.build_kp_detector(config),
              "generator": cfg.build_generator(config)}
    for name, m in models.items():
        m.load_state_dict(strip_prefix(fomm[name]))
        m.to(device)
    dataset = build_dataset(config, is_train=False)
    if opt.mode == "reconstruction":
        n = config.get("reconstruction_params", {}).get("num_videos",
                                                        opt.num_videos)
        feature_fn = None
        if opt.emo_checkpoint:
            emo = cfg.build_emotion_detector(config)
            sd, _ = split_unused(strip_prefix(load_torch_checkpoint(
                opt.emo_checkpoint)["emo_detector"]), emo, EMOTION_K_UNUSED)
            emo.load_state_dict(sd)
            emo.to(device).eval()
            feature_fn = emo.feature
        out = reconstruction(models, dataset, min(n, opt.num_videos),
                             emotion_feature_fn=feature_fn)
        print(json.dumps(out), flush=True)
        return out
    ap = config.get("animate_params", {})
    norm = ap.get("normalization_params", {})
    pairs = PairedDataset(dataset, number_of_pairs=min(
        ap.get("num_pairs", opt.num_videos), opt.num_videos))
    clips = animate(models, pairs,
                    relative=norm.get("use_relative_movement", True),
                    adapt_scale=norm.get("adapt_movement_scale", False))
    out_dir = os.path.join(log_dir, "animation")
    os.makedirs(out_dir, exist_ok=True)
    for i, clip in enumerate(clips):
        np.save(os.path.join(out_dir, f"pair_{i}.npy"),
                (clip * 255).astype("uint8"))
    print(f"saved {len(clips)} animations to {out_dir}", flush=True)
    return clips


def main(argv=None):
    opt = build_parser().parse_args(argv)
    import torch

    from eamm_tpu_torch.config import load_config

    config = load_config(opt.config)
    tp = config.setdefault("train_params", {})
    for key in ("compute_dtype", "steps_per_dispatch", "grad_accum"):
        if getattr(opt, key):
            tp[key] = getattr(opt, key)

    from eamm_tpu_torch.parallel import mesh
    env = mesh.torchrun_env() if opt.mode in TRAIN_MODES else None
    device = torch.device("cpu" if opt.cpu else "cuda")
    if env is not None:
        if not opt.cpu:
            device = torch.device("cuda", env["local_rank"])
        mesh.init_distributed(env["rank"], env["world_size"],
                              env["init_method"], device)
    try:
        return _run(opt, config, device, env)
    finally:
        if env is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(opt, config: dict, device, env):
    import torch.distributed as dist

    from eamm_tpu_torch.compat import load_torch_checkpoint
    from eamm_tpu_torch.compat.preflight import check_state_dict
    from eamm_tpu_torch.train.loop import train

    rank = 0 if env is None else env["rank"]
    log_dir, checkpoint = run_dir(opt)
    if env is not None:     # rank 0's choice (the timestamp) for every rank
        chosen = [(log_dir, checkpoint)]
        dist.broadcast_object_list(chosen, src=0)
        log_dir, checkpoint = chosen[0]
    if rank == 0:
        os.makedirs(log_dir, exist_ok=True)
        shutil.copy(opt.config, os.path.join(log_dir,
                                             os.path.basename(opt.config)))
        print(f"mode={opt.mode} log_dir={log_dir}"
              + (f" ranks={env['world_size']}" if env else ""), flush=True)

    for path in (opt.fomm_checkpoint, opt.audio_checkpoint,
                 opt.emo_checkpoint):
        if path and os.path.isfile(str(path)):
            report = check_state_dict(str(path))
            if report.fatal:
                raise SystemExit(str(report))
            if not report.ok:
                print(report)
    if opt.mode in ("reconstruction", "animate"):
        return evaluate(opt, config, log_dir, device)
    dataset_name = config.get("dataset_params", {}).get("name", "LRW")
    if opt.mode == "train_part2" and dataset_name != "MEAD":
        raise SystemExit(f"--mode train_part2 trains on MEAD (its emotion "
                         f"labels and transformed_driving stream); "
                         f"dataset_params.name is {dataset_name!r}")
    vgg = (load_torch_checkpoint(opt.vgg_checkpoint)
           if opt.vgg_checkpoint else None)
    return train(config, opt.mode, log_dir, checkpoint=checkpoint,
                 max_steps=opt.max_steps, seed=opt.seed, vgg_state_dict=vgg,
                 fomm_checkpoint=opt.fomm_checkpoint,
                 audio_checkpoint=opt.audio_checkpoint, device=device)


if __name__ == "__main__":
    main()
