"""``eamm-torch-run``: the training CLI, with the JAX CLI's flags.

Counterpart of ``eamm_tpu/cli/run.py`` for the part1 modes:

    python -m eamm_tpu_torch.cli.run --config configs/train_part1.yaml \\
        --mode train_part1 --log_dir log/

trains on the CUDA device unless ``--cpu`` is given.  ``--mode
train_part1_fine_tune`` adds the generator (``--vgg_checkpoint`` a
torchvision ``vgg19`` state_dict for the perceptual loss).  ``--mode
train_part2``, ``reconstruction`` and ``animate`` are not ported yet and
exit non-zero.  A config may be YAML or, where PyYAML is missing, JSON.
"""
from __future__ import annotations

import os
import shutil
import time
from argparse import ArgumentParser

NOT_PORTED = ("train_part2", "reconstruction", "animate")


def build_parser() -> ArgumentParser:
    parser = ArgumentParser("eamm-torch-run", description=__doc__)
    parser.add_argument("--config", required=True, help="path to config")
    parser.add_argument("--mode", default="train_part1",
                        choices=["train_part1", "train_part1_fine_tune",
                                 *NOT_PORTED])
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
                        help="accepted for the JAX CLI's flags "
                             "(reconstruction mode, not ported yet)")
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
                        help="accepted for the reference CLI's flags; the "
                             "port trains on one device")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU (the kernels' plain versions)")
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


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if opt.mode in NOT_PORTED:
        raise SystemExit(f"eamm-torch-run: --mode {opt.mode} is not ported "
                         "yet (ROADMAP Queue 1)")
    import torch

    from eamm_tpu_torch.compat import load_torch_checkpoint
    from eamm_tpu_torch.compat.preflight import check_state_dict
    from eamm_tpu_torch.config import load_config
    from eamm_tpu_torch.train.loop import train

    config = load_config(opt.config)
    tp = config["train_params"]
    for key in ("compute_dtype", "steps_per_dispatch", "grad_accum"):
        if getattr(opt, key):
            tp[key] = getattr(opt, key)

    log_dir, checkpoint = run_dir(opt)
    os.makedirs(log_dir, exist_ok=True)
    shutil.copy(opt.config, os.path.join(log_dir,
                                         os.path.basename(opt.config)))
    print(f"mode={opt.mode} log_dir={log_dir}", flush=True)

    for path in (opt.fomm_checkpoint, opt.audio_checkpoint):
        if path and os.path.isfile(str(path)):
            report = check_state_dict(str(path))
            if report.fatal:
                raise SystemExit(str(report))
            if not report.ok:
                print(report)
    vgg = (load_torch_checkpoint(opt.vgg_checkpoint)
           if opt.vgg_checkpoint else None)
    return train(config, opt.mode, log_dir, checkpoint=checkpoint,
                 max_steps=opt.max_steps, seed=opt.seed, vgg_state_dict=vgg,
                 fomm_checkpoint=opt.fomm_checkpoint,
                 audio_checkpoint=opt.audio_checkpoint,
                 device=torch.device("cpu" if opt.cpu else "cuda"))


if __name__ == "__main__":
    main()
