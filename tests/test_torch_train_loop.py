"""``eamm-torch-run`` on the CPU: the port's training loop end to end on a
synthetic LRW tree (the session's ``lrw_root``), port only.

Two part1 steps through the CLI and a resume from the latest checkpoint;
the GAN fine-tune with two steps per call; grad_accum with the device
augmentation; the SIGTERM emergency checkpoint; the option combinations
and modes the CLI refuses.  TINY_CONFIG widths, batch 2.
"""
import copy
import json
import os
import shutil
import signal

import pytest
import torch

from eamm_tpu_torch.cli.run import main
from eamm_tpu_torch.train.checkpoint import CheckpointManager
from eamm_tpu_torch.train.logging import read_scalars
from eamm_tpu_torch.train.loop import build_models, train
from tests.conftest import TINY_CONFIG

TRAIN_PARAMS = {
    "jaco_net": "cnn", "generator": "not", "num_epochs": 1, "num_repeats": 4,
    "epoch_milestones": [60, 90], "lr_audio_feature": 2.0e-4,
    "batch_size": 2, "scales": [0.125], "checkpoint_freq": 1, "log_every": 1,
    "loss_weights": {"generator_gan": 0, "discriminator_gan": 0,
                     "feature_matching": [10, 10, 10],
                     "perceptual": [0.1] * 5, "audio": 10},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def remove_checkpoints(tmp_path):
    """A checkpoint holds ATNet at its full width with its Adam moments
    (~0.4 GB): each test's files go when it ends, so that the suite's
    temporary directories do not fill the disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _config(lrw_root, **train_params) -> dict:
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["model_params"]["discriminator_params"]["scales"] = [0.125]
    cfg["dataset_params"] = {"name": "LRW", "root_dir": lrw_root,
                             "frame_shape": [256, 256, 3],
                             "augmentation_params": {}}
    cfg["train_params"] = {**copy.deepcopy(TRAIN_PARAMS), **train_params}
    return cfg


def _write(cfg: dict, tmp_path) -> str:
    path = str(tmp_path / "part1.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _tensors(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_cli_part1_two_steps_then_resume(lrw_root, tmp_path):
    """Two steps: finite losses logged, a checkpoint at step 2, the
    trainable models changed, the frozen detector (weights and running
    statistics) bit for bit as drawn; then ``--checkpoint latest``
    continues the same run from step 2."""
    cfg = _config(lrw_root)
    path, log = _write(cfg, tmp_path), str(tmp_path / "log")
    state = main(["--config", path, "--mode", "train_part1", "--cpu",
                  "--max_steps", "2", "--log_dir", log])
    assert state.step == 2
    (run,) = os.listdir(log)
    run = os.path.join(log, run)
    scalars = read_scalars(os.path.join(run, "scalars.jsonl"))
    steps, values = scalars["train/loss_value"]
    assert list(steps) == [1, 2] and all(v == v for v in values)
    assert CheckpointManager(os.path.join(run, "checkpoints")).steps() == [2]
    drawn = build_models(cfg, "train_part1", False, 0, "cpu")
    for name, m in drawn.items():
        same = all(torch.equal(v, state.models[name].state_dict()[k])
                   for k, v in m.state_dict().items())
        assert same == (name not in state.trainable), name

    saved = _tensors(state.models["audio_feature"])
    resumed = main(["--config", path, "--mode", "train_part1", "--cpu",
                    "--max_steps", "1", "--log_dir", log,
                    "--checkpoint", "latest"])
    assert os.listdir(log) == [os.path.basename(run)]
    assert resumed.step == 3
    assert CheckpointManager(os.path.join(run, "checkpoints")).steps() == [2,
                                                                           3]
    tree = CheckpointManager(os.path.join(run, "checkpoints")).restore(2)
    for k, v in saved.items():
        assert torch.equal(tree["models"]["audio_feature"][k], v), k


def test_fine_tune_gan_two_steps_per_call(lrw_root, tmp_path):
    """The GAN fine-tune (generator on the audio keypoints, perceptual,
    LSGAN and feature matching) with steps_per_dispatch 2: two steps in
    one call, the discriminator trained and its power-iteration vectors
    stored."""
    cfg = _config(lrw_root, generator="audio", steps_per_dispatch=2,
                  loss_weights={**TRAIN_PARAMS["loss_weights"],
                                "generator_gan": 1, "discriminator_gan": 1})
    log = str(tmp_path / "log")
    drawn = build_models(cfg, "train_part1_fine_tune", True, 0, "cpu")
    state = main(["--config", _write(cfg, tmp_path), "--mode",
                  "train_part1_fine_tune", "--cpu", "--max_steps", "2",
                  "--log_dir", log])
    assert state.step == 2 and state.disc_optimizer.count == 2
    assert set(state.trainable) == {"audio_feature", "kp_detector_a",
                                    "generator"}
    (run,) = os.listdir(log)
    scalars = read_scalars(os.path.join(log, run, "scalars.jsonl"))
    for tag in ("perceptual", "gen_gan", "feature_matching", "disc_gan"):
        assert list(scalars[f"train/{tag}"][0]) == [1, 2], tag
    disc = state.models["discriminator"].state_dict()
    for k, v in drawn["discriminator"].state_dict().items():
        assert not torch.equal(v, disc[k]), k


def test_grad_accum_with_device_augmentation(lrw_root, tmp_path):
    """grad_accum 2 on uint8 batches with flip and jitter decided on the
    host: one optimizer step from two loader batches."""
    cfg = _config(lrw_root, grad_accum=2)
    cfg["dataset_params"].update(device_augmentation=True, augmentation_params={
        "flip_param": {"horizontal_flip": True, "time_flip": True},
        "jitter_param": {"brightness": 0.1, "contrast": 0.1,
                         "saturation": 0.1, "hue": 0.1}})
    state = train(cfg, "train_part1", str(tmp_path / "log"), max_steps=1,
                  device="cpu")
    assert state.step == 1 and state.optimizer.count == 1


def test_sigterm_emergency_checkpoint(lrw_root, tmp_path, monkeypatch):
    """A SIGTERM asks for a checkpoint at the next step boundary: the
    signal arrives as the handler is installed, so exactly one step runs,
    is checkpointed, and train returns."""
    fired = []

    def fake_signal(sig, handler):
        if sig == signal.SIGTERM and callable(handler) and not fired:
            fired.append(sig)
            handler(sig, None)
        return signal.SIG_DFL

    monkeypatch.setattr(signal, "signal", fake_signal)
    cfg = _config(lrw_root, num_epochs=5)
    log = str(tmp_path / "log")
    state = train(cfg, "train_part1", log, device="cpu")
    assert fired and state.step == 1
    assert CheckpointManager(os.path.join(log, "checkpoints")
                             ).latest_step() == 1
    assert "train/loss_value" in read_scalars(os.path.join(log,
                                                           "scalars.jsonl"))


def test_grad_accum_with_steps_per_dispatch_rejected(lrw_root, tmp_path):
    cfg = _config(lrw_root, grad_accum=2, steps_per_dispatch=2)
    with pytest.raises(ValueError, match="grad_accum"):
        train(cfg, "train_part1", str(tmp_path / "log"), max_steps=1,
              device="cpu")


@pytest.mark.parametrize("mode", ["train_part2", "reconstruction"])
def test_unported_modes_exit(lrw_root, tmp_path, mode):
    path = _write(_config(lrw_root), tmp_path)
    with pytest.raises(SystemExit, match="not ported yet"):
        main(["--config", path, "--mode", mode, "--cpu"])
