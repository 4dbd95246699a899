"""``eamm-torch-run --mode train_part2`` on the CPU, and the checkpoint
visualizer.

- Part2 through the CLI on a synthetic MEAD tree (packed frames) from the
  reference's FOMM and audio checkpoints: two steps, finite losses, a
  checkpoint at step 2, emo_detector changed and the frozen models
  exactly the checkpoints' weights; then ``--checkpoint latest`` runs
  step 3 of the same run.
- The visualizer's image against ``eamm_tpu.train.visualizer`` on the
  same arrays, and its PNG read back (``test_torch_train_loop.py`` reads
  the one a part1 run writes at its checkpoint).

TINY_CONFIG widths (the emotion hourglass narrow), batches of one clip
(16 frames).
"""
import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch

from eamm_tpu.train.visualizer import Visualizer as JaxVisualizer
from eamm_tpu_torch.cli.run import main
from eamm_tpu_torch.data.packed import write_pack
from eamm_tpu_torch.train.checkpoint import CheckpointManager
from eamm_tpu_torch.train.logging import read_scalars
from eamm_tpu_torch.train.loop import build_models
from eamm_tpu_torch.train.visualizer import Visualizer
from tests.conftest import TINY_CONFIG

CLIPS = ("M1/angry_001", "M1/neutral_001", "M1/happy_001", "M1/neutral_002")


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
    """A checkpoint holds ATNet at its full width: each test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _mead_tree(root: str, frames: int = 24) -> None:
    rng = np.random.RandomState(0)
    for clip in CLIPS:
        d = os.path.join(root, "MEAD_fomm_crop", clip)
        os.makedirs(d)
        write_pack(os.path.join(d, "frames.eammpack"), list(range(frames)),
                   rng.randint(0, 256, (frames, 256, 256, 3), np.uint8))
        for sub, arr in (("MEAD_MFCC", rng.randn(frames, 28, 13)),
                         ("MEAD_fomm_pose_crop", rng.randn(frames, 7))):
            path = os.path.join(root, sub, clip + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, arr)


def _part2_config(root: str) -> dict:
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg["model_params"]["emotion_params"] = {
        "block_expansion": 8, "max_features": 32, "num_blocks": 3}
    cfg["dataset_params"] = {
        "name": "MEAD", "root_dir": root, "frame_shape": [256, 256, 3],
        "device_augmentation": True, "augmentation_params": {
            "crop_mouth_param": {"center_x": 135, "center_y": 190,
                                 "mask_width": 100, "mask_height": 60},
            "rotation_param": {"degrees": 30},
            "perspective_param": {"pers_num": 30, "enlarge_num": 40},
            "flip_param": {"horizontal_flip": True, "time_flip": False}}}
    cfg["train_params"] = {
        "jaco_net": "cnn", "type": "linear_4", "classify": True,
        "smooth": True, "num_epochs": 1, "num_repeats": 2, "batch_size": 1,
        "log_every": 1,
        "epoch_milestones": [60, 90], "lr_audio_feature": 2.0e-4,
        "checkpoint_freq": 1, "loss_weights": {"emo": 10}}
    return cfg


def _tensors(module) -> dict:
    return {k: v.clone() for k, v in module.state_dict().items()}


def test_cli_part2_two_steps_then_resume(tmp_path):
    root = str(tmp_path / "mead")
    _mead_tree(root)
    cfg = _part2_config(root)
    path = str(tmp_path / "part2.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    # the reference's checkpoints, from models drawn with another seed
    other = build_models(cfg, "train_part2", seed=5, device="cpu")
    fomm, audio = str(tmp_path / "fomm.pth.tar"), str(tmp_path / "a.pth.tar")
    torch.save({"kp_detector": other["kp_detector"].state_dict()}, fomm)
    torch.save({n: other[n].state_dict()
                for n in ("audio_feature", "kp_detector_a")}, audio)
    log = str(tmp_path / "log")
    argv = ["--config", path, "--mode", "train_part2", "--cpu",
            "--log_dir", log, "--fomm_checkpoint", fomm,
            "--audio_checkpoint", audio]
    state = main(argv + ["--max_steps", "2"])
    assert state.step == 2 and state.trainable == ("emo_detector",)
    (run,) = os.listdir(log)
    run = os.path.join(log, run)
    scalars = read_scalars(os.path.join(run, "scalars.jsonl"))
    for tag in ("loss_value", "loss_jacobian", "loss_classify",
                "loss_smooth", "total"):
        steps, values = scalars[f"train/{tag}"]
        assert list(steps) == [1, 2] and np.isfinite(values).all(), tag
    ckpt = CheckpointManager(os.path.join(run, "checkpoints"))
    assert ckpt.steps() == [2]
    assert not [f for f in os.listdir(run) if f.endswith("-viz.png")]
    drawn = build_models(cfg, "train_part2", seed=0, device="cpu")
    for name, m in state.models.items():
        want = (drawn if name == "emo_detector" else other)[name]
        same = all(torch.equal(v, m.state_dict()[k])
                   for k, v in want.state_dict().items())
        assert same == (name != "emo_detector"), name

    saved = _tensors(state.models["emo_detector"])
    resumed = main(argv + ["--max_steps", "1", "--checkpoint", "latest"])
    assert resumed.step == 3 and ckpt.steps() == [2, 3]
    tree = ckpt.restore(2)
    for k, v in saved.items():
        assert torch.equal(tree["models"]["emo_detector"][k], v), k


def _panels(seed: int = 0) -> tuple:
    rng = np.random.RandomState(seed)
    out = {"prediction": rng.rand(1, 64, 64, 3),
           "deformed": rng.rand(1, 64, 64, 3),
           "occlusion_map": rng.rand(1, 16, 16, 1),
           "sparse_deformed": rng.rand(1, 11, 16, 16, 3),
           "mask": rng.rand(1, 16, 16, 11),
           "kp_source": {"value": rng.uniform(-1, 1, (1, 10, 2))},
           "kp_driving": {"value": rng.uniform(-1, 1, (1, 10, 2))}}
    return rng.rand(1, 64, 64, 3), rng.rand(1, 64, 64, 3), out


def test_visualizer_matches_jax(tmp_path):
    """The grid equals JAX's on the same arrays; the PNG holds it times
    255, truncated, and reads back through imageio."""
    import imageio.v2 as imageio
    driving, source, out = _panels()
    grid = Visualizer(kp_size=3).visualize(driving, source, out)
    np.testing.assert_array_equal(
        grid, JaxVisualizer(kp_size=3).visualize(driving, source, out))
    assert grid.shape == (4 * 64, 5 * 64, 3)      # 5 panels, 11 masks
    path = Visualizer(kp_size=3).save(str(tmp_path / "v.png"), driving,
                                      source, out)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)),
                                  (grid * 255).astype(np.uint8))
