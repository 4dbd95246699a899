"""The evaluation modes of the port against ``eamm_tpu.infer.animate``
(CPU): ``reconstruction`` (L1, PSNR, SSIM, AKD, and AED through
EmotionK's trunk) and ``animate`` (relative motion, ``adapt_scale``), on
a Vox-layout test split of 64x64 packed frames, with the same weights
(the port's, seeded, BatchNorm running statistics randomized, converted
by ``eamm_tpu.compat``).  Metrics within 1e-3 relative, frames within the
end-to-end bounds (per-frame mean |difference| max < 1e-2, mean < 3e-3).
Both CLI modes run through ``eamm-torch-run``'s ``main`` on checkpoint
files and give what the functions give.  TINY_CONFIG widths.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from eamm_tpu import compat
from eamm_tpu import config as jax_cfg
from eamm_tpu.data.datasets import PairedDataset as JaxPairs
from eamm_tpu.data.datasets import VoxDataset as JaxVox
from eamm_tpu.infer import animate as jax_animate
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.cli.run import main
from eamm_tpu_torch.data.datasets import PairedDataset, VoxDataset
from eamm_tpu_torch.data.packed import write_pack
from eamm_tpu_torch.infer.animate import animate, reconstruction
from tests.conftest import TINY_CONFIG

METRIC_RTOL = 1e-3
FRAME_BOUNDS = (1e-2, 3e-3)        # per-frame mean |diff|: max, mean


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(module: torch.nn.Module, gen: torch.Generator) -> None:
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The tree, the config, the port's models and their checkpoints, and
    JAX's models and variables over the same weights."""
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(0)
    root = str(d / "vox")
    for name in ("id0/v0", "id1/v0"):
        clip = os.path.join(root, "align_img", "test_fo", name)
        os.makedirs(clip)
        write_pack(os.path.join(clip, "frames.eammpack"), list(range(20)),
                   rng.randint(0, 256, (20, 64, 64, 3), np.uint8))
        for sub, arr in (("MFCC/test", rng.randn(20, 28, 13)),
                         ("align_pose/test_fo", rng.randn(20, 7))):
            path = os.path.join(root, sub, name + ".npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, arr)
    config = copy.deepcopy(TINY_CONFIG)
    config["model_params"]["emotion_params"] = {
        "block_expansion": 8, "max_features": 32, "num_blocks": 3}
    config["dataset_params"] = {"name": "Vox", "root_dir": root,
                                "frame_shape": [64, 64, 3]}
    config["reconstruction_params"] = {"num_videos": 2}
    config["animate_params"] = {"num_pairs": 2, "normalization_params": {
        "use_relative_movement": True, "adapt_movement_scale": True}}
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    models = {"kp_detector": cfg.build_kp_detector(config),
              "generator": cfg.build_generator(config)}
    emo = cfg.build_emotion_detector(config)
    with torch.no_grad():
        models["kp_detector"].jacobian.weight.normal_(0.0, 0.05,
                                                      generator=gen)
    for m in (*models.values(), emo):
        _randomize(m, gen)
        m.eval()
    torch.save({n: m.state_dict() for n, m in models.items()},
               str(d / "fomm.pth.tar"))
    torch.save({"emo_detector": emo.state_dict()}, str(d / "emo.pth.tar"))
    with open(str(d / "config.json"), "w") as f:
        json.dump(config, f)
    sd = {n: {k: v.numpy() for k, v in m.state_dict().items()}
          for n, m in (*models.items(), ("emo", emo))}
    variables = {"kp_detector": compat.convert_kp_detector(sd["kp_detector"]),
                 "generator": compat.convert_generator(sd["generator"])}
    jax_models = {"kp_detector": jax_cfg.build_kp_detector(config),
                  "generator": jax_cfg.build_generator(config)}
    return dict(dir=str(d), config=config, root=root, models=models,
                emo=emo, jax_models=jax_models, variables=variables,
                emo_variables=compat.convert_emotion_k(sd["emo"]))


def _jax_feature_fn(env):
    import jax
    model = jax_cfg.build_emotion_detector(env["config"])
    v = env["emo_variables"]
    return jax.jit(lambda frames: model.apply(v, frames,
                                              method=model.feature))


def test_reconstruction_matches_jax(env):
    """Both clips; every metric, AED included."""
    ours = reconstruction(env["models"], VoxDataset(env["root"],
                                                    is_train=False), 2,
                          emotion_feature_fn=env["emo"].feature)
    ref = jax_animate.reconstruction(
        env["jax_models"], env["variables"],
        JaxVox(env["root"], is_train=False), 2,
        emotion_feature_fn=_jax_feature_fn(env))
    assert set(ours) == set(ref) and ours["videos"] == 2
    assert "reconstruction_aed" in ours
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=METRIC_RTOL, err_msg=k)


def test_animate_matches_jax(env):
    """Two pairs, relative motion with adapt_scale; each frame's mean
    |difference| within the end-to-end bounds."""
    pairs = PairedDataset(VoxDataset(env["root"], is_train=False), 2)
    ours = animate(env["models"], pairs, relative=True, adapt_scale=True)
    ref = jax_animate.animate(
        env["jax_models"], env["variables"],
        JaxPairs(JaxVox(env["root"], is_train=False), 2), relative=True,
        adapt_scale=True)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (16, 64, 64, 3)
        per_frame = np.abs(a - np.asarray(b)).mean(axis=(1, 2, 3))
        assert per_frame.max() < FRAME_BOUNDS[0], per_frame
        assert per_frame.mean() < FRAME_BOUNDS[1], per_frame


def test_cli_modes(env, tmp_path):
    """``--mode reconstruction`` with ``--emo_checkpoint`` returns (and
    prints) the function's metrics; ``--mode animate`` saves each pair's
    frames times 255 as uint8 ``pair_<i>.npy``."""
    d = env["dir"]
    argv = ["--config", f"{d}/config.json", "--cpu", "--log_dir",
            str(tmp_path), "--fomm_checkpoint", f"{d}/fomm.pth.tar",
            "--num_videos", "2"]
    out = main(argv + ["--mode", "reconstruction", "--emo_checkpoint",
                       f"{d}/emo.pth.tar"])
    want = reconstruction(env["models"], VoxDataset(env["root"],
                                                    is_train=False), 2,
                          emotion_feature_fn=env["emo"].feature)
    assert out == pytest.approx(want, rel=1e-6)
    clips = main(argv + ["--mode", "animate"])
    (run,) = [r for r in os.listdir(tmp_path)
              if os.path.isdir(os.path.join(tmp_path, r, "animation"))]
    for i, clip in enumerate(clips):
        saved = np.load(os.path.join(tmp_path, run, "animation",
                                     f"pair_{i}.npy"))
        np.testing.assert_array_equal(saved, (clip * 255).astype(np.uint8))
