"""The host-side helpers of the port's entry points against the JAX
package's on the same inputs, on the CPU: the YAML config loader, the
convex-hull area and the scaled ``normalize_kp`` of adapt_scale, the AVI
writers (byte for byte), face crop and alignment, the emotion clip's
augmentation (the same random and numpy seeds) and the audio decode."""
import os
import random

import numpy as np
import torch

from eamm_tpu.config import load_config as jax_load_config
from eamm_tpu.data import augmentation as jax_aug
from eamm_tpu.data import native as jax_native
from eamm_tpu.data import preprocess as jax_pre
from eamm_tpu.ops import motion as jax_motion
from eamm_tpu_torch import config as cfg
from eamm_tpu_torch.data import augmentation, native, preprocess
from eamm_tpu_torch.ops import motion
from tests.conftest import REPO_ROOT
from tests.test_torch_entry import one_thread  # noqa: F401


def test_load_config_matches_jax():
    """Every file of configs/ loads to the JAX package's dict."""
    names = sorted(f for f in os.listdir(os.path.join(REPO_ROOT, "configs"))
                   if f.endswith(".yaml"))
    assert len(names) >= 5
    for name in names:
        path = os.path.join(REPO_ROOT, "configs", name)
        assert cfg.load_config(path) == jax_load_config(path), name


def test_convex_hull_and_scaled_normalize_kp_match_jax():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (10, 2)).astype(np.float32)
    assert motion.convex_hull_area(pts) == jax_motion.convex_hull_area(pts)
    kp = {k: rng.uniform(-1, 1, s).astype(np.float32)
          for k, s in (("value", (10, 2)), ("jacobian", (10, 2, 2)))}
    drv = {k: rng.uniform(-1, 1, (5,) + v.shape).astype(np.float32)
           for k, v in kp.items()}
    init = {k: v[0] + 0.1 for k, v in drv.items()}
    scale = 1.37
    ours = motion.normalize_kp(
        {k: torch.from_numpy(v) for k, v in kp.items()},
        {k: torch.from_numpy(v) for k, v in drv.items()},
        {k: torch.from_numpy(v) for k, v in init.items()},
        use_relative_movement=True, use_relative_jacobian=True,
        adapt_movement_scale=scale)
    ref = jax_motion.normalize_kp(kp, drv, init, use_relative_movement=True,
                                  use_relative_jacobian=True,
                                  adapt_movement_scale=scale)
    for k in ("value", "jacobian"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-5)


def test_avi_writers_match_jax(tmp_path):
    """The same bytes as the JAX package's writers: RGB without and with
    a float waveform, I420 with an (int16-able array, rate) tuple."""
    rng = np.random.RandomState(5)
    audio = (0.3 * rng.randn(3000)).astype(np.float32)
    frames = rng.randint(0, 256, (5, 16, 14, 3), dtype=np.uint8)
    planes = [rng.randint(0, 256, (4, h, h), dtype=np.uint8)
              for h in (16, 8, 8)]
    cases = {
        "rgb": lambda m, p: m.write_avi_rgb(p, frames, fps=25.0),
        "rgb_audio": lambda m, p: m.write_avi_rgb(p, frames, fps=25.0,
                                                  audio=audio),
        "i420_audio": lambda m, p: m.write_avi_i420(p, *planes, fps=30.0,
                                                    audio=(audio, 8000)),
    }
    for kind, write in cases.items():
        ours, ref = (str(tmp_path / f"{kind}_{m}.avi") for m in ("o", "r"))
        write(native, ours)
        write(jax_native, ref)
        with open(ours, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), kind


# ------------------------------------------------ demo host inputs

def test_crop_and_align_match_jax():
    """crop_image with given landmarks and with the coarse detector on the
    demo kit's portrait, and align_clip, within 1e-5 of the JAX package."""
    from imageio.v2 import imread
    rng = np.random.RandomState(6)
    template = jax_pre.load_template()
    img = rng.rand(300, 280, 3).astype(np.float32)
    lm = template + rng.uniform(-4, 4, template.shape)
    np.testing.assert_allclose(preprocess.crop_image(img, landmarks=lm),
                               jax_pre.crop_image(img, landmarks=lm),
                               atol=1e-5)
    portrait = imread(os.path.join(REPO_ROOT, "assets", "demo",
                                   "portrait.png"))
    np.testing.assert_array_equal(preprocess.detect_landmarks(portrait),
                                  jax_pre.detect_landmarks(portrait))
    clip = rng.rand(2, 256, 256, 3).astype(np.float32)
    per_frame = [template + rng.uniform(-3, 3, template.shape)
                 for _ in range(2)]
    kw = dict(landmarks0=template, per_frame_landmarks=per_frame,
              shift=(0, 10))
    np.testing.assert_allclose(preprocess.align_clip(clip, **kw),
                               jax_pre.align_clip(clip, **kw), atol=1e-5)


def test_augmentation_matches_jax():
    """The demo config's augmentation (mouth mask, rotation, perspective)
    and a flip/jitter one give the JAX package's frames for the same
    random and numpy seeds."""
    params = [load_demo_augmentation(),
              {"flip_param": {"horizontal_flip": True, "time_flip": True},
               "jitter_param": {"brightness": 0.1, "contrast": 0.1,
                                "saturation": 0.1, "hue": 0.1}}]
    clip = np.random.RandomState(7).rand(2, 256, 256, 3).astype(np.float32)
    for p in params:
        outs = []
        for mod in (augmentation, jax_aug):
            random.seed(8)
            np.random.seed(8)
            outs.append(np.asarray(mod.AllAugmentationTransform(**p)(clip)))
        np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)


def load_demo_augmentation() -> dict:
    return cfg.load_config(os.path.join(REPO_ROOT, "configs", "demo.yaml"))[
        "dataset_params"]["augmentation_params"]


def test_load_audio_matches_jax(tmp_path):
    """A mono 16 kHz int16 wav, and a stereo 8 kHz one (averaged and
    resampled)."""
    from scipy.io import wavfile
    rng = np.random.RandomState(9)
    for name, rate, shape in (("mono", 16000, (4800,)),
                              ("stereo", 8000, (2400, 2))):
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, rate, (0.1 * rng.randn(*shape) * 32767)
                      .astype(np.int16))
        np.testing.assert_array_equal(preprocess.load_audio(path),
                                      jax_pre.load_audio(path))
