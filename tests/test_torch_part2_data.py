"""Part2's data path of the port against ``eamm_tpu`` (CPU): the MEAD,
Vox and paired datasets and the device MEAD augmentation.

- ``warp_homography_frames`` (zeros, and border into a fixed 256x256) and
  ``decode_and_augment`` of a uint8 batch with ``tdrv_*`` decisions
  (mouth noise, flip, rotation, perspective, jitter), within 1e-5 of
  JAX's on the same arrays.
- ``MeadDataset`` (host and device augmentation routes), ``VoxDataset``
  and ``PairedDataset``: every array of a sample bit for bit JAX's, with
  Python's ``random`` and numpy's global state seeded alike before each
  item.  The clips are packed frames (``frames.eammpack``), which both
  packages read alike; one identity's neutral clips are PNGs on the
  device route (uint8 either way), where the neutral frame is drawn from
  the directory's listing.
"""
import os
import random

import numpy as np
import pytest
import torch
import jax

from eamm_tpu.data import datasets as jax_ds
from eamm_tpu.ops import augment as jax_aug
from eamm_tpu_torch.data import datasets as ds
from eamm_tpu_torch.data.packed import write_pack
from eamm_tpu_torch.ops import augment

TOL = 1e-5
MEAD_AUG = {"crop_mouth_param": {"center_x": 135, "center_y": 190,
                                 "mask_width": 100, "mask_height": 60},
            "rotation_param": {"degrees": 30},
            "perspective_param": {"pers_num": 30, "enlarge_num": 40},
            "flip_param": {"horizontal_flip": True, "time_flip": False},
            "jitter_param": {"brightness": 0.1, "contrast": 0.1,
                             "saturation": 0.1, "hue": 0.1}}
MEAD_CLIPS = {"M1/angry_001": "pack", "M1/neutral_001": "pack",
              "M1/neutral_002": "pack", "M2/happy_001": "pack",
              "M2/neutral_001": "png"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs in several
    workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(rng, n: int) -> np.ndarray:
    return rng.randint(0, 256, (n, 256, 256, 3), np.uint8)


def _write_clip(d: str, frames: np.ndarray, form: str) -> None:
    os.makedirs(d)
    if form == "pack":
        write_pack(os.path.join(d, "frames.eammpack"),
                   list(range(len(frames))), frames)
    else:
        import imageio.v2 as imageio
        for i, f in enumerate(frames):
            imageio.imwrite(os.path.join(d, f"{i}.png"), f)


def _save(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, arr)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A MEAD tree (24-frame clips) and a Vox test split (3 videos)."""
    rng = np.random.RandomState(0)
    mead = str(tmp_path_factory.mktemp("mead"))
    for clip, form in MEAD_CLIPS.items():
        _write_clip(os.path.join(mead, "MEAD_fomm_crop", clip),
                    _frames(rng, 24), form)
        _save(os.path.join(mead, "MEAD_MFCC", clip + ".npy"),
              rng.randn(24, 28, 13))
        _save(os.path.join(mead, "MEAD_fomm_pose_crop", clip + ".npy"),
              rng.randn(24, 7))
    vox = str(tmp_path_factory.mktemp("vox"))
    for name, n in (("id0/v0", 20), ("id0/v1", 25), ("id1/v0", 25)):
        _write_clip(os.path.join(vox, "align_img", "test_fo", name),
                    _frames(rng, n), "pack")
        _save(os.path.join(vox, "MFCC", "test", name + ".npy"),
              rng.randn(n, 28, 13))
        _save(os.path.join(vox, "align_pose", "test_fo", name + ".npy"),
              rng.randn(n, 7))
    return {"mead": mead, "vox": vox}


def _same(ours: dict, ref: dict) -> None:
    assert set(ours) == set(ref)
    for k, v in ref.items():
        a, b = np.asarray(ours[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _item(dataset, i: int, seed: int) -> dict:
    random.seed(seed)
    np.random.seed(seed)
    return dataset[i]


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_warp_homography_frames_matches_jax(padding_mode):
    """Rotations and perspectives of the host samplers' size, per clip
    (zeros, [B, 1, 3, 3]) or per frame (border, into 256x256 from 128x96
    frames)."""
    rng = np.random.RandomState(1)
    B, T = 2, 3
    hw = (128, 96) if padding_mode == "border" else (64, 80)
    frames = rng.rand(B, T, *hw, 3).astype(np.float32)
    m = np.eye(3) + 0.05 * rng.randn(B, 1 if padding_mode == "zeros" else T,
                                     3, 3)
    m[..., :2, 2] = rng.uniform(-8, 8, m.shape[:2] + (2,))
    minv = np.linalg.inv(m).astype(np.float32)
    out_hw = (256, 256) if padding_mode == "border" else None
    ours = augment.warp_homography_frames(torch.from_numpy(frames),
                                          torch.from_numpy(minv),
                                          padding_mode, out_hw)
    ref = jax.jit(jax_aug.warp_homography_frames, static_argnums=(2, 3))(
        frames, minv, padding_mode, out_hw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_decode_and_augment_mead_matches_jax():
    """Two clips' uint8 frames and the decisions the device route samples
    (one with the horizontal flip, one without), through both decodes."""
    samplers = ds._make_mead_device_aug(MEAD_AUG)
    rng = np.random.RandomState(2)
    B, T = 2, 3
    batch = {"example_image": _frames(rng, B),
             "driving": _frames(rng, B * T).reshape(B, T, 256, 256, 3)}
    decisions = []
    for seed in (3, 4):
        random.seed(seed)
        np.random.seed(seed)
        decisions.append(ds._sample_mead_device_aug(samplers, T, 256, 256))
    assert {int(d["tdrv_flip_h"]) for d in decisions} == {0, 1}
    for k in decisions[0]:
        batch[k] = np.stack([d[k] for d in decisions])
    ours = augment.decode_and_augment({k: torch.from_numpy(np.asarray(v))
                                       for k, v in batch.items()})
    # eager, op by op: under jit XLA contracts the projective divide's
    # products differently, and 4 of 1.2M values near the edge then part
    # from the eager ones by 1.8e-5
    ref = jax_aug.decode_and_augment({k: jax.numpy.asarray(v)
                                      for k, v in batch.items()})
    assert set(ours) == set(ref) == {"example_image", "driving",
                                     "transformed_driving"}
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), atol=TOL,
                                   rtol=TOL, err_msg=k)


@pytest.mark.parametrize("device_augmentation", [False, True])
def test_mead_dataset_matches_jax(roots, device_augmentation):
    """Every clip's sample (the neutral example, the window, the smoothed
    pose, the label, the transformed frames or their decisions)."""
    kwargs = dict(root_dir=roots["mead"], augmentation_params=MEAD_AUG,
                  device_augmentation=device_augmentation)
    ours, ref = ds.MeadDataset(**kwargs), jax_ds.MeadDataset(**kwargs)
    assert ours.videos == ref.videos and ours.neutral == ref.neutral
    assert ds.EMOTIONS == jax_ds.EMOTIONS
    # the host route reads a clip of the packed identity (PNG frames would
    # decode to float32 by two formulas) with its neutral example
    clips = [i for i, v in enumerate(ours.videos)
             if device_augmentation or v == "M1/angry_001"]
    for i in clips:
        _same(_item(ours, i, 10 + i), _item(ref, i, 10 + i))


def test_vox_and_paired_datasets_match_jax(roots):
    """The Vox test split (a 20-frame video starts at 0, longer ones at a
    drawn start) and the pairs over it."""
    ours = ds.VoxDataset(roots["vox"], is_train=False)
    ref = jax_ds.VoxDataset(roots["vox"], is_train=False)
    assert ours.videos == ref.videos
    for i in range(len(ours)):
        _same(_item(ours, i, 20 + i), _item(ref, i, 20 + i))
    pairs = ds.PairedDataset(ours, number_of_pairs=4, seed=1)
    ref_pairs = jax_ds.PairedDataset(ref, number_of_pairs=4, seed=1)
    np.testing.assert_array_equal(pairs.pairs, ref_pairs.pairs)
    for i in range(len(pairs)):
        _same(_item(pairs, i, 30 + i), _item(ref_pairs, i, 30 + i))
