"""The one generator of traffic, driven by a cell's ``traffic`` parameters.

Two kinds:

- ``requests``: a pool of ``identities`` seeded identities (a 256 x 256
  portrait, a waveform long enough for the longest clip, a head pose
  track of ``pose_rows`` rows), and a schedule in which every clip
  length from ``frames[0]`` to ``frames[1]`` frames (25 fps) comes once a
  cycle, in an order and with identities drawn from the seed.  Every seed
  asks for the same set of lengths: only their order and the pixels
  change.  The order is stratified: the lengths fall into ``strata``
  bands, and each run of ``strata`` requests takes one from every band,
  so that the frames of any stretch of consecutive requests, and of a
  window's, hardly depend on where the stretch starts.
- ``batches``: a ring of ``ring`` distinct training batches of ``batch``
  clips of ``frames`` frames, made on the device from the seed in a few
  large draws.

Images are smooth random fields in [0, 1] (three octaves of random
values, 4, 16 and 64 a side, bilinearly enlarged to 256 and mixed 0.6 /
0.3 / 0.1): they have the structure the detectors, dense motion and the
generator respond to, where uniform noise blurs to a flat grey and every
keypoint falls on the centre.  Waveforms are noise under a syllable-rate
envelope (2-6 Hz, random phase), so that the MFCCs change from frame to
frame.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.ops import samples_for_frames

FPS = 25
OCTAVES = ((4, 0.6), (16, 0.3), (64, 0.1))


def smooth_images(n: int, generator: torch.Generator, device, size=256):
    """[n, size, size, 3] float32 smooth random fields in [0, 1]."""
    out = torch.zeros(n, 3, size, size, device=device)
    for side, weight in OCTAVES:
        coarse = torch.rand(n, 3, side, side, generator=generator,
                            device=device)
        out += weight * F.interpolate(coarse, size=(size, size),
                                      mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous()


def waveforms(n: int, length: int, rng: np.random.Generator,
              amplitude: float = 0.1) -> np.ndarray:
    """[n, length] float32 16 kHz noise under a syllable-rate envelope."""
    t = np.arange(length) / 16000.0
    rate = rng.uniform(2.0, 6.0, (n, 1))
    phase = rng.uniform(0.0, 2 * math.pi, (n, 1))
    envelope = 0.5 + 0.5 * np.sin(2 * math.pi * rate * t + phase)
    return (amplitude * envelope * rng.standard_normal((n, length))).astype(
        np.float32)


class Requests:
    def __init__(self, params: dict, seed: int):
        self.params = params
        rng = np.random.default_rng(int(seed))
        n = int(params["identities"])
        lo, hi = params["frames"]
        self.lengths = np.arange(lo, hi + 1)
        wav_len = samples_for_frames(int(hi))
        gen = torch.Generator().manual_seed(int(seed))
        self.portraits = smooth_images(n, gen, "cpu").numpy()
        self.waveforms = waveforms(n, wav_len, rng,
                                   params.get("amplitude", 0.1))
        self.poses = (params.get("pose_scale", 0.1) * rng.standard_normal(
            (n, int(params["pose_rows"]), 7))).astype(np.float32)
        self._rng = rng
        self._cycle: list = []
        self.issued = 0

    def next(self) -> dict:
        """The next request of the schedule: {'index', 'identity',
        'frames', 'source', 'waveform', 'pose'}."""
        if not self._cycle:
            rng = self._rng
            bands = [rng.permutation(b) for b in np.array_split(
                self.lengths, int(self.params.get("strata", 8)))]
            order = [int(b[i]) for i in range(max(map(len, bands)))
                     for j in rng.permutation(len(bands))
                     for b in [bands[j]] if i < len(b)]
            ids = rng.integers(0, len(self.portraits), len(order))
            self._cycle = list(zip(order, ids.tolist()))[::-1]
        frames, ident = self._cycle.pop()
        req = {"index": self.issued, "identity": ident, "frames": frames,
               "source": self.portraits[ident],
               "waveform": self.waveforms[ident, :samples_for_frames(frames)],
               "pose": self.poses[ident]}
        self.issued += 1
        return req


def batches(params: dict, seed: int, device) -> list:
    """``ring`` training batches on ``device``: ``example_image`` and
    ``driving`` frames smooth random fields, MFCC windows N(0, 1), poses
    N(0, 0.1^2)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    R, B, T = int(params["ring"]), int(params["batch"]), int(params["frames"])
    example = smooth_images(R * B, gen, device).view(R, B, 256, 256, 3)
    driving = smooth_images(R * B * T, gen, device).view(R, B, T, 256, 256,
                                                         3)
    audio = torch.randn(R, B, T, 28, 12, generator=gen, device=device)
    pose = 0.1 * torch.randn(R, B, T, 6, generator=gen, device=device)
    return [{"example_image": example[i], "driving": driving[i],
             "driving_audio": audio[i], "driving_pose": pose[i]}
            for i in range(R)]
