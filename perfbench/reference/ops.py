"""Plain PyTorch and numpy functions of the EAMM render, written out from
the reference's published description (First Order Motion Model's
``modules/util.py``, python_speech_features' defaults, the one-euro filter
and BT.601 full-range colour), for the benchmark's reference.

Nothing here imports the program under test.  Images are NHWC where the
name says so and NCHW otherwise; every function computes in the dtype it
is given.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ audio

SAMPLE_RATE = 16000
PAD_SAMPLES = 1920          # zeros before and after the clip
WIN_LEN, WIN_STEP, NFFT = 400, 160, 512
NFILT, NUMCEP, CEPLIFTER = 26, 13, 22


def num_mfcc_frames(n_samples: int) -> int:
    if n_samples <= WIN_LEN:
        return 1
    return 1 + int(math.ceil((n_samples - WIN_LEN) / float(WIN_STEP)))


def frames_for_samples(n_samples: int) -> int:
    """Video frames (MFCC windows of 28 rows, one every 4) a clip of
    ``n_samples`` 16 kHz samples yields, the 1920-sample pads included."""
    return max(0, num_mfcc_frames(n_samples + 2 * PAD_SAMPLES) // 4 - 6)


def samples_for_frames(frames: int) -> int:
    """The fewest samples that yield ``frames`` frames."""
    n = 640 * frames
    while frames_for_samples(n) < frames:
        n += WIN_STEP
    while n > WIN_STEP and frames_for_samples(n - WIN_STEP) >= frames:
        n -= WIN_STEP
    return n


def _mel_filters() -> np.ndarray:
    def hz2mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def mel2hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    mel = np.linspace(hz2mel(0.0), hz2mel(SAMPLE_RATE / 2), NFILT + 2)
    bins = np.floor((NFFT + 1) * mel2hz(mel) / SAMPLE_RATE)
    bank = np.zeros((NFILT, NFFT // 2 + 1))
    for j in range(NFILT):
        lo, mid, hi = bins[j:j + 3]
        for i in range(int(lo), int(mid)):
            bank[j, i] = (i - lo) / (mid - lo)
        for i in range(int(mid), int(hi)):
            bank[j, i] = (hi - i) / (hi - mid)
    return bank


def mfcc_windows(waveform: torch.Tensor) -> torch.Tensor:
    """[N] 16 kHz float waveform -> [T, 28, 12] MFCC windows: 25 ms
    rectangular frames every 10 ms, pre-emphasis 0.97, 512-point power
    spectrum, 26 mel filters, log, orthonormal DCT-II keeping 13, lifter 22,
    cepstrum 0 the log frame energy; window t is rows 4t .. 4t+27 without
    cepstrum 0.  Computed in float64, returned in float32."""
    dev = waveform.device
    x = F.pad(waveform.double(), (PAD_SAMPLES, PAD_SAMPLES))
    x = torch.cat([x[:1], x[1:] - 0.97 * x[:-1]])
    n = num_mfcc_frames(x.shape[0])
    x = F.pad(x, (0, max(0, (n - 1) * WIN_STEP + WIN_LEN - x.shape[0])))
    frames = x.unfold(0, WIN_LEN, WIN_STEP)[:n]
    power = torch.fft.rfft(frames, n=NFFT).abs() ** 2 / NFFT
    eps = float(np.finfo(np.float32).eps)
    energy = power.sum(1)
    energy = torch.where(energy == 0, eps, energy)
    bank = torch.as_tensor(_mel_filters(), device=dev)
    feat = power @ bank.T
    feat = torch.log(torch.where(feat == 0, eps, feat))
    k = torch.arange(NUMCEP, device=dev, dtype=torch.float64)
    i = torch.arange(NFILT, device=dev, dtype=torch.float64)
    dct = torch.cos(math.pi * k[None] * (2 * i[:, None] + 1) / (2 * NFILT))
    dct = dct * math.sqrt(2.0 / NFILT)
    dct[:, 0] = math.sqrt(1.0 / NFILT)
    cep = feat @ dct
    cep = cep * (1 + CEPLIFTER / 2 * torch.sin(math.pi * k / CEPLIFTER))
    cep[:, 0] = torch.log(energy)
    T = max(0, n // 4 - 6)
    return torch.stack([cep[4 * t:4 * t + 28, 1:] for t in range(T)]).float()


# ------------------------------------------------------------ smoothing

def one_euro(x, *, mincutoff: float, beta: float, freq: float,
             scale: float = 1.0, dcutoff: float = 1.0):
    """The one-euro filter along axis 0 of a numpy array or a tensor, in its
    dtype: the first sample passes, then the derivative is low-passed at
    ``dcutoff`` and the value at ``mincutoff + beta |dx|``; values are
    multiplied by ``scale`` before and divided after."""
    def alpha(cutoff):
        tau = 1.0 / (2.0 * math.pi * cutoff)
        return 1.0 / (1.0 + tau * freq)

    xs = x * scale
    ys = [xs[0]]
    dx_prev = xs[0] * 0
    for t in range(1, xs.shape[0]):
        dx = alpha(dcutoff) * (xs[t] - xs[t - 1]) * freq \
            + (1 - alpha(dcutoff)) * dx_prev
        a = alpha(mincutoff + beta * abs(dx))
        ys.append(a * xs[t] + (1 - a) * ys[-1])
        dx_prev = dx
    stack = np.stack if isinstance(x, np.ndarray) else torch.stack
    return stack(ys) / scale


def pose_track(pose: np.ndarray, frames: int) -> np.ndarray:
    """[M, 7] head pose -> [frames, 6]: one pose held for 100 frames, a
    track one-euro smoothed (in float64), a short track extended back and
    forth."""
    p = np.asarray(pose, np.float32).reshape(-1, 7)[:, :6]
    if len(p) == 1:
        p = np.repeat(p, 100, 0)
    else:
        p = one_euro(p.astype(np.float64), mincutoff=0.004, beta=0.7,
                     freq=100).astype(np.float32)
    while len(p) < frames:
        p = np.concatenate([p, p[::-1]])
    return p[:frames]


# ------------------------------------------------------------- geometry

def coordinate_grid(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """[h, w, 2] (x, y) in [-1, 1], corners included."""
    x = torch.linspace(-1, 1, w, dtype=like.dtype, device=like.device)
    y = torch.linspace(-1, 1, h, dtype=like.dtype, device=like.device)
    return torch.stack([x[None].expand(h, w), y[:, None].expand(h, w)], -1)


def blur_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """NCHW anti-aliased downsample: a 2-D Gaussian (sigma 1.5, 13 taps,
    normalized) with zero padding, then every 1/scale-th pixel."""
    if scale == 1:
        return x
    sigma, size = 1.5, 13
    t = torch.arange(size, dtype=torch.float64)
    g = torch.exp(-(t - (size - 1) / 2) ** 2 / (2 * sigma ** 2))
    g = g / g.sum()
    k = (g[:, None] * g[None, :]).to(x)
    C = x.shape[1]
    out = F.conv2d(x, k.expand(C, 1, size, size), padding=size // 2,
                   groups=C)
    step = int(1 / scale)
    return out[:, :, ::step, ::step]


def gaussian_maps(kp: torch.Tensor, h: int, w: int,
                  variance: float = 0.01) -> torch.Tensor:
    """[B, K, 2] keypoints -> [B, K, h, w] Gaussians around them."""
    d = coordinate_grid(h, w, kp)[None, None] - kp[:, :, None, None]
    return torch.exp(-0.5 * (d ** 2).sum(-1) / variance)


def soft_keypoints(logits: torch.Tensor, jmaps: torch.Tensor,
                   temperature: float) -> dict:
    """Keypoint heads' maps -> value [B, K, 2] (the heatmap's expected
    position), Jacobian [B, K, 2, 2] (its heatmap-weighted maps) and the
    heatmap [B, K, h, w] (softmax at ``temperature``)."""
    B, K, h, w = logits.shape
    heat = torch.softmax(logits.reshape(B, K, -1) / temperature, -1)
    heat = heat.reshape(B, K, h, w)
    grid = coordinate_grid(h, w, logits)
    value = (heat[..., None] * grid).sum((2, 3))
    jac = (heat[:, :, None] * jmaps.reshape(B, K, 4, h, w)).sum((3, 4))
    return {"value": value, "jacobian": jac.reshape(B, K, 2, 2),
            "heatmap": heat}


def warp(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear samples, zeros outside, half-pixel corners: NCHW
    ``image`` [Bi, C, H, W] by ``grid`` [B, h, w, 2] with B a multiple of
    Bi, grid b reading image b // (B // Bi)."""
    group = grid.shape[0] // image.shape[0]
    if group > 1:
        image = image.repeat_interleave(group, 0)
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def motion_grids(h: int, w: int, kp_d: dict, kp_s: dict) -> torch.Tensor:
    """[B, K+1, h, w, 2]: the identity, then for each keypoint the
    first-order motion J_s J_d^-1 (z - kp_d) + kp_s."""
    ident = coordinate_grid(h, w, kp_d["value"])
    B = kp_d["value"].shape[0]
    z = ident[None, None] - kp_d["value"][:, :, None, None]
    jac = kp_s["jacobian"] @ torch.linalg.inv(kp_d["jacobian"])
    moved = (jac[:, :, None, None] @ z[..., None])[..., 0] \
        + kp_s["value"][:, :, None, None]
    return torch.cat([ident[None, None].expand(B, 1, h, w, 2), moved], 1)


# ---------------------------------------------------------------- colour

def yuv420(rgb: torch.Tensor):
    """[N, 3, H, W] RGB in [0, 1] -> (Y [N, H, W], U, V [N, H/2, W/2])
    uint8, BT.601 full range, chroma the mean of each 2x2 block, rounded
    half to even and clipped."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b
    v = 0.5 * r - 0.418688 * g - 0.081312 * b

    def q(p, offset=0.0):
        return torch.clamp(torch.round(p * 255.0 + offset), 0, 255).to(
            torch.uint8)

    return (q(y), q(F.avg_pool2d(u[:, None], 2)[:, 0], 128.0),
            q(F.avg_pool2d(v[:, None], 2)[:, 0], 128.0))
