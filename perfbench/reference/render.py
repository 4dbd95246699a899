"""The reference render of one neutral request, from its raw inputs.

portrait, 16 kHz waveform and head pose -> MFCC windows -> ATNet ->
audio keypoints -> one-euro smoothing -> the generator, frame by frame in
chunks -> yuv420 planes, every network in float32 with TF32 off.

The same render in a lower precision is the yardstick and the control:
``precision`` 'bfloat16' computes the generator as the configuration
states (every weight, every input and every tensor that any operation of
the decode makes rounded to bfloat16, as the program holds them), and
'fp8' one step below (each such tensor rounded to float8 e4m3 under its
own scale), with the keypoint networks in TF32.
The neutral batch render moves the frames by the smoothed audio
keypoints as they are (no relative movement), which this follows.
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

from perfbench.reference import ops

CHUNK = 32            # frames a generator call; any size gives the same frames
EURO = {"mincutoff": 0.05, "beta": 8.0, "freq": 100, "scale": 10.0}


@contextlib.contextmanager
def tf32(enabled: bool):
    """Matrix products and cuDNN convolutions in TF32 for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded to ``precision`` ('bfloat16', or 'fp8': float8 e4m3
    under a per-tensor scale that maps its largest magnitude to 448), back
    in its own dtype."""
    if precision == "bfloat16":
        return t.to(torch.bfloat16).to(t.dtype)
    if t.numel() == 0:
        return t
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Precision(TorchDispatchMode):
    """Every floating tensor that an operation makes inside the block is
    rounded to ``precision`` (``rounded``); views pass as they are, and an
    operation that writes into its input rounds it in place."""

    def __init__(self, precision: str):
        super().__init__()
        self.precision = precision

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        alias = [r.alias_info for r in func._schema.returns]
        if any(a is not None and not a.is_write for a in alias):
            return out

        def fix(t):
            if not t.is_floating_point():
                return t
            if any(a is not None for a in alias):
                return t.copy_(rounded(t, self.precision))
            return rounded(t, self.precision)
        return tree_map_only(torch.Tensor, fix, out)


def lowered(generator: torch.nn.Module, precision: str) -> torch.nn.Module:
    """A copy of ``generator`` with every floating parameter and buffer
    rounded to ``precision``."""
    out = copy.deepcopy(generator)
    with torch.no_grad():
        for t in out.state_dict().values():
            if t.is_floating_point():
                t.copy_(rounded(t, precision))
    return out


@torch.no_grad()
def render(nets: dict, source: np.ndarray, waveform: np.ndarray,
           pose: np.ndarray, device, audio_weight: float,
           precision: str | None = None, euro: dict | None = None):
    """One request -> (Y [T, 256, 256], U, V [T, 128, 128]) uint8 numpy, T
    the frames its waveform yields.  ``nets`` are eval-mode reference
    networks on ``device``.  With ``precision`` the decode runs in it
    (``nets['generator']`` is to have been made by ``lowered``; its
    inputs, the source and the keypoints, are rounded too, as the program
    casts them), and with 'fp8' the keypoint networks run in TF32.
    ``euro`` overrides the one-euro filter's parameters."""
    T = ops.frames_for_samples(len(waveform))
    wav = torch.as_tensor(np.asarray(waveform, np.float32), device=device)
    windows = ops.mfcc_windows(wav)[:T]
    track = torch.as_tensor(ops.pose_track(pose, T), device=device)
    src = torch.as_tensor(np.asarray(source, np.float32),
                          device=device).permute(2, 0, 1)[None]
    with tf32(precision == "fp8"):
        kp_s = nets["kp_detector"](src)
        maps = nets["audio_feature"](src, windows[None], track[None],
                                     audio_weight)[0]
        kp_a = nets["kp_detector_a"](maps)
    params = dict(EURO, **(euro or {}))
    kp_d = {k: ops.one_euro(kp_a[k], **params) for k in ("value", "jacobian")}
    kp_s = {k: kp_s[k] for k in ("value", "jacobian")}
    gen = nets["generator"]
    mode = contextlib.nullcontext()
    if precision is not None:
        src = rounded(src, precision)
        kp_d = {k: rounded(v, precision) for k, v in kp_d.items()}
        kp_s = {k: rounded(v, precision) for k, v in kp_s.items()}
        mode = Precision(precision)
    planes = []
    with mode:
        feats = gen.encode_source(src)
        for t in range(0, T, CHUNK):
            n = min(CHUNK, T - t)
            frames = gen.decode(
                src, feats, {k: v[t:t + n] for k, v in kp_d.items()},
                {k: v.expand(n, *v.shape[1:]) for k, v in kp_s.items()})
            planes.append(frames)
    # the colour conversion outside the block, in float32 as the program's
    return tuple(np.concatenate(p) for p in zip(*(
        tuple(q.cpu().numpy() for q in ops.yuv420(f.float()))
        for f in planes)))
