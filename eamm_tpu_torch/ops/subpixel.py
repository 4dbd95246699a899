"""Eval-mode convolution forms (NCHW, torch ``[C_out, C_in, kh, kw]``
weights): counterpart of ``eamm_tpu/ops/subpixel.py``.

Each form computes a literal convolution exactly, up to the order of
summation, with the work laid out differently:

- ``upsample_conv3x3_d2s``: ``conv3x3_pad1(nearest_up_2x(x))`` as one 3x3
  conv at the input resolution with ``4 * C_out`` phase channels, then one
  depth-to-space (``F.pixel_shuffle``).  Nearest upsampling repeats every
  pixel into a 2x2 block, so each output-parity phase (a, b) reads only two
  distinct input rows and columns: a=0 reads rows (i-1, i) with taps
  (w0, w1+w2), a=1 reads rows (i, i+1) with taps (w0+w1, w2).  The folded
  3x3 kernel embeds those 2-tap weights so that every phase reads the same
  window; the doubled input is never materialized.
- ``conv_s2d``: a stride-1 conv with a thin output computed on the
  space-to-depth grid: ``F.pixel_unshuffle`` by ``block``, one conv whose
  kernel copies (never sums) every original tap into place, then
  ``F.pixel_shuffle`` back.
- ``conv_s2d_strided``: the same conv as one stride-``block`` conv with a
  ``(k + block - 1)``-tap phase-expanded kernel, so the space-to-depth
  happens in the stride and the input is never rearranged.

Channel order (trouble spot of the port): the JAX folds put phase blocks at
channel ``(2a+b) * C + c``; ``F.pixel_shuffle`` and ``F.pixel_unshuffle``
read ``c * r^2 + (r*a + b)``, so the folds here order the channels
c-major, once, in the folded kernel.

``fold_upsample_kernel`` and ``upsample_conv3x3_folded`` are the 2x2 fold
(2.25x fewer multiply-adds, a one-pixel offset per phase): the JAX package
measured its phase interleave slower than the depth-to-space form and no
model calls it, here either; it is kept for its tests.

The folds are functions of the weights alone: a model folds once per load
of its weights (``models/blocks.py`` ``FoldedWeights``), never per call.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Row-fold matrices f[a] : taps (3,) -> folded taps (2,) per output parity
#   a=0 reads x rows (i-1, i) with weights (w0, w1+w2)
#   a=1 reads x rows (i, i+1) with weights (w0+w1, w2)
_FOLD = np.asarray(
    [[[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]],
     [[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)    # [a, r, p]

# the same per-phase 2-tap weights embedded in a 3-row window (i-1, i, i+1)
_FOLD_D2S = np.asarray(
    [[[1.0, 0.0, 0.0], [0.0, 1.0, 1.0], [0.0, 0.0, 0.0]],
     [[0.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)


def _fold_2d(fold: np.ndarray, w: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, 3, 3] -> [C_out * 4, C_in, R, R]: output channel
    ``o * 4 + 2a + b`` holds phase (a, b)'s folded taps."""
    f = torch.as_tensor(fold, dtype=w.dtype, device=w.device)
    cout, cin = w.shape[:2]
    w2 = torch.einsum("arp,bsq,oipq->oabirs", f, f, w)
    return w2.reshape(4 * cout, cin, fold.shape[1], fold.shape[1])


def fold_upsample_kernel(w: torch.Tensor) -> torch.Tensor:
    """The 2x2 fold: [C_out, C_in, 3, 3] -> [4 * C_out, C_in, 2, 2]."""
    return _fold_2d(_FOLD, w)


def upsample_conv3x3_folded(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3x3_pad1(nearest_up_2x(x))`` as one VALID 2x2 conv over the
    1-padded input -> [B, 4 * C_out, H+1, W+1], whose phase (a, b) lives at
    grid position (i+a, j+b), interleaved back to [B, C_out, 2H, 2W].  No
    bias (it commutes with the interleave).  Off every path (module
    docstring)."""
    B, _, H, W = x.shape
    C = w.shape[0]
    y = F.conv2d(F.pad(x, (1, 1, 1, 1)), fold_upsample_kernel(w))
    y = y.view(B, C, 4, H + 1, W + 1)
    t = torch.stack([y[:, :, 0, :H, :W], y[:, :, 1, :H, 1:],
                     y[:, :, 2, 1:, :W], y[:, :, 3, 1:, 1:]], dim=2)
    return F.pixel_shuffle(t.reshape(B, 4 * C, H, W), 2)


def fold_upsample_kernel_d2s(w: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, 3, 3] -> the depth-to-space fold [4 * C_out, C_in, 3, 3],
    output channel ``o * 4 + 2a + b`` (``F.pixel_shuffle``'s order)."""
    return _fold_2d(_FOLD_D2S, w)


def upsample_conv3x3_d2s(x: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         folded: bool = False) -> torch.Tensor:
    """``conv3x3_pad1(nearest_up_2x(x))`` [B, C_out, 2H, 2W] as one SAME
    3x3 conv at the input resolution + ``F.pixel_shuffle``.  ``w`` is the
    literal kernel, or with ``folded`` already ``fold_upsample_kernel_d2s``'s
    (and ``bias`` then repeated per phase, ``repeat_interleave(4)``)."""
    w3 = w if folded else fold_upsample_kernel_d2s(w)
    if bias is not None and not folded:
        bias = bias.repeat_interleave(4)
    return F.pixel_shuffle(F.conv2d(x, w3, bias, padding=1), 2)


def _s2d_fold(kernel: int, pad: int, block: int):
    """Indicator ``F[a, R, u, r] = 1`` iff output phase ``a``, original tap
    ``r`` reads the input row at relative block ``R`` (offset so R >= 0),
    within-block offset ``u``; and the (low, high) padding in whole
    blocks."""
    tmin = -pad
    tmax = block - 1 + kernel - 1 - pad
    rmin, rmax = tmin // block, tmax // block
    fold = np.zeros((block, rmax - rmin + 1, block, kernel), np.float32)
    for a in range(block):
        for r in range(kernel):
            t = a + r - pad
            fold[a, t // block - rmin, t % block, r] = 1.0
    return fold, (-rmin, rmax)


def fold_conv_kernel_s2d(w: torch.Tensor, block: int,
                         pad: int | None = None):
    """[C_out, C_in, kh, kw] -> (the space-to-depth fold [block^2 * C_out,
    block^2 * C_in, Kh, Kw], row pads, column pads), channels in
    ``F.pixel_shuffle`` / ``F.pixel_unshuffle`` order."""
    cout, cin, kh, kw = w.shape
    fr, pads_r = _s2d_fold(kh, kh // 2 if pad is None else pad, block)
    fc, pads_c = _s2d_fold(kw, kw // 2 if pad is None else pad, block)
    f_r = torch.as_tensor(fr, dtype=w.dtype, device=w.device)
    f_c = torch.as_tensor(fc, dtype=w.dtype, device=w.device)
    w2 = torch.einsum("aRur,eScs,oirs->oaeiucRS", f_r, f_c, w)
    return (w2.reshape(block * block * cout, block * block * cin,
                       fr.shape[1], fc.shape[1]), pads_r, pads_c)


def _check_blocks(x: torch.Tensor, block: int) -> None:
    if x.shape[2] % block or x.shape[3] % block:
        raise ValueError(f"spatial dims {tuple(x.shape[2:])} not divisible "
                         f"by {block}")


def conv_s2d_folded(x: torch.Tensor, w2: torch.Tensor, pads_r: tuple,
                    pads_c: tuple, block: int,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """``conv_s2d`` with the kernel already folded (``fold_conv_kernel_s2d``)
    and ``bias``, if any, repeated per phase."""
    _check_blocks(x, block)
    z = F.pixel_unshuffle(x, block)
    if pads_r[0] == pads_r[1] and pads_c[0] == pads_c[1]:
        y = F.conv2d(z, w2, bias, padding=(pads_r[0], pads_c[0]))
    else:
        y = F.conv2d(F.pad(z, (pads_c[0], pads_c[1], pads_r[0], pads_r[1])),
                     w2, bias)
    return F.pixel_shuffle(y, block)


def conv_s2d(x: torch.Tensor, w: torch.Tensor, block: int = 4,
             pad: int | None = None) -> torch.Tensor:
    """Stride-1 conv (SAME by default, ``pad`` on every side otherwise; the
    output has x's size either way, so with ``pad=0`` the VALID result is
    its top-left slice) on the space-to-depth grid: [B, C_in, H, W] ->
    pixel_unshuffle -> conv -> pixel_shuffle -> [B, C_out, H, W]."""
    w2, pads_r, pads_c = fold_conv_kernel_s2d(w, block, pad)
    return conv_s2d_folded(x, w2, pads_r, pads_c, block)


def fold_conv_kernel_s2d_strided(w: torch.Tensor,
                                 block: int) -> torch.Tensor:
    """[C_out, C_in, k, k] -> the phase-expanded kernel [block^2 * C_out,
    C_in, k + block - 1, k + block - 1]: output channel (o, a, e) holds w
    shifted by (a, e)."""
    cout, cin, kh, kw = w.shape
    wp = w.new_zeros((cout, block, block, cin, kh + block - 1,
                      kw + block - 1))
    for a in range(block):
        for e in range(block):
            wp[:, a, e, :, a:a + kh, e:e + kw] = w
    return wp.reshape(cout * block * block, cin, kh + block - 1,
                      kw + block - 1)


def conv_s2d_strided(x: torch.Tensor, w: torch.Tensor, block: int = 4,
                     bias: torch.Tensor | None = None,
                     folded: bool = False) -> torch.Tensor:
    """Stride-1 SAME thin-output conv as one stride-``block`` conv with the
    phase-expanded kernel (``fold_conv_kernel_s2d_strided``, or ``w``
    itself with ``folded``, ``bias`` then repeated per phase), padding
    (k//2, k-1-k//2), then ``F.pixel_shuffle``."""
    _check_blocks(x, block)
    wp = w if folded else fold_conv_kernel_s2d_strided(w, block)
    if bias is not None and not folded:
        bias = bias.repeat_interleave(block * block)
    k = wp.shape[-1] - block + 1
    p = k // 2
    if p == k - 1 - p:
        y = F.conv2d(x, wp, bias, stride=block, padding=p)
    else:
        y = F.conv2d(F.pad(x, (p, k - 1 - p, p, k - 1 - p)), wp, bias,
                     stride=block)
    return F.pixel_shuffle(y, block)
