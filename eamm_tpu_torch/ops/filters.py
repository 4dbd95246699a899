"""One-Euro temporal filter (PyTorch counterpart of
``eamm_tpu/ops/filters.py``).

The first sample passes through (s = x, derivative seeded with 0); after it
the derivative is low-passed at ``dcutoff`` and the value at an adaptive
cutoff ``mincutoff + beta |dx|``.  ``scale`` multiplies the values before
filtering and divides after, which changes the adaptive cutoff because beta
multiplies |dx| (the reference's ``filter(x * 100) / 100`` pattern).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _alpha(cutoff, freq: float):
    te = 1.0 / freq
    tau = 1.0 / (2.0 * math.pi * cutoff)
    return 1.0 / (1.0 + tau / te)


def one_euro_init(shape, dtype: torch.dtype = torch.float32,
                  device=None) -> tuple:
    """A fresh filter state for samples of ``shape``: (raw, filtered,
    derivative, started), the first three in the scaled domain."""
    zeros = torch.zeros(shape, dtype=dtype, device=device)
    return (zeros, zeros, zeros,
            torch.zeros(shape, dtype=torch.bool, device=device))


def one_euro_filter(x: torch.Tensor, *, mincutoff: float = 1.0,
                    beta: float = 0.0, dcutoff: float = 1.0,
                    freq: float = 30.0, scale: float = 1.0, carry=None,
                    return_carry: bool = False):
    """Filter a [T, ...] tensor along its leading (time) axis; a loop over
    T on the tensor's device.

    ``carry`` is the state a call with ``return_carry=True`` returned (or
    ``one_euro_init``): filtering a sequence in chunks with the state
    threaded through gives the whole sequence's result bit for bit, since
    every step after a chunk's first is the whole sequence's step and the
    first selects it wherever the state has started."""
    xs = x * scale
    d_alpha = _alpha(dcutoff, freq)
    out = torch.empty_like(xs)
    prev_raw = prev_filt = prev_dfilt = started = None
    if carry is not None:
        prev_raw, prev_filt, prev_dfilt, started = carry
    for t in range(xs.shape[0]):
        xt = xs[t]
        if prev_raw is None:
            edx = torch.zeros_like(xt)
            s = xt
        else:
            dx = (xt - prev_raw) * freq
            edx = d_alpha * dx + (1.0 - d_alpha) * prev_dfilt
            a = _alpha(mincutoff + beta * edx.abs(), freq)
            s = a * xt + (1.0 - a) * prev_filt
            if started is not None:      # a carried state: fresh where unset
                edx = torch.where(started, edx, torch.zeros_like(xt))
                s = torch.where(started, s, xt)
                started = None
        prev_raw, prev_filt, prev_dfilt = xt, s, edx
        out[t] = s
    ys = out / scale
    if not return_carry:
        return ys
    return ys, (prev_raw, prev_filt, prev_dfilt,
                torch.ones(xs.shape[1:], dtype=torch.bool, device=xs.device))


def one_euro_filter_np(x: np.ndarray, *, mincutoff: float = 1.0,
                       beta: float = 0.0, dcutoff: float = 1.0,
                       freq: float = 30.0, scale: float = 1.0) -> np.ndarray:
    """Host numpy ``one_euro_filter`` in float64, returned in x's dtype (the
    pipeline's pose smoothing runs it before anything reaches the device)."""
    dtype = np.asarray(x).dtype
    xs = np.asarray(x, np.float64) * scale
    d_alpha = _alpha(dcutoff, freq)
    ys = np.empty_like(xs)
    prev_raw = prev_filt = prev_dfilt = None
    for t in range(xs.shape[0]):
        xt = xs[t]
        if prev_raw is None:
            edx = np.zeros_like(xt)
            s = xt
        else:
            dx = (xt - prev_raw) * freq
            edx = d_alpha * dx + (1.0 - d_alpha) * prev_dfilt
            a = _alpha(mincutoff + beta * np.abs(edx), freq)
            s = a * xt + (1.0 - a) * prev_filt
        prev_raw, prev_filt, prev_dfilt = xt, s, edx
        ys[t] = s
    return (ys / scale).astype(dtype)
