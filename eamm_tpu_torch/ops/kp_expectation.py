"""The keypoint expectation of the keypoint heads, as CUDA kernels.

``kp_expectation`` replaces ``eamm_tpu/ops/kp_expectation.py::
kp_expectation`` (its Pallas forward); ``kp_expectation_fused`` replaces
``eamm_tpu/ops/kp_pallas.py::kp_expectation_fused`` (the same math for
float32 or bfloat16 inputs, plus the normalized heatmap on request; no
model calls it).  From logits ``pred`` [B, K, h, w] and Jacobian maps ``jmap``
[B, K, 4, h, w] it computes, per (b, k):

  * ``value``    [B, K, 2]    — the softmax(pred / T) weighted mean of the
    align-corners [-1, 1]^2 grid (soft-argmax);
  * ``jacobian`` [B, K, 2, 2] — the same weighting of the four maps.

The kernel (``csrc/kp_expectation.cu``) reads both inputs in place through
their strides, so the heads pass slices of one conv output uncopied.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from eamm_tpu_torch import kernels
from eamm_tpu_torch.ops.grid import gaussian2kp, heatmap_softmax


def kp_expectation_plain(pred: torch.Tensor, jmap: torch.Tensor,
                         temperature: float):
    """The plain version: softmax heatmap, soft-argmax, weighted Jacobian."""
    heat = heatmap_softmax(pred, temperature)
    value = gaussian2kp(heat)
    jac = (heat[:, :, None] * jmap).sum(dim=(-2, -1))
    B, K = pred.shape[:2]
    return value, jac.reshape(B, K, 2, 2)


def _check(pred: torch.Tensor, jmap: torch.Tensor) -> None:
    if pred.dim() != 4 or jmap.dim() != 5 or jmap.shape[2] != 4 \
            or jmap.shape[:2] != pred.shape[:2] \
            or jmap.shape[3:] != pred.shape[2:]:
        raise ValueError(f"need pred [B,K,h,w] and jmap [B,K,4,h,w], got "
                         f"{tuple(pred.shape)} and {tuple(jmap.shape)}")
    if pred.device != jmap.device:
        raise ValueError(f"pred on {pred.device}, jmap on {jmap.device}")


def kp_expectation(pred: torch.Tensor, jmap: torch.Tensor,
                   temperature: float):
    """(value [B,K,2], jacobian [B,K,2,2]) from pred [B,K,h,w] and jmap
    [B,K,4,h,w]."""
    _check(pred, jmap)
    if pred.device.type == "cpu":
        return kp_expectation_plain(pred, jmap, temperature)
    if pred.device.type != "cuda":
        raise ValueError(f"kp_expectation: tensors on {pred.device}; the "
                         "kernel runs on CUDA and the plain version on the CPU")
    if pred.dtype != torch.float32 or jmap.dtype != torch.float32:
        raise TypeError(f"kp_expectation: need float32, got {pred.dtype} and "
                        f"{jmap.dtype}")
    B, K, h, w = pred.shape
    for name, t in (("pred", pred), ("jmap", jmap)):
        if t.stride(-1) != 1 or t.stride(-2) != w:
            raise ValueError(f"kp_expectation: each {name} row of h*w must "
                             f"be contiguous, strides {t.stride()}")
    if B * K == 0 or h < 2 or w < 2:
        raise ValueError(f"kp_expectation: shape {tuple(pred.shape)} needs "
                         "rows and h, w >= 2")
    value = torch.empty((B, K, 2), dtype=torch.float32, device=pred.device)
    jac = torch.empty((B, K, 2, 2), dtype=torch.float32, device=pred.device)
    lib = kernels.library("kp_expectation")
    fn = lib.eamm_kp_expectation
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(pred.data_ptr(), pred.stride(0), pred.stride(1),
              jmap.data_ptr(), jmap.stride(0), jmap.stride(1), jmap.stride(2),
              value.data_ptr(), jac.data_ptr(), B, K, h, w, float(temperature),
              torch.cuda.current_stream(pred.device).cuda_stream)
    kernels.check(lib, code, "kp_expectation")
    kp_expectation.launches += 1
    return value, jac


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the row's logits stay in shared memory: at most 192 KB of the 227 KB
MAX_FUSED_PIXELS = 48 * 1024


def kp_expectation_fused_plain(prediction: torch.Tensor, jmap: torch.Tensor,
                               temperature: float,
                               want_heatmap: bool = False):
    """The plain version of ``kp_expectation_fused``, in float32."""
    pred = prediction.float()
    value, jac = kp_expectation_plain(pred, jmap.float(), temperature)
    heat = (heatmap_softmax(pred, temperature).to(prediction.dtype)
            if want_heatmap else None)
    return value, jac, heat


def kp_expectation_fused(prediction: torch.Tensor, jmap: torch.Tensor,
                         temperature: float, want_heatmap: bool = False):
    """(value [B,K,2] f32, jacobian [B,K,2,2] f32, heatmap [B,K,h,w] in the
    prediction's dtype or None) from prediction [B,K,h,w] and jmap
    [B,K,4,h,w], each float32 or bfloat16 (read as float32).  The TPU
    kernel's row and lane padding with -1e9 logits is TPU layout and has
    no counterpart here."""
    _check(prediction, jmap)
    if prediction.device.type == "cpu":
        return kp_expectation_fused_plain(prediction, jmap, temperature,
                                          want_heatmap)
    if prediction.device.type != "cuda":
        raise ValueError(f"kp_expectation_fused: tensors on "
                         f"{prediction.device}; the kernel runs on CUDA and "
                         "the plain version on the CPU")
    if prediction.dtype not in _DTYPES or jmap.dtype not in _DTYPES:
        raise TypeError(f"kp_expectation_fused: prediction {prediction.dtype},"
                        f" jmap {jmap.dtype}; each must be float32 or "
                        "bfloat16")
    B, K, h, w = prediction.shape
    for name, t in (("prediction", prediction), ("jmap", jmap)):
        if t.stride(-1) != 1 or t.stride(-2) != w:
            raise ValueError(f"kp_expectation_fused: each {name} row of h*w "
                             f"must be contiguous, strides {t.stride()}")
    if B * K == 0 or h < 2 or w < 2 or h * w > MAX_FUSED_PIXELS:
        raise ValueError(f"kp_expectation_fused: shape "
                         f"{tuple(prediction.shape)} needs rows, h, w >= 2 "
                         f"and h*w <= {MAX_FUSED_PIXELS}")
    dev = prediction.device
    value = torch.empty((B, K, 2), dtype=torch.float32, device=dev)
    jac = torch.empty((B, K, 2, 2), dtype=torch.float32, device=dev)
    heat = (torch.empty((B, K, h, w), dtype=prediction.dtype, device=dev)
            if want_heatmap else None)
    lib = kernels.library("kp_expectation")
    fn = lib.eamm_kp_expectation_fused
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(prediction.data_ptr(), _DTYPES[prediction.dtype],
              prediction.stride(0), prediction.stride(1),
              jmap.data_ptr(), _DTYPES[jmap.dtype],
              jmap.stride(0), jmap.stride(1), jmap.stride(2),
              value.data_ptr(), jac.data_ptr(),
              heat.data_ptr() if heat is not None else None,
              B, K, h, w, float(temperature),
              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, "kp_expectation_fused")
    kp_expectation_fused.launches += 1
    return value, jac, heat


kp_expectation.launches = 0
kp_expectation_fused.launches = 0
