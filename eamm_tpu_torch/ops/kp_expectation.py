"""The keypoint expectation of both keypoint heads, as a CUDA kernel.

Replaces ``eamm_tpu/ops/kp_expectation.py::kp_expectation`` (its Pallas
forward).  From logits ``pred`` [B, K, h, w] and Jacobian maps ``jmap``
[B, K, 4, h, w] it computes, per (b, k):

  * ``value``    [B, K, 2]    — the softmax(pred / T) weighted mean of the
    align-corners [-1, 1]^2 grid (soft-argmax);
  * ``jacobian`` [B, K, 2, 2] — the same weighting of the four maps.

The kernel (``csrc/kp_expectation.cu``) reads both inputs in place through
their strides, so the heads pass slices of one conv output uncopied.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``kp_expectation.launches`` counts the launches.
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


kp_expectation.launches = 0
