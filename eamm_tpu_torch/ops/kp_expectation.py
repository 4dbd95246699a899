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
their strides, so the heads pass slices of one conv output uncopied.  Each
kernel is an operator, ``torch.ops.eamm.kp_expectation`` and
``kp_expectation_fused`` (``torch.library.custom_op``), kept as a call by
``torch.export``: its CPU implementation is the plain version, its CUDA
implementation launches the kernel or raises and counts the launch in the
wrapper's ``launches`` attribute, and its fake implementation gives the
outputs' shapes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

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


def _cuda_check(name: str, pred: torch.Tensor) -> None:
    if pred.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {pred.device}; the kernel runs "
                         "on CUDA and the plain version on the CPU")


def kp_expectation(pred: torch.Tensor, jmap: torch.Tensor,
                   temperature: float):
    """(value [B,K,2], jacobian [B,K,2,2]) from pred [B,K,h,w] and jmap
    [B,K,4,h,w]."""
    _check(pred, jmap)
    _cuda_check("kp_expectation", pred)
    return kp_expectation_op(pred, jmap, float(temperature))


@torch.library.custom_op("eamm::kp_expectation", mutates_args=(),
                         device_types="cpu")
def kp_expectation_op(pred: torch.Tensor, jmap: torch.Tensor,
                      temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    return kp_expectation_plain(pred, jmap, temperature)


@kp_expectation_op.register_fake
def _kp_expectation_fake(pred, jmap, temperature):
    B, K = pred.shape[:2]
    return (pred.new_empty((B, K, 2), dtype=torch.float32),
            pred.new_empty((B, K, 2, 2), dtype=torch.float32))


@kp_expectation_op.register_kernel("cuda")
def _kp_expectation_cuda(pred, jmap, temperature):
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
# the largest row the fused kernel takes: with the heatmap, its float32
# logits fill 192 KB of a block's 227 KB of shared memory
MAX_FUSED_PIXELS = 48 * 1024
# the dynamic shared memory a block may take: sm_90's 232448 bytes less
# the kernel's static scratch (csrc/kp_expectation.cu kFusedSmemBudget)
FUSED_SMEM_BUDGET = 232448 - 4 * (8 + 8 * 7)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """How ``kp_expectation_fused`` launches: dynamic shared memory per
    block, whether it holds the coordinate tables gx[w], gy[h], the blocks
    the card holds at once at that size, the blocks launched and the most
    rows one block walks."""
    smem_bytes: int
    tables: bool
    resident: int
    blocks: int
    rows_per_block: int


def fused_plan(B: int, K: int, h: int, w: int, want_heatmap: bool,
               resident: Callable[[int], int]) -> FusedPlan:
    """The fused kernel's launch for B*K rows of h*w pixels: the row's
    float32 logits in shared memory when the heatmap is wanted, the
    coordinate tables where they fit beside them, and persistent blocks,
    no more than ``resident(smem_bytes)`` (the blocks the card holds at
    once at that size), balanced so that each walks the same number of
    rows, give or take one.  Raises ``ValueError`` past
    ``MAX_FUSED_PIXELS``."""
    if h * w > MAX_FUSED_PIXELS:
        raise ValueError(f"kp_expectation_fused: {h}x{w} pixels is more "
                         f"than MAX_FUSED_PIXELS ({MAX_FUSED_PIXELS}), the "
                         "largest row the kernel takes")
    logits = 4 * h * w if want_heatmap else 0
    tables = logits + 4 * (h + w) <= FUSED_SMEM_BUDGET
    smem = logits + 4 * (h + w) if tables else logits
    held = resident(smem)
    rows_per_block = -(-B * K // held)
    return FusedPlan(smem_bytes=smem, tables=tables, resident=held,
                     blocks=-(-B * K // rows_per_block),
                     rows_per_block=rows_per_block)


@functools.lru_cache(maxsize=None)
def _fused_resident(device: torch.device, pdtype: int, jdtype: int,
                    smem: int) -> int:
    """The fused kernel's blocks that ``device`` holds at once with
    ``smem`` bytes of dynamic shared memory each, asked once per device,
    dtypes and size, so that a launch (or a CUDA graph's capture of it)
    makes no other runtime call; the query also lets the kernel take that
    much shared memory."""
    lib = kernels.library("kp_expectation")
    fn = lib.eamm_kp_expectation_fused_resident
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        kernels.check(lib, fn(pdtype, jdtype, smem, ctypes.byref(out)),
                      "kp_expectation_fused occupancy")
    if out.value < 1:
        raise RuntimeError(f"kp_expectation_fused: no block of {smem} bytes "
                           f"of shared memory fits on {device}")
    return out.value


def fused_launch_plan(prediction: torch.Tensor, jmap: torch.Tensor,
                      want_heatmap: bool) -> FusedPlan:
    """The plan ``kp_expectation_fused`` launches with for these CUDA
    tensors."""
    B, K, h, w = prediction.shape
    return fused_plan(B, K, h, w, want_heatmap, functools.partial(
        _fused_resident, prediction.device, _DTYPES[prediction.dtype],
        _DTYPES[jmap.dtype]))


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
    [B,K,4,h,w], each float32 or bfloat16 (read as float32).  The kernel
    runs persistent blocks that walk the rows, one pass over each row's
    five planes (``fused_plan``).  The TPU kernel's row and lane padding
    with -1e9 logits is TPU layout and has no counterpart here."""
    _check(prediction, jmap)
    _cuda_check("kp_expectation_fused", prediction)
    value, jac, heat = kp_expectation_fused_op(
        prediction, jmap, float(temperature), bool(want_heatmap))
    return value, jac, heat if want_heatmap else None


@torch.library.custom_op("eamm::kp_expectation_fused", mutates_args=(),
                         device_types="cpu")
def kp_expectation_fused_op(prediction: torch.Tensor, jmap: torch.Tensor,
                            temperature: float, want_heatmap: bool
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The operator: the heatmap is an empty tensor when not wanted."""
    value, jac, heat = kp_expectation_fused_plain(prediction, jmap,
                                                  temperature, want_heatmap)
    return value, jac, heat if want_heatmap else prediction.new_empty(0)


@kp_expectation_fused_op.register_fake
def _kp_expectation_fused_fake(prediction, jmap, temperature, want_heatmap):
    B, K = prediction.shape[:2]
    return (prediction.new_empty((B, K, 2), dtype=torch.float32),
            prediction.new_empty((B, K, 2, 2), dtype=torch.float32),
            prediction.new_empty(prediction.shape if want_heatmap else 0))


@kp_expectation_fused_op.register_kernel("cuda")
def _kp_expectation_fused_cuda(prediction, jmap, temperature, want_heatmap):
    if prediction.dtype not in _DTYPES or jmap.dtype not in _DTYPES:
        raise TypeError(f"kp_expectation_fused: prediction {prediction.dtype},"
                        f" jmap {jmap.dtype}; each must be float32 or "
                        "bfloat16")
    B, K, h, w = prediction.shape
    for name, t in (("prediction", prediction), ("jmap", jmap)):
        if t.stride(-1) != 1 or t.stride(-2) != w:
            raise ValueError(f"kp_expectation_fused: each {name} row of h*w "
                             f"must be contiguous, strides {t.stride()}")
    if B * K == 0 or h < 2 or w < 2:
        raise ValueError(f"kp_expectation_fused: shape "
                         f"{tuple(prediction.shape)} needs rows and h, w >= 2")
    plan = fused_launch_plan(prediction, jmap, want_heatmap)
    dev = prediction.device
    value = torch.empty((B, K, 2), dtype=torch.float32, device=dev)
    jac = torch.empty((B, K, 2, 2), dtype=torch.float32, device=dev)
    heat = (torch.empty((B, K, h, w), dtype=prediction.dtype, device=dev)
            if want_heatmap else prediction.new_empty(0))
    lib = kernels.library("kp_expectation")
    fn = lib.eamm_kp_expectation_fused
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    code = fn(prediction.data_ptr(), _DTYPES[prediction.dtype],
              prediction.stride(0), prediction.stride(1),
              jmap.data_ptr(), _DTYPES[jmap.dtype],
              jmap.stride(0), jmap.stride(1), jmap.stride(2),
              value.data_ptr(), jac.data_ptr(),
              heat.data_ptr() if want_heatmap else None,
              B, K, h, w, float(temperature), plan.smem_bytes,
              int(plan.tables), plan.blocks,
              torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, "kp_expectation_fused")
    kp_expectation_fused.launches += 1
    return value, jac, heat


kp_expectation.launches = 0
kp_expectation_fused.launches = 0
