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

``kp_expectation`` is differentiable, as the JAX ``custom_vjp`` is: the
operator's autograd formula calls ``eamm::kp_expectation_backward``, whose
CUDA implementation is the kernel K3b (``kp_expectation_backward``) and
whose CPU implementation is the autodiff of the plain version
(``kp_expectation_backward_plain``); ``backward_plan`` decides its launch,
as ``fused_plan`` does K5's.  K5 has no backward: no training path calls
it.
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
    dt = torch.promote_types(pred.dtype, torch.float32)  # float64 stays
    return (pred.new_empty((B, K, 2), dtype=dt),
            pred.new_empty((B, K, 2, 2), dtype=dt))


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
    lib, fn = kernels.entry(
        "kp_expectation", "eamm_kp_expectation",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p] + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    code = fn(pred.data_ptr(), pred.stride(0), pred.stride(1),
              jmap.data_ptr(), jmap.stride(0), jmap.stride(1), jmap.stride(2),
              value.data_ptr(), jac.data_ptr(), B, K, h, w, float(temperature),
              torch.cuda.current_stream(pred.device).cuda_stream)
    kernels.check(lib, code, "kp_expectation")
    kp_expectation.launches += 1
    return value, jac


def kp_expectation_backward_plain(pred: torch.Tensor, jmap: torch.Tensor,
                                  temperature: float, g_value: torch.Tensor,
                                  g_jac: torch.Tensor):
    """The plain backward: the autodiff of ``kp_expectation_plain`` ->
    (grad_pred, grad_jmap) for output gradients g_value [B,K,2] and g_jac
    [B,K,2,2]."""
    _, vjp = torch.func.vjp(
        lambda p, j: kp_expectation_plain(p, j, temperature), pred, jmap)
    return vjp((g_value, g_jac))


def kp_expectation_backward(pred: torch.Tensor, jmap: torch.Tensor,
                            temperature: float, g_value: torch.Tensor,
                            g_jac: torch.Tensor):
    """(grad_pred [B,K,h,w], grad_jmap [B,K,4,h,w]) of ``kp_expectation``
    at (pred, jmap) for output gradients g_value [B,K,2] and g_jac
    [B,K,2,2]: the kernel K3b on CUDA (float32), the plain version on the
    CPU."""
    _check(pred, jmap)
    _cuda_check("kp_expectation_backward", pred)
    return kp_expectation_backward_op(pred, jmap, float(temperature),
                                      g_value, g_jac)


@torch.library.custom_op("eamm::kp_expectation_backward", mutates_args=(),
                         device_types="cpu")
def kp_expectation_backward_op(pred: torch.Tensor, jmap: torch.Tensor,
                               temperature: float, g_value: torch.Tensor,
                               g_jac: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    return kp_expectation_backward_plain(pred, jmap, temperature, g_value,
                                         g_jac)


@kp_expectation_backward_op.register_fake
def _kp_expectation_backward_fake(pred, jmap, temperature, g_value, g_jac):
    return torch.empty_like(pred), torch.empty_like(jmap)


@kp_expectation_backward_op.register_kernel("cuda")
def _kp_expectation_backward_cuda(pred, jmap, temperature, g_value, g_jac):
    for name, t in (("pred", pred), ("jmap", jmap), ("g_value", g_value),
                    ("g_jac", g_jac)):
        if t.dtype != torch.float32:
            raise TypeError(f"kp_expectation_backward: need float32, {name} "
                            f"is {t.dtype}")
    B, K, h, w = pred.shape
    for name, t in (("pred", pred), ("jmap", jmap)):
        if t.stride(-1) != 1 or t.stride(-2) != w:
            raise ValueError(f"kp_expectation_backward: each {name} row of "
                             f"h*w must be contiguous, strides {t.stride()}")
    if B * K == 0 or h < 2 or w < 2:
        raise ValueError(f"kp_expectation_backward: shape "
                         f"{tuple(pred.shape)} needs rows and h, w >= 2")
    plan = backward_launch_plan(pred)
    g_value = g_value.reshape(B, K, 2).contiguous()
    g_jac = g_jac.reshape(B, K, 2, 2).contiguous()
    grad_pred = torch.empty((B, K, h, w), dtype=torch.float32,
                            device=pred.device)
    grad_jmap = torch.empty((B, K, 4, h, w), dtype=torch.float32,
                            device=pred.device)
    lib, fn = kernels.entry(
        "kp_expectation", "eamm_kp_expectation_backward",
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p] + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    code = fn(pred.data_ptr(), pred.stride(0), pred.stride(1),
              jmap.data_ptr(), jmap.stride(0), jmap.stride(1), jmap.stride(2),
              g_value.data_ptr(), g_jac.data_ptr(), grad_pred.data_ptr(),
              grad_jmap.data_ptr(), B, K, h, w, float(temperature),
              plan.groups, plan.smem_bytes, int(plan.tables), plan.blocks,
              torch.cuda.current_stream(pred.device).cuda_stream)
    kernels.check(lib, code, "kp_expectation_backward")
    kp_expectation_backward.launches += 1
    return grad_pred, grad_jmap


def _kp_expectation_setup(ctx, inputs, output):
    pred, jmap, temperature = inputs
    ctx.save_for_backward(pred, jmap)
    ctx.temperature = temperature


def _kp_expectation_grad(ctx, g_value, g_jac):
    pred, jmap = ctx.saved_tensors
    grad_pred, grad_jmap = kp_expectation_backward_op(
        pred, jmap, ctx.temperature, g_value, g_jac)
    need_pred, need_jmap = ctx.needs_input_grad[:2]
    return (grad_pred if need_pred else None,
            grad_jmap if need_jmap else None, None)


kp_expectation_op.register_autograd(_kp_expectation_grad,
                                    setup_context=_kp_expectation_setup)


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
    lib, fn = kernels.entry(
        "kp_expectation", "eamm_kp_expectation_fused_resident",
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
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


# K3b's threads a block and the groups of 4 pixels a thread may hold in
# registers (csrc/kp_expectation.cu kp_expectation_backward_kernel<G>); a
# larger row is held in shared memory, 8 bytes a pixel, up to the largest
# row K3b takes
BACKWARD_THREADS = 256
BACKWARD_GROUPS = (1, 2, 4)
MAX_BACKWARD_PIXELS = FUSED_SMEM_BUDGET // 8


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How ``kp_expectation_backward`` launches: the groups of 4 pixels a
    thread holds in registers (0: the row's logits and s in shared
    memory), dynamic shared memory per block, whether it holds the
    coordinate tables gx[w], gy[h], the blocks the card holds at once at
    that plan, the blocks launched and the most rows one block walks."""
    groups: int
    smem_bytes: int
    tables: bool
    resident: int
    blocks: int
    rows_per_block: int


def backward_plan(B: int, K: int, h: int, w: int,
                  resident: Callable[[int, int], int]) -> BackwardPlan:
    """K3b's launch for B*K rows of h*w pixels: the fewest register groups
    that hold a row (P // 4 groups at most, at BACKWARD_THREADS threads),
    else the shared-memory path; the coordinate tables where they fit;
    persistent blocks, no more than ``resident(groups, smem_bytes)``,
    balanced as ``fused_plan``'s.  Raises ``ValueError`` past
    ``MAX_BACKWARD_PIXELS``."""
    P = h * w
    if P > MAX_BACKWARD_PIXELS:
        raise ValueError(f"kp_expectation_backward: {h}x{w} pixels is more "
                         f"than MAX_BACKWARD_PIXELS ({MAX_BACKWARD_PIXELS}), "
                         "the largest row the kernel takes")
    need = -(-(P // 4) // BACKWARD_THREADS)
    groups = next((g for g in BACKWARD_GROUPS if g >= need), 0)
    held = 0 if groups else 8 * P
    tables = held + 4 * (h + w) <= FUSED_SMEM_BUDGET
    smem = held + 4 * (h + w) if tables else held
    n = resident(groups, smem)
    rows_per_block = -(-B * K // n)
    return BackwardPlan(groups=groups, smem_bytes=smem, tables=tables,
                        resident=n, blocks=-(-B * K // rows_per_block),
                        rows_per_block=rows_per_block)


@dataclasses.dataclass(frozen=True)
class RowSlots:
    """One row's split as K3b's kernel makes it (csrc ``row_slots``): the
    first pixel of the first group, the groups of 4, the pixel after the
    last group, the pixels outside the groups and whether the groups move
    as 16-byte vectors."""
    first: int
    groups: int
    after: int
    loose: int
    grouped: bool


def row_slots(P: int, offsets) -> RowSlots:
    """The split of a row of P float32 pixels whose ten planes (pred, the
    four jmap planes, grad_pred, the four grad_jmap planes) start at the
    element ``offsets``: vector groups from the first 16-byte boundary
    when all ten planes reach it at the same pixel, else scalar groups
    from pixel 0."""
    heads = [(-o) % 4 for o in offsets]
    grouped = heads[0] < P and all(hd == heads[0] for hd in heads)
    first = heads[0] if grouped else 0
    groups = (P - first) // 4
    after = first + 4 * groups
    return RowSlots(first=first, groups=groups, after=after,
                    loose=first + P - after, grouped=grouped)


def backward_slots(P: int, slots: RowSlots, groups: int,
                   threads: int = BACKWARD_THREADS) -> list[list[int]]:
    """The pixels each thread of K3b holds for one row: in a grouped row,
    group q = t + g * threads of thread t (g < ``groups`` in registers,
    any g with groups 0), else pixel k * threads + t for k < 4 * groups
    (any k with groups 0) before ``slots.after``; and, for t < loose, one
    pixel outside them."""
    out = []
    for t in range(threads):
        held = []
        if slots.grouped:
            q = t
            while q < slots.groups and (groups == 0
                                        or q < t + groups * threads):
                held.extend(range(slots.first + 4 * q,
                                  slots.first + 4 * q + 4))
                q += threads
        else:
            k = 0
            while k * threads + t < slots.after and (groups == 0
                                                     or k < 4 * groups):
                held.append(k * threads + t)
                k += 1
        if t < slots.loose:
            held.append(t if t < slots.first
                        else slots.after + t - slots.first)
        out.append(held)
    return out


@functools.lru_cache(maxsize=None)
def _backward_resident(device: torch.device, groups: int, smem: int) -> int:
    """K3b's blocks that ``device`` holds at once for ``groups`` with
    ``smem`` bytes of dynamic shared memory each, asked once per device
    and plan (the query also lets the kernel take that much)."""
    lib, fn = kernels.entry(
        "kp_expectation", "eamm_kp_expectation_backward_resident",
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        kernels.check(lib, fn(groups, smem, ctypes.byref(out)),
                      "kp_expectation_backward occupancy")
    if out.value < 1:
        raise RuntimeError(f"kp_expectation_backward: no block of {smem} "
                           f"bytes of shared memory fits on {device}")
    return out.value


def backward_launch_plan(pred: torch.Tensor) -> BackwardPlan:
    """The plan ``kp_expectation_backward`` launches with for this CUDA
    tensor."""
    B, K, h, w = pred.shape
    return backward_plan(B, K, h, w, functools.partial(_backward_resident,
                                                       pred.device))


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
    lib, fn = kernels.entry(
        "kp_expectation", "eamm_kp_expectation_fused",
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
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
kp_expectation_backward.launches = 0
kp_expectation_fused.launches = 0
