"""The bilinear warps, as CUDA kernels for Hopper.

``grid_sample_wide`` replaces ``eamm_tpu/ops/warp_pallas.py::
grid_sample_twolevel_pallas`` (the generator's bottleneck warp),
``grid_sample_narrow`` replaces ``grid_sample_smallc_pallas`` (dense
motion's deformed copies of the downsampled source) and
``grid_sample_shared`` replaces ``grid_sample_shared`` (one source, many
grids, any channel count; no model calls it).  All compute
``ops.warp.grid_sample`` with zeros padding: image [Bi, H, W, C] NHWC,
grid [B, Ho, Wo, 2], each float32 or bfloat16, grid b samples image
b // (B // Bi), float32 arithmetic rounded once to the image dtype.  The kernels are in
``csrc/warp.cu``.

A CPU tensor takes the plain version (``ops.warp.grid_sample``); a CUDA
tensor launches the kernel or raises.  Each wrapper counts its launches in
its ``launches`` attribute.  ``store_only`` is a yardstick, no warp: it
writes zeros over a tensor's bytes, the card's write ceiling for a kernel
that writes them.
"""
from __future__ import annotations

import ctypes

import torch

from eamm_tpu_torch import kernels
from eamm_tpu_torch.ops.warp import check_shared_batch, grid_sample

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# as in csrc/warp.cu: a block's shared-memory maximum on sm_90 and
# warp_narrow's output tile in pixels
SMEM_LIMIT = 232448
NARROW_TILE = 2048


def narrow_smem_bytes(H: int, W: int, C: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the narrow kernel needs for an [H, W, C]
    source: the source with channels padded to 4 or 8, then an output tile
    and 16 bytes of slack; raises ``ValueError`` past ``SMEM_LIMIT``."""
    size = dtype.itemsize
    padded = 4 if C <= 4 else 8
    n = (H * W * padded * size + 15) // 16 * 16 + NARROW_TILE * C * size + 16
    if n > SMEM_LIMIT:
        raise ValueError(f"grid_sample_narrow: a [{H},{W},{C}] {dtype} source "
                         f"needs {n} bytes of shared memory, more than a "
                         f"block's {SMEM_LIMIT}")
    return n


def grid_sample_plain(image: torch.Tensor, grid: torch.Tensor,
                      align_corners: bool = False) -> torch.Tensor:
    """The plain version of both kernels."""
    return grid_sample(image, grid, padding_mode="zeros",
                       align_corners=align_corners)


def grid_sample_shared_plain(source: torch.Tensor, grids: torch.Tensor,
                             align_corners: bool = False) -> torch.Tensor:
    """The plain version of ``grid_sample_shared``."""
    return grid_sample_plain(source[None], grids, align_corners)


def _entry(name: str):
    """The warp library and its C function ``name``, typed once."""
    lib = kernels.library("warp")
    fn = _typed.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _typed[name] = fn
    return lib, fn


_typed: dict = {}


def _launch(entry: str, image: torch.Tensor, grid: torch.Tensor,
            align_corners: bool) -> torch.Tensor:
    group = check_shared_batch(image, grid)
    if image.device.type != "cuda":
        raise ValueError(f"{entry}: tensors on {image.device}; the kernel "
                         "runs on CUDA and the plain version on the CPU")
    if image.dtype not in _DTYPES or grid.dtype not in _DTYPES:
        raise TypeError(f"{entry}: image {image.dtype}, grid {grid.dtype}; "
                        "each must be float32 or bfloat16")
    if not image.is_contiguous():
        raise ValueError(f"{entry}: image must be contiguous NHWC")
    Bi, H, W, C = image.shape
    B, Ho, Wo, _ = grid.shape
    g = grid.contiguous()
    if g.data_ptr() % (2 * g.element_size()):   # (x, y) is one load
        g = g.clone()
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        raise ValueError(f"{entry}: empty output {tuple(out.shape)}")
    if image.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{entry}: image and output need 16-byte alignment")
    lib, fn = _entry(entry)
    code = fn(image.data_ptr(), g.data_ptr(), out.data_ptr(),
              _DTYPES[image.dtype], _DTYPES[g.dtype], B, Ho, Wo, group, H, W,
              C, int(align_corners),
              torch.cuda.current_stream(image.device).cuda_stream)
    kernels.check(lib, code, entry)
    return out


def grid_sample_wide(image: torch.Tensor, grid: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Warp for channel counts that are a multiple of 8 (the bottleneck's
    256): a block per 8x8 tile of output pixels, a thread per 16 bytes of
    channels."""
    if image.device.type == "cpu":
        return grid_sample_plain(image, grid, align_corners)
    if image.dim() != 4 or image.shape[-1] % 8:
        raise ValueError(f"grid_sample_wide: need [Bi,H,W,C] with C % 8 == 0, "
                         f"got {tuple(image.shape)}")
    out = _launch("eamm_warp_wide", image, grid, align_corners)
    grid_sample_wide.launches += 1
    return out


def grid_sample_narrow(image: torch.Tensor, grid: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """Warp for 1 to 8 channels (dense motion's RGB source): each block
    holds one source in shared memory (``narrow_smem_bytes``) and walks the
    pixels of the grids that read it."""
    if image.device.type == "cpu":
        return grid_sample_plain(image, grid, align_corners)
    if image.dim() != 4 or not 1 <= image.shape[-1] <= 8:
        raise ValueError(f"grid_sample_narrow: need [Bi,H,W,C] with "
                         f"1 <= C <= 8, got {tuple(image.shape)}")
    narrow_smem_bytes(*image.shape[1:], image.dtype)
    out = _launch("eamm_warp_narrow", image, grid, align_corners)
    grid_sample_narrow.launches += 1
    return out


def grid_sample_shared(source: torch.Tensor, grids: torch.Tensor,
                       align_corners: bool = False,
                       exact: bool = False) -> torch.Tensor:
    """Warp one source [Hs, Ws, C] by N grids [N, Ho, Wo, 2] -> [N, Ho, Wo, C]
    in the source dtype, zeros padding, any C.

    On the TPU ``exact=False`` runs the one-hot weight matrix at bf16
    multiply precision; here the four corners are gathered and weighted in
    float32 and rounded once, so both values of ``exact`` give that result.
    The TPU's ``tile`` block size has no counterpart."""
    del exact                       # both values give the float32 result
    if source.dim() != 3:
        raise ValueError(f"grid_sample_shared: need source [Hs,Ws,C], got "
                         f"{tuple(source.shape)}")
    if source.device.type == "cpu":
        return grid_sample_shared_plain(source, grids, align_corners)
    out = _launch("eamm_warp_shared", source[None], grids, align_corners)
    grid_sample_shared.launches += 1
    return out


def store_only(out: torch.Tensor) -> torch.Tensor:
    """Write zeros over the bytes of CUDA tensor ``out`` (a multiple of 16)
    with 16-byte stores and nothing else; returns ``out``."""
    if out.device.type != "cuda" or not out.is_contiguous() \
            or out.data_ptr() % 16 or out.nbytes % 16:
        raise ValueError("store_only: need a contiguous CUDA tensor, 16-byte "
                         "aligned, of a multiple of 16 bytes")
    lib = kernels.library("warp")
    lib.eamm_store_only.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p]
    lib.eamm_store_only.restype = ctypes.c_int
    kernels.check(lib, lib.eamm_store_only(
        out.data_ptr(), out.nbytes,
        torch.cuda.current_stream(out.device).cuda_stream), "eamm_store_only")
    return out


grid_sample_wide.launches = 0
grid_sample_narrow.launches = 0
grid_sample_shared.launches = 0
