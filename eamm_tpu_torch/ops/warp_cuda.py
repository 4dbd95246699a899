"""The bilinear warps, as CUDA kernels for Hopper.

``grid_sample_wide`` replaces ``eamm_tpu/ops/warp_pallas.py::
grid_sample_twolevel_pallas`` (the generator's bottleneck warp),
``grid_sample_narrow`` replaces ``grid_sample_smallc_pallas`` (dense
motion's deformed copies of the downsampled source) and
``grid_sample_shared`` replaces ``grid_sample_shared`` (one source, many
grids, any channel count; no model calls it).  All compute
``ops.warp.grid_sample`` with zeros padding: image [Bi, H, W, C] NHWC,
grid [B, Ho, Wo, 2], each float32 or bfloat16, grid b samples image
b // (B // Bi), float32 arithmetic rounded once to the image dtype.
``grid_sample_twolevel_b16`` replaces ``benchmarks/bench_warp_variants.py::
twolevel_b16`` (K6; no model calls it): the same warp with
``align_corners=False`` and its y pass rounded to bfloat16
(``grid_sample_twolevel_b16_plain``).  The kernels are in
``csrc/warp.cu``.

Each kernel is an operator, ``torch.ops.eamm.warp_wide``, ``warp_narrow``,
``warp_shared`` and ``warp_wide_b16`` (``torch.library.custom_op``), so that ``torch.export``
keeps it as a call: its CPU implementation is the plain version
(``ops.warp.grid_sample``), its CUDA implementation launches the kernel or
raises, and its fake implementation gives the output's shape.  The Python
wrappers check what the kernels take and call the operators; the CUDA
implementation counts its launches in the wrapper's ``launches``
attribute, so the calls of an exported program count too.  ``store_only``
is a yardstick, no warp: it writes zeros over a tensor's bytes, the card's
write ceiling for a kernel that writes them.

The wide and narrow warps are differentiable: each operator's autograd
formula calls ``eamm::warp_wide_backward`` or ``eamm::warp_narrow_backward``
for the gradients ``ctx.needs_input_grad`` asks for.  Their CUDA
implementations are the kernels K1b and K2b (``csrc/warp_backward.cu``,
counted in ``warp_wide_backward.launches`` and
``warp_narrow_backward.launches``); their CPU implementation is the
autodiff of the plain version (``grid_sample_backward_plain``).  The
shared warp has no backward: no training path calls it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from eamm_tpu_torch import kernels
from eamm_tpu_torch.ops.warp import (_unnormalize, check_shared_batch,
                                     grid_sample)

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


def grid_sample_twolevel_b16_plain(image: torch.Tensor,
                                   grid: torch.Tensor) -> torch.Tensor:
    """The plain version of K6, ``twolevel_b16``'s two passes step by step
    with its roundings (float32 arithmetic, zeros outside the image,
    ``align_corners=False``): tents max(0, 1 - |f - i|) at the two taps'
    own integers i, the y tents cast to the image dtype; each column's two
    row products summed and rounded to bfloat16; the two columns weighted
    by the x tents, summed and rounded to the image dtype."""
    group = check_shared_batch(image, grid)
    if image.dtype not in _DTYPES:
        raise TypeError(f"grid_sample_twolevel_b16: image {image.dtype}; "
                        "float32 or bfloat16")
    Bi, H, W, C = image.shape
    B, Ho, Wo, _ = grid.shape
    g = grid.float()
    fx = _unnormalize(g[..., 0], W, False)
    fy = _unnormalize(g[..., 1], H, False)
    x0, y0 = torch.floor(fx), torch.floor(fy)

    def tent(f, i):
        return torch.clamp_min(1.0 - torch.abs(f - i), 0.0)

    src = image.reshape(Bi, H * W, C)
    src_of = torch.arange(B, device=image.device) // group

    def product(cx, cy, weight):
        # fl(weight * s(cy, cx)), 0 outside the image: [B, Ho, Wo, C]
        valid = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        idx = (cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).long()
        vals = src[src_of[:, None], idx.reshape(B, -1)].float()
        prod = weight.reshape(B, -1, 1) * vals
        return torch.where(valid.reshape(B, -1, 1), prod,
                           torch.zeros_like(prod)).reshape(B, Ho, Wo, C)

    ty0 = tent(fy, y0).to(image.dtype).float()
    ty1 = tent(fy, y0 + 1).to(image.dtype).float()
    out = None
    for cx in (x0, x0 + 1):
        rows = (product(cx, y0, ty0) + product(cx, y0 + 1, ty1)
                ).to(torch.bfloat16).float()
        term = tent(fx, cx)[..., None] * rows
        out = term if out is None else out + term
    return out.to(image.dtype)


# the C interfaces of csrc/warp.cu's warps and csrc/warp_backward.cu's
# backward warps: pointers, then the dtypes and sizes (and align_corners,
# which K6 does not take), then the stream
_WARP_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_B16_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# K2b's: pointers (grad_image and grad_grid or null), the dtypes and
# sizes, grad_out's image, pixel and channel strides, its plan's blocks
# and shared memory, then the stream
_NARROW_BACKWARD_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                         + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])
# K1b's: pointers (grad_image and grad_grid or null), its workspace and
# the workspace's ints, then the dtypes, sizes and the stream
_WIDE_BACKWARD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _launch(entry: str, image: torch.Tensor, grid: torch.Tensor,
            align_corners: bool | None) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/warp.cu``; ``align_corners`` None for K6,
    whose C interface does not take it."""
    group = check_shared_batch(image, grid)
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
    align = () if align_corners is None else (int(align_corners),)
    lib, fn = kernels.entry("warp", entry,
                            _WARP_ARGS if align else _B16_ARGS)
    code = fn(image.data_ptr(), g.data_ptr(), out.data_ptr(),
              _DTYPES[image.dtype], _DTYPES[g.dtype], B, Ho, Wo, group, H, W,
              C, *align, torch.cuda.current_stream(image.device).cuda_stream)
    kernels.check(lib, code, entry)
    return out


def _device_check(name: str, t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {t.device}; the kernel runs on "
                         "CUDA and the plain version on the CPU")


def _warp_fake(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return image.new_empty((grid.shape[0], grid.shape[1], grid.shape[2],
                            image.shape[3]))


@torch.library.custom_op("eamm::warp_wide", mutates_args=(),
                         device_types="cpu")
def warp_wide_op(image: torch.Tensor, grid: torch.Tensor,
                 align_corners: bool) -> torch.Tensor:
    return grid_sample_plain(image, grid, align_corners)


@warp_wide_op.register_kernel("cuda")
def _warp_wide_cuda(image, grid, align_corners):
    out = _launch("eamm_warp_wide", image, grid, align_corners)
    grid_sample_wide.launches += 1
    return out


@torch.library.custom_op("eamm::warp_narrow", mutates_args=(),
                         device_types="cpu")
def warp_narrow_op(image: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool) -> torch.Tensor:
    return grid_sample_plain(image, grid, align_corners)


@warp_narrow_op.register_kernel("cuda")
def _warp_narrow_cuda(image, grid, align_corners):
    out = _launch("eamm_warp_narrow", image, grid, align_corners)
    grid_sample_narrow.launches += 1
    return out


@torch.library.custom_op("eamm::warp_shared", mutates_args=(),
                         device_types="cpu")
def warp_shared_op(source: torch.Tensor, grids: torch.Tensor,
                   align_corners: bool) -> torch.Tensor:
    return grid_sample_shared_plain(source, grids, align_corners)


@warp_shared_op.register_kernel("cuda")
def _warp_shared_cuda(source, grids, align_corners):
    out = _launch("eamm_warp_shared", source[None], grids, align_corners)
    grid_sample_shared.launches += 1
    return out


@torch.library.custom_op("eamm::warp_wide_b16", mutates_args=(),
                         device_types="cpu")
def warp_wide_b16_op(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return grid_sample_twolevel_b16_plain(image, grid)


@warp_wide_b16_op.register_kernel("cuda")
def _warp_wide_b16_cuda(image, grid):
    out = _launch("eamm_warp_wide_b16", image, grid, None)
    grid_sample_twolevel_b16.launches += 1
    return out


warp_wide_op.register_fake(lambda image, grid, align_corners:
                           _warp_fake(image, grid))
warp_wide_b16_op.register_fake(_warp_fake)
warp_narrow_op.register_fake(lambda image, grid, align_corners:
                             _warp_fake(image, grid))
warp_shared_op.register_fake(lambda source, grids, align_corners:
                             _warp_fake(source[None], grids))


def grid_sample_backward_plain(grad_out: torch.Tensor, image: torch.Tensor,
                               grid: torch.Tensor, align_corners: bool,
                               need_image: bool = True,
                               need_grid: bool = True):
    """The plain backward of both warps: the autodiff of
    ``grid_sample_plain`` -> (grad_image or an empty tensor, grad_grid or an
    empty tensor), each in its input's dtype."""
    _, vjp = torch.func.vjp(
        lambda i, g: grid_sample_plain(i, g, align_corners), image, grid)
    grad_image, grad_grid = vjp(grad_out.to(image.dtype))
    return (grad_image if need_image else image.new_empty(0),
            grad_grid if need_grid else grid.new_empty(0))


# K1b's source tiles (a warp a row) and channels a block, as in
# csrc/warp_backward.cu (kTile, kSlice)
WIDE_TILE = 8
WIDE_SLICE = 128


@dataclasses.dataclass(frozen=True)
class WideBackwardPlan:
    """K1b's gather for [Bi, H, W, C] sources: tiles of WIDE_TILE pixels
    across and down, the bins of one source (one more row and column than
    tiles: a base corner at -1), channel slices of WIDE_SLICE (a block per
    tile, source and slice) and the workspace in int32s (csrc
    ``wide_layout``)."""
    tiles_x: int
    tiles_y: int
    bins_x: int
    bins: int
    slices: int
    workspace: int


def wide_backward_plan(B: int, Ho: int, Wo: int, group: int, H: int, W: int,
                       C: int, need_grid: bool) -> WideBackwardPlan:
    """The plan of K1b for grad_out [B,Ho,Wo,C] of B // group sources of
    [H,W,C]: workspace = bin counts, bin offsets (one more), padding to 8
    bytes, (bin, rank) per output pixel, the bins' pixel list, and with
    the grid gradient a float per (slice, output pixel, corner)."""
    tiles_x, tiles_y = -(-W // WIDE_TILE), -(-H // WIDE_TILE)
    bins_x = tiles_x + 1
    bins = (tiles_y + 1) * bins_x
    n_bins = B // group * bins
    slices = -(-C // WIDE_SLICE)
    BP = B * Ho * Wo
    head = 2 * n_bins + 1
    slot = head + (head & 1)
    return WideBackwardPlan(
        tiles_x=tiles_x, tiles_y=tiles_y, bins_x=bins_x, bins=bins,
        slices=slices, workspace=slot + 3 * BP + (4 * slices * BP if need_grid else 0))


def wide_backward_bins(grid: torch.Tensor, H: int, W: int,
                       align_corners: bool, group: int = 1) -> torch.Tensor:
    """Each output pixel's bin as K1b's count kernel finds it, flat over
    [B*Ho*Wo]: the bin of the WIDE_TILE tile that holds its base corner
    (floor x, floor y), counted from a base corner at -1, after the bins
    of the sources before its own; -1 where no corner lies inside the
    image.  A block of tile (ty, tx) reads the bins at rows ty, ty + 1 and
    columns tx, tx + 1 of its source."""
    B = grid.shape[0]
    plan = wide_backward_plan(B, grid.shape[1], grid.shape[2], group, H, W,
                              WIDE_SLICE, False)
    x0 = torch.floor(_unnormalize(grid[..., 0].float(), W, align_corners))
    y0 = torch.floor(_unnormalize(grid[..., 1].float(), H, align_corners))
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    source = torch.arange(B, device=grid.device).view(B, 1, 1) // group
    key = (source * plan.bins
           + torch.div(y0.clamp(-1, H - 1) + WIDE_TILE, WIDE_TILE,
                       rounding_mode="floor").long() * plan.bins_x
           + torch.div(x0.clamp(-1, W - 1) + WIDE_TILE, WIDE_TILE,
                       rounding_mode="floor").long())
    return torch.where(inside, key, -1).flatten()


# K2b's threads a block, with the image gradient and without
# (csrc/warp_backward.cu kNarrowThreads), the pixels a thread takes at
# once (kNarrowPixels), and the most blocks of one cluster: 8, the
# portable size (the kernel takes 16, which fewer clusters at once made
# slower)
NARROW_BACKWARD_THREADS = {True: 512, False: 256}
NARROW_BACKWARD_PIXELS = 4
NARROW_BACKWARD_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class NarrowBackwardPlan:
    """How K2b launches: the threads a block, the pixels a tile
    (NARROW_BACKWARD_PIXELS a thread), the tiles of one source's pixels,
    the blocks a source (with the image gradient one cluster of them),
    the dynamic shared memory a block and the blocks the card holds at
    once at that size."""
    threads: int
    tile: int
    tiles: int
    blocks: int
    smem_bytes: int
    resident: int


def narrow_backward_smem(H: int, W: int, C: int, dtype: torch.dtype,
                         need_image: bool, need_grid: bool) -> int:
    """K2b's shared memory a block for an [H, W, C] source: with the image
    gradient its float32 sums, with the grid gradient the source's bytes
    as they are (16 bytes of slack for their offset); raises
    ``ValueError`` past ``SMEM_LIMIT``."""
    n = H * W * C
    smem = ((-(-4 * n // 16) * 16 if need_image else 0)
            + (-(-n * dtype.itemsize // 16) * 16 + 16 if need_grid else 0))
    if smem > SMEM_LIMIT:
        raise ValueError(f"warp_narrow_backward: a [{H},{W},{C}] {dtype} "
                         f"source needs {smem} bytes of shared memory, more "
                         f"than a block's {SMEM_LIMIT}")
    return smem


def narrow_backward_plan(B: int, Ho: int, Wo: int, group: int, H: int,
                         W: int, C: int, dtype: torch.dtype, need_image: bool,
                         need_grid: bool,
                         resident: Callable[[int], int]) -> NarrowBackwardPlan:
    """K2b's launch for grad_out [B,Ho,Wo,C] of B // group sources of
    [H,W,C]: each source's group * Ho * Wo pixels in tiles of a block's
    threads times NARROW_BACKWARD_PIXELS, walked by persistent blocks, no
    more than ``resident(smem_bytes)`` over the sources (with the image
    gradient no more than NARROW_BACKWARD_CLUSTER a source: one cluster),
    balanced so that every block walks the same number of tiles."""
    if not 1 <= C <= 8:
        raise ValueError(f"warp_narrow_backward: C = {C}, need 1 to 8")
    smem = narrow_backward_smem(H, W, C, dtype, need_image, need_grid)
    threads = NARROW_BACKWARD_THREADS[need_image]
    tile = threads * NARROW_BACKWARD_PIXELS
    tiles = -(-group * Ho * Wo // tile)
    n = resident(smem)
    most = max(1, n // (B // group))
    if need_image:
        most = min(most, NARROW_BACKWARD_CLUSTER)
    rounds = -(-tiles // most)
    return NarrowBackwardPlan(threads=threads, tile=tile, tiles=tiles,
                              blocks=-(-tiles // rounds), smem_bytes=smem,
                              resident=n)


def narrow_backward_walk(plan: NarrowBackwardPlan, Bi: int,
                         n_px: int) -> np.ndarray:
    """How often K2b's blocks take each of the Bi * n_px pixels, as its
    kernel walks them: thread t of block x of source s takes the source's
    pixels x * tile + u * threads + t (u < NARROW_BACKWARD_PIXELS), then
    blocks * tile further on."""
    taken = np.zeros(Bi * n_px, dtype=np.int64)
    for s in range(Bi):
        for x in range(plan.blocks):
            for p0 in range(x * plan.tile, n_px, plan.blocks * plan.tile):
                px = (p0 + np.arange(NARROW_BACKWARD_PIXELS)[:, None]
                      * plan.threads + np.arange(plan.threads)).ravel()
                np.add.at(taken, s * n_px + px[px < n_px], 1)
    return taken


def narrow_out_layout(grad_out: torch.Tensor) -> tuple[int, int, int] | None:
    """How K2b reads ``grad_out`` [B,Ho,Wo,C] in place: its (image, pixel,
    channel) strides in elements, where its rows of pixels are evenly
    strided (NHWC contiguous, or a plane a channel as dense motion's
    gradient arrives through its channel-first concatenation); None
    where it must be made contiguous first."""
    B, Ho, Wo, C = grad_out.shape
    sb, sy, sx, sc = grad_out.stride()
    return (sb, sx, sc) if sy == Wo * sx or Ho == 1 else None


@functools.lru_cache(maxsize=None)
def _narrow_backward_resident(device: torch.device, dtype: int, gdtype: int,
                              C: int, need_image: bool, need_grid: bool,
                              smem: int) -> int:
    """K2b's blocks that ``device`` holds at once with ``smem`` bytes of
    dynamic shared memory each, asked once per device and kernel (the
    query also lets the kernel take that much)."""
    lib, fn = kernels.entry(
        "warp_backward", "eamm_warp_narrow_backward_resident",
        [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        kernels.check(lib, fn(dtype, gdtype, C, int(need_image),
                              int(need_grid), smem, ctypes.byref(out)),
                      "warp_narrow_backward occupancy")
    if out.value < 1:
        raise RuntimeError(f"warp_narrow_backward: no block of {smem} bytes "
                           f"of shared memory fits on {device}")
    return out.value


def narrow_backward_launch_plan(image: torch.Tensor, grid: torch.Tensor,
                                need_image: bool, need_grid: bool
                                ) -> NarrowBackwardPlan:
    """The plan K2b launches with for these CUDA tensors."""
    _, H, W, C = image.shape
    B, Ho, Wo, _ = grid.shape
    return _narrow_launch_plan(B, Ho, Wo, B // image.shape[0], H, W, C,
                               image.dtype, grid.dtype, need_image, need_grid,
                               image.device)


@functools.lru_cache(maxsize=None)
def _narrow_launch_plan(B, Ho, Wo, group, H, W, C, dtype, gdtype, need_image,
                        need_grid, device) -> NarrowBackwardPlan:
    return narrow_backward_plan(
        B, Ho, Wo, group, H, W, C, dtype, need_image, need_grid,
        functools.partial(_narrow_backward_resident, device, _DTYPES[dtype],
                          _DTYPES[gdtype], C, need_image, need_grid))


def _launch_backward(entry: str, grad_out: torch.Tensor, image: torch.Tensor,
                     grid: torch.Tensor, align_corners: bool, need_image: bool,
                     need_grid: bool):
    """Launch K1b or K2b for the gradients asked for, each writing the
    image gradient once in the image type: K1b through its workspace
    (``wide_backward_plan``), K2b as ``narrow_backward_plan`` says,
    reading grad_out in place where ``narrow_out_layout`` allows."""
    group = check_shared_batch(image, grid)
    if image.dtype not in _DTYPES or grid.dtype not in _DTYPES:
        raise TypeError(f"{entry}: image {image.dtype}, grid {grid.dtype}; "
                        "each must be float32 or bfloat16")
    if not (need_image or need_grid):
        raise ValueError(f"{entry}: no gradient asked for")
    image = image.contiguous()
    g = grid.contiguous()
    if g.data_ptr() % (2 * g.element_size()):   # (x, y) is one load
        g = g.clone()
    if grad_out.shape != (*grid.shape[:3], image.shape[3]):
        raise ValueError(f"{entry}: grad_out {tuple(grad_out.shape)} for "
                         f"image {tuple(image.shape)} and grid "
                         f"{tuple(grid.shape)}")
    gout = grad_out.to(image.dtype)
    if entry == "eamm_warp_wide_backward" or narrow_out_layout(gout) is None:
        gout = gout.contiguous()
    if image.data_ptr() % 16 or (entry == "eamm_warp_wide_backward"
                                 and gout.data_ptr() % 16):
        raise ValueError(f"{entry}: image and grad_out need 16-byte "
                         "alignment")
    Bi, H, W, C = image.shape
    B, Ho, Wo, _ = grid.shape
    grad_image = (torch.empty_like(image) if need_image
                  else image.new_empty(0))
    grad_grid = torch.empty_like(g) if need_grid else grid.new_empty(0)
    sizes = (_DTYPES[image.dtype], _DTYPES[g.dtype], B, Ho, Wo, group, H, W,
             C, int(align_corners),
             torch.cuda.current_stream(image.device).cuda_stream)
    outputs = (grad_image.data_ptr() if need_image else None,
               grad_grid.data_ptr() if need_grid else None)
    if entry == "eamm_warp_wide_backward":
        plan = wide_backward_plan(B, Ho, Wo, group, H, W, C, need_grid)
        work = torch.empty(plan.workspace, dtype=torch.int32,
                           device=image.device)
        lib, fn = kernels.entry("warp_backward", entry, _WIDE_BACKWARD_ARGS)
        code = fn(image.data_ptr(), g.data_ptr(), gout.data_ptr(), *outputs,
                  work.data_ptr(), plan.workspace, *sizes)
    else:
        plan = narrow_backward_launch_plan(image, g, need_image, need_grid)
        lib, fn = kernels.entry("warp_backward", entry, _NARROW_BACKWARD_ARGS)
        code = fn(image.data_ptr(), g.data_ptr(), gout.data_ptr(), *outputs,
                  *sizes[:-1], *narrow_out_layout(gout), plan.blocks,
                  plan.smem_bytes, sizes[-1])
    kernels.check(lib, code, entry)
    return grad_image, grad_grid


def _backward_fake(grad_out, image, grid, align_corners, need_image,
                   need_grid):
    return (image.new_empty(image.shape if need_image else 0),
            grid.new_empty(grid.shape if need_grid else 0))


@torch.library.custom_op("eamm::warp_wide_backward", mutates_args=(),
                         device_types="cpu")
def warp_wide_backward_op(grad_out: torch.Tensor, image: torch.Tensor,
                          grid: torch.Tensor, align_corners: bool,
                          need_image: bool, need_grid: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    return grid_sample_backward_plain(grad_out, image, grid, align_corners,
                                      need_image, need_grid)


@warp_wide_backward_op.register_kernel("cuda")
def _warp_wide_backward_cuda(grad_out, image, grid, align_corners, need_image,
                             need_grid):
    out = _launch_backward("eamm_warp_wide_backward", grad_out, image, grid,
                           align_corners, need_image, need_grid)
    warp_wide_backward.launches += 1
    return out


@torch.library.custom_op("eamm::warp_narrow_backward", mutates_args=(),
                         device_types="cpu")
def warp_narrow_backward_op(grad_out: torch.Tensor, image: torch.Tensor,
                            grid: torch.Tensor, align_corners: bool,
                            need_image: bool, need_grid: bool
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    return grid_sample_backward_plain(grad_out, image, grid, align_corners,
                                      need_image, need_grid)


@warp_narrow_backward_op.register_kernel("cuda")
def _warp_narrow_backward_cuda(grad_out, image, grid, align_corners,
                               need_image, need_grid):
    H, W, C = image.shape[1:]
    narrow_backward_smem(H, W, C, image.dtype, need_image, need_grid)
    out = _launch_backward("eamm_warp_narrow_backward", grad_out, image, grid,
                           align_corners, need_image, need_grid)
    warp_narrow_backward.launches += 1
    return out


warp_wide_backward_op.register_fake(_backward_fake)
warp_narrow_backward_op.register_fake(_backward_fake)


def _warp_setup(ctx, inputs, output):
    image, grid, align_corners = inputs
    ctx.save_for_backward(image, grid)
    ctx.align_corners = align_corners


def _warp_grad(backward_op):
    def grad(ctx, grad_out):
        image, grid = ctx.saved_tensors
        need_image, need_grid = ctx.needs_input_grad[:2]
        if not (need_image or need_grid):
            return None, None, None
        grad_image, grad_grid = backward_op(grad_out, image, grid,
                                            ctx.align_corners, need_image,
                                            need_grid)
        return (grad_image if need_image else None,
                grad_grid if need_grid else None, None)
    return grad


warp_wide_op.register_autograd(_warp_grad(warp_wide_backward_op),
                               setup_context=_warp_setup)
warp_narrow_op.register_autograd(_warp_grad(warp_narrow_backward_op),
                                 setup_context=_warp_setup)


def warp_wide_backward(grad_out: torch.Tensor, image: torch.Tensor,
                       grid: torch.Tensor, align_corners: bool = False,
                       need_image: bool = True, need_grid: bool = True):
    """(grad_image, grad_grid) of ``grid_sample_wide`` for ``grad_out``
    [B,Ho,Wo,C], each an empty tensor when not asked for: the kernel K1b
    on CUDA, the plain version on the CPU."""
    _device_check("warp_wide_backward", image)
    return warp_wide_backward_op(grad_out, image, grid, align_corners,
                                 need_image, need_grid)


def warp_narrow_backward(grad_out: torch.Tensor, image: torch.Tensor,
                         grid: torch.Tensor, align_corners: bool = False,
                         need_image: bool = True, need_grid: bool = True):
    """(grad_image, grad_grid) of ``grid_sample_narrow``: the kernel K2b on
    CUDA, the plain version on the CPU."""
    _device_check("warp_narrow_backward", image)
    return warp_narrow_backward_op(grad_out, image, grid, align_corners,
                                   need_image, need_grid)


def grid_sample_wide(image: torch.Tensor, grid: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Warp for channel counts that are a multiple of 8 (the bottleneck's
    256): a block per 8x8 tile of output pixels, a thread per 16 bytes of
    channels."""
    if image.device.type != "cpu":
        if image.dim() != 4 or image.shape[-1] % 8:
            raise ValueError(f"grid_sample_wide: need [Bi,H,W,C] with "
                             f"C % 8 == 0, got {tuple(image.shape)}")
        _device_check("grid_sample_wide", image)
    return warp_wide_op(image, grid, align_corners)


def grid_sample_narrow(image: torch.Tensor, grid: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """Warp for 1 to 8 channels (dense motion's RGB source): each block
    holds one source in shared memory (``narrow_smem_bytes``) and walks the
    pixels of the grids that read it."""
    if image.device.type != "cpu":
        if image.dim() != 4 or not 1 <= image.shape[-1] <= 8:
            raise ValueError(f"grid_sample_narrow: need [Bi,H,W,C] with "
                             f"1 <= C <= 8, got {tuple(image.shape)}")
        narrow_smem_bytes(*image.shape[1:], image.dtype)
        _device_check("grid_sample_narrow", image)
        check_shared_batch(image, grid)
    return warp_narrow_op(image, grid, align_corners)


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
    _device_check("grid_sample_shared", source)
    return warp_shared_op(source, grids, align_corners)


def grid_sample_twolevel_b16(image: torch.Tensor, grid: torch.Tensor,
                             tile: int = 256) -> torch.Tensor:
    """K6: ``benchmarks/bench_warp_variants.py::twolevel_b16``, the bilinear
    warp (zeros padding, ``align_corners=False``) of a float32 or bfloat16
    image [Bi, H, W, C] by a grid [B, Ho, Wo, 2] with its y pass rounded to
    bfloat16 -> [B, Ho, Wo, C] in the image dtype.  On CUDA the kernel
    (C % 8 == 0), on the CPU its plain version.  ``tile``, the TPU
    kernel's pixels a block, is checked (a positive int) and ignored: the
    result does not depend on it."""
    if isinstance(tile, bool) or not isinstance(tile, int) or tile < 1:
        raise ValueError(f"grid_sample_twolevel_b16: tile must be a positive "
                         f"int, got {tile!r}")
    if image.device.type != "cpu":
        if image.dim() != 4 or image.shape[-1] % 8:
            raise ValueError(f"grid_sample_twolevel_b16: need [Bi,H,W,C] "
                             f"with C % 8 == 0, got {tuple(image.shape)}")
        _device_check("grid_sample_twolevel_b16", image)
    return warp_wide_b16_op(image, grid)


def store_only(out: torch.Tensor) -> torch.Tensor:
    """Write zeros over the bytes of CUDA tensor ``out`` (a multiple of 16)
    with 16-byte stores and nothing else; returns ``out``."""
    if out.device.type != "cuda" or not out.is_contiguous() \
            or out.data_ptr() % 16 or out.nbytes % 16:
        raise ValueError("store_only: need a contiguous CUDA tensor, 16-byte "
                         "aligned, of a multiple of 16 bytes")
    lib, fn = kernels.entry("warp", "eamm_store_only",
                            [ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p])
    kernels.check(lib, fn(
        out.data_ptr(), out.nbytes,
        torch.cuda.current_stream(out.device).cuda_stream), "eamm_store_only")
    return out


grid_sample_wide.launches = 0
grid_sample_narrow.launches = 0
grid_sample_shared.launches = 0
grid_sample_twolevel_b16.launches = 0
warp_wide_backward.launches = 0
warp_narrow_backward.launches = 0
