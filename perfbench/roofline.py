"""The card's peaks and the least time each hand-written kernel could take
for the work of one launch, from the launch's shapes.

Peaks of an NVIDIA H100 SXM (NVIDIA's data sheet, dense): device memory
3.35 TB/s; bfloat16 tensor cores 989 TFLOP/s; float32 outside the tensor
cores 67 TFLOP/s.  A kernel's bound is the larger of its bytes at the
memory peak and its operations at the float32 peak, each input read once
and each output written once (the count of the port's kernel table).
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2,
               "double": 8}


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * DTYPE_BYTES[dtype]


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)


def warp_forward(shapes, dtypes) -> float:
    """K1 / K2: image [Bi, H, W, C] by grid [B, Ho, Wo, 2] -> out
    [B, Ho, Wo, C] in the image's dtype; 8 operations an output value (4
    multiply-adds)."""
    image, grid = shapes[0], shapes[1]
    out = [grid[0], grid[1], grid[2], image[3]]
    n = _bytes(image, dtypes[0]) + _bytes(grid, dtypes[1]) \
        + _bytes(out, dtypes[0])
    return bound_s(n, 8 * math.prod(out))


def warp_backward(shapes, dtypes, need_image: bool, need_grid: bool
                  ) -> float:
    """K1b / K2b: (grad_out [B, Ho, Wo, C], image [Bi, H, W, C], grid) ->
    the image's gradient (when asked for) and the grid's (when asked for):
    grad_out and the grid read once, the image once for the grid's
    gradient, each gradient written once; 2 operations a (pixel, corner,
    channel) for each gradient."""
    grad_out, image, grid = shapes[0], shapes[1], shapes[2]
    n = _bytes(grad_out, dtypes[0]) + _bytes(grid, dtypes[2])
    if need_grid:
        n += _bytes(image, dtypes[1]) + _bytes(grid, dtypes[2])
    if need_image:
        n += _bytes(image, dtypes[1])
    ops = math.prod(grad_out) * 4 * (2 * need_image + 2 * need_grid)
    return bound_s(n, ops)


def kp_expectation_backward(shapes, dtypes) -> float:
    """K3b: (pred [B, K, h, w], jmap [B, K, 4, h, w], temperature, g_value,
    g_jac) -> their gradients: pred and jmap read and their gradients
    written, the output gradients read; ~30 operations a logit."""
    pred, jmap, g_value, g_jac = shapes[0], shapes[1], shapes[3], shapes[4]
    n = 2 * (_bytes(pred, dtypes[0]) + _bytes(jmap, dtypes[1])) \
        + _bytes(g_value, dtypes[3]) + _bytes(g_jac, dtypes[4])
    return bound_s(n, 30 * math.prod(pred))
