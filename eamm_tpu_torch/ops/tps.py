"""Random affine + thin-plate-spline transform for the equivariance losses.

Counterpart of ``eamm_tpu/ops/tps.py``: parameters are drawn once per
batch (from a ``torch.Generator`` here, a PRNG key there, so the two
packages' draws differ: feed both the same ``TpsParams`` to compare them),
the warps are plain functions, and the keypoint Jacobian of the warp is
written out analytically.  The TPS radial term uses the L1 distance
|z - c|_1, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from eamm_tpu_torch.ops.grid import make_coordinate_grid
from eamm_tpu_torch.ops.warp import grid_sample

_LOG_EPS = 1e-6


class TpsParams(NamedTuple):
    theta: torch.Tensor           # [B, 2, 3] affine
    control_points: torch.Tensor  # [P^2, 2]
    control_params: torch.Tensor  # [B, 1, P^2]


def sample_tps(batch: int, sigma_affine: float, sigma_tps: float,
               points_tps: int, generator: torch.Generator | None = None,
               device=None, dtype=torch.float32) -> TpsParams:
    """theta = I + N(0, sigma_affine); control points on a points_tps^2
    grid in [-1, 1]^2; their weights N(0, sigma_tps)."""
    theta = torch.randn((batch, 2, 3), generator=generator, device=device,
                        dtype=dtype) * sigma_affine \
        + torch.eye(2, 3, device=device, dtype=dtype)[None]
    cp = make_coordinate_grid(points_tps, points_tps, dtype,
                              device).reshape(-1, 2)
    params = torch.randn((batch, 1, points_tps ** 2), generator=generator,
                         device=device, dtype=dtype) * sigma_tps
    return TpsParams(theta, cp, params)


def _l1_distances(tps: TpsParams, coords: torch.Tensor) -> torch.Tensor:
    """[B, N, P^2, 2] signed offsets of the points from the control
    points."""
    return coords[:, :, None, :] - tps.control_points[None, None]


def warp_coordinates(tps: TpsParams, coords: torch.Tensor) -> torch.Tensor:
    """[B, N, 2] -> warped [B, N, 2]: the affine map, plus the TPS term, one
    scalar per point added to both coordinates."""
    out = torch.einsum("bij,bnj->bni", tps.theta[:, :, :2], coords) \
        + tps.theta[:, None, :, 2]
    dist = _l1_distances(tps, coords).abs().sum(-1)            # [B,N,P^2]
    radial = dist ** 2 * torch.log(dist + _LOG_EPS)
    return out + (radial * tps.control_params[:, 0, None, :]).sum(2)[..., None]


def transform_frame(tps: TpsParams, frame: torch.Tensor) -> torch.Tensor:
    """Warp [B, H, W, C] frames by the transform, reflection padding."""
    B, H, W, _ = frame.shape
    grid = make_coordinate_grid(H, W, frame.dtype, frame.device)
    grid = grid.reshape(1, -1, 2).expand(B, H * W, 2)
    warped = warp_coordinates(tps, grid).reshape(B, H, W, 2)
    return grid_sample(frame, warped, padding_mode="reflection")


def warp_jacobian(tps: TpsParams, coords: torch.Tensor) -> torch.Tensor:
    """d warp / d coords at each point, [B, N, 2, 2]: theta's linear part
    plus, in every row, the gradient of the TPS scalar
    sum_k p_k r(d_k), r(d) = d^2 log(d + 1e-6), d_k = |z - c_k|_1."""
    off = _l1_distances(tps, coords)                           # [B,N,P^2,2]
    dist = off.abs().sum(-1, keepdim=True)
    dr = 2.0 * dist * torch.log(dist + _LOG_EPS) + dist ** 2 / (dist + _LOG_EPS)
    grad = (tps.control_params[:, 0, None, :, None] * dr
            * torch.sign(off)).sum(2)                          # [B,N,2]
    return tps.theta[:, None, :, :2] + grad[:, :, None, :]
