"""Sparse keypoint-motion math (PyTorch counterpart of
``eamm_tpu/ops/motion.py``): the K+1 candidate backward warps of the
first-order motion model and the inference-time keypoint normalization."""
from __future__ import annotations

import torch

from eamm_tpu_torch.ops.grid import make_coordinate_grid


def inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 2, 2] matrices (valid in any float dtype)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def sparse_motions(spatial_size: tuple[int, int],
                   kp_driving_value: torch.Tensor,
                   kp_source_value: torch.Tensor,
                   kp_driving_jacobian: torch.Tensor | None = None,
                   kp_source_jacobian: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """[B, K+1, h, w, 2] backward warps in [-1, 1] (x, y): the identity grid
    first, then J_s J_d^-1 (z - kp_d) + kp_s for each keypoint."""
    h, w = spatial_size
    B = kp_driving_value.shape[0]
    identity = make_coordinate_grid(h, w, kp_driving_value.dtype,
                                    kp_driving_value.device)
    coord = identity[None, None] - kp_driving_value[:, :, None, None, :]
    if kp_driving_jacobian is not None:
        jac = kp_source_jacobian @ inv2x2(kp_driving_jacobian)
        coord = torch.einsum("bkij,bkhwj->bkhwi", jac, coord)
    driving_to_source = coord + kp_source_value[:, :, None, None, :]
    return torch.cat([identity[None, None].expand(B, 1, h, w, 2),
                      driving_to_source], dim=1)


def relative_kp(kp_driving_value, kp_driving_initial_value, kp_source_value,
                kp_driving_jacobian=None, kp_driving_initial_jacobian=None,
                kp_source_jacobian=None, movement_scale: float = 1.0):
    """value' = scale (kp_d - kp_d0) + kp_s; jacobian' = (J_d J_d0^-1) J_s.
    Returns (value, jacobian), the jacobian None without driving jacobians."""
    value = (kp_driving_value - kp_driving_initial_value) * movement_scale \
        + kp_source_value
    jacobian = None
    if kp_driving_jacobian is not None:
        diff = kp_driving_jacobian @ inv2x2(kp_driving_initial_jacobian)
        jacobian = diff @ kp_source_jacobian
    return value, jacobian


def normalize_kp(kp_source: dict, kp_driving: dict, kp_driving_initial: dict,
                 use_relative_movement: bool = False,
                 use_relative_jacobian: bool = False,
                 adapt_movement_scale: float = 1.0) -> dict:
    """Driving keypoints, moved relative to the first driving frame when
    ``use_relative_movement`` (dict in, dict out)."""
    kp_new = dict(kp_driving)
    if use_relative_movement:
        value, jacobian = relative_kp(
            kp_driving["value"], kp_driving_initial["value"],
            kp_source["value"],
            kp_driving.get("jacobian") if use_relative_jacobian else None,
            kp_driving_initial.get("jacobian"), kp_source.get("jacobian"),
            movement_scale=adapt_movement_scale)
        kp_new["value"] = value
        if use_relative_jacobian and jacobian is not None:
            kp_new["jacobian"] = jacobian
    return kp_new
