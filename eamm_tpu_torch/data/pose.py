"""Head pose from a 3x4 camera matrix, and from 68 facial landmarks.

The port's copy of ``eamm_tpu/data/pose.py`` (numpy): the reference's pose
files hold per frame [yaw, pitch, roll (degrees), scale, t3d.x, t3d.y,
t3d.z], decomposed from a 3DMM camera matrix (``P2sRt``,
``matrix2angle``; ``pose_from_param``).  ``pose_from_landmarks`` fits
the same weak-perspective 3x4 matrix to 68 2-D landmarks against a
canonical 3-D landmark template (``template_3d``) by linear least squares
and decomposes it the same way, so a pose file made from landmarks keeps
the conventions of one made from 3DMM parameters.  With the coarse
landmark fallback (``data/landmarks.py``) the landmarks are a rigidly
placed template: yaw and pitch read about 0, and the fit gives roll,
scale and translation.
"""
from __future__ import annotations

from math import asin, atan2, cos, sin

import numpy as np


def P2sRt(P: np.ndarray):
    """Decompose a 3x4 affine camera matrix into scale, rotation, t3d."""
    t3d = P[:, 3]
    R1 = P[0:1, :3]
    R2 = P[1:2, :3]
    s = (np.linalg.norm(R1) + np.linalg.norm(R2)) / 2.0
    r1 = R1 / np.linalg.norm(R1)
    r2 = R2 / np.linalg.norm(R2)
    r3 = np.cross(r1, r2)
    return s, np.concatenate((r1, r2, r3), 0), t3d


def matrix2angle(R: np.ndarray):
    """Rotation matrix -> (yaw, pitch, roll) radians (ref convention)."""
    if R[2, 0] > 0.998:
        z = 0.0
        x = np.pi / 2
        y = z + atan2(-R[0, 1], -R[0, 2])
    elif R[2, 0] < -0.998:
        z = 0.0
        x = -np.pi / 2
        y = -z + atan2(R[0, 1], R[0, 2])
    else:
        x = asin(R[2, 0])
        y = atan2(R[2, 1] / cos(x), R[2, 2] / cos(x))
        z = atan2(R[1, 0] / cos(x), R[0, 0] / cos(x))
    return x, y, z


def angle2matrix(theta) -> np.ndarray:
    """(yaw, pitch, roll) radians -> rotation matrix (inverse of
    matrix2angle for non-degenerate poses; ref:3DDFA_V2/utils/pose.py:65-110)."""
    R_x = np.array([[1, 0, 0],
                    [0, cos(theta[1]), -sin(theta[1])],
                    [0, sin(theta[1]), cos(theta[1])]])
    R_y = np.array([[cos(theta[0]), 0, sin(-theta[0])],
                    [0, 1, 0],
                    [-sin(-theta[0]), 0, cos(theta[0])]])
    R_z = np.array([[cos(theta[2]), -sin(theta[2]), 0],
                    [sin(theta[2]), cos(theta[2]), 0],
                    [0, 0, 1]])
    return R_z @ R_y @ R_x


# Canonical per-landmark depth profile (iBUG-68 ordering), in units of the
# inter-ocular distance, datum = the eye plane (z toward the camera).
# Coarse anthropometric ratios: jaw contour recedes toward the ears
# (~1 IOD at the jaw top), brow ridge sits slightly proud, the nose bridge
# ramps to the tip (~0.5 IOD), nostril bases and lips sit between.  The
# profile only needs relative correctness — the weak-perspective fit scales
# it — and is symmetric left/right.
_JAW_Z = [-1.00, -0.92, -0.80, -0.65, -0.48, -0.32, -0.19, -0.10, -0.06]
_BROW_Z = [0.06, 0.14, 0.16, 0.14, 0.10]
_TEMPLATE_Z = np.asarray(
    _JAW_Z + _JAW_Z[-2::-1]                                   # 0-16 jaw
    + _BROW_Z + _BROW_Z[::-1]                                 # 17-26 brows
    + [0.18, 0.30, 0.42, 0.50]                                # 27-30 bridge
    + [0.28, 0.33, 0.38, 0.33, 0.28]                          # 31-35 nose base
    + [0.0] * 12                                              # 36-47 eyes
    + [0.16, 0.24, 0.28, 0.30, 0.28, 0.24, 0.16,              # 48-54 outer lip
       0.20, 0.24, 0.26, 0.24, 0.20]                          # 55-59
    + [0.20, 0.24, 0.26, 0.24, 0.20, 0.22, 0.24, 0.22],       # 60-67 inner lip
    np.float64)


def template_3d(template2d: np.ndarray) -> np.ndarray:
    """[68, 2] landmark template (image coords, y down) -> [68, 3] canonical
    3-D landmarks: x/y from the template, z from the anthropometric depth
    profile scaled by the template's inter-ocular distance, centroid at the
    origin.  z points toward the camera, matching the space the reference's
    camera matrices map into (ref:3DDFA_V2/utils/pose.py:216-230)."""
    t = np.asarray(template2d, np.float64)
    if t.shape != (68, 2):
        raise ValueError(f"expected [68, 2] template, got {t.shape}")
    iod = float(np.linalg.norm(t[42:48].mean(0) - t[36:42].mean(0)))
    pts = np.concatenate([t, (_TEMPLATE_Z * iod)[:, None]], axis=1)
    return pts - pts.mean(0)


def camera_from_landmarks(landmarks: np.ndarray,
                          template3d: np.ndarray) -> np.ndarray:
    """Weak-perspective 3x4 camera matrix P with x_2d ~= (P @ [X; 1])[:2]
    by linear least squares over the 68 correspondences.  The third row is
    completed as s * (r1 x r2), t3d.z = 0 (depth along the optical axis is
    unobservable under weak perspective) — the shape ``pose_from_param``'s
    decomposition consumes."""
    lm = np.asarray(landmarks, np.float64)
    X = np.asarray(template3d, np.float64)
    A = np.concatenate([X, np.ones((len(X), 1))], axis=1)     # [68, 4]
    rows, *_ = np.linalg.lstsq(A, lm, rcond=None)             # [4, 2]
    P = np.zeros((3, 4))
    P[:2] = rows.T
    s, R, _ = P2sRt(P)
    P[2, :3] = s * R[2]
    return P


def pose_from_landmarks(landmarks: np.ndarray,
                        template2d: np.ndarray) -> np.ndarray:
    """68 2-D landmarks (image pixel coords) -> the reference's 7-vector
    [yaw_deg, pitch_deg, roll_deg, s, t3d.x, t3d.y, t3d.z] via the identical
    camera-matrix decomposition used for 3DDFA params."""
    P = camera_from_landmarks(landmarks, template_3d(template2d))
    return pose_from_param(P.reshape(-1))


def pose_from_param(param: np.ndarray) -> np.ndarray:
    """3DMM ``param`` (first 12 = camera matrix) -> 7-vector
    [yaw_deg, pitch_deg, roll_deg, s, t3d.x, t3d.y, t3d.z]
    (ref:3DDFA_V2/utils/pose.py:216-230,263-283)."""
    P = np.asarray(param[:12], np.float64).reshape(3, -1)
    s, R, t3d = P2sRt(P)
    pose = [p * 180 / np.pi for p in matrix2angle(R)]
    return np.array([pose[0], pose[1], pose[2], s, t3d[0], t3d[1], t3d[2]])
