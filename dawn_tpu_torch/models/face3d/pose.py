"""3DMM pose math and the eye/bbox descriptors (host numpy).

A copy of ``dawn_tpu/models/face3d/pose.py`` (the reference's
extract_init_states/utils/pose.py P2sRt :18, matrix2angle :39, pose_6 :217,
get_pose :263, which define the 7-d pose [yaw, pitch, roll, scale, t3d]
that conditions the pipeline; utils/functions.py calculate_bbox :183, the
6-d [x_min, x_max, y_min, y_max, H, W], and calculate_eye :204, the eye-open
ratios).
"""

from __future__ import annotations

from math import asin, atan2, cos
from typing import Sequence, Tuple

import numpy as np


def P2sRt(P: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Decompose a 3x4 affine camera matrix into (scale, R, t3d)."""
    t3d = P[:, 3]
    r1 = P[0:1, :3]
    r2 = P[1:2, :3]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2.0
    r1n = r1 / np.linalg.norm(r1)
    r2n = r2 / np.linalg.norm(r2)
    r3 = np.cross(r1n, r2n)
    return s, np.concatenate((r1n, r2n, r3), axis=0), t3d


def matrix2angle(R: np.ndarray) -> Tuple[float, float, float]:
    """Rotation matrix -> (yaw, pitch, roll) radians, with gimbal guards."""
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


def pose_from_param(param: np.ndarray):
    """62-d 3DMM param -> (s, [yaw,pitch,roll] deg, t3d). (pose_6, :217-228)."""
    P = param[:12].reshape(3, -1)
    s, R, t3d = P2sRt(P)
    angles = matrix2angle(R)
    pose_deg = [a * 180 / np.pi for a in angles]
    P_out = np.concatenate((R, t3d.reshape(3, 1)), axis=1)
    return s, pose_deg, t3d, P_out


def get_pose(param_lst: Sequence[np.ndarray]) -> np.ndarray:
    """The last face's 7-d pose [yaw, pitch, roll, s, tx, ty, tz] (:263-283)."""
    pose7 = None
    for param in param_lst:
        s, pose_deg, t3d, _ = pose_from_param(param)
        pose7 = np.array([pose_deg[0], pose_deg[1], pose_deg[2], s,
                          t3d[0], t3d[1], t3d[2]])
    return pose7


def calculate_bbox(img_shape: Tuple[int, int], lmk: np.ndarray):
    """Landmarks (3, N) -> [x_min, x_max, y_min, y_max, H, W] (:183-203)."""
    pts = np.int32(lmk.T[:, :2].reshape(-1, 2))
    h, w = img_shape[:2]
    return [pts[:, 0].min(), pts[:, 0].max(), pts[:, 1].min(), pts[:, 1].max(), h, w]


def calculate_eye(lmk: np.ndarray) -> Tuple[float, float]:
    """Eye open ratios from the 68-landmark set (3, N) (:204-217)."""
    p = lmk.T
    left = np.linalg.norm(p[43] - p[47], 2) / np.linalg.norm(p[45] - p[42], 2)
    right = np.linalg.norm(p[37] - p[41], 2) / np.linalg.norm(p[39] - p[36], 2)
    return left, right
