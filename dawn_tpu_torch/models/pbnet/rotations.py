"""Rotation representation conversions (torch).

Port of ``dawn_tpu/models/pbnet/rotations.py`` (PBnet/src/utils/
rotation_conversions.py, the ACTOR / pytorch3d suite the PBnet evaluation
stack carries): quaternion, rotation matrix, Euler angles, axis-angle and
the continuous 6-D representation. Every function takes any leading shape,
any floating dtype and any device, and follows the JAX functions' branches
(``copysign`` of a zero difference keeps +0's sign; the small-angle series
below 1e-6 rad).
"""

from __future__ import annotations

import torch


def _stack_last(parts) -> torch.Tensor:
    return torch.stack(list(parts), dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz unit quaternions -> (..., 3, 3)."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = _stack_last([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ])
    return m.reshape(q.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz with non-negative real part."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    w = 0.5 * _sqrt_positive_part(1 + m00 + m11 + m22)
    x = 0.5 * _sqrt_positive_part(1 + m00 - m11 - m22)
    y = 0.5 * _sqrt_positive_part(1 - m00 + m11 - m22)
    z = 0.5 * _sqrt_positive_part(1 - m00 - m11 + m22)
    x = torch.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = torch.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = torch.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    return _stack_last([w, x, y, z])


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(axis)
    return _stack_last(flat).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """(..., 3) radians + convention (e.g. 'XYZ') -> (..., 3, 3)."""
    mats = [_axis_rotation(c, euler[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def matrix_to_euler_angles(m: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Inverse of euler_angles_to_matrix for proper conventions (distinct
    axes). Follows the pytorch3d tan-based extraction."""
    idx = {"X": 0, "Y": 1, "Z": 2}
    i0, i1, i2 = (idx[c] for c in convention)
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(
            m[..., i0, i2] * (-1.0 if i0 - i2 in (-1, 2) else 1.0), -1, 1))
    else:
        central = torch.acos(torch.clamp(m[..., i0, i0], -1, 1))

    def angle_from_tan(axis, other_axis, data, horizontal):
        a1, a2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
        if horizontal:
            a1, a2 = a2, a1
        even = (axis + other_axis) in ("XY", "YZ", "ZX")
        if horizontal == even:
            return torch.atan2(data[..., a1], data[..., a2])
        if tait_bryan:
            return torch.atan2(-data[..., a2], data[..., a1])
        return torch.atan2(data[..., a2], -data[..., a1])

    o0 = angle_from_tan(convention[0], convention[1], m[..., i2], False)
    o2 = angle_from_tan(convention[2], convention[1], m[..., i0, :], True)
    return _stack_last([o0, central, o2])


def _sin_half_over_angle(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, by its series below 1e-6 rad."""
    eps = 1e-6
    return torch.where(angles.abs() < eps, 0.5 - (angles * angles) / 48.0,
                       torch.sin(half) / torch.clamp(angles, min=eps))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    return torch.cat([torch.cos(half), axis_angle * _sin_half_over_angle(angles, half)], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    return q[..., 1:] / _sin_half_over_angle(2.0 * half, half)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6-D rep (Zhou et al. 2019) -> (..., 3, 3)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def _raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return _stack_last([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product a*b with its real part made non-negative."""
    out = _raw_multiply(a, b)
    return torch.where(out[..., :1] < 0, -out, out)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) points by (..., 4) quaternions."""
    p4 = torch.cat([point.new_zeros(point.shape[:-1] + (1,)), point], dim=-1)
    return _raw_multiply(_raw_multiply(q, p4), quaternion_invert(q))[..., 1:]
