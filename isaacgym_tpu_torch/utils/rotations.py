"""Batched quaternion math, xyzw layout, the functions the flagship slice uses.

Counterpart of ``isaacgym_tpu/utils/rotations.py``: the same formulas over
arbitrary leading batch dimensions, ``q`` is ``(..., 4)`` and ``v`` is
``(..., 3)``.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def quat_unit(q):
    """Normalize a quaternion to unit length."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_from_angle_axis(angle, axis):
    """Quaternion from rotation ``angle`` (rad) about unit-ish ``axis``."""
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    half = 0.5 * angle
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None]
    return torch.cat([xyz, w], dim=-1)


def quat_mul(a, b):
    """Hamilton product a*b."""
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2
    z = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate ``v`` by ``q``: v + 2w(u x v) + u x (2 u x v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_rotate_inverse(q, v):
    """Rotate ``v`` by the inverse of ``q``."""
    u = -q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def calc_heading(q):
    """Yaw of ``q``: where the rotated x axis points in the world x-y plane."""
    ref_dir = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ref_dir[..., 0] = 1.0
    rot_dir = quat_rotate(q, ref_dir)
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def _z_axis(q):
    axis = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    axis[..., 2] = 1.0
    return axis


def calc_heading_quat(q):
    """Pure-yaw quaternion with the same heading as ``q``."""
    return quat_from_angle_axis(calc_heading(q), _z_axis(q))


def calc_heading_quat_inv(q):
    """Inverse of the heading quaternion (world into heading-local)."""
    return quat_from_angle_axis(-calc_heading(q), _z_axis(q))


def normalize_angle(x):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def get_euler_xyz(q):
    """Quaternion -> intrinsic XYZ euler angles (roll, pitch, yaw), each
    wrapped to (-pi, pi] as in the JAX package."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = 1.0 - 2.0 * (qx * qx + qy * qy)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return normalize_angle(roll), normalize_angle(pitch), normalize_angle(yaw)
