"""Batched quaternion math, xyzw layout.

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


# alias matching the reference symbol name
my_quat_rotate = quat_rotate


def quat_identity(shape=(), device=None):
    """Identity quaternion(s) with the given leading batch shape."""
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_from_euler_xyz(roll, pitch, yaw):
    """Quaternion from intrinsic x-y-z (roll, pitch, yaw) Euler angles."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    w = cr * cp * cy + sr * sp * sy
    return torch.stack([x, y, z, w], dim=-1)


def quat_apply(q, v):
    return quat_rotate(q, v)


def quat_to_rotmat(q):
    """(..., 4) xyzw -> (..., 3, 3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(m):
    """(..., 3, 3) -> (..., 4) xyzw. Branch-free Shepperd-style selection."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    # the candidate with the largest pivot (first of equals, as argmax)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, wxyz)
    gather = idx[..., None, None].expand(idx.shape + (1, 4))
    q_wxyz = torch.gather(cand, -2, gather)[..., 0, :]
    return quat_unit(torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], dim=-1))


def exp_map_to_quat(exp_map):
    """Exponential map (axis*angle, (...,3)) -> quaternion (...,4 xyzw)."""
    angle = torch.linalg.norm(exp_map, dim=-1)
    axis = exp_map / torch.clamp(angle, min=_EPS)[..., None]
    # the z axis for ~zero rotations
    axis = torch.where(angle[..., None] > _EPS, axis, _z_axis(exp_map))
    return quat_from_angle_axis(angle, axis)


def quat_to_angle_axis(q):
    """Quaternion -> (angle (...,), axis (...,3)), the angle wrapped to (-pi, pi]."""
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    angle = normalize_angle(2.0 * torch.acos(w))
    sin_half = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    axis = q[..., 0:3] / torch.clamp(sin_half, min=_EPS)[..., None]
    axis = torch.where(sin_half[..., None] > 1e-5, axis, _z_axis(q))
    return angle, axis


def quat_to_exp_map(q):
    angle, axis = quat_to_angle_axis(q)
    return angle[..., None] * axis


def quat_to_tan_norm(q):
    """Quaternion -> 6D tangent-normal representation (rotated x and z axes)."""
    ref_tan = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    ref_tan[..., 0] = 1.0
    return torch.cat([quat_rotate(q, ref_tan), quat_rotate(q, _z_axis(q))], dim=-1)


def scale(x, lower, upper):
    """[-1, 1] action -> [lower, upper] (reference ``scale``)."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale(x, lower, upper):
    """[lower, upper] -> [-1, 1] (reference ``unscale``)."""
    return (2.0 * x - upper - lower) / (upper - lower)


def tensor_clamp(x, lower, upper):
    return torch.clamp(x, lower, upper)


def get_axis_params(value, axis_idx, x_value=0.0, n_dims=3):
    """Vector with ``value`` on ``axis_idx`` and ``x_value`` elsewhere-on-x."""
    v = [x_value if i == 0 else 0.0 for i in range(n_dims)]
    v[axis_idx] = value
    return torch.tensor(v, dtype=torch.float32)


def rand_float(generator, lower, upper, shape):
    """Uniform floats in [lower, upper) (reference ``torch_rand_float``) on
    the generator's device, drawn from an explicit ``torch.Generator`` where
    the JAX package takes a PRNG key."""
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (upper - lower) + lower


torch_rand_float = rand_float

# ``to_jnp`` (the JAX package's array constructor) has no counterpart here:
# ``torch.as_tensor`` is that function.


def compute_heading_and_up(torso_rotation, inv_start_rot, to_target,
                           vec0, vec1, up_idx):
    """NV-humanoid heading/up decomposition.

    Returns (torso_quat, up_proj, heading_proj, up_vec, heading_vec)."""
    target_dirs = to_target / torch.clamp(
        torch.linalg.norm(to_target, dim=-1, keepdim=True), min=_EPS)
    torso_quat = quat_mul(torso_rotation, inv_start_rot)
    up_vec = quat_rotate(torso_quat, vec1)
    heading_vec = quat_rotate(torso_quat, vec0)
    up_proj = up_vec[..., up_idx]
    heading_proj = torch.sum(heading_vec * target_dirs, dim=-1)
    return torso_quat, up_proj, heading_proj, up_vec, heading_vec


def compute_rot(torso_quat, velocity, ang_velocity, targets, torso_positions):
    """Local-frame velocities, euler angles and angle to target (companion
    of :func:`compute_heading_and_up`)."""
    vel_loc = quat_rotate_inverse(torso_quat, velocity)
    angvel_loc = quat_rotate_inverse(torso_quat, ang_velocity)
    roll, pitch, yaw = get_euler_xyz(torso_quat)
    walk_target_angle = torch.atan2(
        targets[..., 2] - torso_positions[..., 2],
        targets[..., 0] - torso_positions[..., 0])
    return vel_loc, angvel_loc, roll, pitch, yaw, walk_target_angle - yaw


def slerp(q0, q1, t):
    """Spherical linear interpolation between unit quaternions (xyzw)."""
    cos_half = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(cos_half < 0.0, -q1, q1)
    cos_half = torch.abs(cos_half)
    half = torch.acos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0))
    denom = torch.clamp(sin_half, min=_EPS)
    ratio_a = torch.where(sin_half > 1e-5, torch.sin((1.0 - t) * half) / denom, 1.0 - t)
    ratio_b = torch.where(sin_half > 1e-5, torch.sin(t * half) / denom, t)
    return quat_unit(ratio_a * q0 + ratio_b * q1)
