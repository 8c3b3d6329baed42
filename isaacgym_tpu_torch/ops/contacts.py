"""Contact geometry and impulse resolution of the non-kernel path, in torch.

Counterpart of ``isaacgym_tpu/ops/contacts.py`` (``:32-227``): sphere vs
plane, oriented box, z-axis cylinder and sphere (closest point, signed
distance, the normal that pushes the sphere out), the velocity-level
impulse against a static or kinematic surface with the bounce-threshold
restitution and Coulomb friction, its spin-aware form (friction at the
contact point with ``kappa = m r^2 / I``), the swept-sample CCD frame,
positional depenetration and PhysX's average material combine.

Every function works elementwise over any leading dimensions, where the JAX
package's single-env functions are vmapped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from isaacgym_tpu_torch.utils import rotations as rot

_EPS = 1e-9


class ContactFrame(NamedTuple):
    """Signed distance and frame of a sphere-vs-geom candidate."""
    dist: torch.Tensor     # (...,) signed separation (negative = penetrating)
    normal: torch.Tensor   # (..., 3) unit, pushes the sphere out of the geom
    point: torch.Tensor    # (..., 3) contact point on the sphere surface


def _norm(v):
    return torch.linalg.norm(v, dim=-1)


def _lever(radius):
    """A radius against (..., 3) vectors: a tensor radius gains the last axis."""
    return radius[..., None] if torch.is_tensor(radius) else radius


def sphere_plane(center, radius, plane_z=0.0):
    """Sphere vs the horizontal plane z = plane_z, normal +z."""
    dist = center[..., 2] - plane_z - radius
    n = torch.zeros_like(center)
    n[..., 2] = 1.0
    return ContactFrame(dist, n, center - n * radius)


def sphere_box(center, radius, box_pos, box_quat, half_extents):
    """Sphere vs oriented box, closest-point formulation; a centre inside
    the box exits through the nearest face (first axis on a tie)."""
    c_local = rot.quat_rotate_inverse(box_quat, center - box_pos)
    closest = torch.minimum(torch.maximum(c_local, -half_extents), half_extents)
    d = c_local - closest
    out_dist = _norm(d)
    gap = half_extents - torch.abs(c_local)
    axis = torch.argmin(gap, dim=-1, keepdim=True)
    sign = torch.sign(c_local).gather(-1, axis)
    inside_n = torch.zeros_like(c_local).scatter(
        -1, axis, torch.where(sign == 0, torch.ones_like(sign), sign))
    inside_dist = -gap.gather(-1, axis)[..., 0]
    outside = out_dist > _EPS
    n_local = torch.where(outside[..., None], d / torch.clamp(out_dist, min=_EPS)[..., None],
                          inside_n)
    dist = torch.where(outside, out_dist, inside_dist) - radius
    n = rot.quat_rotate(box_quat, n_local)
    return ContactFrame(dist, n, center - n * _lever(radius))


def sphere_cylinder(center, radius, cyl_pos, cyl_quat, cyl_radius, half_len):
    """Sphere vs solid cylinder whose axis is its local z."""
    c = rot.quat_rotate_inverse(cyl_quat, center - cyl_pos)
    r_xy = _norm(c[..., :2])
    scale = torch.clamp(cyl_radius / torch.clamp(r_xy, min=_EPS), max=1.0)
    closest = torch.cat([c[..., :2] * scale[..., None],
                         torch.minimum(torch.maximum(c[..., 2:3], -half_len[..., None]),
                                       half_len[..., None])], dim=-1)
    d = c - closest
    out_dist = _norm(d)
    outside = out_dist > _EPS
    face_gap = half_len - torch.abs(c[..., 2])
    wall_gap = cyl_radius - r_xy
    z_sign = torch.where(c[..., 2] >= 0, 1.0, -1.0).to(c.dtype)
    n_face = torch.cat([torch.zeros_like(c[..., :2]), z_sign[..., None]], dim=-1)
    radial = c[..., :2] / torch.clamp(r_xy, min=_EPS)[..., None]
    n_wall = torch.cat([radial, torch.zeros_like(c[..., 2:3])], dim=-1)
    use_face = face_gap < wall_gap
    inside_n = torch.where(use_face[..., None], n_face, n_wall)
    inside_dist = -torch.minimum(face_gap, wall_gap)
    n_local = torch.where(outside[..., None], d / torch.clamp(out_dist, min=_EPS)[..., None],
                          inside_n)
    dist = torch.where(outside, out_dist, inside_dist) - radius
    n = rot.quat_rotate(cyl_quat, n_local)
    return ContactFrame(dist, n, center - n * _lever(radius))


def sphere_sphere(center, radius, other_pos, other_radius):
    d = center - other_pos
    dn = _norm(d)
    n = d / torch.clamp(dn, min=_EPS)[..., None]
    return ContactFrame(dn - other_radius - radius, n, center - n * _lever(radius))


def resolve_sphere_impulse(v_ball, frame: ContactFrame, v_surf, restitution, friction,
                           bounce_threshold=0.2, dt=0.0):
    """Velocity change of a free sphere against a kinematic or static
    surface, per unit ball mass; ``dt`` > 0 activates speculatively
    (dist + vn dt < 0). Returns (dv, impulse_per_mass, active)."""
    v_rel = v_ball - v_surf
    vn = torch.sum(v_rel * frame.normal, dim=-1)
    active = (frame.dist + vn * dt < 0.0) & (vn < 0.0)
    e = torch.where(torch.abs(vn) > bounce_threshold, restitution, 0.0)
    jn = -(1.0 + e) * vn
    vt = v_rel - vn[..., None] * frame.normal
    vt_norm = _norm(vt)
    jt = torch.minimum(friction * jn, vt_norm)
    t_hat = vt / torch.clamp(vt_norm, min=_EPS)[..., None]
    dv = jn[..., None] * frame.normal - jt[..., None] * t_hat
    dv = torch.where(active[..., None], dv, 0.0)
    return dv, dv, active


def resolve_sphere_impulse_spin(v_ball, omega, radius, kappa, frame: ContactFrame, v_surf,
                                restitution, friction, bounce_threshold=0.2, dt=0.0):
    """Spin-aware :func:`resolve_sphere_impulse`: the slip at the contact
    point ``c - r n`` includes ``-r (omega x n)``, a tangential impulse j_t
    changes it by ``-(1 + kappa) j_t`` and the spin by ``(kappa j_t / r)
    (n x t_hat)``; ``kappa`` = 0 decouples the spin. Returns (dv, domega,
    impulse_per_mass, active)."""
    n = frame.normal
    v_rel = v_ball - v_surf
    vn = torch.sum(v_rel * n, dim=-1)
    active = (frame.dist + vn * dt < 0.0) & (vn < 0.0)
    e = torch.where(torch.abs(vn) > bounce_threshold, restitution, 0.0)
    jn = -(1.0 + e) * vn
    slip = v_rel - radius * torch.linalg.cross(omega.expand_as(n), n, dim=-1) if kappa > 0.0 \
        else v_rel
    vt = slip - torch.sum(slip * n, dim=-1)[..., None] * n
    vt_norm = _norm(vt)
    jt = torch.minimum(friction * jn, vt_norm / (1.0 + kappa))
    t_hat = vt / torch.clamp(vt_norm, min=_EPS)[..., None]
    dv = jn[..., None] * n - jt[..., None] * t_hat
    dv = torch.where(active[..., None], dv, 0.0)
    domega = (kappa / radius) * jt[..., None] * torch.linalg.cross(n, t_hat, dim=-1)
    domega = torch.where(active[..., None], domega, 0.0)
    return dv, domega, dv, active


def swept_frame(geom_fn, pos, v_rel, dt, samples: int = 4):
    """Swept-sample CCD: the closest-point test ``geom_fn`` at ``samples+1``
    points ``pos + v_rel t`` over one substep; the FIRST penetrating sample's
    (dist, normal), or the current sample's when none penetrates, with the
    current sample's contact point. Returns ``(frame, now_dist)``, the
    current-position distance for the positional depenetration."""
    f0 = geom_fn(pos)
    if dt == 0.0:
        return f0, f0.dist
    frames = [f0] + [geom_fn(pos + v_rel * (dt * k / samples)) for k in range(1, samples + 1)]
    dists = torch.stack([f.dist for f in frames])            # (K+1, ...)
    normals = torch.stack([f.normal for f in frames])        # (K+1, ..., 3)
    j = torch.argmax((dists < 0.0).to(torch.int8), dim=0, keepdim=True)
    dist = torch.gather(dists, 0, j)[0]
    normal = torch.gather(normals, 0, j[..., None].expand((1,) + normals.shape[1:]))[0]
    return ContactFrame(dist=dist, normal=normal, point=f0.point), f0.dist


def depenetrate(pos, frame: ContactFrame, active):
    """Positional projection: push the sphere centre out of penetration."""
    push = torch.clamp(-frame.dist, min=0.0)
    return pos + torch.where(active[..., None], frame.normal * push[..., None], 0.0)


def combine_material(e_a, e_b, mu_a, mu_b):
    """PhysX's default combine mode: the average."""
    return 0.5 * (e_a + e_b), 0.5 * (mu_a + mu_b)
