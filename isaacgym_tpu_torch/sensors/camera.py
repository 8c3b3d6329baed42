"""Batched ray-cast camera sensor, the ``enableCameraSensors`` capability.

Counterpart of ``isaacgym_tpu/sensors/camera.py``: a fixed pinhole camera
ray-traced against the scene's analytic collision geoms (sphere, box,
cylinder and the ground plane), over every env of the batch at once, in
plain PyTorch on the env's device. It returns depth (metres along the ray),
RGB (Lambert shading with a per-actor palette) and per-pixel segmentation
(the actor index, -2 for the ground plane, -1 for sky), the reference's
IMAGE_DEPTH, IMAGE_COLOR and IMAGE_SEGMENTATION image types.

The JAX camera stacks every geom's hit distances and normals and takes the
argmin; here a running nearest hit (distance, normal, geom index) is kept
and each geom replaces it only where it is strictly nearer, which picks the
same geom as the argmin (the first of equal distances). Only one geom's
(B, P, 3) temporaries are alive at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.utils import rotations as rot

_BIG = 1e9


class _GeomTable(NamedTuple):
    """Static per-geom arrays; world poses come from body states at render."""
    kind: np.ndarray        # (G,) GEOM_*
    body: np.ndarray        # (G,) env-level body index carrying the geom
    local_pos: np.ndarray   # (G, 3)
    local_quat: np.ndarray  # (G, 4)
    size: np.ndarray        # (G, 3)
    actor: np.ndarray       # (G,) owning actor index (segmentation id)


def _build_geom_table(scene) -> _GeomTable:
    kinds, bodies, lpos, lquat, sizes, actors = [], [], [], [], [], []
    for g in scene.static_geoms:
        kinds.append(g.kind); bodies.append(g.body_start)
        lpos.append(g.local_pos); lquat.append(g.local_quat)
        sizes.append(g.size); actors.append(g.actor_index)
    for g in scene.art_geoms:
        slot = scene.articulations[g.art_index]
        kinds.append(g.kind); bodies.append(slot.body_start + g.body_index)
        lpos.append(g.local_pos); lquat.append(g.local_quat)
        sizes.append(g.size); actors.append(slot.actor_index)
    for fb in scene.free_bodies:
        kinds.append(U.GEOM_SPHERE); bodies.append(fb.body_start)
        lpos.append(np.zeros(3)); lquat.append(np.asarray([0, 0, 0, 1.0]))
        sizes.append(np.asarray([fb.radius, 0.0, 0.0])); actors.append(fb.actor_index)
    return _GeomTable(
        kind=np.asarray(kinds), body=np.asarray(bodies),
        local_pos=np.stack(lpos).astype(np.float32),
        local_quat=np.stack(lquat).astype(np.float32),
        size=np.stack(sizes).astype(np.float32),
        actor=np.asarray(actors))


def _tiny(x):
    """``x`` with magnitudes below 1e-9 replaced by +-1e-9 (sign of ``x``,
    + for 0), so a division by it stays finite."""
    return torch.where(x.abs() < 1e-9, torch.where(x >= 0, 1e-9, -1e-9), x)


def _ray_sphere(o, d, center, radius):
    """Rays from ``o`` (3,) along ``d`` (P, 3) against one sphere per env
    (``center`` (B, 3)) -> (t (B, P), world normal (B, P, 3))."""
    oc = (o - center)[:, None, :]                       # (B, 1, 3)
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t = torch.where((disc >= 0.0) & (t > 1e-4), t, _BIG)
    n = (oc + t[..., None] * d) / radius
    return t, n


def _local_rays(o, d, pos, quat):
    """Ray origins and directions in the frame of a geom at (pos, quat),
    each (B, 3) -> ((B, 1, 3), (B, P, 3))."""
    qi = rot.quat_conjugate(quat)[:, None, :]
    return rot.quat_rotate(qi, (o - pos)[:, None, :]), rot.quat_rotate(qi, d[None])


def _ray_box(o, d, pos, quat, half):
    """Slab test in the box frame -> (t, world face normal)."""
    ol, dl = _local_rays(o, d, pos, quat)
    inv = 1.0 / _tiny(dl)
    t1 = (-half - ol) * inv
    t2 = (half - ol) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin > 1e-4)
    t = torch.where(hit, tmin, _BIG)
    h_local = ol + tmin[..., None] * dl
    face = torch.argmax(h_local.abs() / half, dim=-1)
    n_local = (torch.nn.functional.one_hot(face, 3).to(h_local.dtype)
               * torch.sign(h_local))
    return t, rot.quat_rotate(quat[:, None, :], n_local)


def _ray_cylinder(o, d, pos, quat, radius, half_len):
    """Quadratic on the lateral wall and the two caps, in the local frame."""
    ol, dl = _local_rays(o, d, pos, quat)
    a = dl[..., 0] ** 2 + dl[..., 1] ** 2
    b = ol[..., 0] * dl[..., 0] + ol[..., 1] * dl[..., 1]
    c = ol[..., 0] ** 2 + ol[..., 1] ** 2 - radius * radius
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = (-b - sq) / torch.where(a.abs() < 1e-12, 1e-12, a)
    z_side = ol[..., 2] + t_side * dl[..., 2]
    side_ok = (disc >= 0.0) & (t_side > 1e-4) & (z_side.abs() <= half_len)
    t_side = torch.where(side_ok, t_side, _BIG)
    # caps at z = +/- half_len
    dz = _tiny(dl[..., 2])
    t_cap = None
    for zc in (half_len, -half_len):
        t = (zc - ol[..., 2]) / dz
        x = ol[..., 0] + t * dl[..., 0]
        y = ol[..., 1] + t * dl[..., 1]
        t = torch.where((t > 1e-4) & (x * x + y * y <= radius * radius), t, _BIG)
        t_cap = t if t_cap is None else torch.minimum(t_cap, t)
    t = torch.minimum(t_side, t_cap)
    h = ol + t[..., None] * dl
    zero = torch.zeros_like(h[..., 0])
    n_side = torch.stack([h[..., 0] / radius, h[..., 1] / radius, zero], dim=-1)
    n_cap = torch.stack([zero, zero, torch.sign(h[..., 2])], dim=-1)
    n_local = torch.where((t_side <= t_cap)[..., None], n_side, n_cap)
    return t, rot.quat_rotate(quat[:, None, :], n_local)


def _look_at_rays(pos, target, up, fov_deg, width, height):
    """Static (H*W, 3) unit ray directions and the camera origin."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    dn = np.cross(right, fwd)  # image down = -true up
    half_w = np.tan(np.radians(fov_deg) / 2.0)
    half_h = half_w * height / width
    xs = np.linspace(-half_w, half_w, width)
    ys = np.linspace(-half_h, half_h, height)
    px, py = np.meshgrid(xs, ys)  # (H, W)
    dirs = (fwd[None, None] + px[..., None] * right[None, None]
            - py[..., None] * dn[None, None])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pos.astype(np.float32), dirs.reshape(-1, 3).astype(np.float32)


# deterministic per-actor palette (sky handled separately)
_PALETTE = np.asarray([
    [0.80, 0.45, 0.25], [0.30, 0.55, 0.85], [0.20, 0.65, 0.35],
    [0.90, 0.80, 0.25], [0.70, 0.35, 0.70], [0.45, 0.75, 0.75],
], np.float32)
_SKY = np.asarray([0.55, 0.70, 0.90], np.float32)
_GROUND = np.asarray([0.42, 0.42, 0.40], np.float32)
_LIGHT = np.asarray([0.35, 0.25, 0.90], np.float32) / np.linalg.norm([0.35, 0.25, 0.90])


class Camera:
    """Fixed pinhole camera over a compiled scene, on ``device`` (the card
    unless asked otherwise; the env passes its own), in float32.

    ``render(sim, state)`` -> dict(depth (B,H,W), rgb (B,H,W,3) in [0,1],
    seg (B,H,W) int32 actor index, -2 = ground plane, -1 = sky).
    """

    def __init__(self, scene, pos=(4.2, -2.6, 2.2), target=(1.4, 0.0, 0.9),
                 up=(0.0, 0.0, 1.0), fov_deg=70.0, width=96, height=72, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for but no CUDA device is available")
        self.scene = scene
        self.width, self.height = int(width), int(height)
        self.table = T = _build_geom_table(scene)
        origin, rays = _look_at_rays(pos, target, up, fov_deg, self.width, self.height)
        t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), dtype=dt,
                                                        device=self.device)
        self.origin, self.rays = t(origin), t(rays)
        self.has_plane = scene.spec.plane is not None
        self._body = t(T.body, torch.long)
        self._local_pos, self._local_quat = t(T.local_pos), t(T.local_quat)
        self._half = [t(s) for s in T.size]
        seg_ids = list(T.actor) + ([-2] if self.has_plane else [])
        colors = [_PALETTE[T.actor % len(_PALETTE)]] + ([_GROUND[None]] if self.has_plane else [])
        self._seg_ids = t(seg_ids, torch.int32)
        self._colors = t(np.concatenate(colors, axis=0))
        self._light, self._sky = t(_LIGHT), t(_SKY)

    def nearest_hits(self, rb_states):
        """The nearest hit of every ray of every env over the geoms and the
        plane, from rigid-body states (B, num_bodies, 13): (t (B, P), world
        normal (B, P, 3), geom index (B, P); index G is the plane, t 1e9 a
        miss)."""
        T, o, d = self.table, self.origin, self.rays
        B, P = rb_states.shape[0], d.shape[0]
        body = rb_states.float()[:, self._body]      # (B, G, 13)
        gpos = body[..., 0:3] + rot.quat_rotate(body[..., 3:7],
                                                 self._local_pos.expand(B, -1, -1))
        gquat = rot.quat_mul(body[..., 3:7], self._local_quat)

        best_t = torch.full((B, P), _BIG, dtype=torch.float32, device=self.device)
        best_n = torch.zeros((B, P, 3), dtype=torch.float32, device=self.device)
        best_g = torch.zeros((B, P), dtype=torch.long, device=self.device)

        def keep(gi, t, n):
            nearer = t < best_t
            best_t.copy_(torch.where(nearer, t, best_t))
            best_n.copy_(torch.where(nearer[..., None], n, best_n))
            best_g.masked_fill_(nearer, gi)

        for gi in range(len(T.kind)):
            kind, size = int(T.kind[gi]), T.size[gi]
            if kind == U.GEOM_SPHERE:
                t, n = _ray_sphere(o, d, gpos[:, gi], float(size[0]))
            elif kind == U.GEOM_BOX:
                t, n = _ray_box(o, d, gpos[:, gi], gquat[:, gi], self._half[gi])
            else:
                t, n = _ray_cylinder(o, d, gpos[:, gi], gquat[:, gi],
                                     float(size[0]), float(size[1]))
            keep(gi, t, n)
        if self.has_plane:
            t_pl = -o[2] / torch.where(d[:, 2].abs() < 1e-9, -1e-9, d[:, 2])
            t_pl = torch.where(t_pl > 1e-4, t_pl, _BIG).expand(B, P)
            keep(len(T.kind), t_pl, torch.tensor([0.0, 0.0, 1.0], device=self.device))
        return best_t, best_n, best_g

    def render_bodies(self, rb_states):
        """Render from rigid-body states (B, num_bodies, 13)."""
        best_t, best_n, best_g = self.nearest_hits(rb_states)
        B = rb_states.shape[0]
        hit = best_t < _BIG * 0.5
        seg = torch.where(hit, self._seg_ids[best_g], -1)
        # Lambert shading from the analytic surface normals
        diff = torch.clamp(torch.sum(best_n * self._light, dim=-1), 0.0, 1.0)
        shade = 0.35 + 0.65 * diff
        rgb = torch.where(hit[..., None], self._colors[best_g] * shade[..., None], self._sky)
        H, W = self.height, self.width
        return dict(depth=torch.where(hit, best_t, torch.inf).reshape(B, H, W),
                    rgb=rgb.reshape(B, H, W, 3),
                    seg=seg.to(torch.int32).reshape(B, H, W))

    @torch.no_grad()
    def render(self, sim, state):
        """Render every env: ``sim`` is the Simulator (the body states' FK),
        ``state`` the batched SimState."""
        return self.render_bodies(sim.rigid_body_states(state))
