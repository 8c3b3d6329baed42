"""Offline trajectory renderer: npz -> mp4 or gif.

A copy of ``isaacgym_tpu/viewer/render.py`` for the port (it imports
nothing of the JAX package): record body states with
``isaacgym_tpu_torch.viewer.trajectory`` (which embeds the compiled scene's
geom table), then

  python -m isaacgym_tpu_torch.viewer.render traj.npz out.mp4 [--env 0] [--fps 60]

draws every geom (sphere, box, cylinder) with a painter's-algorithm software
rasterizer (numpy and OpenCV) plus the recorded marker streams and a ground
grid, on the host. No GPU, no display server and no external ffmpeg are
needed; ``cv2`` (and ``PIL`` for a gif) are imported only when frames are
drawn, so the module imports where neither is installed.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

from isaacgym_tpu_torch.models import urdf as U

# geom-table row layout: [body, kind, size x3, local_pos x3, local_quat x4]
GEOM_ROW = 12


def scene_geom_table(scene) -> np.ndarray:
    """(G, 12) table of every collision geom in a CompiledScene, in the
    body frame of the env-level body each geom is welded to."""
    rows = []
    for g in scene.static_geoms:
        rows.append([g.body_start, g.kind, *np.asarray(g.size, np.float64),
                     *np.asarray(g.local_pos, np.float64),
                     *np.asarray(g.local_quat, np.float64)])
    for g in scene.art_geoms:
        slot = scene.articulations[g.art_index]
        rows.append([slot.body_start + g.body_index, g.kind,
                     *np.asarray(g.size, np.float64),
                     *np.asarray(g.local_pos, np.float64),
                     *np.asarray(g.local_quat, np.float64)])
    for fb in scene.free_bodies:
        rows.append([fb.body_start, U.GEOM_SPHERE, fb.radius, fb.radius,
                     fb.radius, 0, 0, 0, 0, 0, 0, 1.0])
    return np.asarray(rows, np.float32)


# ---------------------------------------------------------------------------
# math helpers (numpy, batch-friendly)
# ---------------------------------------------------------------------------

def _qrot(q, v):
    """Rotate v (..., 3) by quats q (..., 4 xyzw)."""
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _qmul(a, b):
    ax, ay, az, aw = np.moveaxis(np.asarray(a, np.float64), -1, 0)
    bx, by, bz, bw = np.moveaxis(np.asarray(b, np.float64), -1, 0)
    return np.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
        aw * bw - ax * bx - ay * by - az * bz,
    ], axis=-1)


class _Camera:
    def __init__(self, eye, target, width, height, fov_deg=50.0):
        self.eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - self.eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        self.R = np.stack([right, up, fwd])      # world -> cam rows
        self.w, self.h = width, height
        self.f = 0.5 * height / np.tan(np.radians(fov_deg) / 2)

    def project(self, pts):
        """(N,3) world -> (N,2) pixel + (N,) depth (cam z, >0 in front)."""
        c = (np.asarray(pts, np.float64) - self.eye) @ self.R.T
        z = np.maximum(c[:, 2], 1e-3)
        x = self.w / 2 + self.f * c[:, 0] / z
        y = self.h / 2 - self.f * c[:, 1] / z
        return np.stack([x, y], -1), c[:, 2]


def viewer_camera_look_at(camera: "_Camera", eye, target) -> "_Camera":
    """Reference ``gym.viewer_camera_look_at(viewer, env, eye, target)``
    (joint_monkey2_new.py:223): returns a camera re-aimed at ``target`` from
    ``eye`` keeping the image size/FOV."""
    fov = np.degrees(2 * np.arctan(0.5 * camera.h / camera.f))
    return _Camera(eye, target, camera.w, camera.h, fov_deg=fov)


def get_viewer_camera_transform(camera: "_Camera"):
    """Reference ``gym.get_viewer_camera_transform`` → (position (3,),
    orientation quat (4,) xyzw) of the camera in world frame, in the
    gymapi camera convention: the camera looks along the transform's +x,
    with +z up (so columns of the rotation are [fwd, left, up])."""
    right, up, fwd = camera.R  # world->cam rows (left-handed screen basis)
    m = np.stack([fwd, -right, up], axis=1)  # cam->world, right-handed
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        q[3] = (m[k, j] - m[j, k]) / s
    return camera.eye.copy(), q / np.linalg.norm(q)


_BOX_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)], np.float64)
_BOX_FACES = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
              (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
_LIGHT = np.array([0.4, -0.3, 0.85])
_LIGHT_DIR = _LIGHT / np.linalg.norm(_LIGHT)


def _color_for(body: int, kind: int):
    palette = [(96, 130, 222), (222, 140, 80), (120, 190, 120), (200, 110, 180),
               (110, 200, 210), (230, 200, 90), (160, 120, 220), (150, 150, 150)]
    return palette[int(body) % len(palette)]


def _shade(color, normal):
    lam = 0.45 + 0.55 * max(float(np.dot(normal, _LIGHT_DIR)), 0.0)
    return tuple(int(min(255, c * lam)) for c in color)


def render_frames(body_states: np.ndarray, geoms: np.ndarray,
                  markers: Optional[np.ndarray] = None,
                  size: Tuple[int, int] = (960, 540),
                  eye=(2.8, -2.6, 1.9), target=(0.0, 0.0, 0.8),
                  lines: Optional[np.ndarray] = None,
                  line_colors: Optional[np.ndarray] = None):
    """Yield BGR uint8 frames for body_states (T, nb, 13) + geom table."""
    import cv2

    W, H = size
    cam = _Camera(eye, target, W, H)
    n_cyl = 10
    ang = np.linspace(0, 2 * np.pi, n_cyl, endpoint=False)
    cyl_ring = np.stack([np.cos(ang), np.sin(ang)], -1)

    # ground grid
    grid_lines = []
    for v in np.arange(-3.0, 3.01, 0.5):
        grid_lines.append([[v, -3, 0], [v, 3, 0]])
        grid_lines.append([[-3, v, 0], [3, v, 0]])
    grid_lines = np.asarray(grid_lines)

    T = body_states.shape[0]
    for t in range(T):
        frame = np.full((H, W, 3), 245, np.uint8)
        # grid
        for a, b in grid_lines:
            (p, z) = cam.project(np.stack([a, b]))
            if (z > 0.05).all():
                cv2.line(frame, tuple(p[0].astype(int)), tuple(p[1].astype(int)),
                         (210, 210, 210), 1, cv2.LINE_AA)

        prims = []  # (depth, draw_fn closure args)
        bs = body_states[t]
        for row in geoms:
            body, kind = int(row[0]), int(row[1])
            sizev, lpos, lquat = row[2:5], row[5:8], row[8:12]
            bpos, bquat = bs[body, 0:3], bs[body, 3:7]
            gpos = bpos + _qrot(bquat, lpos)
            gquat = _qmul(bquat, lquat)
            color = _color_for(body, kind)
            if kind == U.GEOM_SPHERE:
                (p, z) = cam.project(gpos[None])
                if z[0] <= 0.05:
                    continue
                r_px = max(int(cam.f * sizev[0] / z[0]), 1)
                prims.append((z[0], "circle", (tuple(p[0].astype(int)), r_px,
                                               _shade(color, [0, 0, 1]))))
            else:
                if kind == U.GEOM_BOX:
                    corners = gpos + _qrot(gquat[None], _BOX_CORNERS * sizev)
                    faces = _BOX_FACES
                else:  # cylinder: n-gon prism, axis z, size = (radius, half_len)
                    ring = cyl_ring * sizev[0]
                    locs = np.concatenate([
                        np.concatenate([ring, np.full((n_cyl, 1), -sizev[1])], -1),
                        np.concatenate([ring, np.full((n_cyl, 1), sizev[1])], -1)])
                    corners = gpos + _qrot(gquat[None], locs)
                    faces = ([tuple(range(n_cyl))[::-1], tuple(range(n_cyl, 2 * n_cyl))]
                             + [(i, (i + 1) % n_cyl, n_cyl + (i + 1) % n_cyl, n_cyl + i)
                                for i in range(n_cyl)])
                (p, z) = cam.project(corners)
                if (z <= 0.05).any():
                    continue
                for f in faces:
                    idx = np.asarray(f)
                    a = corners[idx[1]] - corners[idx[0]]
                    b = corners[idx[-1]] - corners[idx[0]]
                    nrm = np.cross(a, b)
                    nn = np.linalg.norm(nrm)
                    if nn < 1e-12:
                        continue
                    nrm /= nn
                    if np.dot(nrm, cam.eye - corners[idx[0]]) <= 0:
                        continue  # back face
                    prims.append((float(z[idx].mean()), "poly",
                                  (p[idx].astype(np.int32), _shade(color, nrm))))

        for depth, kindp, args in sorted(prims, key=lambda x: -x[0]):
            if kindp == "circle":
                center, r_px, col = args
                cv2.circle(frame, center, r_px, col, -1, cv2.LINE_AA)
                cv2.circle(frame, center, r_px, tuple(int(c * 0.6) for c in col),
                           1, cv2.LINE_AA)
            else:
                pts, col = args
                cv2.fillPoly(frame, [pts], col, cv2.LINE_AA)

        if markers is not None and t < len(markers):
            m = np.asarray(markers[t], np.float64).reshape(-1, 3)
            (p, z) = cam.project(m)
            for (px, py), zz in zip(p, z):
                if zz > 0.05:
                    cv2.drawMarker(frame, (int(px), int(py)), (30, 30, 200),
                                   cv2.MARKER_CROSS, 8, 2)
        if lines is not None and t < len(lines):
            # NaN rows are padding (ragged per-frame counts)
            for i, seg in enumerate(np.asarray(lines[t], np.float64)):
                if not np.isfinite(seg).all():
                    continue
                (p, z) = cam.project(seg)
                if (z > 0.05).all():
                    rgb = (line_colors[t, i] if line_colors is not None
                           else np.asarray([1.0, 0.0, 0.0]))
                    bgr = tuple(int(255 * c) for c in rgb[::-1])
                    cv2.line(frame, tuple(p[0].astype(int)),
                             tuple(p[1].astype(int)), bgr, 2, cv2.LINE_AA)
        yield frame


def render_trajectory(npz_path: str, out_path: str, env: int = 0,
                      fps: float = 60.0, size: Tuple[int, int] = (960, 540),
                      eye=(2.8, -2.6, 1.9), target=(0.0, 0.0, 0.8)) -> str:
    """Render a recorded trajectory npz to mp4 (or .gif if requested)."""
    import cv2

    data = dict(np.load(npz_path, allow_pickle=False))
    bs = data["body_states"]          # (T, k, nb, 13)
    if bs.ndim == 4:
        bs = bs[:, env]
    geoms = data.get("geoms")
    if geoms is None:
        # legacy npz without a geom table: draw each body as a small sphere
        nb = bs.shape[1]
        geoms = np.asarray([[b, U.GEOM_SPHERE, 0.03, 0.03, 0.03,
                             0, 0, 0, 0, 0, 0, 1.0] for b in range(nb)], np.float32)
    markers = data.get("markers")
    if markers is not None and markers.ndim == 4:
        markers = markers[:, env]

    frames = render_frames(bs, geoms, markers, size=size, eye=eye, target=target,
                           lines=data.get("lines"),
                           line_colors=data.get("line_colors"))
    if out_path.endswith(".gif"):
        from PIL import Image
        imgs = [Image.fromarray(f[:, :, ::-1]) for f in frames]
        imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return out_path
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, size)
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {out_path}")
    n = 0
    for f in frames:
        writer.write(f)
        n += 1
    writer.release()
    if n == 0 or not os.path.getsize(out_path):
        raise RuntimeError("no frames rendered")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz")
    ap.add_argument("out")
    ap.add_argument("--env", type=int, default=0)
    ap.add_argument("--fps", type=float, default=60.0)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--eye", type=float, nargs=3, default=(2.8, -2.6, 1.9))
    ap.add_argument("--target", type=float, nargs=3, default=(0.0, 0.0, 0.8))
    args = ap.parse_args(argv)
    out = render_trajectory(args.npz, args.out, env=args.env, fps=args.fps,
                            size=(args.width, args.height), eye=args.eye,
                            target=args.target)
    print(out)


if __name__ == "__main__":
    main()
