"""Heightfield terrain: contact sampling, the heightmap observation, the
trimesh conversion and a seeded generator.

Counterpart of ``isaacgym_tpu/models/terrain.py``: the heightfield is the
collision representation (a bilinear height and a finite-difference normal,
no mesh), loaded from a reference-format heightmap (``Heightfield.from_raw``,
the transposed npy with ``horizontal_scale``, ``vertical_scale`` and the
``transform_x/y`` offsets of the reference's ``_create_trimesh``); the
heading-local heightmap observation block; ``convert_heightfield_to_trimesh``
for export. ``Heightfield.sample`` and ``normal`` take torch tensors of any
leading shape; the field's heights move to the query's device on first use.

``rough_heightfield_raw`` makes a field from a seed for the terrain cell of
``chip_smoke.py`` and the tests: a sum of random-phase sinusoidal bumps
(wavelengths 0.3-2 m) plus uniform per-cell noise, quantized to integers as
a reference heightmap is, so the relief is a few centimetres at the G1's
vertical scale.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from isaacgym_tpu_torch.utils import rotations as rot


def convert_heightfield_to_trimesh(height_field_raw: np.ndarray, horizontal_scale: float,
                                   vertical_scale: float, slope_threshold: float = None
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Heightfield grid -> (vertices (N,3) float32, triangles (M,3) uint32),
    with the slope-threshold correction that turns steep slopes into
    near-vertical walls (``isaacgym.terrain_utils``' conversion)."""
    hf = np.asarray(height_field_raw, dtype=np.float64)
    num_rows, num_cols = hf.shape
    y = np.linspace(0, (num_cols - 1) * horizontal_scale, num_cols)
    x = np.linspace(0, (num_rows - 1) * horizontal_scale, num_rows)
    yy, xx = np.meshgrid(y, x)
    if slope_threshold is not None:
        thr = slope_threshold * horizontal_scale / vertical_scale
        move_x = np.zeros((num_rows, num_cols))
        move_y = np.zeros((num_rows, num_cols))
        move_corners = np.zeros((num_rows, num_cols))
        move_x[: num_rows - 1, :] += hf[1:, :] - hf[: num_rows - 1, :] > thr
        move_x[1:, :] -= hf[: num_rows - 1, :] - hf[1:, :] > thr
        move_y[:, : num_cols - 1] += hf[:, 1:] - hf[:, : num_cols - 1] > thr
        move_y[:, 1:] -= hf[:, : num_cols - 1] - hf[:, 1:] > thr
        move_corners[: num_rows - 1, : num_cols - 1] += (
            hf[1:, 1:] - hf[: num_rows - 1, : num_cols - 1] > thr)
        move_corners[1:, 1:] -= hf[: num_rows - 1, : num_cols - 1] - hf[1:, 1:] > thr
        xx += (move_x + move_corners * (move_x == 0)) * horizontal_scale
        yy += (move_y + move_corners * (move_y == 0)) * horizontal_scale
    vertices = np.zeros((num_rows * num_cols, 3), dtype=np.float32)
    vertices[:, 0] = xx.flatten()
    vertices[:, 1] = yy.flatten()
    vertices[:, 2] = hf.flatten() * vertical_scale
    triangles = np.zeros((2 * (num_rows - 1) * (num_cols - 1), 3), dtype=np.uint32)
    for i in range(num_rows - 1):
        ind0 = np.arange(0, num_cols - 1) + i * num_cols
        ind1, ind2 = ind0 + 1, ind0 + num_cols
        ind3 = ind2 + 1
        start = 2 * i * (num_cols - 1)
        stop = start + 2 * (num_cols - 1)
        triangles[start:stop:2, 0] = ind0
        triangles[start:stop:2, 1] = ind3
        triangles[start:stop:2, 2] = ind1
        triangles[start + 1:stop:2, 0] = ind0
        triangles[start + 1:stop:2, 1] = ind2
        triangles[start + 1:stop:2, 2] = ind3
    return vertices, triangles


class Heightfield:
    """Static heightfield: ``heights`` (R, C) float32 world z, ``origin`` (2,)
    world x, y of cell (0, 0), ``scale`` the cell size in metres."""

    def __init__(self, heights, origin, scale: float):
        self.heights = np.asarray(heights, np.float32)
        self.origin = np.asarray(origin, np.float32)
        self.scale = float(scale)
        self._on = {}   # (device, dtype) -> (heights, origin) tensors

    @staticmethod
    def from_raw(raw: np.ndarray, horizontal_scale: float, vertical_scale: float,
                 transform_x: float = 0.0, transform_y: float = 0.0) -> "Heightfield":
        """From a reference-format heightmap (already transposed) and its
        scales and offsets."""
        return Heightfield(heights=np.asarray(raw, np.float32) * vertical_scale,
                           origin=np.asarray([transform_x, transform_y], np.float32),
                           scale=float(horizontal_scale))

    def _tensors(self, like: torch.Tensor):
        key = (like.device, like.dtype)
        if key not in self._on:
            self._on[key] = (torch.as_tensor(self.heights, device=like.device).to(like.dtype),
                             torch.as_tensor(self.origin, device=like.device).to(like.dtype))
        return self._on[key]

    def sample(self, xy):
        """Bilinear height at world (..., 2) positions, clamped to the field
        (``gx`` in [0, R - 1.001])."""
        H, origin = self._tensors(xy)
        R, Cc = self.heights.shape
        g = (xy - origin) / self.scale
        gx = torch.clamp(g[..., 0], 0.0, R - 1.001)
        gy = torch.clamp(g[..., 1], 0.0, Cc - 1.001)
        x0 = torch.floor(gx).to(torch.int64)
        y0 = torch.floor(gy).to(torch.int64)
        fx, fy = gx - x0, gy - y0
        flat = H.reshape(-1)
        at = lambda i, j: flat[i * Cc + j]
        return (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
                + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)

    def normal(self, xy, eps: float = None):
        """Central-difference surface normal at world (..., 2) positions, over
        one cell unless ``eps`` says otherwise."""
        e = eps or self.scale
        ex = xy.new_tensor([e, 0.0])
        ey = xy.new_tensor([0.0, e])
        dzdx = (self.sample(xy + ex) - self.sample(xy - ex)) / (2 * e)
        dzdy = (self.sample(xy + ey) - self.sample(xy - ey)) / (2 * e)
        n = torch.stack([-dzdx, -dzdy, torch.ones_like(dzdx)], dim=-1)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def compute_heightmap_observations(body_states, meshgrid, field: Heightfield,
                                   height_offset: float = 0.9):
    """(B, G) terrain heights on the heading-local grid around the root (row
    0 of ``body_states`` (B, J, 13)), minus the root height, plus
    ``height_offset``."""
    root_pos = body_states[:, 0, 0:3]
    heading = rot.calc_heading_quat(body_states[:, 0, 3:7])
    G = meshgrid.shape[0]
    pts = rot.quat_rotate(heading[:, None].expand(-1, G, 4),
                          meshgrid.to(root_pos)[None].expand(root_pos.shape[0], G, 3))
    pts = pts + root_pos[:, None]
    return field.sample(pts[..., :2]) - root_pos[:, 2:3] + height_offset


def make_meshgrid(x_range: float = 0.6, y_range: float = 0.6, x_split: int = 15,
                  y_split: int = 15) -> torch.Tensor:
    """The (x_split * y_split, 3) sample grid (reference ``_get_meshgrid``)."""
    xs = np.linspace(-x_range, x_range, x_split)
    ys = np.linspace(-y_range, y_range, y_split)
    x, y = np.meshgrid(xs, ys, indexing="xy")
    return torch.as_tensor(np.stack([x.flatten(), y.flatten(), np.zeros_like(x.flatten())],
                                    axis=1), dtype=torch.float32)


#: the seeded field's relief: ``ROUGH_N_WAVES`` sinusoids of total amplitude
#: ``ROUGH_BUMP_RAW`` plus uniform noise of ``ROUGH_NOISE_RAW`` per cell, in
#: raw units quantized to ``ROUGH_UNIT_RAW``
ROUGH_N_WAVES = 12
ROUGH_BUMP_RAW = 0.04
ROUGH_NOISE_RAW = 0.002
ROUGH_UNIT_RAW = 0.001


def rough_heightfield_raw(seed: int, rows: int, cols: int,
                          horizontal_scale: float = 0.015) -> np.ndarray:
    """A (rows, cols) reference-format heightmap from ``seed``:
    ``ROUGH_N_WAVES`` sinusoids of random direction, phase and wavelength in
    [0.3, 2] m, of total amplitude ``ROUGH_BUMP_RAW``, plus uniform noise of
    ``ROUGH_NOISE_RAW``, quantized to integer multiples of ``ROUGH_UNIT_RAW``
    and stored as float32 raw values (world height = raw x the vertical
    scale)."""
    rng = np.random.RandomState(seed)
    x = np.arange(rows)[:, None] * horizontal_scale
    y = np.arange(cols)[None, :] * horizontal_scale
    h = np.zeros((rows, cols))
    for _ in range(ROUGH_N_WAVES):
        ang, lam, ph = rng.uniform(0, np.pi), rng.uniform(0.3, 2.0), rng.uniform(0, 2 * np.pi)
        h += np.sin(2 * np.pi * (np.cos(ang) * x + np.sin(ang) * y) / lam + ph)
    h *= ROUGH_BUMP_RAW / np.sqrt(ROUGH_N_WAVES / 2.0)
    h += rng.uniform(-ROUGH_NOISE_RAW, ROUGH_NOISE_RAW, (rows, cols))
    return (np.round(h / ROUGH_UNIT_RAW) * ROUGH_UNIT_RAW).astype(np.float32)
