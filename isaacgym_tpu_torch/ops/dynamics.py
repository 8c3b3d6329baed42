"""Articulation constants for the port: ``build_articulation`` in numpy.

A copy of the numpy half of ``isaacgym_tpu/ops/dynamics.py`` (``:61``): the
ancestor mask, composite link masses, COMs and inertias about the COM, and
the armature that the fused-substep kernel and its plain version read. The
dynamics themselves live in :mod:`isaacgym_tpu_torch.ops.fused_substep`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.kinematics import KinematicTree


@dataclass(frozen=True)
class ArticulationModel:
    """Static (compile-time) dynamics view of a KinematicTree."""

    tree: KinematicTree
    floating: bool
    nv: int                          # generalized velocity dimension
    ancestor_mask: np.ndarray        # (nl, nd) link l moved by joint dof d
    link_mass: np.ndarray            # (nl,)
    link_com: np.ndarray             # (nl,3) composite com in link body frame
    link_inertia_com: np.ndarray     # (nl,3,3) composite inertia about com, body frame
    armature: np.ndarray             # (nv,)
    is_revolute: np.ndarray          # (nd,) 1.0 for revolute, 0.0 prismatic

    @property
    def nd(self) -> int:
        return self.tree.n_dof

    @property
    def nl(self) -> int:
        # one articulated link per dof, plus the base composite when floating
        return self.tree.n_dof + (1 if self.floating else 0)


def build_articulation(tree: KinematicTree) -> ArticulationModel:
    nd = tree.n_dof
    # ancestor-or-self mask over the dof tree
    mask = np.zeros((nd, nd), dtype=np.float32)
    for l in range(nd):
        a = l
        while a != -1:
            mask[l, a] = 1.0
            a = int(tree.dof_parent[a])
    # composite inertia about composite com (stored about body origin)
    m = tree.comp_mass
    c = tree.comp_com
    I_com = np.zeros_like(tree.comp_inertia)
    for l in range(nd):
        cc = c[l]
        shift = m[l] * ((cc @ cc) * np.eye(3) - np.outer(cc, cc))
        I_com[l] = tree.comp_inertia[l] - shift
    floating = tree.floating_base
    nv = nd + (6 if floating else 0)
    armature = np.concatenate([np.zeros(6, np.float32), tree.armature]) if floating else tree.armature
    link_mass = m.astype(np.float32)
    link_com = c.astype(np.float32)
    link_inertia = I_com.astype(np.float32)
    if floating:
        # the base's welded composite is a link of its own, moved only by the
        # 6 base columns (zero row in the joint ancestor mask)
        bm = tree.base_comp_mass
        bc = tree.base_comp_com
        shift = bm * ((bc @ bc) * np.eye(3) - np.outer(bc, bc))
        b_inertia = tree.base_comp_inertia - shift
        mask = np.concatenate([mask, np.zeros((1, nd), np.float32)], axis=0)
        link_mass = np.concatenate([link_mass, np.asarray([bm], np.float32)])
        link_com = np.concatenate([link_com, bc[None].astype(np.float32)], axis=0)
        link_inertia = np.concatenate([link_inertia, b_inertia[None].astype(np.float32)], axis=0)
    return ArticulationModel(
        tree=tree,
        floating=floating,
        nv=nv,
        ancestor_mask=mask,
        link_mass=link_mass,
        link_com=link_com,
        link_inertia_com=link_inertia,
        armature=armature.astype(np.float32),
        is_revolute=(tree.dof_type == U.JOINT_REVOLUTE).astype(np.float32),
    )
