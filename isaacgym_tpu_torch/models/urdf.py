"""URDF parser: the asset loader for the port.

A copy of ``isaacgym_tpu/models/urdf.py`` (numpy + ElementTree only), kept
in the port so that ``isaacgym_tpu_torch`` never imports the JAX package.
Assets are parsed once at build time into plain Python structures, then
compiled by :mod:`isaacgym_tpu_torch.models.kinematics` into static arrays.

Supports the URDF subset the task family needs: tree-structured ``<link>`` /
``<joint>`` with revolute/continuous/prismatic/fixed joints, inertial blocks,
and primitive collision geometry (sphere / box / cylinder).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

JOINT_FIXED = 0
JOINT_REVOLUTE = 1
JOINT_PRISMATIC = 2

GEOM_SPHERE = 0
GEOM_BOX = 1
GEOM_CYLINDER = 2


@dataclass
class Geom:
    """A collision primitive attached to a link."""
    kind: int                      # GEOM_*
    xyz: np.ndarray                # offset in link frame
    rpy: np.ndarray
    size: np.ndarray               # sphere: (r,0,0); box: half-extents; cylinder: (r, half_len, 0)


@dataclass
class Link:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))  # about COM, link frame
    geoms: List[Geom] = field(default_factory=list)


@dataclass
class Joint:
    name: str
    kind: int                      # JOINT_*
    parent: str
    child: str
    xyz: np.ndarray                # parent link frame -> joint/child frame
    rpy: np.ndarray
    axis: np.ndarray
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    damping: float = 0.0
    friction: float = 0.0
    armature: float = 0.0


@dataclass
class UrdfModel:
    name: str
    links: Dict[str, Link]
    joints: List[Joint]            # document order (defines DOF ordering)
    root: str

    @property
    def link_names(self) -> List[str]:
        """Link names in depth-first traversal order from the root, visiting
        children in joint document order (Isaac Gym's asset body ordering)."""
        children: Dict[str, List[str]] = {}
        for j in self.joints:
            children.setdefault(j.parent, []).append(j.child)
        order: List[str] = []

        def visit(name: str) -> None:
            order.append(name)
            for c in children.get(name, []):
                visit(c)

        visit(self.root)
        return order


def _floats(text: Optional[str], n: int, default: float = 0.0) -> np.ndarray:
    if not text:
        return np.full(n, default, dtype=np.float64)
    vals = [float(v) for v in text.replace(",", " ").split()]
    return np.asarray(vals, dtype=np.float64)


def rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy (extrinsic x-y-z / intrinsic z-y-x) -> rotation matrix."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def parse_urdf(source: str, *, from_string: bool = False) -> UrdfModel:
    """Parse a URDF file (or XML string) into a :class:`UrdfModel`."""
    root_el = ET.fromstring(source) if from_string else ET.parse(source).getroot()
    if root_el.tag != "robot":
        raise ValueError(f"not a URDF: root tag {root_el.tag!r}")

    links: Dict[str, Link] = {}
    for link_el in root_el.findall("link"):
        link = Link(name=link_el.attrib["name"])
        inertial = link_el.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            link.mass = float(mass_el.attrib.get("value", 0.0)) if mass_el is not None else 0.0
            origin = inertial.find("origin")
            if origin is not None:
                link.com = _floats(origin.attrib.get("xyz"), 3)
            in_el = inertial.find("inertia")
            if in_el is not None:
                a = in_el.attrib
                ixx = float(a.get("ixx", 0)); iyy = float(a.get("iyy", 0)); izz = float(a.get("izz", 0))
                ixy = float(a.get("ixy", 0)); ixz = float(a.get("ixz", 0)); iyz = float(a.get("iyz", 0))
                link.inertia = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        for col_el in link_el.findall("collision"):
            geom_el = col_el.find("geometry")
            if geom_el is None:
                continue
            origin = col_el.find("origin")
            xyz = _floats(origin.attrib.get("xyz"), 3) if origin is not None else np.zeros(3)
            rpy = _floats(origin.attrib.get("rpy"), 3) if origin is not None else np.zeros(3)
            sphere = geom_el.find("sphere")
            box = geom_el.find("box")
            cyl = geom_el.find("cylinder")
            if sphere is not None:
                size = np.array([float(sphere.attrib["radius"]), 0.0, 0.0])
                link.geoms.append(Geom(GEOM_SPHERE, xyz, rpy, size))
            elif box is not None:
                full = _floats(box.attrib["size"], 3)
                link.geoms.append(Geom(GEOM_BOX, xyz, rpy, full / 2.0))
            elif cyl is not None:
                size = np.array([float(cyl.attrib["radius"]), float(cyl.attrib["length"]) / 2.0, 0.0])
                link.geoms.append(Geom(GEOM_CYLINDER, xyz, rpy, size))
            # mesh collision: skipped (reference tasks exercise primitives only)
        links[link.name] = link

    kind_map = {
        "fixed": JOINT_FIXED,
        "revolute": JOINT_REVOLUTE,
        "continuous": JOINT_REVOLUTE,
        "prismatic": JOINT_PRISMATIC,
    }
    joints: List[Joint] = []
    for joint_el in root_el.findall("joint"):
        kind_str = joint_el.attrib.get("type", "fixed")
        if kind_str not in kind_map:
            raise ValueError(f"unsupported joint type {kind_str!r}")
        origin = joint_el.find("origin")
        axis_el = joint_el.find("axis")
        limit_el = joint_el.find("limit")
        dyn_el = joint_el.find("dynamics")
        parent_el = joint_el.find("parent")
        child_el = joint_el.find("child")
        if parent_el is None or child_el is None:
            raise ValueError(f"joint {joint_el.attrib.get('name')} missing parent/child")
        j = Joint(
            name=joint_el.attrib["name"],
            kind=kind_map[kind_str],
            parent=parent_el.attrib["link"],
            child=child_el.attrib["link"],
            xyz=_floats(origin.attrib.get("xyz"), 3) if origin is not None else np.zeros(3),
            rpy=_floats(origin.attrib.get("rpy"), 3) if origin is not None else np.zeros(3),
            axis=_floats(axis_el.attrib.get("xyz"), 3) if axis_el is not None else np.array([1.0, 0, 0]),
        )
        if limit_el is not None:
            j.lower = float(limit_el.attrib.get("lower", 0.0))
            j.upper = float(limit_el.attrib.get("upper", 0.0))
            j.effort = float(limit_el.attrib.get("effort", 0.0))
            j.velocity = float(limit_el.attrib.get("velocity", 0.0))
        elif kind_str == "continuous":
            j.lower, j.upper = -math.pi, math.pi
        if dyn_el is not None:
            j.damping = float(dyn_el.attrib.get("damping", 0.0))
            j.friction = float(dyn_el.attrib.get("friction", 0.0))
            j.armature = float(dyn_el.attrib.get("armature", 0.0))
        joints.append(j)

    children = {j.child for j in joints}
    roots = [name for name in links if name not in children]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, found {roots}")

    return UrdfModel(name=root_el.attrib.get("name", "robot"), links=links, joints=joints, root=roots[0])
