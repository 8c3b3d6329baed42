"""MJCF (MuJoCo XML) asset parser (SURVEY.md §2 N3: ``load_asset`` handles
URDF and MJCF; the reference keeps its G1 assets under ``assets/mjcf/``).

Parses the MJCF subset needed for articulated robots into the same
:class:`isaacgym_tpu_torch.models.urdf.UrdfModel` the URDF path produces, so the
kinematic-tree compiler is format-agnostic:

  * nested ``<body>`` tree with pos / quat / euler frames,
  * one ``<joint>`` per body: hinge -> revolute, slide -> prismatic,
    ``<freejoint>``/none -> welded (floating bases are a load_asset flag),
  * ``<inertial>`` (pos, mass, diaginertia / fullinertia),
  * ``<geom>`` sphere / box / cylinder / capsule(approximated as cylinder),
  * ``<default>`` class inheritance for joint/geom attributes (single level).

Joints anchored away from the body origin (``<joint pos != 0>``) are
supported by shifting the anchor into the joint frame the same way MuJoCo's
own compiler does for reduced coordinates.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from isaacgym_tpu_torch.models import urdf as U


def _floats(text: Optional[str], n: int, default: float = 0.0) -> np.ndarray:
    if not text:
        return np.full(n, default, dtype=np.float64)
    vals = [float(v) for v in text.split()]
    out = np.full(n, default, dtype=np.float64)
    out[: len(vals)] = vals[:n]
    return out


def _quat_wxyz_to_xyzw(q):
    return np.asarray([q[1], q[2], q[3], q[0]], dtype=np.float64)


def _quat_to_rpy(q_xyzw) -> np.ndarray:
    """xyzw quaternion -> URDF rpy (extrinsic XYZ)."""
    x, y, z, w = q_xyzw
    sinr = 2 * (w * x + y * z)
    cosr = 1 - 2 * (x * x + y * y)
    roll = math.atan2(sinr, cosr)
    sinp = 2 * (w * y - z * x)
    pitch = math.copysign(math.pi / 2, sinp) if abs(sinp) >= 1 else math.asin(sinp)
    siny = 2 * (w * z + x * y)
    cosy = 1 - 2 * (y * y + z * z)
    yaw = math.atan2(siny, cosy)
    return np.asarray([roll, pitch, yaw])


def _frame_rpy(el) -> np.ndarray:
    if el.get("quat"):
        return _quat_to_rpy(_quat_wxyz_to_xyzw(_floats(el.get("quat"), 4)))
    if el.get("euler"):
        return _floats(el.get("euler"), 3)  # MJCF default eulerseq xyz
    return np.zeros(3)


def parse_mjcf(source: str, *, from_string: bool = False) -> U.UrdfModel:
    root_el = ET.fromstring(source) if from_string else ET.parse(source).getroot()
    if root_el.tag != "mujoco":
        raise ValueError(f"not an MJCF file: root tag {root_el.tag!r}")

    # default classes for joint/geom, nested classes inherit their parent
    defaults: Dict[str, Dict[str, Dict[str, str]]] = {"": {"joint": {}, "geom": {}}}

    def collect_defaults(d, parent_cls: str) -> None:
        cls = d.get("class", parent_cls)
        entry = {k: dict(defaults.get(parent_cls, {}).get(k, {})) for k in ("joint", "geom")}
        for kind in ("joint", "geom"):
            el = d.find(kind)
            if el is not None:
                entry[kind].update(el.attrib)
        defaults[cls] = entry
        for sub in d.findall("default"):
            collect_defaults(sub, cls)

    for d in root_el.findall("default"):
        collect_defaults(d, "")

    def merged(el, kind: str) -> Dict[str, str]:
        cls = el.get("class", "")
        base = dict(defaults.get("", {}).get(kind, {}))
        base.update(defaults.get(cls, {}).get(kind, {}))
        base.update(el.attrib)
        return base

    worldbody = root_el.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF has no <worldbody>")

    links: Dict[str, U.Link] = {}
    joints: List[U.Joint] = []
    counter = [0]

    def geom_of(el) -> Optional[U.Geom]:
        a = merged(el, "geom")
        gtype = a.get("type", "sphere")
        size = _floats(a.get("size"), 3)
        xyz = _floats(a.get("pos"), 3)
        rpy = _frame_rpy(el)
        if gtype == "sphere":
            return U.Geom(U.GEOM_SPHERE, xyz, rpy, np.asarray([size[0], 0.0, 0.0]))
        if gtype == "box":
            return U.Geom(U.GEOM_BOX, xyz, rpy, size.copy())  # MJCF sizes are half-extents
        if gtype in ("cylinder", "capsule"):
            half_len = size[1]
            if a.get("fromto"):
                ft = _floats(a.get("fromto"), 6)
                p0, p1 = ft[:3], ft[3:]
                xyz = (p0 + p1) / 2
                half_len = float(np.linalg.norm(p1 - p0) / 2)
                # orientation from the segment direction
                d = (p1 - p0) / max(np.linalg.norm(p1 - p0), 1e-9)
                pitch = math.acos(max(-1.0, min(1.0, d[2])))
                yaw = math.atan2(d[1], d[0])
                rpy = np.asarray([0.0, pitch, yaw])
            return U.Geom(U.GEOM_CYLINDER, xyz, rpy, np.asarray([size[0], half_len, 0.0]))
        return None  # planes/meshes: not collision primitives we simulate

    def walk(body_el, parent_name: Optional[str]):
        name = body_el.get("name") or f"body_{counter[0]}"
        counter[0] += 1
        link = U.Link(name=name)

        inertial = body_el.find("inertial")
        if inertial is not None:
            link.mass = float(inertial.get("mass", 0.0))
            link.com = _floats(inertial.get("pos"), 3)
            if inertial.get("fullinertia"):
                fi = _floats(inertial.get("fullinertia"), 6)
                link.inertia = np.asarray([
                    [fi[0], fi[3], fi[4]],
                    [fi[3], fi[1], fi[5]],
                    [fi[4], fi[5], fi[2]],
                ])
            else:
                di = _floats(inertial.get("diaginertia"), 3)
                link.inertia = np.diag(di)
        for gel in body_el.findall("geom"):
            g = geom_of(gel)
            if g is not None:
                link.geoms.append(g)
        links[name] = link

        if parent_name is not None:
            xyz = _floats(body_el.get("pos"), 3)
            rpy = _frame_rpy(body_el)
            joint_els = body_el.findall("joint")
            free = body_el.find("freejoint") is not None
            if len(joint_els) > 1:
                raise NotImplementedError(
                    f"body {name}: multiple joints per body are not supported "
                    "(decompose into chained dummy bodies)")
            if joint_els and not free:
                a = merged(joint_els[0], "joint")
                jtype = a.get("type", "hinge")
                kind = {"hinge": U.JOINT_REVOLUTE, "slide": U.JOINT_PRISMATIC}.get(jtype)
                if kind is None:
                    raise NotImplementedError(f"joint type {jtype!r}")
                jpos = _floats(a.get("pos"), 3)
                if np.any(np.abs(jpos) > 0):
                    # shift the child frame onto the joint anchor (MuJoCo
                    # compiles anchors away the same way)
                    xyz = xyz + jpos
                    link.com = link.com - jpos
                    for g in link.geoms:
                        g.xyz = g.xyz - jpos
                rng = _floats(a.get("range"), 2)
                limited = a.get("limited", "true" if a.get("range") else "false")
                lower, upper = (rng[0], rng[1]) if limited == "true" or a.get("range") else (-math.pi, math.pi)
                j = U.Joint(
                    name=a.get("name") or f"{name}_joint",
                    kind=kind, parent=parent_name, child=name,
                    xyz=xyz, rpy=rpy,
                    axis=_floats(a.get("axis", "0 0 1"), 3),
                    lower=float(lower), upper=float(upper),
                    effort=float(a.get("actuatorfrcrange", "0 100").split()[-1])
                    if a.get("actuatorfrcrange") else 100.0,
                    velocity=50.0,
                    damping=float(a.get("damping", 0.0)),
                    friction=float(a.get("frictionloss", 0.0)),
                    armature=float(a.get("armature", 0.0)),
                )
                joints.append(j)
            else:
                joints.append(U.Joint(
                    name=f"{name}_weld", kind=U.JOINT_FIXED,
                    parent=parent_name, child=name,
                    xyz=xyz, rpy=rpy, axis=np.asarray([0.0, 0, 1.0])))

        # MJCF child bodies whose parent's joint anchor was folded away:
        # their pos is relative to the unshifted parent frame -> compensate
        shift = np.zeros(3)
        jels = body_el.findall("joint")
        if parent_name is not None and jels and body_el.find("freejoint") is None:
            a = merged(jels[0], "joint")
            shift = _floats(a.get("pos"), 3)
        for child_el in body_el.findall("body"):
            child_joint_idx = len(joints)  # the child's connecting joint is
            walk(child_el, name)           # appended first in its walk
            if np.any(np.abs(shift) > 0):
                joints[child_joint_idx].xyz = joints[child_joint_idx].xyz - shift

        return name

    top_bodies = worldbody.findall("body")
    if not top_bodies:
        raise ValueError("MJCF worldbody has no bodies")
    if len(top_bodies) == 1:
        root_name = walk(top_bodies[0], None)
    else:
        # multiple top-level bodies: weld them to a synthetic world link
        links["world"] = U.Link(name="world")
        for b in top_bodies:
            walk(b, "world")
        root_name = "world"

    return U.UrdfModel(name=root_el.get("model", "mjcf_robot"),
                       links=links, joints=joints, root=root_name)
