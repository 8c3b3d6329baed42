"""Procedural generator for the pingpong asset suite (SURVEY.md §2 N14).

The reference consumes URDF assets from absolute paths on the author's
machine that are **absent from the snapshot**
(the reference's tasks/humanoid_pingpong_3_actor_tilt_no_earlystop.py:420,501,507),
so this framework synthesizes its own Unitree-G1-class humanoid with the
exact body/DOF naming and ordering contract recorded in the reference's dev
notes (the reference's tasks/pingpong_note.txt:12-33: 40 bodies, 29-DOF name
list, 7 right-arm DOFs) plus the table/ball assets.

All variants are generated from one kinematic spec table:
  * ``g1_29dof_rev_1_0_pingpong_fixed_except_right_arm.urdf`` — 40 bodies,
    7 DOFs (right arm), paddle welded as body 39 (used by C5-C8 tasks).
  * ``g1_27dof_pingpong.urdf`` — waist roll/pitch welded, 27 DOFs (C10).
  * ``g1_26dof_pingpong.urdf`` — whole waist welded, 26 DOFs (C11).
  * ``g1_29dof_pingpong.urdf`` — fully articulated, 29 DOFs.
  * ``pingpong_table.urdf`` — ITTF-dimensioned table + net (top z=0.76).
  * ``small_ball.urdf`` — 40 mm / 2.7 g ball.

Run ``python -m isaacgym_tpu_torch.models.assets.generate`` to (re)write the files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

ASSET_DIR = os.path.dirname(os.path.abspath(__file__))

RIGHT_ARM_DOF_NAMES = [
    "right_shoulder_pitch_joint", "right_shoulder_roll_joint", "right_shoulder_yaw_joint",
    "right_elbow_joint",
    "right_wrist_roll_joint", "right_wrist_pitch_joint", "right_wrist_yaw_joint",
]
WAIST_DOF_NAMES = ["waist_yaw_joint", "waist_roll_joint", "waist_pitch_joint"]

# ---------------------------------------------------------------------------
# Spec rows: (link, parent, jtype, xyz, rpy, axis, (lo, hi), mass, com,
#             inertia diag, geom or None)
# jtype: 'fixed' | 'revolute'.  Joint name is '<link minus _link>_joint' for
# movable rows (matching the reference DOF name list) else '<link>_joint'.
# Geometry: ('sphere', r, (ox,oy,oz)) | ('box', (hx,hy,hz), (ox,oy,oz))
#         | ('cylinder', r, half_len, (ox,oy,oz), (rr,rp,ry))
# ---------------------------------------------------------------------------

Row = Tuple


def _leg(side: str, sy: float) -> List[Row]:
    """One leg chain; ``sy`` = +1 left, -1 right (mirrored in y and roll limits)."""
    roll_lo, roll_hi = (-0.5236, 2.9671) if sy > 0 else (-2.9671, 0.5236)
    s = side
    return [
        (f"{s}_hip_pitch_link", "pelvis", "revolute", (0.0, sy * 0.064452, -0.1027), (0, 0, 0),
         (0, 1, 0), (-2.5307, 2.8798), 1.35, (0.002, sy * 0.021, -0.027), (0.00181, 0.00153, 0.00116), None),
        (f"{s}_hip_roll_link", f"{s}_hip_pitch_link", "revolute", (0.0, sy * 0.052, -0.030465), (0, 0, 0),
         (1, 0, 0), (roll_lo, roll_hi), 1.52, (0.029, sy * -0.001, -0.087), (0.00254, 0.00263, 0.00168), None),
        (f"{s}_hip_yaw_link", f"{s}_hip_roll_link", "revolute", (0.025001, 0.0, -0.12412), (0, 0, 0),
         (0, 0, 1), (-2.7576, 2.7576), 1.9, (-0.057, sy * 0.007, -0.126), (0.00567, 0.00554, 0.00244), None),
        (f"{s}_knee_link", f"{s}_hip_yaw_link", "revolute", (-0.078273, sy * 0.0021489, -0.17734), (0, 0, 0),
         (0, 1, 0), (-0.087267, 2.8798), 1.93, (0.005, sy * 0.003, -0.121), (0.01110, 0.01100, 0.00159), None),
        (f"{s}_ankle_pitch_link", f"{s}_knee_link", "revolute", (0.0, sy * -9.4445e-05, -0.30001), (0, 0, 0),
         (0, 1, 0), (-0.87267, 0.5236), 0.074, (-0.007, 0.0, 0.0), (1.9e-05, 1.1e-05, 1.3e-05), None),
        (f"{s}_ankle_roll_link", f"{s}_ankle_pitch_link", "revolute", (0.0, 0.0, -0.017558), (0, 0, 0),
         (1, 0, 0), (-0.2618, 0.2618), 0.608, (0.026, 0.0, -0.016), (0.00024, 0.00100, 0.00110),
         ("box", (0.08, 0.045, 0.025), (0.03, 0.0, -0.035))),
    ]


def _arm(side: str, sy: float) -> List[Row]:
    """One arm chain; ``sy`` = +1 left, -1 right."""
    roll_lo, roll_hi = (-1.5882, 2.2515) if sy > 0 else (-2.2515, 1.5882)
    s = side
    return [
        (f"{s}_shoulder_pitch_link", "torso_link", "revolute",
         (0.0039563, sy * 0.10022, 0.23778), (sy * 0.27931, 0, 0),
         (0, 1, 0), (-3.0892, 2.6704), 0.718, (0.0, sy * 0.036, -0.005), (0.00143, 0.00090, 0.00098), None),
        (f"{s}_shoulder_roll_link", f"{s}_shoulder_pitch_link", "revolute",
         (0.0, sy * 0.038, -0.013831), (sy * -0.27925, 0, 0),
         (1, 0, 0), (roll_lo, roll_hi), 0.643, (-0.0002, sy * 0.001, -0.045), (0.00113, 0.00115, 0.00081), None),
        (f"{s}_shoulder_yaw_link", f"{s}_shoulder_roll_link", "revolute",
         (0.0, sy * 0.00624, -0.1032), (0, 0, 0),
         (0, 0, 1), (-2.618, 2.618), 0.734, (0.010, sy * 0.003, -0.025), (0.00121, 0.00118, 0.00046), None),
        (f"{s}_elbow_link", f"{s}_shoulder_yaw_link", "revolute",
         (0.015783, 0.0, -0.080518), (0, 0, 0),
         (0, 1, 0), (-1.0472, 2.0944), 0.6, (0.064, sy * 0.004, -0.001), (0.00033, 0.00104, 0.00100), None),
        (f"{s}_wrist_roll_link", f"{s}_elbow_link", "revolute",
         (0.1, sy * 0.00188791, -0.01), (0, 0, 0),
         (1, 0, 0), (-1.9722, 1.9722), 0.085, (0.018, 0.0, 0.0), (7.0e-05, 4.8e-05, 5.0e-05), None),
        (f"{s}_wrist_pitch_link", f"{s}_wrist_roll_link", "revolute",
         (0.038, 0.0, 0.0), (0, 0, 0),
         (0, 1, 0), (-1.6144, 1.6144), 0.48, (0.022, 0.0, 0.0), (0.00040, 0.00043, 0.00038), None),
        (f"{s}_wrist_yaw_link", f"{s}_wrist_pitch_link", "revolute",
         (0.046, 0.0, 0.0), (0, 0, 0),
         (0, 0, 1), (-1.6144, 1.6144), 0.436, (0.021, sy * -0.001, 0.0), (0.00030, 0.00036, 0.00030), None),
        (f"{s}_rubber_hand", f"{s}_wrist_yaw_link", "fixed",
         (0.0415, sy * 0.003, 0.0), (0, 0, 0),
         (0, 0, 1), (0, 0), 0.35, (0.06, 0.0, 0.0), (0.00040, 0.00047, 0.00042),
         ("sphere", 0.03, (0.06, 0.0, 0.0))),
    ]


def g1_spec() -> List[Row]:
    """Full 40-body spec in reference depth-first order (pingpong_note.txt:22)."""
    rows: List[Row] = [
        # (link, parent, jtype, xyz, rpy, axis, limits, mass, com, I, geom)
        ("pelvis", None, None, (0, 0, 0), (0, 0, 0), (0, 0, 1), (0, 0),
         3.813, (0.0, 0.0, -0.074), (0.00832, 0.00691, 0.00633),
         ("box", (0.09, 0.11, 0.08), (0.0, 0.0, -0.05))),
        ("imu_in_pelvis", "pelvis", "fixed", (0.04525, 0.0, -0.08339), (0, 0, 0), (0, 0, 1), (0, 0),
         0.0, (0, 0, 0), (0, 0, 0), None),
    ]
    rows += _leg("left", +1.0)
    rows += [
        ("pelvis_contour_link", "pelvis", "fixed", (0, 0, 0), (0, 0, 0), (0, 0, 1), (0, 0),
         0.1, (0, 0, 0), (1e-05, 1e-05, 1e-05), ("box", (0.1, 0.12, 0.09), (0.0, 0.0, -0.04))),
    ]
    rows += _leg("right", -1.0)
    rows += [
        ("waist_yaw_link", "pelvis", "revolute", (-0.0039635, 0.0, 0.044), (0, 0, 0),
         (0, 0, 1), (-2.618, 2.618), 0.22, (0.004, 0.0, 0.019), (0.00012, 0.00019, 0.00020), None),
        ("waist_roll_link", "waist_yaw_link", "revolute", (0.0, 0.0, 0.035), (0, 0, 0),
         (1, 0, 0), (-0.52, 0.52), 0.22, (0.0, 0.0, 0.012), (0.00012, 0.00018, 0.00019), None),
        ("torso_link", "waist_roll_link", "revolute", (0.0, 0.0, 0.019), (0, 0, 0),
         (0, 1, 0), (-0.52, 0.52), 8.562, (0.0031, 0.0004, 0.1652), (0.06400, 0.05270, 0.02740),
         ("box", (0.09, 0.13, 0.19), (0.003, 0.0, 0.19))),
        # torso_pitch joint name must be waist_pitch_joint: handled by name map below
        ("d435_link", "torso_link", "fixed", (0.0576235, 0.01753, 0.42987), (0, 0.8307767, 0), (0, 0, 1), (0, 0),
         0.033, (0, 0, 0), (1e-06, 1e-06, 1e-06), None),
        ("head_link", "torso_link", "fixed", (0.0039635, 0.0, 0.44), (0, 0, 0), (0, 0, 1), (0, 0),
         1.232, (0.005, 0.0, 0.043), (0.00418, 0.00421, 0.00114), ("sphere", 0.06, (0.005, 0.0, 0.05))),
        ("imu_in_torso", "torso_link", "fixed", (-0.03959, -0.00224, 0.13792), (0, 0, 0), (0, 0, 1), (0, 0),
         0.0, (0, 0, 0), (0, 0, 0), None),
    ]
    rows += _arm("left", +1.0)
    rows += [
        ("logo_link", "torso_link", "fixed", (0.0039635, 0.0, 0.054), (0, 0, 0), (0, 0, 1), (0, 0),
         0.05, (0, 0, 0), (1e-06, 1e-06, 1e-06), None),
        ("mid360_link", "torso_link", "fixed", (0.0039635, 0.0, 0.424), (0, 0, 0), (0, 0, 1), (0, 0),
         0.05, (0, 0, 0), (1e-06, 1e-06, 1e-06), None),
    ]
    rows += _arm("right", -1.0)
    rows += [
        # Paddle welded to the right hand as body 39; blade extends +x of the
        # hand with face normal along local z after the geom rotation below.
        ("pingpong_paddle", "right_rubber_hand", "fixed", (0.10, 0.0, 0.0), (0, 0, 0), (0, 0, 1), (0, 0),
         0.17, (0.05, 0.0, 0.0), (0.00030, 0.00030, 0.00058),
         ("cylinder", 0.08, 0.0075, (0.05, 0.0, 0.0), (0, 1.5707963, 0))),
    ]
    return rows


# joint names that differ from '<link stem>_joint'
_JOINT_NAME_MAP = {"torso_link": "waist_pitch_joint"}

# per-joint armature (reflected rotor inertia) — stabilizes small wrist links
_ARMATURE = {"default": 0.01, "wrist": 0.003}


def _joint_name(link: str) -> str:
    if link in _JOINT_NAME_MAP:
        return _JOINT_NAME_MAP[link]
    stem = link[:-5] if link.endswith("_link") else link
    return f"{stem}_joint"


def _geom_xml(geom) -> str:
    if geom is None:
        return ""
    kind = geom[0]
    if kind == "sphere":
        _, r, off = geom
        return (f'    <collision><origin xyz="{off[0]} {off[1]} {off[2]}"/>'
                f'<geometry><sphere radius="{r}"/></geometry></collision>\n')
    if kind == "box":
        _, half, off = geom
        return (f'    <collision><origin xyz="{off[0]} {off[1]} {off[2]}"/>'
                f'<geometry><box size="{2*half[0]} {2*half[1]} {2*half[2]}"/></geometry></collision>\n')
    if kind == "cylinder":
        _, r, half_len, off, rpy = geom
        return (f'    <collision><origin xyz="{off[0]} {off[1]} {off[2]}" rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/>'
                f'<geometry><cylinder radius="{r}" length="{2*half_len}"/></geometry></collision>\n')
    raise ValueError(kind)


def build_g1_urdf(name: str, movable_joints: Optional[Sequence[str]] = None) -> str:
    """Render the G1 URDF; joints not in ``movable_joints`` become fixed
    (None = all spec-movable joints stay movable)."""
    rows = g1_spec()
    out = [f'<robot name="{name}">\n']
    # links first (document order = reference body order)
    for (link, parent, jtype, xyz, rpy, axis, lim, mass, com, inertia, geom) in rows:
        out.append(f'  <link name="{link}">\n')
        out.append('    <inertial>\n')
        out.append(f'      <origin xyz="{com[0]} {com[1]} {com[2]}"/>\n')
        out.append(f'      <mass value="{mass}"/>\n')
        out.append(f'      <inertia ixx="{inertia[0]}" iyy="{inertia[1]}" izz="{inertia[2]}" ixy="0" ixz="0" iyz="0"/>\n')
        out.append('    </inertial>\n')
        out.append(_geom_xml(geom))
        out.append('  </link>\n')
    # joints in document order (defines DOF ordering contract)
    for (link, parent, jtype, xyz, rpy, axis, lim, mass, com, inertia, geom) in rows:
        if parent is None:
            continue
        jname = _joint_name(link)
        movable = jtype == "revolute" and (movable_joints is None or jname in movable_joints)
        jt = "revolute" if movable else "fixed"
        out.append(f'  <joint name="{jname}" type="{jt}">\n')
        out.append(f'    <origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/>\n')
        out.append(f'    <parent link="{parent}"/>\n    <child link="{link}"/>\n')
        if movable:
            arm = _ARMATURE["wrist" if "wrist" in jname else "default"]
            out.append(f'    <axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>\n')
            out.append(f'    <limit lower="{lim[0]}" upper="{lim[1]}" effort="88" velocity="32"/>\n')
            out.append(f'    <dynamics damping="0.0" friction="0.0" armature="{arm}"/>\n')
        out.append('  </joint>\n')
    out.append('</robot>\n')
    return "".join(out)


def build_table_urdf() -> str:
    """ITTF table: 2.74 x 1.525 m, top surface z=0.76, net at table-center x
    (the task places the actor at x=1.75 so the net plane is world x=1.75;
    reference reward windows at tasks/
    humanoid_pingpong_3_actor_tilt_no_earlystop.py:1426-1478 assume this)."""
    return """<robot name="pingpong_table">
  <link name="pingpong_table">
    <inertial>
      <origin xyz="0 0 0.4"/>
      <mass value="80.0"/>
      <inertia ixx="8.0" iyy="14.0" izz="20.0" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 0.735"/>
      <geometry><box size="2.74 1.525 0.05"/></geometry>
    </collision>
    <collision>
      <origin xyz="0 0 0.83625"/>
      <geometry><box size="0.02 1.83 0.1525"/></geometry>
    </collision>
  </link>
</robot>
"""


def build_ball_urdf() -> str:
    """Regulation 40 mm, 2.7 g ball."""
    return """<robot name="small_ball">
  <link name="ball">
    <inertial>
      <origin xyz="0 0 0"/>
      <mass value="0.0027"/>
      <inertia ixx="7.2e-7" iyy="7.2e-7" izz="7.2e-7" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 0"/>
      <geometry><sphere radius="0.02"/></geometry>
    </collision>
  </link>
</robot>
"""


ALL_29 = None  # sentinel: every spec-movable joint
VARIANTS: Dict[str, Optional[List[str]]] = {
    "g1_29dof_rev_1_0_pingpong_fixed_except_right_arm.urdf": RIGHT_ARM_DOF_NAMES,
    "g1_29dof_pingpong.urdf": ALL_29,
}


def _all_dof_names() -> List[str]:
    return [_joint_name(r[0]) for r in g1_spec() if r[2] == "revolute"]


def generate_all(out_dir: str = ASSET_DIR) -> List[str]:
    names = _all_dof_names()
    variants = dict(VARIANTS)
    # 27-DOF variant: C10's DOF_Names list (reference
    # tasks/humanoid_pingpong_3_actor_all_dof.py:1303-1310) keeps all joints
    # except right_shoulder_yaw and right_elbow (5 right-arm DOFs remain)
    variants["g1_27dof_pingpong.urdf"] = [
        n for n in names if n not in ("right_shoulder_yaw_joint", "right_elbow_joint")]
    variants["g1_26dof_pingpong.urdf"] = [n for n in names if n not in WAIST_DOF_NAMES]
    written = []
    for fname, movable in variants.items():
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(build_g1_urdf(fname.rsplit(".", 1)[0], movable))
        written.append(path)
    for fname, render in [("pingpong_table.urdf", build_table_urdf), ("small_ball.urdf", build_ball_urdf)]:
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(render())
        written.append(path)
    return written


if __name__ == "__main__":
    for p in generate_all():
        print("wrote", p)
