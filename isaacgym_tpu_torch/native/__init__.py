"""ctypes binding of the native C++ asset parsers (``isaacgym_tpu/native``).

``urdf_parser.cpp`` and ``mjcf_parser.cpp`` (copies of the JAX package's,
with their headers ``xml_mini.h`` and ``ig_asset.h``) are built by g++ at
first use into one library, ``libig_assets.so``, in the hashed and locked
``build/kernels/<hash>/`` directory of ``ops/_build.py``. A failed build
raises with the compiler's output. :func:`parse_urdf_native` and
:func:`parse_mjcf_native` return the same
:class:`isaacgym_tpu_torch.models.urdf.UrdfModel` as the Python parsers and
raise ``ValueError`` on a file they cannot parse; ``models/kinematics.py``
``load_asset`` then retries the Python parser, which raises its own error on
a malformed file.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, "urdf_parser.cpp"), os.path.join(_DIR, "mjcf_parser.cpp")]
HEADERS = [os.path.join(_DIR, "xml_mini.h"), os.path.join(_DIR, "ig_asset.h")]
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None


class _IgUrdf(ctypes.Structure):
    _fields_ = [
        ("n_links", ctypes.c_int),
        ("n_joints", ctypes.c_int),
        ("n_geoms", ctypes.c_int),
        ("link_mass", ctypes.POINTER(ctypes.c_double)),
        ("link_com", ctypes.POINTER(ctypes.c_double)),
        ("link_inertia", ctypes.POINTER(ctypes.c_double)),
        ("link_names", ctypes.POINTER(ctypes.c_char_p)),
        ("joint_kind", ctypes.POINTER(ctypes.c_int)),
        ("joint_parent", ctypes.POINTER(ctypes.c_int)),
        ("joint_child", ctypes.POINTER(ctypes.c_int)),
        ("joint_origin", ctypes.POINTER(ctypes.c_double)),
        ("joint_axis", ctypes.POINTER(ctypes.c_double)),
        ("joint_limit", ctypes.POINTER(ctypes.c_double)),
        ("joint_dynamics", ctypes.POINTER(ctypes.c_double)),
        ("joint_names", ctypes.POINTER(ctypes.c_char_p)),
        ("geom_link", ctypes.POINTER(ctypes.c_int)),
        ("geom_kind", ctypes.POINTER(ctypes.c_int)),
        ("geom_origin", ctypes.POINTER(ctypes.c_double)),
        ("geom_size", ctypes.POINTER(ctypes.c_double)),
        ("robot_name", ctypes.c_char_p),
    ]


def library_path() -> str:
    """Build ``libig_assets.so`` if this checkout has not yet; its path."""
    from isaacgym_tpu_torch.ops import _build
    return _build._build("libig_assets.so", "g++", FLAGS, SOURCES, HEADERS)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(library_path())
        for fn in ("ig_parse_urdf", "ig_parse_mjcf"):
            getattr(lib, fn).restype = ctypes.POINTER(_IgUrdf)
            getattr(lib, fn).argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.ig_free_urdf.argtypes = [ctypes.POINTER(_IgUrdf)]
        _lib = lib
    return _lib


def _unpack(lib, ptr):
    """IgUrdf* -> UrdfModel (shared by the URDF and MJCF cores)."""
    from isaacgym_tpu_torch.models import urdf as U

    try:
        u = ptr.contents
        nL, nJ, nG = u.n_links, u.n_joints, u.n_geoms

        def arr(p, n):
            return np.ctypeslib.as_array(p, shape=(n,)).copy() if n else np.zeros(0)

        link_names = [u.link_names[i].decode() for i in range(nL)]
        links = {}
        mass = arr(u.link_mass, nL)
        com = arr(u.link_com, nL * 3).reshape(nL, 3)
        inertia = arr(u.link_inertia, nL * 9).reshape(nL, 3, 3)
        for i, name in enumerate(link_names):
            links[name] = U.Link(name=name, mass=float(mass[i]), com=com[i],
                                 inertia=inertia[i])
        if nG:
            geom_link = np.ctypeslib.as_array(u.geom_link, shape=(nG,)).copy()
            geom_kind = np.ctypeslib.as_array(u.geom_kind, shape=(nG,)).copy()
            geom_origin = arr(u.geom_origin, nG * 6).reshape(nG, 6)
            geom_size = arr(u.geom_size, nG * 3).reshape(nG, 3)
            kind_map = {0: U.GEOM_SPHERE, 1: U.GEOM_BOX, 2: U.GEOM_CYLINDER}
            for g in range(nG):
                links[link_names[int(geom_link[g])]].geoms.append(U.Geom(
                    kind=kind_map[int(geom_kind[g])],
                    xyz=geom_origin[g, :3], rpy=geom_origin[g, 3:],
                    size=geom_size[g]))

        joints = []
        j_origin = arr(u.joint_origin, nJ * 6).reshape(nJ, 6)
        j_axis = arr(u.joint_axis, nJ * 3).reshape(nJ, 3)
        j_limit = arr(u.joint_limit, nJ * 4).reshape(nJ, 4)
        j_dyn = arr(u.joint_dynamics, nJ * 3).reshape(nJ, 3)
        kind_map = {0: U.JOINT_FIXED, 1: U.JOINT_REVOLUTE, 2: U.JOINT_PRISMATIC}
        for j in range(nJ):
            joints.append(U.Joint(
                name=u.joint_names[j].decode(),
                kind=kind_map[int(u.joint_kind[j])],
                parent=link_names[u.joint_parent[j]],
                child=link_names[u.joint_child[j]],
                xyz=j_origin[j, :3], rpy=j_origin[j, 3:], axis=j_axis[j],
                lower=float(j_limit[j, 0]), upper=float(j_limit[j, 1]),
                effort=float(j_limit[j, 2]), velocity=float(j_limit[j, 3]),
                damping=float(j_dyn[j, 0]), friction=float(j_dyn[j, 1]),
                armature=float(j_dyn[j, 2]),
            ))

        children = {j.child for j in joints}
        roots = [n for n in link_names if n not in children]
        if len(roots) != 1:
            raise ValueError(f"expected one root, got {roots}")
        return U.UrdfModel(name=u.robot_name.decode(), links=links,
                           joints=joints, root=roots[0])
    finally:
        lib.ig_free_urdf(ptr)


def _parse(fn: str, kind: str, path: str):
    lib = _load()
    errbuf = ctypes.create_string_buffer(512)
    ptr = getattr(lib, fn)(path.encode(), errbuf, len(errbuf))
    if not ptr:
        raise ValueError(f"native {kind} parse failed: {errbuf.value.decode()}")
    return _unpack(lib, ptr)


def parse_urdf_native(path: str):
    """Parse a URDF file with the C++ core -> UrdfModel (ValueError on a parse error)."""
    return _parse("ig_parse_urdf", "URDF", path)


def parse_mjcf_native(path: str):
    """Parse an MJCF file with the C++ core -> UrdfModel (ValueError on a parse error)."""
    return _parse("ig_parse_mjcf", "MJCF", path)
