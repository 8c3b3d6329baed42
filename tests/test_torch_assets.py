"""The port's asset layer against the JAX package's, on the CPU.

* MJCF: the port's ``load_asset`` takes ``tests/test_mjcf.py``'s ``ARM``
  (an ``.xml`` file) to the JAX package's ``KinematicTree``, array for
  array, exactly; a malformed file raises, a file the native core refuses
  but the Python parser reads still loads.
* The native parsers (the port's copies of the C++ cores, built by g++ into
  ``build/kernels/<hash>/``) give the port's Python parsers' models field
  for field (1e-12), on every URDF of ``models/assets``, on
  ``tests/test_native.py``'s rich MJCF document, on ``ARM`` and on 25
  random MJCF trees from that file's fuzz generator (seed 7); the port's
  Python parsers give the JAX package's on the same documents; both native
  cores raise ``ValueError`` on the JAX tests' malformed documents. A build
  that fails raises with the compiler's output.
* The generator: each URDF string equals the JAX generator's, and
  ``generate_all`` into a temporary directory writes the port's committed
  URDFs byte for byte.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.models import mjcf as JM
from isaacgym_tpu.models import urdf as JU
from isaacgym_tpu.models.assets import generate as JG
from tests.test_mjcf import ARM
from tests.test_native import MJCF_RICH

from isaacgym_tpu_torch import native
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import mjcf as M
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.assets import ASSET_DIR
from isaacgym_tpu_torch.models.assets import generate as G

URDFS = sorted(f for f in os.listdir(ASSET_DIR) if f.endswith(".urdf"))


def assert_models_equal(a, b):
    """Two ``UrdfModel``s (of either package) field for field."""
    assert (a.name, a.root, a.link_names) == (b.name, b.root, b.link_names)
    assert [j.name for j in a.joints] == [j.name for j in b.joints]
    for ja, jb in zip(a.joints, b.joints):
        assert (ja.kind, ja.parent, ja.child) == (jb.kind, jb.parent, jb.child)
        for f in ("xyz", "rpy", "axis"):
            np.testing.assert_allclose(getattr(ja, f), getattr(jb, f), atol=1e-12, err_msg=f)
        np.testing.assert_allclose([ja.lower, ja.upper, ja.effort, ja.velocity],
                                   [jb.lower, jb.upper, jb.effort, jb.velocity], atol=1e-9)
        np.testing.assert_allclose([ja.damping, ja.friction, ja.armature],
                                   [jb.damping, jb.friction, jb.armature], atol=1e-12)
    for name in a.link_names:
        la, lb = a.links[name], b.links[name]
        np.testing.assert_allclose(la.mass, lb.mass, atol=1e-12)
        np.testing.assert_allclose(la.com, lb.com, atol=1e-12)
        np.testing.assert_allclose(la.inertia, lb.inertia, atol=1e-12)
        assert len(la.geoms) == len(lb.geoms)
        for ga, gb in zip(la.geoms, lb.geoms):
            assert ga.kind == gb.kind
            for f in ("size", "xyz", "rpy"):
                np.testing.assert_allclose(getattr(ga, f), getattr(gb, f), atol=1e-12)


def assert_trees_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, (np.ndarray, list, tuple)) or hasattr(x, "shape"):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
        else:
            assert x == y, f.name


def fuzz_docs(n=25, seed=7):
    """``tests/test_native.py``'s random MJCF trees (depth, joint types,
    anchors, frames, geom mix), in its draw order."""
    rng = np.random.RandomState(seed)
    uid = [0]

    def rand_body(depth, idx):
        name = f"b{depth}_{idx}_{uid[0]}"
        uid[0] += 1
        pos = " ".join(f"{v:.3f}" for v in rng.uniform(-0.3, 0.3, 3))
        frame = ""
        r = rng.rand()
        if r < 0.3:
            q = rng.uniform(-1, 1, 4)
            q /= np.linalg.norm(q)
            frame = f' quat="{q[0]:.4f} {q[1]:.4f} {q[2]:.4f} {q[3]:.4f}"'
        elif r < 0.5:
            e = rng.uniform(-0.5, 0.5, 3)
            frame = f' euler="{e[0]:.3f} {e[1]:.3f} {e[2]:.3f}"'
        joint = ""
        if depth > 0:
            jt = rng.choice(["hinge", "slide", "none"])
            if jt != "none":
                anchor = f' pos="{rng.uniform(-0.1, 0.1):.3f} 0 0"' if rng.rand() < 0.4 else ""
                rngstr = (f' range="{-rng.rand():.2f} {rng.rand():.2f}"'
                          if rng.rand() < 0.7 else "")
                joint = (f'<joint name="{name}_j" type="{jt}" axis="0 1 0"'
                         f'{anchor}{rngstr} damping="{rng.rand():.3f}"/>')
        g = rng.choice(["sphere", "box", "capsule", "none"])
        geom = ""
        if g == "sphere":
            geom = f'<geom type="sphere" size="{0.01 + rng.rand() * 0.05:.3f}"/>'
        elif g == "box":
            s = rng.uniform(0.01, 0.1, 3)
            geom = f'<geom type="box" size="{s[0]:.3f} {s[1]:.3f} {s[2]:.3f}"/>'
        elif g == "capsule":
            ft = rng.uniform(-0.2, 0.2, 6)
            geom = (f'<geom type="capsule" size="0.02 0" '
                    f'fromto="{" ".join(f"{v:.3f}" for v in ft)}"/>')
        kids = ""
        if depth < 3 and rng.rand() < 0.6:
            kids = "".join(rand_body(depth + 1, k) for k in range(rng.randint(1, 3)))
        inertial = (f'<inertial mass="{0.1 + rng.rand():.3f}" '
                    f'pos="{rng.uniform(-0.05, 0.05):.3f} 0 0" '
                    f'diaginertia="0.01 0.01 0.005"/>')
        return (f'<body name="{name}" pos="{pos}"{frame}>'
                f'{inertial}{joint}{geom}{kids}</body>')

    return [f'<mujoco model="fuzz{t}"><worldbody>' + rand_body(0, t) + "</worldbody></mujoco>"
            for t in range(n)]


def test_load_asset_takes_mjcf_to_the_jax_tree(tmp_path):
    path = str(tmp_path / "arm.xml")
    with open(path, "w") as f:
        f.write(ARM)
    got, want = K.load_asset(path), JK.load_asset(path)
    assert got.n_dof == want.n_dof == 2
    assert_trees_equal(got, want)
    assert_trees_equal(K.load_asset(path, floating_base=True),
                       JK.load_asset(path, floating_base=True))


def test_load_asset_on_urdfs_equals_the_python_parse():
    for f in URDFS:
        path = os.path.join(ASSET_DIR, f)
        assert_trees_equal(K.load_asset(path), K.compile_tree(U.parse_urdf(path)))


@pytest.mark.parametrize("fname", URDFS)
def test_native_urdf_equals_python_in_both_packages(fname):
    path = os.path.join(ASSET_DIR, fname)
    model = native.parse_urdf_native(path)
    assert_models_equal(model, U.parse_urdf(path))
    assert_models_equal(U.parse_urdf(path), JU.parse_urdf(path))


def test_native_mjcf_equals_python_in_both_packages(tmp_path):
    docs = [MJCF_RICH, ARM] + fuzz_docs()
    for i, doc in enumerate(docs):
        path = str(tmp_path / f"doc{i}.xml")
        with open(path, "w") as f:
            f.write(doc)
        model = M.parse_mjcf(path)
        assert_models_equal(native.parse_mjcf_native(path), model)
        assert_models_equal(model, JM.parse_mjcf(path))


def test_native_errors_and_the_python_retry(tmp_path, monkeypatch):
    bad_urdf = tmp_path / "bad.urdf"
    bad_urdf.write_text("<robot name='x'><link name='a'><inertial></robot>")
    bad_mjcf = tmp_path / "bad.xml"
    bad_mjcf.write_text("<mujoco model='x'><worldbody></mujoco>")
    with pytest.raises(ValueError):
        native.parse_urdf_native(str(bad_urdf))
    with pytest.raises(ValueError):
        native.parse_mjcf_native(str(bad_mjcf))
    # the Python parser's own error on a malformed file
    for bad in (bad_urdf, bad_mjcf):
        with pytest.raises(Exception):
            K.load_asset(str(bad))
    # a file the native core refuses goes to the Python parser
    good = tmp_path / "arm.xml"
    good.write_text(ARM)

    def refuse(path):
        raise ValueError("refused")
    monkeypatch.setattr(native, "parse_mjcf_native", refuse)
    assert_trees_equal(K.load_asset(str(good)), JK.load_asset(str(good)))


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from isaacgym_tpu_torch.ops import _build
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", [str(broken)])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.parse_urdf_native(os.path.join(ASSET_DIR, "small_ball.urdf"))


def test_generator_strings_equal_the_jax_generator():
    assert G.g1_spec() == JG.g1_spec()
    for movable in (None, G.RIGHT_ARM_DOF_NAMES, G.WAIST_DOF_NAMES):
        assert G.build_g1_urdf("g1", movable) == JG.build_g1_urdf("g1", movable)
    assert G.build_table_urdf() == JG.build_table_urdf()
    assert G.build_ball_urdf() == JG.build_ball_urdf()


def test_generate_all_writes_the_committed_urdfs(tmp_path):
    written = G.generate_all(str(tmp_path))
    assert sorted(os.path.basename(p) for p in written) == URDFS
    for f in URDFS:
        with open(tmp_path / f, "rb") as a, open(os.path.join(ASSET_DIR, f), "rb") as b:
            assert a.read() == b.read(), f


def test_scripted_mjcf_fixture_is_the_jax_tests_arm():
    from isaacgym_tpu_torch.sim.scripted import ARM_MJCF
    assert ARM_MJCF == ARM
