"""The port's asset API (``isaacgym_tpu_torch/sim/asset_api.py``) against the
JAX package's (``isaacgym_tpu/sim/asset_api.py``), on the same assets: the
flagship's 7-DOF G1 (each package's copy of the URDF), a pendulum with a
prismatic joint, and the flagship scene. Mirrors ``tests/test_asset_api.py``
on the scenes the port simulates (its simulator takes scenes with a ball).

Every query is a read of compile-time tables, so the two packages agree
exactly; the DOF frames agree to 1e-6 (float32 forward kinematics in another
order).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.models import urdf as JU
from isaacgym_tpu.models.assets import generate
from isaacgym_tpu.sim import asset_api as JA
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_pingpong_scene
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.assets import ASSET_DIR
from isaacgym_tpu_torch.sim import asset_api as A
from isaacgym_tpu_torch.sim.scene import ActorSpec, PlaneParams, SceneSpec, compile_scene
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene
from isaacgym_tpu_torch.utils.config import load_task_config

G1 = "g1_29dof_rev_1_0_pingpong_fixed_except_right_arm.urdf"
TASK = "HumanoidPingpongTiltNoEarlyStopG1"
PENDULUM = """
<robot name="pend">
  <link name="base"><inertial><mass value="1"/><inertia ixx="0.1" iyy="0.1" izz="0.1"/></inertial></link>
  <link name="arm">
    <inertial><origin xyz="0 0 -0.5"/><mass value="2"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001"/></inertial>
  </link>
  <joint name="swing" type="revolute">
    <origin xyz="0 0 0"/><parent link="base"/><child link="arm"/>
    <axis xyz="0 1 0"/><limit lower="-3.14" upper="3.14" effort="10" velocity="10"/>
  </joint>
</robot>
"""


@pytest.fixture(scope="module")
def g1s():
    jpath = os.path.join(generate.ASSET_DIR, G1)
    if not os.path.exists(jpath):
        generate.generate_all()
    return K.load_asset(os.path.join(ASSET_DIR, G1)), JK.load_asset(jpath)


def test_asset_queries_match(g1s):
    g1, jg1 = g1s
    for fn in ("get_asset_rigid_body_count", "get_asset_dof_count", "get_asset_joint_count",
               "get_asset_rigid_body_names", "get_asset_dof_names", "get_asset_joint_names"):
        assert getattr(A, fn)(g1) == getattr(JA, fn)(jg1), fn
    assert A.get_asset_rigid_body_count(g1) == 40 and A.get_asset_dof_count(g1) == 7
    for i in (0, 17, 39):
        assert A.get_asset_rigid_body_name(g1, i) == JA.get_asset_rigid_body_name(jg1, i)
    for name in ("pingpong_paddle", "no_such_body"):
        assert A.find_asset_rigid_body_index(g1, name) == JA.find_asset_rigid_body_index(jg1, name)
    assert A.find_asset_rigid_body_index(g1, "pingpong_paddle") == 39
    for d in range(7):
        assert A.get_asset_dof_name(g1, d) == JA.get_asset_dof_name(jg1, d)
        assert A.get_asset_dof_type(g1, d) == JA.get_asset_dof_type(jg1, d) == A.DOF_ROTATION
    for t in (A.DOF_INVALID, A.DOF_ROTATION, A.DOF_TRANSLATION, 99):
        assert A.get_dof_type_string(t) == JA.get_dof_type_string(t)


def test_dof_properties_match_and_are_copies(g1s):
    g1, jg1 = g1s
    props, want = A.get_asset_dof_properties(g1), JA.get_asset_dof_properties(jg1)
    assert set(props) == set(want)
    for k in want:
        np.testing.assert_array_equal(props[k], want[k], err_msg=k)
        assert props[k].dtype == want[k].dtype, k
    props["lower"][:] = -99.0
    assert not (np.asarray(g1.lower) == -99.0).any()


def test_prismatic_dof_type():
    xml = PENDULUM.replace('type="revolute"', 'type="prismatic"')
    tree = K.compile_tree(U.parse_urdf(xml, from_string=True))
    jtree = JK.compile_tree(JU.parse_urdf(xml, from_string=True))
    assert A.get_asset_dof_type(tree, 0) == JA.get_asset_dof_type(jtree, 0) == A.DOF_TRANSLATION


def test_force_sensor_rows_follow_actor_order(g1s):
    """Sensors on two G1 bodies of an actor placed after the ball resolve to
    the same env-level rows in both packages; counts and indices too."""
    _, jg1 = g1s
    g1 = K.load_asset(os.path.join(ASSET_DIR, G1))
    jg1 = dataclasses.replace(jg1)    # a fresh copy: the fixture's asset keeps no sensor
    for tree, api in ((g1, A), (jg1, JA)):
        assert api.create_asset_force_sensor(tree, 5) == 0
        assert api.create_asset_force_sensor(tree, 12, (0.0, 0.0, 0.1)) == 1
        assert api.get_asset_force_sensor_count(tree) == 2
    assert g1._force_sensors == jg1._force_sensors
    ball = K.load_asset(os.path.join(ASSET_DIR, "small_ball.urdf"))
    kp = np.full(7, 20.0, np.float32)
    scene = compile_scene(SceneSpec(actors=[
        ActorSpec("ball", ball, pos=(1, 0, 1), fixed_base=False),
        ActorSpec("g1", g1, pos=(0, 0, 0.8), fixed_base=True, stiffness=kp, damping=kp / 40)],
        plane=PlaneParams()))
    np.testing.assert_array_equal(A.scene_force_sensor_body_indices(scene), [6, 13])
    from isaacgym_tpu.sim.scene import ActorSpec as JActor, SceneSpec as JSpec
    jball = JK.load_asset(os.path.join(generate.ASSET_DIR, "small_ball.urdf"))
    jscene = jax_compile_scene(JSpec(actors=[
        JActor("ball", jball, pos=(1, 0, 1), fixed_base=False),
        JActor("g1", jg1, pos=(0, 0, 0.8), fixed_base=True, stiffness=kp, damping=kp / 40)]))
    np.testing.assert_array_equal(A.scene_force_sensor_body_indices(scene),
                                  JA.scene_force_sensor_body_indices(jscene))
    # a sensor-less scene has none
    assert A.get_asset_force_sensor_count(ball) == 0
    cfg = load_task_config(TASK)
    assert A.scene_force_sensor_body_indices(
        compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"]))).size == 0


def test_dof_handles_and_frames_match():
    """DOF handles and world DOF frames on the flagship scene, at the
    initial pose, at random joint values and under a yawed base."""
    cfg = load_task_config(TASK)
    sim = Simulator(compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"])), device="cpu")
    jscene = jax_compile_scene(jax_pingpong_scene(cfg["env"], cfg["sim"]))
    assert [A.get_actor_dof_handle(sim, "humanoid1", d) for d in range(7)] == \
        [JA.get_actor_dof_handle(jscene, "humanoid1", d) for d in range(7)] == list(range(7))
    with pytest.raises(IndexError):
        A.get_actor_dof_handle(sim, "humanoid1", 7)
    with pytest.raises(ValueError, match="no DOFs"):
        A.get_actor_dof_handle(sim, "pingpong_table", 0)
    rng = np.random.RandomState(0)
    state = sim.initial_state(5)
    q = rng.uniform(-1.0, 1.0, (5, 7)).astype(np.float32)
    yaw = np.asarray([0, 0, np.sin(0.3), np.cos(0.3)], np.float32)
    root = state.root.clone()
    root[:, 0, 3:7] = torch.as_tensor(yaw)
    for st in (state, state._replace(dof_pos=torch.as_tensor(q)),
               state._replace(dof_pos=torch.as_tensor(q), root=root)):
        jst = type("S", (), {f: jnp.asarray(getattr(st, f).numpy()) for f in st._fields})
        for d in (0, 3, 6):
            o, a = A.get_dof_frame(sim, st, "humanoid1", d)
            jo, ja = JA.get_dof_frame(jscene, jst, "humanoid1", d)
            assert o.shape == a.shape == (5, 3)
            np.testing.assert_allclose(o.numpy(), jo, atol=1e-6)
            np.testing.assert_allclose(a.numpy(), ja, atol=1e-6)


def test_env_origin_and_add_ground():
    np.testing.assert_array_equal(A.get_env_origin(None, 7), JA.get_env_origin(None, 7))
    spec = SceneSpec(actors=[], plane=None)
    A.add_ground(spec, PlaneParams(restitution=0.3))
    assert spec.plane is not None and spec.plane.restitution == 0.3
    A.add_ground(spec)
    assert spec.plane == PlaneParams()
