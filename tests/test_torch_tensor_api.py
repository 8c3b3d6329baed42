"""The port's tensor API (``isaacgym_tpu_torch/sim/tensor_api.py``) against
the JAX package's (``isaacgym_tpu/sim/tensor_api.py``) on the flagship
scene: the acquire views, the force-sensor tensor, the indexed setters, the
handles, and the shape and DOF property getters, setters and run-time DR
scales. Both packages start from one numpy state and one set of DR params.

The acquire views, setters and handles are reads and writes of the same
numbers, so they agree exactly; the rigid-body states (forward kinematics in
float32, in another order) to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax.numpy as jnp

from isaacgym_tpu.env.randomize import DRParams as JDRParams
from isaacgym_tpu.sim import asset_api as JA
from isaacgym_tpu.sim import tensor_api as JT
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import SimState as JSimState, Simulator as JaxSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_pingpong_scene
from isaacgym_tpu_torch.env.randomize import DRParams
from isaacgym_tpu_torch.interop import dr_params_from_numpy, sim_state_from_numpy
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim import tensor_api as T
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene
from isaacgym_tpu_torch.utils.config import load_task_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 6


@pytest.fixture(scope="module")
def sims():
    """(port simulator, JAX simulator) of the flagship scene with a sensor
    on the paddle, and one state of each from the same numbers."""
    cfg = load_task_config(TASK)
    psim = Simulator(scripted.paddle_sensor_scene(cfg), device="cpu")
    spec = jax_pingpong_scene(cfg["env"], cfg["sim"])
    tree = dataclasses.replace(spec.actors[0].tree)   # the JAX package caches its asset
    spec.actors[0].tree = tree
    JA.create_asset_force_sensor(tree, 39)
    jsim = JaxSimulator(jax_compile_scene(spec))
    rng = np.random.RandomState(0)
    shapes = {f: tuple(getattr(psim.initial_state(B), f).shape) for f in JSimState._fields}
    s_np = {f: rng.standard_normal(shapes[f]).astype(np.float32) for f in shapes}
    s_np["root"][..., 3:7] /= np.linalg.norm(s_np["root"][..., 3:7], axis=-1, keepdims=True)
    return psim, jsim, sim_state_from_numpy(s_np), JSimState(
        **{k: jnp.asarray(v) for k, v in s_np.items()})


def _eq(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _state_eq(got, want):
    for f in got._fields:
        _eq(getattr(got, f), getattr(want, f))


def test_acquire_views_match(sims):
    psim, jsim, ps, js = sims
    _eq(T.acquire_actor_root_state_tensor(ps), JT.acquire_actor_root_state_tensor(js))
    _eq(T.acquire_dof_state_tensor(ps), JT.acquire_dof_state_tensor(js))
    _eq(T.acquire_dof_force_tensor(ps), JT.acquire_dof_force_tensor(js))
    _eq(T.acquire_net_contact_force_tensor(ps), JT.acquire_net_contact_force_tensor(js))
    rb = T.acquire_rigid_body_state_tensor(psim, ps)
    assert rb.shape == (B, psim.scene.num_bodies, 13)
    _eq(rb, JT.acquire_rigid_body_state_tensor(jsim, js), atol=1e-5)
    assert T.acquire_actor_root_state_tensor(ps) is ps.root   # a view, not a copy


def test_force_sensor_tensor_matches(sims):
    """(B, n_sensors, 6) = [net contact force, net contact torque] at the
    sensor rows, by default every registered sensor, or given rows."""
    psim, jsim, ps, js = sims
    w = T.acquire_force_sensor_tensor(psim, ps)
    assert w.shape == (B, 1, 6)
    _eq(w, JT.acquire_force_sensor_tensor(jsim, js))
    rows = [39, 41, 3]
    _eq(T.acquire_force_sensor_tensor(psim, ps, rows),
        JT.acquire_force_sensor_tensor(jsim, js, body_indices=rows))


def test_refresh_is_the_identity_and_cameras_are_not_ported(sims):
    _, _, ps, _ = sims
    for fn in (T.refresh_all, T.refresh_actor_root_state_tensor, T.refresh_dof_state_tensor,
               T.refresh_rigid_body_state_tensor, T.refresh_dof_force_tensor,
               T.refresh_net_contact_force_tensor, T.refresh_force_sensor_tensor):
        assert fn(ps) is ps
    # the camera is ported (``sensors/camera.py``, held to the JAX camera in
    # tests/test_torch_camera.py): the image tensor is the camera's render
    from isaacgym_tpu_torch.sensors import Camera
    psim = sims[0]
    cam = Camera(psim.scene, width=12, height=9, device="cpu")
    out = cam.render(psim, ps)
    for image_type, key in (("depth", "depth"), ("rgb", "rgb"), ("seg", "seg"),
                            ("color", "rgb"), ("segmentation", "seg")):
        got = T.acquire_camera_image_tensor(cam, psim, ps, image_type)
        assert torch.equal(got, out[key]), image_type
    assert out["seg"].shape == (B, 9, 12) and out["seg"].dtype == torch.int32


def test_setters_match(sims):
    psim, jsim, ps, js = sims
    rng = np.random.RandomState(1)
    envs = [4, 1]
    vals = rng.standard_normal((2, 3, 13)).astype(np.float32)
    _state_eq(T.set_actor_root_state_tensor_indexed(ps, vals, envs),
              JT.set_actor_root_state_tensor_indexed(js, jnp.asarray(vals), envs))
    vals2 = rng.standard_normal((2, 1, 13)).astype(np.float32)
    _state_eq(T.set_actor_root_state_tensor_indexed(ps, vals2, envs, [2]),
              JT.set_actor_root_state_tensor_indexed(js, jnp.asarray(vals2), envs, [2]))
    qp, qv = (rng.standard_normal((2, 7)).astype(np.float32) for _ in range(2))
    _state_eq(T.set_dof_state_tensor_indexed(ps, qp, qv, envs),
              JT.set_dof_state_tensor_indexed(js, jnp.asarray(qp), jnp.asarray(qv), envs))
    v = [0.5, -1.0, 2.0]
    _state_eq(T.set_rigid_linear_velocity(ps, 2, v), JT.set_rigid_linear_velocity(js, 2, v))
    _state_eq(T.set_rigid_angular_velocity(ps, 2, v), JT.set_rigid_angular_velocity(js, 2, v))
    full = rng.standard_normal((3, 13)).astype(np.float32)
    _state_eq(T.set_actor_root_state_tensor(ps, full),
              JT.set_actor_root_state_tensor(js, jnp.asarray(full)))
    for ids in (None, envs):
        n = B if ids is None else len(ids)
        _state_eq(T.set_actor_dof_states(ps, psim, "humanoid1", qp[:1].repeat(n, 0),
                                         qv[:1].repeat(n, 0), ids),
                  JT.set_actor_dof_states(js, jsim, "humanoid1", jnp.asarray(qp[:1].repeat(n, 0)),
                                          jnp.asarray(qv[:1].repeat(n, 0)), ids))
    t = torch.ones(B, 7)
    assert T.set_dof_position_target_tensor(t) is t and T.set_dof_actuation_force_tensor(t) is t
    # the argument is left as it was
    before = ps.root.clone()
    T.set_rigid_linear_velocity(ps, 2, v)
    assert torch.equal(ps.root, before)


def test_handles_match(sims):
    psim, jsim, _, _ = sims
    for actor in ("humanoid1", "pingpong_table", "pingpong_ball_2", 1):
        assert T.get_actor_index(psim, actor) == JT.get_actor_index(jsim, actor)
        assert T.get_actor_rigid_body_names(psim, actor) == \
            JT.get_actor_rigid_body_names(jsim, actor)
    for actor in ("humanoid1", "pingpong_table", "pingpong_ball_2"):
        for body in T.get_actor_rigid_body_names(psim, actor):
            h = T.get_rigid_handle(psim, actor, body)
            assert h == JT.get_rigid_handle(jsim, actor, body)
            assert T.find_actor_rigid_body_handle(psim, actor, body) == h
            assert T.find_actor_rigid_body_index(psim.scene, actor, body) == h
    assert T.get_rigid_handle(psim, "humanoid1", "pingpong_paddle") == 39
    with pytest.raises(ValueError, match="no DOFs"):
        T.set_actor_dof_states(sims[2], psim, "pingpong_table", 0, 0)


def test_shape_and_dof_properties_match(sims):
    psim, jsim, _, _ = sims
    for actor in ("humanoid1", "pingpong_table", "pingpong_ball_2"):
        got = T.get_actor_rigid_shape_properties(psim, actor)
        want = JT.get_actor_rigid_shape_properties(jsim, actor)
        assert [(p.friction, p.restitution) for p in got] == \
            [(p.friction, p.restitution) for p in want]
    got, want = T.get_actor_dof_properties(psim, "humanoid1"), \
        JT.get_actor_dof_properties(jsim, "humanoid1")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = load_task_config(TASK)
    spec = build_pingpong_scene(cfg["env"], cfg["sim"])
    jspec = jax_pingpong_scene(cfg["env"], cfg["sim"])
    T.set_actor_rigid_shape_properties(spec, "humanoid1", [T.RigidShapeProperties(0.9, 0.1)])
    JT.set_actor_rigid_shape_properties(jspec, "humanoid1", [JT.RigidShapeProperties(0.9, 0.1)])
    props = {"stiffness": np.full(7, 30.0), "damping": np.full(7, 2.0), "driveMode": [1]}
    T.set_actor_dof_properties(spec, 0, props)
    JT.set_actor_dof_properties(jspec, 0, props)
    a, b = spec.actors[0], jspec.actors[0]
    assert (a.friction, a.restitution, a.drive_mode) == (b.friction, b.restitution, b.drive_mode)
    np.testing.assert_array_equal(a.stiffness, b.stiffness)
    np.testing.assert_array_equal(a.damping, b.damping)


def test_runtime_property_scales_match(sims):
    psim, jsim, _, _ = sims
    rng = np.random.RandomState(2)
    d_np = dict(gravity_offset=rng.standard_normal((B, 3)), mass_scale=rng.uniform(0.5, 1.5, B),
                friction_scale=rng.uniform(0.5, 1.5, B), restitution_scale=rng.uniform(0.5, 1.5, B),
                kp_scale=rng.uniform(0.5, 1.5, (B, 7)), kd_scale=rng.uniform(0.5, 1.5, (B, 7)),
                lower_shift=rng.standard_normal((B, 7)), upper_shift=rng.standard_normal((B, 7)))
    d_np = {k: v.astype(np.float32) for k, v in d_np.items()}
    pd = dr_params_from_numpy(d_np)
    jd = JDRParams(**{k: jnp.asarray(v) for k, v in d_np.items()})
    fr = rng.uniform(0.2, 0.8, B).astype(np.float32)
    for kw in (dict(friction=fr), dict(restitution=0.7), dict(friction=0.3, restitution=fr)):
        got = T.runtime_shape_property_scales(psim, pd, "humanoid1", **kw)
        want = JT.runtime_shape_property_scales(jsim, jd, "humanoid1",
                                                       **{k: jnp.asarray(v) if isinstance(
                                                           v, np.ndarray) else v
                                                          for k, v in kw.items()})
        assert isinstance(got, DRParams)
        for f in got._fields:
            _eq(getattr(got, f), getattr(want, f), atol=1e-7)
    kp = rng.uniform(10, 40, (B, 7)).astype(np.float32)
    for kw in (dict(stiffness=kp), dict(damping=3.0), dict(stiffness=25.0, damping=kp / 40)):
        got = T.runtime_dof_property_scales(psim, pd, "humanoid1", **kw)
        want = JT.runtime_dof_property_scales(jsim, jd, "humanoid1", **kw)
        for f in got._fields:
            _eq(getattr(got, f), getattr(want, f), atol=1e-7)
    # the input is left as it was
    np.testing.assert_array_equal(pd.kp_scale.numpy(), d_np["kp_scale"])
