"""The port's ray-cast camera (``isaacgym_tpu_torch/sensors/camera.py``)
against the JAX package's (``isaacgym_tpu/sensors/camera.py``), and its
wiring behind ``enableCameraSensors``.

Both cameras render the same body states: the flagship's after a port
rollout at 4 envs, and a scripted scene with boxes, cylinders and spheres at
random poses around the camera's target. The gates: depth within 1e-4 m
plus two float32 ulps of the depth where both hit (ground hits near the
horizon lie kilometres off, where one ulp is 5e-4 m), misses inf in both; segmentation equal on at least 99.9 %
of pixels and unequal only where the two nearest hits lie within 1e-4 m of
each other (both depths then agree to 1e-4); RGB within 1e-4 where the
segmentation agrees. The JAX camera runs at 24 x 18 pixels, a jitted render
each scene (a few seconds of XLA compile).
"""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax.numpy as jnp

import isaacgym_tpu_torch
from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.models import urdf as JU
from isaacgym_tpu.sensors import Camera as JCamera
from isaacgym_tpu.sim import scene as JS
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_pingpong_scene
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.models.assets import ASSET_DIR
from isaacgym_tpu_torch.sensors import Camera
from isaacgym_tpu_torch.sim import scene as S
from isaacgym_tpu_torch.sim import tensor_api as T
from isaacgym_tpu_torch.sim.simulator import Simulator
from isaacgym_tpu_torch.utils.config import load_task_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
W, H = 24, 18

SHAPES_URDF = """
<robot name="shapes">
  <link name="base">
    <inertial><origin xyz="0 0 0"/><mass value="5.0"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.1" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0 0 0"/><geometry><box size="0.6 0.3 0.2"/></geometry></collision>
    <collision><origin xyz="0 0.35 0.1" rpy="0.3 0.5 0"/>
      <geometry><cylinder radius="0.12" length="0.5"/></geometry></collision>
  </link>
  <link name="arm">
    <inertial><origin xyz="0 0 0"/><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial>
    <collision><origin xyz="0.2 0 0"/><geometry><sphere radius="0.15"/></geometry></collision>
    <collision><origin xyz="-0.1 0 0.1" rpy="0 0 0.7"/>
      <geometry><box size="0.1 0.4 0.25"/></geometry></collision>
    <collision><origin xyz="0 -0.2 0" rpy="1.2 0 0"/>
      <geometry><cylinder radius="0.07" length="0.3"/></geometry></collision>
  </link>
  <joint name="hinge" type="revolute">
    <origin xyz="0 0 0.4"/><parent link="base"/><child link="arm"/>
    <axis xyz="0 1 0"/><limit lower="-2.0" upper="2.0" effort="30" velocity="20"/>
  </joint>
</robot>
"""


def _scenes_from(urdf_text):
    """The same two-actor scene (the shapes robot, a ball) in both packages."""
    ball = os.path.join(ASSET_DIR, "small_ball.urdf")
    out = []
    for Um, Km, Sm in ((U, K, S), (JU, JK, JS)):
        tree = Km.compile_tree(Um.parse_urdf(urdf_text, from_string=True))
        out.append(Sm.compile_scene(Sm.SceneSpec(
            actors=[Sm.ActorSpec("shapes", tree, pos=(1.4, 0.0, 0.9), fixed_base=True),
                    Sm.ActorSpec("ball", Km.load_asset(ball), pos=(1.0, 0.0, 1.0),
                                 fixed_base=False)],
            plane=Sm.PlaneParams(), dt=1 / 120, substeps=2)))
    return out


def _random_bodies(nb, B, seed):
    """Body states at random poses within 0.6 m of the camera's target."""
    rng = np.random.RandomState(seed)
    rb = np.zeros((B, nb, 13), np.float32)
    rb[..., 0:3] = np.float32([1.4, 0.0, 0.9]) + rng.uniform(-0.6, 0.6, (B, nb, 3))
    q = rng.standard_normal((B, nb, 4))
    rb[..., 3:7] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return rb


def _flagship_bodies(B=4, steps=20):
    env = isaacgym_tpu_torch.make(seed=3, task=TASK, num_envs=B, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset()
    for _ in range(steps):
        state, *_ = env.step(state, torch.rand((B, 7), generator=gen) * 2 - 1)
    return env.sim.rigid_body_states(state.sim).numpy()


def _compare(port_out, jax_out):
    d, jd = port_out["depth"].numpy(), np.asarray(jax_out["depth"])
    seg, jseg = port_out["seg"].numpy(), np.asarray(jax_out["seg"])
    rgb, jrgb = port_out["rgb"].numpy(), np.asarray(jax_out["rgb"])
    assert seg.dtype == np.int32 and jseg.dtype == np.int32
    hit, jhit = np.isfinite(d), np.isfinite(jd)
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(seg == -1, ~hit)
    gate = 1e-4 + 2 * np.spacing(np.abs(jd[hit]))
    assert (np.abs(d[hit] - jd[hit]) <= gate).all()
    same = seg == jseg
    assert same.mean() >= 0.999
    assert (np.abs(d[~same] - jd[~same]) <= 1e-4).all()
    assert np.abs(rgb - jrgb)[same].max() <= 1e-4
    return set(np.unique(seg).tolist())


@pytest.mark.parametrize("scene", ("flagship", "shapes"))
def test_camera_matches_the_jax_camera(scene):
    if scene == "flagship":
        cfg = load_task_config(TASK)
        env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=1, device="cpu")
        pscene, jscene = env.scene, JS.compile_scene(jax_pingpong_scene(cfg["env"], cfg["sim"]))
        rb = _flagship_bodies()
        kw = {}
    else:
        pscene, jscene = _scenes_from(SHAPES_URDF)
        rb = _random_bodies(pscene.num_bodies, 6, seed=1)
        kw = dict(pos=(2.8, -1.0, 1.0), fov_deg=60.0)
    cam = Camera(pscene, width=W, height=H, device="cpu", **kw)
    jcam = JCamera(jscene, width=W, height=H, **kw)
    assert (cam.table.kind.tolist(), cam.table.body.tolist()) == (
        jcam.table.kind.tolist(), jcam.table.body.tolist())
    got = cam.render_bodies(torch.as_tensor(rb))
    seen = _compare(got, jcam._render_batched(jnp.asarray(rb)))
    assert {-2, 0, 1} <= seen, seen                # the ground and two actors in view
    if scene == "shapes":
        assert -1 in seen                          # and the sky
        g = cam.nearest_hits(torch.as_tensor(rb))[2].unique().numpy()
        kinds = set(cam.table.kind[g[g < len(cam.table.kind)]].tolist())
        assert kinds == {U.GEOM_SPHERE, U.GEOM_BOX, U.GEOM_CYLINDER}, kinds


def _ball_scene(z=1.0):
    tree = K.load_asset(os.path.join(ASSET_DIR, "small_ball.urdf"))
    return S.compile_scene(S.SceneSpec(
        actors=[S.ActorSpec("ball", tree, pos=(0.0, 0.0, z), fixed_base=False,
                            restitution=1.5, friction=0.2)],
        plane=S.PlaneParams(), dt=1 / 120, substeps=2))


def test_closed_form_depth_seg_and_a_moving_ball():
    """tests/test_camera.py's checks on the port: a camera 2 m from the
    ball sees it at 2 - r, the sky in the top corners and the ground below;
    moving the ball 0.5 m nearer shortens the depth by 0.5 m."""
    scene = _ball_scene(z=1.0)
    sim = Simulator(scene, device="cpu")
    state = sim.initial_state(2)
    cam = Camera(scene, pos=(2.0, 0.0, 1.0), target=(0.0, 0.0, 1.0), width=33, height=33,
                 fov_deg=60, device="cpu")
    out = cam.render(sim, state)
    d, seg = out["depth"][0].numpy(), out["seg"][0].numpy()
    assert abs(d[16, 16] - (2.0 - 0.02)) <= 1e-4
    assert seg[16, 16] == 0
    assert seg[0, 0] == -1 and not np.isfinite(d[0, 0])
    assert seg[-1, 16] == -2 and d[-1, 16] > 1.0
    np.testing.assert_array_equal(out["depth"][1].numpy(), d)
    root = state.root.clone()
    root[:, 0, 0] = 0.5
    d1 = cam.render(sim, state._replace(root=root))["depth"][0, 16, 16]
    assert abs(float(d[16, 16] - d1) - 0.5) <= 1e-4


def test_env_camera_wiring_and_tensor_api():
    """``enableCameraSensors`` ("true" or "1") builds a camera per entry of
    ``cameras``; ``render_camera`` and ``acquire_camera_image_tensor`` give
    its images; the default stays off."""
    env = isaacgym_tpu_torch.make(
        seed=0, task="HumanoidPingpongTiltG1", num_envs=2, device="cpu",
        enableCameraSensors=True, cameras=[dict(pos=(4.2, -2.6, 2.2), target=(1.4, 0.0, 0.9),
                                                width=48, height=36)])
    assert len(env.cameras) == 1 and env.cameras[0].device.type == "cpu"
    state, obs = env.reset()
    out = env.render_camera(state)
    assert out["depth"].shape == (2, 36, 48) and out["rgb"].shape == (2, 36, 48, 3)
    assert {0, 1, -2} <= set(out["seg"][0].flatten().tolist())
    for kind, key in (("depth", "depth"), ("color", "rgb"), ("segmentation", "seg")):
        img = T.acquire_camera_image_tensor(env.cameras[0], env.sim, state.sim, kind)
        assert torch.equal(img, out[key]) and bool(torch.isfinite(img.float()).any())
    assert bool(torch.isfinite(out["rgb"]).all())
    env1 = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device="cpu",
                                   enableCameraSensors="1")
    assert len(env1.cameras) == 1 and env1.cameras[0].width == 96
    assert isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device="cpu").cameras == []
