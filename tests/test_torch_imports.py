"""The port stands alone: no JAX, no YAML, nothing of the JAX package.

A subprocess with those modules made unimportable imports every module of
``isaacgym_tpu_torch`` and the top of ``chip_smoke.py`` and drives the env,
the two-humanoid C8 env (K3), the floating-base 27-DOF C10 env (K4), the
two 26-DOF humanoids of C11 (K3), a link-collision scene, the flagship and
C8 scenes with paddle force sensors (K2-tau, K3-tau) read
through the tensor API, the DR env and one PPO epoch with a checkpoint, a
camera through ``enableCameraSensors`` and the tensor API, a motion clip and
the AMP loss, a ``flatten_optimizer`` epoch, a recorded rollout and the joint
monkey, an MJCF asset, the observers, the reward hooks with the
``model_size_multiplier`` and the mesh arithmetic on the CPU; an AST scan
of every file finds no such import. The entry
points (the env, the launcher, the camera, the motion library, the joint
monkey, the two tools, PBT, ``profile_ppo`` and ``probe_ball``) default to
the card and raise without one.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "isaacgym_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "omegaconf", "isaacgym_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel.endswith(".__init__"):
            rel = rel[:-len(".__init__")]
        names.append(rel)
    return names


BLOCKER = f"""
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
"""


def test_port_imports_and_steps_with_jax_yaml_and_reference_blocked():
    code = BLOCKER + f"""
import importlib
for name in {_module_names()!r}:
    importlib.import_module(name)
import os, torch, isaacgym_tpu_torch
env = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1",
                              num_envs=2, device="cpu")
state, obs = env.reset()
state, obs, rew, done, info = env.step(state, torch.zeros(2, 7))
assert obs.shape == (2, 80) and bool(torch.isfinite(obs).all())
env8 = isaacgym_tpu_torch.make(seed=0, task="Humanoid12PingpongTiltG1", num_envs=2,
                               device="cpu")
state8, obs8 = env8.reset()
state8, obs8, rew8, done8, info8 = env8.step(state8, torch.zeros(2, 14))
assert obs8.shape == (2, 94) and bool(torch.isfinite(obs8).all())
assert env8.sim.fused_substep is None and env8.sim.fused_substep_multi is not None
env10 = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNESSparse27DOFG1",
                                num_envs=2, device="cpu")
state10, obs10 = env10.reset()
state10, obs10, rew10, done10, info10 = env10.step(state10, torch.zeros(2, 27))
assert obs10.shape == (2, 313) and bool(torch.isfinite(obs10).all())
assert env10.sim.fused_substep_floating is not None
from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
from isaacgym_tpu_torch.utils.config import load_task_config
envt = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1", num_envs=2,
                               device="cpu", cfg=rough_terrain_cfg(load_task_config(
                                   "HumanoidPingpongTiltNoEarlyStopG1"), 0, size_m=(1.0, 1.0)))
statet, obst = envt.reset()
statet, obst, rewt, donet, infot = envt.step(statet, torch.zeros(2, 7))
assert obst.shape == (2, 305) and bool(torch.isfinite(obst).all())
assert envt.sim.route == "k1" and envt.sim.arm_steps is not None
for task in ("HumanoidPingpongG1", "HumanoidPingpongAlignmentG1", "HumanoidPingpongTiltGaussFTG1"):
    envc = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=2, device="cpu")
    sc, oc = envc.reset()
    sc, oc, rc, dc, ic = envc.step(sc, torch.zeros(2, 7))
    assert oc.shape == (2, 80) and envc.sim.route == "k2" and bool(torch.isfinite(rc).all())
from isaacgym_tpu_torch.parity import env_step, kl_pair
res = env_step.check(os.path.join(os.path.dirname(env_step.__file__), "data", "c9.npz"), "cpu")
assert res["gate"] == "PASS", res
env11 = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpong5ActorG1", num_envs=2,
                                device="cpu")
s11, o11 = env11.reset()
s11, o11, r11, d11, i11 = env11.step(s11, torch.zeros(2, 52))
assert o11.shape == (2, 24) and env11.sim.route == "k3" and bool(torch.isfinite(r11).all())
from isaacgym_tpu_torch.sim import scripted, tensor_api
from isaacgym_tpu_torch.sim.simulator import Simulator
simL = Simulator(scripted.pendulum_scene(), device="cpu")
sL = simL.step(simL.initial_state(2), torch.zeros(2, 2), torch.zeros(2, 2))
assert simL.route == "nonkernel" and len(simL._art_art_pairs) == 1
from isaacgym_tpu_torch.utils.config import load_task_config
for task, humanoids in (("HumanoidPingpongTiltNoEarlyStopG1", 1), ("Humanoid12PingpongTiltG1", 2)):
    sim = Simulator(scripted.paddle_sensor_scene(load_task_config(task), humanoids), device="cpu")
    s = sim.step(sim.initial_state(2), torch.zeros(2, 7 * humanoids), torch.zeros(2, 7 * humanoids))
    assert sim.with_torque and tensor_api.acquire_force_sensor_tensor(sim, s).shape == (2, humanoids, 6)
import os, tempfile
from isaacgym_tpu_torch.rl import checkpoint
from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from isaacgym_tpu_torch.utils.config import compose
cfg = compose("HumanoidPingpongTiltNoEarlyStopG1", ["task.randomize=true", "num_envs=4",
              "train.params.network.mlp.units=[16]", "train.params.config.horizon_length=2",
              "train.params.config.minibatch_size=4"])
env = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1",
                              device="cpu", cfg=cfg["task"])
trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)
ts = trainer.init_state()
state, obs = env.reset()
ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
assert state.dr is not None and int(state.global_step) == 2
assert all(bool(torch.isfinite(v)) for v in metrics.values())
with tempfile.TemporaryDirectory() as d:
    checkpoint.save(os.path.join(d, "c.pt"), ts)
    checkpoint.restore(os.path.join(d, "c.pt"), trainer.init_state())
envc = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1", num_envs=2,
                               device="cpu", enableCameraSensors=True,
                               cameras=[dict(width=16, height=12)])
sc, oc = envc.reset()
img = tensor_api.acquire_camera_image_tensor(envc.cameras[0], envc.sim, sc.sim, "seg")
assert img.shape == (2, 12, 16) and envc.render_camera(sc)["rgb"].shape == (2, 12, 16, 3)
from isaacgym_tpu_torch.rl import amp, motion_lib
from isaacgym_tpu_torch.viewer import joint_monkey, trajectory
with tempfile.TemporaryDirectory() as d:
    motion_lib.save_motion_clip(os.path.join(d, "c.npz"), 30.0, torch.zeros(5, 3),
                                torch.tensor([[0.0, 0, 0, 1]]).repeat(5, 1), torch.zeros(5, 7),
                                torch.zeros(5, 7))
    lib = motion_lib.MotionLib(os.path.join(d, "c.npz"), 7, device="cpu")
    assert lib.get_motion_state(torch.tensor([0]), torch.tensor([0.05]))["dof_pos"].shape == (1, 7)
disc = amp.AMPDiscriminator(28, (16,))
assert amp.disc_loss(disc, torch.zeros(4, 28), torch.ones(4, 28))[0].ndim == 0
import dataclasses
ft = PPOTrainer(env, dataclasses.replace(PPOConfig.from_train_cfg(cfg["train"]),
                                         flatten_optimizer=True), seed=0)
fts = ft.init_state()
fts, state, obs, metrics = ft.train_epoch(fts, state, obs)
assert fts.opt_state.count > 0 and all(bool(torch.isfinite(v)) for v in metrics.values())
assert trajectory.record_env_rollout(envc, steps=2).stacked().shape[0] == 2
assert joint_monkey.run(steps=2, device="cpu").stacked().shape == (2, 1, 83, 13)
from isaacgym_tpu_torch.models.kinematics import load_asset
from isaacgym_tpu_torch.parallel import mesh
from isaacgym_tpu_torch.utils import logging as L
from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "a.xml"), "w") as f:
        f.write('<mujoco model="a"><worldbody><body name="b"><inertial mass="1" '
                'diaginertia="1 1 1"/><body name="c"><joint name="j" type="hinge"/>'
                '<inertial mass="1" diaginertia="1 1 1"/></body></body></worldbody></mujoco>')
    assert load_asset(os.path.join(d, "a.xml")).n_dof == 1
    obs_ = L.MultiObserver([L.EpisodeStatsObserver(), L.JsonlObserver(), L.PbtObserver(1)])
    obs_.after_init(d, {{}})
c8 = compose("Humanoid12PingpongTiltG1", ["two_player=true", "hit_reward=500",
                                          "train.params.network.mlp.model_size_multiplier=2"])
assert c8["task"]["env"]["twoPlayer"] is True and c8["task"]["env"]["hitTableReward"] == 500
assert preprocess_train_config(c8)["params"]["network"]["mlp"]["units"][0] == 4096
assert mesh.make_mesh(4, 2) == {{"dp": 2, "mdl": 2}}
for bad in {FORBIDDEN!r}:
    assert bad not in sys.modules, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {m}"


def test_make_on_cuda_without_a_gpu_raises(monkeypatch):
    import isaacgym_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1",
                                num_envs=4)


def test_c8_make_on_cuda_without_a_gpu_raises(monkeypatch):
    import isaacgym_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isaacgym_tpu_torch.make(seed=0, task="Humanoid12PingpongTiltG1", num_envs=4)


def test_c10_make_on_cuda_without_a_gpu_raises(monkeypatch):
    import isaacgym_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNESSparse27DOFG1",
                                num_envs=4)


@pytest.mark.parametrize("task", ("HumanoidPingpongG1", "HumanoidPingpongAlignmentG1",
                                  "HumanoidPingpongTiltGaussFTG1"))
def test_single_humanoid_make_on_cuda_without_a_gpu_raises(monkeypatch, task):
    import isaacgym_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isaacgym_tpu_torch.make(seed=0, task=task, num_envs=4)


def test_launcher_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path):
    """The launcher (and so the trainer on its env) runs on the card unless
    ``device=cpu`` is passed."""
    from isaacgym_tpu_torch.train import main
    from isaacgym_tpu_torch.utils.config import compose
    assert compose("HumanoidPingpongTiltNoEarlyStopG1")["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["num_envs=4", "max_iterations=1"], run_root=str(tmp_path))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    import isaacgym_tpu_torch
    env = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1",
                                  num_envs=4, device="cpu")
    k = env.sim.fused_substep
    good = [torch.zeros(4, n) for n in (7, 7, 7, 7, 3, 3, 3)]
    with pytest.raises(ValueError, match="float32"):
        k(*[g.double() for g in good])
    with pytest.raises(ValueError):
        k(*good[:6], torch.zeros(4, 4))
    with pytest.raises(ValueError, match="no kernel for device"):
        k(*[g.to("meta") for g in good])
    with pytest.raises(ValueError, match="CUDA"):
        k.launch(torch.zeros(37, 4))   # a CPU buffer never reaches the kernel
    assert k.launches == 0
    kdr = env.sim.fused_substep_dr
    with pytest.raises(ValueError, match="dr_chan"):
        kdr(*good)                      # K2-dr needs its channel
    with pytest.raises(ValueError, match="dr_chan"):
        k(*good, torch.ones(4, 34))     # K2 refuses one
    with pytest.raises(ValueError, match="34"):
        kdr(*good, torch.ones(4, 33))
    with pytest.raises(ValueError, match=r"\(71, B\)"):
        kdr.launch(torch.zeros(37, 4))
    assert kdr.launches == 0


def _camera_on_the_card():
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.sensors import Camera
    env = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1",
                                  num_envs=2, device="cpu")
    Camera(env.scene)


def _motion_lib_on_the_card(tmp_path):
    from isaacgym_tpu_torch.rl.motion_lib import MotionLib, save_motion_clip
    path = str(tmp_path / "c.npz")
    save_motion_clip(path, 30.0, torch.zeros(3, 3), torch.zeros(3, 4), torch.zeros(3, 7),
                     torch.zeros(3, 7))
    MotionLib(path, 7)


def _amp_demo_on_the_card(tmp_path):
    from isaacgym_tpu_torch.amp_demo import main
    main(["--expert", str(tmp_path / "none.pt"), "--out", str(tmp_path / "amp")])


def _record_policy_on_the_card(tmp_path):
    from isaacgym_tpu_torch.record_policy import main
    main(["--checkpoint", str(tmp_path / "none.pt"), "--out", str(tmp_path / "p")])


def _joint_monkey_on_the_card(tmp_path):
    from isaacgym_tpu_torch.viewer.joint_monkey import run
    run(steps=1)


def _pbt_on_the_card(tmp_path):
    from isaacgym_tpu_torch.pbt import main
    main(["num_envs=2", "population=2", "rounds=1"], run_root=str(tmp_path))


def _profile_ppo_on_the_card():
    from isaacgym_tpu_torch.profile_ppo import main
    main(["--num-envs", "4"])


def _probe_ball_on_the_card():
    from isaacgym_tpu_torch.probe_ball import main
    main(["--envs", "4", "--steps", "1"])


@pytest.mark.parametrize("entry", ("camera", "motion_lib", "amp_demo", "record_policy",
                                   "joint_monkey", "pbt", "profile_ppo", "probe_ball"))
def test_camera_amp_and_viewer_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"camera": lambda: _camera_on_the_card(),
          "motion_lib": lambda: _motion_lib_on_the_card(tmp_path),
          "amp_demo": lambda: _amp_demo_on_the_card(tmp_path),
          "record_policy": lambda: _record_policy_on_the_card(tmp_path),
          "joint_monkey": lambda: _joint_monkey_on_the_card(tmp_path),
          "pbt": lambda: _pbt_on_the_card(tmp_path),
          "profile_ppo": lambda: _profile_ppo_on_the_card(),
          "probe_ball": lambda: _probe_ball_on_the_card()}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
