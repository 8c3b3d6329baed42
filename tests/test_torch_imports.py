"""The port stands alone: no JAX, no YAML, nothing of the JAX package.

A subprocess with those modules made unimportable imports every module of
``isaacgym_tpu_torch`` and the top of ``chip_smoke.py`` and drives the env,
the two-humanoid C8 env (K3), the floating-base 27-DOF C10 env (K4), the
flagship and C8 scenes with paddle force sensors (K2-tau, K3-tau) read
through the tensor API, the DR env and one PPO epoch with a checkpoint on
the CPU; an AST scan of every file finds no such import. The entry points
default to the card and raise without one.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

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
import torch, isaacgym_tpu_torch
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
from isaacgym_tpu_torch.sim import scripted, tensor_api
from isaacgym_tpu_torch.sim.simulator import Simulator
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
