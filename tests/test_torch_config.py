"""The port's config surface against the JAX package's, on the CPU.

* ``compose`` routes the root-level keys where the JAX YAMLs route them:
  every registered task x every reward hook (``hit_reward`` ...
  ``two_player``), set and empty, gives the JAX ``compose``'s task config;
  the launcher keys give its train config. Compared whole, with one key
  left out: the root ``device`` (the port's own launcher key, which the JAX
  root config does not have). Values are exact (the hooks' values are
  integers or booleans, which both loaders parse alike).
* The interpolation table ``cfg/interpolations.json`` is what
  ``tools/torch_cfg_export.py`` writes from the YAMLs.
* ``preprocess_train_config``: with ``model_size_multiplier=2`` the port's
  trainer's layer widths are the JAX trainer's, and the preprocessed train
  dict is the JAX one but for ``params.config.device`` (the port's
  ``device``, where the JAX package writes its ``rl_device``).
"""

import copy
import os
import sys

import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

from isaacgym_tpu.utils.config import compose as jax_compose
from isaacgym_tpu.utils.config import preprocess_train_config as jax_preprocess

from isaacgym_tpu_torch.utils.config import compose, interpolations, preprocess_train_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

TASKS = sorted(interpolations()["tasks"])
HOOKS = ("alpha_velocity_reward", "power_coefficient", "penalty", "hit_reward", "hit_penalty",
         "cross_net_reward", "landing_shaping", "die_penalty", "two_player")
#: a value per hook that differs from every task's default
HOOK_VALUE = dict(alpha_velocity_reward=77, power_coefficient=3, penalty=-123, hit_reward=500,
                  hit_penalty=-456, cross_net_reward=789, landing_shaping=250,
                  die_penalty=-999, two_player="true")
LAUNCHER = ["num_envs=8", "seed=3", "experiment=cfgtest", "checkpoint=runs/x/ckpt_final.pt",
            "test=true", "max_iterations=5"]


def _without_device(cfg):
    cfg = dict(cfg)
    cfg.pop("device")
    return cfg


def test_table_is_what_the_exporter_writes():
    import torch_cfg_export
    assert interpolations() == torch_cfg_export.table()


def test_tasks_are_the_registered_tasks():
    from isaacgym_tpu.tasks import task_registry
    assert set(TASKS) <= set(task_registry())
    assert set(TASKS) == {f[:-5] for f in os.listdir(os.path.join(REPO, "isaacgym_tpu_torch",
                                                                  "cfg")) if f.endswith(".json")
                          and f != "interpolations.json"}


@pytest.mark.parametrize("task", TASKS)
def test_hooks_reach_the_task_as_in_the_jax_package(task):
    for hook in HOOKS:
        for value in (HOOK_VALUE[hook], ""):
            ov = [f"{hook}={value}"]
            got, want = compose(task, ov), jax_compose(task, ov)
            assert got["task"] == want["task"], (task, hook, value)
            assert _without_device(got) == want, (task, hook, value)
    both = [f"{h}={v}" for h, v in HOOK_VALUE.items()]
    assert compose(task, both)["task"] == jax_compose(task, both)["task"]


@pytest.mark.parametrize("task", TASKS)
def test_launcher_keys_reach_the_train_config(task):
    got, want = compose(task, LAUNCHER), jax_compose(task, LAUNCHER)
    assert _without_device(got) == want
    p = got["train"]["params"]
    assert (p["seed"], p["load_checkpoint"], p["load_path"]) == (3, True, "runs/x/ckpt_final.pt")
    assert p["config"]["name"] == "cfgtest" and p["config"]["num_actors"] == 8
    assert got["task"]["env"]["test"] is True and got["task"]["env"]["numEnvs"] == 8


def test_two_player_and_hit_reward_reach_c8():
    """The reported fault: C8 with two_player=true and hit_reward=500."""
    cfg = compose("Humanoid12PingpongTiltG1", ["hit_reward=500", "two_player=true"])
    assert cfg["task"]["env"]["hitTableReward"] == 500
    assert cfg["task"]["env"]["twoPlayer"] is True


def test_landing_shaping_reaches_c6():
    cfg = compose("HumanoidPingpongTiltG1", ["landing_shaping=500.0"])
    assert cfg["task"]["env"]["landingShapingWeight"] == 500.0


def test_explicit_leaf_override_wins_over_the_hook():
    ov = ["hit_reward=500", "task.env.hitTableReward=7", "task.env.numEnvs=16"]
    got, want = compose("HumanoidPingpongTiltG1", ov), jax_compose("HumanoidPingpongTiltG1", ov)
    assert got["task"] == want["task"]
    assert got["task"]["env"]["hitTableReward"] == 7
    assert got["train"]["params"]["config"]["num_actors"] == 16


MULT = ["train.params.network.mlp.model_size_multiplier=2",
        "train.params.network.mlp.units=[16,8]", "num_envs=2", "device=cpu"]


@pytest.mark.parametrize("task", ["HumanoidPingpongTiltNoEarlyStopG1", "Humanoid12PingpongTiltG1"])
def test_preprocess_train_config_matches(task):
    got, want = compose(task, MULT), jax_compose(task, MULT)
    g, w = copy.deepcopy(preprocess_train_config(got)), copy.deepcopy(jax_preprocess(want))
    assert g["params"]["config"].pop("device") == "cpu"
    assert w["params"]["config"].pop("device") == "tpu"
    assert g == w
    assert g["params"]["network"]["mlp"]["units"] == [32, 16]


def test_multiplied_widths_equal_the_jax_trainer():
    import isaacgym_tpu
    import isaacgym_tpu_torch
    from isaacgym_tpu.rl.ppo import PPOConfig as JPPOConfig, PPOTrainer as JPPOTrainer
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    task = "HumanoidPingpongTiltNoEarlyStopG1"
    cfg, jcfg = compose(task, MULT), jax_compose(task, MULT)
    preprocess_train_config(cfg)
    jax_preprocess(jcfg)
    env = isaacgym_tpu_torch.make(seed=0, task=task, device="cpu", cfg=cfg["task"])
    ts = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0).init_state()
    jenv = isaacgym_tpu.make(seed=0, task=task, num_envs=2)
    jts = JPPOTrainer(jenv, JPPOConfig.from_train_cfg(jcfg["train"]), seed=0).init_state()
    jp = jts.params["params"]
    want = [jp["actor_mlp"][f"Dense_{i}"]["kernel"].shape[1] for i in range(len(jp["actor_mlp"]))]
    got = [layer.weight.shape[0] for layer in ts.params.actor_mlp.layers]
    assert got == want == [32, 16]


def test_launcher_trains_the_multiplied_net(tmp_path):
    from isaacgym_tpu_torch.train import main
    ts = main(["task=HumanoidPingpongTiltNoEarlyStopG1", "max_iterations=1", "experiment=mult",
               "train.params.config.minibatch_size=16", "train.params.config.horizon_length=4",
               "pbt.enabled=true"] + MULT, run_root=str(tmp_path))
    assert [l.weight.shape[0] for l in ts.params.actor_mlp.layers] == [32, 16]
    assert os.path.exists(tmp_path / "mult" / "pbt_objective.json")
