"""The port's launcher, checkpoints and player on the CPU.

``python -m isaacgym_tpu_torch.train`` at 128 envs with tiny nets (units
[64, 32]) and DR on, for two epochs; then the checkpoint it wrote restores
into a fresh trainer bit for bit, and ``test=true`` plays whole episodes
from it (with a 20-step episode, so the play stays short on the CPU).
"""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu_torch.rl import checkpoint as ckpt
from isaacgym_tpu_torch.rl.player import play, resolve_hit_flag
from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from isaacgym_tpu_torch.train import main
from isaacgym_tpu_torch.utils.config import compose
from isaacgym_tpu_torch.utils.logging import LINE_KEYS

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
TINY = ["train.params.network.mlp.units=[64,32]", "train.params.config.minibatch_size=1024"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    ts = main([f"task={TASK}", "task.randomize=true", "num_envs=128", "max_iterations=2",
               "device=cpu", "seed=3", "experiment=tiny"] + TINY, run_root=root)
    return root, ts


def test_launcher_trains_two_epochs(trained):
    root, ts = trained
    run = os.path.join(root, "tiny")
    assert ts.epoch == 2 and ts.opt_state.count == 2 * 5 * 4   # 4 minibatches x 5
    assert os.path.exists(os.path.join(run, "ckpt_final.pt"))
    cfg = json.load(open(os.path.join(run, "config.json")))
    assert cfg["task"]["task"]["randomize"] is True and cfg["task"]["env"]["numEnvs"] == 128
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [x["epoch"] for x in lines] == [0, 1]
    for x in lines:
        assert set(LINE_KEYS) <= set(x)
        assert {"event_hit_paddle_rate", "event_missed_ball_rate"} <= set(x)
        assert all(np.isfinite(v) for v in x.values())
    assert all(torch.isfinite(p).all() for p in ts.params.parameters())


def test_checkpoint_round_trip(trained, tmp_path):
    root, ts = trained
    cfg = compose(TASK, ["num_envs=8", "device=cpu"] + TINY)
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, device="cpu", cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=99)
    fresh = trainer.init_state()
    back = ckpt.restore(os.path.join(root, "tiny", "ckpt_final.pt"), fresh)
    obs = torch.randn(8, env.num_obs, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mu_a = trainer._policy(ts.params, ts.obs_stats, obs)[0]
        mu_b = trainer._policy(back.params, back.obs_stats, obs)[0]
    assert torch.equal(mu_a, mu_b)
    for a, b in zip(ts.params.state_dict().values(), back.params.state_dict().values()):
        assert torch.equal(a, b)
    assert back.epoch == ts.epoch and back.opt_state.count == ts.opt_state.count
    for a, b in zip(ts.opt_state.mu + ts.opt_state.nu, back.opt_state.mu + back.opt_state.nu):
        assert torch.equal(a, b)
    for a, b in zip(ts.obs_stats + ts.value_stats, back.obs_stats + back.value_stats):
        assert torch.equal(a, b)
    assert torch.equal(ts.last_lr, back.last_lr)
    assert torch.equal(ts.rng.get_state(), back.rng.get_state())
    # and a save of the restored state is the same file content again
    ckpt.save(str(tmp_path / "again.pt"), back)
    again = ckpt.restore(str(tmp_path / "again.pt"), trainer.init_state())
    assert all(torch.equal(a, b) for a, b in zip(back.params.state_dict().values(),
                                                 again.params.state_dict().values()))


def test_play_from_the_checkpoint(trained):
    root, _ = trained
    stats = main([f"task={TASK}", "num_envs=16", "device=cpu", "test=true", "episodes=1",
                  "task.env.episodeLength=20", "experiment=play",
                  f"checkpoint={os.path.join(root, 'tiny', 'ckpt_final.pt')}"] + TINY,
                 run_root=root)
    assert stats["episodes"] == 16 and stats["steps"] == 19
    assert np.isfinite(stats["return_mean"]) and 0.0 <= stats["hit_rate"] <= 1.0


def test_play_with_sigma_and_the_hit_flag():
    cfg = compose(TASK, ["num_envs=4", "device=cpu", "task.env.episodeLength=6"] + TINY)
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, device="cpu", cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)
    ts = trainer.init_state()
    assert resolve_hit_flag(env, env.reset()[0].flags) == "paddle_condition_calculated"
    stats = play(env, trainer, ts, episodes=2, sigma=0.3, seed=1)
    assert stats["episodes"] == 8 and stats["steps"] == 10   # 5 steps an episode
    assert np.isfinite(stats["return_mean"])
