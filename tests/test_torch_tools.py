"""The port's last tools against the JAX package's, on the CPU.

* ``profile_ppo``: its FLOP counts, from the parameter shapes, against
  ``torch.utils.flop_counter.FlopCounterMode`` (a policy forward exactly;
  a minibatch's loss and gradients exactly three forwards less the first
  layer's input gradient, which the update never takes), on a short CPU
  run whose report carries every key and no MFU (no card).
* ``probe_ball``: from a JAX env's reset carried across with ``interop``,
  the port's zero-action roll of 8 envs over 100 steps (the first episode,
  170 steps long, does not end) gives the JAX tool's arrival statistics
  (the JAX tool resets the same env from the same seed): the cross rate
  and crossing step exactly, the positions, speeds and distances at the
  crossing within 2e-3, spins within 2e-2 rad/s and the mean reward within
  1e-3 relative.
* ``distill_run``: on the same run directory, the port's file is the JAX
  tool's byte for byte.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import jax

import isaacgym_tpu

from isaacgym_tpu_torch import distill_run, probe_ball, profile_ppo
from isaacgym_tpu_torch.interop import env_state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
TASK = "HumanoidPingpongTiltNoEarlyStopG1"


def test_profile_ppo_flops_match_the_flop_counter():
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose
    cfg = compose(TASK, ["num_envs=4", "device=cpu", "train.params.network.mlp.units=[48,24]",
                         "train.params.config.horizon_length=4"])
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, device="cpu", cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)
    ts = trainer.init_state()
    state, obs = env.reset()
    _, _, batch, obs_stats, _, _ = trainer._rollout_and_gae(ts, state, obs)
    fwd = profile_ppo.fwd_flops_per_sample(ts.params)
    units = [80, 48, 24]
    want = 2 * (2 * sum(a * b for a, b in zip(units, units[1:])) + 24 * 7 + 24 * 1)
    assert fwd == want
    c_fwd, c_mb = profile_ppo.counted_flops(trainer, ts, batch, obs_stats, 16)
    assert c_fwd == 16 * fwd
    first_layer_input_grad = 2 * 2 * 80 * 48     # both trunks' first layers
    assert c_mb == 16 * (3 * fwd - first_layer_input_grad)


def test_profile_ppo_report_on_the_cpu():
    rep = profile_ppo.profile(TASK, 4, ["train.params.network.mlp.units=[16,8]",
                                        "train.params.config.horizon_length=4",
                                        "train.params.config.minibatch_size=8"],
                              device="cpu", repeats=1)
    assert rep["device"] == "cpu" and "mfu_update_analytic" not in rep
    assert rep["samples_per_epoch"] == 16 and rep["num_minibatches"] == 2
    assert rep["flops_analytic_update"] == 5 * 2 * 8 * 3.0 * rep["net_fwd_flops_per_sample"]
    assert rep["flops_counter_fwd_per_sample"] == rep["net_fwd_flops_per_sample"]
    assert all(rep[k] > 0 for k in ("t_rollout_s", "t_update_s", "t_epoch_s"))


def test_probe_ball_matches_the_jax_tool(capsys):
    import probe_ball as jax_probe
    jax_probe.main(["--envs", "8", "--steps", "100", "--device", "cpu", "--seed", "1"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    import isaacgym_tpu_torch
    jenv = isaacgym_tpu.make(seed=1, task=TASK, num_envs=8)
    jstate, _ = jenv.reset()
    s = jax.tree.map(np.asarray, jstate)
    state = env_state_from_numpy(dict(sim=dict(s.sim._asdict()), progress=s.progress,
                                      flags=dict(s.flags), pre_ball_root=s.pre_ball_root,
                                      ep_return=s.ep_return))
    env = isaacgym_tpu_torch.make(seed=1, task=TASK, num_envs=8, device="cpu")
    got = probe_ball.probe(env, state, 100, TASK)
    assert set(got) == set(want) | {"route", "kernel_launches"}
    # on the CPU the wrappers run their plain versions: no kernel launches
    assert got["kernel_launches"] == {"fused_substep": 0, "fused_substep_dr": 0}
    assert (got["envs"], got["steps"]) == (8, 100) and got["cross_rate"] > 0.5
    for k in ("cross_rate", "t_cross_med", "dropped_rate", "task"):
        assert got[k] == want[k], k
    for k, tol in (("y_cross", 2e-3), ("z_cross", 2e-3), ("vx_cross", 2e-3),
                   ("gauss_d_yz", 2e-3), ("paddle_xyz0", 1e-5), ("spin_at_cross", 2e-2),
                   ("max_spin_rad_s", 2e-2), ("gauss_reward_med", 2e-3)):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    np.testing.assert_allclose(got["reward_mean"], want["reward_mean"], rtol=1e-3)


def test_distill_run_writes_the_jax_tools_file(tmp_path):
    import distill_run as jax_distill
    run = tmp_path / "runs" / "r1"
    os.makedirs(run)
    rng = np.random.RandomState(2)
    with open(run / "metrics.jsonl", "w") as f:
        for epoch in range(37):
            row = {"epoch": epoch, "episode_count": float(rng.rand() < 0.3),
                   "reward_mean": float(rng.randn()), "kl": float(rng.rand()),
                   "a_loss": float(rng.randn()), "event_hit_paddle_rate": float(rng.rand())}
            f.write(json.dumps(row) + "\n")
        f.write("\n")
    with open(run / "config.json", "w") as f:
        json.dump({"task_name": TASK, "seed": 3}, f)
    a = jax_distill.distill(str(run), 5, out_dir=str(tmp_path / "jax"))
    b = distill_run.distill(str(run), 5, out_dir=str(tmp_path / "port"))
    for name in ("r1.jsonl", "r1.config.json"):
        with open(tmp_path / "jax" / name, "rb") as x, open(tmp_path / "port" / name, "rb") as y:
            assert x.read() == y.read(), name
    assert os.path.basename(a) == os.path.basename(b) == "r1.jsonl"
