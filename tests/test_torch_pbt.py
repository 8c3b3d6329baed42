"""The port's PBT tool and C6 curriculum on the CPU.

* PBT (``python -m isaacgym_tpu_torch.pbt``) at 2 envs, population 3, two
  rounds of two epochs, as ``tests/test_rl_infra.py`` runs ``tools/pbt.py``:
  one member exploited each round, its lr explored off the donor's, the
  history and ``ckpt_best.pt`` written, and the best checkpoint restores.
  The initial lr spread and every exploit/explore choice follow the JAX
  tool's ``random.Random(seed)`` order (the same draws give the same lrs).
* A clone shares no tensor with its donor: the donor trains an epoch and
  the clone's parameters, Adam moments and normalizers keep their bits.
* The curriculum's stage table is ``tools/c6_curriculum.py``'s, and its
  ``--dry-run`` prints each stage's launcher command with the JAX tool's
  overrides.
"""

import json
import os
import random
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu_torch import c6_curriculum, pbt
from isaacgym_tpu_torch.rl import checkpoint as ckpt
from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
TASK = "HumanoidPingpongTiltNoEarlyStopG1"
ARGS = [f"task={TASK}", "experiment=pbt", "population=3", "rounds=2", "epochs_per_round=2",
        "num_envs=2", "device=cpu", "seed=3", "train.params.network.mlp.units=[8,8]",
        "train.params.config.minibatch_size=8", "train.params.config.horizon_length=4",
        "task.env.episodeLength=6"]


@pytest.fixture(scope="module")
def population(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pbt"))
    members, history, trainer = pbt.main(ARGS, run_root=root)
    assert trainer.env.num_envs == 2 and trainer.cfg.lr_schedule == "constant"
    return root, members, history


def test_pbt_exploits_and_explores(population):
    root, members, history = population
    rows = [json.loads(x) for x in open(os.path.join(root, "pbt", "pbt_history.jsonl"))]
    assert rows == history and len(rows) == 2
    assert all(len(r["objectives"]) == 3 and len(r["exploited"]) == 1 for r in rows)
    # the JAX tool's draws: the initial spread, then per round a donor and a factor
    rng = random.Random(3)
    lrs = [2e-5 * rng.choice([0.5, 0.8, 1.0, 1.25, 2.0]) for _ in range(3)]
    for r in rows:
        order = sorted(range(3), key=lambda i: r["objectives"][i], reverse=True)
        donor = rng.choice(order[:1])
        lrs[order[-1]] = max(1e-6, min(1e-2, lrs[donor] * rng.choice([0.8, 1.25])))
        assert r["lrs"] == pytest.approx(lrs)
        assert r["exploited"] == [order[-1]]
    assert [float(m["ts"].last_lr) for m in members] == pytest.approx(lrs)


def test_best_checkpoint_restores(population):
    root, members, _ = population
    from isaacgym_tpu_torch.utils.config import compose
    cfg = compose(TASK, [a for a in ARGS if a.split("=")[0] not in pbt.PBT_KEYS])
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, device="cpu", cfg=cfg["task"])
    fresh = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=9).init_state()
    back = ckpt.restore(os.path.join(root, "pbt", "ckpt_best.pt"), fresh)
    best = max(members, key=lambda m: m["objective"])["ts"]
    for a, b in zip(back.params.parameters(), best.params.parameters()):
        assert torch.equal(a, b)
    assert back.epoch == best.epoch == 4


def test_clone_holds_its_bits_while_the_donor_trains(population):
    _, members, _ = population
    from isaacgym_tpu_torch.utils.config import compose
    cfg = compose(TASK, [a for a in ARGS if a.split("=")[0] not in pbt.PBT_KEYS])
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, device="cpu", cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)
    donor = trainer.init_state()
    state, obs = env.reset()
    donor, state, obs, _ = trainer.train_epoch(donor, state, obs)
    clone = pbt.clone_train_state(donor, torch.Generator().manual_seed(1), 1e-4)

    def tensors(ts):
        return ([p.detach() for p in ts.params.parameters()] + list(ts.opt_state.mu)
                + list(ts.opt_state.nu) + list(ts.obs_stats) + list(ts.value_stats))
    ptrs = {t.data_ptr() for t in tensors(donor)}
    assert not ptrs & {t.data_ptr() for t in tensors(clone)}
    kept = [t.clone() for t in tensors(clone)]
    donor, state, obs, _ = trainer.train_epoch(donor, state, obs)
    assert all(torch.equal(a, b) for a, b in zip(tensors(clone), kept))
    assert not all(torch.equal(a, b) for a, b in zip(tensors(donor), kept))
    assert float(clone.last_lr) == pytest.approx(1e-4) and clone.rng is not donor.rng


def test_curriculum_stages_and_dry_run(tmp_path):
    import c6_curriculum as jax_c6
    assert c6_curriculum.build_stages() == jax_c6.build_stages()
    out = subprocess.run([sys.executable, "-m", "isaacgym_tpu_torch.c6_curriculum", "c6dry",
                          "--dry-run", "--device", "cpu"], cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    cmds = [line.split() for line in out if "isaacgym_tpu_torch.train" in line]
    assert len(cmds) == len(jax_c6.build_stages())
    stages = json.load(open(tmp_path / "runs" / "c6dry" / "stages.json"))
    for i, (cmd, st) in enumerate(zip(cmds, stages)):
        assert f"landing_shaping={st['shaping']}" in cmd
        assert f"task.env.scene.ballRestitution={st['restitution']}" in cmd
        assert f"max_iterations={st['end_epoch']}" in cmd and "device=cpu" in cmd
        # a dry run trains nothing, so every stage names the warm start (as the JAX tool)
        assert f"checkpoint={c6_curriculum.WARM_START}" in cmd
