"""The port's observers (``utils/logging.py``) against the JAX package's.

Both stacks (episode stats, JSONL, PBT, console, W&B and the fan-out) take
the same per-step infos, drawn from a seed with numpy, and the same metrics
for six epochs. Their episode stats, their ``pbt_objective.json`` and their
console lines are equal; each port ``metrics.jsonl`` line equals the JAX
line on the port's keys (``LINE_KEYS`` and the ``event_*_rate`` keys; the
JAX line also carries a wall-clock ``time`` and every other metric). The W&B
observer does nothing without ``wandb`` (it is not installed here) and
nothing on a rank other than 0.
"""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

from isaacgym_tpu.utils import logging as JL

from isaacgym_tpu_torch.utils import logging as L


def _stack(mod, run_dir, interval):
    return mod.MultiObserver([mod.EpisodeStatsObserver(games_to_track=20), mod.JsonlObserver(),
                              mod.PbtObserver(interval=interval),
                              mod.ConsoleObserver(interval=interval),
                              mod.WandbObserver(project="p", name="n", rank=0)])


def test_observers_write_what_the_jax_observers_write(tmp_path, capsys):
    rng = np.random.RandomState(11)
    runs = {}
    for name, mod in (("jax", JL), ("port", L)):
        run_dir = str(tmp_path / name)
        obs = _stack(mod, run_dir, interval=2)
        obs.after_init(run_dir, {"task_name": "t"})
        rng = np.random.RandomState(11)
        stats, objectives = [], []
        for epoch in range(6):
            for _ in range(4):
                done = rng.rand(16) < 0.3
                obs.process_infos({"episode_done": done,
                                   "episode_return": rng.normal(50.0, 20.0, 16) * done,
                                   "episode_length": rng.randint(1, 170, 16) * done})
            metrics = {k: float(v) for k, v in zip(
                ("episode_count", "reward_mean", "kl", "last_lr", "env_steps_per_s",
                 "event_hit_paddle_rate", "event_missed_ball_rate", "a_loss"),
                rng.uniform(0.0, 2.0, 8))}
            obs.after_epoch(epoch, metrics)
            stats.append(dict(metrics))
            path = os.path.join(run_dir, "pbt_objective.json")
            objectives.append(open(path).read() if os.path.exists(path) else None)
        obs.close()
        lines = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
        runs[name] = dict(stats=stats, objectives=objectives, lines=lines,
                          console=capsys.readouterr().out)
    j, p = runs["jax"], runs["port"]
    assert p["stats"] == j["stats"]
    assert p["objectives"] == j["objectives"] and p["objectives"][0] is not None
    assert p["console"] == j["console"] and p["console"].count("epoch") == 3
    assert len(p["lines"]) == len(j["lines"]) == 6
    for pl, jl in zip(p["lines"], j["lines"]):
        assert set(pl) == {"epoch", *L.LINE_KEYS, "event_hit_paddle_rate",
                           "event_missed_ball_rate"}
        assert pl == {k: jl[k] for k in pl}
    assert p["stats"][-1]["episodes_tracked"] == 20.0


def test_observer_hooks_match():
    for cls in ("AlgoObserver", "EpisodeStatsObserver", "ConsoleObserver", "JsonlObserver",
                "WandbObserver", "PbtObserver", "MultiObserver"):
        for hook in ("after_init", "process_infos", "after_epoch", "close"):
            assert hasattr(getattr(L, cls), hook) and hasattr(getattr(JL, cls), hook)


@pytest.mark.parametrize("rank", [0, 1])
def test_wandb_observer_is_inert_without_wandb_or_off_rank_zero(tmp_path, rank):
    w = L.WandbObserver(project="p", name="n", rank=rank)
    w.after_init(str(tmp_path), {})
    w.after_epoch(0, {"kl": 1.0})
    w.close()
    assert w._run is None and os.listdir(tmp_path) == []
