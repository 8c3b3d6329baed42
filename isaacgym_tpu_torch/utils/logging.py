"""Training telemetry: the observers of ``isaacgym_tpu/utils/logging.py``.

The rl_games observer stack the reference wires into its launcher:
episode-stat aggregation (``RLGPUAlgoObserver``), multi-observer fan-out,
W&B logging gated to rank 0 (``WandbAlgoObserver``) and the PBT observer
hook. Observers take plain metric dicts once per logged epoch and numpy env
infos per step. :class:`JsonlObserver` writes one line per logged epoch in
``<run_dir>/metrics.jsonl`` with the keys of the JAX package's runs
(``epoch``, ``episode_return_mean``, ``episode_length_mean``,
``episode_count``, ``reward_mean``, ``kl``, ``last_lr``,
``env_steps_per_s``, ``event_*_rate``), so a run of the port can be laid
beside a JAX curve such as ``docs/runs/c7_r5_exact.jsonl``.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List

import numpy as np


class AlgoObserver:
    """Base observer interface (after_init / process_infos / after_print_stats)."""

    def after_init(self, run_dir: str, cfg: Dict[str, Any]) -> None:
        pass

    def process_infos(self, infos: Dict[str, Any]) -> None:
        """Called with per-step env infos (numpy arrays)."""

    def after_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


class EpisodeStatsObserver(AlgoObserver):
    """Aggregates completed-episode returns/lengths (RLGPUAlgoObserver parity):
    keeps a sliding window like rl_games' ``games_to_track``."""

    def __init__(self, games_to_track: int = 100):
        self.returns = deque(maxlen=games_to_track)
        self.lengths = deque(maxlen=games_to_track)

    def process_infos(self, infos: Dict[str, Any]) -> None:
        done = np.asarray(infos.get("episode_done", ()))
        if done.size and done.any():
            self.returns.extend(np.asarray(infos["episode_return"])[done].tolist())
            self.lengths.extend(np.asarray(infos["episode_length"])[done].tolist())

    def stats(self) -> Dict[str, float]:
        if not self.returns:
            return {}
        return {
            "episode_return_mean": float(np.mean(self.returns)),
            "episode_return_std": float(np.std(self.returns)),
            "episode_length_mean": float(np.mean(self.lengths)),
            "episodes_tracked": float(len(self.returns)),
        }

    def after_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        metrics.update(self.stats())


class ConsoleObserver(AlgoObserver):
    def __init__(self, interval: int = 10):
        self.interval = interval

    def after_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        if epoch % self.interval:
            return
        parts = "  ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items()))
        print(f"epoch {epoch:6d}  {parts}", flush=True)


#: the keys every line carries, besides ``event_*_rate``
LINE_KEYS = ("episode_return_mean", "episode_length_mean", "episode_count",
             "reward_mean", "kl", "last_lr", "env_steps_per_s")


class JsonlObserver(AlgoObserver):
    """Writes one JSON line per logged epoch to ``<run_dir>/metrics.jsonl``."""

    def __init__(self):
        self._fh = None

    def after_init(self, run_dir: str, cfg: Dict[str, Any]) -> None:
        os.makedirs(run_dir, exist_ok=True)
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def after_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        if self._fh is None:
            return
        line = {"epoch": epoch, **{k: float(metrics[k]) for k in LINE_KEYS},
                **{k: float(v) for k, v in sorted(metrics.items())
                   if k.startswith("event_") and k.endswith("_rate")}}
        self._fh.write(json.dumps(line) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class WandbObserver(AlgoObserver):
    """W&B logging, active only when wandb is importable and rank == 0
    (the reference launcher's gating). Without ``wandb``, or where
    ``wandb.init`` fails (no network), it does nothing."""

    def __init__(self, project: str, name: str, entity: str = "", group: str = "",
                 rank: int = 0):
        self._run = None
        if rank != 0:
            return
        try:
            import wandb  # noqa: F401
            self._wandb = wandb
            self._init_args = dict(project=project, name=name,
                                   entity=entity or None, group=group or None)
        except ImportError:
            self._wandb = None

    def after_init(self, run_dir: str, cfg: Dict[str, Any]) -> None:
        if getattr(self, "_wandb", None) is None:
            return
        try:
            self._run = self._wandb.init(config=cfg, **self._init_args)
        except Exception as exc:  # offline/zero-egress: degrade gracefully
            print(f"[wandb] disabled: {exc}")
            self._run = None

    def after_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        if self._run is not None:
            self._run.log(metrics, step=epoch)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


class PbtObserver(AlgoObserver):
    """Population-based-training hook (the reference's ``PbtAlgoObserver``
    surface): writes the objective every ``interval`` epochs to
    ``<run_dir>/pbt_objective.json`` for an external PBT scheduler."""

    def __init__(self, interval: int = 100, objective_key: str = "episode_return_mean"):
        self.interval = interval
        self.objective_key = objective_key
        self.run_dir = ""

    def after_init(self, run_dir: str, cfg: Dict[str, Any]) -> None:
        self.run_dir = run_dir

    def after_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        if epoch % self.interval or not self.run_dir:
            return
        with open(os.path.join(self.run_dir, "pbt_objective.json"), "w") as f:
            json.dump({"epoch": epoch,
                       "objective": metrics.get(self.objective_key, float("nan"))}, f)


class MultiObserver(AlgoObserver):
    """Fan-out to several observers (the reference's ``MultiObserver``)."""

    def __init__(self, observers: List[AlgoObserver]):
        self.observers = observers

    def after_init(self, run_dir, cfg):
        for o in self.observers:
            o.after_init(run_dir, cfg)

    def process_infos(self, infos):
        for o in self.observers:
            o.process_infos(infos)

    def after_epoch(self, epoch, metrics):
        for o in self.observers:
            o.after_epoch(epoch, metrics)

    def close(self):
        for o in self.observers:
            o.close()
