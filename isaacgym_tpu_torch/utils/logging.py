"""Training telemetry (``isaacgym_tpu/utils/logging.py``): the JSONL
observer only, one line per logged epoch in ``<run_dir>/metrics.jsonl`` with
the keys of the JAX package's runs (``epoch``, ``episode_return_mean``,
``episode_length_mean``, ``episode_count``, ``reward_mean``, ``kl``,
``last_lr``, ``env_steps_per_s``, ``event_*_rate``), so a run of the port can
be laid beside a JAX curve such as ``docs/runs/c7_r5_exact.jsonl``."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

#: the keys every line carries, besides ``event_*_rate``
LINE_KEYS = ("episode_return_mean", "episode_length_mean", "episode_count",
             "reward_mean", "kl", "last_lr", "env_steps_per_s")


class JsonlObserver:
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
