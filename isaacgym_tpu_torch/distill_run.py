"""Distill a training run's ``metrics.jsonl`` into a tracked evidence file
(``tools/distill_run.py`` on the port: the same rows and the same file).

``runs/`` is gitignored (checkpoints are large), so a learning curve dies
with the working tree. This copies the learning-relevant subset of a run's
``metrics.jsonl`` (every Nth row, and every row where episodes finished,
with its key fields and every ``event_*`` rate) into
``docs/runs/<name>.jsonl``, and its ``config.json`` beside it.

    python -m isaacgym_tpu_torch.distill_run runs/<experiment> [stride]
"""

from __future__ import annotations

import json
import os
import sys

KEYS = ("epoch", "episode_return_mean", "episode_length_mean",
        "episode_count", "reward_mean", "kl", "last_lr", "env_steps_per_s")
# every per-episode event rate survives distillation (C6 needs
# hit_opponent_table/cross_net, C7 hit_paddle/missed_ball, C10 fall/hit)


def _keep(row):
    out = {k: row[k] for k in KEYS if k in row}
    out.update({k: v for k, v in row.items() if k.startswith("event_")})
    return out


def distill(run_dir: str, stride: int = 10, out_dir: str = "docs/runs") -> str:
    name = os.path.basename(os.path.normpath(run_dir))
    stride = max(1, stride)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{name}.jsonl")
    n_in = n_out = 0
    with open(os.path.join(run_dir, "metrics.jsonl")) as f, \
            open(out_path, "w") as out:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            n_in += 1
            # keep strided rows and every row where episodes completed
            if row.get("epoch", 0) % stride and not row.get("episode_count"):
                continue
            out.write(json.dumps(_keep(row)) + "\n")
            n_out += 1
    cfg = os.path.join(run_dir, "config.json")
    if os.path.exists(cfg):
        with open(cfg) as f:
            meta = json.load(f)
        with open(os.path.join(out_dir, f"{name}.config.json"), "w") as out:
            json.dump(meta, out, indent=1)
    print(f"{out_path}: kept {n_out}/{n_in} rows")
    return out_path


if __name__ == "__main__":
    distill(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 10)
