"""C6 (``HumanoidPingpongTiltG1``) gradual-anneal curriculum on the port
(``tools/c6_curriculum.py``'s stage table and rules).

A physics staircase (``ballRestitution`` 0.3 -> 1.5 and the launch speed
[5.5, 6.1] -> [8.0, 8.6] over many small stages) with the dense landing
shaping (the ``landing_shaping`` root hook, the task's
``landingShapingWeight``) held on through it and annealed to zero at the
end, so the last stage trains on the reference reward at the reference
physics. Each stage is a fresh ``python -m isaacgym_tpu_torch.train`` that
resumes from the previous stage's ``ckpt_final.pt`` into one shared
experiment directory, whose ``metrics.jsonl`` is the curve. The first stage
starts from :data:`WARM_START`, a port checkpoint made from the JAX run's
orbax checkpoint by ``tools/torch_ckpt_from_orbax.py``.

    python -m isaacgym_tpu_torch.c6_curriculum [experiment] [--dry-run] [--device cpu]

``--dry-run`` writes ``stages.json`` and prints each stage's command
without running it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TASK = "HumanoidPingpongTiltG1"
#: the JAX run's epoch-3500 checkpoint (paddle 0.93 at e=0.3), converted with
#: ``tools/torch_ckpt_from_orbax.py runs/c6_r4_curr/ckpt_0003500 WARM_START``
WARM_START = "runs/c6_r4_curr/ckpt_0003500.pt"
WARM_EPOCH = 3500
NUM_ENVS = 4096
SEED = 7
LR = 1e-4

# physics endpoints: soft curriculum stage (round-4 phase A) -> reference
# (cfg/task/HumanoidPingpongTiltG1.yaml: ballRestitution 1.5, speed 8.0-8.6)
E_SOFT, E_REF = 0.3, 1.5
LO_SOFT, LO_REF = 5.5, 8.0
HI_SOFT, HI_REF = 6.1, 8.6
N_HARDEN = 12          # 0.1 restitution / 0.21 m/s per step
SHAPING = 500.0


def build_stages():
    stages = []
    # stage 0: learn the shaping gradient at the soft physics the warm-start
    # checkpoint was trained on
    stages.append(dict(epochs=800, f=0.0, shaping=SHAPING))
    for k in range(1, N_HARDEN + 1):
        stages.append(dict(epochs=400, f=k / N_HARDEN, shaping=SHAPING))
    # Reference physics reached: consolidate, then anneal the shaping away
    # GRADUALLY and hold on the pure reference reward. (Round-5 in-flight
    # observation: each 400-epoch hardening stage re-tunes crossing quickly
    # but the landing band needs a longer fixed-physics window — the
    # breakthrough at e=1.0 took the full stage; at e>=1.2 400 epochs was
    # not enough, so the consolidation lives here.)
    stages.append(dict(epochs=1000, f=1.0, shaping=SHAPING))
    stages.append(dict(epochs=800, f=1.0, shaping=SHAPING * 0.4))
    stages.append(dict(epochs=1200, f=1.0, shaping=0.0))
    for st in stages:
        f = st["f"]
        st["restitution"] = round(E_SOFT + f * (E_REF - E_SOFT), 4)
        st["speed_lo"] = round(LO_SOFT + f * (LO_REF - LO_SOFT), 3)
        st["speed_hi"] = round(HI_SOFT + f * (HI_REF - HI_SOFT), 3)
    return stages


def last_logged_epoch(metrics_path):
    last = 0
    if os.path.exists(metrics_path):
        with open(metrics_path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        last = max(last, int(json.loads(line).get("epoch", 0)))
                    except json.JSONDecodeError:
                        pass
    return last


def stage_command(exp, st, ckpt, device="cuda"):
    """The launcher command of one stage."""
    return [
        sys.executable, "-m", "isaacgym_tpu_torch.train", f"task={TASK}", f"experiment={exp}",
        f"num_envs={NUM_ENVS}", f"seed={SEED}", f"device={device}",
        f"max_iterations={st['end_epoch']}",
        f"train.params.config.learning_rate={LR}",
        f"task.env.scene.ballRestitution={st['restitution']}",
        f"task.env.ball.initialSpeedRange=[{st['speed_lo']},{st['speed_hi']}]",
        f"landing_shaping={st['shaping']}",
        f"checkpoint={ckpt}",
    ]


def main(argv, run_root: str = "runs"):
    ap = argparse.ArgumentParser(description="C6 curriculum on the port")
    ap.add_argument("experiment", nargs="?", default="c6_r5_anneal")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    exp, dry, device = args.experiment, args.dry_run, args.device
    run_dir = os.path.join(run_root, exp)
    os.makedirs(run_dir, exist_ok=True)

    cum = WARM_EPOCH
    manifest = []
    for i, st in enumerate(build_stages()):
        st = dict(st, start_epoch=cum, end_epoch=cum + st["epochs"], stage=i)
        cum = st["end_epoch"]
        manifest.append(st)
    with open(os.path.join(run_dir, "stages.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)

    done_epoch = last_logged_epoch(os.path.join(run_dir, "metrics.jsonl"))
    ckpt = WARM_START
    final_ckpt = os.path.join(run_dir, "ckpt_final.pt")
    for st in manifest:
        if st["end_epoch"] <= done_epoch:
            print(f"stage {st['stage']} already complete (epoch {st['end_epoch']})")
            ckpt = final_ckpt
            continue
        # resume mid-stage from the shared dir if any progress was logged
        if done_epoch > WARM_EPOCH:
            ckpt = final_ckpt
        cmd = stage_command(exp, st, ckpt, device)
        print(f"=== stage {st['stage']}: e={st['restitution']} "
              f"speed=[{st['speed_lo']},{st['speed_hi']}] w={st['shaping']} "
              f"epochs {st['start_epoch']}->{st['end_epoch']}", flush=True)
        print(" ".join(cmd), flush=True)
        if dry:
            continue
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            print(f"stage {st['stage']} FAILED rc={rc}", flush=True)
            return rc
        ckpt = final_ckpt
        done_epoch = st["end_epoch"]
    print("curriculum complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
