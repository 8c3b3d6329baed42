"""PPO epoch profiler (``tools/profile_ppo.py`` on the port): the epoch and
its rollout and update halves timed apart, the matmul FLOPs, and the MFU.

* Times: the rollout with GAE (``PPOTrainer._rollout_and_gae``) and the
  update (``PPOTrainer._update``), each the least of ``--repeats`` runs, and
  whole ``train_epoch`` calls; host clock around work that ends in a
  synchronize. The update changes the state in place, so the repeats train
  on.
* FLOPs: counted from the parameter shapes (a forward is 2 x in x out per
  Linear and sample; the rollout is a forward of each of the ``H x B``
  samples, the update three forwards' worth of each minibatch sample per
  mini-epoch), and cross-checked with ``torch.utils.flop_counter.
  FlopCounterMode`` on one policy forward and one minibatch's loss and
  gradients (where the JAX tool reads XLA's ``cost_analysis``). The counter
  leaves out the first layer's input gradient, which the update never takes.
* MFU: the analytic FLOPs over the time, against the card's dense bf16 peak
  (989 TFLOP/s for an H100 SXM at 700 W), with the card's name and power
  limit from ``nvidia-smi`` beside it. A CPU run (``--device cpu``) reports
  its counts and times, and no MFU.

    python -m isaacgym_tpu_torch.profile_ppo [--num-envs 4096] [--task T]
        [--device cuda|cpu] [--trace] [key=value ...]

``--trace`` records one epoch with ``torch.profiler`` into
``build/profile_ppo/trace.json`` (Chrome trace format). Prints one JSON
line, with each kernel wrapper's launches over the whole run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

#: dense bf16 peak of one H100 SXM at its full power limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = {"H100": 989e12}
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "profile_ppo")


def fwd_flops_per_sample(net) -> float:
    """2 x in x out over every Linear of the actor-critic."""
    return float(sum(2.0 * m.weight.shape[0] * m.weight.shape[1]
                     for m in net.modules() if isinstance(m, torch.nn.Linear)))


def counted_flops(trainer, ts, batch, obs_stats, n: int):
    """FlopCounterMode's FLOPs of one policy forward over ``n`` samples and
    of one minibatch's loss with its gradients."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        trainer._policy(ts.params, obs_stats, batch["obs"][:n])
    fwd = fc.get_total_flops()
    mb = {k: v[:n] for k, v in batch.items()}
    with FlopCounterMode(display=False) as fc:
        total, _ = trainer.loss(ts.params, obs_stats, mb)
        torch.autograd.grad(total, list(ts.params.parameters()))
    return fwd, fc.get_total_flops()


def card() -> str:
    """``name, power limit`` from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed(fn, sync, repeats):
    best, out = float("inf"), None
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def profile(task: str, num_envs: int, overrides=(), device: str = "cuda", repeats: int = 3,
            trace: bool = False) -> dict:
    from isaacgym_tpu_torch.make import make
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
    cfg = compose(task, [f"num_envs={num_envs}", f"device={device}", *overrides])
    preprocess_train_config(cfg)
    env = make(seed=0, task=task, device=device, cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)
    pcfg = trainer.cfg
    sync = torch.cuda.synchronize if env.device.type == "cuda" else (lambda: None)
    ts = trainer.init_state()
    state, obs = env.reset()

    B, H = env.num_envs, pcfg.horizon_length
    T = B * H
    mb = min(pcfg.minibatch_size, T)
    num_mb = T // mb

    def rollout():
        return trainer._rollout_and_gae(ts, state, obs)
    rollout()   # warm-up (builds the kernels on first use)
    t_roll, roll = _timed(rollout, sync, repeats)
    _, _, batch, obs_stats, _, _ = roll
    t_upd, _ = _timed(lambda: trainer._update(ts, batch, obs_stats), sync, repeats)

    epoch_s = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        ts, state, obs, _m = trainer.train_epoch(ts, state, obs)
        sync()
        epoch_s.append(time.perf_counter() - t0)
    t_epoch = min(epoch_s)

    trace_path = None
    if trace:
        from torch.profiler import ProfilerActivity, profile as tprofile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if env.device.type == "cuda" else [])
        with tprofile(activities=acts) as prof:
            ts, state, obs, _m = trainer.train_epoch(ts, state, obs)
            sync()
        os.makedirs(TRACE_DIR, exist_ok=True)
        trace_path = os.path.join(TRACE_DIR, "trace.json")
        prof.export_chrome_trace(trace_path)

    fwd = fwd_flops_per_sample(ts.params)
    flops_rollout = T * fwd
    flops_update = pcfg.mini_epochs * num_mb * mb * 3.0 * fwd
    c_fwd, c_mb = counted_flops(trainer, ts, batch, obs_stats, mb)
    report = {
        "task": task, "num_envs": B, "horizon": H, "samples_per_epoch": T,
        "minibatch": mb, "num_minibatches": num_mb, "mini_epochs": pcfg.mini_epochs,
        "device": (torch.cuda.get_device_name(env.device) if env.device.type == "cuda"
                   else "cpu"),
        "t_rollout_s": t_roll, "t_update_s": t_upd, "t_epoch_s": t_epoch,
        "update_frac_of_epoch": t_upd / t_epoch,
        "env_steps_per_s": T / t_epoch,
        "net_fwd_flops_per_sample": fwd,
        "flops_analytic_rollout": flops_rollout,
        "flops_analytic_update": flops_update,
        "flops_counter_fwd_per_sample": c_fwd / mb,
        "flops_counter_update": c_mb * pcfg.mini_epochs * num_mb,
        "tflops_per_s_update_analytic": flops_update / t_upd / 1e12,
        "tflops_per_s_epoch_analytic": (flops_rollout + flops_update) / t_epoch / 1e12,
    }
    report["kernel_launches"] = env.sim.kernel_launches()
    if env.device.type == "cuda":
        report["card"] = card()
        peak = next((v for k, v in PEAK_BF16_FLOPS.items() if k in report["device"]), None)
        if peak:
            report["peak_bf16_tflops"] = peak / 1e12
            report["mfu_update_analytic"] = flops_update / t_upd / peak
            report["mfu_epoch_analytic"] = (flops_rollout + flops_update) / t_epoch / peak
    if trace_path:
        report["trace"] = trace_path
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="PPO epoch profiler on the port")
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--task", default="HumanoidPingpongTiltNoEarlyStopG1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--trace", action="store_true")
    args, overrides = ap.parse_known_args(argv)
    report = profile(args.task, args.num_envs, overrides, args.device, args.repeats, args.trace)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
