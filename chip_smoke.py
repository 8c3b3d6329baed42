#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds:
  device  the card's name, and its name and power limit from nvidia-smi;
  build   nvcc builds csrc/*.cu into build/kernels/ (and g++ the host loop
          that counts the kernel's operations), wall seconds;
  k2/*    the fused-substep kernel against its plain PyTorch version on the
          card, B = 4096, one substep from each state set (reset, rollout
          after 60 steps, paddle_ball, paddle_table, ball_rest): max abs
          deviation per output over envs whose contact pattern agrees, and
          the flip rate, gated at the CPU tests' tolerances;
  timing  K2 per launch (CUDA events, median of 15 repeats of 20 launches)
          beside the plain version and the bound (bytes over 3.35 TB/s vs
          counted FP32 operations over 67 TFLOP/s, the larger);
  main    make(seed=0, flagship, 4096 envs), reset, 5 warm-up steps, then
          3 windows of 100 steps under uniform actions in [-1, 1] from a
          seeded generator: launches must be exactly 2 per step, every
          state finite, and some ball must bounce (z below 0.85, then up);
          env-steps/s and ms per step per window;
  profile torch.profiler over 10 more steps: device busy share, device
          kernels per step, K2's share, the top kernels by device time.
Then the kernels line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with
no CUDA device, or run outside the repository, it exits non-zero at once.
"""

import json
import os
import statistics
import subprocess
import sys
import time

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 4096
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, non-tensor
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3)
MAX_FLIP_RATE = 0.002


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(got, want):
    """Max deviation per output over envs with the same contact pattern, and
    the share of envs whose pattern differs (flips)."""
    import torch
    fa = got.impulses.abs().sum(-1) > 0
    fb = want.impulses.abs().sum(-1) > 0
    keep = ~(fa != fb).any(dim=1)
    dev = {}
    for f in TOL:
        d = (getattr(got, f) - getattr(want, f)).abs().reshape(keep.shape[0], -1)
        dev[f] = float(d[keep].max()) if bool(keep.any()) else 0.0
    finite = all(bool(torch.isfinite(getattr(got, f)).all()) for f in got._fields)
    return dev, float((~keep).float().mean()), finite


def cuda_ms(fn, inner, repeats):
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls."""
    import torch
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main():
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "isaacgym_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    import numpy as np
    import isaacgym_tpu_torch
    from concurrent.futures import ThreadPoolExecutor
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.utils.config import load_task_config

    # ---- 0: device
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    # ---- 1: build (nvcc and g++ started together)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        f_cuda = pool.submit(_build.build_cuda_library)
        f_host = pool.submit(_build.build_host_library)
        lib, host = f_cuda.result(), f_host.result()
    F.check_library_layout(lib, 7)
    F.check_library_layout(host, 7)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compile_seconds": _build.build_seconds})

    # ---- 2: K2 against its plain version on the card
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B)
    env_raised = isaacgym_tpu_torch.make(
        seed=0, task=TASK, num_envs=B, cfg=scripted.raised_table_cfg(load_task_config(TASK)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def rollout_inputs():
        state, _ = env.reset()
        for _ in range(60):
            state, *_ = env.step(state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
        tgt, eff = env.action_to_drive(torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
        s = state.sim
        return tuple(t.contiguous() for t in (s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 2, 0:3],
                                              s.root[:, 2, 7:10], s.root[:, 2, 10:13]))

    sets = {}
    max_err, flip_rates = {}, {}
    for i, name in enumerate(("reset", "rollout", "paddle_ball", "paddle_table", "ball_rest")):
        t0 = time.perf_counter()
        e = env_raised if name == "paddle_table" else env
        if name == "rollout":
            ins = rollout_inputs()
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k2_inputs(e, name, B, np.random.RandomState(100 + i)))
        k = e.sim.fused_substep
        got = k(*ins)
        want = F.fused_substep_reference(k.device_consts(dev), *ins)
        torch.cuda.synchronize()
        err, flip, finite = compare(got, want)
        contacts = (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist()
        emit({"phase": f"k2/{name}", "max_err": err, "flip_rate": flip, "finite": finite,
              "contact_rows_active": contacts, "seconds": time.perf_counter() - t0})
        bad = [f for f, tol in TOL.items() if not err[f] <= tol]
        if bad or flip > MAX_FLIP_RATE or not finite:
            raise SystemExit(f"k2/{name}: kernel disagrees with its plain version: "
                             f"{bad} flip {flip} finite {finite}")
        for f in TOL:
            max_err[f] = max(max_err.get(f, 0.0), err[f])
        flip_rates[name] = flip
        sets[name] = (e, ins)

    # ---- timing at the main path's shape, on the rollout states
    t0 = time.perf_counter()
    e, ins = sets["rollout"]
    k = e.sim.fused_substep
    x = F.pack_inputs(*ins)
    consts = k.device_consts(dev)
    k_ms = cuda_ms(lambda: k.launch(x), 20, 15)
    wrap_ms = cuda_ms(lambda: k(*ins), 20, 15)
    plain_ms = cuda_ms(lambda: F.fused_substep_reference(consts, *ins), 1, 10)
    xc = x.cpu()
    yc = torch.empty((F.n_out(k.nd, k.ng), B))
    cc = torch.as_tensor(k.consts)
    ops = host.igt_fused_substep_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B, k.nd)
    if ops <= 0:
        raise SystemExit("operation count failed")
    n_bytes = 4 * B * (F.n_in(k.nd) + F.n_out(k.nd, k.ng)) + 4 * k.consts.size
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit({"phase": "timing", "kernel_ms": k_ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms,
          "bytes": n_bytes, "fp32_ops": ops, "ops_per_env": ops / B,
          "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms, "bound_ms": bound_ms,
          "seconds": time.perf_counter() - t0})

    # ---- 3: the main path
    t0 = time.perf_counter()
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B)
    k = env.sim.fused_substep
    gen.manual_seed(0)
    state, obs = env.reset()
    for _ in range(5):
        state, obs, rew, done, info = env.step(
            state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    k.launches = 0
    windows, zs = [], []
    steps = 0
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(100):
            state, obs, rew, done, info = env.step(
                state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
            zs.append(state.sim.root[:, 2, 2].clone())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    launches = k.launches
    if launches != 2 * steps:
        raise SystemExit(f"main path: K2 launched {launches} times in {steps} steps")
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    z = torch.stack(zs)                          # (steps, B)
    zmin, tmin = z.min(dim=0)
    later = torch.where(torch.arange(steps, device=dev)[:, None] > tmin[None], z,
                        torch.full_like(z, -1e9)).max(dim=0).values
    bounced = int(((zmin < 0.85) & (later > zmin + 0.01)).sum())
    if not finite or bounced == 0:
        raise SystemExit(f"main path: finite={finite} bounced_envs={bounced}")
    rates = [B * 100 / w for w in windows]
    emit({"phase": "main", "num_envs": B, "steps": steps, "k2_launches": launches,
          "env_steps_per_s": rates, "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 10 for w in windows], "bounced_envs": bounced,
          "hit_paddle_flags": int(state.flags["paddle_condition_calculated"].sum()),
          "seconds": time.perf_counter() - t0})

    # ---- where a step's time goes: torch.profiler over 10 more steps
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env.step(state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:   # device kernels only, not the CPU ops
            n, t = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    kernels = [(name, n, t) for name, (n, t) in per_name.items()]
    busy_us = sum(t for _, _, t in kernels)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4,
          "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k2_ms_per_step": sum(t for n, _, t in kernels if "fused_substep" in n) / 1e4,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})

    # ---- 4: the kernels line, the card, the verdict
    emit({"kernels": [{
        "name": "fused_substep", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754",
        "launches": launches, "max_abs_err": max(max_err.values()), "max_err": max_err,
        "flip_rate": max(flip_rates.values()), "ms": k_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "us": k_ms * 1e3, "plain_us": plain_ms * 1e3,
        "bound_us": bound_ms * 1e3}]})
    print(f"total seconds {time.perf_counter() - t_all:.1f}", file=sys.stderr)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
