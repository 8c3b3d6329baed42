#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds:
  device  the card's name, and its name and power limit from nvidia-smi;
  build   one nvcc per csrc/*.cu, started together, into build/kernels/
          (and g++ the host loop that counts the kernels' operations), wall
          seconds, and ptxas's registers, stack and spills of K2, K2-dr and
          K3;
  k2/*    the fused-substep kernel against its plain PyTorch version on the
          card, B = 4096, one substep from each state set (reset, rollout
          after 60 steps, paddle_ball, paddle_table, ball_rest), the plain
          version run in float32 and in float64: per output over envs whose
          contact pattern agrees, the deviation from each, gated at the CPU
          tests' tolerances beyond the float32 plain run's own rounding (see
          compare), and the flip rate;
  timing  K2 per launch (CUDA events, median of 15 repeats of 20 launches)
          beside the plain version and the bound (bytes over 3.35 TB/s vs
          counted FP32 operations over 67 TFLOP/s, the larger);
  k2dr/*  K2-dr, the domain-randomized build, against its plain version on
          the same five sets with a channel drawn by DomainRandomizer.sample
          at global step 3000 (every scheduled term at full strength), under
          the same comparison and gates; and K2-dr with an identity channel
          against K2 (within 1e-6 of each output's scale);
  k2dr_timing  K2-dr per launch, its plain version and its bound, as timing;
  k3/*    K3, the multi-articulation kernel, against its plain version under
          the same comparison and gates, B = 4096: on C8 (reset, rollout
          after 60 steps, paddle_ball1, paddle_ball2 -- the humanoid yawed
          180 deg -- and ball_rest) and on the two-arm, two-ball check scene
          (ball_ball: the balls about to collide; effort: effort drive);
  k3_timing  K3 per launch on the C8 rollout states, its plain version and
          its bound, as timing;
  main    make(seed=0, flagship, 4096 envs), reset, 5 warm-up steps, then
          3 windows of 100 steps under uniform actions in [-1, 1] from a
          seeded generator: launches must be exactly 2 per step, every
          state finite, and some ball must bounce (z below 0.85, then up);
          env-steps/s and ms per step per window;
  profile torch.profiler over 10 more steps: device busy share, device
          kernels per step, K2's share, the top kernels by device time;
  c8_main make(seed=0, C8, 4096 envs), 3 windows of 100 steps as main: K3
          exactly 2 launches per step and K2 none, every state finite, a
          ball bounces; then 10 steps with twoPlayer on, obs 188 finite;
  c8_profile  torch.profiler over 10 C8 steps: device kernels per step and
          K3's share;
  c6_main 100 steps of C6 (HumanoidPingpongTiltG1) at 4096 envs: K2
          exactly 2 per step, every state finite;
  train   PPOTrainer at the flagship's full width (4096 envs, horizon 32,
          minibatch 4096 x 5 mini-epochs, separate [2048,1536,1024,1024,512,512]
          bf16 trunks) with task.randomize=true, global step 3000 and
          full-strength DR params after reset, 7 epochs: seconds per epoch
          split into rollout and update, rollout env-steps/s, K2-dr launched
          exactly 2 x 32 per epoch and K2 never, every metric finite,
          episode_length_mean 169 once episodes finish, and a lower total
          loss on the first 4096 rows of each epoch's batch after the update
          than before it; then torch.profiler over one more epoch (device
          busy share) and the update's bf16 matrix-work floor;
  train_nodr  2 epochs with randomize false: the launcher's default route,
          K2 exactly 2 x 32 per epoch and K2-dr never;
  ckpt    save under a temporary directory, restore into a fresh trainer,
          the same mu on the same observations bit for bit, then play one
          episode of 4096 envs;
  c8_train  2 epochs on C8's own train config at 4096 envs: K3 exactly
          2 x 32 launches per epoch, every metric finite, a lower loss on
          the first 4096 rows after the update than before it.
Then the kernels line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with
no CUDA device, or run outside the repository, it exits non-zero at once.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C6 = "HumanoidPingpongTiltG1"
C8 = "Humanoid12PingpongTiltG1"
B = 4096
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, non-tensor
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3)
MAX_FLIP_RATE = 0.002
C_F32 = 1.0                    # see compare


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(got, want32, want64):
    """A kernel against its plain version, run in float32 and in float64 on
    the same inputs. Flips (envs whose contact pattern differs from the
    float32 plain run's) are counted and left out. The gate holds each
    element of each output to exact arithmetic, as far as float32 allows:

        |kernel - plain64| <= TOL + C_F32 |plain32 - plain64|

    C_F32 = 1 is the least value at which the float32 plain version itself,
    put in the kernel's place, passes whatever the gate: it credits the
    kernel with the float32 rounding that the plain version shows on that
    element, and no more. Every result within TOL of the float32 plain run
    passes (triangle inequality); so does one nearer to exact arithmetic
    than the float32 plain run where that run's own rounding exceeds TOL (at
    paddle contacts the contact normal is a short ball-to-paddle vector
    normalised). Reports, per output over the kept envs, the gated excess
    ``|kernel - plain64| - C_F32 |plain32 - plain64|``, the deviation from
    each plain run and the float32-to-float64 gap."""
    import torch
    fa = got.impulses.abs().sum(-1) > 0
    fb = want32.impulses.abs().sum(-1) > 0
    keep = ~(fa != fb).any(dim=1)
    flat = lambda t: t.reshape(keep.shape[0], -1)[keep]
    kept_max = lambda d: float(flat(d).max()) if bool(keep.any()) else 0.0
    res = {k_: {} for k_ in ("excess", "max_err_vs_f32_plain", "max_err_vs_f64_plain",
                             "f32_plain_vs_f64_plain")}
    for f in TOL:
        g, w32, w64 = getattr(got, f).double(), getattr(want32, f).double(), getattr(want64, f)
        d64, gap = (g - w64).abs(), (w32 - w64).abs()
        res["excess"][f] = kept_max(d64 - C_F32 * gap)
        res["max_err_vs_f32_plain"][f] = kept_max((g - w32).abs())
        res["max_err_vs_f64_plain"][f] = kept_max(d64)
        res["f32_plain_vs_f64_plain"][f] = kept_max(gap)
    res["flip_rate"] = float((~keep).float().mean())
    res["finite"] = all(bool(torch.isfinite(getattr(got, f)).all()) for f in got._fields)
    return res


def gate(phase, res, extra_ok=True, extra=""):
    """Raise unless ``compare``'s result is within TOL, the flip rate and
    finite."""
    bad = [f for f, tol in TOL.items() if not res["excess"][f] <= tol]
    if bad or res["flip_rate"] > MAX_FLIP_RATE or not res["finite"] or not extra_ok:
        raise SystemExit(f"{phase}: kernel disagrees with its plain version: {bad} "
                         f"flip {res['flip_rate']} finite {res['finite']} {extra}")


def device_kernels(prof):
    """name -> (launches, device microseconds) of the CUDA kernels a
    torch.profiler run recorded (device events only, not the CPU ops). Reads
    the raw kineto events: building the profiler's FunctionEvent tree for an
    epoch's ~10^5 events takes minutes."""
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, t = per_name.get(e.name(), (0, 0.0))
            per_name[e.name()] = (n + 1, t + e.duration_ns() / 1e3)
    return per_name


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


def time_kernel(phase, launch, wrapped, plain, ops, n_bytes, plain_repeats=10):
    """A kernel's time per launch on a packed buffer and through its wrapper,
    its plain version's time and the bound: the larger of the bytes over the
    memory rate and the counted FP32 operations over the FP32 peak."""
    t0 = time.perf_counter()
    k_ms = cuda_ms(launch, 20, 15)
    wrap_ms = cuda_ms(wrapped, 20, 15)
    plain_ms = cuda_ms(plain, 1, plain_repeats)
    if ops <= 0:
        raise SystemExit(f"{phase}: operation count failed")
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    out = {"kernel_ms": k_ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms, "bytes": n_bytes,
           "fp32_ops": ops, "ops_per_env": ops / B, "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    emit({"phase": phase, **out, "seconds": time.perf_counter() - t0})
    return out


def bounced_envs(zs, dev):
    """Envs whose ball went below z = 0.85 and then up again, from a list of
    per-step (B,) heights."""
    import torch
    z = torch.stack(zs)                          # (steps, B)
    zmin, tmin = z.min(dim=0)
    later = torch.where(torch.arange(len(zs), device=dev)[:, None] > tmin[None], z,
                        torch.full_like(z, -1e9)).max(dim=0).values
    return int(((zmin < 0.85) & (later > zmin + 0.01)).sum())


def k3_checks(dev, host):
    """K3 against its plain version (float32 and float64) on the C8 and
    check-scene state sets, then its timing and bound. Returns the kernels-line
    numbers; raises on any failed gate."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS

    env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B)
    toy_pd = scripted.ToyEnv(DRIVE_POS, device=dev)
    toy_effort = scripted.ToyEnv(DRIVE_EFFORT, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def rollout_inputs():
        state, _ = env.reset()
        for _ in range(60):
            state, *_ = env.step(state, torch.rand((B, 14), generator=gen, device=dev) * 2 - 1)
        tgt, eff = env.action_to_drive(torch.rand((B, 14), generator=gen, device=dev) * 2 - 1)
        s = state.sim
        return tuple(t.contiguous() for t in (s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 3:4, 0:3],
                                              s.root[:, 3:4, 7:10], s.root[:, 3:4, 10:13]))

    cases = (("reset", env, "reset", 0.0), ("rollout", env, None, 0.0),
             ("paddle_ball1", env, "paddle_ball1", 0.0), ("paddle_ball2", env, "paddle_ball2", 0.0),
             ("ball_rest", env, "ball_rest", 0.0), ("ball_ball", toy_pd, "ball_ball", 0.0),
             ("effort", toy_effort, "paddle_ball1", 15.0))
    sets, max_err, excess, flips = {}, {}, {}, {}
    for i, (name, e, kind, scale) in enumerate(cases):
        t0 = time.perf_counter()
        if kind is None:
            ins = rollout_inputs()
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                e, kind, B, np.random.RandomState(200 + i), scale))
        k = e.sim.fused_substep_multi
        got = k(*ins)
        want = M.fused_substep_multi_reference(k.device_consts(dev), *ins)
        want64 = M.fused_substep_multi_reference(k.device_consts(dev),
                                                 *[t.double() for t in ins])
        torch.cuda.synchronize()
        res = compare(got, want, want64)
        contacts = (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist()
        emit({"phase": f"k3/{name}", **res, "contact_rows_active": contacts,
              "shape": [k.nd, k.K, k.nb], "seconds": time.perf_counter() - t0})
        gate(f"k3/{name}", res)
        for f in TOL:
            max_err[f] = max(max_err.get(f, 0.0), res["max_err_vs_f32_plain"][f])
            excess[f] = max(excess.get(f, -math.inf), res["excess"][f])
        flips[name] = res["flip_rate"]
        sets[name] = (e, ins)

    # timing at the main path's shape, on the C8 rollout states
    e, ins = sets["rollout"]
    k = e.sim.fused_substep_multi
    x = M.pack_inputs(*ins)
    consts = k.device_consts(dev)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((M.n_out(k.nd_tot, k.nb, k.ng), B))
    t = time_kernel(
        "k3_timing", lambda: k.launch(x), lambda: k(*ins),
        lambda: M.fused_substep_multi_reference(consts, *ins),
        host.igt_fused_substep_multi_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B,
                                               k.nd, k.K, k.nb),
        4 * B * (M.n_in(k.nd_tot, k.nb) + M.n_out(k.nd_tot, k.nb, k.ng)) + 4 * k.consts.size,
        plain_repeats=5)
    return dict(max_abs_err=max(max_err.values()), max_err=max_err, excess=excess,
                flip_rate=max(flips.values()), ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"])


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
    from isaacgym_tpu_torch.env.randomize import DomainRandomizer
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
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

    # ---- 1: build (one nvcc per source and g++, all started together)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        f_cuda = pool.submit(_build.build_cuda_libraries)
        f_host = pool.submit(_build.build_host_library)
        libs, host = f_cuda.result(), f_host.result()
    for lib in (libs["fused_substep"], host):
        F.check_library_layout(lib, 7)
    for lib in (libs["fused_substep_multi"], host):
        for nd in (7, 3):
            M.check_library_layout(lib, nd, 2)
    ptxas = [ln.strip() for log in _build.build_logs.values() for ln in log.splitlines()
             if "registers" in ln or "bytes stack frame" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compile_seconds": _build.build_seconds, "ptxas": ptxas})

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
    max_err, excess, flip_rates = {}, {}, {}
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
        want64 = F.fused_substep_reference(k.device_consts(dev), *[t.double() for t in ins])
        torch.cuda.synchronize()
        res = compare(got, want, want64)
        contacts = (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist()
        emit({"phase": f"k2/{name}", **res, "contact_rows_active": contacts,
              "seconds": time.perf_counter() - t0})
        gate(f"k2/{name}", res)
        for f in TOL:
            max_err[f] = max(max_err.get(f, 0.0), res["max_err_vs_f32_plain"][f])
            excess[f] = max(excess.get(f, -math.inf), res["excess"][f])
        flip_rates[name] = res["flip_rate"]
        sets[name] = (e, ins)

    # ---- timing at the main path's shape, on the rollout states
    e, ins = sets["rollout"]
    k = e.sim.fused_substep
    x = F.pack_inputs(*ins)
    consts = k.device_consts(dev)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((F.n_out(k.nd, k.ng), B))
    k2t = time_kernel(
        "timing", lambda: k.launch(x), lambda: k(*ins),
        lambda: F.fused_substep_reference(consts, *ins),
        host.igt_fused_substep_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B, k.nd),
        4 * B * (F.n_in(k.nd) + F.n_out(k.nd, k.ng)) + 4 * k.consts.size)

    # ---- 2b: K2-dr against its plain version, DR at full strength
    rz = DomainRandomizer(load_task_config(TASK)["task"]["randomization_params"], 7)
    dr_gen = torch.Generator(device=dev)
    dr_gen.manual_seed(3)
    ident = None
    dr_err, dr_excess, dr_flips, dr_chans = {}, {}, {}, {}
    for name, (e, ins) in sets.items():
        t0 = time.perf_counter()
        chan = e.sim.dr_channel(rz.sample(dr_gen, 3000, B))
        if ident is None:
            ident = e.sim.dr_channel(rz.sample(dr_gen, 0, B))   # step 0: the identity
        k = e.sim.fused_substep_dr
        got = k(*ins, chan)
        want = F.fused_substep_reference(k.device_consts(dev), *ins, dr_chan=chan)
        want64 = F.fused_substep_reference(k.device_consts(dev), *[t.double() for t in ins],
                                           dr_chan=chan.double())
        k2_out, id_out = e.sim.fused_substep(*ins), k(*ins, ident)
        torch.cuda.synchronize()
        res = compare(got, want, want64)
        id_dev = max(float(((getattr(id_out, f) - getattr(k2_out, f)).abs()
                            / getattr(k2_out, f).abs().clamp(min=1.0)).max())
                     for f in k2_out._fields)
        contacts = (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist()
        emit({"phase": f"k2dr/{name}", **res,
              "identity_vs_k2": id_dev, "contact_rows_active": contacts,
              "mass_scale_range": [float(chan[:, 4 * k.nd].min()),
                                   float(chan[:, 4 * k.nd].max())],
              "seconds": time.perf_counter() - t0})
        gate(f"k2dr/{name}", res, id_dev <= 1e-6, f"identity vs K2 {id_dev}")
        for f in TOL:
            dr_err[f] = max(dr_err.get(f, 0.0), res["max_err_vs_f32_plain"][f])
            dr_excess[f] = max(dr_excess.get(f, -math.inf), res["excess"][f])
        dr_flips[name] = res["flip_rate"]
        dr_chans[name] = chan

    e, ins = sets["rollout"]
    chan = dr_chans["rollout"]
    k = e.sim.fused_substep_dr
    x = F.pack_inputs(*ins, chan)
    xc = x.cpu()
    k2drt = time_kernel(
        "k2dr_timing", lambda: k.launch(x), lambda: k(*ins, chan),
        lambda: F.fused_substep_reference(consts, *ins, dr_chan=chan),
        host.igt_fused_substep_dr_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B,
                                            k.nd),
        4 * B * (k.n_in() + F.n_out(k.nd, k.ng)) + 4 * k.consts.size)

    # ---- 2c: K3 against its plain version, and its timing
    k3 = k3_checks(dev, host)

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
    bounced = bounced_envs(zs, dev)
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
    kernels = [(name, n, t) for name, (n, t) in device_kernels(prof).items()]
    busy_us = sum(t for _, _, t in kernels)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4,
          "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k2_ms_per_step": sum(t for n, _, t in kernels if "fused_substep" in n) / 1e4,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})

    # ---- 4b: the C8 env step through K3
    t0 = time.perf_counter()
    env8 = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B)
    k3k = env8.sim.fused_substep_multi
    gen.manual_seed(0)
    act8 = lambda: torch.rand((B, 14), generator=gen, device=dev) * 2 - 1
    state, obs = env8.reset()
    for _ in range(5):
        state, obs, rew, done, info = env8.step(state, act8())
    torch.cuda.synchronize()
    k3k.launches = 0
    windows, zs, steps = [], [], 0
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(100):
            state, obs, rew, done, info = env8.step(state, act8())
            zs.append(state.sim.root[:, 3, 2].clone())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    c8_launches = k3k.launches
    c8_k2 = 0 if env8.sim.fused_substep is None else env8.sim.fused_substep.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    bounced = bounced_envs(zs, dev)
    rates = [B * 100 / w for w in windows]
    env2p = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B, twoPlayer=True)
    s2, o2 = env2p.reset()
    for _ in range(10):
        s2, o2, r2, d2, _ = env2p.step(s2, act8())
    two_player_ok = (tuple(o2.shape) == (B, 188) and bool(torch.isfinite(o2).all())
                     and bool(torch.isfinite(r2).all()))
    emit({"phase": "c8_main", "num_envs": B, "steps": steps, "k3_launches": c8_launches,
          "k2_launches": c8_k2, "env_steps_per_s": rates,
          "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 10 for w in windows], "bounced_envs": bounced,
          "hit_paddle_flags": int(state.flags["condition_calculated"].sum()),
          "two_player_obs": list(o2.shape), "two_player_finite": two_player_ok,
          "seconds": time.perf_counter() - t0})
    if c8_launches != 2 * steps or c8_k2 != 0 or not finite or bounced == 0 or not two_player_ok:
        raise SystemExit(f"c8_main: K3 {c8_launches} and K2 {c8_k2} launches in {steps} steps, "
                         f"finite={finite} bounced_envs={bounced} two_player={two_player_ok}")
    del env2p, s2, o2

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env8.step(state, act8())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    kernels = [(name, n, t) for name, (n, t) in device_kernels(prof).items()]
    busy_us = sum(t for _, _, t in kernels)
    k3_us = sum(t for n, _, t in kernels if "fused_substep_multi" in n)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "c8_profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4, "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k3_ms_per_step": k3_us / 1e4, "k3_share_of_busy": k3_us / busy_us,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})
    del env8, state, obs

    # ---- 4c: the C6 env step through K2
    t0 = time.perf_counter()
    env6 = isaacgym_tpu_torch.make(seed=0, task=C6, num_envs=B)
    state, obs = env6.reset()
    torch.cuda.synchronize()
    env6.sim.fused_substep.launches = 0
    tw = time.perf_counter()
    for _ in range(100):
        state, obs, rew, done, info = env6.step(
            state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    c6_s = time.perf_counter() - tw
    c6_launches = env6.sim.fused_substep.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    emit({"phase": "c6_main", "num_envs": B, "steps": 100, "k2_launches": c6_launches,
          "env_steps_per_s": B * 100 / c6_s, "finite": finite,
          "seconds": time.perf_counter() - t0})
    if c6_launches != 200 or not finite:
        raise SystemExit(f"c6_main: K2 launched {c6_launches} times in 100 steps, "
                         f"finite={finite}")
    del env6, state, obs

    # ---- 5: training at full width with DR, through K2-dr
    from isaacgym_tpu_torch.rl import checkpoint
    from isaacgym_tpu_torch.rl.player import play
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose

    def trainer_for(overrides, task=TASK):
        cfg = compose(task, [f"num_envs={B}"] + overrides)
        env = isaacgym_tpu_torch.make(seed=0, task=task, cfg=cfg["task"])
        return env, PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)

    env, trainer = trainer_for(["task.randomize=true"])
    pcfg = trainer.cfg
    halves = {"rollout": [], "update": []}
    loss_checks = []

    def timed(name, fn):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            halves[name].append(time.perf_counter() - t)
            return out
        return run

    real_update = trainer._update
    timed_update = timed("update", real_update)

    def update_with_loss_check(ts_, batch, obs_stats):
        # the total loss on the first minibatch's worth of rows, before and after
        mb0 = {k_: v[:pcfg.minibatch_size] for k_, v in batch.items()}
        with torch.no_grad():
            before = float(trainer.loss(ts_.params, obs_stats, mb0)[0])
        out = timed_update(ts_, batch, obs_stats)
        with torch.no_grad():
            after = float(trainer.loss(out[0], obs_stats, mb0)[0])
        loss_checks.append((before, after))
        return out

    trainer._rollout_and_gae = timed("rollout", trainer._rollout_and_gae)
    trainer._update = update_with_loss_check
    ts = trainer.init_state()
    state, obs = env.reset()
    # past the 3000-step ramp: every scheduled DR term at full strength
    state = state._replace(global_step=torch.full_like(state.global_step, 3000),
                           dr=env.randomizer.sample(env.generator, 3000, B))
    k2, k2dr = env.sim.fused_substep, env.sim.fused_substep_dr
    torch.cuda.synchronize()
    k2.launches = k2dr.launches = 0
    epochs = []
    t0 = time.perf_counter()
    for it in range(7):
        te = time.perf_counter()
        ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
        m = {k_: float(v) for k_, v in metrics.items()}
        epoch_s = time.perf_counter() - te
        n_ep = m["episode_count"]
        row = {"epoch": it, "epoch_s": epoch_s, "rollout_s": halves["rollout"][-1],
               "update_s": halves["update"][-1],
               "rollout_env_steps_per_s": B * pcfg.horizon_length / halves["rollout"][-1],
               "env_steps_per_s": B * pcfg.horizon_length / epoch_s,
               "loss_first_mb_before_after": loss_checks[-1],
               "episode_count": n_ep,
               "episode_length_mean": m["episode_length_sum"] / n_ep if n_ep else None,
               "episode_return_mean": m["episode_return_sum"] / n_ep if n_ep else None,
               **{k_: m[k_] for k_ in ("reward_mean", "a_loss", "c_loss", "kl", "last_lr")}}
        emit({"phase": "train/epoch", **row})
        if not all(math.isfinite(v) for v in m.values()):
            raise SystemExit(f"train: non-finite metrics in epoch {it}: {m}")
        if n_ep and m["episode_length_sum"] / n_ep != 169.0:
            raise SystemExit(f"train: episode_length_mean {m['episode_length_sum'] / n_ep}")
        if not loss_checks[-1][1] < loss_checks[-1][0]:
            raise SystemExit(f"train: the update did not lower the loss: {loss_checks[-1]}")
        epochs.append(row)
    train_launches = {"k2": k2.launches, "k2dr": k2dr.launches}
    want = 2 * pcfg.horizon_length * len(epochs)
    if train_launches != {"k2": 0, "k2dr": want}:
        raise SystemExit(f"train: launches {train_launches}, want K2-dr {want} and K2 0")
    if not any(r["episode_count"] for r in epochs):
        raise SystemExit("train: no episode finished in 7 epochs")
    n_weights = sum(mod.weight.numel() for mod in ts.params.modules()
                    if isinstance(mod, torch.nn.Linear))
    upd_flop = 3 * 2 * n_weights * B * pcfg.horizon_length * pcfg.mini_epochs
    steady = epochs[1:]
    emit({"phase": "train", "epochs": len(epochs), "launches": train_launches,
          "epoch_s_median": statistics.median(r["epoch_s"] for r in steady),
          "rollout_s_median": statistics.median(r["rollout_s"] for r in steady),
          "update_s_median": statistics.median(r["update_s"] for r in steady),
          "rollout_env_steps_per_s_median": statistics.median(
              r["rollout_env_steps_per_s"] for r in steady),
          "env_steps_per_s_median": statistics.median(r["env_steps_per_s"] for r in steady),
          "net_weights": n_weights, "update_flop": upd_flop,
          "update_bf16_floor_ms": upd_flop / PEAK_BF16_OPS_PER_S * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    per_name = device_kernels(prof)
    busy_us = sum(t for _, t in per_name.values())
    top = sorted(per_name.items(), key=lambda r: -r[1][1])[:8]
    emit({"phase": "train_profile", "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / wall_us,
          "device_kernels": sum(c for c, _ in per_name.values()),
          "k2dr_ms": sum(t for n, (_, t) in per_name.items() if "fused_substep" in n) / 1e3,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3}
                          for n, (c, t) in top],
          "seconds": time.perf_counter() - t0})

    # ---- 6: the launcher's default route (randomize false) through K2
    t0 = time.perf_counter()
    env_n, trainer_n = trainer_for([])
    ts_n = trainer_n.init_state()
    state_n, obs_n = env_n.reset()
    k2n, k2drn = env_n.sim.fused_substep, env_n.sim.fused_substep_dr
    torch.cuda.synchronize()
    k2n.launches = k2drn.launches = 0
    for _ in range(2):
        ts_n, state_n, obs_n, metrics_n = trainer_n.train_epoch(ts_n, state_n, obs_n)
    nodr_finite = all(math.isfinite(float(v)) for v in metrics_n.values())
    nodr_launches = {"k2": k2n.launches, "k2dr": k2drn.launches}
    emit({"phase": "train_nodr", "epochs": 2, "launches": nodr_launches,
          "finite": nodr_finite, "seconds": time.perf_counter() - t0})
    if nodr_launches != {"k2": 2 * 2 * pcfg.horizon_length, "k2dr": 0} or not nodr_finite:
        raise SystemExit(f"train_nodr: launches {nodr_launches} finite {nodr_finite}")
    del env_n, trainer_n, ts_n, state_n, obs_n

    # ---- 7: checkpoint round trip, then play one episode
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        checkpoint.save(path, ts)
        fresh = PPOTrainer(env, pcfg, seed=123)
        back = checkpoint.restore(path, fresh.init_state())
    with torch.no_grad():
        mu_a = trainer._policy(ts.params, ts.obs_stats, obs)[0]
        mu_b = fresh._policy(back.params, back.obs_stats, obs)[0]
    same = bool(torch.equal(mu_a, mu_b)) and back.epoch == ts.epoch
    stats = play(env, fresh, back, episodes=1)
    emit({"phase": "ckpt", "mu_identical": same, "play": stats,
          "seconds": time.perf_counter() - t0})
    if not same or stats["episodes"] != B or not math.isfinite(stats["return_mean"]):
        raise SystemExit(f"ckpt: mu identical {same}, play {stats}")

    # ---- 7b: C8 training through K3
    t0 = time.perf_counter()
    env_c8, trainer_c8 = trainer_for([], task=C8)
    ts8 = trainer_c8.init_state()
    state8, obs8 = env_c8.reset()
    k3t = env_c8.sim.fused_substep_multi
    real_update8 = trainer_c8._update
    c8_losses = []

    def update_checked8(ts_, batch, obs_stats):
        mb0 = {k_: v[:trainer_c8.cfg.minibatch_size] for k_, v in batch.items()}
        with torch.no_grad():
            before = float(trainer_c8.loss(ts_.params, obs_stats, mb0)[0])
        out = real_update8(ts_, batch, obs_stats)
        with torch.no_grad():
            after = float(trainer_c8.loss(out[0], obs_stats, mb0)[0])
        c8_losses.append((before, after))
        return out

    trainer_c8._update = update_checked8
    c8_epochs = []
    for it in range(2):
        torch.cuda.synchronize()
        k3t.launches = 0
        te = time.perf_counter()
        ts8, state8, obs8, metrics8 = trainer_c8.train_epoch(ts8, state8, obs8)
        m = {k_: float(v) for k_, v in metrics8.items()}
        row = {"epoch": it, "epoch_s": time.perf_counter() - te, "k3_launches": k3t.launches,
               "loss_first_mb_before_after": c8_losses[-1],
               **{k_: m[k_] for k_ in ("reward_mean", "a_loss", "c_loss", "kl", "last_lr")}}
        emit({"phase": "c8_train/epoch", **row})
        if (k3t.launches != 2 * trainer_c8.cfg.horizon_length
                or not all(math.isfinite(v) for v in m.values())
                or not c8_losses[-1][1] < c8_losses[-1][0]):
            raise SystemExit(f"c8_train: epoch {it}: {row} {m}")
        c8_epochs.append(row)
    c8_train_launches = sum(r["k3_launches"] for r in c8_epochs)
    emit({"phase": "c8_train", "epochs": 2, "k3_launches": c8_train_launches,
          "epoch_s": [r["epoch_s"] for r in c8_epochs],
          "env_steps_per_s": [B * trainer_c8.cfg.horizon_length / r["epoch_s"]
                              for r in c8_epochs],
          "seconds": time.perf_counter() - t0})
    del env_c8, trainer_c8, ts8, state8, obs8

    # ---- 8: the kernels line, the card, the verdict
    emit({"kernels": [{
        "name": "fused_substep", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754",
        "launches": launches, "launches_by_path": {
            "main": launches, "train": train_launches["k2"], "train_nodr": nodr_launches["k2"]},
        "max_abs_err": max(max_err.values()), "max_err": max_err, "excess": excess,
        "flip_rate": max(flip_rates.values()), "ms": k2t["kernel_ms"],
        "plain_ms": k2t["plain_ms"], "bound_ms": k2t["bound_ms"], "bound_by": k2t["bound_by"],
        "library_ms": None, "us": k2t["kernel_ms"] * 1e3, "plain_us": k2t["plain_ms"] * 1e3,
        "bound_us": k2t["bound_ms"] * 1e3}, {
        "name": "fused_substep_dr", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_dr=True, "
                    "isaacgym_tpu/sim/simulator.py:521)",
        "launches": train_launches["k2dr"], "launches_by_path": {
            "main": 0, "train": train_launches["k2dr"], "train_nodr": nodr_launches["k2dr"]},
        "max_abs_err": max(dr_err.values()), "max_err": dr_err, "excess": dr_excess,
        "flip_rate": max(dr_flips.values()), "ms": k2drt["kernel_ms"],
        "plain_ms": k2drt["plain_ms"], "bound_ms": k2drt["bound_ms"],
        "bound_by": k2drt["bound_by"], "library_ms": None, "us": k2drt["kernel_ms"] * 1e3,
        "plain_us": k2drt["plain_ms"] * 1e3, "bound_us": k2drt["bound_ms"] * 1e3}, {
        "name": "fused_substep_multi", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_multi.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:1477",
        "launches": c8_launches, "launches_by_path": {
            "c8_main": c8_launches, "c8_train": c8_train_launches},
        **k3, "library_ms": None, "us": k3["ms"] * 1e3, "plain_us": k3["plain_ms"] * 1e3,
        "bound_us": k3["bound_ms"] * 1e3}]})
    print(f"total seconds {time.perf_counter() - t_all:.1f}", file=sys.stderr)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
