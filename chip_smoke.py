#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds:
  device  the card's name, and its name and power limit from nvidia-smi;
  build   one nvcc per csrc/*.cu, started together, into build/kernels/
          (and g++ the host loop that counts the kernels' operations), wall
          seconds, and ptxas's registers, stack and spills of K2, K2-dr,
          K2-tau, K2-dr-tau, K3, K3-tau and K4;
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
  k2tau/*  K2-tau, the torque-lane build of K2 for scenes with a force
          sensor, on the flagship scene with a paddle sensor (raised table
          for paddle_table), on K2's five sets under the same comparison and
          gates, the moment rows compared on their own (geom moments to
          1e-5, the ball's to 1e-7: TOL); k2drtau/* K2-dr-tau (DR and torque
          lanes) on two of them; k2tau_timing and k2drtau_timing their
          times and bounds;
  k3tau/*  K3-tau on C8 with a sensor on each paddle (C8's five sets) and on
          the two-arm, two-ball scene with paddle sensors (ball_ball, whose
          ball-pair moments the JAX package's tests never reach, and
          effort); k3tau_timing its time and bound;
  tau_gates  each tau kernel's output with its geom or its ball moment rows
          zeroed, or negated, must fail the moment gates on some set;
  k4/*    K4, the floating-base kernel, against its plain version on C10
          at its 2048 envs under the same comparison, the base's pose and
          velocities gated as q and qd are, flip rate at most 0.2 % as K2's:
          stand (the neutral pose, the feet's resting contacts), random (60
          env steps under random actions), strike (a paddle-ball strike),
          fall (a falling humanoid hitting the ground), table (standing on
          the raised table, art-vs-static);
  k4_gates  K4's output with the base's linear velocity negated, and K4
          run on the scene lifted 2 m above its ground (the ground contacts
          dropped, everything else the same), must each fail the gates on
          some set;
  k4_timing  K4 per launch on the random-action states, its plain version,
          its bound, ptxas's registers, stack and spills, and its blocks per
          SM;
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
  sensors/flagship, sensors/c8  the force-sensor path at 4096 envs: the
          scene with a sensor on each paddle (create_asset_force_sensor), 100
          Simulator.step calls from scripted off-centre strikes re-launched
          every 10 steps, each read with acquire_force_sensor_tensor: K2-tau
          (K3-tau on C8) exactly 2 launches per step, every strike (force
          above 0.1 N) reads a non-zero moment; env-steps/s and
          microseconds per acquire_force_sensor_tensor; then the first
          strike step's sensor force and moment lanes against the same step
          through the plain version in float32 and float64 (SENSOR_TOL
          beyond the float32 run's rounding);
  c10_main  make(seed=0, C10, 2048 envs), 3 windows of 100 steps under
          random actions: K4 exactly 2 launches per step, every state
          finite; env-steps/s and ms per step;
  c10_profile  torch.profiler over 10 C10 steps: device kernels per step,
          K4's share and the device busy share;
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
          the first 4096 rows after the update than before it;
  c10_train  the same for C10 on its own train config at 2048 envs, K4
          exactly 2 x 32 launches per epoch.
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
import types

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C6 = "HumanoidPingpongTiltG1"
C8 = "Humanoid12PingpongTiltG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
B = 4096
B10 = 2048                     # C10's numEnvs (its config, and the reference's)
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, non-tensor
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
# impulses: the force rows; a torque build's moment rows are gated on their
# own, by their size (tests/test_torch_force_torque.py's header): a ball's
# moment about its centre is 0.02 m times a friction impulse (up to ~1e-4),
# a geom body's up to ~6e-3 in a strike and ~0.4 at the raised table
# K4's base pose and velocities are gated as q and qd are (the CPU tests'
# tolerances, tests/test_torch_fused_substep_floating.py)
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3, geom_moments=1e-5, ball_moments=1e-7,
           base_pos=1e-4, base_quat=1e-4, base_linvel=1e-3, base_angvel=1e-3)
# the sensor path's step against the same step through the plain version:
# force lanes in N, moment lanes in N m (the CPU test's port step against the
# JAX package's step holds them so)
SENSOR_TOL = dict(force=1e-2, moment=1e-3)
MAX_FLIP_RATE = 0.002
C_F32 = 1.0                    # see compare


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def split_rows(out, moments=None):
    """name -> tensor of each compared output. A torque build's impulses
    (``moments`` = (ng, nb): ng geom moment rows, then nb ball moment rows,
    after the force rows) split into ``impulses`` (the force rows),
    ``geom_moments`` and ``ball_moments``."""
    v = {f: getattr(out, f) for f in out._fields}
    if moments:
        ng, nb = moments
        imp = out.impulses
        v.update(impulses=imp[:, :-(ng + nb)], geom_moments=imp[:, -(ng + nb):-nb],
                 ball_moments=imp[:, -nb:])
    return v


def compare(got, want32, want64, moments=None):
    """A kernel against its plain version, run in float32 and in float64 on
    the same inputs (a torque build's moment rows as their own outputs, see
    split_rows). Flips (envs whose contact pattern, the force rows, differs
    from the float32 plain run's) are counted and left out. The gate holds
    each element of each output to exact arithmetic, as far as float32 allows:

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
    g_, w32_, w64_ = (split_rows(o, moments) for o in (got, want32, want64))
    fa = g_["impulses"].abs().sum(-1) > 0
    fb = w32_["impulses"].abs().sum(-1) > 0
    keep = ~(fa != fb).any(dim=1)
    flat = lambda t: t.reshape(keep.shape[0], -1)[keep]
    kept_max = lambda d: float(flat(d).max()) if bool(keep.any()) else 0.0
    res = {k_: {} for k_ in ("excess", "max_err_vs_f32_plain", "max_err_vs_f64_plain",
                             "f32_plain_vs_f64_plain")}
    for f in g_:
        g, w32, w64 = g_[f].double(), w32_[f].double(), w64_[f]
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
    bad = [f for f, e in res["excess"].items() if not e <= TOL[f]]
    if bad or res["flip_rate"] > MAX_FLIP_RATE or not res["finite"] or not extra_ok:
        raise SystemExit(f"{phase}: kernel disagrees with its plain version: {bad} "
                         f"flip {res['flip_rate']} finite {res['finite']} {extra}")


def check_kernel(phase, kernel, plain, ins, extra=(), fields=None, ok=True, why=""):
    """One state set: the kernel against its plain version run in float32 and
    in float64 on the same inputs (``extra``: more inputs, the DR channel),
    emitted and gated (``compare``, ``gate``; ``ok`` and ``why`` a further
    check of the caller's). A torque-lane build also reports its largest geom
    and ball moment, and which of its moment rows, zeroed or negated in the
    kernel's output, the gates reject (``wrong_moments_rejected``). Returns
    ``compare``'s result."""
    import torch
    t0 = time.perf_counter()
    got = kernel(*ins, *extra)
    want = plain(*ins, *extra)
    want64 = plain(*[t.double() for t in ins], *[t.double() for t in extra])
    torch.cuda.synchronize()
    moments = (kernel.ng, getattr(kernel, "nb", 1)) if kernel.with_torque else None
    res = compare(got, want, want64, moments)
    out = {"phase": phase, **res, **(fields or {}),
           "contact_rows_active": (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist()}
    if moments:
        ng, nb = moments
        rows = {"geom_moments": slice(-(ng + nb), -nb), "ball_moments": slice(-nb, None)}
        out["max_moment"] = {f: float(got.impulses[:, r].abs().max()) for f, r in rows.items()}
        res["wrong_moments_rejected"] = []
        for how, scale in (("zeroed", 0.0), ("negated", -1.0)):
            for f, r in rows.items():
                imp = got.impulses.clone()
                imp[:, r] *= scale
                if not compare(got._replace(impulses=imp), want, want64,
                               moments)["excess"][f] <= TOL[f]:
                    res["wrong_moments_rejected"].append(f"{f} {how}")
    emit({**out, "seconds": time.perf_counter() - t0})
    gate(phase, res, ok, why)
    return res


def fold(acc, res):
    """Keep in ``acc`` the largest deviation, excess and flip rate over sets,
    and which wrong moment rows some set's gates rejected."""
    if "wrong_moments_rejected" in res:
        acc["wrong_moments_rejected"] = sorted(set(acc.get("wrong_moments_rejected", ()))
                                               | set(res["wrong_moments_rejected"]))
    for f in res["excess"]:
        acc["max_err"][f] = max(acc["max_err"].get(f, 0.0), res["max_err_vs_f32_plain"][f])
        acc["excess"][f] = max(acc["excess"].get(f, -math.inf), res["excess"][f])
    acc["flip_rate"] = max(acc.get("flip_rate", 0.0), res["flip_rate"])
    acc["max_abs_err"] = max(acc["max_err"].values())


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


def time_kernel(phase, launch, wrapped, plain, ops, n_bytes, plain_repeats=10, b=B,
                fields=None):
    """A kernel's time per launch on a packed buffer and through its wrapper,
    its plain version's time and the bound: the larger of the bytes over the
    memory rate and the counted FP32 operations over the FP32 peak, at ``b``
    envs."""
    t0 = time.perf_counter()
    k_ms = cuda_ms(launch, 20, 15)
    wrap_ms = cuda_ms(wrapped, 20, 15)
    plain_ms = cuda_ms(plain, 1, plain_repeats)
    if ops <= 0:
        raise SystemExit(f"{phase}: operation count failed")
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    out = {"kernel_ms": k_ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms, "bytes": n_bytes,
           "fp32_ops": ops, "ops_per_env": ops / b, "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **(fields or {})}
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
    sets, acc = {}, {"max_err": {}, "excess": {}}
    for i, (name, e, kind, scale) in enumerate(cases):
        if kind is None:
            ins = rollout_inputs()
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                e, kind, B, np.random.RandomState(200 + i), scale))
        k = e.sim.fused_substep_multi
        plain = lambda *a, k=k: M.fused_substep_multi_reference(k.device_consts(dev), *a)
        fold(acc, check_kernel(f"k3/{name}", k, plain, ins,
                               fields={"shape": [k.nd, k.K, k.nb]}))
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
    return dict(acc, ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"])


def tau_checks(dev, host, k2_sets, rz):
    """K2-tau (the torque lanes of K2, for scenes with a force sensor) against
    its plain version in float32 and float64 on K2's five state sets, on the
    flagship scene with a paddle sensor (raised-table scene for
    paddle_table); K2-dr-tau on two of them; then K3-tau on C8 with a sensor
    on each paddle (C8's five sets) and on the two-arm, two-ball scene with
    paddle sensors (ball_ball, effort). Then each kernel's timing and bound,
    and a check that the moment gates reject each kernel's output with its
    geom or its ball moment rows zeroed or negated. Returns the kernels-line
    numbers of K2-tau and K3-tau; raises on any failed gate."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    sims = {raised: Simulator(scripted.paddle_sensor_scene(
        scripted.raised_table_cfg(load_task_config(TASK)) if raised else load_task_config(TASK)),
        device=dev) for raised in (False, True)}
    k2 = {"max_err": {}, "excess": {}}
    k2dr = {"max_err": {}, "excess": {}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for name, (e, ins) in k2_sets.items():
        sim = sims[name == "paddle_table"]
        k = sim.fused_substep
        if not k.with_torque or not np.array_equal(k.consts, e.sim.fused_substep.consts):
            raise SystemExit("k2tau: the sensor scene's pack differs from the flagship's")
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a,
                                                          with_torque=True)
        fold(k2, check_kernel(f"k2tau/{name}", k, plain, ins))
        if name in ("rollout", "paddle_ball"):
            kd = sim.fused_substep_dr
            chan = sim.dr_channel(rz.sample(gen, 3000, B))
            plain_dr = lambda *a, k=kd: F.fused_substep_reference(
                k.device_consts(dev), *a[:7], dr_chan=a[7], with_torque=True)
            fold(k2dr, check_kernel(f"k2drtau/{name}", kd, plain_dr, ins, (chan,)))

    # K2-tau timing on the rollout states, the bound from the host body's count
    _, ins = k2_sets["rollout"]
    k = sims[False].fused_substep
    x = F.pack_inputs(*ins)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((F.n_out(k.nd, k.ng, True), B))
    consts = k.device_consts(dev)
    t = time_kernel(
        "k2tau_timing", lambda: k.launch(x), lambda: k(*ins),
        lambda: F.fused_substep_reference(consts, *ins, with_torque=True),
        host.igt_fused_substep_tau_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B,
                                             k.nd, 0),
        4 * B * (F.n_in(k.nd) + F.n_out(k.nd, k.ng, True)) + 4 * k.consts.size)
    k2.update(ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
              bound_by=t["bound_by"])
    # K2-dr-tau on the same states with a full-strength DR channel
    kd = sims[False].fused_substep_dr
    chan = sims[False].dr_channel(rz.sample(gen, 3000, B))
    xd = F.pack_inputs(*ins, chan)
    xdc = xd.cpu()
    t = time_kernel(
        "k2drtau_timing", lambda: kd.launch(xd), lambda: kd(*ins, chan),
        lambda: F.fused_substep_reference(consts, *ins, dr_chan=chan, with_torque=True),
        host.igt_fused_substep_tau_count_ops(cc.data_ptr(), xdc.data_ptr(), yc.data_ptr(), B,
                                             kd.nd, 1),
        4 * B * (kd.n_in() + F.n_out(kd.nd, kd.ng, True)) + 4 * kd.consts.size)
    k2dr.update(ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"])

    # K3-tau
    c8cfg = load_task_config(C8)
    c8 = types.SimpleNamespace(cfg=c8cfg, sim=Simulator(scripted.paddle_sensor_scene(c8cfg, 2),
                                                        device=dev))
    c8.scene = c8.sim.scene
    toys = {d: scripted.ToyEnv(d, device=dev, paddle_sensor=True)
            for d in (DRIVE_POS, DRIVE_EFFORT)}
    k3 = {"max_err": {}, "excess": {}}
    rollout = None
    cases = (("reset", c8, "reset", 0.0), ("rollout", c8, None, 0.0),
             ("paddle_ball1", c8, "paddle_ball1", 0.0), ("paddle_ball2", c8, "paddle_ball2", 0.0),
             ("ball_rest", c8, "ball_rest", 0.0), ("ball_ball", toys[DRIVE_POS], "ball_ball", 0.0),
             ("effort", toys[DRIVE_EFFORT], "paddle_ball1", 15.0))
    for i, (name, e, kind, scale) in enumerate(cases):
        if kind is None:   # 60 steps of the sensor scene from reset launches
            state, _ = scripted.strike_state(e.sim, "reset", B, np.random.RandomState(299),
                                             c8cfg)
            for _ in range(60):
                tgt = torch.rand((B, 14), generator=gen, device=dev) * 2 - 1
                state = e.sim.step(state, tgt, torch.zeros_like(tgt))
            ba = [b.actor_index for b in e.scene.free_bodies]
            ins = (state.dof_pos, state.dof_vel, tgt, torch.zeros_like(tgt),
                   state.root[:, ba, 0:3], state.root[:, ba, 7:10], state.root[:, ba, 10:13])
            ins = rollout = tuple(a.contiguous() for a in ins)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                e, kind, B, np.random.RandomState(300 + i), scale))
        k = e.sim.fused_substep_multi
        if not k.with_torque:
            raise SystemExit("k3tau: the sensor scene was built without the torque lanes")
        plain = lambda *a, k=k: M.fused_substep_multi_reference(k.device_consts(dev), *a,
                                                                with_torque=True)
        fold(k3, check_kernel(f"k3tau/{name}", k, plain, ins))
    # the moment gates bite: each kernel's output with its geom or its ball
    # moment rows zeroed, or negated, fails them on some set
    rejected = {n: acc.pop("wrong_moments_rejected")
                for n, acc in (("k2tau", k2), ("k2drtau", k2dr), ("k3tau", k3))}
    emit({"phase": "tau_gates", "wrong_moments_rejected": rejected})
    wrong = {f"{f} {how}" for how in ("zeroed", "negated")
             for f in ("geom_moments", "ball_moments")}
    if any(wrong - set(r) for r in rejected.values()):
        raise SystemExit(f"tau_gates: the moment gates let wrong moments pass: {rejected}")
    k = c8.sim.fused_substep_multi
    x = M.pack_inputs(*rollout)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((M.n_out(k.nd_tot, k.nb, k.ng, True), B))
    consts = k.device_consts(dev)
    t = time_kernel(
        "k3tau_timing", lambda: k.launch(x), lambda: k(*rollout),
        lambda: M.fused_substep_multi_reference(consts, *rollout, with_torque=True),
        host.igt_fused_substep_multi_tau_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(),
                                                   B, k.nd, k.K, k.nb),
        4 * B * (M.n_in(k.nd_tot, k.nb) + M.n_out(k.nd_tot, k.nb, k.ng, True))
        + 4 * k.consts.size, plain_repeats=5)
    k3.update(ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
              bound_by=t["bound_by"])
    return k2, k2dr, k3


def sensor_vs_plain(sim, state, tgt, eff):
    """One ``Simulator.step`` from ``state`` through the scene's kernel, and
    the same step with the kernel's plain version put in its place, run in
    float32 and in float64: the sensor tensor's force and moment lanes of
    the kernel's step against the plain steps', over envs whose sensors read
    a force in both the kernel's and the float32 plain step or in neither,
    held as ``compare`` holds a kernel, ``|kernel - plain64| <= SENSOR_TOL +
    |plain32 - plain64|``. Raises if they disagree."""
    import copy
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import tensor_api as T
    name = "fused_substep" if sim.fused_substep_multi is None else "fused_substep_multi"
    consts = getattr(sim, name).device_consts(state.root.device)
    ref = F.fused_substep_reference if name == "fused_substep" else \
        M.fused_substep_multi_reference
    plain = copy.copy(sim)
    setattr(plain, name, lambda *a: ref(consts, *a, with_torque=True))
    w = T.acquire_force_sensor_tensor(sim, sim.step(state, tgt, eff))
    w32 = T.acquire_force_sensor_tensor(plain, plain.step(state, tgt, eff))
    w64 = T.acquire_force_sensor_tensor(plain, plain.step(
        state._replace(**{f: getattr(state, f).double() for f in state._fields}),
        tgt.double(), eff.double()))
    keep = ((w[..., :3].norm(dim=-1) > 0) == (w32[..., :3].norm(dim=-1) > 0)).all(dim=1)
    res = {"flip_rate": float((~keep).float().mean()), "strikes": int(
        (w[keep][..., :3].norm(dim=-1) > 0.1).sum())}
    for lane, sl in (("force", slice(0, 3)), ("moment", slice(3, 6))):
        g, a, b = w[keep][..., sl].double(), w32[keep][..., sl].double(), w64[keep][..., sl]
        res[lane] = {"excess": float(((g - b).abs() - (a - b).abs()).max()),
                     "max_err_vs_f64_plain": float((g - b).abs().max()),
                     "f32_plain_vs_f64_plain": float((a - b).abs().max()),
                     "largest": float(b.abs().max())}
    if (res["flip_rate"] > MAX_FLIP_RATE or res["strikes"] == 0
            or any(not res[n]["excess"] <= tol for n, tol in SENSOR_TOL.items())):
        raise SystemExit(f"sensor lanes disagree with the plain version's step: {res}")
    return res


def sensor_path(dev, steps=100, relaunch_every=10):
    """The force-sensor path at full width: the flagship scene, then C8, each
    with a sensor on every paddle (``create_asset_force_sensor``), 4096
    envs, ``steps`` calls of ``Simulator.step`` from scripted off-centre
    strikes (re-launched every ``relaunch_every`` steps), each read through
    ``acquire_force_sensor_tensor``. Checks that every strike (a sensor
    force above 0.1 N) reads a non-zero moment, and after the run the first
    strike step's sensor lanes against the same step through the plain
    version (``sensor_vs_plain``). Returns the kernels' launch counts of
    this run (``flagship_dr``: K2-dr-tau's, the DR build of the flagship
    sensor scene, which this path, with DR off, leaves at 0) and the
    phase's numbers."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim import tensor_api as T
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    out, launches = {}, {}
    for label, task, humanoids, kinds in (("flagship", TASK, 1, ("paddle_ball",)),
                                          ("c8", C8, 2, ("paddle_ball1", "paddle_ball2"))):
        t0 = time.perf_counter()
        sim = Simulator(scripted.paddle_sensor_scene(load_task_config(task), humanoids),
                        device=dev)
        k = sim.fused_substep if humanoids == 1 else sim.fused_substep_multi
        rng = np.random.RandomState(7)
        state, tgt = scripted.strike_state(sim, kinds[0], B, rng)
        eff = torch.zeros_like(tgt)
        sim.step(state, tgt, eff)   # warm-up
        torch.cuda.synchronize()
        for kk in (sim.fused_substep, sim.fused_substep_dr, sim.fused_substep_multi):
            if kk is not None:
                kk.launches = 0
        step_s, read_s, strikes, moments = 0.0, 0.0, 0, 0
        rows = torch.as_tensor(sim.scene.force_sensor_bodies, device=dev)
        for i in range(steps):
            if i % relaunch_every == 0:
                state, tgt = scripted.strike_state(sim, kinds[(i // relaunch_every) % len(kinds)],
                                                   B, rng)
                if i == 0:
                    first = (state, tgt)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            state = sim.step(state, tgt, eff)
            torch.cuda.synchronize()
            tr = time.perf_counter()
            w = T.acquire_force_sensor_tensor(sim, state)
            torch.cuda.synchronize()
            read_s += time.perf_counter() - tr
            step_s += tr - ts
            hit = w[..., :3].norm(dim=-1) > 0.1
            strikes += int(hit.sum())
            moments += int((hit & (w[..., 3:].norm(dim=-1) > 0)).sum())
        finite = all(bool(torch.isfinite(t).all()) for t in state)
        launches[label] = k.launches
        if sim.fused_substep_dr is not None:   # K2-dr-tau: DR is off on this path
            launches[f"{label}_dr"] = sim.fused_substep_dr.launches
        out[label] = {"num_envs": B, "steps": steps, "sensors": int(rows.numel()),
                      "launches": k.launches, "env_steps_per_s": B * steps / step_s,
                      "us_per_acquire_force_sensor_tensor": read_s / steps * 1e6,
                      "strikes": strikes, "strikes_with_moment": moments, "finite": finite}
        if k.launches != 2 * steps or not finite or strikes == 0 or moments != strikes:
            raise SystemExit(f"sensors/{label}: {out[label]}")
        out[label]["vs_plain_step"] = sensor_vs_plain(sim, *first, eff)
        out[label]["seconds"] = time.perf_counter() - t0
        emit({"phase": f"sensors/{label}", **out[label]})
    return launches, out


def ptxas_usage(lib_name):
    """Registers, stack frame and spill bytes of a library's kernels from
    its ``ptxas -v`` output (the build of this run)."""
    import re
    from isaacgym_tpu_torch.ops import _build
    log = _build.build_logs.get(lib_name, "")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    stack = [int(m) for m in re.findall(r"(\d+) bytes stack frame", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"registers": max(regs, default=None), "stack_bytes": max(stack, default=None),
            "spill_bytes": max(spills, default=None)}


def k4_checks(dev, host):
    """K4 against its plain version (float32 and float64) on C10 at 2048 envs,
    five sets: stand (the neutral pose, resting foot contacts), random (60
    env steps under random actions), strike (a paddle-ball strike), fall (a
    falling humanoid hitting the ground) and table (standing on the raised
    table, art-vs-static); then that the gates reject K4's output with the
    base's linear velocity negated, and K4's output on the scene lifted above
    its ground (k4_gates); then its timing, bound and ptxas usage (k4_timing). Returns
    the kernels-line numbers; raises on any failed gate."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.utils.config import load_task_config

    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B10)
    env_raised = isaacgym_tpu_torch.make(
        seed=0, task=C10, num_envs=B10, cfg=scripted.raised_table_cfg(load_task_config(C10)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    lift = 2.0

    def lifted(k):
        """K4 on a copy of the scene's pack whose statics stand ``lift`` m
        higher (its own wrapper and count)."""
        consts = k.consts.copy()
        lay = FF.layout(k.nd)
        for si in range(int(consts[FF.C_NSTATIC])):
            consts[lay["static"] + si * FF.STATIC_STRIDE + FF.G_POS + 2] += lift
        return FF.FusedSubstepFloating(consts)

    def no_ground(k_lifted, ins):
        """The wrong form the gates must reject: K4 with its ground contacts
        dropped. The scene, humanoid and ball included, is run ``lift`` m
        above its ground and brought back down; gravity is uniform, so only
        the ground contacts (feet and ball) differ from the real step."""
        ins = list(ins)
        for i in (4, 8):   # base pos, ball pos
            ins[i] = ins[i] + torch.tensor([0.0, 0.0, lift], device=dev)
        out = k_lifted(*ins)
        down = torch.tensor([0.0, 0.0, lift], device=dev)
        return out._replace(base_pos=out.base_pos - down, ball_pos=out.ball_pos - down)

    def random_inputs():
        state, _ = env.reset()
        for _ in range(60):
            state, *_ = env.step(state, torch.rand((B10, 27), generator=gen, device=dev) * 2 - 1)
        tgt, eff = env.action_to_drive(torch.rand((B10, 27), generator=gen, device=dev) * 2 - 1)
        s = state.sim
        return tuple(t.contiguous() for t in (
            s.dof_pos, s.dof_vel, tgt, eff, s.root[:, 0, 0:3], s.root[:, 0, 3:7],
            s.root[:, 0, 7:10], s.root[:, 0, 10:13], s.root[:, 2, 0:3], s.root[:, 2, 7:10],
            s.root[:, 2, 10:13]))

    acc, sets = {"max_err": {}, "excess": {}}, {}
    wrong = {"base_linvel negated": [], "ground contacts dropped": []}
    bad_forms = {}
    for i, name in enumerate(("stand", "random", "strike", "fall", "table")):
        t0 = time.perf_counter()
        e = env_raised if name == "table" else env
        if name == "random":
            ins = random_inputs()
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k4_inputs(e, name, B10, np.random.RandomState(400 + i)))
        k = e.sim.fused_substep_floating
        consts = k.device_consts(dev)
        got = k(*ins)
        want = FF.floating_substep_plain(consts, *ins)
        want64 = FF.floating_substep_plain(consts, *[t.double() for t in ins])
        torch.cuda.synchronize()
        res = compare(got, want, want64)
        emit({"phase": f"k4/{name}", **res,
              "contact_rows_active": (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist(),
              "seconds": time.perf_counter() - t0})
        gate(f"k4/{name}", res)
        fold(acc, res)
        sets[name] = (e, ins)
        if e not in bad_forms:
            bad_forms[e] = lifted(k)
        for form, out in (("base_linvel negated", got._replace(base_linvel=-got.base_linvel)),
                          ("ground contacts dropped", no_ground(bad_forms[e], ins))):
            r = compare(out, want, want64)
            if (any(not v <= TOL[f] for f, v in r["excess"].items())
                    or r["flip_rate"] > MAX_FLIP_RATE):
                wrong[form].append(name)
    emit({"phase": "k4_gates", "rejected_on_sets": wrong})
    if not all(wrong.values()):
        raise SystemExit(f"k4_gates: the gates let a wrong K4 output pass on every set: {wrong}")

    # timing at the main path's shape, on the random-action states
    e, ins = sets["random"]
    k = e.sim.fused_substep_floating
    x = FF.pack_inputs(*ins)
    consts = k.device_consts(dev)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((FF.n_out(k.nd, k.ng), B10))
    usage = ptxas_usage("libigt_fused_substep_floating.so")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = (B10 + 31) // 32
    t = time_kernel(
        "k4_timing", lambda: k.launch(x), lambda: k(*ins),
        lambda: FF.floating_substep_plain(consts, *ins),
        host.igt_fused_substep_floating_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(),
                                                  B10, k.nd),
        4 * B10 * (FF.n_in(k.nd) + FF.n_out(k.nd, k.ng)) + 4 * k.consts.size,
        plain_repeats=3, b=B10,
        fields={"num_envs": B10, **usage, "blocks_of_32": blocks, "sms": sms,
                "sms_with_a_warp": min(blocks, sms),
                "warps_per_busy_sm": blocks / min(blocks, sms)})
    return dict(acc, ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], **usage)


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
    from isaacgym_tpu_torch.ops import fused_substep_floating as FL
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
    for lib in (libs["fused_substep_floating"], host):
        FL.check_library_layout(lib, 27)
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

    sets, k2acc = {}, {"max_err": {}, "excess": {}}
    for i, name in enumerate(("reset", "rollout", "paddle_ball", "paddle_table", "ball_rest")):
        e = env_raised if name == "paddle_table" else env
        if name == "rollout":
            ins = rollout_inputs()
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k2_inputs(e, name, B, np.random.RandomState(100 + i)))
        k = e.sim.fused_substep
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a)
        fold(k2acc, check_kernel(f"k2/{name}", k, plain, ins))
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
    k2dracc, dr_chans = {"max_err": {}, "excess": {}}, {}
    for name, (e, ins) in sets.items():
        chan = e.sim.dr_channel(rz.sample(dr_gen, 3000, B))
        if ident is None:
            ident = e.sim.dr_channel(rz.sample(dr_gen, 0, B))   # step 0: the identity
        k = e.sim.fused_substep_dr
        k2_out, id_out = e.sim.fused_substep(*ins), k(*ins, ident)
        id_dev = max(float(((getattr(id_out, f) - getattr(k2_out, f)).abs()
                            / getattr(k2_out, f).abs().clamp(min=1.0)).max())
                     for f in k2_out._fields)
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a[:7],
                                                          dr_chan=a[7])
        fold(k2dracc, check_kernel(
            f"k2dr/{name}", k, plain, ins, (chan,), ok=id_dev <= 1e-6,
            why=f"identity vs K2 {id_dev}",
            fields={"identity_vs_k2": id_dev,
                    "mass_scale_range": [float(chan[:, 4 * k.nd].min()),
                                         float(chan[:, 4 * k.nd].max())]}))
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

    # ---- 2d: K2-tau, K2-dr-tau and K3-tau against their plain versions, timings
    k2tau, k2drtau, k3tau = tau_checks(dev, host, sets, rz)

    # ---- 2e: K4 against its plain version on C10, the gates' bite, its timing
    k4 = k4_checks(dev, host)

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

    # ---- 4d: the force-sensor path through K2-tau and K3-tau
    tau_launches, _ = sensor_path(dev)

    # ---- 4e: the C10 env step through K4, at its 2048 envs
    t0 = time.perf_counter()
    env10 = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B10)
    k4k = env10.sim.fused_substep_floating
    gen.manual_seed(0)
    act10 = lambda: torch.rand((B10, 27), generator=gen, device=dev) * 2 - 1
    state, obs = env10.reset()
    for _ in range(5):
        state, obs, rew, done, info = env10.step(state, act10())
    torch.cuda.synchronize()
    k4k.launches = 0
    windows, steps = [], 0
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(100):
            state, obs, rew, done, info = env10.step(state, act10())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    c10_launches = k4k.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    rates = [B10 * 100 / w for w in windows]
    emit({"phase": "c10_main", "num_envs": B10, "steps": steps, "k4_launches": c10_launches,
          "env_steps_per_s": rates, "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 10 for w in windows], "finite": finite,
          "obs_shape": list(obs.shape),
          "fallen_share": float(state.flags["humanoid_die_calculated"].float().mean()),
          "pelvis_z_mean": float(state.sim.root[:, 0, 2].mean()),
          "seconds": time.perf_counter() - t0})
    if c10_launches != 2 * steps or not finite or tuple(obs.shape) != (B10, 313):
        raise SystemExit(f"c10_main: K4 launched {c10_launches} times in {steps} steps, "
                         f"finite={finite}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env10.step(state, act10())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    kernels = [(name, n, t) for name, (n, t) in device_kernels(prof).items()]
    busy_us = sum(t for _, _, t in kernels)
    k4_us = sum(t for n, _, t in kernels if "fused_substep_floating" in n)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "c10_profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4, "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k4_ms_per_step": k4_us / 1e4, "k4_share_of_busy": k4_us / busy_us,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})
    del env10, state, obs

    # ---- 5: training at full width with DR, through K2-dr
    from isaacgym_tpu_torch.rl import checkpoint
    from isaacgym_tpu_torch.rl.player import play
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose

    def trainer_for(overrides, task=TASK, b=B):
        cfg = compose(task, [f"num_envs={b}"] + overrides)
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

    # ---- 7c: C10 training through K4, at its 2048 envs
    t0 = time.perf_counter()
    env_c10, trainer_c10 = trainer_for([], task=C10, b=B10)
    ts10 = trainer_c10.init_state()
    state10, obs10 = env_c10.reset()
    k4t = env_c10.sim.fused_substep_floating
    real_update10 = trainer_c10._update
    c10_losses = []

    def update_checked10(ts_, batch, obs_stats):
        mb0 = {k_: v[:trainer_c10.cfg.minibatch_size] for k_, v in batch.items()}
        with torch.no_grad():
            before = float(trainer_c10.loss(ts_.params, obs_stats, mb0)[0])
        out = real_update10(ts_, batch, obs_stats)
        with torch.no_grad():
            after = float(trainer_c10.loss(out[0], obs_stats, mb0)[0])
        c10_losses.append((before, after))
        return out

    trainer_c10._update = update_checked10
    c10_epochs = []
    for it in range(2):
        torch.cuda.synchronize()
        k4t.launches = 0
        te = time.perf_counter()
        ts10, state10, obs10, metrics10 = trainer_c10.train_epoch(ts10, state10, obs10)
        m = {k_: float(v) for k_, v in metrics10.items()}
        row = {"epoch": it, "epoch_s": time.perf_counter() - te, "k4_launches": k4t.launches,
               "loss_first_mb_before_after": c10_losses[-1],
               **{k_: m[k_] for k_ in ("reward_mean", "a_loss", "c_loss", "kl", "last_lr")}}
        emit({"phase": "c10_train/epoch", **row})
        if (k4t.launches != 2 * trainer_c10.cfg.horizon_length
                or not all(math.isfinite(v) for v in m.values())
                or not c10_losses[-1][1] < c10_losses[-1][0]):
            raise SystemExit(f"c10_train: epoch {it}: {row} {m}")
        c10_epochs.append(row)
    c10_train_launches = sum(r["k4_launches"] for r in c10_epochs)
    emit({"phase": "c10_train", "epochs": 2, "num_envs": B10, "k4_launches": c10_train_launches,
          "epoch_s": [r["epoch_s"] for r in c10_epochs],
          "env_steps_per_s": [B10 * trainer_c10.cfg.horizon_length / r["epoch_s"]
                              for r in c10_epochs],
          "seconds": time.perf_counter() - t0})
    del env_c10, trainer_c10, ts10, state10, obs10

    # ---- 8: the kernels line, the card, the verdict
    emit({"kernels": [{
        "name": "fused_substep", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754",
        "launches": launches, "launches_by_path": {
            "main": launches, "train": train_launches["k2"], "train_nodr": nodr_launches["k2"]},
        **k2acc, "ms": k2t["kernel_ms"],
        "plain_ms": k2t["plain_ms"], "bound_ms": k2t["bound_ms"], "bound_by": k2t["bound_by"],
        "library_ms": None, "us": k2t["kernel_ms"] * 1e3, "plain_us": k2t["plain_ms"] * 1e3,
        "bound_us": k2t["bound_ms"] * 1e3}, {
        "name": "fused_substep_dr", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_dr=True, "
                    "isaacgym_tpu/sim/simulator.py:521)",
        "launches": train_launches["k2dr"], "launches_by_path": {
            "main": 0, "train": train_launches["k2dr"], "train_nodr": nodr_launches["k2dr"]},
        **k2dracc, "ms": k2drt["kernel_ms"],
        "plain_ms": k2drt["plain_ms"], "bound_ms": k2drt["bound_ms"],
        "bound_by": k2drt["bound_by"], "library_ms": None, "us": k2drt["kernel_ms"] * 1e3,
        "plain_us": k2drt["plain_ms"] * 1e3, "bound_us": k2drt["bound_ms"] * 1e3}, {
        "name": "fused_substep_multi", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_multi.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:1477",
        "launches": c8_launches, "launches_by_path": {
            "c8_main": c8_launches, "c8_train": c8_train_launches},
        **k3, "library_ms": None, "us": k3["ms"] * 1e3, "plain_us": k3["plain_ms"] * 1e3,
        "bound_us": k3["bound_ms"] * 1e3}, {
        "name": "fused_substep_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_torque=True)",
        "launches": tau_launches["flagship"],
        "launches_by_path": {"sensors": tau_launches["flagship"]},
        **k2tau, "library_ms": None, "us": k2tau["ms"] * 1e3,
        "plain_us": k2tau["plain_ms"] * 1e3, "bound_us": k2tau["bound_ms"] * 1e3}, {
        "name": "fused_substep_dr_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_dr=True, with_torque=True)",
        "launches": tau_launches["flagship_dr"],
        "launches_by_path": {"sensors": tau_launches["flagship_dr"]},
        **k2drtau, "library_ms": None, "us": k2drtau["ms"] * 1e3,
        "plain_us": k2drtau["plain_ms"] * 1e3, "bound_us": k2drtau["bound_ms"] * 1e3}, {
        "name": "fused_substep_multi_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_multi.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:1477 (with_torque=True)",
        "launches": tau_launches["c8"], "launches_by_path": {"sensors": tau_launches["c8"]},
        **k3tau, "library_ms": None, "us": k3tau["ms"] * 1e3,
        "plain_us": k3tau["plain_ms"] * 1e3, "bound_us": k3tau["bound_ms"] * 1e3}, {
        "name": "fused_substep_floating", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_floating.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:2225",
        "launches": c10_launches, "launches_by_path": {
            "c10_main": c10_launches, "c10_train": c10_train_launches},
        **k4, "library_ms": None, "us": k4["ms"] * 1e3, "plain_us": k4["plain_ms"] * 1e3,
        "bound_us": k4["bound_ms"] * 1e3}]})
    print(f"total seconds {time.perf_counter() - t_all:.1f}", file=sys.stderr)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
