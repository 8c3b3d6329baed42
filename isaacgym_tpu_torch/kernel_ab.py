"""Compare builds of the port's kernels (K1; K2, K2-dr, K2-tau, K2-dr-tau;
K3, K3-tau; K4, K4-tau) from two or more source trees on the card: the same
inputs through each build, bit-for-bit equality with the first tree's
outputs (as int32 words, so -0 and +0 differ), and the time per launch in
turns (A B ... B A, twice over).

    python -m isaacgym_tpu_torch.kernel_ab BASE_CSRC [OTHER_CSRC ...]
        [--kernels k1,k2,k2dr,k2tau,k2drtau,k3,k3tau,k4,k4tau] [--num-envs N]

Each argument is a ``csrc`` directory holding ``arm_step.cu``,
``fused_substep.cu``, ``fused_substep_multi.cu``,
``fused_substep_floating.cu`` and their headers (this package's own is
``isaacgym_tpu_torch/csrc``; a parent commit's can be unpacked with ``git
archive``). Each is built with the flags of ``ops/_build.py`` into
``build/kernels/``, and its ptxas lines (registers, stack, spills, shared
memory of each entry) are printed.

The inputs, at each kernel's main-path width (``--num-envs``: the first N
envs); every launch goes through the wrapper's ``launcher`` into an output
allocated once:
- K2 at 4096 envs: the flagship's reset and paddle_ball sets, paddle_table
  and ball_rest on the raised-table scene (``sim/scripted.k2_inputs``), and
  its random-action states (``sim/scripted.k2_random_inputs``, as
  ``chip_smoke.py``'s ``timing``). K2-dr on the same with a channel drawn
  by ``DomainRandomizer.sample`` at global step 3000 (every term at full
  strength); K2-tau and K2-dr-tau with the same packs and the torque lanes.
- K1 at 4096 envs: those sets' joints, targets and efforts with the arm's
  base pose (``sim/scripted.k1_inputs``), through the terrain flagship's K1.
- K3 at 4096 envs: C8's reset, paddle_ball1, paddle_ball2 and ball_rest
  sets (``sim/scripted.k3_inputs``) and its random-action states
  (``sim/scripted.k3_random_inputs``, as ``chip_smoke.py``'s ``k3/rollout``)
  at <7, 2, 1>; the two-arm, two-ball check scene's ball_ball set (PD
  drive) and effort set (effort drive) at <3, 2, 2>; C11's reset,
  paddle_ball1, paddle_ball2 and ball_rest sets (efforts uniform in +-20)
  and its random-action states at <26, 2, 2> (``c11_*``). K3-tau runs on
  the same inputs with the packs of the same scenes with paddle sensors.
- K4 at 2048 envs: C10's stand, strike and fall sets
  (``sim/scripted.k4_inputs``) and its random-action states
  (``sim/scripted.k4_random_inputs``); K4-tau with the pack of C10's scene
  with a paddle sensor.
Prints one JSON line per kernel and set, and the card's name and power
limit; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C8 = "Humanoid12PingpongTiltG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
C11 = "HumanoidPingpong5ActorG1"
C11_EFFORT = 20.0   # N m: C11's sets' efforts are uniform in +-20 (effort drive)
K2_BUILDS = {"k2": (False, False), "k2dr": (True, False), "k2tau": (False, True),
             "k2drtau": (True, True)}   # (with_dr, with_torque)
KERNELS = ("k1",) + tuple(K2_BUILDS) + ("k3", "k3tau", "k4", "k4tau")
SOURCES = {"k1": "arm_step", **{k: "fused_substep" for k in K2_BUILDS},
           "k3": "fused_substep_multi", "k3tau": "fused_substep_multi",
           "k4": "fused_substep_floating", "k4tau": "fused_substep_floating"}


def _time_ms(fn, inner=20, repeats=5):
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


def _k2_cases(kernels, dev, b=4096):
    """(kernel, set, wrapper, inputs) of K1 and K2's builds at ``b`` envs."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.env.randomize import DomainRandomizer
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
    from isaacgym_tpu_torch.utils.config import load_task_config

    cfg = load_task_config(TASK)
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=b, device=dev)
    raised = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=b, device=dev,
                                     cfg=scripted.raised_table_cfg(cfg))
    k1 = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device=dev,
                                 cfg=rough_terrain_cfg(cfg, seed=0)).sim.arm_steps[0]
    rz = DomainRandomizer(cfg["task"]["randomization_params"], 7)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for i, kind in enumerate(("reset", "paddle_ball", "paddle_table", "ball_rest", "random")):
        e = raised if kind in ("paddle_table", "ball_rest") else env
        if kind == "random":
            ins = scripted.k2_random_inputs(env, b)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k2_inputs(e, kind, b, np.random.RandomState(601 + i)))
        chan = e.sim.dr_channel(rz.sample(gen, 3000, b)).contiguous()
        if "k1" in kernels:
            yield "k1", kind, k1, scripted.k1_inputs(e, ins)
        for kname, (dr, tau) in K2_BUILDS.items():
            if kname in kernels:
                k = F.FusedSubstep(e.sim.fused_substep.consts, with_dr=dr, with_torque=tau)
                yield kname, kind, k, ins + ((chan,) if dr else ())


def _k3_cases(kernels, dev, b=4096):
    """(kernel, set, wrapper, inputs) of K3 and K3-tau at ``b`` envs."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_draft_5actor import build_5actor_scene
    from isaacgym_tpu_torch.utils.config import load_task_config

    env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=b, device=dev)
    c8tau = Simulator(scripted.paddle_sensor_scene(load_task_config(C8), 2), device=dev)
    toys = {(d, tau): scripted.ToyEnv(d, device=dev, paddle_sensor=tau)
            for d in (DRIVE_POS, DRIVE_EFFORT) for tau in (False, True)}
    sets = [("reset", env, "reset", 0.0), ("paddle_ball1", env, "paddle_ball1", 0.0),
            ("paddle_ball2", env, "paddle_ball2", 0.0), ("ball_rest", env, "ball_rest", 0.0),
            ("random", env, None, 0.0), ("ball_ball", DRIVE_POS, "ball_ball", 0.0),
            ("effort", DRIVE_EFFORT, "paddle_ball1", 15.0)]
    for i, (name, e, kind, scale) in enumerate(sets):
        toy = e is not env
        if kind is None:
            ins = scripted.k3_random_inputs(env, b)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                toys[(e, False)] if toy else env, kind, b, np.random.RandomState(501 + i), scale))
        for kname, tau in (("k3", False), ("k3tau", True)):
            if kname not in kernels:
                continue
            sim = (toys[(e, tau)].sim if toy else c8tau if tau else env.sim)
            yield kname, name, sim.fused_substep_multi, ins
    env = isaacgym_tpu_torch.make(seed=0, task=C11, num_envs=b, device=dev)
    c11tau = Simulator(scripted.with_paddle_sensor(
        build_5actor_scene(load_task_config(C11)["sim"])), device=dev)
    for i, kind in enumerate(("reset", "paddle_ball1", "paddle_ball2", "ball_rest", "random")):
        if kind == "random":
            ins = scripted.k3_random_inputs(env, b)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                env, kind, b, np.random.RandomState(701 + i), C11_EFFORT))
        for kname, sim in (("k3", env.sim), ("k3tau", c11tau)):
            if kname in kernels:
                yield kname, f"c11_{kind}", sim.fused_substep_multi, ins


def _k4_cases(kernels, dev, b=2048):
    """(kernel, set, wrapper, inputs) of K4 and K4-tau at ``b`` envs."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=b, device=dev)
    sensor = Simulator(scripted.paddle_sensor_scene(load_task_config(C10), floating_base=True),
                       device=dev)
    for i, kind in enumerate(("stand", "strike", "fall", "random")):
        if kind == "random":
            ins = scripted.k4_random_inputs(env, b)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k4_inputs(env, kind, b, np.random.RandomState(401 + i)))
        for kname, k in (("k4", env.sim.fused_substep_floating),
                         ("k4tau", sensor.fused_substep_floating)):
            if kname in kernels:
                yield kname, kind, k, ins


def _launcher(kname, k, dev, stream):
    """(pack, output rows, shape, launcher(lib, x, y) -> run()) of wrapper
    ``k``: K1, K2 and K3 through the wrapper's own launcher, K4 through its
    library entry; run raises if the launch fails."""
    from isaacgym_tpu_torch.ops import arm_step as A
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    if kname == "k1":
        return A.pack_inputs, A.n_out(k.nd), [k.nd], lambda lib, x, y: k.launcher(x, y, lib=lib)
    if kname in K2_BUILDS:
        return (F.pack_inputs, F.n_out(k.nd, k.ng, k.with_torque), [k.nd],
                lambda lib, x, y: k.launcher(x, y, lib=lib))
    if kname in ("k3", "k3tau"):
        return (M.pack_inputs, M.n_out(k.nd_tot, k.nb, k.ng, k.with_torque), [k.nd, k.K, k.nb],
                lambda lib, x, y: k.launcher(x, y, lib=lib))
    entry = ("igt_fused_substep_floating_tau_launch" if k.with_torque
             else "igt_fused_substep_floating_launch")
    c = k.device_consts(dev)

    def launcher(lib, x, y):
        def run():
            if getattr(lib, entry)(c.data_ptr(), x.data_ptr(), y.data_ptr(), x.shape[1], k.nd,
                                   k.ng, stream) != 0:
                raise RuntimeError(f"{kname} launch failed")
        return run
    return FF.pack_inputs, FF.n_out(k.nd, k.ng, k.with_torque), [k.nd], launcher


def main(argv) -> int:
    import torch
    from isaacgym_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="+")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--num-envs", type=int, default=None)
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if set(kernels) - set(KERNELS):
        ap.error(f"--kernels: known {KERNELS}")
    trees = args.csrc
    jobs = [(src, i, d) for src in sorted({SOURCES[k] for k in kernels})
            for i, d in enumerate(trees)]

    def build(job):
        src, i, d = job
        deps = [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".cuh")]
        return _build._build(f"libigt_ab{i}_{src}.so", _build._nvcc(), _build.CUDA_FLAGS,
                             [os.path.join(d, f"{src}.cu")], deps)

    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc per build, all together
        paths = list(pool.map(build, jobs))
    libs = {}
    for (src, i, d), path in zip(jobs, paths):
        libs[(src, d)] = _build._bind(path)
        ptxas = [ln.strip() for ln in _build.build_logs.get(os.path.basename(path), "").splitlines()
                 if any(k in ln for k in ("Compiling entry", "Used", "stack frame"))]
        print(json.dumps({"tree": d, "source": src, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    if {"k1", *K2_BUILDS} & set(kernels):
        cases += list(_k2_cases(kernels, dev))
    if {"k3", "k3tau"} & set(kernels):
        cases += list(_k3_cases(kernels, dev))
    if {"k4", "k4tau"} & set(kernels):
        cases += list(_k4_cases(kernels, dev))
    for kname, kind, k, ins in cases:
        pack, rows, shape, launcher = _launcher(kname, k, dev, stream)
        b = ins[0].shape[0] if args.num_envs is None else min(args.num_envs, ins[0].shape[0])
        x = pack(*[t[:b] for t in ins])
        ys = {d: torch.empty((rows, b), device=dev) for d in trees}
        runs = {d: launcher(libs[(SOURCES[kname], d)], x, ys[d]) for d in trees}
        run = lambda d: runs[d]()
        for d in trees:
            run(d)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int32)   # -0 and +0 differ
        equal = {d: bool(torch.equal(bits(ys[d]), bits(ys[trees[0]]))) for d in trees}
        ms = {d: [] for d in trees}
        turns = list(trees) + list(reversed(trees))
        for d in turns + turns:
            ms[d].append(_time_ms(lambda: run(d)))
        print(json.dumps({"kernel": kname, "set": kind, "num_envs": b,
                          "shape": shape, "equal_to_first": equal,
                          "finite": bool(torch.isfinite(ys[trees[-1]]).all()),
                          "ms_in_turns": ms,
                          "median_ms": {d: statistics.median(v) for d, v in ms.items()}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
