"""Compare K4 and K4-tau, the floating-base kernel built without and with
the torque lanes, from two or more source trees on the card: the same C10
inputs through each build, bit-for-bit equality with the first tree's
outputs, and the time per launch in turns (A B ... B A, twice over).

    python -m isaacgym_tpu_torch.kernel_ab BASE_CSRC [OTHER_CSRC ...] [--num-envs N]

Each argument is a ``csrc`` directory holding ``fused_substep_floating.cu``
and its headers (this package's own is ``isaacgym_tpu_torch/csrc``; a
parent commit's can be unpacked with ``git archive``). Each is built with
the flags of ``ops/_build.py`` into ``build/kernels/``, and its ptxas lines
(registers, stack, spills, shared memory of each entry) are printed. The
inputs are ``sim/scripted.k4_inputs``' stand, strike and fall sets and the
random-action states (``sim/scripted.k4_random_inputs``, as
``chip_smoke.py``'s ``k4/random``), at
C10's 2048 envs by default (``--num-envs``: the first N of them); K4-tau
runs on the same inputs with the pack of C10's scene with a paddle sensor.
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

C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
SETS = ("stand", "strike", "fall", "random")


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


def main(argv) -> int:
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="+")
    ap.add_argument("--num-envs", type=int, default=2048)
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    trees = args.csrc
    libs = {}
    for i, d in enumerate(trees):
        src = os.path.join(d, "fused_substep_floating.cu")
        deps = [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".cuh")]
        name = f"libigt_ab{i}_floating.so"
        libs[d] = _build._bind(_build._build(name, _build._nvcc(), _build.CUDA_FLAGS, [src], deps))
        ptxas = [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
                 if any(k in ln for k in ("Compiling entry", "Used", "stack frame"))]
        print(json.dumps({"tree": d, "ptxas": ptxas}), flush=True)
    dev = torch.device("cuda")
    b = args.num_envs
    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=2048)
    sensor = Simulator(scripted.paddle_sensor_scene(load_task_config(C10), floating_base=True),
                       device=dev)
    kernels = {"k4": (env.sim.fused_substep_floating, "igt_fused_substep_floating_launch"),
               "k4tau": (sensor.fused_substep_floating, "igt_fused_substep_floating_tau_launch")}
    stream = torch.cuda.current_stream().cuda_stream
    for i, kind in enumerate(SETS):
        if kind == "random":
            ins = scripted.k4_random_inputs(env, 2048)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k4_inputs(env, kind, 2048, np.random.RandomState(401 + i)))
        x = FF.pack_inputs(*[t[:b] for t in ins])
        for kname, (k, entry) in kernels.items():
            c = k.device_consts(dev)
            ys = {d: torch.empty((FF.n_out(k.nd, k.ng, k.with_torque), b), device=dev)
                  for d in trees}
            run = lambda d: getattr(libs[d], entry)(
                c.data_ptr(), x.data_ptr(), ys[d].data_ptr(), b, k.nd, k.ng, stream)
            for d in trees:
                if run(d) != 0:
                    raise RuntimeError(f"{kname} launch failed for {d}")
            torch.cuda.synchronize()
            equal = {d: bool(torch.equal(ys[d], ys[trees[0]])) for d in trees}
            ms = {d: [] for d in trees}
            turns = list(trees) + list(reversed(trees))
            for d in turns + turns:
                ms[d].append(_time_ms(lambda: run(d)))
            print(json.dumps({"kernel": kname, "set": kind, "num_envs": b,
                              "equal_to_first": equal,
                              "finite": bool(torch.isfinite(ys[trees[-1]]).all()),
                              "ms_in_turns": ms,
                              "median_ms": {d: statistics.median(v) for d, v in ms.items()}}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
