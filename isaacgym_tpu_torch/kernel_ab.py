"""Compare K4, the floating-base kernel built without the torque lanes, from
two or more source trees on the card: the same C10 inputs through each
build, bit-for-bit equality with the first tree's outputs, and the time per
launch in turns (A B ... B A, twice over).

    python -m isaacgym_tpu_torch.kernel_ab BASE_CSRC [OTHER_CSRC ...]

Each argument is a ``csrc`` directory holding ``fused_substep_floating.cu``
and its headers (this package's own is ``isaacgym_tpu_torch/csrc``; a
parent commit's can be unpacked with ``git archive``). Each is built with
the flags of ``ops/_build.py`` into ``build/kernels/``. The inputs are
``sim/scripted.k4_inputs``' stand, strike and fall sets at C10's 2048 envs.
Prints one JSON line per set and the card's name and power limit; needs a
CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


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

    if len(argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    libs = {}
    for i, d in enumerate(argv):
        src = os.path.join(d, "fused_substep_floating.cu")
        deps = [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".cuh")]
        name = f"libigt_ab{i}_floating.so"
        libs[d] = _build._bind(_build._build(name, _build._nvcc(), _build.CUDA_FLAGS, [src], deps))
    dev = torch.device("cuda")
    b = 2048
    env = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNESSparse27DOFG1",
                                  num_envs=b)
    k = env.sim.fused_substep_floating
    c = k.device_consts(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for i, kind in enumerate(("stand", "strike", "fall")):
        ins = tuple(torch.as_tensor(a, device=dev) for a in
                    scripted.k4_inputs(env, kind, b, np.random.RandomState(401 + i)))
        x = FF.pack_inputs(*ins)
        ys = {d: torch.empty((FF.n_out(k.nd, k.ng), b), device=dev) for d in argv}
        run = lambda d: libs[d].igt_fused_substep_floating_launch(
            c.data_ptr(), x.data_ptr(), ys[d].data_ptr(), b, k.nd, k.ng, stream)
        for d in argv:
            if run(d) != 0:
                raise RuntimeError(f"launch failed for {d}")
        torch.cuda.synchronize()
        equal = {d: bool(torch.equal(ys[d], ys[argv[0]])) for d in argv}
        ms = {d: [] for d in argv}
        turns = list(argv) + list(reversed(argv))
        for d in turns + turns:
            ms[d].append(_time_ms(lambda: run(d)))
        print(json.dumps({"set": kind, "num_envs": b, "equal_to_first": equal, "ms_in_turns": ms,
                          "median_ms": {d: statistics.median(v) for d, v in ms.items()}}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
