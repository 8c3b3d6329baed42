"""Time K3's phases on the card with clock64 marks: where a warp's cycles go.

    python -m isaacgym_tpu_torch.phase_probe [--csrc DIR] [--num-envs 528,4096]

Copies a ``csrc`` directory (this package's by default) into
``build/probe/<hash>/``, inserts a mark before each phase group of K3's body
(the phase comments of ``art_warp.cuh`` and ``fused_substep_multi.cuh``; a
missing one raises), where lane 0 of each warp writes ``clock64()`` into a
device array, builds that copy with the flags of ``ops/_build.py``, and runs
K3 on C8's random-action states (``sim/scripted.k3_random_inputs``) at each
env count. Prints, per env count, the time per launch (CUDA events, median
of 7 runs of 20 launches) and each phase group's median cycles over the
envs, then the card's name, power limit and SM clocks. The marks add a few
instructions and registers, so the probe's times run a little above the
kernel's own. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys

C8 = "Humanoid12PingpongTiltG1"
SLOTS = 32   # marks per env in the device array
MAX_ENVS = 4096
#: (file, the line a mark goes before, the phase group that ends there)
MARKS = (
    ("fused_substep_multi.cuh", "  arms_dynamics<T, ND, K>(art, x, y, b, sB, NDT, sh, w);\n", None),
    ("art_warp.cuh", "  // FK with the velocity and bias propagation, one lane per articulation", "drive"),
    ("art_warp.cuh", "  // per link: world COM, inertia, force and moment\n  each_arm", "fk_vel"),
    ("art_warp.cuh", "  // every link's active columns", "link_terms"),
    ("art_warp.cuh", "  // each entry of M sums over its links in ascending l, a lane each", "columns"),
    ("art_warp.cuh", "  // row 0's pivot and y_0", "entries"),
    ("art_warp.cuh", "  // Cholesky in place (left-looking) with the forward solve", "pivot0"),
    ("art_warp.cuh", "  // qdd = L^-T y, one lane per articulation", "cholesky"),
    ("art_warp.cuh", "  // semi-implicit Euler, velocity clamp", "back_solve"),
    ("art_warp.cuh", "  // FK at the new q", "euler"),
    ("art_warp.cuh", "#undef IGT_IN\n#undef IGT_OUT\n}\n", "fk"),
    ("fused_substep_multi.cuh", "  // the statics in order: each (ball, static)", "flight_pairs"),
    ("fused_substep_multi.cuh", "  // each ball against every articulated geom of every articulation, in\n",
     "statics"),
    ("fused_substep_multi.cuh", "  if constexpr (NB == 2) {\n    one(w,", "ball_art"),
    ("fused_substep_multi.cuh", "  // articulated geoms vs the true statics: pairs pruned at pack time\n",
     "ball_pair"),
    ("fused_substep_multi.cuh", "  // outputs: qd, the impulse rows (and moment rows); each ball capped",
     "pairs"),
    ("fused_substep_multi.cuh", "  });\n#undef IGT_OUT\n}\n", "outputs"),
)
MARK = """#ifdef __CUDACC__
__device__ long long g_probe[%d * %d];
#endif
#ifdef __CUDA_ARCH__
#define IGT_MARK(i) do { if ((threadIdx.x & 31) == 0) \\
    g_probe[(blockIdx.x * 4 + threadIdx.x / 32) * %d + (i)] = clock64(); } while (0)
#else
#define IGT_MARK(i) do {} while (0)
#endif
""" % (MAX_ENVS, SLOTS, SLOTS)
READ = """
extern "C" int igt_probe_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(long long) * n);
}
"""


def marked_copy(csrc: str, root: str) -> str:
    """A copy of ``csrc`` with the marks, under ``root``/<hash of csrc>."""
    h = hashlib.sha256()
    for f in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    out = os.path.join(root, h.hexdigest()[:16])
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    edit = lambda f, old, new: _replace(os.path.join(out, f), old, new)
    edit("warp.cuh", "namespace igt {\n", MARK + "namespace igt {\n")
    for i, (f, anchor, _) in enumerate(MARKS):
        edit(f, anchor, f"  IGT_MARK({i});\n" + anchor)
    with open(os.path.join(out, "fused_substep_multi.cu"), "a") as fh:
        fh.write(READ)
    return out


def _replace(path, old, new):
    with open(path) as fh:
        s = fh.read()
    if old not in s:
        raise RuntimeError(f"phase probe: no anchor {old!r} in {path}")
    with open(path, "w") as fh:
        fh.write(s.replace(old, new, 1))


def main(argv) -> int:
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC)
    ap.add_argument("--num-envs", default="528,4096")
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    counts = [int(n) for n in args.num_envs.split(",")]
    if max(counts) > MAX_ENVS:
        ap.error(f"--num-envs: at most {MAX_ENVS}")
    src = marked_copy(args.csrc, os.path.join(os.path.dirname(_build.BUILD_ROOT), "probe"))
    path = _build._build("libigt_phase_probe.so", _build._nvcc(), _build.CUDA_FLAGS,
                         [os.path.join(src, "fused_substep_multi.cu")],
                         [os.path.join(src, f) for f in os.listdir(src) if f.endswith(".cuh")])
    lib = _build._bind(path)
    lib.igt_probe_read.argtypes, lib.igt_probe_read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build_logs.get(
        "libigt_phase_probe.so", "").splitlines() if "Used" in ln or "stack frame" in ln]}),
        flush=True)
    dev = torch.device("cuda")
    env = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=MAX_ENVS, device=dev)
    k = env.sim.fused_substep_multi
    ins = scripted.k3_random_inputs(env, MAX_ENVS)
    names = [g for _, _, g in MARKS[1:]]
    for b in counts:
        x = M.pack_inputs(*[t[:b] for t in ins])
        y = torch.empty((M.n_out(k.nd_tot, k.nb, k.ng), b), device=dev)
        run = k.launcher(x, y, lib=lib)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (MAX_ENVS * SLOTS))()
        if lib.igt_probe_read(ctypes.addressof(buf), MAX_ENVS * SLOTS) != 0:
            raise RuntimeError("phase probe: reading the marks failed")
        marks = np.frombuffer(buf, dtype=np.int64).reshape(MAX_ENVS, SLOTS)[:b]
        cycles = {g: int(np.median(marks[:, i + 1] - marks[:, i])) for i, g in enumerate(names)}
        times = []
        for _ in range(7):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 20)
        print(json.dumps({"num_envs": b, "ms": statistics.median(times), "cycles": cycles,
                          "total_cycles": int(np.median(marks[:, len(MARKS) - 1] - marks[:, 0]))}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
