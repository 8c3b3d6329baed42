"""Time a kernel's phases on the card with clock64 marks: where a warp's
cycles go.

    python -m isaacgym_tpu_torch.phase_probe [--kernel k3|k2|k1] [--csrc DIR]
        [--num-envs 528,4096] [--set random] [--scene c8|c11]

Copies a ``csrc`` directory (this package's by default) into
``build/probe/<hash>/``, inserts a mark before each phase group of the
kernel's body (the phase comments of ``art_warp.cuh``, whose dynamics K1, K2
and K3 share, and of the kernel's own header: ``fused_substep_multi.cuh``
for K3, ``fused_substep_warp.cuh`` for K2, ``arm_step.cuh`` for K1; a
missing one raises), where lane 0 of each warp writes ``clock64()`` into a
device array, builds that copy with the flags of ``ops/_build.py``, and runs
the kernel on its random-action states (``sim/scripted.k3_random_inputs``
on C8, or with ``--scene c11`` on C11 at <26, 2, 2>; ``k2_random_inputs``
on the flagship, and for K1 those states'
joints with the arm's base pose, ``k1_inputs``; ``--set``: another of the
flagship's sets, ``scripted.k2_inputs``) at each env count. Prints,
per env count, the time per launch (CUDA events, median of 7 runs of 20
launches), each phase group's median and 90th-percentile cycles over the
warps and the whole body's median, 90th percentile and maximum (the
slowest warps set a launch's time), then the card's name, power limit and
SM clocks. The marks add a few instructions
and registers, so the probe's times run a little above the kernel's own.
Needs a CUDA device.
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
C11 = "HumanoidPingpong5ActorG1"
TASK = "HumanoidPingpongTiltNoEarlyStopG1"
SLOTS = 32   # marks per warp in the device array
MAX_ENVS = 4096
#: art_warp.cuh's dynamics phase groups: (file, the line a mark goes before,
#: the phase group that ends there); K3 factors M a phase per column, K1 and
#: K2 on one lane (SERIAL_FACTOR)
DYNAMICS = (
    ("art_warp.cuh", "  // FK with the velocity and bias propagation, one lane per articulation", "drive"),
    ("art_warp.cuh", "  // per link: world COM, inertia, force and moment\n  each_arm", "fk_vel"),
    ("art_warp.cuh", "  // every link's active columns", "link_terms"),
    ("art_warp.cuh", "  // each entry of M sums over its links in ascending l, a lane each", "columns"),
)
FACTOR_PHASES = (
    ("art_warp.cuh", "    // row 0's pivot and y_0", "entries"),
    ("art_warp.cuh", "    // Cholesky in place (left-looking) with the forward solve", "pivot0"),
    ("art_warp.cuh", "    // qdd = L^-T y, one lane per articulation", "cholesky"),
    ("art_warp.cuh", "  // semi-implicit Euler, velocity clamp", "back_solve"),
)
FACTOR_SERIAL = (
    ("art_warp.cuh", "    // the factor, the forward and the back solve for qdd on one lane per",
     "entries"),
    ("art_warp.cuh", "  // semi-implicit Euler, velocity clamp", "factor"),
)
INTEGRATE = (
    ("art_warp.cuh", "  // FK at the new q", "euler"),
    ("art_warp.cuh", "}\n\n// --------------------------------------------------------------- contacts --",
     "fk"),
)
#: tree_warp.cuh's dynamics phase groups (K3 at <26, 2, 2>, C11)
TREE = (
    ("tree_warp.cuh", "  // the blocks, one lane per articulation", "drive"),
    ("tree_warp.cuh", "  // FK with the velocity and bias propagation, one lane per block", "blocks"),
    ("tree_warp.cuh", "  // per link: world COM, inertia, force and moment; per DOF i", "fk_vel"),
    ("tree_warp.cuh", "  // every link's active columns, a lane per link", "link_terms"),
    ("tree_warp.cuh", "  // each entry of a block's M sums over its links", "columns"),
    ("tree_warp.cuh", "  // each block's first pivot and its y", "entries"),
    ("tree_warp.cuh", "  // Cholesky in place (left-looking) with the forward solve, the blocks",
     "pivot0"),
    ("tree_warp.cuh", "  // qdd = L^-T y, one lane per block", "cholesky"),
    ("tree_warp.cuh", "  // semi-implicit Euler, velocity clamp, joint limits", "back_solve"),
    ("tree_warp.cuh", "  // FK at the new q, one lane per block", "euler"),
    ("tree_warp.cuh", "  return true;\n}\n", "fk"),
)
#: K3's contact phase groups, after its dynamics
K3_CONTACTS = (
    ("fused_substep_multi.cuh", "  // the statics in order: each (ball, static)", "flight_pairs"),
        ("fused_substep_multi.cuh",
         "  // each ball against every articulated geom of every articulation, in\n", "statics"),
        ("fused_substep_multi.cuh", "  if constexpr (NB == 2) {\n    one(w,", "ball_art"),
        ("fused_substep_multi.cuh",
         "  // articulated geoms vs the true statics: pairs pruned at pack time\n", "ball_pair"),
        ("fused_substep_multi.cuh",
         "  // outputs: qd, the impulse rows (and moment rows); each ball capped", "pairs"),
        ("fused_substep_multi.cuh", "  });\n#undef IGT_OUT\n}\n", "outputs"))
K3_START = (("fused_substep_multi.cuh", "  const ArmRows<ND> rows{x, y, b, sB, NDT};\n", None),)
#: each kernel's marks (K3 at <26, 2, 2>: "k3c11"), the first before its dynamics
MARKS = {
    "k3": K3_START + DYNAMICS + FACTOR_PHASES + INTEGRATE + K3_CONTACTS,
    "k3c11": K3_START + TREE + K3_CONTACTS,
    "k2": (("fused_substep_warp.cuh",
            "  arms_dynamics<T, ND, G, WITH_DR, true>([c](int) { return c; }, io, sh, w);\n",
            None),)
    + DYNAMICS + FACTOR_SERIAL + INTEGRATE + (
        ("fused_substep_warp.cuh", "  // the statics in order: each env's statics", "flight_pairs"),
        ("fused_substep_warp.cuh", "  // each env's ball against its articulated geoms in order",
         "statics"),
        ("fused_substep_warp.cuh",
         "  // articulated geoms vs the true statics: pairs pruned at pack time\n", "ball_art"),
        ("fused_substep_warp.cuh", "  // outputs: qd, the impulse rows (then the moment rows)",
         "pairs"),
        ("fused_substep_warp.cuh", "}\n\n}  // namespace igt\n", "outputs")),
    "k1": (("arm_step.cuh",
            "  arms_dynamics<T, ND, G, false, true>([c](int) { return c; }, io, sh, w);\n", None),)
    + DYNAMICS + FACTOR_SERIAL + INTEGRATE + (("arm_step.cuh", "}\n\n}  // namespace igt\n", "outputs"),),
}
SOURCES = {"k3": "fused_substep_multi", "k3c11": "fused_substep_multi", "k2": "fused_substep",
           "k1": "arm_step"}
ENVS_PER_WARP = {"k3": 1, "k3c11": 1, "k2": 2, "k1": 4}   # K2_ENVS and K1_ENVS of the headers
MARK = """#ifdef __CUDACC__
__device__ long long g_probe[%d * %d];
#endif
#ifdef __CUDA_ARCH__
#define IGT_MARK(i) do { if ((threadIdx.x & 31) == 0) \\
    g_probe[(blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * %d + (i)] = clock64(); \
    } while (0)
#else
#define IGT_MARK(i) do {} while (0)
#endif
""" % (MAX_ENVS, SLOTS, SLOTS)
READ = """
extern "C" int igt_probe_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(long long) * n);
}
"""


def marked_copy(csrc: str, root: str, kernel: str = "k3") -> str:
    """A copy of ``csrc`` with ``kernel``'s marks, under ``root``/<hash of
    csrc and kernel>."""
    h = hashlib.sha256(kernel.encode())
    for f in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    out = os.path.join(root, h.hexdigest()[:16])
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    edit = lambda f, old, new: _replace(os.path.join(out, f), old, new)
    edit("warp.cuh", "namespace igt {\n", MARK + "namespace igt {\n")
    for i, (f, anchor, _) in enumerate(MARKS[kernel]):
        edit(f, anchor, f"  IGT_MARK({i});\n" + anchor)
    with open(os.path.join(out, f"{SOURCES[kernel]}.cu"), "a") as fh:
        fh.write(READ)
    return out


def _replace(path, old, new):
    with open(path) as fh:
        s = fh.read()
    if old not in s:
        raise RuntimeError(f"phase probe: no anchor {old!r} in {path}")
    with open(path, "w") as fh:
        fh.write(s.replace(old, new, 1))


def _cases(kernel, dev, kind="random", scene="c8"):
    """(wrapper, inputs at MAX_ENVS, pack, output rows) of ``kernel`` on the
    state set ``kind``: the random-action states (K3's of ``scene``), or for
    K2 and K1 one of the flagship's ``scripted.k2_inputs`` sets."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import arm_step as A
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
    from isaacgym_tpu_torch.utils.config import load_task_config

    if kernel == "k3":
        if kind != "random":
            raise ValueError("phase probe: K3 runs on its random-action states only")
        env = isaacgym_tpu_torch.make(seed=0, task={"c8": C8, "c11": C11}[scene],
                                      num_envs=MAX_ENVS, device=dev)
        k = env.sim.fused_substep_multi
        return (k, scripted.k3_random_inputs(env, MAX_ENVS), M.pack_inputs,
                M.n_out(k.nd_tot, k.nb, k.ng))
    cfg = load_task_config(TASK)
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=MAX_ENVS, device=dev,
                                  cfg=scripted.raised_table_cfg(cfg)
                                  if kind in ("paddle_table", "ball_rest") else cfg)
    ins = (scripted.k2_random_inputs(env, MAX_ENVS) if kind == "random" else
           tuple(torch.as_tensor(a, device=dev) for a in scripted.k2_inputs(
               env, kind, MAX_ENVS, np.random.RandomState(601))))
    if kernel == "k2":
        k = env.sim.fused_substep
        return k, ins, F.pack_inputs, F.n_out(k.nd, k.ng)
    terrain = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device=dev,
                                      cfg=rough_terrain_cfg(cfg, seed=0))
    return (terrain.sim.arm_steps[0], scripted.k1_inputs(env, ins), A.pack_inputs,
            A.n_out(7))


def main(argv) -> int:
    import numpy as np
    import torch
    from isaacgym_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="k3", choices=("k1", "k2", "k3"))
    ap.add_argument("--csrc", default=_build.CSRC)
    ap.add_argument("--num-envs", default="528,4096")
    ap.add_argument("--set", default="random",
                    help="K2 and K1: random, or a scripted.k2_inputs kind")
    ap.add_argument("--scene", default="c8", choices=("c8", "c11"),
                    help="K3: C8's states at <7, 2, 1> or C11's at <26, 2, 2>")
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    counts = [int(n) for n in args.num_envs.split(",")]
    if max(counts) > MAX_ENVS:
        ap.error(f"--num-envs: at most {MAX_ENVS}")
    key = "k3c11" if (args.kernel, args.scene) == ("k3", "c11") else args.kernel
    marks_of = MARKS[key]
    src = marked_copy(args.csrc, os.path.join(os.path.dirname(_build.BUILD_ROOT), "probe"), key)
    name = f"libigt_phase_probe_{key}.so"
    path = _build._build(name, _build._nvcc(), _build.CUDA_FLAGS,
                         [os.path.join(src, f"{SOURCES[key]}.cu")],
                         [os.path.join(src, f) for f in os.listdir(src) if f.endswith(".cuh")])
    lib = _build._bind(path)
    lib.igt_probe_read.argtypes, lib.igt_probe_read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    print(json.dumps({"kernel": args.kernel, "ptxas": [ln.strip() for ln in _build.build_logs.get(
        name, "").splitlines() if "Used" in ln or "stack frame" in ln]}), flush=True)
    dev = torch.device("cuda")
    k, ins, pack, rows = _cases(args.kernel, dev, args.set, args.scene)
    names = [g for _, _, g in marks_of[1:]]
    for b in counts:
        x = pack(*[t[:b] for t in ins])
        y = torch.empty((rows, b), device=dev)
        run = k.launcher(x, y, lib=lib)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (MAX_ENVS * SLOTS))()
        if lib.igt_probe_read(ctypes.addressof(buf), MAX_ENVS * SLOTS) != 0:
            raise RuntimeError("phase probe: reading the marks failed")
        warps = -(-b // ENVS_PER_WARP[key])
        marks = np.frombuffer(buf, dtype=np.int64).reshape(MAX_ENVS, SLOTS)[:warps]
        span = lambda i, j: marks[:, j] - marks[:, i]
        cycles = {g: int(np.median(span(i, i + 1))) for i, g in enumerate(names)}
        p90 = {g: int(np.percentile(span(i, i + 1), 90)) for i, g in enumerate(names)}
        total = span(0, len(marks_of) - 1)
        times = []
        for _ in range(7):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 20)
        print(json.dumps({"kernel": args.kernel, "scene": args.scene, "set": args.set,
                          "num_envs": b, "ms": statistics.median(times),
                          "cycles": cycles, "cycles_p90": p90,
                          "total_cycles": int(np.median(total)),
                          "total_cycles_p90": int(np.percentile(total, 90)),
                          "total_cycles_max": int(total.max())}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
