"""K4 and K4-tau, one launch each per case, from a process that holds no
PyTorch: the CUDA runtime and the kernel library through ``ctypes``, so
``compute-sanitizer`` sees the kernels' own launches and nothing else.

    python isaacgym_tpu_torch/sanitize_k4.py pack DIR
    compute-sanitizer --tool racecheck python isaacgym_tpu_torch/sanitize_k4.py launch DIR
    compute-sanitizer --tool memcheck python isaacgym_tpu_torch/sanitize_k4.py launch DIR

``pack`` (PyTorch on the CPU) builds the kernel library and the host loop
(``ops/_build.py``) and writes to DIR each case's scene pack, packed inputs
and the host build's outputs: C10's strike set (K4, and K4-tau with the
paddle sensor scene's pack) and its table set on the raised-table scene
with the statics copied twice (``sim/scripted.with_static_copies``: 54
art-vs-static pairs, more than a warp's chunk of 32), at 8 envs.
``launch`` (numpy and ctypes only) runs each case once on the card and
prints one JSON line per case: the launch's return code, whether the
outputs are finite and their largest difference from the host build's.
Exits 1 if a launch fails or an output is not finite.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import sys

import numpy as np

C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
B = 8
SHIFTS = [(0.01, -0.01, -0.001), (0.02, -0.02, -0.002)]


def pack(out_dir: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    os.makedirs(out_dir, exist_ok=True)
    lib = _build._build("libigt_fused_substep_floating.so", _build._nvcc(), _build.CUDA_FLAGS,
                        [os.path.join(_build.CSRC, "fused_substep_floating.cu")],
                        _build._headers())
    host = _build.build_host_library()
    cases = []
    for raised, kind, seed in ((False, "strike", 61), (True, "table", 73)):
        cfg = load_task_config(C10)
        if raised:
            cfg = scripted.raised_table_cfg(cfg)
        env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B, device="cpu", cfg=cfg)
        tau = Simulator(scripted.paddle_sensor_scene(cfg, floating_base=True), device="cpu")
        ins = [torch.as_tensor(a) for a in
               scripted.k4_inputs(env, kind, B, np.random.RandomState(seed))]
        x = FF.pack_inputs(*ins).contiguous()
        for with_torque, k in ((False, env.sim.fused_substep_floating),
                               (True, tau.fused_substep_floating)):
            consts = k.consts if kind == "strike" else scripted.with_static_copies(k.consts,
                                                                                   SHIFTS)
            c = torch.as_tensor(consts)
            ng = int(consts[FF.C_NART])
            y = torch.zeros((FF.n_out(k.nd, ng, with_torque), B))
            fn = (host.igt_fused_substep_floating_tau_host if with_torque
                  else host.igt_fused_substep_floating_host)
            if fn(c.data_ptr(), x.data_ptr(), y.data_ptr(), B, k.nd) != 0:
                raise RuntimeError(f"host build failed on {kind}")
            name = f"{'k4tau' if with_torque else 'k4'}_{kind}"
            for part, a in (("consts", c), ("x", x), ("y_host", y)):
                np.save(os.path.join(out_dir, f"{name}_{part}.npy"), a.numpy())
            cases.append({"name": name, "with_torque": with_torque, "nd": k.nd, "ng": ng,
                          "n_pair": int(consts[FF.C_NPAIR])})
    with open(os.path.join(out_dir, "cases.json"), "w") as f:
        json.dump({"library": lib, "cases": cases}, f)


def _cudart():
    root = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    paths = sorted(glob.glob(os.path.join(root, "lib64", "libcudart.so*")))
    if not paths:
        raise SystemExit(f"no libcudart under {root}/lib64")
    rt = ctypes.CDLL(paths[0])
    rt.cudaMalloc.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t]
    rt.cudaMemcpy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    rt.cudaFree.argtypes = [ctypes.c_void_p]
    return rt


def launch(in_dir: str) -> int:
    with open(os.path.join(in_dir, "cases.json")) as f:
        spec = json.load(f)
    rt = _cudart()
    lib = ctypes.CDLL(spec["library"])
    vp, ip = ctypes.c_void_p, ctypes.c_int
    h2d, d2h = 1, 2
    bad = 0
    for case in spec["cases"]:
        load = lambda part: np.load(os.path.join(in_dir, f"{case['name']}_{part}.npy"))
        host = {p: np.ascontiguousarray(load(p), np.float32) for p in ("consts", "x", "y_host")}
        dev = {}
        for p, a in host.items():
            ptr = ctypes.c_void_p()
            if rt.cudaMalloc(ctypes.byref(ptr), a.nbytes) != 0:
                raise SystemExit(f"cudaMalloc failed for {case['name']}")
            dev[p] = ptr
            if p != "y_host":
                rt.cudaMemcpy(ptr, a.ctypes.data, a.nbytes, h2d)
        fn = getattr(lib, "igt_fused_substep_floating_tau_launch" if case["with_torque"]
                     else "igt_fused_substep_floating_launch")
        fn.argtypes, fn.restype = [vp, vp, vp, ip, ip, ip, vp], ip
        rc = fn(dev["consts"], dev["x"], dev["y_host"], B, case["nd"], case["ng"], None)
        sync = rt.cudaDeviceSynchronize()
        y = np.empty_like(host["y_host"])
        rt.cudaMemcpy(y.ctypes.data, dev["y_host"], y.nbytes, d2h)
        for ptr in dev.values():
            rt.cudaFree(ptr)
        finite = bool(np.isfinite(y).all())
        bad += rc != 0 or sync != 0 or not finite
        print(json.dumps({"case": case["name"], "n_pair": case["n_pair"], "launch_rc": rc,
                          "sync_rc": sync, "finite": finite,
                          "max_abs_diff_to_host": float(np.abs(y - host["y_host"]).max())}),
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("pack", "launch"):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    if sys.argv[1] == "pack":
        pack(sys.argv[2])
    else:
        sys.exit(launch(sys.argv[2]))
