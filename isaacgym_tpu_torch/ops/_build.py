"""Build and bind the port's hand-written kernels: nvcc into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is its own library, built at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -fmad=false
         -o <dir>/libigt_<name>.so csrc/<name>.cu

into ``build/kernels/<hash>/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the source, the headers and the flags, so a fresh
checkout builds it once and every scene reuses it; processes that need a
library another is building wait for that build (a file lock). ``build_cuda_libraries``
starts one nvcc per source, all together. ``build_host_library`` compiles
the host loop ``csrc/fused_substep_host.cpp`` (the kernels' own per-env
bodies, for the CPU tests and the operation counts) with g++ the same way,
one object per kernel family side by side, linked into one library.
``build_logs`` keeps the compiler's output of the builds this process ran
(``ptxas -v``: each kernel's registers, stack and spills).

A failed build raises with the compiler's output. Nothing here falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")

CUDA_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-fmad=false"]
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
#: ``-fmad=false``: no FMA contraction, so the kernels round op by op as
#: their plain versions and the JAX package's kernels do. At a paddle contact
#: the ball's spin change is the friction impulse times kappa / (r m) ~ 5e4,
#: and a contracted build's own rounding carried it past its gate: K3 at
#: humanoid 2's paddle (x ~ 3.2 m, where a float32 ulp is 4x humanoid 1's)
#: 2.1e-3 off, K2-dr-tau on a full-strength DR channel 1.8e-3 off, where the
#: float32 plain version was within 1e-3 of float64.

_loaded = {}
#: wall seconds of the builds this process ran, by library name
build_seconds = {}
#: compiler output (stdout + stderr) of the builds this process ran
build_logs = {}


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _build(name: str, compiler: str, flags, sources, extra_deps, parts=()) -> str:
    h = hashlib.sha256()
    for path in sorted(set(sources) | set(extra_deps)):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join([compiler] + list(flags) + [str(p) for p in parts]).encode())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    out = os.path.join(out_dir, name)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    # one build of a library at a time: a process that finds another building
    # it waits for that build (the lock is released when its holder exits)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        t0 = time.perf_counter()
        tmp = f"{out}.{os.getpid()}.tmp"
        if parts:
            # one object per part, compiled side by side, then linked
            objs = [f"{tmp}.{p}.o" for p in parts]
            with ThreadPoolExecutor(len(parts)) as pool:
                logs = list(pool.map(
                    lambda po: _run(compiler, [f for f in flags if f != "-shared"]
                                    + ["-c", f"-DIGT_HOST_PART={po[0]}", "-I", CSRC,
                                       "-o", po[1]] + list(sources)),
                    zip(parts, objs)))
            logs.append(_run(compiler, list(flags) + ["-o", tmp] + objs))
            for o in objs:
                os.remove(o)
        else:
            logs = [_run(compiler, list(flags) + ["-I", CSRC, "-o", tmp] + list(sources))]
        os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = "".join(logs)
        return out


def _run(compiler, args) -> str:
    """Run one compiler command; its output, or raise with it."""
    cmd = [compiler] + list(args)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"kernel build: compiler not found: {compiler}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _load(path: str) -> ctypes.CDLL:
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(path)
    return _loaded[path]


def _headers():
    return glob.glob(os.path.join(CSRC, "*.cuh"))


_VP, _IP = ctypes.c_void_p, ctypes.c_int
#: the C functions of the libraries: name -> (argument types, result type)
_SIGNATURES = {
    "igt_fused_substep_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_dr_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_multi_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_layout": ([_IP, _VP, _IP], _IP),
    "igt_arm_step_launch": ([_VP, _VP, _VP, _IP, _IP, _VP], _IP),
    "igt_arm_layout": ([_IP, _VP, _IP], _IP),
    "igt_arm_step_host": ([_VP, _VP, _VP, _IP, _IP], _IP),
    "igt_arm_step_count_ops": ([_VP, _VP, _VP, _IP, _IP], ctypes.c_longlong),
    "igt_multi_layout": ([_IP, _IP, _VP, _IP], _IP),
    # the blocks of one articulation's tree in a K3 pack (tree_warp.cuh)
    "igt_multi_tree": ([_VP, _IP, _VP, _IP], _IP),
    "igt_fused_substep_floating_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _VP], _IP),
    "igt_floating_layout": ([_IP, _VP, _IP], _IP),
    "igt_fused_substep_floating_host": ([_VP, _VP, _VP, _IP, _IP], _IP),
    "igt_fused_substep_floating_count_ops": ([_VP, _VP, _VP, _IP, _IP], ctypes.c_longlong),
    "igt_fused_substep_host": ([_VP, _VP, _VP, _IP, _IP], _IP),
    "igt_fused_substep_dr_host": ([_VP, _VP, _VP, _IP, _IP], _IP),
    "igt_fused_substep_count_ops": ([_VP, _VP, _VP, _IP, _IP], ctypes.c_longlong),
    "igt_fused_substep_dr_count_ops": ([_VP, _VP, _VP, _IP, _IP], ctypes.c_longlong),
    "igt_fused_substep_multi_host": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP], _IP),
    "igt_fused_substep_multi_count_ops": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP],
                                          ctypes.c_longlong),
    # the torque-lane builds (K2-tau with a with_dr flag, K3-tau, K4-tau)
    "igt_fused_substep_tau_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_multi_tau_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_tau_host": ([_VP, _VP, _VP, _IP, _IP, _IP], _IP),
    "igt_fused_substep_tau_count_ops": ([_VP, _VP, _VP, _IP, _IP, _IP], ctypes.c_longlong),
    "igt_fused_substep_multi_tau_host": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP], _IP),
    "igt_fused_substep_multi_tau_count_ops": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP],
                                              ctypes.c_longlong),
    "igt_fused_substep_floating_tau_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_floating_tau_host": ([_VP, _VP, _VP, _IP, _IP], _IP),
    "igt_fused_substep_floating_tau_count_ops": ([_VP, _VP, _VP, _IP, _IP], ctypes.c_longlong),
    # K4 or K4-tau (with_torque) on the host, each phase's lanes in reverse order
    "igt_fused_substep_floating_reversed_host": ([_VP, _VP, _VP, _IP, _IP, _IP], _IP),
    # K4's or K4-tau's (with_torque) envs per block, blocks per SM asked and found
    "igt_floating_occupancy": ([_IP, _VP, _IP], _IP),
    # K3 or K3-tau (with_torque) on the host, each phase's lanes in reverse order
    "igt_fused_substep_multi_reversed_host": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP, _IP], _IP),
    # the same for K3 or K3-tau at (nd, k, nb)
    "igt_multi_occupancy": ([_IP, _IP, _IP, _IP, _VP, _IP], _IP),
    # K2's build (with_dr, with_torque) on the host, each phase's lanes in reverse order
    "igt_fused_substep_reversed_host": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP], _IP),
    # K1 the same
    "igt_arm_step_reversed_host": ([_VP, _VP, _VP, _IP, _IP], _IP),
    # K2's build (with_dr, with_torque) and K1: envs and warps per block, blocks per SM
    "igt_fused_occupancy": ([_IP, _IP, _VP, _IP], _IP),
    "igt_arm_occupancy": ([_VP, _IP], _IP),
}


def _bind(path: str) -> ctypes.CDLL:
    lib = _load(path)
    for name, (args, res) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def cuda_sources():
    """Names of the CUDA sources, ``csrc/<name>.cu``."""
    return sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu")))


def cuda_library(name: str) -> ctypes.CDLL:
    """libigt_<name>.so: ``csrc/<name>.cu`` built by nvcc for sm_90a."""
    return _bind(_build(f"libigt_{name}.so", _nvcc(), CUDA_FLAGS,
                        [os.path.join(CSRC, f"{name}.cu")], _headers()))


def build_cuda_libraries() -> dict:
    """Every ``csrc/*.cu``, one nvcc each, all started together -> name -> library."""
    names = cuda_sources()
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(cuda_library, names)))


#: the host library's parts (``IGT_HOST_PART`` in fused_substep_host.cpp: K1,
#: K2's builds, K3, K4, K3-tau, K3's reversed lanes), compiled side by side:
#: about 12 s of wall where the one compile takes about 40
HOST_PARTS = (1, 2, 3, 4, 5, 6)


def build_host_library() -> ctypes.CDLL:
    """libigt_host.so: the kernels' per-env bodies in a plain host loop (g++)."""
    return _bind(_build("libigt_host.so", "g++", HOST_FLAGS,
                        [os.path.join(CSRC, "fused_substep_host.cpp")], _headers(),
                        parts=HOST_PARTS))
