"""Build and bind the port's hand-written kernels: nvcc into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` is its own library, built at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -fmad=false
         -o <dir>/libigt_<name>.so csrc/<name>.cu

into ``build/kernels/<hash>/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the source, the headers and the flags, so a fresh
checkout builds it once and every scene reuses it. ``build_cuda_libraries``
starts one nvcc per source, all together. ``build_host_library`` compiles
the host loop ``csrc/fused_substep_host.cpp`` (the kernels' own per-env
bodies, for the CPU tests and the operation counts) with g++ the same way.
``build_logs`` keeps the compiler's output of the builds this process ran
(``ptxas -v``: each kernel's registers, stack and spills).

A failed build raises with the compiler's output. Nothing here falls back.
"""

from __future__ import annotations

import ctypes
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


def _build(name: str, compiler: str, flags, sources, extra_deps) -> str:
    h = hashlib.sha256()
    for path in sorted(set(sources) | set(extra_deps)):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join([compiler] + list(flags)).encode())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    out = os.path.join(out_dir, name)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler] + list(flags) + ["-I", CSRC, "-o", tmp] + list(sources)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"kernel build: compiler not found: {compiler}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees a partial file
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr
    return out


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
    "igt_multi_layout": ([_IP, _IP, _VP, _IP], _IP),
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
    # the torque-lane builds (K2-tau with a with_dr flag, K3-tau)
    "igt_fused_substep_tau_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_multi_tau_launch": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP, _IP, _VP], _IP),
    "igt_fused_substep_tau_host": ([_VP, _VP, _VP, _IP, _IP, _IP], _IP),
    "igt_fused_substep_tau_count_ops": ([_VP, _VP, _VP, _IP, _IP, _IP], ctypes.c_longlong),
    "igt_fused_substep_multi_tau_host": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP], _IP),
    "igt_fused_substep_multi_tau_count_ops": ([_VP, _VP, _VP, _IP, _IP, _IP, _IP],
                                              ctypes.c_longlong),
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


def build_host_library() -> ctypes.CDLL:
    """libigt_host.so: the kernels' per-env bodies in a plain host loop (g++)."""
    return _bind(_build("libigt_host.so", "g++", HOST_FLAGS,
                        [os.path.join(CSRC, "fused_substep_host.cpp")], _headers()))
