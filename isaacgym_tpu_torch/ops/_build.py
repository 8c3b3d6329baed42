"""Build and bind the port's hand-written kernels: nvcc into a shared library
with a plain C interface, loaded with ``ctypes``.

The CUDA library is built at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <dir>/libigt_kernels.so csrc/*.cu

into ``build/kernels/<hash>/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the sources and flags, so a fresh checkout builds it once
and every scene reuses it. ``build_host_library`` compiles the host loop
``csrc/fused_substep_host.cpp`` (the kernel's own per-env body, for the CPU
test and the operation count) with g++ the same way. ``build_logs`` keeps
the compiler's output of the builds this process ran (``ptxas -v``: each
kernel's registers, stack and spills).

A failed build raises with the compiler's output. Nothing here falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")

CUDA_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

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


def build_cuda_library() -> ctypes.CDLL:
    """libigt_kernels.so: every ``csrc/*.cu`` in one nvcc call, for sm_90a."""
    path = _build("libigt_kernels.so", _nvcc(), CUDA_FLAGS,
                  sorted(glob.glob(os.path.join(CSRC, "*.cu"))), _headers())
    lib = _load(path)
    vp, ip = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.igt_fused_substep_launch, lib.igt_fused_substep_dr_launch):
        fn.argtypes = [vp, vp, vp, ip, ip, ip, vp]
        fn.restype = ip
    lib.igt_fused_layout.argtypes = [ip, vp, ip]
    lib.igt_fused_layout.restype = ip
    return lib


def build_host_library() -> ctypes.CDLL:
    """libigt_host.so: the kernel's per-env body in a plain host loop (g++)."""
    path = _build("libigt_host.so", "g++", HOST_FLAGS,
                  [os.path.join(CSRC, "fused_substep_host.cpp")], _headers())
    lib = _load(path)
    vp, ip = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.igt_fused_substep_host, lib.igt_fused_substep_dr_host):
        fn.argtypes = [vp, vp, vp, ip, ip]
        fn.restype = ip
    for fn in (lib.igt_fused_substep_count_ops, lib.igt_fused_substep_dr_count_ops):
        fn.argtypes = [vp, vp, vp, ip, ip]
        fn.restype = ctypes.c_longlong
    lib.igt_fused_layout.argtypes = [ip, vp, ip]
    lib.igt_fused_layout.restype = ip
    return lib
