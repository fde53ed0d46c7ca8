"""Builds and binds the port's CUDA kernels, and makes sure the shared host
library exists.

csrc/*.cu compile with nvcc for sm_90a into build/libartc_cuda.so, a shared
library with a plain C interface loaded through ctypes, on first use and
again whenever a source is newer than the library. Every C entry launches on
the stream it is given and returns cudaGetLastError(); `launch` raises on a
nonzero code and counts the launch under its kernel's name.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD, "libartc_cuda.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# One launch counter per kernel; a wrapper adds one where it launches.
launches = {"wire_expand": 0, "dual0_expand": 0, "model_pass_v4": 0,
            "lane_scan_dev": 0, "lane_compact": 0, "model_pass_v2": 0,
            "lane_scan": 0, "model_pass_dict": 0, "model_pass": 0}

# C entry -> argument kinds ('p' pointer, 'i' 64-bit int); the stream follows.
_SIGNATURES = {
    "artc_wire_expand": "p" * 11 + "i" * 12,
    "artc_dual0_expand": "p" * 5 + "i" * 3,
    "artc_model_pass_v4": "p" * 13 + "i" * 16,
    "artc_lane_scan_dev": "p" * 6 + "i" * 3,
    "artc_lane_compact": "p" * 4 + "i" * 3,
    "artc_model_pass_v2": "p" * 15 + "i" * 15,
    "artc_lane_scan": "p" * 7 + "i" * 2,
    "artc_model_pass_dict": "p" * 13 + "i" * 10,
    "artc_model_pass": "p" * 11 + "i" * 9,
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_longlong}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def build() -> str:
    """Compiles csrc/*.cu into LIB_PATH if it is missing or older than a
    source; returns its path. ptxas's per-kernel register report lands in
    build/nvcc.log."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = sources + glob.glob(os.path.join(CSRC, "*.cuh"))
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= max(
            os.path.getmtime(p) for p in deps):
        return LIB_PATH
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                         capture_output=True, text=True)
    with open(os.path.join(BUILD, "nvcc.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, kinds in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
        lib.artc_cuda_error_string.restype = ctypes.c_char_p
        lib.artc_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Calls C entry `entry` on `device`'s current stream with `args`
    (tensors pass their data pointer), raises on a CUDA error, and counts
    one launch of `kernel`."""
    lib = load()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*cargs, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.artc_cuda_error_string(rc).decode()})")
    launches[kernel] += 1


def check_cuda(name: str, *tensors: torch.Tensor, dtype=torch.int32) -> None:
    """Validates kernel inputs: one CUDA device, the dtype, contiguity."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _git_rev(cwd: str) -> str:
    try:
        res = subprocess.run(["git", "rev-parse", "--short=12", "HEAD"], cwd=cwd,
                             capture_output=True, text=True)
    except FileNotFoundError:
        return "nogit"
    rev = res.stdout.strip()
    return rev if res.returncode == 0 and rev else "nogit"


def ensure_host_lib() -> str:
    """Makes sure avrecode_tpu's native host library is built and current,
    safely against other processes doing the same.

    host.build_native runs cmake + ninja in one shared build directory with
    no lock, so concurrent callers (pytest-xdist workers, two scripts) can
    link a library from an object file another compile is still writing,
    and then load it. Here the build runs under an exclusive flock on a lock
    file beside the library: the holder re-checks staleness, compiles
    native/recode.cc with g++ and CMakeLists.txt's flags into a private
    temporary path, and renames it over the library, so no process ever
    sees a partial file. Once this has run, host.lib() finds the library
    current and never calls cmake."""
    from avrecode_tpu import host
    if not host._needs_rebuild():
        return host._LIB_PATH
    os.makedirs(host._BUILD_DIR, exist_ok=True)
    with open(os.path.join(host._BUILD_DIR, "libartc.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not host._needs_rebuild():  # built while we waited
            return host._LIB_PATH
        tmp = f"{host._LIB_PATH}.{os.getpid()}.tmp"
        build_id = _git_rev(host._NATIVE_DIR)
        try:
            subprocess.run(["g++", "-std=c++17", "-O3", "-DNDEBUG", "-march=native",
                            "-fPIC", "-shared", "-pthread", f'-DARTC_BUILD_ID="{build_id}"',
                            "-I", host._NATIVE_DIR, "-o", tmp,
                            os.path.join(host._NATIVE_DIR, "recode.cc")], check=True)
            os.replace(tmp, host._LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return host._LIB_PATH
