"""Builds and binds the port's CUDA kernels, and builds its host library.

csrc/*.cu compile with nvcc for sm_90a into build/libartc_cuda.so, a shared
library with a plain C interface loaded through ctypes, on first use and
again whenever a source is newer than the library. Every C entry launches on
the stream it is given and returns cudaGetLastError(); `launch` raises on a
nonzero code and counts the launch under its kernel's name.

The C++ host engine (the syntax walkers, the prior model, CABAC, rANS, the
container) is the port's own copy, under native/; g++ compiles it into
build/libartc_host.so, which host.py loads. Its linker version script
exports the artc_* entries only.

Both builds run under an exclusive flock on a lock file beside their
library (and, within a process, under a thread lock per library), through a private
temporary file renamed over the library: threads of a corpus run and
processes on one machine never see a partial library.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD, "libartc_cuda.so")
# The host engine: the port's copy of its sources, and the library built
# from them beside the kernels' library.
NATIVE_DIR = os.path.join(_PKG, "native")
HOST_LIB_PATH = os.path.join(BUILD, "libartc_host.so")
VERSION_SCRIPT = os.path.join(NATIVE_DIR, "libartc_host.map")
# The host library's g++ flags: the JAX package's CMakeLists.txt release
# flags (less -g and -Wall, which change no instruction), the version script
# and what a shared library needs. g++ 13.3 at -O3 miscompiles one loop of
# the engine, decode_coeffs's significance map (native/h264_slice.h:1082),
# when it unswitches it: 4:2:2 CABAC containers then fail to decode. That
# function alone carries `optimize("no-unswitch-loops")`; the cause and
# its standalone reproducer are at the site and in
# native/repro_unswitch.cc.
HOST_CXXFLAGS = ["-std=c++17", "-O3", "-DNDEBUG", "-march=native",
                 "-fPIC", "-shared", "-pthread", f"-Wl,--version-script={VERSION_SCRIPT}"]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# One launch counter per kernel; a wrapper adds one where it launches. The
# mesh steps (parallel/pipeline.py) add one per step call on CUDA devices.
launches = {"wire_expand": 0, "dual0_expand": 0, "model_pass_v4": 0,
            "lane_scan_dev": 0, "lane_compact": 0, "model_pass_v2": 0,
            "lane_scan": 0, "model_pass_dict": 0, "model_pass": 0,
            "sharded_v4_compress_step": 0, "sharded_recompress_step": 0,
            "dense_expand": 0, "dense_lanes": 0}

# C entry -> argument kinds ('p' pointer, 'i' 64-bit int); the stream follows.
_SIGNATURES = {
    "artc_wire_expand": "p" * 6 + "i" * 16,
    "artc_dual0_expand": "p" * 5 + "i" * 3,
    "artc_launch_floor": "p" * 5 + "i" * 3,
    "artc_model_pass_v4": "p" * 14 + "i" * 20,
    "artc_lane_scan_dev": "p" * 7 + "i" * 3,
    "artc_lane_compact": "p" * 4 + "i" * 3,
    "artc_model_pass_v2": "p" * 16 + "i" * 16,
    "artc_lane_scan": "p" * 8 + "i" * 5,
    "artc_model_pass_dict": "p" * 15 + "i" * 12,
    "artc_model_pass": "p" * 15 + "i" * 12,
    "artc_dense_expand": "p" * 7 + "i" * 8,
    "artc_dense_lanes": "p" * 5 + "i" * 3,
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_longlong}

_lib = None
# Threads of one process: one lock per library path (so two builds can run
# at once; made on first use) and one for loading; the flock covers processes.
_BUILD_LOCKS: dict[str, threading.Lock] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
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


def _stale(lib_path: str, deps) -> bool:
    if not os.path.exists(lib_path):
        return True
    mtime = os.path.getmtime(lib_path)
    return any(os.path.getmtime(p) > mtime for p in deps)


def _locked_build(lib_path: str, lock_name: str, deps, compile_to) -> str:
    """Builds `lib_path` if it is missing or older than one of `deps`:
    under the thread lock and an exclusive flock on `lock_name` beside it,
    re-checking once the lock is held, compiling into a private temporary
    path (`compile_to(tmp)`) that is renamed over the library."""
    if not _stale(lib_path, deps):
        return lib_path
    build_dir = os.path.dirname(lib_path)
    with _BUILD_LOCKS.setdefault(lib_path, threading.Lock()):
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, lock_name), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stale(lib_path, deps):  # built while we waited
                return lib_path
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            try:
                compile_to(tmp)
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib_path


def build() -> str:
    """Compiles csrc/*.cu into LIB_PATH if it is missing or older than a
    source; returns its path. One nvcc per source, all started together,
    then one link; ptxas's per-kernel register report lands in
    build/nvcc.log."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = sources + glob.glob(os.path.join(CSRC, "*.cuh"))

    def nvcc(tmp: str) -> None:
        nv = _nvcc()
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
        try:
            procs = [subprocess.Popen([nv, *NVCC_FLAGS, "-c", "-o", o, s], text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                     for s, o in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            link = None
            if all(p.returncode == 0 for p in procs):
                link = subprocess.run([nv, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                                      capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
            with open(os.path.join(BUILD, "nvcc.log"), "w") as f:
                f.write("\n".join(logs))
            if link is None:
                bad = [log[-4000:] for p, log in zip(procs, logs) if p.returncode != 0]
                raise RuntimeError("nvcc failed:\n" + "\n".join(bad))
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{logs[-1][-4000:]}")
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)

    return _locked_build(LIB_PATH, "libartc_cuda.lock", deps, nvcc)


def load() -> ctypes.CDLL:
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, kinds in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
            lib.artc_cuda_error_string.restype = ctypes.c_char_p
            lib.artc_cuda_error_string.argtypes = [ctypes.c_int]
            for name in ("artc_pass_launches", "artc_expand_launches",
                         "artc_compact_launches", "artc_dual0_launches"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = []
            _lib = lib
    return _lib


def count(name: str) -> None:
    """Adds one to `name`'s launch counter (thread-safe)."""
    with _COUNT_LOCK:  # corpus runs launch from several threads
        launches[name] += 1


def launch(kernel: str | None, entry: str, device: torch.device, *args) -> None:
    """Calls C entry `entry` on `device`'s current stream with `args`
    (tensors pass their data pointer), raises on a CUDA error, and counts
    one launch of `kernel` (None: a launch that is no kernel of a path, as
    the launch floor, counts nowhere)."""
    lib = _lib or load()
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # The raw stream handle and no device switch where the device is the
    # current one: launching a call is host time the card may wait on.
    current = torch.cuda.current_device()
    idx = current if device.index is None else device.index
    if idx == current:
        rc = getattr(lib, entry)(*cargs, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = getattr(lib, entry)(*cargs, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.artc_cuda_error_string(rc).decode()})")
    if kernel is not None:
        count(kernel)


def pass_launches() -> int:
    """Device-side launches (kernels, copies, clears) that the calling
    thread's last model pass call made (v3_core, model_pass_v2,
    model_pass_dict or model_pass)."""
    return int(load().artc_pass_launches())


def expand_launches() -> int:
    """Device-side launches that the calling thread's last wire expand call
    made (all of its chunks)."""
    return int(load().artc_expand_launches())


def dual0_launches() -> int:
    """Device-side launches that the calling thread's last dual0 expand call
    made."""
    return int(load().artc_dual0_launches())


def compact_launches() -> int:
    """Device-side launches that the calling thread's last lane compaction
    call made."""
    return int(load().artc_compact_launches())


def check_cuda(name: str, *tensors: torch.Tensor, dtype=torch.int32) -> None:
    """Validates kernel inputs: one CUDA device, the dtype (one for all, or
    a tuple with one per tensor), contiguity."""
    dev = tensors[0].device
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,) * len(tensors)
    for t, want in zip(tensors, dtypes, strict=True):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
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


def _host_sources() -> list[str]:
    """The host engine's build inputs: .h, .cc and the version script under
    NATIVE_DIR."""
    found = []
    for root, _dirs, files in os.walk(NATIVE_DIR):
        found += [os.path.join(root, f) for f in files if f.endswith((".h", ".cc", ".map"))]
    return found


def ensure_host_lib() -> str:
    """Makes sure the host library HOST_LIB_PATH is built from NATIVE_DIR
    with HOST_CXXFLAGS and current, safely against other threads and
    processes doing the same; returns its path. The holder of the lock
    compiles native/recode.cc with g++ into a private temporary path and
    renames it over the library, so no process ever sees a partial file."""
    def gxx(tmp: str) -> None:
        build_id = _git_rev(NATIVE_DIR)
        subprocess.run(["g++", *HOST_CXXFLAGS, f'-DARTC_BUILD_ID="{build_id}"',
                        "-I", NATIVE_DIR, "-o", tmp, os.path.join(NATIVE_DIR, "recode.cc")],
                       check=True)

    deps = _host_sources() + [_flags_stamp(HOST_LIB_PATH, HOST_CXXFLAGS)]
    return _locked_build(HOST_LIB_PATH, "libartc_host.lock", deps, gxx)


def _flags_stamp(lib_path: str, flags: list[str]) -> str:
    """A file beside `lib_path` (its name with .flags) holding `flags`,
    rewritten (and so newer than the library, which is then rebuilt) when
    they change."""
    path = os.path.splitext(lib_path)[0] + ".flags"
    text = " ".join(flags) + "\n"
    try:
        with open(path) as f:
            if f.read() == text:
                return path
    except FileNotFoundError:
        pass
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path
