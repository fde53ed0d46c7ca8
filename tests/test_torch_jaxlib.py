"""The JAX package's host library, the reference the port's tests load
through avrecode_tpu.host and avrecode_tpu.device, built under a lock.

The port builds only its own host library (avrecode_tpu_torch/native into
avrecode_tpu_torch/build/libartc_host.so). The JAX package's own build
(avrecode_tpu.host.build_native) runs cmake + ninja in
avrecode_tpu/native/build with no lock, so concurrent callers (pytest-xdist
workers) can link a library from an object file another compile is still
writing, and then load it. `ensure_jax_lib` compiles avrecode_tpu/native/
recode.cc with g++ (the card's machine may have no cmake) and
CMakeLists.txt's release flags into that same path, under an flock on
build/libartc.lock, through a private temporary file renamed over the
library; build_native then finds the library current and never runs cmake.
Every port test module calls it at import, so every xdist worker waits for
one locked build during collection.
"""
import os
import subprocess

from avrecode_tpu_torch import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "avrecode_tpu", "native")
JAX_BUILD = os.path.join(JAX_NATIVE, "build")
JAX_LIB = os.path.join(JAX_BUILD, "libartc.so")
# CMakeLists.txt's release flags, and -fno-unswitch-loops: g++ 13.3's loop
# unswitching at -O3 miscompiles the decoder's significance-map loop,
# decode_coeffs in native/h264_slice.h (it drops the 4:2:2 chroma DC case
# from the unswitched copy, so the test corpus's 4:2:2 CABAC containers fail
# to decode). The port's copy confines the workaround to that function
# (avrecode_tpu_torch/native/h264_slice.h, repro_unswitch.cc beside it); the
# JAX sources stay as they are and carry the same loop, so their build keeps
# the flag.
JAX_CXXFLAGS = ["-std=c++17", "-O3", "-DNDEBUG", "-march=native", "-fno-unswitch-loops",
                "-fPIC", "-shared", "-pthread"]


def _jax_sources() -> list[str]:
    """The files whose change makes build_native rebuild: .h, .cc and .txt
    under avrecode_tpu/native, outside its build directory."""
    found = []
    for root, _dirs, files in os.walk(JAX_NATIVE):
        if root.startswith(JAX_BUILD):
            continue
        found += [os.path.join(root, f) for f in files if f.endswith((".h", ".cc", ".txt"))]
    return found


def ensure_jax_lib() -> str:
    """Builds JAX_LIB if it is missing, older than a source or built with
    other flags (a stamp beside it); returns its path."""
    def gxx(tmp: str) -> None:
        build_id = _native._git_rev(JAX_NATIVE)
        subprocess.run(["g++", *JAX_CXXFLAGS, f'-DARTC_BUILD_ID="{build_id}"',
                        "-I", JAX_NATIVE, "-o", tmp, os.path.join(JAX_NATIVE, "recode.cc")],
                       check=True)

    deps = _jax_sources() + [_native._flags_stamp(JAX_LIB, JAX_CXXFLAGS)]
    return _native._locked_build(JAX_LIB, "libartc.lock", deps, gxx)


ensure_jax_lib()


def test_jax_library_is_current_for_build_native():
    """The library this module builds is the file the JAX package loads,
    and build_native finds it current (so it never runs cmake)."""
    from avrecode_tpu import host as jhost
    assert ensure_jax_lib() == os.path.abspath(jhost._LIB_PATH)
    assert not jhost._needs_rebuild()
    assert jhost.build_native() == jhost._LIB_PATH
