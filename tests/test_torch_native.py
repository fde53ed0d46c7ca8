"""The port's build of its own native host library
(avrecode_tpu_torch._native.ensure_host_lib) under concurrency: processes
that build it at once from an empty build directory all end up loading one
complete library; its flags; and the one function of the engine built
without loop unswitching, with the reproducer of the miscompile that
keeps it so."""
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu_torch import _native

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import os, sys
import numpy as np
from avrecode_tpu_torch import _native
from avrecode_tpu_torch import device as td
path = _native.ensure_host_lib()
an = td.analyze(open(sys.argv[1], "rb").read(), batch_size=1024, model_profile=2, sup=128)
ok = all(np.array_equal(td.device_probs(an, c, "cpu"), c.host_probs) for c in an.chunks)
print(path, os.stat(path).st_ino, ok)
"""


def test_concurrent_host_lib_builds(corpus_dir, tmp_path):
    """Two processes call ensure_host_lib at the same moment on a copy of
    the packages whose build directory is empty. Both must load a library
    that runs an analysis whose probs equal the port's model pass, and the
    library must be built once (one file, no second replace after a load).
    An unlocked build (cmake + ninja from two processes, as the JAX
    package's build_native) can link a library from a half-written object
    file."""
    root = tmp_path / "repo"
    skip = shutil.ignore_patterns("build", "__pycache__", "*.so", "*.pyc")
    for pkg in ("avrecode_tpu", "avrecode_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), root / pkg, ignore=skip)
    assert not (root / "avrecode_tpu_torch" / "build").exists()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    clip = os.path.join(corpus_dir, "i_main.264")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, clip], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-2000:]
    lines = [out.split() for out, _ in results]
    want_lib = str(root / "avrecode_tpu_torch" / "build" / "libartc_host.so")
    for path, _, ok in lines:
        assert path == want_lib and ok == "True", lines
    assert lines[0][1] == lines[1][1], lines  # one build: the same file
    leftovers = [f for f in os.listdir(os.path.dirname(want_lib)) if f.endswith(".tmp")]
    assert not leftovers


def _cmake_release_flags() -> list[str]:
    """The JAX package's CMakeLists.txt release flags (C++ standard,
    CMAKE_CXX_FLAGS_RELEASE and ARTC_NATIVE_ARCH's -march=native), less -g
    and -Wall, which change no instruction."""
    with open(os.path.join(REPO, "avrecode_tpu", "native", "CMakeLists.txt")) as f:
        text = f.read()
    std = re.search(r"set\(CMAKE_CXX_STANDARD (\d+)\)", text).group(1)
    release = re.search(r'set\(CMAKE_CXX_FLAGS_RELEASE "([^"]*)"\)', text).group(1).split()
    arch = re.search(r'string\(APPEND CMAKE_CXX_FLAGS_RELEASE " ([^"]*)"\)', text).group(1)
    return [f"-std=c++{std}", *(f for f in release if f not in ("-g", "-Wall")), arch]


def test_host_library_flags_and_rebuild_when_they_change(tmp_path, monkeypatch):
    """The host library is built with the JAX package's release flags, what
    a shared library needs and the version script that exports artc_* only:
    no flag against g++ 13.3's loop-unswitching miscompile. That workaround
    is confined to decode_coeffs (native/h264_slice.h), the one function it
    broke, as an attribute (see test_unswitch_guard_sits_on_decode_coeffs).
    A library built with other flags is stale: the flags live in a stamp
    file beside it, and a change rebuilds it once."""
    script = f"-Wl,--version-script={_native.VERSION_SCRIPT}"
    assert _native.HOST_CXXFLAGS == [*_cmake_release_flags(), "-fPIC", "-shared", "-pthread",
                                     script]
    assert os.path.exists(_native.VERSION_SCRIPT)
    lib = tmp_path / "build" / "libartc_host.so"
    monkeypatch.setattr(_native, "HOST_LIB_PATH", str(lib))
    monkeypatch.setitem(_native._BUILD_LOCKS, str(lib), threading.Lock())
    real_run = subprocess.run
    builds = []

    def run(cmd, *args, **kw):
        if cmd[0] != "g++":
            return real_run(cmd, *args, **kw)
        builds.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")

    monkeypatch.setattr(_native.subprocess, "run", run)
    assert _native.ensure_host_lib() == str(lib)
    assert len(builds) == 1 and builds[0][1:1 + len(_native.HOST_CXXFLAGS)] == \
        _native.HOST_CXXFLAGS
    assert (tmp_path / "build" / "libartc_host.flags").exists()
    _native.ensure_host_lib()  # the same flags: the stamp is not rewritten
    assert len(builds) == 1
    monkeypatch.setattr(_native, "HOST_CXXFLAGS", [*_native.HOST_CXXFLAGS, "-fno-unswitch-loops"])
    _native.ensure_host_lib()
    assert len(builds) == 2 and "-fno-unswitch-loops" in builds[1]


def test_unswitch_guard_sits_on_decode_coeffs():
    """The workaround for g++ 13.3's miscompile of decode_coeffs's
    significance-map loop: the function, and no other, carries
    ARTC_NO_UNSWITCH, which is optimize("no-unswitch-loops") under g++ and
    nothing under other compilers, and which a build may define away."""
    with open(os.path.join(_native.NATIVE_DIR, "h264_slice.h")) as f:
        text = f.read()
    assert '#define ARTC_NO_UNSWITCH __attribute__((optimize("no-unswitch-loops")))' in text
    assert "#ifndef ARTC_NO_UNSWITCH" in text and "!defined(__clang__)" in text
    uses = re.findall(r"^\s*ARTC_NO_UNSWITCH (.*)$", text, re.M)
    assert uses == ["void decode_coeffs(int cat, int max_coeff) {"]
    others = [f for f in os.listdir(_native.NATIVE_DIR) if f.endswith((".h", ".cc"))
              and f not in ("h264_slice.h", "repro_unswitch.cc")]
    for name in others:
        with open(os.path.join(_native.NATIVE_DIR, name)) as f:
            body = f.read()
        assert "no-unswitch" not in body and "ARTC_NO_UNSWITCH" not in body, name


# The reproducer of that miscompile, with the attribute (-DARTC_GUARD) or a
# flag that turns unswitching off: right under any g++. (Without either,
# g++ 13.3 at -O3 gets it wrong: tools/host_unswitch.py --repro.)
REPRO_FLAGS = {"guard_O3": ["-O3", "-DARTC_GUARD"],
               "guard_O3_native": ["-O3", "-march=native", "-DARTC_GUARD"],
               "no_unswitch_O3": ["-O3", "-fno-unswitch-loops"],
               "O2": ["-O2"]}


@pytest.mark.parametrize("flags", list(REPRO_FLAGS))
def test_unswitch_reproducer_is_right_with_the_guard(tmp_path, flags):
    exe = tmp_path / "repro"
    subprocess.run(["g++", "-std=c++17", *REPRO_FLAGS[flags], "-I", _native.NATIVE_DIR,
                    "-o", str(exe), os.path.join(_native.NATIVE_DIR, "repro_unswitch.cc")],
                   check=True)
    r = subprocess.run([str(exe)], capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout.startswith("ok: 0 of "), r.stdout
