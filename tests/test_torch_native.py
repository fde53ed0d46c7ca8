"""The port's build of its own native host library
(avrecode_tpu_torch._native.ensure_host_lib) under concurrency: processes
that build it at once from an empty build directory all end up loading one
complete library; and its flags."""
import os
import shutil
import subprocess
import sys
import threading

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


def test_host_library_flags_and_rebuild_when_they_change(tmp_path, monkeypatch):
    """The host library is built with -fno-unswitch-loops (without it, g++
    13 at -O3 builds a library that cannot decode the test corpus's 4:2:2
    CABAC containers) and with the version script that exports artc_*
    only. A library built with other flags is stale: the flags live in a
    stamp file beside it, and a change rebuilds it once."""
    assert "-fno-unswitch-loops" in _native.HOST_CXXFLAGS
    script = f"-Wl,--version-script={_native.VERSION_SCRIPT}"
    assert script in _native.HOST_CXXFLAGS and os.path.exists(_native.VERSION_SCRIPT)
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
    assert len(builds) == 1 and "-fno-unswitch-loops" in builds[0] and script in builds[0]
    assert (tmp_path / "build" / "libartc_host.flags").exists()
    _native.ensure_host_lib()  # the same flags: the stamp is not rewritten
    assert len(builds) == 1
    monkeypatch.setattr(_native, "HOST_CXXFLAGS", [f for f in _native.HOST_CXXFLAGS
                                                   if f != "-fno-unswitch-loops"])
    _native.ensure_host_lib()
    assert len(builds) == 2 and "-fno-unswitch-loops" not in builds[1]
