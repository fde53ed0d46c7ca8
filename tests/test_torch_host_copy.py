"""The port's own copy of the C++ host engine (avrecode_tpu_torch/native)
against the JAX package's (avrecode_tpu/native): the copy differs only by
the defined read in sig_pos_class, decode_coeffs's guard against g++
13.3's unswitching, recode.cc's span recording, its slim and dense
exports, which the port's slim_export.h and dense_export.h replace, and the
dense analysis's walker threads (dense_export.h); the
port's library
exports only the artc_* entries; both libraries, loaded in one process, write the same
containers and read each other's; building the port's library reads,
writes and names nothing under avrecode_tpu/."""
import json
import os
import shutil
import subprocess
import sys

import pytest
from test_torch_jaxlib import JAX_LIB, JAX_NATIVE, ensure_jax_lib
from torch_native_export import RECODE_EXPORT, RECODE_STREAM
from torch_native_spans import RECODE_SPANS

from avrecode_tpu_torch import _native
from avrecode_tpu_torch import testcorpus as tc

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_NATIVE = os.path.join(REPO, "avrecode_tpu_torch", "native")
# Files of the JAX tree that are not copied (the build is the port's own;
# the npz tables are read only by the JAX side), and the files of the copy
# that have no original: the version script, the reproducer of the
# miscompile that h264_slice.h's guard avoids (built by no library), the
# span records' header and the slim and dense exports
# (torch_native_export.py).
NOT_COPIED = {"CMakeLists.txt", "gen/cabac_tables.npz"}
PORT_ONLY = {"libartc_host.map", "repro_unswitch.cc", "trace.h", "slim_export.h",
             "dense_export.h"}
# The entries of the port's library that the JAX package's has not: its span
# records (avrecode_tpu_torch/trace.py).
PORT_ENTRIES = {"artc_session_trace", "artc_trace_enable"}
# The changes to the code, as (original text, copy's text) pairs. sig_pos_class reads kSigCoeffFlagOffset8x8[0][63],
# one past its row, for pos 63 (the level bins of an 8x8 block's last
# coefficient). The copy reads [1][0], the element the contiguous read gave.
# The table's other reads stop at pos 62: sig_ctx, last_ctx and
# refmodel.h's zig_off (through RefModel::sig) take only significance-map
# positions, which decode_coeffs bounds by max_coeff - 1 (h264_slice.h).
FIXES = {"model.h": [(
    "    return (cat_ == kCatLuma8x8) ? kSigCoeffFlagOffset8x8[0][pos]\n",
    "    // pos 63 (a level bin) is past the [63] row: read [1][0], as contiguity did.\n"
    "    return (cat_ == kCatLuma8x8) ? (pos < 63 ? kSigCoeffFlagOffset8x8[0][pos]\n"
    "                                             : kSigCoeffFlagOffset8x8[1][0])\n")],
    # decode_coeffs is built without loop unswitching, which g++ 13.3 gets
    # wrong there (the comment says how; native/repro_unswitch.cc shows it).
    "h264_slice.h": [(
        "  void decode_coeffs(int cat, int max_coeff) {\n",
        "  //\n"
        "  // Built without loop unswitching. g++ 13.3 at -O3 miscompiles the\n"
        "  // significance-map loop below once it is inlined into decode_block: it\n"
        "  // unswitches the loop on the switch that sig_ctx's and last_ctx's tests\n"
        "  // of cat become (cases 5, 9, 13: cat_is_8x8; case 3: kCatChromaDC), and\n"
        "  // in the copy for cat outside {5, 9, 13} it drops case 3. A 4:2:2 chroma\n"
        "  // DC block (NumC8x8 2) then gets the contexts base + pos instead of\n"
        "  // base + Min(pos / 2, 2) and the decoder loses sync; 4:2:0 is spared\n"
        "  // only because there pos < 3 and NumC8x8 is 1, where both agree. The\n"
        "  // code is well defined: native/repro_unswitch.cc reduces it to a\n"
        "  // standalone program that g++ 13.3 -O3 gets wrong. The attribute also\n"
        "  // keeps the function out of line, so no caller's unswitching reaches the\n"
        "  // loop. Defining ARTC_NO_UNSWITCH empty builds the engine without it\n"
        "  // (tools/host_unswitch.py).\n"
        "#ifndef ARTC_NO_UNSWITCH\n"
        "#if defined(__GNUC__) && !defined(__clang__)\n"
        "#define ARTC_NO_UNSWITCH __attribute__((optimize(\"no-unswitch-loops\")))\n"
        "#else\n"
        "#define ARTC_NO_UNSWITCH\n"
        "#endif\n"
        "#endif\n"
        "  ARTC_NO_UNSWITCH void decode_coeffs(int cat, int max_coeff) {\n")],
    # The span records (native/trace.h, torch_native_spans.py), then the
    # slim and dense exports (native/slim_export.h, native/dense_export.h,
    # torch_native_export.py) and the dense analysis's walker threads.
    "recode.cc": RECODE_SPANS + RECODE_EXPORT + RECODE_STREAM,
}


def _tree(root: str) -> set[str]:
    """Every file under `root` (relative, '/'-separated), outside build
    directories and bytecode caches."""
    found = set()
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x not in ("build", "__pycache__")]
        found |= {os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/") for f in files}
    return found


COPIED = sorted(_tree(JAX_NATIVE) - NOT_COPIED)


def test_copy_holds_exactly_the_engine_sources():
    """The copy holds every .h, recode.cc and gen/*.h of the JAX tree and,
    beside them, only the version script, the reproducer, the span header
    and the slim and dense exports; the JAX tree holds nothing else
    but CMakeLists.txt and the npz tables."""
    assert _tree(PORT_NATIVE) == set(COPIED) | PORT_ONLY
    assert all(f == "recode.cc" or f.endswith(".h") for f in COPIED)
    assert "gen/cabac_tables.h" in COPIED and "gen/cavlc_tables.h" in COPIED
    assert NOT_COPIED <= _tree(JAX_NATIVE)


@pytest.mark.parametrize("name", COPIED)
def test_copied_file_equals_its_original(name):
    """Byte for byte, but for the listed fixes (applied in order, each old
    text found once)."""
    with open(os.path.join(JAX_NATIVE, name), "rb") as f:
        want = f.read().decode()
    with open(os.path.join(PORT_NATIVE, name), "rb") as f:
        got = f.read().decode()
    for old, new in FIXES.get(name, []):
        assert want.count(old) == 1
        want = want.replace(old, new)
    assert got == want


def _dyn_syms(path: str) -> list[tuple[str, str]]:
    """(binding, name) of every symbol the library defines in its dynamic
    symbol table (readelf --dyn-syms)."""
    out = subprocess.run(["readelf", "--dyn-syms", "-W", path], capture_output=True,
                         text=True, check=True).stdout
    syms = []
    for line in out.splitlines():
        parts = line.split()
        if len(parts) >= 8 and parts[0].endswith(":") and parts[0][:-1].isdigit():
            if parts[6] != "UND":
                syms.append((parts[4], parts[7]))
    return syms


def test_port_library_exports_only_the_artc_entries():
    """The version script leaves the artc_* entries global and everything
    else local: no STB_GNU_UNIQUE symbol (the dynamic loader binds those once
    per process, across libraries loaded RTLD_LOCAL, so two copies of the
    engine would share their function-local statics). The JAX package's
    library, built without it, has such symbols (the parse sees them), and
    the same artc_* entries but for the port's span entries."""
    port = _dyn_syms(_native.HOST_LIB_PATH)
    assert port and all(bind == "GLOBAL" and name.startswith("artc_") for bind, name in port)
    jax = _dyn_syms(JAX_LIB)
    assert any(bind == "UNIQUE" for bind, _ in jax)
    assert {n for _, n in port} == {n for _, n in jax if n.startswith("artc_")} | PORT_ENTRIES


def _mapped() -> set[str]:
    """The real paths of the files this process maps."""
    with open("/proc/self/maps") as f:
        rows = [line.split(None, 5) for line in f]
    return {os.path.realpath(r[5].strip()) for r in rows if len(r) == 6 and r[5].startswith("/")}


@pytest.mark.parametrize("clip", ["ipb_high.mp4", "hi10.264"])
@pytest.mark.parametrize("profile", [0, 2])
def test_both_libraries_in_one_process(clip, profile):
    """The port's host.compress and the JAX package's, on clips with 8x8
    transforms, give the same bytes and stats; each library decodes the
    other's container exactly; the process maps both library files."""
    from avrecode_tpu import host as jhost
    from avrecode_tpu_torch import host as thost
    data = tc.clip_bytes(clip)
    comp, st = thost.compress(data, batch_size=512, model_profile=profile)
    want, want_st = jhost.compress(data, batch_size=512, model_profile=profile)
    assert comp == want and vars(st) == vars(want_st)
    assert jhost.decompress(comp)[0] == data and thost.decompress(want)[0] == data
    port_lib, jax_lib = (os.path.realpath(p) for p in (_native.HOST_LIB_PATH, jhost._LIB_PATH))
    assert port_lib != jax_lib and {port_lib, jax_lib} <= _mapped()


_BUILD_CHILD = """
import json, os, sys
events = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        events.append(["open", os.path.abspath(os.fsdecode(args[0]))])
    elif event == "subprocess.Popen":
        cmd = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        events.append(["popen", [os.fsdecode(a) for a in cmd], os.fsdecode(args[2] or "")])

sys.addaudithook(hook)
from avrecode_tpu_torch import _native
print(json.dumps({"lib": _native.ensure_host_lib(), "events": events}))
"""


def _snapshot(root: str) -> dict:
    """{path: (size, mtime_ns)} of every file and directory under root."""
    snap = {}
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            p = os.path.join(d, name)
            st = os.stat(p)
            snap[p] = (st.st_size, st.st_mtime_ns)
    return snap


def test_port_build_leaves_the_jax_package_alone(tmp_path):
    """A forced build of the port's host library (a copy of both packages
    with no build directory), watched by an audit hook on open and on
    subprocess.Popen: it opens no file under avrecode_tpu/, names no path
    under it to g++ (or any other program it starts), creates or changes
    nothing there, and writes its library under avrecode_tpu_torch/build."""
    root = tmp_path / "repo"
    skip = shutil.ignore_patterns("build", "__pycache__", "*.so", "*.pyc")
    for pkg in ("avrecode_tpu", "avrecode_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), root / pkg, ignore=skip)
    jax_dirs = [str(root / "avrecode_tpu"), os.path.join(REPO, "avrecode_tpu")]
    before = _snapshot(jax_dirs[0])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    res = subprocess.run([sys.executable, "-c", _BUILD_CHILD], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["lib"] == str(root / "avrecode_tpu_torch" / "build" / "libartc_host.so")
    assert os.path.exists(out["lib"])

    def under_jax(path: str) -> bool:
        return any(path == d or path.startswith(d + os.sep) for d in jax_dirs)

    opened = [e[1] for e in out["events"] if e[0] == "open"]
    assert opened and not [p for p in opened if under_jax(p)]
    started = [e for e in out["events"] if e[0] == "popen"]
    gxx = [cmd for _, cmd, _ in started if os.path.basename(cmd[0]) == "g++"]
    assert len(gxx) == 1 and os.path.join(str(root), "avrecode_tpu_torch", "native",
                                          "recode.cc") in gxx[0]
    named = [a for _, cmd, cwd in started for a in [*cmd, cwd]
             if any(d + os.sep in a or a.endswith(d) for d in jax_dirs)]
    assert named == []
    assert _snapshot(jax_dirs[0]) == before
