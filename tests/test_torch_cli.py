"""The port's CLI (avrecode_tpu_torch.cli) against the JAX package's
(avrecode_tpu.cli), command by command. Both run in this process through
main(argv), their output captured by capsys. With --host, compress and
roundtrip run the native host engine, as the JAX CLI does, and must print
the same JSON (every field) and write the same bytes; without it they run
the port's device path, here on --device cpu (the plain versions), whose
container must equal avrecode_tpu.device.compress's. Exact equality
everywhere."""
import json
import os

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import cli as jcli
from avrecode_tpu import device as jd
from avrecode_tpu_torch import _native, cli, host, pipeline

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

CLIP = "i_main.264"


def _run(main, argv, capsys):
    """(exit code, the last stdout line as JSON, stderr) of main(argv)."""
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("argv", [
    ["compress", "OUT"],
    ["compress", "OUT", "--bill"],
    ["compress", "OUT", "--lanes", "4", "--chunk-mode", "1"],
    ["roundtrip"],
    ["roundtrip", "OUT", "--bill", "--bill-table"],
    ["roundtrip", "OUT", "--lanes", "4"],
], ids=lambda a: "-".join(x.strip("-") for x in a if x != "OUT"))
def test_host_path_matches_jax_cli(corpus_dir, tmp_path, capsys, argv):
    """--host: the JSON equals the JAX CLI's in every field, the files are
    byte-identical, and roundtrip's --bill-table stderr is the same table."""
    src = os.path.join(corpus_dir, CLIP)
    results = {}
    for name, main, extra in (("port", cli.main, ["--host"]), ("jax", jcli.main, [])):
        out = str(tmp_path / f"{name}.atrc")
        args = [argv[0], src] + [out if a == "OUT" else a for a in argv[1:]]
        results[name] = (*_run(main, args + extra, capsys),
                         _bytes(out) if "OUT" in argv else None)
    (rc, rep, err, written), want = results["port"], results["jax"]
    assert rc == want[0] == 0
    assert rep == want[1]
    assert written == want[3]
    if "--bill" in argv:
        assert rep["bill"] == pipeline.compress(_bytes(src))[1].bill
    if argv[0] == "roundtrip":
        assert rep["roundtrip_ok"] is True
        assert err == want[2]
        assert ("TOTAL" in err) == ("--bill-table" in argv)


def test_compress_bill_table_prints_the_table(corpus_dir, tmp_path, capsys):
    """--bill-table on compress (which the JAX CLI ignores there) prints
    format_bill's table of the container's stats on stderr."""
    from avrecode_tpu_torch.utils.billing import format_bill
    src = os.path.join(corpus_dir, CLIP)
    out = str(tmp_path / "a.atrc")
    rc, rep, err = _run(cli.main, ["compress", src, out, "--host", "--bill-table"], capsys)
    assert rc == 0 and "bill" not in rep
    assert err.strip() == format_bill(pipeline.compress(_bytes(src))[1])


def test_decompress_matches_jax_cli(corpus_dir, tmp_path, capsys):
    src = os.path.join(corpus_dir, "mbaff.264")
    comp = str(tmp_path / "c.atrc")
    with open(comp, "wb") as f:
        f.write(pipeline.compress(_bytes(src), chunk_mode=1)[0])
    got = _run(cli.main, ["decompress", comp, str(tmp_path / "port.264")], capsys)
    want = _run(jcli.main, ["decompress", comp, str(tmp_path / "jax.264")], capsys)
    assert got[:2] == want[:2] and got[0] == 0
    assert set(got[1]) == {"output_bytes", "slices"}
    assert _bytes(tmp_path / "port.264") == _bytes(tmp_path / "jax.264") == _bytes(src)


def test_info_matches_jax_cli(corpus_dir, tmp_path, capsys):
    """info on a container (a pure header parse) and on a file that is not
    one (exit code 1 and the same error JSON)."""
    src = os.path.join(corpus_dir, CLIP)
    comp = str(tmp_path / "c.atrc")
    with open(comp, "wb") as f:
        f.write(pipeline.compress(_bytes(src))[0])
    got, want = (_run(m, ["info", comp], capsys) for m in (cli.main, jcli.main))
    assert got[:2] == want[:2] and got[0] == 0
    assert got[1]["container_version"] == host.container_version()
    assert got[1]["readable"] is True and got[1]["bytes"] == os.path.getsize(comp)
    got, want = (_run(m, ["info", src], capsys) for m in (cli.main, jcli.main))
    assert got[:2] == want[:2] == (1, {"error": "not an ATRC container"})


@pytest.mark.parametrize("lanes", [None, 4])
def test_device_path_matches_jax_device(corpus_dir, tmp_path, capsys, lanes):
    """compress and roundtrip on --device cpu --batch-size 512 write the
    container avrecode_tpu.device.compress writes with the same parameters
    (--lanes reaches the call); the reports carry the JAX CLI's fields."""
    src = os.path.join(corpus_dir, CLIP)
    data = _bytes(src)
    opts = ["--device", "cpu", "--batch-size", "512"]
    kw = {}
    if lanes:
        opts += ["--lanes", str(lanes)]
        kw["lanes"] = lanes
    want, want_st = jd.compress(data, batch_size=512, **kw)
    if lanes:  # the lane count changes the container, so equality shows it arrived
        assert want != jd.compress(data, batch_size=512)[0]
    out = str(tmp_path / "c.atrc")
    rc, rep, _ = _run(cli.main, ["compress", src, out] + opts, capsys)
    assert rc == 0 and _bytes(out) == want
    assert rep["device"] == "cpu" and rep["output_bytes"] == len(want)
    assert (rep["slices"], rep["fallback_slices"]) == (want_st.n_slices, want_st.n_fallback)
    out2 = str(tmp_path / "r.atrc")
    rc, rep, err = _run(cli.main, ["roundtrip", src, out2, "--bill", "--bill-table"] + opts,
                        capsys)
    assert rc == 0 and rep["roundtrip_ok"] is True and _bytes(out2) == want
    assert rep["compressed_bytes"] == len(want) and rep["slices"] == want_st.n_slices
    assert rep["container_overhead"] == pipeline.container_overhead(len(want), want_st)
    assert rep["bill"] == want_st.bill and "TOTAL" in err
