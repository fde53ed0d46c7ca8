"""The port's compress(device="cpu") (the plain versions) against the frozen
corpus's manifest (avrecode_tpu_torch/testdata/corpus/manifest.json, the JAX
package's container hashes) on the clips that bring a syntax branch the
other CPU tests do not hold whole: 4:4:4 10-bit interlaced, High 10, mono,
CAVLC 4:4:4, PCM in CABAC, MBAFF 4:2:2, weighted prediction, PAFF fields,
SP slices and separate colour planes, each at profile 2 and batch 512, and
three of them at profile 0. testcorpus.check_clip also checks each chunk's
probs against the host model, its lane blob against the C++ encoder and the
roundtrip.
"""
import copy

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu_torch import _native
from avrecode_tpu_torch import testcorpus as tc
from avrecode_tpu_torch.testing import assert_same_array

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

CLIPS = ["c444p10i.264", "hi10.264", "mono.264", "cav444.264", "pcm_cabac.264",
         "mbaff422.mp4", "stress_wpred.264", "paff_ip.264", "sp_cavlc.264", "sepplanes.264"]
P0_CLIPS = ["paff_ip.264", "sp_cavlc.264", "sepplanes.264"]


@pytest.fixture(scope="module")
def man():
    return tc.manifest()


@pytest.mark.parametrize("name", CLIPS)
def test_port_matches_the_manifest_at_profile_2(man, name):
    r = tc.check_clip(name, "cpu", man, modes=["p2_b512"])
    assert r["modes"] == ["p2_b512"] and r["chunks"] >= 1


@pytest.mark.parametrize("name", P0_CLIPS)
def test_port_matches_the_manifest_at_profile_0(man, name):
    """ARTC_MODEL_IMPL=v2 (dict, sort and mm against JAX on the CPU are
    tests/test_torch_profile0.py's)."""
    r = tc.check_clip(name, "cpu", man, modes=["p0_v2"], impls=())
    assert r["modes"] == ["p0_v2"] and r["chunks"] >= 1


def test_port_raises_the_jax_error_where_jax_raises(man):
    """p2_b4096 on a clip whose super-step overflows the slim dictionary:
    the port raises JAX's error, word for word."""
    name = "ipb_high.264"
    assert "error" in man["clips"][name]["modes"]["p2_b4096"]
    r = tc.check_clip(name, "cpu", man, modes=["p2_b4096"])
    assert r["errors"] == 1


def test_a_flipped_manifest_digest_fails_the_port_check(man):
    bad = copy.deepcopy(man)
    outcome = bad["clips"]["sp_cavlc.264"]["modes"]["p2_b512"]
    outcome["digest"] = outcome["digest"][::-1]
    with pytest.raises(AssertionError, match="sp_cavlc.264 p2_b512: container digest"):
        tc.check_clip("sp_cavlc.264", "cpu", bad, modes=["p2_b512"])


def test_container_digest_leaves_out_only_the_build_provenance():
    """A container's header holds the writing build's git revision (the
    host library's build id, "nogit" outside a git checkout), so its raw
    bytes differ between two builds of the same sources: the digest cuts
    out exactly that field and nothing else."""
    comp, _ = tc.port_container(tc.clip_bytes("sp_cavlc.264"), tc.CORPUS_MODES["p2_b512"],
                                device="cpu")
    build = tc.build_field(comp)
    assert build == tc.library_build() and len(build) > 0
    other = comp[:5] + bytes([5]) + b"nogit" + comp[6 + len(build):]
    assert other != comp and tc.build_field(other) == b"nogit"
    assert tc.container_digest(other) == tc.container_digest(comp)
    flipped = bytearray(comp)
    flipped[-1] ^= 1
    assert tc.container_digest(bytes(flipped)) != tc.container_digest(comp)
    with pytest.raises(ValueError):
        tc.container_digest(b"ATRX" + comp[4:])


def _kernel_check(man, workers, clips=("sp_cavlc.264",), modes=("p2_b512",)):
    kc = tc.KernelCheck(_raise_check, workers=workers)
    for name in clips:
        tc.check_clip(name, "cpu", man, modes=list(modes), kernels=kc)
    return kc


def _raise_check(name, got, want, what):
    assert_same_array(got.cpu(), want.cpu().numpy(), f"{name} on {what}")


def test_kernel_check_holds_every_row_on_every_chunk(man):
    """The harness the card runs, on the CPU (every wrapper runs its plain
    version there, so every comparison holds): one clip under three modes,
    the plain versions in two worker processes, the lane scans flushed as
    one plain run a (K, T) over a chunk axis; every row is counted on every
    chunk it runs on."""
    with _kernel_check(man, 2, ("sp_cavlc.264",), ("p2_b512", "p2_k4", "p0_v2")) as kc:
        assert kc.queued == 2 * 5 + 5  # two profile-2 chunks, one profile-0 chunk
        kc.flush()
        assert kc.queued == 0
    assert kc.counts == {"dual0_expand": 2, "wire_expand": 2, "model_pass_v4": 2,
                         "lane_scan_dev": 2, "lane_compact": 3, "model_pass_v2": 1,
                         "model_pass_dict": 1, "model_pass": 1, "lane_scan": 1}
    assert kc.clips == {"sp_cavlc.264": 15}
    assert set(kc.seconds) == {"dual0_expand", "wire_expand", "model_pass_v4", "lane_compact",
                               "model_pass_v2", "model_pass_dict", "model_pass", "lane_scan"}


@pytest.mark.parametrize("kernel", ["lane_compact", "lane_scan_dev", "model_pass_dict"])
def test_kernel_check_names_a_wrong_kernel_output(man, monkeypatch, kernel):
    """A kernel output one element off its plain version's, in its last
    element (for the pass: a padding bin, which the container never shows),
    fails the flush, naming the kernel, the clip, the mode, the chunk and
    the first differing index."""
    module = tc.mp if kernel == "model_pass_dict" else tc.lx
    real = getattr(module, kernel)

    def wrong(*args, **kw):
        out = real(*args, **kw)
        first = out[1] if isinstance(out, tuple) else out
        first.view(-1)[-1] += 1
        return out

    monkeypatch.setattr(module, kernel, wrong)
    kc = _kernel_check(man, 0, modes=("p0_v2",) if kernel == "model_pass_dict" else
                       ("p2_b512",))
    with pytest.raises(AssertionError, match=rf"{kernel} on sp_cavlc.264 p\w+ chunk 0, "
                                             r"output \d, first at flat index \d+"):
        kc.flush()
