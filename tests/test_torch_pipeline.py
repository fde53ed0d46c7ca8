"""The port's host-engine modules against the JAX package's: pipeline
(compress, decompress, roundtrip), utils.billing.format_bill and
models.refprior. Everything compared is an integer, a byte string or a
float computed by the same formula from them, so equality is exact."""
import dataclasses
import os

import pytest
from test_torch_jaxlib import ensure_jax_lib

from avrecode_tpu import pipeline as jpipeline
from avrecode_tpu.models import refprior as jrefprior
from avrecode_tpu.utils import billing as jbilling
from avrecode_tpu_torch import _native, analysis, models, pipeline
from avrecode_tpu_torch.models import refprior
from avrecode_tpu_torch.ops import intmath
from avrecode_tpu_torch.utils import billing

# Both host libraries, each built here under its own lock, before any test
# of any module can reach the JAX package's unlocked build (see
# test_torch_jaxlib.py).
_native.ensure_host_lib()
ensure_jax_lib()

CLIPS = ["i_main.264", "cavlc.mp4", "mbaff.264"]


def _read(corpus_dir, name):
    with open(os.path.join(corpus_dir, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("chunk_mode", [0, 1])
@pytest.mark.parametrize("clip", CLIPS)
def test_roundtrip_report_matches_jax(corpus_dir, clip, chunk_mode):
    """The port's roundtrip report equals the JAX one field by field, its
    stats included, and its field names come in the same order."""
    data = _read(corpus_dir, clip)
    got = pipeline.roundtrip(data, chunk_mode=chunk_mode)
    want = jpipeline.roundtrip(data, chunk_mode=chunk_mode)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.ok and want.ok
    for name in ("ok", "input_bytes", "compressed_bytes", "ratio", "container_overhead"):
        assert getattr(got, name) == getattr(want, name), name
    assert vars(got.stats) == vars(want.stats)


@pytest.mark.parametrize("clip", CLIPS)
def test_compress_decompress_match_jax(corpus_dir, clip):
    data = _read(corpus_dir, clip)
    comp, st = pipeline.compress(data, lanes=4, chunk_mode=1)
    want, want_st = jpipeline.compress(data, lanes=4, chunk_mode=1)
    assert comp == want and vars(st) == vars(want_st)
    dec, dst = pipeline.decompress(comp)
    jdec, jdst = jpipeline.decompress(comp)
    assert dec == jdec == data and vars(dst) == vars(jdst)


def test_format_bill_matches_jax(corpus_dir):
    data = _read(corpus_dir, "mbaff.264")
    st = pipeline.roundtrip(data).stats
    table = billing.format_bill(st)
    assert table == jbilling.format_bill(jpipeline.roundtrip(data).stats)
    assert table.splitlines()[-1].startswith("TOTAL")
    assert len(table.splitlines()) == len(st.bill) + 4


def test_refprior_matches_jax_and_native(corpus_dir):
    """The counterpart of tests/test_device_model.py's
    test_refprior_constants_match_native: the port's config equals the JAX
    package's field by field, the header of the port's analysis export (the
    native values) and the port's ops/intmath.py constants."""
    cfg = models.MODEL_FAMILIES["refprior"]
    assert models.RefPriorConfig is refprior.RefPriorConfig
    assert list(models.MODEL_FAMILIES) == list(jrefprior.MODEL_FAMILIES) == ["refprior"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jrefprior.MODEL_FAMILIES["refprior"])
    for profile in (0, 2):
        an = analysis.analyze(_read(corpus_dir, "i_main.264"), batch_size=1024,
                              model_profile=profile)
        assert an.fast_w == cfg.fast_window
        assert an.slow_w == cfg.slow_window
        assert an.sig_w == cfg.sig_window
        assert (an.sig_alpha & 0xFFFF) == cfg.sig_mix_alpha
        assert (an.sig_alpha >> 16) in cfg.sig_mix_alpha_off_cands
        assert an.n_sig == 1 << cfg.sig_hash_bits
        assert an.profile in cfg.profiles and an.batch == 1024
    assert intmath.PROB_BITS == cfg.prob_bits
    assert intmath.RES_DIR_ALPHA == cfg.res_dir_alpha
    assert intmath.RES_DIR_K == cfg.res_dir_fast_boost
    assert cfg.profiles == (0, 2)
