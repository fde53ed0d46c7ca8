"""Model families: prior-model configurations of the recompression engine.

Counterpart of avrecode_tpu/models/refprior.py. The one family, `refprior`,
is the adaptive prior model of the native engine (native/model.h). These
values are format-defining and the C++ is their single source of truth: it
writes them into every analysis export header (analysis.analyze reads
them), and ops/intmath.py carries the device pass's share (PROB_BITS,
RES_DIR_ALPHA, RES_DIR_K). tests/test_torch_pipeline.py holds this file
against both, and against the JAX package's copy.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RefPriorConfig:
    name: str = "refprior"
    # estimator windows (observations before halving): model.h kFastWindow /
    # kSlowWindow / kWindowSig
    fast_window: int = 48
    slow_window: int = 640
    sig_window: int = 128
    # significance prior mixing: model.h kSigMixAlpha / kSigMixAlphaOff;
    # the off-mode tag travels in prior bit 15 (kPriorOffTag)
    sig_mix_alpha: int = 1        # on-mode: hypergeometric prior weight
    sig_mix_alpha_off: int = 48   # off-mode default (the probe may override)
    # the off weight is chosen per file by the nz-mode probe from these
    # candidates (model.h kSigAlphaCands) and travels in the container and
    # the analysis header's sig_alpha high half
    sig_mix_alpha_off_cands: tuple = (48, 32, 64, 96)
    sig_hash_bits: int = 17       # sig key space hashed to 2^17 entries
    # residual-level mix: model.h kResDirAlpha / kResDirFastBoost,
    # ops.intmath.RES_DIR_ALPHA / RES_DIR_K
    res_dir_alpha: int = 32
    res_dir_fast_boost: int = 2
    # model profiles (container field): 0 = immediate within-batch
    # increments, 2 = frozen batches (the device path's slim wire)
    profiles: tuple = (0, 2)
    # batched-update semantics
    default_batch: int = 4096
    max_batch: int = 32768        # uint16 counter headroom
    # entropy lanes
    prob_bits: int = 15
    default_lanes: int = 16
    max_lanes: int = 1024


MODEL_FAMILIES = {
    "refprior": RefPriorConfig(),
}
