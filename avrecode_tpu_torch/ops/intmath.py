"""Shared integer math of the model passes (plain PyTorch).

Counterpart of avrecode_tpu/ops/model_pass.py:31-108. These are the plain
versions the CPU path and the tests run; csrc/model_pass.cu carries the same
arithmetic in int32 for the card. Plain code computes in int64: torch on the
CPU has no shifts, division or comparisons for uint16/uint32, and every value
here stays below 2^31 (the CPU tests assert it), so int64
results equal the kernel's int32 ones.
"""
from __future__ import annotations

import torch

PROB_BITS = 15
PROB_SCALE = 1 << PROB_BITS

# Residual-level bins (container v15): Dirichlet count-weighted mix with the
# mirrored-CABAC prior. Must match native/model.h kResDirAlpha /
# kResDirFastBoost (and avrecode_tpu.ops.model_pass).
RES_DIR_ALPHA = 32
RES_DIR_K = 2


def _clamp_prob(p: torch.Tensor) -> torch.Tensor:
    return p.clamp(1, PROB_SCALE - 1)


def _halve_iters(window: int, batch: int) -> int:
    """Provable iteration count for _halve_while (a copy of the JAX
    package's bound): start-of-sub-batch totals are <= window and one
    sub-batch adds at most `batch`, and each halving maps t to at most
    (t+2)/2, so the worst trajectory is computable exactly."""
    t, k = window + batch, 0
    while t > window:
        t = (t + 2) >> 1
        k += 1
    return k


def _halve_while(x_pos, x_neg, window: int, iters: int):
    """Replicates `while (pos+neg > window) { pos=(pos+1)>>1; neg=(neg+1)>>1; }`
    with the bounded count from _halve_iters, as the JAX pass unrolls it."""
    for _ in range(iters):
        mask = (x_pos + x_neg) > window
        x_pos = torch.where(mask, (x_pos + 1) >> 1, x_pos)
        x_neg = torch.where(mask, (x_neg + 1) >> 1, x_neg)
    return x_pos, x_neg


def _div_floor(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """floor(num / den) for 0 <= num, 0 < den. The JAX package's _div_floor
    and _div_floor2 compute the same floor through a float reciprocal plus
    fixups only to spare the TPU's vector unit; the floor is the spec."""
    return torch.div(num, den, rounding_mode="floor")


def _dual_prob(dfp, dfn, dsp, dsn, prior_f, tag):
    """kKindDual probability: fixed-weight linear mix, or the v15 Dirichlet
    count-weighted mix when the prior is bit-15 tagged; returns (p_dual,
    p_slow). Denominators are floored at 1, here and in the kernel: the
    vectorized plain pass evaluates every branch for every bin, and a zero
    only occurs in a branch whose bin kind discards it (torch raises on an
    integer /0)."""
    ps = _div_floor(dsp << PROB_BITS, (dsp + dsn).clamp_min(1))
    pf = _div_floor(dfp << PROB_BITS, (dfp + dfn).clamp_min(1))
    lin = torch.where(prior_f > 0, (3 * (pf + ps) + 2 * prior_f) >> 3, (pf + ps) >> 1)
    dirich = _div_floor(((RES_DIR_K * dfp + dsp) << PROB_BITS) + RES_DIR_ALPHA * prior_f,
                        RES_DIR_K * (dfp + dfn) + dsp + dsn + RES_DIR_ALPHA)
    return _clamp_prob(torch.where(tag != 0, dirich, lin)), _clamp_prob(ps)


def _prob_by_kind(kind, prior_raw, dfp, dfn, dsp, dsn, spos, sneg, alpha_on: int,
                  alpha_off: int):
    """Every model pass's per-bin probability from the bin's effective
    estimator state (csrc/model_pass.cu bin_prob): kind 0 the dual mix, kind 1
    the slow voice, kind 2 the sig counts mixed with the prior at weight
    alpha_on or, when the prior's bit 15 is set, alpha_off; kind 3 the prior
    passed through. Clamped to [1, 32767]."""
    prior_f = prior_raw & 0x7FFF
    tag = prior_raw >> 15
    alpha_v = torch.where(tag != 0, alpha_off, alpha_on)
    p_dual, p_slow = _dual_prob(dfp, dfn, dsp, dsn, prior_f, tag)
    p_sig = _clamp_prob(_div_floor((spos << PROB_BITS) + alpha_v * prior_f,
                                   (spos + sneg + alpha_v).clamp_min(1)))
    prob = torch.where(kind == 0, p_dual, torch.where(kind == 1, p_slow, p_sig))
    return torch.where(kind == 3, _clamp_prob(prior_f), prob)
