// Adaptive prior model for the recoded stream — the compression win.
//
// Reference parity (SURVEY.md §2.5, reference recode.cpp:615-1059): per-context
// pos/neg estimators with windowed halving; significance-map bins keyed on the
// block's *total* nonzero count (serialized before the map via queueing,
// reference recode.cpp:844-930) plus position class; EOB bins cost zero bits
// (deterministic from nnz_total == observed, reference recode.cpp:802-809,
// 1437-1438); nonzero counts coded bit-by-bit with spatial (left/above) and
// temporal (previous picture) priors (reference recode.cpp:884).
//
// Differences (deliberate, documented):
//  - Context identity is a stable spec ctxIdx (dense tables -> TPU-friendly),
//    not an ffmpeg state pointer (reference recode.cpp:318 uses pointer keys
//    in a std::map — a red-black-tree lookup per bin).
//  - nnz is serialized as (nnz-1) in ceil(log2(maxCoeff)) bits: same widths as
//    the reference's 6/4/2 (reference recode.cpp:858) but cannot overflow at
//    nnz=64 (the reference drops bit 6 for a full 8x8 block).
//  - Probabilities are 15-bit quantized for the rANS lanes (reference uses a
//    64-bit range coder; measured cost of quantization is <0.1%).
#pragma once

#include <algorithm>
#include <cassert>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cabac.h"
#include "h264_slice.h"
#include "h264_tables.h"
#include "rans.h"
#include "gen/cabac_tables.h"

namespace artc {

struct Estimator {
  uint16_t pos = 1, neg = 1;
};

// Two-speed estimator: average of a fast window (adapts in ~tens of bins) and
// a slow window (low steady-state noise). Beats both single speeds on every
// class measured; the slow half alone serves near-0.5 sources.
struct Dual {
  uint16_t fp = 1, fn = 1, sp = 1, sn = 1;
};

// Per-coding-class bit accounting (the reference's "Avrecode Bill",
// recode.cpp:635-655) — information content in millibits.
struct Billing {
  uint64_t mbits[kNumBinKlasses] = {0};
  uint64_t count[kNumBinKlasses] = {0};
  // What the original CABAC spent on the same bins (the reference's
  // "CABAC Bill", recode.cpp:646-654), incl. EOB bins we code for free.
  uint64_t cabac_mbits[kNumBinKlasses] = {0};
  uint64_t eob_cabac_mbits = 0;
  uint64_t nz_mbits = 0, nz_count = 0, eob_count = 0;
  // What the REFERENCE's model (refmodel.h side-car, ARTC_REFMODEL=1) would
  // have spent on the same bins — the measured avrecode baseline. 0 when off.
  uint64_t ref_mbits = 0;
};

class PriorModel {
 public:
  static constexpr int kSigPosClasses = 16;
  static constexpr int kSigThird = 2 * kSigPosClasses * 6;  // is_dc + 2*pos_class + 32*cat
  static constexpr size_t kCtxStride = kNumModelContexts + 3;
  static constexpr size_t kSigStride = size_t(65) * 64 * kSigThird;
  static constexpr size_t kNzUnaryKeys = size_t(8) * 8 * 4 * 6;
  static constexpr size_t kNzStride = kNzUnaryKeys + size_t(6) * 6;  // + suffix bits
  static constexpr int kNumResCtx = 59;  // 227..275 and 426..435 compacted
  static constexpr size_t kResStride = size_t(kNumResCtx) * 16 * 16;  // x nnz x pos

  // Unified Dual table layout (global key space, shared with the TPU path):
  //   [0, 3*kCtxStride)                       per-class ctx estimators
  //   [kNzBase, +3*kNzStride)                 nonzero-count estimators
  //   [kResBase, +3*kResStride)               residual-level estimators
  //   [kCbfBase2, +3*40)                      coded_block_flag estimators
  //   [kSkipBase, +12)                        mb_skip estimators
  static constexpr size_t kNzBase = 3 * kCtxStride;
  static constexpr size_t kResBase = kNzBase + 3 * kNzStride;
  static constexpr size_t kCbfBase2 = kResBase + 3 * kResStride;
  static constexpr size_t kSkipBase = kCbfBase2 + 3 * 40;
  // CAVLC value-model keys: (role, aux-hash, binarization node).
  static constexpr int kNumCavlcRolesM = 24;
  static constexpr int kCavlcAux = 256;
  static constexpr int kCavlcNodes = 20;
  static constexpr size_t kCavlcBase = kSkipBase + 12;
  static constexpr size_t kCavlcStride = size_t(kNumCavlcRolesM) * kCavlcAux * kCavlcNodes;
  // prev-skip-conditioned P/B mb_type + mvd bins (ctx 14..59 compacted)
  static constexpr size_t kMbExtraBase = kCavlcBase + kCavlcStride;
  static constexpr size_t kMbExtraStride = size_t(46) * 2;
  static constexpr size_t kSignBase = kMbExtraBase + 3 * kMbExtraStride;
  // mvd bins additionally conditioned on a fine |mvd| neighbor-sum bucket
  // (the walker supplies it as the bin's aux; CABAC's own ctxIdxInc only
  // 3-buckets the first bin and leaves prefix bins unconditioned).
  static constexpr int kMvdAuxBuckets = 8;
  static constexpr size_t kMvdAuxBase = kSignBase + 3 * 16;
  static constexpr size_t kMvdAuxStride = size_t(14) * 2 * kMvdAuxBuckets;
  // rem_intra_pred_mode bins keyed on the binary-tree node (aux 1..7): the
  // spec codes all 3 FL bins under one context; this learns the full rem
  // value distribution (v20).
  static constexpr size_t kIntraRemBase = kMvdAuxBase + 3 * kMvdAuxStride;
  // Exp-Golomb suffix exponent bins (mvd UEG3 / level UEG0) keyed on the
  // exponent index (aux, capped 8): CABAC prices every bypass bin at exactly
  // 1 bit, but the continuation probability decays geometrically (v21).
  static constexpr size_t kBypOtherAuxBase = kIntraRemBase + 3 * 8;
  static constexpr size_t kBypResAuxBase = kBypOtherAuxBase + 3 * 8;
  // mvd sign bins keyed on (component, sign of the neighbor mvd sum) — v23.
  static constexpr size_t kMvdSignBase = kBypResAuxBase + 3 * 8;
  // coded_block_pattern bins conditioned on the previous frame's cbp at the
  // same MB (v27): luma bins on (spec inc, 8x8 index, prev-frame bit of that
  // 8x8), chroma bins on (spec ctx offset, prev-frame chroma class). CABAC
  // only sees spatial neighbors (ctxIdxInc); static regions make cbp
  // strongly temporally persistent.
  static constexpr size_t kCbpBase = kMvdSignBase + 3 * 12;
  static constexpr size_t kCbpLumaStride = size_t(4) * 4 * 2;  // inc x b8 x prev
  static constexpr size_t kCbpChromaStride = size_t(8) * 3;    // ctx-off x prev class
  // B mb_type bins additionally keyed on whether the previous frame's MB at
  // this position had any coded residual (v27, with the cbp keys): moving
  // areas keep coding residual, static ones keep B_skip/Direct. Swept:
  // sparse -0.050pp, camera -0.021pp, screen -0.030pp, dense -0.005pp;
  // P mb_type and a combined P+B variant measured worse on small clips
  // (estimator dilution), so only the B bins split.
  static constexpr size_t kMbT2Base = kCbpBase + 3 * (kCbpLumaStride + kCbpChromaStride);
  static constexpr size_t kMbT2Stride = size_t(22) * 4;  // ctx-off x skip x resid
  static constexpr size_t kNumDualKeys = kMbT2Base + 3 * kMbT2Stride;
  // Off-mode (classic adaptive-EOB) significance keys live after the
  // nnz-conditioned region; same table + formula with a neutral prior.
  static constexpr size_t kSigOffStride = size_t(6) * kSigPosClasses * 2 * 16;  // cat,pos,dc,obs
  static constexpr size_t kSigOffBase = 3 * kSigStride;
  static constexpr size_t kEobOffStride = size_t(6) * kSigPosClasses * 2;
  static constexpr size_t kEobOffBase = kSigOffBase + 3 * kSigOffStride;
  // The raw sig key space is sparse (~1% occupied); hash it into a compact
  // table (identical on host and device — collisions deterministically share
  // estimators, measured ratio impact <0.05%). Keeps device tables small.
  static constexpr int kSigHashBits = 17;
  static constexpr size_t kNumSigKeys = size_t(1) << kSigHashBits;
  static size_t hash_sig(size_t raw) {
    return (uint32_t(raw) * 2654435761u) >> (32 - kSigHashBits);
  }
  static constexpr uint16_t kNeutralPrior = kProbScale / 2;

  PriorModel() : state_prob_(state_prob_q15()) {
    dual_.assign(kNumDualKeys, Dual());
    sig_est_.assign(kNumSigKeys, Estimator{0, 0});
  }

  // Batched ("deferred") estimator updates: with batch B > 1, probabilities
  // within a batch come from tables frozen at the last batch boundary, and all
  // of a batch's updates are applied at once (per-key aggregate, then
  // halve-while-over-window). This makes the model pass a gather + scatter-add
  // per batch — the TPU formulation — while the serial decoder replicates the
  // identical integer semantics. B is a container format parameter; B=1 gives
  // classic per-bin adaptation.
  void set_batch_size(uint32_t b) {
    batch_ = b ? b : 1;
    if (batch_ > 32768) batch_ = 32768;  // uint16 counter headroom
  }

  // Tri-modal significance coding: 2-bit field (slice_class*6 + cat) of
  // nz_modes_ selects how the significance complex is coded:
  //   1 = NZ-first (count coded up front, EOB bins free),
  //   0 = classic adaptive-EOB (learned estimators),
  //   2 = adaptive sig + CABAC-parity EOB (EOB bins coded at the mirrored
  //       CABAC state probability — guarantees ~parity with the original
  //       stream on EOB bins where the learned estimator loses, e.g. dense
  //       grain content).
  // Chosen per chunk at compress time from pass-1 statistics; stored in the
  // container.
  static constexpr uint64_t kAllNzOn = 0x555555555ull;  // 18 cells, value 1
  void set_nz_modes(uint64_t modes) { nz_modes_ = modes; }
  int sig_mode() const { return int((nz_modes_ >> (2 * (sc_ * 6 + cat_))) & 3); }
  bool nz_on() const { return sig_mode() == 1; }
  bool eob_parity() const { return sig_mode() == 2; }

  // Model profile 0 = counting estimators with immediate within-batch
  // increments (ratio-optimal, the host path); 2 = frozen-batch counting
  // estimators (probabilities read tables as of the last flush — the TPU
  // formulation behind the slim device wire, measured +0.10pp on bench.mp4).
  // Format-defining; stored in the container. (Profile 1, division-free EMA
  // estimators for an in-kernel Pallas loop, was removed after the XLA
  // super-batched pass measured 180x faster than the Pallas scalar loop —
  // RESULTS.md "Pallas decision".)
  void set_profile(int p) { profile_ = p; }
  int profile() const { return profile_; }

  // Seeds the per-ctx estimators from the H.264 context-init state so the
  // model starts at CABAC's tuned priors instead of p=0.5 (win on short
  // chunks; the reference always cold-starts, recode.cpp:1057).
  void seed_from_cabac(int cabac_init_idc, int slice_qp) {
    // Always stash the current slice's CABAC params: begin_slice() (called
    // right after, with the slice class) re-initializes the mirror context
    // bank from them — the mirror tracks the *original* stream's CABAC state
    // per slice, independent of the once-only estimator seeding below.
    mirror_idc_ = cabac_init_idc;
    mirror_qp_ = slice_qp;
    if (seeded_) return;
    seeded_ = true;
    // pLPS(sigma) ~= 0.5 * alpha^sigma, alpha = (0.01875/0.5)^(1/63).
    constexpr int W = 24;
    constexpr int WS = 192;
    static const double kAlpha = 0.9491255522855953;  // pow(0.0375, 1/63.)
    for (int cls = 0; cls < 3; ++cls) {
      CabacContexts c;
      c.init(cls == 0, cabac_init_idc, slice_qp);
      size_t base = size_t(cls) * kCtxStride;
      for (int i = 0; i < kNumCabacContexts; ++i) {
        double plps = 0.5;
        for (int s = 0; s < c.p_state[i]; ++s) plps *= kAlpha;
        double p1 = c.val_mps[i] ? 1.0 - plps : plps;
        int pos = int(p1 * W + 0.5);
        if (pos < 1) pos = 1;
        if (pos > W - 1) pos = W - 1;
        dual_[base + i].fp = uint16_t(pos);
        dual_[base + i].fn = uint16_t(W - pos);
        int pos_s = int(p1 * WS + 0.5);
        if (pos_s < 1) pos_s = 1;
        if (pos_s > WS - 1) pos_s = WS - 1;
        dual_[base + i].sp = uint16_t(pos_s);
        dual_[base + i].sn = uint16_t(WS - pos_s);
      }
      // Bypass/sign bins: genuinely near 0.5 -> damp early noise hard. These
      // keys are always read slow-only (route() gives them kKindDualSlow), so
      // only the sp/sn damping matters; the fast voice is seeded WITHIN its
      // window so the v22 invariant (no estimator starts a batch over-window)
      // holds — flush halving is detected at window-crossing time.
      dual_[base + kCtxBypass] = Dual{24, 24, 256, 256};
      dual_[base + kNumModelContexts + 0] = Dual{24, 24, 256, 256};
      dual_[base + kNumModelContexts + 1] = Dual{24, 24, 256, 256};
      // Terminate bins are almost always 0.
      dual_[base + kCtxTerminate] = Dual{1, 47, 1, 511};
    }
  }

  // ---- picture / mb / block state ----------------------------------------
  // slice_class: 0 = I, 1 = P, 2 = B. Estimator banks are separated per class
  // (CABAC effectively does the same via per-slice-type init tables; I/P/B bin
  // statistics differ enough that mixing them costs ~0.5%).
  void set_chroma422(bool v) { chroma422_ = v; }
  void begin_slice(int slice_class, bool new_picture, int mb_width, int mb_height) {
    sc_ = slice_class;
    mirror_.init(slice_class == 0, mirror_idc_, mirror_qp_);
    if (new_picture || frames_[cur_].w != mb_width || frames_[cur_].h != mb_height) {
      cur_ ^= 1;
      frames_[cur_].reset(mb_width, mb_height);
      skip_grid_[cur_].assign(size_t(mb_width) * mb_height, 0);
      cbp_grid_[cur_].assign(size_t(mb_width) * mb_height, 0);
      if (frames_[cur_ ^ 1].w != mb_width || frames_[cur_ ^ 1].h != mb_height) {
        frames_[cur_ ^ 1].reset(mb_width, mb_height);
        skip_grid_[cur_ ^ 1].assign(size_t(mb_width) * mb_height, 0);
        cbp_grid_[cur_ ^ 1].assign(size_t(mb_width) * mb_height, 0);
      }
    }
  }

  int prev_skip() const {
    const auto& g = skip_grid_[cur_ ^ 1];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    return idx < g.size() && g[idx] ? 1 : 0;
  }
  void set_skip(int bit) {
    auto& g = skip_grid_[cur_];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    if (idx < g.size()) g[idx] = uint8_t(bit);
  }
  // Previous-frame CBP state at the same MB (v27 cbp keys), tracked from the
  // coded cbp bins themselves. I_16x16 / I_PCM MBs never code cbp bins, so
  // their grid entry stays 0 — an approximation both codec sides share.
  // Layout per MB byte: bits 0-3 luma 8x8 bits, bit 4 chroma nonzero,
  // bit 5 chroma == 2.
  // Any coded residual at the previous frame's same-position MB (cbp grid).
  int prev_mb_resid() const {
    const auto& g = cbp_grid_[cur_ ^ 1];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    return idx < g.size() && g[idx] ? 1 : 0;
  }
  int prev_cbp_luma(int b8) const {
    const auto& g = cbp_grid_[cur_ ^ 1];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    return idx < g.size() ? (g[idx] >> b8) & 1 : 0;
  }
  int prev_cbp_chroma() const {
    const auto& g = cbp_grid_[cur_ ^ 1];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    int v = idx < g.size() ? g[idx] : 0;
    return (v & 0x20) ? 2 : ((v & 0x10) ? 1 : 0);
  }
  void note_cavlc_resid() {
    auto& g = cbp_grid_[cur_];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    if (idx < g.size()) g[idx] |= 1;
  }
  void note_cbp_bit(int ctx, int aux, int bit) {
    auto& g = cbp_grid_[cur_];
    size_t idx = size_t(mb_y_) * frames_[cur_].w + mb_x_;
    if (idx >= g.size() || !bit) return;
    if (ctx < kCtxCbpLuma + 4) {
      if (aux >= 0 && aux < 4) g[idx] |= uint8_t(1u << aux);
    } else if (ctx < kCtxCbpChroma + 4) {
      g[idx] |= 0x10;  // chroma nonzero
    } else {
      g[idx] |= 0x20;  // chroma == 2
    }
  }
  void begin_mb(int x, int y) {
    mb_x_ = x;
    mb_y_ = y;
  }
  void begin_block(int slot, int cat, int max_coeff) {
    slot_ = slot;
    cat_ = cat;
    max_coeff_ = max_coeff;
    nnz_total_ = -1;  // unknown until NZ bits are coded/decoded
    observed_ = 0;
    in_sig_ = false;
  }
  void mark_in_sig() { in_sig_ = true; }  // off-mode: sig map without NZ count
  void end_block() {
    if (in_sig_) frames_[cur_].set(mb_x_, mb_y_, slot_, uint8_t(observed_));
    in_sig_ = false;
  }
  void note_implicit_last() { ++observed_; }

  // ---- estimator machinery ------------------------------------------------
  // Exact small-denominator division via round-up magic multipliers:
  // floor(n/d) == (n * ceil(2^36/d)) >> 36 for n < 2^25, d <= 2048
  // (proof: the magic's excess e <= 1 adds n*e/2^36 < 2^-11 <= 1/d to n/d,
  // which cannot cross the next integer since frac(n/d) <= 1 - 1/d). All
  // batch-1 host-path numerators/denominators are within bounds (windows
  // 48/640/128, alphas <= 96); batched device-replay states can exceed them
  // and take the hardware divide. Saves ~20 cycles per division on the
  // 2-3-divisions-per-bin hot loop; bit-exact by construction (tested).
  // The magic table lives at namespace scope (initialized at library load):
  // a function-local static would cost an atomic init-guard load per call —
  // ~45M calls per model pass.
  struct DivMagic {
    uint64_t t[2049];
    DivMagic() {
      t[0] = 0;
      for (uint32_t i = 1; i <= 2048; ++i)
        t[i] = ((uint64_t(1) << 36) + i - 1) / i;
    }
  };
  static inline const DivMagic div_magic_{};
  static uint32_t div_q(uint32_t n, uint32_t d) {
    if (n < (1u << 25) && d <= 2048)
      return uint32_t((uint64_t(n) * div_magic_.t[d]) >> 36);
    return n / d;
  }
  static uint32_t prob15(const Estimator& e) {
    uint32_t p = div_q(uint32_t(e.pos) << kProbBits, uint32_t(e.pos) + e.neg);
    if (p < 1) p = 1;
    if (p > kProbScale - 1) p = kProbScale - 1;
    return p;
  }
  static void update(Estimator& e, int bit, int window) {
    // Branchless counts: `bit` is data-random on the hot path — a predicted
    // branch here mispredicts ~half the time.
    e.pos += uint16_t(bit);
    e.neg += uint16_t(bit ^ 1);
    if (e.pos + e.neg > window) {
      e.pos = (e.pos + 1) >> 1;
      e.neg = (e.neg + 1) >> 1;
    }
  }

  static constexpr int kFastWindow = 48;
  static constexpr int kSlowWindow = 640;
  static uint32_t dual_prob(const Dual& d, bool slow_only = false, uint16_t prior = 0) {
    uint32_t ps = div_q(uint32_t(d.sp) << kProbBits, uint32_t(d.sp) + d.sn);
    uint32_t p;
    if (slow_only) {
      p = ps;
    } else if (prior) {
      // Three-voice mix: fast + slow learned estimators (3/8 each) + the
      // mirrored CABAC prediction (2/8). Applies to every context-coded
      // mb-layer bin, residual levels, and cbf (swept weights 1..6/8 across
      // dense + sparse content; 2/8 with res+cbf included won on both).
      uint32_t pf = div_q(uint32_t(d.fp) << kProbBits, uint32_t(d.fp) + d.fn);
      p = (3u * (pf + ps) + 2u * prior) >> 3;
    } else {
      uint32_t pf = div_q(uint32_t(d.fp) << kProbBits, uint32_t(d.fp) + d.fn);
      p = (pf + ps) >> 1;
    }
    if (p < 1) p = 1;
    if (p > kProbScale - 1) p = kProbScale - 1;
    return p;
  }
  static void dual_update(Dual& d, int bit) {
    d.fp += uint16_t(bit);
    d.fn += uint16_t(bit ^ 1);
    d.sp += uint16_t(bit);
    d.sn += uint16_t(bit ^ 1);
    if (d.fp + d.fn > kFastWindow) {
      d.fp = (d.fp + 1) >> 1;
      d.fn = (d.fn + 1) >> 1;
    }
    if (d.sp + d.sn > kSlowWindow) {
      d.sp = (d.sp + 1) >> 1;
      d.sn = (d.sn + 1) >> 1;
    }
  }

  // Routing: bypass bins get role-separated estimators (suffix bits vs generic
  // bypass); coded_block_flag and mb_skip_flag add a temporal prior dimension
  // (previous picture, same block/MB); signs and terminates use fixed
  // probabilities (measured: adaptivity only adds noise there).
  // The ChromaArrayType==3 extension banks (Cb/Cr cats 6-13) share the
  // estimator key spaces of their luma/chroma analogues — deterministic on
  // both codec sides; plane separation rides the slot/cat where it matters.
  static int canon_cbf_ctx(int ctx) {
    if (ctx >= 1012) return 93 + ((ctx - 1012) & 3);       // 8x8 cats -> cat-2 bank
    if (ctx >= 472 && ctx < 484) return 85 + (ctx - 472);  // Cr DC/AC/4x4
    if (ctx >= 460 && ctx < 472) return 85 + (ctx - 460);  // Cb DC/AC/4x4
    return ctx;
  }
  static int canon_abs_ctx(int ctx) {
    if (ctx >= 982 && ctx < 1012) return kCtxAbsBase + (ctx - 982);
    if (ctx >= 952 && ctx < 982) return kCtxAbsBase + (ctx - 952);
    if (ctx >= 766 && ctx < 776) return kCtxAbs8x8Base + (ctx - 766);
    if (ctx >= 708 && ctx < 718) return kCtxAbs8x8Base + (ctx - 708);
    return ctx;
  }

  size_t route(int ctx, BinKlass klass, int aux = -1) {
    size_t base = size_t(sc_) * kCtxStride;
    switch (klass) {
      case kKlassSign:
        // Coefficient signs keyed on (slice_class, cat): unbiased content
        // converges to 1/2 at negligible cost (<0.003pp measured on camera
        // and dense-grain clips) while biased content (screen/synthetic
        // gradients, chroma DC) gains up to 0.28pp.
        return kSignBase + size_t(sc_) * 16 + (cat_ & 15);
      case kKlassBypassRes:
        if (aux >= 0)
          return kBypResAuxBase + size_t(sc_) * 8 + size_t(aux > 7 ? 7 : aux);
        return base + kNumModelContexts + 0;
      case kKlassMvdSign:
        return kMvdSignBase + size_t(sc_) * 12 + size_t(aux >= 0 && aux < 12 ? aux : 0);
      case kKlassRes:
        if (ctx < kCtxBypass) return res_key(ctx, 0);
        return base + ctx;
      case kKlassCbf: {
        int prev = frames_[cur_ ^ 1].get(mb_x_, mb_y_, slot_) > 0 ? 1 : 0;
        return kCbfBase2 + size_t(sc_) * 40 +
               size_t(canon_cbf_ctx(ctx) - kCtxCbfBase) * 2 + prev;
      }
      case kKlassSkip: {
        int compact = (ctx >= kCtxMbSkipB) ? ctx - kCtxMbSkipB + 3 : ctx - kCtxMbSkipP;
        return kSkipBase + size_t(compact) * 2 + prev_skip();
      }
      default:
        // Temporal conditioning for P/B mb_type, mvd and ref_idx bins:
        // statistics differ sharply between previously-static (skip) and
        // moving regions (ref_idx added at v15: -0.01pp on every class).
        if (aux >= 0 && ctx >= kCtxMvdX && ctx < kCtxMvdX + 14) {
          return kMvdAuxBase + size_t(sc_) * kMvdAuxStride +
                 (size_t(ctx - kCtxMvdX) * 2 + prev_skip()) * kMvdAuxBuckets +
                 size_t(aux);
        }
        if (aux >= 0 && ctx == kCtxIntra4x4PredRem)
          return kIntraRemBase + size_t(sc_) * 8 + size_t(aux & 7);
        // v27: cbp bins conditioned on the previous frame's cbp at this MB.
        if (ctx >= kCtxCbpLuma && ctx < kCtxCbpChroma + 8) {
          size_t cb = kCbpBase + size_t(sc_) * (kCbpLumaStride + kCbpChromaStride);
          if (ctx < kCtxCbpLuma + 4) {
            if (aux >= 0)
              return cb + (size_t(ctx - kCtxCbpLuma) * 4 + size_t(aux & 3)) * 2 +
                     size_t(prev_cbp_luma(aux & 3));
          } else {
            return cb + kCbpLumaStride + size_t(ctx - kCtxCbpChroma) * 3 +
                   size_t(prev_cbp_chroma());
          }
        }
        if (aux >= 0 && ctx == kCtxBypass)
          return kBypOtherAuxBase + size_t(sc_) * 8 + size_t(aux > 7 ? 7 : aux);
        if ((ctx >= kCtxMbTypeP && ctx < kCtxMbTypeP + 4) ||
            (ctx >= kCtxMbTypeB && ctx < kCtxMbTypeB + 9)) {
          if (ctx >= kCtxMbTypeB)
            return kMbT2Base + size_t(sc_) * kMbT2Stride +
                   size_t(ctx - kCtxMbTypeP) * 4 + size_t(prev_skip()) * 2 +
                   size_t(prev_mb_resid());
          return kMbExtraBase + size_t(sc_) * kMbExtraStride +
                 size_t(ctx - kCtxMbTypeP) * 2 + prev_skip();
        }
        if ((ctx >= kCtxMvdX && ctx < kCtxMvdX + 14) ||
            (ctx >= kCtxRefIdx && ctx < kCtxRefIdx + 6)) {
          return kMbExtraBase + size_t(sc_) * kMbExtraStride +
                 size_t(ctx - kCtxMbTypeP) * 2 + prev_skip();
        }
        return base + ctx;
    }
  }

  static bool slow_only(BinKlass klass) {
    return klass == kKlassSign || klass == kKlassBypassOther ||
           klass == kKlassBypassRes || klass == kKlassTerminate ||
           klass == kKlassMvdSign;
  }

  // Coded-bin trace record: the (kind, key, prior) triple fully determines the
  // probability given the frozen tables — the host->device interchange.
  // kKindPrior: probability is the recorded prior verbatim (no table, no
  // update) — the device passthrough for CABAC-parity EOB bins.
  enum BinKind : uint8_t { kKindDual = 0, kKindDualSlow = 1, kKindSig = 2, kKindPrior = 3 };
  struct Coded {
    uint8_t bit, kind;
    uint32_t key;
    uint16_t prior;  // sig mix prior (kKindSig only)
  };

  // Sig priors carry the mix weight in bit 15 (see sig_prior): set = off-mode
  // (mirrored-CABAC prior, weight kSigMixAlphaOff), clear = on-mode
  // (hypergeometric prior, weight kSigMixAlpha). The tag travels verbatim in
  // the device trace so the TPU pass selects the same weight per bin.
  static constexpr uint16_t kPriorOffTag = 0x8000;
  // Residual-level bins use a Dirichlet-style count-weighted mix instead of
  // the fixed-weight linear mix: p = ((K*fp + sp)<<15 + A*prior) /
  // (K*(fp+fn) + sp+sn + A). Cold/diluted key cells lean on the mirrored
  // CABAC prior (never lose much to the original), hot cells on the learned
  // counts. Selected per bin by kPriorOffTag in the prior (the tag bit is
  // free on kKindDual bins — it only means off-mode on kKindSig bins), so
  // the device trace needs no extra fields. Swept A in 8..96, K in 1..6 on
  // dense + sparse + camera content: A=32, K=2 won (bench -0.073pp, sparse
  // -0.043pp, camera -0.078pp); extending the same mix to mb-layer ctx bins
  // LOST everywhere (their seeded fast estimators + linear mix are better).
  static constexpr uint32_t kResDirAlpha = 32;
  static constexpr uint32_t kResDirFastBoost = 2;
  // Off-mode sig prior weight: chosen empirically per FILE by the nz-mode
  // probe from kSigAlphaCands (v18) — dense grain favors a heavy mirrored-
  // CABAC prior (96: bench -0.025pp), structured content a light one
  // (32: sparse -0.034pp). One value per file so the device pass keeps a
  // single static sig_alpha; travels in the container and the analyze wire.
  static constexpr uint32_t kSigAlphaCands[4] = {48, 32, 64, 96};
  void set_alpha_off(uint32_t a) { alpha_off_ = a; }
  uint32_t alpha_off() const { return alpha_off_; }
  // Frozen-batch flush replay source (analyze path): a recorded trace with
  // one entry per stream position, in order — see flush_updates.
  void set_flush_replay(const std::vector<Coded>* t) { replay_ = t; }
  uint32_t prob_for(uint8_t kind, uint32_t key, uint16_t prior) const {
    if (kind == kKindSig) {
      uint32_t alpha = (prior & kPriorOffTag) ? alpha_off_ : kSigMixAlpha;
      prior &= 0x7fff;
      const Estimator& e = sig_est_[key];
      uint32_t p = div_q((uint32_t(e.pos) << kProbBits) + alpha * prior,
                         uint32_t(e.pos) + e.neg + alpha);
      if (p < 1) p = 1;
      if (p > kProbScale - 1) p = kProbScale - 1;
      return p;
    }
    if (kind == kKindDual && (prior & kPriorOffTag)) {
      const Dual& d = dual_[key];
      constexpr uint32_t A = kResDirAlpha, K = kResDirFastBoost;
      uint32_t num =
          ((K * d.fp + uint32_t(d.sp)) << kProbBits) + A * (prior & 0x7fff);
      uint32_t den = K * (uint32_t(d.fp) + d.fn) + d.sp + d.sn + A;
      uint32_t p = div_q(num, den);
      if (p < 1) p = 1;
      if (p > kProbScale - 1) p = kProbScale - 1;
      return p;
    }
    return dual_prob(dual_[key], kind == kKindDualSlow, prior);
  }

  static uint32_t clamp15(int32_t p) {
    if (p < 1) return 1;
    if (p > int32_t(kProbScale) - 1) return kProbScale - 1;
    return uint32_t(p);
  }

  // Registers a coded bin: count increments apply IMMEDIATELY (on the device
  // this is a within-batch segmented prefix-sum — still parallel), while the
  // window-halving normalization is deferred to the batch boundary. With B=1
  // this is exactly classic per-bin adaptation. MUST be called once per coded
  // bin, in pair-stream order, on both encode and decode paths.
  void note_coded(uint8_t kind, uint32_t key, int bit) {
    if (batch_ == 1 && profile_ == 0) {
      // Per-bin adaptation fast path: the pending queue always flushes after
      // one entry — update and window-halve inline (bit-identical to the
      // queued path; one estimator can gain at most 1 per bin, so a single
      // halving check suffices).
      if (kind == kKindPrior) return;
      if (kind == kKindSig) {
        Estimator& e = sig_est_[key];
        e.pos += uint16_t(bit);
        e.neg += uint16_t(bit ^ 1);
        if (e.pos + e.neg > kWindowSig) {
          e.pos = (e.pos + 1) >> 1;
          e.neg = (e.neg + 1) >> 1;
        }
      } else {
        dual_update(dual_[key], bit);
      }
      return;
    }
    if (profile_ == 2) {
      // Frozen-batch profile: increments are NOT visible within the batch —
      // probabilities read the table as of the last flush. This removes the
      // within-batch per-key prefix machinery from the device pass (the whole
      // batch becomes one gather + one scatter per table); the serial decoder
      // replays the identical semantics from this same code path. When a
      // trace is being recorded (analyze path), it already holds one entry
      // per stream position in order — flush replays its tail instead of
      // duplicating every bin into pending_.
      if (!replay_) pending_.push_back({uint8_t(bit), kind, key, 0});
      if (++fill_ >= batch_) flush_updates();
      return;
    }
    // Immediate-increment batch path (profile 0, batch > 1). Counts are
    // monotone within a batch (halving only happens at flush), so an
    // estimator is over its window at the flush boundary IFF one of its
    // counts crossed the window during this batch — push the key into
    // pending_ only at that crossing instead of on every bin (windows 48/
    // 640/128 make crossings 20-50x rarer than touches; kills most of the
    // pending_ traffic and the flush-time random table walk). Requires the
    // v22 invariant: every estimator starts each batch within its window
    // (seeds are in-window, flush normalizes, snapshots are normalized).
    if (kind == kKindSig) {
      Estimator& e = sig_est_[key];
      e.pos += uint16_t(bit);
      e.neg += uint16_t(bit ^ 1);
      if (uint32_t(e.pos) + e.neg == kWindowSig + 1)
        pending_.push_back({uint8_t(bit), kind, key, 0});
    } else {
      Dual& d = dual_[key];
      d.fp += uint16_t(bit);
      d.fn += uint16_t(bit ^ 1);
      d.sp += uint16_t(bit);
      d.sn += uint16_t(bit ^ 1);
      if (uint32_t(d.fp) + d.fn == kFastWindow + 1 ||
          uint32_t(d.sp) + d.sn == kSlowWindow + 1)
        pending_.push_back({uint8_t(bit), kind, key, 0});
    }
    if (++fill_ >= batch_) flush_updates();
  }

  // Prior-passthrough bins (kKindPrior) touch no estimator but still occupy a
  // stream position: count them toward the batch fill so host batch
  // boundaries stay aligned with the device's stream-position batches (the
  // frozen profile additionally records a placeholder pending entry — its
  // flush replays increments from pending_ in stream order).
  void note_passthrough() {
    if (batch_ == 1 && profile_ == 0) return;  // alignment no-op at batch 1
    if (profile_ == 2 && !replay_) pending_.push_back({0, kKindPrior, 0, 0});
    if (++fill_ >= batch_) flush_updates();
  }

  // Batch-boundary normalization: halve every touched estimator while it is
  // over its window (commutative; device equivalent is a masked elementwise
  // pass over the tables).
  void flush_updates() {
    // Frozen-batch replay source: the recorded trace's last fill_ entries are
    // exactly this batch, in stream order (the recorder pushes each bin's
    // trace entry before its note_coded/note_passthrough) — same content
    // pending_ would hold, without the per-bin duplicate push.
    const Coded* batch_begin = pending_.data();
    const Coded* batch_end = batch_begin + pending_.size();
    if (profile_ == 2 && replay_) {
      if (replay_->size() < fill_)
        throw std::logic_error("flush replay: trace shorter than batch fill");
      batch_end = replay_->data() + replay_->size();
      batch_begin = batch_end - fill_;
    }
    if (profile_ == 2) {
      // Apply the deferred increments first (frozen-batch profile).
      for (const Coded* c = batch_begin; c != batch_end; ++c) {
        if (c->kind == kKindPrior) continue;
        if (c->kind == kKindSig) {
          Estimator& e = sig_est_[c->key];
          if (c->bit) ++e.pos; else ++e.neg;
        } else {
          Dual& d = dual_[c->key];
          if (c->bit) { ++d.fp; ++d.sp; } else { ++d.fn; ++d.sn; }
        }
      }
    }
    for (const Coded* c = batch_begin; c != batch_end; ++c) {
      if (c->kind == kKindPrior) continue;  // no-op placeholder (alignment)
      if (c->kind == kKindSig) {
        Estimator& e = sig_est_[c->key];
        while (e.pos + e.neg > kWindowSig) {
          e.pos = (e.pos + 1) >> 1;
          e.neg = (e.neg + 1) >> 1;
        }
      } else {
        Dual& d = dual_[c->key];
        while (d.fp + d.fn > kFastWindow) {
          d.fp = (d.fp + 1) >> 1;
          d.fn = (d.fn + 1) >> 1;
        }
        while (d.sp + d.sn > kSlowWindow) {
          d.sp = (d.sp + 1) >> 1;
          d.sn = (d.sn + 1) >> 1;
        }
      }
    }
    pending_.clear();
    fill_ = 0;
  }

  uint16_t bin_prior(int ctx, BinKlass klass) const {
    return (ctx < kCtxBypass && !slow_only(klass)) ? uint16_t(mirror_prob(ctx)) : 0;
  }
  uint32_t bin_prob(int ctx, BinKlass klass, int aux = -1) {
    uint8_t kind = slow_only(klass) ? kKindDualSlow : kKindDual;
    cached_aux_ = int16_t(aux);
    cached_dual_key_ = uint32_t(route(ctx, klass, aux));
    cached_prior_ = bin_prior(ctx, klass);
    return prob_for(kind, cached_dual_key_, cached_prior_);
  }
  void bin_update(int ctx, BinKlass klass, int bit) {
    uint8_t kind = slow_only(klass) ? kKindDualSlow : kKindDual;
    note_coded(kind, cached_dual_key_, bit);
    if (klass == kKlassSkip) set_skip(bit);
    if (klass == kKlassOther && ctx >= kCtxCbpLuma && ctx < kCtxCbpChroma + 8)
      note_cbp_bit(ctx, cached_aux_, bit);
  }
  // (kind,key,prior) of the last bin_prob/sig_prob computation, for tracing.
  uint8_t last_kind(BinKlass klass) const {
    return slow_only(klass) ? kKindDualSlow : kKindDual;
  }

  // Residual level bins conditioned on the block's nonzero count in addition
  // to the spec context (a prior the reference never exploits).
  size_t res_key(int ctx, int pos) const {
    ctx = canon_abs_ctx(ctx);
    int idx = (ctx >= kCtxAbs8x8Base) ? 49 + (ctx - kCtxAbs8x8Base) : ctx - kCtxAbsBase;
    int cnt = nnz_total_ >= 1 ? nnz_total_ : observed_;  // observed in off-mode
    int nnz_class = cnt < 16 ? cnt : 15;
    int pos_class = sig_pos_class(pos);
    return kResBase + size_t(sc_) * kResStride +
           (size_t(idx) * 16 + nnz_class) * 16 + pos_class;
  }

  // Significance probability = hypergeometric prior (remaining nonzeros over
  // remaining positions — computable only because the nonzero count is coded
  // first) mixed with a dense learned correction keyed on
  // (cat, pos_class, nnz_class). The prior gives instant accuracy on cold
  // contexts; the estimator learns the zigzag energy-concentration skew.
  static constexpr int kSigMixAlpha = 1;      // on-mode (hypergeometric prior)
  static constexpr int kSigMixAlphaOff = 48;  // off-mode (mirrored-CABAC prior)
  int sig_pos_class(int pos) const {
    // pos 63 (a level bin) is past the [63] row: read [1][0], as contiguity did.
    return (cat_ == kCatLuma8x8) ? (pos < 63 ? kSigCoeffFlagOffset8x8[0][pos]
                                             : kSigCoeffFlagOffset8x8[1][0])
                                 : (pos < kSigPosClasses ? pos : kSigPosClasses - 1);
  }
  int sig_is_dc() const { return (cat_ == kCatLumaDC || cat_ == kCatChromaDC) ? 1 : 0; }
  size_t sig_key(int pos) const {
    if (!nz_on()) {
      // Off-mode keys add a 3-bit Markov history of recent significance bins
      // (energy clusters along the scan; swept 1..4 bits on dense + sparse +
      // camera content — 3 won everywhere; ON-mode history was a loss on
      // camera content and is not taken).
      int obs = observed_ < 16 ? observed_ : 15;
      size_t key = ((size_t(cat_) * kSigPosClasses + sig_pos_class(pos)) * 2 + sig_is_dc()) * 16 +
                   obs;
      key = (key << 3) + (sig_hist_ & 7);
      return hash_sig(kSigOffBase + size_t(sc_) * kSigOffStride + key);
    }
    size_t key = (size_t(nnz_total_) * 64 + observed_) * kSigThird +
                 (sig_is_dc() + 2 * sig_pos_class(pos) + 2 * kSigPosClasses * cat_);
    return hash_sig(size_t(sc_) * kSigStride + key);
  }
  uint16_t sig_prior(int ctx, int pos) const {
    // Off-mode: back off to the mirrored CABAC prediction, weighted heavily
    // (kSigMixAlphaOff pseudo-counts: on dense content the mirror prediction
    // beats the learned correction until the cell has real evidence —
    // measured -0.37pp on dense-grain 720p, -0.05pp on sparse content).
    // Bit 15 tags the weight choice for prob_for and the device pass.
    if (!nz_on()) return uint16_t(mirror_prob(ctx)) | kPriorOffTag;
    int remaining = nnz_total_ - observed_;
    int left = max_coeff_ - pos;
    uint32_t prior = (uint32_t(remaining) << kProbBits) / uint32_t(left);
    if (prior < 1) prior = 1;
    if (prior > kProbScale - 1) prior = kProbScale - 1;
    return uint16_t(prior);
  }
  // NOTE on the cached_*_key_ members: every *_prob call is immediately
  // followed by its *_update twin with identical model state (both pipeline
  // directions, audited) — the update reuses the key computed by the prob
  // call instead of re-deriving it, and the device-trace recorder reuses the
  // cached (key, prior) pair instead of re-deriving both per bin (the trace
  // walk is the device e2e critical path). Pure micro-optimization; bit-exact.
  uint32_t sig_prob(int ctx, int pos) {
    assert(!nz_on() || nnz_total_ >= 1);
    cached_sig_key_ = uint32_t(sig_key(pos));
    cached_prior_ = sig_prior(ctx, pos);
    return prob_for(kKindSig, cached_sig_key_, cached_prior_);
  }
  // Key/prior derivation without the probability math — the trace-only
  // analyze walk (device path) records (kind, key, prior) and the device
  // computes every probability itself, so the 2-3 divisions per bin of
  // prob_for are pure waste there. Must stay in lockstep with the *_prob
  // twins above/below (same cached_* writes).
  void sig_key_prior(int ctx, int pos) {
    cached_sig_key_ = uint32_t(sig_key(pos));
    cached_prior_ = sig_prior(ctx, pos);
  }
  void eob_key_prior(int ctx, int pos) {
    cached_sig_key_ = uint32_t(eob_key(pos));
    cached_prior_ = uint16_t(mirror_prob(ctx));
  }
  void res_key_prior(int ctx, int pos) {
    cached_dual_key_ = uint32_t(res_key(ctx, pos));
    cached_prior_ = res_prior(ctx);
  }
  void bin_key_prior(int ctx, BinKlass klass, int aux = -1) {
    cached_aux_ = int16_t(aux);
    cached_dual_key_ = uint32_t(route(ctx, klass, aux));
    cached_prior_ = bin_prior(ctx, klass);
  }
  // Cached (key, prior) of the last *_prob call — the trace recorder's view
  // (avoids a second key derivation per traced bin; see sig_prob NOTE).
  uint32_t cached_sig_key() const { return cached_sig_key_; }
  uint32_t cached_dual_key() const { return cached_dual_key_; }
  uint16_t cached_prior() const { return cached_prior_; }
  // Probe-only alternative-alpha pricing of the bin sig_prob just computed
  // (reuses cached_sig_key_; pre-update state, like sig_prob itself).
  uint32_t sig_prob_alpha_probe(uint16_t prior, uint32_t alpha) const {
    const Estimator& e = sig_est_[cached_sig_key_];
    uint32_t p = ((uint32_t(e.pos) << kProbBits) + alpha * (prior & 0x7fff)) /
                 (uint32_t(e.pos) + e.neg + alpha);
    return clamp15(int32_t(p));
  }
  void sig_update(int pos, int bit) {
    (void)pos;
    note_coded(kKindSig, cached_sig_key_, bit);
  }

  // ---- mirrored CABAC contexts ------------------------------------------
  // A replay of the original stream's CABAC adaptive state (spec 9.3.3.1
  // state machine), re-initialized per slice and advanced on every
  // context-coded bin. Gives any estimator access to "what CABAC would have
  // predicted here" as a prior; currently used to code EOB bins at exact
  // CABAC parity where the learned estimator loses (sig_mode() == 2).
  static const uint16_t* state_prob_q15() {
    // p1-if-MPS==1 per state: pLPS(s) = 0.5 * alpha^s, alpha = 0.0375^(1/63).
    static const auto table = [] {
      static uint16_t t[64];
      double plps = 0.5;
      for (int s = 0; s < 64; ++s) {
        int v = int(plps * kProbScale + 0.5);
        t[s] = uint16_t(v < 1 ? 1 : (v > int(kProbScale) - 1 ? kProbScale - 1 : v));
        plps *= 0.9491255522855953;
      }
      return t;
    }();
    return table;
  }
  void mirror_update(int ctx, int bit) {
    uint8_t& s = mirror_.p_state[ctx];
    uint8_t& m = mirror_.val_mps[ctx];
    if (bit == m) {
      s = kTransIdxMPS[s];
    } else {
      if (s == 0) m ^= 1;
      s = kTransIdxLPS[s];
    }
  }
  uint32_t mirror_prob(int ctx) const {
    // state_prob_ caches state_prob_q15() (the function-local static's
    // thread-safe init guard costs an atomic load per call — ~30M/pass).
    uint32_t plps = state_prob_[mirror_.p_state[ctx]];
    return mirror_.val_mps[ctx] ? kProbScale - plps : plps;
  }
  uint32_t eob_parity_prob(int ctx) const { return mirror_prob(ctx); }

  // Off-mode EOB (last_significant_coeff_flag) estimator. (Adding the
  // observed count or a stronger mirror alpha to these keys was swept and
  // LOST — the tri-modal probe's parity fallback already covers the cells
  // an adaptive EOB would lose.)
  size_t eob_key(int pos) const {
    size_t key = (size_t(cat_) * kSigPosClasses + sig_pos_class(pos)) * 2 + sig_is_dc();
    return hash_sig(kEobOffBase + size_t(sc_) * kEobOffStride + key);
  }
  uint32_t eob_prob(int ctx, int pos) {
    cached_sig_key_ = uint32_t(eob_key(pos));
    cached_prior_ = uint16_t(mirror_prob(ctx));
    return prob_for(kKindSig, cached_sig_key_, cached_prior_);
  }
  void eob_update(int pos, int bit) {
    (void)pos;
    note_coded(kKindSig, cached_sig_key_, bit);
  }

  // Res priors carry kPriorOffTag: selects the Dirichlet count-weighted mix
  // in prob_for (and in the device pass, which sees the tag in the trace).
  uint16_t res_prior(int ctx) const {
    return uint16_t(mirror_prob(ctx)) | kPriorOffTag;
  }
  uint32_t res_prob(int ctx, int pos) {
    cached_dual_key_ = uint32_t(res_key(ctx, pos));
    cached_prior_ = res_prior(ctx);
    return prob_for(kKindDual, cached_dual_key_, cached_prior_);
  }
  void res_update(int ctx, int pos, int bit) {
    (void)ctx;
    (void)pos;
    note_coded(kKindDual, cached_dual_key_, bit);
  }

  // Spatial/temporal conditioning classes for the nonzero count (the
  // reference's per-bit neighbor flags, recode.cpp:865-884, upgraded to
  // bucketed count predictions).
  int nz_pred_class() const {
    int sum = neighbor_count(-1, 0) + neighbor_count(0, -1);
    if (sum >= 16) return 7;
    if (sum >= 9) return 6;
    if (sum >= 6) return 5;
    if (sum >= 4) return 4;
    return sum;  // 0..3
  }
  int nz_prev_class() const {
    int prev = frames_[cur_ ^ 1].get(mb_x_, mb_y_, slot_);
    return prev >= 4 ? 3 : (prev >= 2 ? 2 : prev);
  }
  // Raw neighbor/temporal counts for the current block (refmodel.h inputs;
  // -1 = neighbor outside the picture).
  int nz_left_i() const { return neighbor_count_i(-1, 0); }
  int nz_above_i() const { return neighbor_count_i(0, -1); }
  int nz_prev_raw() const { return frames_[cur_ ^ 1].get(mb_x_, mb_y_, slot_); }
  bool chroma422() const { return chroma422_; }
  size_t nz_unary_key(int idx) const {
    size_t key = ((size_t(idx) * 8 + nz_pred_class()) * 4 + nz_prev_class()) * 6 + cat_;
    return kNzBase + size_t(sc_) * kNzStride + key;
  }
  size_t nz_suffix_key(int bit_i) const {
    return kNzBase + size_t(sc_) * kNzStride + kNzUnaryKeys + size_t(bit_i) * 6 + cat_;
  }

  // Shared NZ-count serialization (the reference's finished_queueing,
  // recode.cpp:844-930, re-binarized): (nnz-1) as truncated unary up to 8
  // with per-index neighbor-conditioned contexts, then an LSB-first
  // fixed-width suffix. BitIO: int operator()(Dual&, int bit_for_put).
  // BitIO: int operator()(uint32_t dual_key, int bit_for_put) — codes one bin
  // with the Dual estimator at dual_key; the model queues the update here.
  template <class BitIO>
  int code_nz(BitIO&& io, int put_value /*-1 when decoding*/) {
    int enc = put_value >= 0 ? put_value - 1 : -1;
    int cap = max_coeff_ - 1 < 8 ? max_coeff_ - 1 : 8;
    int val = 0;
    while (val < cap) {
      uint32_t key = uint32_t(nz_unary_key(val));
      int b = io(key, enc >= 0 ? (enc > val ? 1 : 0) : -1);
      note_coded(kKindDual, key, b);
      if (!b) break;
      ++val;
    }
    if (val == cap && cap == 8) {
      // suffix: (nnz-1-8) in ceil(log2(max_coeff-8)) bits, LSB first
      int span = max_coeff_ - 8;  // 8 or 56
      int sbits = span > 32 ? 6 : (span > 16 ? 5 : (span > 8 ? 4 : 3));
      int suffix = 0;
      for (int i = 0; i < sbits; ++i) {
        uint32_t key = uint32_t(nz_suffix_key(i));
        int b = io(key, enc >= 0 ? ((enc - 8) >> i) & 1 : -1);
        note_coded(kKindDual, key, b);
        suffix |= b << i;
      }
      val += suffix;
    }
    return val + 1;
  }

  // Deterministic EOB answer (zero bits).
  int eob_answer() const {
    assert(nnz_total_ >= 1);
    return observed_ == nnz_total_ ? 1 : 0;
  }

  // State transitions shared by encode/decode.
  void on_sig_bin(int bit) {
    sig_hist_ = ((sig_hist_ << 1) | bit) & 7;
    if (bit) ++observed_;
  }
  void set_nnz_total(int n) {
    nnz_total_ = n;
    in_sig_ = true;
  }
  bool needs_nnz() const { return in_sig_ == false; }
  int nnz_total() const { return nnz_total_; }

  // Estimator windows. The reference uses 0x50 for its sig maps
  // (recode.cpp:1041-1042); with the strong mirrored-CABAC prior in the mix
  // a longer window measured better (swept 56..288 on dense + sparse +
  // camera: 128 — bench flat, sparse/camera -0.02pp; 288 degrades dense).
  static constexpr int kWindowSig = 128;
  static constexpr int kWindowOther = 0x60;

  // ---- CAVLC value transport (capability extension: the reference passes
  // CAVLC through uncompressed, recode.cpp:1289-1296). Values are binarized
  // as truncated-unary + adaptive Elias-gamma (or fixed-width for raw-bit
  // roles), each bin an adaptive Dual estimator. BitIO as in code_nz.
  size_t cavlc_key(uint8_t role, uint8_t aux, int node) const {
    return kCavlcBase +
           (size_t(role) * kCavlcAux + (aux & (kCavlcAux - 1))) * kCavlcNodes +
           (node < kCavlcNodes ? node : kCavlcNodes - 1);
  }
  // Fixed-width bit count for raw-bit roles (aux packing per cavlc_stream.h).
  static int cavlc_fixed_bits(uint8_t role, uint8_t aux) {
    switch (role) {
      case 2: case 3: case 12: return aux >> 4;      // IntraPredFlag/Rem, T1Sign (u-packed)
      case 5: case 20: return aux >> 4;              // RefIdx/Transform8x8 via u(1); 0 => ue
      case 14: return aux >> 3;                      // LevelSuffix
      default: return 0;
    }
  }
  static bool cavlc_signed(uint8_t role) { return role == 6 || role == 8; }  // Mvd, QpDelta

  template <class BitIO>
  int32_t code_cavlc(BitIO&& io, uint8_t role, uint8_t aux, int32_t put_value, bool put) {
    // CAVLC temporal keys (v27): cbp values keyed additionally on the
    // previous frame's any-residual bit at this MB. The recorded aux is
    // unchanged — the bit only enters the key derivation, identically on
    // both codec paths (the model tracks its own grid from total_coeff;
    // geometry from the recorded slice/mb events — see process_cavlc).
    // Measured: natural CAVLC qp26 -0.29pp, qp32 -0.23pp, B-CAVLC -0.04pp,
    // tiny synthetic clips neutral.
    if (role == 7 /*kRCbp*/) aux = uint8_t(aux | (prev_mb_resid() << 1));
    // mb_type values on the same temporal bit (qp26 -0.04pp, qp32 -0.04pp,
    // B-CAVLC -0.15pp, tiny synthetic clips neutral).
    if (role == 1 /*kRMbType*/) aux = uint8_t(aux | (prev_mb_resid() << 2));
    // (kRRefIdx on the same temporal bit measured noise-level — not taken.)
    int nb = cavlc_fixed_bits(role, aux);
    auto key_at = [&](int node) { return uint32_t(cavlc_key(role, aux, node)); };
    if (nb > 0) {
      // v28: short fixed-bit values keyed on the binary-tree node (bit index
      // + decoded prefix) instead of the bit position alone — the CAVLC
      // analogue of the v20 CABAC rem_intra_pred_mode tree keys (learns the
      // full value distribution, e.g. the 8 rem modes' skew). Node =
      // (2^i - 1) + prefix <= 6 for nb <= 3; wider roles (LevelSuffix) stay
      // positional. Measured: natural CAVLC qp26/qp32 -0.033/-0.039pp,
      // synthetic qp14 -0.122pp, B-CAVLC -0.093pp — wins on every clip.
      uint32_t v = 0;
      for (int i = 0; i < nb; ++i) {
        int node = (nb <= 3) ? ((1 << i) - 1) + int(v) : i;
        uint32_t key = key_at(node);
        int b = io(key, put ? int((uint32_t(put_value) >> (nb - 1 - i)) & 1) : -1);
        note_coded(kKindDual, key, b);
        v = (v << 1) | uint32_t(b);
      }
      return int32_t(v);
    }
    uint32_t uv = 0;
    if (put) {
      if (cavlc_signed(role)) {
        int64_t x = put_value;
        uv = x <= 0 ? uint32_t(-2 * x) : uint32_t(2 * x - 1);
      } else {
        uv = uint32_t(put_value);
      }
    }
    // Truncated unary to 8, then adaptive Elias-gamma for the tail.
    uint32_t val = 0;
    while (val < 8) {
      uint32_t key = key_at(int(val));
      int b = io(key, put ? (uv > val ? 1 : 0) : -1);
      note_coded(kKindDual, key, b);
      if (!b) break;
      ++val;
    }
    if (val == 8) {
      uint32_t m = put ? (uv - 8) + 1 : 1;
      int k = 0;
      if (put) {
        while ((m >> (k + 1)) != 0) ++k;
      }
      if (put) {
        for (int i = 0; i < k; ++i) {
          uint32_t key = key_at(8 + (i < 7 ? i : 7));
          io(key, 1);
          note_coded(kKindDual, key, 1);
        }
        uint32_t key = key_at(8 + (k < 7 ? k : 7));
        io(key, 0);
        note_coded(kKindDual, key, 0);
      } else {
        k = 0;
        while (true) {
          uint32_t key = key_at(8 + (k < 7 ? k : 7));
          int b = io(key, -1);
          note_coded(kKindDual, key, b);
          if (!b) break;
          if (++k > 30) throw std::runtime_error("cavlc gamma overflow");
        }
      }
      for (int i = k - 1; i >= 0; --i) {
        uint32_t key = key_at(16 + (i < 3 ? i : 3));
        int b = io(key, put ? int((m >> i) & 1) : -1);
        note_coded(kKindDual, key, b);
        if (!put) m = (m << 1) | uint32_t(b);
      }
      if (!put) uv = 8 + m - 1;  // uv is only read on get below
    }
    if (put) {
      if (role == 10 /*kRTotalCoeff*/ && put_value > 0) note_cavlc_resid();
      return put_value;
    }
    uint32_t out = (val < 8) ? val : uv;
    if (role == 10 /*kRTotalCoeff*/ && out > 0) note_cavlc_resid();
    if (cavlc_signed(role)) {
      int32_t v = int32_t((out + 1) >> 1);
      return (out & 1) ? v : -v;
    }
    return int32_t(out);
  }

  Billing bill;
  // Per-(slice_class, cat) accumulated cost of the significance complex
  // (sig + eob + nz bits) in millibits — drives the empirical mode choice.
  uint64_t sigc_mbits[3][6] = {};
  // EOB-only costs measured during the adaptive-EOB probe pass: what the
  // learned estimator paid vs what CABAC-parity coding would have paid.
  uint64_t eobc_adapt_mbits[3][6] = {};
  uint64_t eobc_parity_mbits[3][6] = {};
  // Per-candidate off-mode sig cost (probe pass only): drives the empirical
  // per-file alpha_off choice (kSigAlphaCands).
  uint64_t sigc_alpha_mbits[4][3][6] = {};
  int slice_class() const { return sc_; }
  int cur_cat() const { return cat_; }

  const std::vector<Dual>& dual_table() const { return dual_; }
  const std::vector<Estimator>& sig_table() const { return sig_est_; }

  // Warm-started chunks (container v16): chunk 0 publishes a copy of its
  // learned tables after its first `warm_slices` slices; later chunks start
  // from that snapshot instead of the cold CABAC-init seed, recovering most
  // of the sectioning ratio cost while chunks still encode/decode in
  // parallel (only chunk 0's prefix serializes). The snapshot is taken
  // between slices with no flush: pending batch updates of chunk 0 are NOT
  // transferred (deterministic on both codec sides; keeps the device pass's
  // uniform batch grid intact).
  struct TableSnapshot {
    std::vector<Dual> dual;
    std::vector<Estimator> sig;
  };
  void snapshot_tables(TableSnapshot& s) const {
    s.dual = dual_;
    s.sig = sig_est_;
    // v22: normalize the snapshot — the capture happens mid-batch (immediate
    // increments, no flush), so counts can sit over their windows; halving
    // them here (deterministic, both codec sides) restores the invariant
    // that every estimator starts a chunk within its window. That invariant
    // is what lets (a) the host detect flush halvings at window-crossing
    // time and (b) the device pass halve via a masked elementwise op per
    // sub-batch without tracking which keys were touched.
    for (Dual& d : s.dual) {
      while (uint32_t(d.fp) + d.fn > kFastWindow) {
        d.fp = (d.fp + 1) >> 1;
        d.fn = (d.fn + 1) >> 1;
      }
      while (uint32_t(d.sp) + d.sn > kSlowWindow) {
        d.sp = (d.sp + 1) >> 1;
        d.sn = (d.sn + 1) >> 1;
      }
    }
    for (Estimator& e : s.sig) {
      while (uint32_t(e.pos) + e.neg > kWindowSig) {
        e.pos = (e.pos + 1) >> 1;
        e.neg = (e.neg + 1) >> 1;
      }
    }
  }
  void restore_tables(const TableSnapshot& s) {
    dual_ = s.dual;
    sig_est_ = s.sig;
    seeded_ = true;  // the snapshot already carries the CABAC-init seed
  }

 private:
  struct NZFrame {
    int w = 0, h = 0;
    std::vector<uint8_t> cnt;
    void reset(int w_, int h_) {
      w = w_;
      h = h_;
      cnt.assign(size_t(w) * h * kNumBlockSlots, 0);
    }
    uint8_t get(int x, int y, int slot) const {
      if (x < 0 || y < 0 || x >= w || y >= h) return 0;
      return cnt[(size_t(y) * w + x) * kNumBlockSlots + slot];
    }
    // As get(), but distinguishes "outside the picture" (-1) from a zero
    // count (refmodel.h availability-aware neighbor priors).
    int get_i(int x, int y, int slot) const {
      if (x < 0 || y < 0 || x >= w || y >= h) return -1;
      return cnt[(size_t(y) * w + x) * kNumBlockSlots + slot];
    }
    void set(int x, int y, int slot, uint8_t v) {
      cnt[(size_t(y) * w + x) * kNumBlockSlots + slot] = v;
      // Cross-replicate so 4x4 and 8x8 slot lookups both work at transform
      // boundaries (our design; any deterministic rule is format-valid).
      if (slot >= kSlotLuma8x8 && slot < kSlotChromaDC) {
        int b8 = slot - kSlotLuma8x8;
        uint8_t q = uint8_t((v + 3) >> 2);
        for (int k = 0; k < 4; ++k) {
          int blk = 4 * b8 + k;
          cnt[(size_t(y) * w + x) * kNumBlockSlots + kSlotLuma4x4 + blk] = q;
        }
      } else if (slot >= kSlotLuma4x4 && slot < kSlotLuma8x8) {
        int blk = slot - kSlotLuma4x4;
        int b8 = blk >> 2;
        size_t base = (size_t(y) * w + x) * kNumBlockSlots;
        int sum = 0;
        for (int k = 0; k < 4; ++k) sum += cnt[base + kSlotLuma4x4 + 4 * b8 + k];
        cnt[base + kSlotLuma8x8 + b8] = uint8_t(sum > 63 ? 63 : sum);
      }
    }
  };

  // Left/above neighbor nonzero-count for the current block's slot (spatial
  // prior; reference recode.cpp:865-872 uses the scan8 grid equivalently).
  // The _i variant returns -1 when the neighbor is outside the picture
  // (refmodel.h needs the availability distinction); neighbor_count clamps
  // that to 0 — bit-identical to its pre-refmodel behavior.
  int neighbor_count_i(int dx, int dy) const {
    const NZFrame& f = frames_[cur_];
    if (slot_ >= kSlotLuma4x4 && slot_ < kSlotLuma8x8) {
      int blk = slot_ - kSlotLuma4x4;
      int gx = kBlk4x4X[blk] + dx, gy = kBlk4x4Y[blk] + dy;
      int mx = mb_x_, my = mb_y_;
      if (gx < 0) { gx = 3; --mx; }
      if (gy < 0) { gy = 3; --my; }
      return f.get_i(mx, my, kSlotLuma4x4 + kBlk4x4Idx[gx + 4 * gy]);
    }
    if (slot_ >= kSlotLuma8x8 && slot_ < kSlotChromaDC) {
      int b8 = slot_ - kSlotLuma8x8;
      int gx = kBlk8x8X[b8] + dx, gy = kBlk8x8Y[b8] + dy;
      int mx = mb_x_, my = mb_y_;
      if (gx < 0) { gx = 1; --mx; }
      if (gy < 0) { gy = 1; --my; }
      return f.get_i(mx, my, kSlotLuma8x8 + gx + 2 * gy);
    }
    if (slot_ >= kSlotChromaAC) {
      int idx = slot_ - kSlotChromaAC;
      int c = idx >> 3, blk = idx & 7;
      int gh = chroma422_ ? 4 : 2;  // chroma AC grid height
      int gx = (blk & 1) + dx, gy = (blk >> 1) + dy;
      int mx = mb_x_, my = mb_y_;
      if (gx < 0) { gx = 1; --mx; }
      if (gy < 0) { gy = gh - 1; --my; }
      return f.get_i(mx, my, kSlotChromaAC + 8 * c + gx + 2 * gy);
    }
    // DC slots: same slot of the adjacent MB.
    return f.get_i(mb_x_ + dx, mb_y_ + dy, slot_);
  }
  uint8_t neighbor_count(int dx, int dy) const {
    int v = neighbor_count_i(dx, dy);
    return uint8_t(v < 0 ? 0 : v);
  }

  std::vector<Dual> dual_;
  std::vector<Estimator> sig_est_;
  // prob->update key reuse (see sig_prob NOTE).
  uint32_t cached_sig_key_ = 0, cached_dual_key_ = 0;
  uint16_t cached_prior_ = 0;  // prior of the last *_prob call (trace reuse)
  int16_t cached_aux_ = -1;    // aux of the last bin_prob call (cbp tracking)
  const uint16_t* state_prob_;  // cached state_prob_q15() (see mirror_prob)
  int sig_hist_ = 0;  // last 3 significance bins (off-mode sig key Markov)
  std::vector<Coded> pending_;
  const std::vector<Coded>* replay_ = nullptr;  // see set_flush_replay
  uint32_t batch_ = 1;
  uint32_t fill_ = 0;  // stream positions seen since the last flush
  uint64_t nz_modes_ = kAllNzOn;  // default: NZ-first everywhere
  uint32_t alpha_off_ = kSigMixAlphaOff;
  int profile_ = 0;
  std::vector<uint8_t> skip_grid_[2];
  std::vector<uint8_t> cbp_grid_[2];  // v27 cbp keys (see note_cbp_bit)
  bool seeded_ = false;
  bool chroma422_ = false;
  CabacContexts mirror_{};
  int mirror_idc_ = 0, mirror_qp_ = 26;
  NZFrame frames_[2];
  int cur_ = 0;
  int mb_x_ = 0, mb_y_ = 0;
  int sc_ = 0;
  int slot_ = 0, cat_ = 0, max_coeff_ = 0;
  int nnz_total_ = -1, observed_ = 0;
  bool in_sig_ = false;
};

}  // namespace artc
