// End-to-end recompression pipelines and the ARTC container format.
//
// Reference parity: compressor/decompressor pipelines (reference
// recode.cpp:1102-1591) and the Recoded protobuf container (recode.proto,
// SURVEY.md Appendix B), re-architected:
//  - explicit file segmentation (literals + slice records) instead of
//    memmem-located coded blocks (reference recode.cpp:1275-1297),
//  - no surrogate streams: our own syntax walker replays the slice during
//    decompression (reference needed dummy payloads, recode.cpp:1526-1544),
//  - chunked model state + K-lane rANS payloads so chunks decode
//    independently (GOP/shard parallelism; reference is strictly serial),
//  - universal tail patches instead of the 0x80-trim / parity / last-byte
//    quirk handling (reference recode.cpp:1345-1356, 1501-1508).
#pragma once

#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "bitstream.h"
#include "cabac.h"
#include "h264_params.h"
#include "h264_slice.h"
#include "avi.h"
#include "flv.h"
#include "model.h"
#include "mkv.h"
#include "mp4.h"
#include "nal.h"
#include "ps.h"
#include "ts.h"
#include "rans.h"
#include "cavlc_stream.h"
#include "refmodel.h"
#include "symbol_stream.h"

namespace artc {

// ATRC container format version: bumped on any change to the container layout
// or to model semantics that alter the coded streams. decompress() rejects
// other versions; corpus --resume checks it before skipping a file.
// v13: verbatim side bytes (literals, slice headers, paramsets, tail patches)
// travel through the adaptive order-1 byte coder (bytemodel.h) with a store
// fallback, instead of raw.
// v14: mvd bins keyed on a fine 8-bucket |mvd| neighbor-sum (walker aux
// side-channel) in addition to prev-skip; CABAC's own inc only 3-buckets the
// first bin.
// v15: residual-level bins switch to a Dirichlet count-weighted mix with the
// mirrored-CABAC prior (kResDirAlpha/kResDirFastBoost, prior bit-15 tagged
// in the trace); sig estimator window 80 -> 128; ref_idx bins prev-skip
// conditioned (kMbExtraStride 40 -> 46).
// v16: warm-started chunks — chunks 1+ start from a snapshot of chunk 0's
// tables taken after its first warm_slices slices (new container field after
// nz_modes; 0 = cold). Recovers most of the sectioning cold-start cost while
// chunks still code in parallel.
// v17: MPEG-TS transport — the pipeline codes the reassembled H.264
// elementary stream; a header run map + skeleton side bytes reproduce the
// original packetization byte-exactly (new transport field after
// model_profile).
// v18: empirical per-file off-mode sig prior weight (kSigAlphaCands, priced
// by the nz-mode probe; new header field after warm_slices) — dense grain
// picks a heavy mirrored-CABAC prior, structured content a light one.
// v20: rem_intra_pred_mode bins keyed on the binary-tree node (walker aux;
// the spec codes all 3 FL bins under one context) — learns the full
// 8-value rem distribution. (v19 was the reverted CAVLC temporal bank.)
// v21: Exp-Golomb suffix exponent bins (mvd UEG3 / level UEG0) keyed on the
// exponent index — CABAC prices bypass bins at exactly 1 bit while the
// continuation probability decays geometrically.
// v22: window-crossing flush semantics — warm-chunk table snapshots are
// normalized (halve-while-over) at capture and the damped bypass/sign fast
// seed moves in-window, so every estimator starts each batch within its
// window (also what the device pass's elementwise halving assumes).
// v23/v24: mvd sign bins keyed on (component, sign of the neighbor mvd sum,
// |mvd| neighbor strength) via kKlassMvdSign — CABAC codes the sign as a raw
// bypass bin, but motion fields are smooth.
// v25: CAVLC mvd values keyed on the neighbors' MB-level signed mvd sums
// (zero-motion shares the unconditioned key) — the CAVLC analogue of
// v14/v23; the reference stores CAVLC raw.
// v26: build provenance in the header (u8 len + build-id bytes after the
// version byte; populated from the git revision at build-configure time) —
// parity with the reference's recode.proto:2-7 Metadata fields, which it
// defines but never populates; version-skew rejections now name both
// versions and the writing build. (Per-partition CAVLC mvd keys were
// measured here and REJECTED: both adjacent-block and edge-sum variants
// lose 0.02-0.10pp vs the v25 MB-level sum on natural and synthetic CAVLC —
// partition-local classes dilute the estimators; see RESULTS.md.)
// v27: CABAC coded_block_pattern bins keyed on the previous frame's cbp at
// the same MB (luma per-8x8 bit via the bin's aux, chroma class) on top of
// the spec's spatial ctxIdxInc — static regions make cbp temporally
// persistent, which CABAC cannot see. Measured (100-frame 640x480 natural
// clips + bench corpus): sparse qp30 -0.214pp, camera crf26 -0.129pp,
// dense bench.mp4 -0.018pp, 720p natural -0.016pp — wins everywhere.
// Also in v27: B mb_type bins split on the previous frame's any-residual
// bit (same grid): sparse -0.050pp, camera -0.021pp, screen -0.030pp on
// top of the cbp keys. And the CAVLC analogue: cbp VALUES keyed on the
// prev-frame any-residual bit (model-side grids driven by the recorded
// slice/mb events — the parallel walkers cannot see cross-picture state):
// natural CAVLC qp26 -0.29pp, qp32 -0.23pp, B-CAVLC -0.04pp.
// v28: short fixed-bit CAVLC values (rem_intra4x4_pred_mode, T1 signs,
// 1-bit flags) keyed on the binary-tree node (bit index + decoded prefix)
// instead of the bit position — the CAVLC analogue of v20's CABAC rem tree
// keys. Measured: natural qp26/qp32 -0.033/-0.039pp, synthetic qp14
// -0.122pp, B-CAVLC -0.093pp — wins on every clip. (Rejected the same
// session, measured noise-or-loss: a 4-class prev-frame MB key for B
// mb_type, and a heavier mirror weight on the mb_type/cbp/skip key
// families — the post-v27 residual ctx losses are mixing-optimal already.)
constexpr uint8_t kContainerVersion = 28;

// Build id injected by CMake (git revision at configure time; build_native
// re-runs configure on every source-triggered rebuild so it tracks HEAD).
#ifndef ARTC_BUILD_ID
#define ARTC_BUILD_ID "unknown"
#endif

struct Options {
  int lanes = 16;
  // 0 = sectioned whole-file chunking (max compression; large files split
  //     into a few independently-modeled sections at picture boundaries so
  //     the model pass and decode parallelize — ~8M bins each, machine-
  //     independent policy, measured ratio cost +0.089pp on bench.mp4);
  // 1 = new chunk at each IDR picture (GOP-parallel decode/encode).
  int chunk_mode = 0;
  // chunk_mode 0 section target (bins); 0 = default 8M. Sections share one
  // nz-mode probe (they are statistically homogeneous by construction).
  uint64_t section_bins = 0;
  // Estimator-update batch size: 1 = per-bin adaptation (reference-like,
  // serial); >1 = frozen-within-batch tables (the TPU formulation; measured
  // ratio cost <0.3% at 16k). Stored in the container header.
  uint32_t batch_size = 1;
  // 0 = immediate within-batch increments (host path); 2 = frozen-batch (the
  // slim device wire). Stored in the container header.
  int model_profile = 0;
  bool collect_streams = false;  // keep per-slice SymbolStreams (device path)
};

struct Stats {
  uint64_t input_bytes = 0;
  uint64_t output_bytes = 0;
  uint64_t cabac_in_bytes = 0;    // original CABAC payload bytes recompressed
  uint64_t recoded_bytes = 0;     // rANS payload bytes produced
  uint64_t literal_bytes = 0;
  int n_slices = 0;
  int n_fallback = 0;  // slice NALs stored as literals (unsupported/CAVLC/...)
  int n_chunks = 0;
  uint64_t total_bins = 0;
  Billing bill;
};

// Env-gated per-spec-ctx billing (ARTC_BILL_CTX=1): diagnostic stderr dump of
// ours-vs-CABAC cost per context index, to locate modeling gaps. Thread-safe
// (sections run the model pass in parallel); zero cost when disabled.
struct CtxBillTab {
  static constexpr int N = 1100;
  std::atomic<uint64_t> ours[N]{}, cabac[N]{}, cnt[N]{};
  static bool enabled() {
    static const bool v = [] {
      const char* e = getenv("ARTC_BILL_CTX");
      return e && atoi(e);
    }();
    return v;
  }
  static CtxBillTab& get() {
    static CtxBillTab t;
    return t;
  }
  void add(int ctx, uint64_t ours_mb, uint64_t cabac_mb) {
    if (ctx < 0 || ctx >= N) return;
    ours[ctx].fetch_add(ours_mb, std::memory_order_relaxed);
    cabac[ctx].fetch_add(cabac_mb, std::memory_order_relaxed);
    cnt[ctx].fetch_add(1, std::memory_order_relaxed);
  }
  void dump(FILE* f) const {
    fprintf(f, "ctx      count     ours(B)   cabac(B)     win(B)\n");
    for (int i = 0; i < N; ++i) {
      if (!cnt[i].load()) continue;
      int64_t w = int64_t(cabac[i].load()) - int64_t(ours[i].load());
      fprintf(f, "%4d %9llu %11.1f %10.1f %+10.1f\n", i,
              (unsigned long long)cnt[i].load(), ours[i].load() / 8000.0,
              cabac[i].load() / 8000.0, w / 8000.0);
    }
  }
};

// ---------------------------------------------------------------------------
// Model encode pass: replays recorded SymbolStreams through the prior model,
// producing the flat (bit, prob) pair stream for the rANS lanes. The reference
// does this inline in its hooks with symbol queueing (recode.cpp:1160-1254);
// here it is a separate pass so the TPU path can batch it.
class ModelEncoder {
 public:
  ModelEncoder(PriorModel& m, std::vector<uint8_t>& bits, std::vector<uint16_t>& probs)
      : m_(m), bits_(bits), probs_(probs) {}

  // Optional per-pair trace of (kind, key, prior) — the device-path input.
  void set_trace(std::vector<PriorModel::Coded>* t) { trace_ = t; }
  // Billing-only mode (nz-mode probes): skip storing the (bit, prob) pairs.
  void set_discard_output(bool d) { discard_ = d; }
  // Probe fast path: model only the significance complex (sig/eob/nz bins +
  // events). Everything the nz-mode probes read — sigc_mbits, eobc_*,
  // sigc_alpha_mbits — is BIT-IDENTICAL to a full pass because no sig-complex
  // state depends on non-sig bins: sig/eob keys read cat/pos/observed/
  // nnz_total/sig_hist/slice class (events + sig bins only), their mirrored-
  // CABAC priors read ctx indices only sig/eob bins themselves update (spec
  // ctxIdx spaces are disjoint), and skipped bins advance the batch position
  // via note_passthrough so flush epochs land on the same stream offsets.
  // Skipped-bin estimator tables (res/mvd/mb) drift, but probes never read
  // them. Cuts ~60% of the probe's per-bin work (it was two extra full model
  // passes per file).
  void set_sig_only(bool s) { sig_only_ = s; }
  // Reference-model head-to-head side-car (refmodel.h, ARTC_REFMODEL=1):
  // prices every bin under the reference's model in parallel.
  void set_ref_model(RefModel* r) { ref_ = r; }
  // Diagnostic per-CAVLC-role cost accounting (ARTC_BILL_CAVLC): caller
  // provides a uint64[32] mbit accumulator.
  void set_role_bill(uint64_t* t) { role_bill_ = t; }
  // Trace-only walk (device path, probs not exported): record (kind, key,
  // prior) + advance model state, but skip the probability math and the
  // bits_/probs_ stores — the device computes every probability itself, so
  // prob_for's 2-3 divisions per bin are pure waste on the e2e critical
  // path. Billing stays zero (the analyze path discards its Stats).
  void set_trace_only(bool t) { trace_only_ = t; }

  void process(const SymbolStream& ss) {
    size_t ev = 0;
    const size_t n_ev = ss.events.size();
    bits_.reserve(bits_.size() + ss.bins.size() + ss.bins.size() / 8);
    probs_.reserve(probs_.size() + ss.bins.size() + ss.bins.size() / 8);
    const bool billtab = CtxBillTab::enabled();
    // Hoisted next-event position: one compare per bin instead of two loads
    // through the events vector.
    size_t next_ev_at = ev < n_ev ? ss.events[ev].at : SIZE_MAX;
    for (size_t i = 0; i <= ss.bins.size(); ++i) {
      while (i == next_ev_at) {
        apply(ss, ss.events[ev], ev);
        ++ev;
        next_ev_at = ev < n_ev ? ss.events[ev].at : SIZE_MAX;
      }
      if (i == ss.bins.size()) break;
      const SymbolStream::Bin& b = ss.bins[i];
      if (sig_only_ && b.klass != kKlassSig && b.klass != kKlassEob) {
        m_.note_passthrough();  // keep flush epochs stream-aligned
        continue;
      }
      // Reference side-car: every non-significance bin is one per-context
      // estimator keyed on ctx identity (bypass/terminate collapse onto
      // kCtxBypass/kCtxTerminate — the reference's shared estimators).
      // Sig bins are keyed in the kKlassSig case; EOB bins cost it zero.
      if (ref_ && b.klass != kKlassSig && b.klass != kKlassEob)
        ref_->bin(b.ctx, b.bin);
      switch (b.klass) {
        case kKlassSig: {
          if (m_.nz_on()) ensure_nnz();
          else if (m_.needs_nnz()) m_.mark_in_sig();
          if (ref_) {
            ref_->ensure_nz();
            ref_->sig(b.pos, b.bin);
          }
          uint32_t sp = 0;
          if (trace_only_) {
            m_.sig_key_prior(b.ctx, b.pos);
          } else {
            m_.bill.cabac_mbits[b.klass] += b.cabac_mbits;
            sp = m_.sig_prob(b.ctx, b.pos);
          }
          // Trace from the cached (key, prior) the prob call derived — the
          // second derivation per bin was the device-walk hot spot.
          if (trace_)
            trace_->push_back({b.bin, PriorModel::kKindSig, m_.cached_sig_key(),
                               m_.cached_prior()});
          push(b.bin, sp, b.klass);
          if (discard_) {
            // Probe pass: also price the off-mode sig bin under every
            // candidate alpha (drives the per-file alpha_off choice).
            uint16_t pr = m_.cached_prior();
            if (pr & PriorModel::kPriorOffTag)
              for (int c = 0; c < 4; ++c)
                m_.sigc_alpha_mbits[c][m_.slice_class()][m_.cur_cat()] += cost_mb(
                    b.bin, m_.sig_prob_alpha_probe(pr, PriorModel::kSigAlphaCands[c]));
          }
          m_.sig_update(b.pos, b.bin);
          m_.on_sig_bin(b.bin);
          break;
        }
        case kKlassEob: {
          if (m_.nz_on()) {
            int det = m_.eob_answer();
            if (det != b.bin) throw std::runtime_error("model/walker EOB disagreement");
            ++m_.bill.eob_count;  // zero bits
            m_.bill.eob_cabac_mbits += b.cabac_mbits;
          } else if (m_.eob_parity()) {
            m_.bill.cabac_mbits[b.klass] += b.cabac_mbits;
            // The mirror probability IS the trace payload here (kKindPrior
            // passthrough), so it is computed even in trace-only mode.
            uint32_t pp = m_.eob_parity_prob(b.ctx);
            if (trace_)
              trace_->push_back({b.bin, PriorModel::kKindPrior, 0, uint16_t(pp)});
            push(b.bin, pp, kKlassEob);
            m_.note_passthrough();
          } else if (trace_only_) {
            m_.eob_key_prior(b.ctx, b.pos);
            if (trace_)
              trace_->push_back({b.bin, PriorModel::kKindSig, m_.cached_sig_key(),
                                 m_.cached_prior()});
            m_.eob_update(b.pos, b.bin);
          } else {
            m_.bill.cabac_mbits[b.klass] += b.cabac_mbits;
            uint32_t pa = m_.eob_prob(b.ctx, b.pos);
            if (discard_) {
              // Price both EOB codings during the probe's adaptive pass —
              // feeds the per-cell tri-mode choice in pick_nz_modes.
              m_.eobc_adapt_mbits[m_.slice_class()][m_.cur_cat()] += cost_mb(b.bin, pa);
              m_.eobc_parity_mbits[m_.slice_class()][m_.cur_cat()] +=
                  cost_mb(b.bin, m_.eob_parity_prob(b.ctx));
            }
            if (trace_)
              trace_->push_back({b.bin, PriorModel::kKindSig, m_.cached_sig_key(),
                                 m_.cached_prior()});
            push(b.bin, pa, kKlassEob);
            m_.eob_update(b.pos, b.bin);
          }
          break;
        }
        case kKlassRes: {
          if (b.ctx < kCtxBypass && b.pos >= 0) {
            uint32_t rp = 0;
            if (trace_only_) {
              m_.res_key_prior(b.ctx, b.pos);
            } else {
              m_.bill.cabac_mbits[b.klass] += b.cabac_mbits;
              rp = m_.res_prob(b.ctx, b.pos);
            }
            if (trace_)
              trace_->push_back({b.bin, PriorModel::kKindDual,
                                 m_.cached_dual_key(), m_.cached_prior()});
            push(b.bin, rp, b.klass);
            m_.res_update(b.ctx, b.pos, b.bin);
            break;
          }
          [[fallthrough]];
        }
        default: {
          uint32_t bp = 0;
          if (trace_only_) {
            m_.bin_key_prior(b.ctx, BinKlass(b.klass), b.pos);
          } else {
            m_.bill.cabac_mbits[b.klass] += b.cabac_mbits;
            bp = m_.bin_prob(b.ctx, BinKlass(b.klass), b.pos);
          }
          if (trace_)
            trace_->push_back({b.bin, m_.last_kind(BinKlass(b.klass)),
                               m_.cached_dual_key(), m_.cached_prior()});
          push(b.bin, bp, b.klass);
          m_.bin_update(b.ctx, BinKlass(b.klass), b.bin);
          break;
        }
      }
      if (billtab && !discard_ && b.ctx < kCtxBypass && last_p_)
        CtxBillTab::get().add(b.ctx, cost_mb(b.bin, last_p_), b.cabac_mbits);
      last_p_ = 0;
      // Advance the mirrored CABAC state for every context-coded bin (after
      // this bin's probabilities were computed from the pre-update state).
      if (b.ctx < kCtxBypass) m_.mirror_update(b.ctx, b.bin);
    }
  }

 private:
  void apply(const SymbolStream& ss, const SymbolStream::Event& e, size_t ev_idx) {
    (void)ev_idx;
    switch (e.type) {
      case kEvBeginSlice:
        m_.seed_from_cabac((e.d >> 16) & 0xffff, int16_t(e.d & 0xffff));
        m_.set_chroma422((e.a & 16) != 0);
        m_.begin_slice((e.a >> 2) & 3, (e.a & 2) != 0, e.b, e.c);
        break;
      case kEvBeginMB: m_.begin_mb(e.a, e.b); break;
      case kEvBeginBlock:
        cur_block_nnz_ = e.d;  // recorder-annotated nonzero count
        m_.begin_block(e.a, e.b, e.c);
        if (ref_)
          ref_->begin_block(e.b, e.c, e.d, m_.nz_left_i(), m_.nz_above_i(),
                            m_.nz_prev_raw(), m_.chroma422());
        break;
      case kEvEndBlock: m_.end_block(); break;
      case kEvImplicitLast:
        if (m_.nz_on()) ensure_nnz();
        if (ref_) ref_->ensure_nz();
        m_.note_implicit_last();
        break;
      case kEvPcm: {
        // I_PCM: pad bits (x264 stuffs a pseudo-random one) then raw sample
        // bytes, all transported at fixed p=1/2 (1 bit/bin) so host and device
        // paths need no model state. The decompressor re-derives the pad bit
        // count from its encoder's byte alignment.
        auto half = [&](int bit) {
          if (trace_)
            trace_->push_back({uint8_t(bit), PriorModel::kKindPrior, 0,
                               uint16_t(kProbScale / 2)});
          if (ref_) ref_->raw_bit();  // reference copies PCM outside its model
          push(bit, kProbScale / 2, kKlassBypassOther);
          m_.note_passthrough();  // keep batch boundaries stream-aligned
        };
        for (int b = e.d - 1; b >= 0; --b) half((e.c >> b) & 1);
        const uint8_t* p = ss.pcm.data() + e.a;
        for (int32_t i = 0; i < e.b; ++i)
          for (int b = 7; b >= 0; --b) half((p[i] >> b) & 1);
        break;
      }
    }
  }

  void ensure_nnz() {
    if (!m_.needs_nnz()) return;
    // The block's total significant-coefficient count, annotated on its
    // BeginBlock event by the recorder (the stream-order inversion: NZ-count
    // bits precede the significance map, reference recode.cpp:1204-1254 /
    // SURVEY.md §3.4 — here the count is known up-front, no scan-ahead).
    int cnt = cur_block_nnz_;
    m_.code_nz(
        [this](uint32_t key, int putbit) {
          if (trace_)
            trace_->push_back({uint8_t(putbit), PriorModel::kKindDual, key, 0});
          if (!trace_only_)
            push_nz(putbit, m_.prob_for(PriorModel::kKindDual, key, 0));
          return putbit;
        },
        cnt);
    m_.set_nnz_total(cnt);
  }

  // Millibit cost via a 4096-entry lookup (billing only; ~0.1% accurate,
  // avoids a libm call per bin on the hot path). Namespace-scope table: a
  // function-local static would pay an atomic init-guard load on each of the
  // ~40M calls per pass.
  struct CostTab {
    std::array<uint32_t, 4096> t{};
    CostTab() {
      for (int i = 0; i < 4096; ++i) {
        double pp = (i * 8 + 4) / double(kProbScale);
        t[i] = uint32_t(-1000.0 * std::log2(pp));
      }
    }
  };
  static inline const CostTab cost_tab_{};
  static uint64_t cost_mb(int bit, uint32_t p) {
    uint32_t pp = bit ? p : kProbScale - p;
    return cost_tab_.t[pp >> 3];
  }
  void push(int bit, uint32_t p, uint8_t klass) {
    if (trace_only_) return;  // device path: no (bit, prob) stream, no billing
    if (!discard_) {
      bits_.push_back(uint8_t(bit));
      probs_.push_back(uint16_t(p));
    }
    last_p_ = p;
    uint64_t mb = cost_mb(bit, p);
    m_.bill.mbits[klass] += mb;
    ++m_.bill.count[klass];
    // Per-(slice_class, cat) sig pricing: consumed only by pick_nz_modes'
    // probe passes (discard_), dead weight on the production pass.
    if (discard_ && (klass == kKlassSig || klass == kKlassEob))
      m_.sigc_mbits[m_.slice_class()][m_.cur_cat()] += mb;
  }
  void push_nz(int bit, uint32_t p) {
    if (!discard_) {
      bits_.push_back(uint8_t(bit));
      probs_.push_back(uint16_t(p));
    }
    uint64_t mb = cost_mb(bit, p);
    m_.bill.nz_mbits += mb;
    ++m_.bill.nz_count;
    if (discard_) m_.sigc_mbits[m_.slice_class()][m_.cur_cat()] += mb;
  }

  PriorModel& m_;
  std::vector<uint8_t>& bits_;
  std::vector<uint16_t>& probs_;
  std::vector<PriorModel::Coded>* trace_ = nullptr;
  RefModel* ref_ = nullptr;  // reference head-to-head side-car (off = null)
  int cur_block_nnz_ = 0;
  bool discard_ = false;
  bool sig_only_ = false;
  bool trace_only_ = false;
  uint8_t cur_role_ = 0;             // role of the CAVLC value being coded
  uint64_t* role_bill_ = nullptr;    // ARTC_BILL_CAVLC per-role mbits
  uint32_t last_p_ = 0;  // last pushed prob (ARTC_BILL_CTX diagnostics)

 public:
  // CAVLC slices: transport every recorded syntax value through the adaptive
  // value model (capability extension; reference passes CAVLC through raw).
  void process_cavlc(const CavlcStream& cs) {
    // Per-MB temporal grids for the v27 CAVLC cbp keys: slice geometry +
    // begin_mb positions drive the same model grids the CABAC path uses;
    // the decode side makes the identical calls from its parsed headers and
    // walker (recode.cc decode_slice).
    m_.begin_slice(cs.slice_class, cs.new_picture, cs.mb_width, cs.mb_height);
    size_t ev = 0;
    const size_t n_ev = cs.mb_events.size();
    size_t next_ev_at = ev < n_ev ? cs.mb_events[ev].at : SIZE_MAX;
    for (size_t vi = 0; vi < cs.values.size(); ++vi) {
      while (vi == next_ev_at) {
        m_.begin_mb(cs.mb_events[ev].a, cs.mb_events[ev].b);
        ++ev;
        next_ev_at = ev < n_ev ? cs.mb_events[ev].at : SIZE_MAX;
      }
      const auto& v = cs.values[vi];
      if (v.role == kRPcmPad || v.role == kRPcmByte) {
        // I_PCM transport: fixed p=1/2 bins, no adaptive state (mirrors the
        // CABAC path's kEvPcm handling).
        int nb = v.role == kRPcmByte ? 8 : (v.aux & 7);
        for (int b = nb - 1; b >= 0; --b) {
          int bit = (v.value >> b) & 1;
          if (trace_)
            trace_->push_back({uint8_t(bit), PriorModel::kKindPrior, 0,
                               uint16_t(kProbScale / 2)});
          push(bit, kProbScale / 2, kKlassBypassOther);
          m_.note_passthrough();  // keep batch boundaries stream-aligned
        }
        continue;
      }
      cur_role_ = v.role;
      m_.code_cavlc(
          [this](uint32_t key, int putbit) {
            if (trace_) trace_->push_back({uint8_t(putbit), PriorModel::kKindDual, key, 0});
            if (!trace_only_) {
              uint32_t p = m_.prob_for(PriorModel::kKindDual, key, 0);
              push(putbit, p, kKlassOther);
              if (role_bill_) role_bill_[cur_role_ & 31] += cost_mb(putbit, p);
            }
            return putbit;
          },
          v.role, v.aux, v.value, /*put=*/true);
    }
  }
};

// Decompress-side CAVLC value source: decodes values from the model + rANS.
class CavlcModelSource {
 public:
  CavlcModelSource(PriorModel& m, RansInterleavedDecoder& rans, uint32_t n_values)
      : m_(m), rans_(rans), remaining_(n_values) {}
  bool more_data() const { return remaining_ > 0; }
  void begin_mb(int x, int y) { m_.begin_mb(x, y); }
  int32_t next(uint8_t role, uint8_t aux) {
    if (remaining_ == 0) throw std::runtime_error("cavlc value stream exhausted");
    --remaining_;
    if (role == kRPcmPad || role == kRPcmByte) {
      int nb = role == kRPcmByte ? 8 : (aux & 7);
      int32_t v = 0;
      for (int b = 0; b < nb; ++b) {
        v = (v << 1) | rans_.decode(kProbScale / 2);
        m_.note_passthrough();
      }
      return v;
    }
    return m_.code_cavlc(
        [this](uint32_t key, int) {
          return rans_.decode(m_.prob_for(PriorModel::kKindDual, key, 0));
        },
        role, aux, 0, /*put=*/false);
  }

 private:
  PriorModel& m_;
  RansInterleavedDecoder& rans_;
  uint32_t remaining_;
};

// ---------------------------------------------------------------------------
// Decompress-side walker IO: decodes bins from the rANS lanes via the model
// and simultaneously regenerates original CABAC (reference
// decompressor::cabac_decoder, recode.cpp:1411-1520).
class ModelSource {
 public:
  ModelSource(PriorModel& m, RansInterleavedDecoder& rans, bool intra_slice, int cabac_init_idc,
              int slice_qp)
      : m_(m), rans_(rans) {
    cab_ctxs_.init(intra_slice, cabac_init_idc, slice_qp);
  }

  int decision(int ctx, BinKlass klass, int aux = -1) {
    int bit = rans_.decode(m_.bin_prob(ctx, klass, aux));
    m_.bin_update(ctx, klass, bit);
    m_.mirror_update(ctx, bit);
    enc_.encode_decision(cab_ctxs_, ctx, bit);
    return bit;
  }
  int bypass(BinKlass klass, int aux = -1) {
    int bit = rans_.decode(m_.bin_prob(kCtxBypass, klass, aux));
    m_.bin_update(kCtxBypass, klass, bit);
    enc_.encode_bypass(bit);
    return bit;
  }
  int terminate(bool end_of_slice = true) {
    (void)end_of_slice;
    int bit = rans_.decode(m_.bin_prob(kCtxTerminate, kKlassTerminate));
    m_.bin_update(kCtxTerminate, kKlassTerminate, bit);
    enc_.encode_terminate(bit);
    return bit;
  }
  int sig_bin(int ctx, int pos) {
    if (m_.needs_nnz()) {
      if (m_.nz_on()) {
        int nnz = m_.code_nz(
            [this](uint32_t key, int) {
              return rans_.decode(m_.prob_for(PriorModel::kKindDual, key, 0));
            }, -1);
        m_.set_nnz_total(nnz);
      } else {
        m_.mark_in_sig();
      }
    }
    int bit = rans_.decode(m_.sig_prob(ctx, pos));
    m_.sig_update(pos, bit);
    m_.on_sig_bin(bit);
    m_.mirror_update(ctx, bit);
    enc_.encode_decision(cab_ctxs_, ctx, bit);
    return bit;
  }
  int eob_bin(int ctx, int pos) {
    int bit;
    if (m_.nz_on()) {
      bit = m_.eob_answer();  // zero recoded bits
    } else if (m_.eob_parity()) {
      bit = rans_.decode(m_.eob_parity_prob(ctx));
      m_.note_passthrough();
    } else {
      bit = rans_.decode(m_.eob_prob(ctx, pos));
      m_.eob_update(pos, bit);
    }
    m_.mirror_update(ctx, bit);
    enc_.encode_decision(cab_ctxs_, ctx, bit);
    return bit;
  }
  int res_bin(int ctx, int pos) {
    int bit = rans_.decode(m_.res_prob(ctx, pos));
    m_.res_update(ctx, pos, bit);
    m_.mirror_update(ctx, bit);
    enc_.encode_decision(cab_ctxs_, ctx, bit);
    return bit;
  }
  void implicit_sig_last(int pos) {
    (void)pos;
    m_.note_implicit_last();
  }
  void pcm_block(int n) {
    int npad = enc_.pcm_pad_width();
    uint32_t pad = 0;
    for (int b = 0; b < npad; ++b) {
      pad = (pad << 1) | rans_.decode(kProbScale / 2);
      m_.note_passthrough();
    }
    std::vector<uint8_t> buf(static_cast<size_t>(n), 0);
    for (int i = 0; i < n; ++i) {
      int v = 0;
      for (int b = 0; b < 8; ++b) {
        v = (v << 1) | rans_.decode(kProbScale / 2);
        m_.note_passthrough();
      }
      buf[i] = uint8_t(v);
    }
    enc_.pcm_bytes(buf.data(), buf.size(), pad, npad);
  }
  void begin_mb(int x, int y) { m_.begin_mb(x, y); }
  void begin_block(int slot, int cat, int max_coeff) { m_.begin_block(slot, cat, max_coeff); }
  void end_block() { m_.end_block(); }

  CabacEncoder& cabac() { return enc_; }

 private:
  PriorModel& m_;
  RansInterleavedDecoder& rans_;
  CabacEncoder enc_;
  CabacContexts cab_ctxs_;
};

// ---------------------------------------------------------------------------
// ARTC container (byte-oriented, little-endian).
//
// Layout:
//   magic "ATRC" | u8 version | u8 build_id_len, build_id bytes (v26+,
//   git revision of the writing build) | u16 lanes | u8 chunk_mode |
//   u32 batch | u8 model_profile | u8 transport [ts run map] | u32 crc32
//   u32 n_paramsets | per paramset: u8 nal_type, u32 len, bytes (EBSP payload
//                     incl. NAL header byte)
//   u32 n_chunks
//   u32 n_segments | segments:
//     u8 tag=0 literal: u64 len, bytes
//     u8 tag=1 slice:   u32 chunk_idx, u16 header_rbsp_len, bytes (incl NAL
//                       header byte), u32 cabac_rbsp_len, u8 tail_patch_len,
//                       bytes, u8 start_code_len (0/3/4)
//   per chunk: u64 blob_len, bytes (RansInterleaved payload)
// CRC-32 (IEEE) for container integrity (the reference's Metadata fields are
// defined but never populated/checked, recode.proto:2-7).
inline uint32_t crc32_ieee(const uint8_t* data, size_t n) {
  static const auto table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void u16(uint16_t v) { buf.push_back(v & 0xff); buf.push_back(v >> 8); }
  void u32(uint32_t v) { for (int i = 0; i < 4; ++i) buf.push_back((v >> (8 * i)) & 0xff); }
  void u64(uint64_t v) { for (int i = 0; i < 8; ++i) buf.push_back((v >> (8 * i)) & 0xff); }
  // LEB128 varint: most container fields are small.
  void vu(uint64_t v) {
    while (v >= 0x80) {
      buf.push_back(uint8_t(v) | 0x80);
      v >>= 7;
    }
    buf.push_back(uint8_t(v));
  }
  void bytes(const uint8_t* p, size_t n) { buf.insert(buf.end(), p, p + n); }
};
struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void need(size_t k) const {
    if (pos + k > n) throw std::runtime_error("container truncated");
  }
  uint8_t u8() { need(1); return p[pos++]; }
  uint16_t u16() { need(2); uint16_t v = p[pos] | (p[pos + 1] << 8); pos += 2; return v; }
  uint32_t u32() {
    need(4);
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= uint32_t(p[pos + i]) << (8 * i);
    pos += 4;
    return v;
  }
  uint64_t u64() {
    need(8);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= uint64_t(p[pos + i]) << (8 * i);
    pos += 8;
    return v;
  }
  uint64_t vu() {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      need(1);
      uint8_t b = p[pos++];
      v |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) throw std::runtime_error("varint overflow");
    }
    return v;
  }
  const uint8_t* bytes(size_t k) {
    need(k);
    const uint8_t* q = p + pos;
    pos += k;
    return q;
  }
};

std::vector<uint8_t> compress(const uint8_t* data, size_t size, const Options& opt, Stats* stats);
std::vector<uint8_t> decompress(const uint8_t* data, size_t size, Stats* stats);

}  // namespace artc
