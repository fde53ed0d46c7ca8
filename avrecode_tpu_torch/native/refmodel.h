// Reference-model head-to-head profiler — the measured baseline behind the
// ">= avrecode's ratio" claim (BASELINE.md: "establish avrecode's number
// empirically ... by our reimplementation of its model, before claiming
// wins"). The reference binary cannot be built here (empty ffmpeg submodule),
// so this is a faithful reimplementation of the reference's h264_model
// semantics (reference recode.cpp:616-1059) run as a side-car accumulator
// over the same recorded symbol stream the product model codes; it reports
// the total information content (millibits) the reference's model would have
// spent. Enabled per compress pass via ARTC_REFMODEL=1 (see run_chunk_model);
// costs nothing when off. tools/ref_head2head.py renders the table.
//
// Faithful (everything that moves the measurement):
//  - Per-key pos/neg counting estimators, cold start pos=neg=1, halving
//    window 0x60 (0x50 for significance-map bins), persistent across slices
//    and pictures (reference recode.cpp:662 "reset should do nothing",
//    recode.cpp:1030-1046; it never warm-seeds from CABAC init tables).
//  - Regular context-coded bins keyed on context identity alone (the
//    reference keys on the ffmpeg context-state POINTER, recode.cpp:318 +
//    676-684; the spec ctxIdx our walker records is the same identity).
//    All bypass-coded bins share ONE estimator and terminate bins another
//    (recode.cpp:1050 bypass_context/terminate_context) — our stream tags
//    them kCtxBypass/kCtxTerminate, which collapse the same way.
//  - Significance-map bins keyed on (64*num_nonzeros + nonzeros_observed,
//    is_dc + 2*zigzag_offset + per-cat offset) exactly as recode.cpp:798-800.
//  - The NZ-count serialized first as 6/4/2 LSB-first bits with per-bit keys
//    on (bits so far, prev-frame bit, left bit, above bit) x (is_8x8, is_dc,
//    chroma422, cat) per recode.cpp:844-930 — including its two quirks: the
//    count masks to the serialized width, and the above-neighbor bit falls
//    back to "unavailable" whenever the above count is zero (recode.cpp:873
//    tests `if (above_nonzero)`, not `if (has_above)`).
//  - EOB (last_significant_coeff_flag) bins cost zero bits — deterministic
//    from num_nonzeros == observed (recode.cpp:1073-1076 skips the put).
//  - Costs are ideal information content (-log2 p), the same pricing basis
//    as our Billing; the reference's 64-bit range coder realizes this to
//    <0.1%, and its protobuf per-block container overhead is NOT charged —
//    both choices are generous to the reference.
// Approximations (documented, second-order):
//  - The NZ-bit key's is_8x8 flag is block-level (64-coeff block), not the
//    reference's MB-level transform flag (recode.cpp:884 meta.is_8x8); they
//    differ only for chroma/DC blocks inside 8x8-transform MBs, where the
//    flag is one key dimension among four.
//  - 4:4:4 per-plane cats fold onto their luma analogues (head-to-head clips
//    are 4:2:0, where cats 0-5 partition identically to the reference's
//    cat_lookup).
#pragma once

#include <array>
#include <cmath>
#include <cstdint>
#include <unordered_map>

#include "gen/cabac_tables.h"
#include "h264_tables.h"

namespace artc {

class RefModel {
 public:
  // One regular bin through the per-context estimator (reference
  // recode.cpp:679-683 default model_key(context, 0, 0)).
  void bin(uint32_t ctx, int b) { code(key(0, ctx, 0), b, /*sigmap=*/false); }

  // Literal bits (I_PCM payload): the reference passes these outside its
  // model at 1 bit per bit.
  void raw_bit() { mbits_ += 1000; }

  void begin_block(int cat, int max_coeff, int nnz, int left_cnt, int above_cnt,
                   int prev_cnt, bool chroma422) {
    cat_ = cat;
    max_coeff_ = max_coeff;
    nnz_ = nnz;
    left_ = left_cnt;    // -1 = neighbor outside the picture
    above_ = above_cnt;  // -1 = neighbor outside the picture
    prev_ = prev_cnt;
    c422_ = chroma422 && (cat == kCatChromaDC || cat == kCatChromaAC) ? 1 : 0;
    observed_ = 0;
    nz_coded_ = false;
  }

  // Charge the NZ-count bits once per block, at the first significance bin
  // (the reference queues them ahead of the sig map, recode.cpp:844-930).
  void ensure_nz() {
    if (nz_coded_) return;
    nz_coded_ = true;
    int bits = max_coeff_ > 16 ? 6 : max_coeff_ > 4 ? 4 : 2;
    int val = nnz_ & ((1 << bits) - 1);  // reference reassembles only `bits` bits
    int so_far = 0;
    for (int i = 0; i < bits; ++i) {
      int cur_bit = 1 << i;
      int left_bit = left_ < 0 ? 2 : (left_ >= cur_bit ? 1 : 0);
      // Reference quirk: `if (above_nonzero)` — a zero count reads as
      // "unavailable" even when the neighbor exists.
      int above_bit = above_ > 0 ? (above_ >= cur_bit ? 1 : 0) : 2;
      int prev_bit = prev_ >= cur_bit ? 1 : 0;
      int b = (val >> i) & 1;
      uint32_t second =
          uint32_t(so_far) + 64u * prev_bit + 128u * left_bit + 384u * above_bit;
      uint32_t third = uint32_t(is_8x8()) + uint32_t(is_dc()) * 2 + c422_ +
                       uint32_t(cat_) * 4;
      code(key(2 + i, second, third), b, /*sigmap=*/false);  // window 0x60:
      // coding_type is PIP_SIGNIFICANCE_NZ here (recode.cpp:851, 1041).
      if (b) so_far |= cur_bit;
    }
    nnz_masked_ = val;
  }

  void sig(int pos, int b) {
    // Reference key (recode.cpp:798-800): second = 64*num_nonzeros +
    // nonzeros_observed (num_nonzeros = the masked reassembled count),
    // third = is_dc + 2*zigzag_offset + distinct-per-cat offset.
    uint32_t second = 64u * uint32_t(nnz_masked_) + uint32_t(observed_);
    uint32_t third =
        uint32_t(is_dc()) + 2u * uint32_t(zig_off(pos)) + 32u * uint32_t(cat_);
    code(key(1, second, third), b, /*sigmap=*/true);
    if (b) ++observed_;
  }

  // last_significant_coeff_flag: zero bits (recode.cpp:1073-1076).
  void eob() {}

  uint64_t mbits() const { return mbits_; }
  size_t estimators() const { return est_.size(); }

 private:
  struct E {
    uint16_t pos = 1, neg = 1;
  };

  int is_dc() const { return cat_ == kCatLumaDC || cat_ == kCatChromaDC ? 1 : 0; }
  int is_8x8() const { return max_coeff_ > 32 ? 1 : 0; }
  int zig_off(int pos) const {
    static constexpr uint8_t kDc422Off[7] = {0, 0, 1, 1, 2, 2, 2};  // recode.cpp:697
    if (is_dc() && c422_) return kDc422Off[pos < 7 ? pos : 6];
    if (max_coeff_ > 32) return kSigCoeffFlagOffset8x8[0][pos];
    return pos;
  }

  static uint64_t key(uint32_t kind, uint32_t second, uint32_t third) {
    return (uint64_t(kind) << 48) | (uint64_t(second) << 24) | third;
  }

  // Millibit cost lookup (same 4096-entry basis as ModelEncoder::CostTab).
  struct CostTab {
    std::array<uint32_t, 4096> t{};
    CostTab() {
      for (int i = 0; i < 4096; ++i) {
        double pp = (i * 8 + 4) / 32768.0;
        t[i] = uint32_t(-1000.0 * std::log2(pp));
      }
    }
  };
  static inline const CostTab cost_tab_{};

  void code(uint64_t k, int b, bool sigmap) {
    E& e = est_[k];
    uint32_t tot = uint32_t(e.pos) + e.neg;
    uint32_t p1 = (uint32_t(e.pos) << 15) / tot;
    if (p1 < 1) p1 = 1;
    if (p1 > 32767) p1 = 32767;
    mbits_ += cost_tab_.t[(b ? p1 : 32768 - p1) >> 3];
    if (b) ++e.pos; else ++e.neg;
    // Reference windows: 0x50 for the significance map, 0x60 for everything
    // else (recode.cpp:1041-1046); halving rounds up.
    if (tot + 1 > (sigmap ? 0x50u : 0x60u)) {
      e.pos = uint16_t((e.pos + 1) / 2);
      e.neg = uint16_t((e.neg + 1) / 2);
    }
  }

  std::unordered_map<uint64_t, E> est_;
  uint64_t mbits_ = 0;
  int cat_ = 0, max_coeff_ = 0, nnz_ = 0, nnz_masked_ = 0;
  int left_ = -1, above_ = -1, prev_ = 0;
  uint32_t c422_ = 0;
  int observed_ = 0;
  bool nz_coded_ = false;
};

}  // namespace artc
