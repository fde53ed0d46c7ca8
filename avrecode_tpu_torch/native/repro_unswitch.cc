// A standalone reproducer of the g++ 13.3 loop-unswitching miscompile that
// h264_slice.h's decode_coeffs guards against. Not part of the library.
//
//   cd avrecode_tpu_torch/native
//   g++ -std=c++17 -O3 -I . repro_unswitch.cc -o /tmp/repro && /tmp/repro
//
// Walker::decode_block / decode_coeffs / sig_ctx / last_ctx are
// SliceWalker's, reduced: the bins come from a fixed xorshift sequence and
// every significance / last context is logged. The program decodes 64
// 4:2:2 chroma DC blocks (ctxBlockCat 3, 8 coefficients, NumC8x8 2) and
// checks each logged context against base + Min(pos / 2, 2) (ITU-T H.264
// 9.3.3.1.3). It prints "ok" and exits 0 when all agree, else "WRONG" and
// exits 1. The code is well defined. With g++ 13.3.0 at -O3 (with or
// without -march=native or -fno-strict-aliasing) it prints WRONG: the
// significance-map loop is unswitched on the switch its context tests
// become, and the copy for cat outside {5, 9, 13} lost case 3, so it
// computes base + pos. With -fno-unswitch-loops, at -O2, or with
// -DARTC_GUARD (the attribute that h264_slice.h puts on decode_coeffs) it
// prints ok.
#include <cstdint>
#include <cstdio>
#include <cstdlib>

#include "h264_tables.h"
#include "gen/cabac_tables.h"

#define IO_ATTR __attribute__((noinline))
#ifdef ARTC_GUARD
#define GUARD __attribute__((optimize("no-unswitch-loops")))
#else
#define GUARD
#endif

namespace {
using namespace artc;

struct Bins {
  uint32_t x = 2463534242u;
  int n_ctx = 0;
  int ctx[4096];
  int pos[4096];
  int next() {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    return int(x >> 7) & 1;
  }
  IO_ATTR int decision(int c) { (void)c; return 1; }
  IO_ATTR int sig_bin(int c, int p) { log(c, p); return next(); }
  IO_ATTR int eob_bin(int c, int p) { log(c, p); return (next() & next()); }
  IO_ATTR int res_bin(int c, int p) { (void)c; (void)p; return next() & next(); }
  IO_ATTR int bypass() { return next(); }
  IO_ATTR void implicit_sig_last(int p) { (void)p; }
  IO_ATTR void begin_block(int slot, int cat, int max_coeff) { (void)slot; (void)cat; (void)max_coeff; }
  IO_ATTR void end_block() {}
  void log(int c, int p) {
    if (n_ctx < 4096) { ctx[n_ctx] = c; pos[n_ctx] = p; ++n_ctx; }
  }
};

struct MB { uint64_t cbf = 0; };

struct Walker {
  Walker(Bins& io, MB* cur, int numc8x8, bool field) : numc8x8_(numc8x8), io_(io), cur_field_(field), cur_(cur) {}

  __attribute__((noinline)) void decode_block(int cat, int slot, int max_coeff, int cbf_ctx_idx, int cbf_bit) {
    io_.begin_block(slot, cat, max_coeff);
    int cbf = 1;
    if (cat != kCatLuma8x8) {
      cbf = io_.decision(cbf_ctx_idx);
      if (cbf && cbf_bit >= 0) cur_->cbf |= 1ull << cbf_bit;
    }
    if (cbf) decode_coeffs(cat, max_coeff);
    io_.end_block();
  }

  GUARD void decode_coeffs(int cat, int max_coeff) {
    uint8_t sig[64] = {0};
    int last_pos = -1;
    int i = 0;
    for (; i < max_coeff - 1; ++i) {
      if (io_.sig_bin(sig_ctx(cat, i), i)) {
        sig[i] = 1;
        if (io_.eob_bin(last_ctx(cat, i), i)) { last_pos = i; break; }
      }
    }
    if (last_pos < 0) {
      sig[max_coeff - 1] = 1;
      io_.implicit_sig_last(max_coeff - 1);
      last_pos = max_coeff - 1;
    }
    int num_eq1 = 0, num_gt1 = 0;
    int abs_base = kAbsCtxBase[cat];
    for (int p = last_pos; p >= 0; --p) {
      if (!sig[p]) continue;
      int ctx0 = (num_gt1 != 0) ? 0 : (num_eq1 + 1 < 4 ? num_eq1 + 1 : 4);
      if (io_.res_bin(abs_base + ctx0, p)) {
        int gt1_cap = (cat == kCatChromaDC) ? 3 : 4;
        int ctx_n = 5 + (num_gt1 < gt1_cap ? num_gt1 : gt1_cap);
        int level = 2;
        while (level < 15 && io_.res_bin(abs_base + ctx_n, p)) ++level;
        if (level == 15) {
          int k = 0;
          while (io_.bypass()) {
            level += 1 << k;
            if (++k > 24) abort();
          }
          while (k--) level += io_.bypass() << k;
        }
        ++num_gt1;
      } else {
        ++num_eq1;
      }
      io_.bypass();
    }
  }

  static bool cat_is_8x8(int cat) { return cat == 5 || cat == 9 || cat == 13; }
  int sig_ctx(int cat, int pos) const {
    int fld = cur_field_ ? 1 : 0;
    if (cat_is_8x8(cat)) return kSigCtxBase[fld][cat] + kSigCoeffFlagOffset8x8[fld][pos];
    if (cat == kCatChromaDC) {
      int p = pos / numc8x8_;
      return kSigCtxBase[fld][cat] + (p < 2 ? p : 2);
    }
    return kSigCtxBase[fld][cat] + pos;
  }
  int last_ctx(int cat, int pos) const {
    int fld = cur_field_ ? 1 : 0;
    if (cat_is_8x8(cat)) return kLastCtxBase[fld][cat] + kLastCoeffFlagOffset8x8[pos];
    if (cat == kCatChromaDC) {
      int p = pos / numc8x8_;
      return kLastCtxBase[fld][cat] + (p < 2 ? p : 2);
    }
    return kLastCtxBase[fld][cat] + pos;
  }

  int numc8x8_ = 1;
  Bins& io_;
  bool cur_field_ = false;
  MB* cur_ = nullptr;
};

}  // namespace

volatile int g_cat = kCatChromaDC, g_max = 8, g_numc = 2;

int main() {
  static Bins bins;
  MB mb;
  Walker w(bins, &mb, g_numc, false);
  const int cat = g_cat, max_coeff = g_max;
  for (int b = 0; b < 64; ++b) w.decode_block(cat, 0, max_coeff, 97, 17);
  // Every significance / last context of a 4:2:2 chroma DC block
  // (ctxBlockCat 3, NumC8x8 2) is its base plus Min(pos / 2, 2)
  // (ITU-T H.264 9.3.3.1.3); ctx >= 166 are last_significant_coeff_flag's.
  int bad = 0;
  for (int k = 0; k < bins.n_ctx; ++k) {
    int c = bins.ctx[k], p = bins.pos[k] / 2;
    int base = c >= kLastCtxBase[0][kCatLumaDC] ? kLastCtxBase[0][kCatChromaDC]
                                               : kSigCtxBase[0][kCatChromaDC];
    if (c != base + (p < 2 ? p : 2)) {
      if (!bad) printf("WRONG: pos %d ctx %d, want %d\n", bins.pos[k], c, base + (p < 2 ? p : 2));
      ++bad;
    }
  }
  printf("%s: %d of %d contexts wrong\n", bad ? "WRONG" : "ok", bad, bins.n_ctx);
  return bad ? 1 : 0;
}
