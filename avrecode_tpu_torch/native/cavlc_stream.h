// CAVLC value-stream transport: compress-side recorder (decodes the original
// bits, records every syntax value) and the bit-exact writer replay.
// The value stream is the CAVLC analogue of the CABAC SymbolStream.
#pragma once

#include <cstdint>
#include <vector>

#include "h264_cavlc.h"

namespace artc {

// aux for kRLevelPrefix: (suffix_length, coefficient index, total_coeff
// bucket) — level magnitudes fall sharply with decode position and with the
// block's coefficient count (measured -0.3..-0.5pp per clip).
inline uint8_t lp_aux(int suffix_length, int idx, int total_coeff) {
  return uint8_t(suffix_length | (idx < 7 ? idx : 7) << 3 |
                 (((total_coeff > 8 ? 3 : (total_coeff - 1) >> 1) & 3) << 6));
}

// aux for kRT1s: the trailing-ones count depends strongly on total_coeff
// (t1s <= min(3, tc); measured -0.9..-4.1pp per clip).
inline uint8_t t1_aux(int nc_class, int total_coeff) {
  return uint8_t(nc_class | (total_coeff < 16 ? total_coeff : 15) << 3);
}

struct CavlcValue {
  uint8_t role;
  uint8_t aux;    // role-specific context/aux (nc_class, suffix_length, nbits...)
  int32_t value;
};

struct CavlcStream {
  std::vector<CavlcValue> values;
  struct Event {
    uint32_t at;
    int32_t a, b;
  };
  std::vector<Event> mb_events;  // begin_mb positions (for model spatial state)
  // Slice geometry for the model's per-MB temporal grids (in-memory only —
  // the decode side re-derives the same values from the parsed headers).
  int mb_width = 0, mb_height = 0;
  uint8_t slice_class = 0;  // 0 I, 1 P(/SP), 2 B
  bool new_picture = false;
};

// Compress side: decode bits, record values.
class CavlcRecorder {
 public:
  CavlcRecorder(const uint8_t* rbsp, size_t size, size_t start_bit, CavlcStream* out)
      : r_(rbsp, size, start_bit), rbsp_(rbsp), size_(size), out_(out) {}

  bool more_data() {
    BitReader probe(rbsp_, size_);
    probe.set_bit_pos(r_.bit_pos());
    return probe.more_rbsp_data();
  }
  void begin_mb(int x, int y) { out_->mb_events.push_back({uint32_t(out_->values.size()), x, y}); }

  uint32_t ue(CavlcRole role, int ctx) { return rec(role, ctx, int32_t(r_.ue())); }
  int32_t se(CavlcRole role, int ctx) { return rec(role, ctx, r_.se()); }
  uint32_t u(int n, CavlcRole role, int ctx) {
    return rec(role, uint8_t(ctx | (n << 4)), int32_t(r_.u(n)));
  }
  void coeff_token(int nc_class, int model_ctx, int* total_coeff, int* t1s) {
    r_.coeff_token(nc_class, total_coeff, t1s);
    rec(kRTotalCoeff, uint8_t(nc_class | (model_ctx << 3)), *total_coeff);
    rec(kRT1s, t1_aux(nc_class, *total_coeff), *t1s);
  }
  uint32_t total_zeros(int tz_idx, int dc_kind, int ctx) {
    uint32_t v = r_.total_zeros(tz_idx, dc_kind);
    // aux: 0x80 = 4:2:0 chroma DC (legacy key shape), 0xC0 = 4:2:2 chroma DC.
    rec(kRTotalZeros, uint8_t((dc_kind == 1 ? 0x80 : dc_kind == 2 ? 0xC0 : 0) | tz_idx),
        int32_t(v));
    return v;
  }
  uint32_t run_before(int zeros_left, int ctx) {
    uint32_t v = r_.run_before(zeros_left);
    rec(kRRunBefore, uint8_t((zeros_left < 15 ? zeros_left : 15) | (ctx << 4)), int32_t(v));
    return v;
  }
  uint32_t level_prefix(int suffix_length, int idx, int total_coeff) {
    uint32_t v = r_.level_prefix();
    rec(kRLevelPrefix, lp_aux(suffix_length, idx, total_coeff), int32_t(v));
    return v;
  }
  uint32_t level_suffix_bits(int nbits, int suffix_length) {
    uint32_t v = r_.u(nbits);
    rec(kRLevelSuffix, uint8_t(suffix_length | (nbits << 3)), int32_t(v));
    return v;
  }
  void pcm_block(int n) {
    // Pad bit values are recorded verbatim (the spec mandates zeros, but see
    // the CABAC path: encoders have stuffed nonzero bits there).
    int npad = int((8 - (r_.bit_pos() & 7)) & 7);
    rec(kRPcmPad, uint8_t(npad), int32_t(npad ? r_.u(npad) : 0));
    for (int i = 0; i < n; ++i) rec(kRPcmByte, 0, int32_t(r_.u(8)));
  }

  size_t bit_pos() const { return r_.bit_pos(); }

 private:
  int32_t rec(uint8_t role, uint8_t aux, int32_t v) {
    out_->values.push_back({role, aux, v});
    return v;
  }
  CavlcBitReader r_;
  const uint8_t* rbsp_;
  size_t size_;
  CavlcStream* out_;
};

// Replay side: values come from a source (recorded stream for verification,
// or the model decoder at decompress time); bits are regenerated.
template <class ValueSource>
class CavlcReplayer {
 public:
  CavlcReplayer(ValueSource& src, BitWriter& w) : src_(src), w_(w) {}

  bool more_data() { return src_.more_data(); }
  void begin_mb(int x, int y) { src_.begin_mb(x, y); }

  uint32_t ue(CavlcRole role, int ctx) {
    uint32_t v = uint32_t(src_.next(role, uint8_t(ctx)));
    w_.ue(v);
    return v;
  }
  int32_t se(CavlcRole role, int ctx) {
    int32_t v = src_.next(role, uint8_t(ctx));
    w_.se(v);
    return v;
  }
  uint32_t u(int n, CavlcRole role, int ctx) {
    uint32_t v = uint32_t(src_.next(role, uint8_t(ctx | (n << 4))));
    w_.u(n, v);
    return v;
  }
  void coeff_token(int nc_class, int model_ctx, int* total_coeff, int* t1s) {
    *total_coeff = src_.next(kRTotalCoeff, uint8_t(nc_class | (model_ctx << 3)));
    *t1s = src_.next(kRT1s, t1_aux(nc_class, *total_coeff));
    w_.coeff_token(nc_class, *total_coeff, *t1s);
  }
  uint32_t total_zeros(int tz_idx, int dc_kind, int ctx) {
    uint32_t v = uint32_t(src_.next(
        kRTotalZeros, uint8_t((dc_kind == 1 ? 0x80 : dc_kind == 2 ? 0xC0 : 0) | tz_idx)));
    w_.total_zeros(tz_idx, dc_kind, v);
    return v;
  }
  uint32_t run_before(int zeros_left, int ctx) {
    uint32_t v = uint32_t(
        src_.next(kRRunBefore, uint8_t((zeros_left < 15 ? zeros_left : 15) | (ctx << 4))));
    w_.run_before(zeros_left, v);
    return v;
  }
  uint32_t level_prefix(int suffix_length, int idx, int total_coeff) {
    uint32_t v = uint32_t(src_.next(kRLevelPrefix, lp_aux(suffix_length, idx, total_coeff)));
    w_.level_prefix(v);
    return v;
  }
  uint32_t level_suffix_bits(int nbits, int suffix_length) {
    uint32_t v = uint32_t(src_.next(kRLevelSuffix, uint8_t(suffix_length | (nbits << 3))));
    w_.u(nbits, v);
    return v;
  }
  void pcm_block(int n) {
    int npad = int((8 - (w_.bit_pos() & 7)) & 7);
    uint32_t pad = uint32_t(src_.next(kRPcmPad, uint8_t(npad)));
    if (npad) w_.u(npad, pad);
    for (int i = 0; i < n; ++i) w_.u(8, uint32_t(src_.next(kRPcmByte, 0)));
  }

 private:
  ValueSource& src_;
  CavlcBitWriter w_;
};

// Verification value source: replays a recorded stream, checking order.
class RecordedValues {
 public:
  explicit RecordedValues(const CavlcStream& s) : s_(s) {}
  bool more_data() const { return pos_ < s_.values.size(); }
  void begin_mb(int, int) {}
  int32_t next(uint8_t role, uint8_t aux) {
    if (pos_ >= s_.values.size()) throw BitstreamError("cavlc replay: stream exhausted");
    const CavlcValue& v = s_.values[pos_++];
    if (v.role != role || v.aux != aux) throw BitstreamError("cavlc replay: role mismatch");
    return v.value;
  }

 private:
  const CavlcStream& s_;
  size_t pos_ = 0;
};

}  // namespace artc
