// Spec-exact H.264 CABAC arithmetic decoding + encoding engines
// (ITU-T Rec. H.264 clauses 9.3.3.2 decode, 9.3.4 encode, 9.3.1 init).
//
// Reference parity: the reference *decodes* original CABAC via ffmpeg's hooked
// ff_get_cabac (reference recode.cpp:1176) and *re-encodes* via its own
// cabac::encoder built on a generic range coder (reference cabac_code.h:16-86).
// Here both directions are first-class spec implementations, so the framework
// needs no ffmpeg fork: the decoder drives our own syntax engine and the
// encoder regenerates original slice bytes bit-exactly on decompression.
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <vector>

#include "gen/cabac_tables.h"

namespace artc {

constexpr int kNumCabacContexts = 1024;

// Per-slice adaptive context states: 6-bit probability state + MPS bit.
struct CabacContexts {
  uint8_t p_state[kNumCabacContexts];
  uint8_t val_mps[kNumCabacContexts];

  static int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }

  // Clause 9.3.1.1. slice_type semantics: I/SI -> init table I; P/SP/B -> PB
  // table selected by cabac_init_idc.
  void init(bool intra_slice, int cabac_init_idc, int slice_qp_y) {
    for (int i = 0; i < kNumCabacContexts; ++i) {
      int m = intra_slice ? kCtxInitI[i][0] : kCtxInitPB[cabac_init_idc][i][0];
      int n = intra_slice ? kCtxInitI[i][1] : kCtxInitPB[cabac_init_idc][i][1];
      int pre = clip3(1, 126, ((m * clip3(0, 51, slice_qp_y)) >> 4) + n);
      if (pre <= 63) {
        p_state[i] = uint8_t(63 - pre);
        val_mps[i] = 0;
      } else {
        p_state[i] = uint8_t(pre - 64);
        val_mps[i] = 1;
      }
    }
  }
};

// Arithmetic *decoding* engine (clause 9.3.3.2). Reads bits MSB-first from an
// RBSP buffer starting at a given bit offset. Reads past the buffer end yield
// zero bits (tracked in overread_bits_ for diagnostics) — the final renorms of
// a conformant stream may touch alignment bits only.
class CabacDecoder {
 public:
  CabacDecoder(const uint8_t* rbsp, size_t size_bytes, size_t start_bit)
      : data_(rbsp), size_bits_(size_bytes * 8), pos_(start_bit) {
    cod_i_range_ = 510;
    cod_i_offset_ = read_bits(9);
  }

  // DecodeDecision (9.3.3.2.1) against context state ctx.
  int decode_decision(CabacContexts& c, int ctx_idx) {
    uint32_t q = (cod_i_range_ >> 6) & 3;
    uint32_t lps = kRangeTabLPS[c.p_state[ctx_idx]][q];
    cod_i_range_ -= lps;
    int bin;
    if (cod_i_offset_ >= cod_i_range_) {
      bin = 1 - c.val_mps[ctx_idx];
      cod_i_offset_ -= cod_i_range_;
      cod_i_range_ = lps;
      if (c.p_state[ctx_idx] == 0) c.val_mps[ctx_idx] ^= 1;
      c.p_state[ctx_idx] = kTransIdxLPS[c.p_state[ctx_idx]];
    } else {
      bin = c.val_mps[ctx_idx];
      c.p_state[ctx_idx] = kTransIdxMPS[c.p_state[ctx_idx]];
    }
    renorm();
    return bin;
  }

  // DecodeBypass (9.3.3.2.3).
  int decode_bypass() {
    cod_i_offset_ = (cod_i_offset_ << 1) | read_bit();
    if (cod_i_offset_ >= cod_i_range_) {
      cod_i_offset_ -= cod_i_range_;
      return 1;
    }
    return 0;
  }

  // DecodeTerminate (9.3.3.2.4). bin==1 => end of slice data.
  int decode_terminate() {
    cod_i_range_ -= 2;
    if (cod_i_offset_ >= cod_i_range_) {
      return 1;
    }
    renorm();
    return 0;
  }

  size_t bit_pos() const { return pos_; }
  size_t overread_bits() const { return overread_bits_; }
  uint32_t range() const { return cod_i_range_; }

 private:
  void renorm() {
    // Equivalent to the spec's doubling loop (9.3.3.2.2): the iteration
    // count is 9 - bit_width(range) (range in [2, 255] here), so shift once
    // and pull all the bits in one read.
    if (cod_i_range_ >= 256) return;
    int shift = 9 - (32 - __builtin_clz(cod_i_range_));
    cod_i_range_ <<= shift;
    cod_i_offset_ = (cod_i_offset_ << shift) | read_bits(shift);
  }

  // n in [1, 9]; MSB-first, identical bit order and overread accounting to n
  // successive read_bit() calls.
  uint32_t read_bits(int n) {
    size_t end = pos_ + size_t(n);
    if (end <= size_bits_) {
      size_t byte = pos_ >> 3;
      int off = int(pos_ & 7);
      uint32_t w = uint32_t(data_[byte]) << 16;
      if (off + n > 8) {
        w |= uint32_t(data_[byte + 1]) << 8;
        if (off + n > 16) w |= data_[byte + 2];
      }
      pos_ = end;
      return (w >> (24 - off - n)) & ((1u << n) - 1);
    }
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  uint32_t read_bit() {
    if (pos_ >= size_bits_) {
      ++pos_;
      ++overread_bits_;
      return 0;
    }
    uint32_t bit = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return bit;
  }

  const uint8_t* data_;
  size_t size_bits_;
  size_t pos_;
  size_t overread_bits_ = 0;
  uint32_t cod_i_range_;
  uint32_t cod_i_offset_;
};

// Arithmetic *encoding* engine (clause 9.3.4). Produces the slice-data bits
// (MSB-first) including the flush of 9.3.4.6; the caller byte-aligns with
// zeros afterwards (rbsp_trailing alignment).
//
// Implementation: wide-accumulator byte-wise renormalization instead of the
// spec's per-bit PutBit/bitsOutstanding loop (9.3.4.3). `low_` holds the
// 10-bit arithmetic window in its low bits plus `pend_` not-yet-final output
// bits above it; carries from low_ += range propagate into the pending bits
// by ordinary integer addition. Bytes are extracted from the top of the
// pending region with the classic carry-deferral rule: an extracted 0xff
// byte cannot be finalized (a future carry could still ripple through it),
// so it is counted in ff_run_; any other byte absorbs at most one +1 and is
// held back one step (last_) so a ripple-past carry (the 9th extracted bit)
// can still increment it. This emits the identical bit sequence to the
// spec's loop — the per-bit engine is the lazy binary expansion of the same
// arithmetic fraction — at a fraction of the cost: the hot re-encode path
// (decompression output + the compress-side byte-exact verify) measures
// ~0.5 renorm iterations per bin under the spec loop, each with two
// data-random branches. Differentially tested against CabacDecoder on
// randomized streams and byte-exact on the full corpus (tools/check_syntax).
class CabacEncoder {
 public:
  CabacEncoder() { reset(); }

  void reset() {
    low_ = 0;
    range_ = 510;
    pend_ = 0;
    first_ = true;
    have_last_ = false;
    last_ = 0;
    ff_run_ = 0;
    buf_.clear();
    nbits_ = 0;
    acc_ = 0;
    accn_ = 0;
  }

  void encode_decision(CabacContexts& c, int ctx_idx, int bin) {
    uint32_t qi = (range_ >> 6) & 3;
    uint32_t lps = kRangeTabLPS[c.p_state[ctx_idx]][qi];
    range_ -= lps;
    if (bin != c.val_mps[ctx_idx]) {
      low_ += range_;  // carry propagates into the pending bits
      range_ = lps;
      if (c.p_state[ctx_idx] == 0) c.val_mps[ctx_idx] ^= 1;
      c.p_state[ctx_idx] = kTransIdxLPS[c.p_state[ctx_idx]];
    } else {
      c.p_state[ctx_idx] = kTransIdxMPS[c.p_state[ctx_idx]];
    }
    renorm();
  }

  void encode_bypass(int bin) {
    // Spec 9.3.4.4's shift-compare-emit collapses to: push one bit into the
    // pending region (the carry, if any, rides the addition).
    low_ <<= 1;
    if (bin) low_ += range_;
    ++pend_;
    if (pend_ >= 16) shovel();
  }

  // EncodeTerminate (9.3.4.5) + EncodeFlush (9.3.4.6) when bin==1.
  void encode_terminate(int bin) {
    range_ -= 2;
    if (bin) {
      low_ += range_;
      // flush: renorm at range 2, then emit bits 9..7 of the window with the
      // stop bit or'ed in, and drain everything (the arithmetic stream ends
      // here — either slice end or an I_PCM re-init).
      range_ = 2;
      renorm();
      uint32_t w = uint32_t(low_) & 1023;
      uint32_t three = (((w >> 9) & 1) << 2) | (((w >> 8) & 1) << 1) |
                       (((w >> 7) & 1) | 1);
      low_ = (((low_ >> 10) << 3) | three) << 10;
      pend_ += 3;
      drain();
    } else {
      renorm();
    }
  }

  // I_PCM sample passthrough (clauses 7.3.5, 9.3.1): after the terminate-bin
  // flush, padding bits fill to a byte boundary, the raw sample bytes follow
  // outside the arithmetic coder, and the encoding engine is re-initialized
  // (context states persist). The pad bit *values* are caller-supplied,
  // MSB-first in `pad`: the spec calls for pcm_alignment_zero_bit == 0, but
  // x264 stuffs a per-frame pseudo-random bit there, so byte-exact
  // regeneration must replay the original padding verbatim.
  void pcm_bytes(const uint8_t* p, size_t n, uint32_t pad, int npad) {
    // Called right after an encode_terminate(1) flush: the arithmetic side
    // is fully drained, so nbits_ is exact here.
    for (int b = npad - 1; b >= 0; --b) raw_bit((pad >> b) & 1);
    if (nbits_ & 7) throw std::runtime_error("pcm pad bits do not align");
    flush_acc();  // byte-aligned: the samples append as whole bytes
    buf_.insert(buf_.end(), p, p + n);
    nbits_ += n * 8;
    low_ = 0;
    range_ = 510;
    pend_ = 0;
    first_ = true;
    have_last_ = false;
    ff_run_ = 0;
  }

  // Pad bits needed to reach the next byte boundary (I_PCM alignment width).
  int pcm_pad_width() const { return int((8 - (nbits_ & 7)) & 7); }

  // Finished bitstream, byte-aligned with zero bits (alignment belongs to
  // rbsp_trailing; the flush above already emitted the stop-one bit).
  std::vector<uint8_t> take_bytes() {
    drain();  // no-op after a terminate(1) flush (the only valid end state)
    int pad = int((8 - (accn_ & 7)) & 7);  // zero-pad the partial tail byte
    acc_ <<= pad;
    accn_ += pad;
    flush_acc();
    return std::move(buf_);
  }

  size_t bit_count() const { return nbits_; }

 private:
  void renorm() {
    // One shift instead of the spec's doubling loop (9.3.4.3): the iteration
    // count is 9 - bit_width(range); the emitted bits accumulate above the
    // 10-bit window and leave in bytes (shovel).
    if (range_ >= 256) return;
    int s = 9 - (32 - __builtin_clz(range_));
    range_ <<= s;
    low_ <<= s;
    pend_ += s;
    if (pend_ >= 16) shovel();
  }

  // Move finalized bytes from the pending region to the backend. An extracted
  // byte's 9th bit is a carry that rippled past it into older output:
  // increment the held byte (never 0xff by construction, so no re-ripple) and
  // the deferred 0xff run becomes 0x00s. While first_ is set, the extraction
  // takes 9 bits and discards the top one (9.3.4.3 firstBitFlag) — kept in
  // the register until then so earlier carries land in it, as the spec's
  // engine effectively does.
  void shovel() {
    while (pend_ >= (first_ ? 9 : 8)) {
      int take = first_ ? 9 : 8;
      int sh = pend_ + 10 - take;
      uint32_t out = uint32_t(low_ >> sh);
      low_ &= (uint64_t(1) << sh) - 1;
      pend_ -= take;
      uint32_t cur = out & 0xff;
      if (!first_ && (out >> 8)) {
        // Carry past this byte: the byte itself wrapped to 0x00 (a ripple
        // producing a carry leaves all lower bits zero), the held byte
        // absorbs +1, deferred 0xffs wrap to 0x00.
        if (have_last_) {
          ++last_;
          push_byte(uint8_t(last_));
          have_last_ = false;
        }
        // (no held byte: the carry lands in the already-discarded first bit)
        for (; ff_run_; --ff_run_) push_byte(0x00);
      }
      first_ = false;
      if (cur == 0xff) {
        ++ff_run_;  // not final: a future carry could ripple through
        continue;
      }
      if (have_last_) push_byte(uint8_t(last_));
      for (; ff_run_; --ff_run_) push_byte(0xff);
      last_ = cur;
      have_last_ = true;
    }
  }

  // Flush every pending/held bit to the backend (stream end: terminate(1)
  // flush or take_bytes). No arithmetic follows, so everything is final.
  void drain() {
    shovel();
    if (first_ && pend_ > 0) {  // degenerate tiny stream: drop the first bit
      --pend_;
      low_ &= (uint64_t(1) << (pend_ + 10)) - 1;
      first_ = false;
    }
    if (have_last_) {
      push_byte(uint8_t(last_));
      have_last_ = false;
    }
    for (; ff_run_; --ff_run_) push_byte(0xff);
    while (pend_ > 0) {
      --pend_;
      raw_bit(uint32_t(low_ >> (pend_ + 10)) & 1);
      low_ &= (uint64_t(1) << (pend_ + 10)) - 1;
    }
  }

  void push_byte(uint8_t b) {
    acc_ = (acc_ << 8) | b;
    nbits_ += 8;
    accn_ += 8;
    if (accn_ == 64) flush_acc();
  }

  void raw_bit(uint32_t b) {
    acc_ = (acc_ << 1) | b;
    ++nbits_;
    if (++accn_ == 64) flush_acc();
  }

  // Emit the accumulator's whole bytes (accn_ must be a multiple of 8).
  void flush_acc() {
    for (int s = accn_ - 8; s >= 0; s -= 8) buf_.push_back(uint8_t(acc_ >> s));
    acc_ = 0;
    accn_ = 0;
  }

  uint64_t low_;   // 10-bit arithmetic window + pend_ pending output bits
  uint32_t range_;
  int pend_;       // pending (not yet byte-extracted) output bits above the window
  bool first_;     // the stream's first pending bit is discarded (firstBitFlag)
  bool have_last_; // a finalized byte held back one step for +1 carry absorption
  uint32_t last_;
  uint64_t ff_run_;  // deferred 0xff bytes between last_ and the window
  std::vector<uint8_t> buf_;  // packed whole bytes
  uint64_t acc_ = 0;          // pending bits, MSB-first in the low accn_ bits
  int accn_ = 0;
  size_t nbits_ = 0;
};

}  // namespace artc
