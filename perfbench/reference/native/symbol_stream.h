// Flat per-slice symbol-stream representation plus the compress-side IO that
// records it while spec-decoding original CABAC.
//
// This is the host->device interchange format: the syntax walk happens once on
// host, producing dense tensors of (ctx, klass, bin, pos) plus block/MB events;
// the adaptive-model + entropy-coding passes consume these either serially
// (C++) or batched on TPU. It replaces the reference's hook-callback coupling
// (reference recode.cpp:212-228) with a replayable stream.
#pragma once

#include <array>
#include <cmath>
#include <cstdint>
#include <stdexcept>
#include <vector>

#include "cabac.h"
#include "h264_slice.h"
#include "h264_tables.h"

namespace artc {

enum EventType : uint8_t {
  kEvBeginMB = 0,      // a = mb_x, b = mb_y
  kEvBeginBlock = 1,   // a = slot, b = cat, c = max_coeff,
                       // d = block nonzero count (filled by the recorder at
                       //     EndBlock so model passes need no scan-ahead)
  kEvEndBlock = 2,
  kEvImplicitLast = 3, // a = pos
  kEvBeginSlice = 4,   // a = flags (bit0 intra, bit1 new_picture),
                       // b = mb_width, c = mb_height,
                       // d = slice_qp | (cabac_init_idc << 16)
  kEvPcm = 5,          // a = offset into pcm[], b = byte count (I_PCM samples),
                       // c = pad bit values (MSB-first), d = pad bit count
};

struct SymbolStream {
  struct Bin {
    uint16_t ctx;   // spec ctxIdx, or kCtxBypass / kCtxTerminate
    uint8_t klass;  // BinKlass
    uint8_t bin;
    int16_t pos;    // scan position for sig/eob bins, else -1
    uint16_t cabac_mbits;  // what the original CABAC paid for this bin
  };
  struct Event {
    uint32_t at;  // fires before bins[at]
    uint8_t type;
    int32_t a = 0, b = 0, c = 0, d = 0;
  };
  std::vector<Bin> bins;
  std::vector<Event> events;
  std::vector<uint8_t> pcm;  // raw I_PCM sample bytes (kEvPcm payload)

  void event(EventType t, int32_t a = 0, int32_t b = 0, int32_t c = 0, int32_t d = 0) {
    events.push_back({uint32_t(bins.size()), uint8_t(t), a, b, c, d});
  }
};

// log2 lookup for the 9-bit CABAC range, in millibits. Namespace scope: a
// function-local static would pay an atomic init-guard per call.
struct Log2MbTab {
  std::array<int32_t, 512> t{};
  Log2MbTab() {
    for (int i = 2; i < 512; ++i) t[i] = int32_t(1000.0 * std::log2(double(i)));
  }
};
inline const Log2MbTab log2_mb_tab_{};

// Compress-side IO: spec-decodes original CABAC bins and records them.
// (Reference analogue: compressor::cabac_decoder, recode.cpp:1134-1268, minus
// the queueing — stream reordering happens in the model pass instead.)
class RecordingSource {
 public:
  RecordingSource(const uint8_t* rbsp, size_t size, size_t start_bit, bool intra_slice,
                  int cabac_init_idc, int slice_qp, SymbolStream* out)
      : dec_(rbsp, size, start_bit), rbsp_(rbsp), size_(size), out_(out) {
    ctxs_.init(intra_slice, cabac_init_idc, slice_qp);
  }

  // Fractional CABAC cost of the bin just decoded: delta of the coder's
  // information potential (consumed millibits minus log2 of the range width),
  // via a small lookup over the 9-bit range (billing accuracy only).
  static int32_t log2_mb(uint32_t range) { return log2_mb_tab_.t[range & 511]; }
  uint16_t cost_mbits(int64_t pot_before) {
    int64_t pot = int64_t(dec_.bit_pos()) * 1000 - log2_mb(dec_.range());
    int64_t d = pot - pot_before;
    return uint16_t(d < 0 ? 0 : (d > 65535 ? 65535 : d));
  }
  int64_t potential() const { return int64_t(dec_.bit_pos()) * 1000 - log2_mb(dec_.range()); }

  int decision(int ctx, BinKlass klass, int aux = -1) {
    int64_t p0 = potential();
    int b = dec_.decode_decision(ctxs_, ctx);
    out_->bins.push_back({uint16_t(ctx), klass, uint8_t(b), int16_t(aux), cost_mbits(p0)});
    return b;
  }
  int bypass(BinKlass klass, int aux = -1) {
    int64_t p0 = potential();
    int b = dec_.decode_bypass();
    out_->bins.push_back({uint16_t(kCtxBypass), klass, uint8_t(b), int16_t(aux),
                          cost_mbits(p0)});
    return b;
  }
  // end_of_slice distinguishes the slice-end bin from the I_PCM mb_type
  // check; both are spec terminate bins (coded identically) — the flag only
  // matters to generating sources (tools/make_synth.cc).
  int terminate(bool end_of_slice = true) {
    (void)end_of_slice;
    int64_t p0 = potential();
    int b = dec_.decode_terminate();
    out_->bins.push_back({uint16_t(kCtxTerminate), kKlassTerminate, uint8_t(b), -1, cost_mbits(p0)});
    return b;
  }
  int sig_bin(int ctx, int pos) {
    int64_t p0 = potential();
    int b = dec_.decode_decision(ctxs_, ctx);
    cur_nnz_ += b;
    out_->bins.push_back({uint16_t(ctx), kKlassSig, uint8_t(b), int16_t(pos), cost_mbits(p0)});
    return b;
  }
  int eob_bin(int ctx, int pos) {
    int64_t p0 = potential();
    int b = dec_.decode_decision(ctxs_, ctx);
    out_->bins.push_back({uint16_t(ctx), kKlassEob, uint8_t(b), int16_t(pos), cost_mbits(p0)});
    return b;
  }
  int res_bin(int ctx, int pos) {
    int64_t p0 = potential();
    int b = dec_.decode_decision(ctxs_, ctx);
    out_->bins.push_back({uint16_t(ctx), kKlassRes, uint8_t(b), int16_t(pos), cost_mbits(p0)});
    return b;
  }
  // I_PCM: the spec decoder's bit position after a terminate==1 bin sits
  // exactly at the encoder's stop bit (init lookahead 9 == flush tail 7+2, so
  // bits-read == bits-written); pcm_alignment_zero_bits pad to the next byte
  // boundary, the raw samples follow, and the decoding engine re-initializes
  // there (clause 9.3.1.2; context states persist).
  void pcm_block(int n) {
    size_t pos = dec_.bit_pos();
    size_t byte = (pos + 7) >> 3;
    if ((byte + size_t(n)) > size_) throw BitstreamError("I_PCM past end of slice data");
    // Record the pad bits verbatim: x264 stuffs a pseudo-random bit into the
    // pcm_alignment region, so zeros cannot be assumed (see CabacEncoder).
    int npad = int(byte * 8 - pos);
    uint32_t pad = 0;
    for (size_t b = pos; b < byte * 8; ++b)
      pad = (pad << 1) | ((rbsp_[b >> 3] >> (7 - (b & 7))) & 1);
    out_->event(kEvPcm, int32_t(out_->pcm.size()), n, int32_t(pad), npad);
    out_->pcm.insert(out_->pcm.end(), rbsp_ + byte, rbsp_ + byte + n);
    dec_ = CabacDecoder(rbsp_, size_, (byte + n) * 8);
  }
  void implicit_sig_last(int pos) {
    ++cur_nnz_;
    out_->event(kEvImplicitLast, pos);
  }
  void begin_mb(int mb_x, int mb_y) { out_->event(kEvBeginMB, mb_x, mb_y); }
  void begin_block(int slot, int cat, int max_coeff) {
    cur_begin_ev_ = out_->events.size();
    cur_nnz_ = 0;
    out_->event(kEvBeginBlock, slot, cat, max_coeff);
  }
  void end_block() {
    // Annotate the block's BeginBlock event with its nonzero count so the
    // model passes (which serialize the count *before* the significance map,
    // SURVEY.md §3.4) need no per-block scan-ahead.
    if (cur_begin_ev_ == SIZE_MAX)
      throw std::logic_error("end_block without begin_block");
    out_->events[cur_begin_ev_].d = cur_nnz_;
    cur_begin_ev_ = SIZE_MAX;
    out_->event(kEvEndBlock);
  }

  const CabacDecoder& decoder() const { return dec_; }

 private:
  CabacDecoder dec_;
  const uint8_t* rbsp_;
  size_t size_;
  CabacContexts ctxs_;
  SymbolStream* out_;
  size_t cur_begin_ev_ = SIZE_MAX;  // SIZE_MAX = no open block
  int cur_nnz_ = 0;
};

// Replays a recorded SymbolStream through the spec CABAC encoder, regenerating
// the original slice-data bytes. Used for validation and by the decompressor.
inline std::vector<uint8_t> reencode_symbol_stream(const SymbolStream& ss, bool intra_slice,
                                                   int cabac_init_idc, int slice_qp) {
  CabacContexts ctxs;
  ctxs.init(intra_slice, cabac_init_idc, slice_qp);
  CabacEncoder enc;
  size_t ev = 0;
  const size_t n_ev = ss.events.size();
  size_t next_ev_at = ev < n_ev ? ss.events[ev].at : SIZE_MAX;
  for (size_t i = 0; i <= ss.bins.size(); ++i) {
    while (i == next_ev_at) {
      if (ss.events[ev].type == kEvPcm)
        enc.pcm_bytes(ss.pcm.data() + ss.events[ev].a, size_t(ss.events[ev].b),
                      uint32_t(ss.events[ev].c), ss.events[ev].d);
      ++ev;
      next_ev_at = ev < n_ev ? ss.events[ev].at : SIZE_MAX;
    }
    if (i == ss.bins.size()) break;
    const auto& b = ss.bins[i];
    if (b.ctx == kCtxBypass) enc.encode_bypass(b.bin);
    else if (b.ctx == kCtxTerminate) enc.encode_terminate(b.bin);
    else enc.encode_decision(ctxs, b.ctx, b.bin);
  }
  return enc.take_bytes();
}

}  // namespace artc
