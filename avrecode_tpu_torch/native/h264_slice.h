// CABAC macroblock-layer syntax walker (ITU-T H.264 clauses 7.3.5, 7.4.5,
// 9.3.2, 9.3.3). Decodes (or, driven by a model, replays) every CABAC bin of a
// slice in spec order, maintaining exactly the neighbor state the *entropy*
// layer needs — no pixel reconstruction, motion compensation, or deblocking.
//
// Reference parity: this replaces the forked-ffmpeg H.264 decoder the
// reference drives via hooks (reference recode.cpp:74-230 + SURVEY.md
// Appendix A). The IO template parameter plays the role of the reference's
// AVCodecHooks table: compress wraps a spec CABAC decoder and records symbols
// (reference compressor::cabac_decoder, recode.cpp:1134-1268); decompress
// wraps the recoded-stream model and a CABAC re-encoder (reference
// decompressor::cabac_decoder, recode.cpp:1411-1520), with no surrogate
// stream needed because the walker is ours.
//
// IO concept:
//   int decision(int ctx, BinKlass klass);   // context-coded bin
//   int bypass(BinKlass klass);              // bypass bin
//   int terminate();                          // end_of_slice / I_PCM bin
//   int sig_bin(int ctx, int pos);           // significant_coeff_flag
//   int eob_bin(int ctx, int pos);           // last_significant_coeff_flag
//   int res_bin(int ctx, int pos);           // coeff_abs_level_minus1 decision
//   void implicit_sig_last(int pos);         // forced-significant final coeff
//   void pcm_block(int n_bytes);             // I_PCM raw samples (align+reinit)
//   void begin_mb(int mb_x, int mb_y);
//   void begin_block(int slot, int cat, int max_coeff);
//   void end_block();
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "h264_params.h"
#include "h264_tables.h"
#include "gen/cabac_tables.h"

namespace artc {

enum BinKlass : uint8_t {
  kKlassOther = 0,     // headers, modes, cbf, mvd prefix, ...
  kKlassSig = 1,       // significant_coeff_flag   (reference PIP_SIGNIFICANCE_MAP)
  kKlassEob = 2,       // last_significant_coeff_flag (reference PIP_SIGNIFICANCE_EOB)
  kKlassRes = 3,       // coeff_abs_level_minus1 decision bins (reference PIP_RESIDUALS)
  kKlassBypassOther = 4,
  kKlassBypassRes = 5,  // level UEG0 suffix bits
  kKlassTerminate = 6,
  kKlassSign = 7,       // coeff_sign_flag
  kKlassCbf = 8,        // coded_block_flag
  kKlassSkip = 9,       // mb_skip_flag
  kKlassMvdSign = 10,   // mvd_sign_flag, keyed on the neighbor-mvd sign (v23)
  kNumBinKlasses = 11,
};

// Per-macroblock entropy-relevant state (our equivalent of the reference's
// BlockMeta, reference block.h:9-23, but actually populated).
struct MBInfo {
  uint16_t slice_id = 0xffff;  // 0xffff = not yet decoded
  uint8_t intra = 0;           // any intra type
  uint8_t i16 = 0;             // Intra_16x16
  uint8_t pcm = 0;
  uint8_t skip = 0;            // P_Skip / B_Skip
  uint8_t direct_or_skip = 0;  // B_Skip or B_Direct_16x16 (for B mb_type ctx)
  uint8_t transform8x8 = 0;
  uint8_t field = 0;           // MBAFF: this MB pair is field-coded
  uint8_t cbp_luma = 0;        // 4 bits, one per 8x8
  uint8_t cbp_chroma = 0;      // 0..2
  uint8_t chroma_pred_nonzero = 0;
  uint8_t qp_delta_nonzero = 0;
  // coded_block_flag storage: bits 0-15 luma 4x4 by grid pos (x + 4*y);
  // bit 16 luma DC; bits 17-18 chroma DC (u,v); bits 19+ chroma AC at
  // 19 + comp*8 + (cx + 2*cy) (cy 0..1 for 4:2:0, 0..3 for 4:2:2).
  uint64_t cbf = 0;
  // Signed mvd per list per 4x4 grid pos per component (ctx formation uses
  // the absolute value via abs_mvd_at; v23 sign keys use the sign).
  int16_t mvd[2][16][2];
  // ref_idx per list per 8x8 (raster); -1 = list unused for that partition.
  int8_t ref[2][4];

  MBInfo() { clear(); }
  void clear() {
    slice_id = 0xffff;
    intra = i16 = pcm = skip = direct_or_skip = transform8x8 = field = 0;
    cbp_luma = cbp_chroma = chroma_pred_nonzero = qp_delta_nonzero = 0;
    cbf = 0;
    std::memset(mvd, 0, sizeof(mvd));
    ref[0][0] = ref[0][1] = ref[0][2] = ref[0][3] = -1;
    ref[1][0] = ref[1][1] = ref[1][2] = ref[1][3] = -1;
  }
};

// Shared across all slices of one picture.
struct PictureState {
  int mb_width = 0, mb_height = 0;
  std::vector<MBInfo> mbs;
  void reset(int w, int h) {
    mb_width = w;
    mb_height = h;
    mbs.assign(size_t(w) * h, MBInfo());
  }
};

template <class IO>
class SliceWalker {
 public:
  SliceWalker(const SPS& sps, const PPS& pps, const SliceHeader& sh, PictureState& pic,
              int slice_id, IO& io)
      : sps_(sps), pps_(pps), sh_(sh), pic_(pic), slice_id_(slice_id), io_(io) {
    if (sps.chroma_format_idc < 0 || sps.chroma_format_idc > 3)
      throw UnsupportedStream("chroma_format not 4:0:0/4:2:0/4:2:2/4:4:4");
    // Monochrome and separate-colour-plane slices share ChromaArrayType == 0
    // semantics: each slice codes one plane with luma-only syntax (no chroma
    // pred mode / cbp / residual; luma-sized I_PCM). Plane isolation needs no
    // extra state: entropy neighbour availability is same-slice (6.4.9) and
    // plane slices carry distinct slice ids.
    is400_ = sps.chroma_format_idc == 0 || sps.separate_colour_plane;
    is444_ = sps.chroma_format_idc == 3 && !sps.separate_colour_plane;
    numc8x8_ = sps.chroma_format_idc == 2 ? 2 : 1;
    // High 10: entropy syntax is depth-agnostic apart from the I_PCM sample
    // width and the (already spec-clamped) negative SliceQPY range.
    if (sps.bit_depth_luma > 14 || sps.bit_depth_chroma > 14)
      throw UnsupportedStream("bit depth > 14");
    int pcm_bits = 256 * sps.bit_depth_luma +
                   (is400_ ? 0 : (is444_ ? 512 : 128 * numc8x8_) * sps.bit_depth_chroma);
    if (pcm_bits % 8) throw UnsupportedStream("unaligned I_PCM payload");
    pcm_bytes_ = pcm_bits / 8;
    mbaff_ = sps.mb_adaptive_frame_field && !sh.field_pic;
    // PAFF field picture: every MB is field-coded (field ctx-table rows) with
    // plain raster addressing; MBAFF-only machinery (pair stepping, ref_idx
    // doubling, mvd unit scaling, mixed-parity neighbor mapping) stays off.
    cur_field_ = sh.field_pic;
  }

  // Walks the whole slice_data(); returns number of macroblocks decoded.
  int run() {
    if (mbaff_) return run_mbaff();
    int mb_addr = sh_.first_mb_in_slice;
    const int num_mbs = pic_.mb_width * pic_.mb_height;
    int count = 0;
    bool prev_qp_delta_nonzero = false;
    while (true) {
      if (mb_addr >= num_mbs) throw BitstreamError("mb address out of range");
      mb_x_ = mb_addr % pic_.mb_width;
      mb_y_ = mb_addr / pic_.mb_width;
      cur_ = &pic_.mbs[mb_addr];
      cur_->clear();
      cur_->slice_id = uint16_t(slice_id_);
      cur_->field = cur_field_;  // PAFF: all MBs field-coded
      io_.begin_mb(mb_x_, mb_y_);

      bool skipped = false;
      if (!sh_.is_intra()) skipped = decode_skip_flag();
      if (skipped) {
        mark_skip(prev_qp_delta_nonzero);
      } else {
        decode_mb_layer(prev_qp_delta_nonzero);
      }
      ++count;
      if (io_.terminate()) break;
      ++mb_addr;
    }
    return count;
  }

 private:
  bool decode_skip_flag() {
    int inc = 0;
    NbLoc a = locate_luma(-1, 0);
    NbLoc b = locate_luma(0, -1);
    if (a.mb && !a.mb->skip) ++inc;
    if (b.mb && !b.mb->skip) ++inc;
    int base = sh_.is_b() ? kCtxMbSkipB : kCtxMbSkipP;
    return io_.decision(base + inc, kKlassSkip) != 0;
  }

  void mark_skip(bool& prev_qp_delta_nonzero) {
    cur_->skip = 1;
    cur_->direct_or_skip = 1;
    if (!sh_.is_b()) cur_->ref[0][0] = cur_->ref[0][1] = cur_->ref[0][2] = cur_->ref[0][3] = 0;
    prev_qp_delta_nonzero = false;
  }

  // MBAFF slice_data() (7.3.4 with MbaffFrameFlag == 1): macroblock pairs,
  // mb_field_decoding_flag coded in the first non-skipped MB of the pair
  // (inferred from the left/above pair when both are skipped, 7.4.4),
  // end_of_slice after the bottom MB only.
  int run_mbaff() {
    int pair_addr = sh_.first_mb_in_slice;  // CurrMbAddr = first_mb * 2
    const int pair_w = pic_.mb_width, pair_h = pic_.mb_height / 2;
    const int num_pairs = pair_w * pair_h;
    int count = 0;
    bool prev_qp_delta_nonzero = false;
    while (true) {
      if (pair_addr >= num_pairs) throw BitstreamError("mb pair address out of range");
      mb_x_ = pair_addr % pair_w;
      int pair_y = pair_addr / pair_w;
      // Speculative field status (7.4.4 inference: left pair, else above).
      const MBInfo* lp = pair_top(mb_x_ - 1, pair_y);
      const MBInfo* ap = pair_top(mb_x_, pair_y - 1);
      cur_field_ = lp ? lp->field != 0 : (ap ? ap->field != 0 : false);
      bool field_known = false;
      bool top_skipped = false;
      for (int bottom = 0; bottom < 2; ++bottom) {
        cur_bottom_ = bottom != 0;
        mb_y_ = 2 * pair_y + bottom;
        cur_ = &pic_.mbs[size_t(mb_y_) * pair_w + mb_x_];
        cur_->clear();
        cur_->slice_id = uint16_t(slice_id_);
        cur_->field = cur_field_;
        io_.begin_mb(mb_x_, mb_y_);
        bool skipped = false;
        if (!sh_.is_intra()) skipped = decode_skip_flag();
        if (skipped) {
          mark_skip(prev_qp_delta_nonzero);
          if (!bottom) top_skipped = true;
        } else {
          if (!field_known && (!bottom || top_skipped)) {
            cur_field_ = decode_mb_field_flag(mb_x_, pair_y);
            field_known = true;
            cur_->field = cur_field_;
            if (bottom)  // retroactively applies to the skipped top MB too
              pic_.mbs[size_t(mb_y_ - 1) * pair_w + mb_x_].field = cur_field_;
          }
          decode_mb_layer(prev_qp_delta_nonzero);
        }
        ++count;
      }
      if (io_.terminate()) break;
      ++pair_addr;
    }
    return count;
  }

  // Top MB of the pair at pair coords (px, py), if available in this slice.
  const MBInfo* pair_top(int px, int py) const {
    if (px < 0 || py < 0 || px >= pic_.mb_width || 2 * py >= pic_.mb_height) return nullptr;
    const MBInfo& m = pic_.mbs[size_t(2 * py) * pic_.mb_width + px];
    return m.slice_id == slice_id_ ? &m : nullptr;
  }

  // mb_field_decoding_flag (9.3.3.1.1.2): ctxIdxInc from the left/above
  // PAIR's field flags.
  bool decode_mb_field_flag(int px, int py) {
    const MBInfo* a = pair_top(px - 1, py);
    const MBInfo* b = pair_top(px, py - 1);
    int inc = (a && a->field ? 1 : 0) + (b && b->field ? 1 : 0);
    return io_.decision(kCtxMbField + inc, kKlassOther) != 0;
  }

  // ---- neighbor access -----------------------------------------------------
  // Returns the MB at (mb_x_+dx, mb_y_+dy) if it exists and belongs to the
  // same slice (clause 6.4.9 availability for entropy decoding). Only valid
  // for non-MBAFF walks; MBAFF goes through locate_luma/locate_chroma.
  const MBInfo* nb_mb(int dx, int dy) const {
    int x = mb_x_ + dx, y = mb_y_ + dy;
    if (x < 0 || y < 0 || x >= pic_.mb_width || y >= pic_.mb_height) return nullptr;
    const MBInfo& m = pic_.mbs[size_t(y) * pic_.mb_width + x];
    if (m.slice_id != slice_id_) return nullptr;  // other/undecoded slice
    return &m;
  }

  struct NbLoc {
    const MBInfo* mb = nullptr;  // null = unavailable
    int lx = 0, ly = 0;          // local luma coords (pixels) within mb
  };

  // Neighbouring-location derivation (6.4.12): the MB (and local coords)
  // containing the luma sample at (xN, yN) relative to the current MB's
  // top-left, in the current MB's own frame/field geometry. Only the A/B
  // offsets CABAC needs arise: xN >= -1, yN >= -1, not both negative.
  NbLoc locate_luma(int xN, int yN) const {
    if (!mbaff_) {
      int dx = 0, dy = 0;
      if (xN < 0) { dx = -1; xN += 16; }
      if (yN < 0) { dy = -1; yN += 16; }
      if (dx != 0 && dy != 0) return {};
      const MBInfo* m = (dx == 0 && dy == 0) ? cur_ : nb_mb(dx, dy);
      if (!m) return {};
      return {m, xN, yN};
    }
    return locate_mbaff(xN, yN, 16);
  }

  // Chroma-plane variant: mbh = chroma MB height in samples (8 for 4:2:0,
  // 16 for 4:2:2). Same member-selection rules in the chroma grid (6.4.12.2
  // applies to any plane via MbHeightC).
  NbLoc locate_chroma(int xN, int yN, int mbh) const {
    if (!mbaff_) {
      int dx = 0, dy = 0;
      if (xN < 0) { dx = -1; xN += 8; }
      if (yN < 0) { dy = -1; yN += mbh; }
      if (dx != 0 && dy != 0) return {};
      const MBInfo* m = (dx == 0 && dy == 0) ? cur_ : nb_mb(dx, dy);
      if (!m) return {};
      return {m, xN, yN};
    }
    return locate_mbaff(xN, yN, mbh, 8);
  }

  // MBAFF branch of 6.4.12.2, derived in pair-region sample space: a pair
  // covers 2*mbh rows; frame members split them 0..mbh-1 / mbh..2*mbh-1,
  // field members by row parity. Verified byte-exact against x264 MBAFF
  // streams (the tests' mbaff corpus).
  NbLoc locate_mbaff(int xN, int yN, int mbh, int mbw = 16) const {
    const int pw = pic_.mb_width;
    const int py = mb_y_ >> 1;
    const bool cf = cur_field_;
    const bool bot = cur_bottom_;
    // Row of this MB's sample yN within the pair region (frame rows).
    auto pair_row = [&](int y) { return cf ? (2 * y + (bot ? 1 : 0)) : (mbh * (bot ? 1 : 0) + y); };
    if (xN >= 0 && yN >= 0) {
      if (yN < mbh) return {cur_, xN, yN};
      return {};
    }
    if (xN < 0) {
      if (yN < 0) return {};  // diagonal neighbors never arise here
      // Left neighbor: pair (mb_x_-1, py).
      const MBInfo* ltop = pair_top(mb_x_ - 1, py);
      if (!ltop) return {};
      int gy = pair_row(yN);
      bool nf = ltop->field != 0;
      int member, ym;
      if (nf) { member = gy & 1; ym = gy >> 1; }
      else { member = gy >= mbh ? 1 : 0; ym = gy - member * mbh; }
      return {ltop + size_t(member) * pw, xN + mbw, ym};
    }
    // Above neighbor: one row up in the current MB's own geometry.
    int gy = pair_row(0) + (cf ? 2 * yN : yN);  // yN == -1
    if (gy >= 0) {
      // Still inside the current pair (frame bottom MB -> own pair top).
      int member, ym;
      if (cf) { member = gy & 1; ym = gy >> 1; }
      else { member = gy >= mbh ? 1 : 0; ym = gy - member * mbh; }
      const MBInfo* m = &pic_.mbs[size_t(2 * py + member) * pw + mb_x_];
      if (m->slice_id != slice_id_) return {};
      return {m, xN, ym};
    }
    const MBInfo* atop = pair_top(mb_x_, py - 1);
    if (!atop) return {};
    int gy2 = gy + 2 * mbh;
    bool nf = atop->field != 0;
    int member, ym;
    if (nf) { member = gy2 & 1; ym = gy2 >> 1; }
    else { member = gy2 >= mbh ? 1 : 0; ym = gy2 - member * mbh; }
    return {atop + size_t(member) * pw, xN, ym};
  }

  // ---- mb_type ------------------------------------------------------------
  // Intra mb_type tree shared by I/P/B (ffmpeg-equivalent value-based context
  // selection validated against conformant streams). Returns 0 = I_NxN,
  // 1..24 = I_16x16 (value = 1 + pred + 4*cbpc + 12*(cbpl!=0)), 25 = I_PCM.
  int decode_intra_mb_type(int ctx_base, bool intra_slice) {
    int state = ctx_base;
    if (intra_slice) {
      int inc = 0;
      const MBInfo* a = locate_luma(-1, 0).mb;
      const MBInfo* b = locate_luma(0, -1).mb;
      if (a && (a->i16 || a->pcm)) ++inc;
      if (b && (b->i16 || b->pcm)) ++inc;
      if (io_.decision(state + inc, kKlassOther) == 0) return 0;
      state += 2;
    } else {
      if (io_.decision(state, kKlassOther) == 0) return 0;
    }
    if (io_.terminate(/*end_of_slice=*/false)) return 25;  // I_PCM
    int mb_type = 1;
    mb_type += 12 * io_.decision(state + 1, kKlassOther);
    if (io_.decision(state + 2, kKlassOther))
      mb_type += 4 + 4 * io_.decision(state + 2 + (intra_slice ? 1 : 0), kKlassOther);
    mb_type += 2 * io_.decision(state + 3 + (intra_slice ? 1 : 0), kKlassOther);
    mb_type += io_.decision(state + 3 + 2 * (intra_slice ? 1 : 0), kKlassOther);
    return mb_type;
  }

  // P-slice mb_type: 0=P_L0_16x16, 1=P_L0_16x8, 2=P_L0_8x16, 3=P_8x8,
  // 5.. = intra (value-5 as intra code above).
  int decode_p_mb_type() {
    if (io_.decision(kCtxMbTypeP, kKlassOther) == 0) {
      if (io_.decision(kCtxMbTypeP + 1, kKlassOther) == 0)
        return 3 * io_.decision(kCtxMbTypeP + 2, kKlassOther);
      return 2 - io_.decision(kCtxMbTypeP + 3, kKlassOther);
    }
    return 5 + decode_intra_mb_type(17, false);
  }

  // B-slice mb_type: 0=B_Direct_16x16, 1..21 two-partition table, 22=B_8x8,
  // 23.. = intra (value-23).
  int decode_b_mb_type() {
    int inc = 0;
    const MBInfo* a = locate_luma(-1, 0).mb;
    const MBInfo* b = locate_luma(0, -1).mb;
    if (a && !a->direct_or_skip) ++inc;
    if (b && !b->direct_or_skip) ++inc;
    if (!io_.decision(kCtxMbTypeB + inc, kKlassOther)) return 0;  // B_Direct_16x16
    if (!io_.decision(kCtxMbTypeB + 3, kKlassOther))
      return 1 + io_.decision(kCtxMbTypeB + 5, kKlassOther);  // B_L0/L1_16x16
    int bits = io_.decision(kCtxMbTypeB + 4, kKlassOther) << 3;
    bits |= io_.decision(kCtxMbTypeB + 5, kKlassOther) << 2;
    bits |= io_.decision(kCtxMbTypeB + 5, kKlassOther) << 1;
    bits |= io_.decision(kCtxMbTypeB + 5, kKlassOther);
    if (bits < 8) return bits + 3;
    if (bits == 13) return 23 + decode_intra_mb_type(32, false);
    if (bits == 14) return 11;  // B_L1_L0_8x16
    if (bits == 15) return 22;  // B_8x8
    bits = (bits << 1) | io_.decision(kCtxMbTypeB + 5, kKlassOther);
    return bits - 4;  // 12..21
  }

  // P sub_mb_type (Table 7-17): 0=L0_8x8, 1=L0_8x4, 2=L0_4x8, 3=L0_4x4.
  int decode_p_sub_mb_type() {
    if (io_.decision(kCtxSubMbTypeP, kKlassOther)) return 0;
    if (!io_.decision(kCtxSubMbTypeP + 1, kKlassOther)) return 1;
    if (io_.decision(kCtxSubMbTypeP + 2, kKlassOther)) return 2;
    return 3;
  }

  // B sub_mb_type (Table 7-18): 0=Direct_8x8, 1=L0_8x8, 2=L1_8x8, 3=Bi_8x8,
  // 4=L0_8x4, 5=L0_4x8, 6=L1_8x4, 7=L1_4x8, 8=Bi_8x4, 9=Bi_4x8,
  // 10=L0_4x4, 11=L1_4x4, 12=Bi_4x4.
  int decode_b_sub_mb_type() {
    if (!io_.decision(kCtxSubMbTypeB, kKlassOther)) return 0;
    if (!io_.decision(kCtxSubMbTypeB + 1, kKlassOther))
      return 1 + io_.decision(kCtxSubMbTypeB + 3, kKlassOther);
    int type = 3;
    if (io_.decision(kCtxSubMbTypeB + 2, kKlassOther)) {
      if (io_.decision(kCtxSubMbTypeB + 3, kKlassOther))
        return 11 + io_.decision(kCtxSubMbTypeB + 3, kKlassOther);
      type += 4;
    }
    type += 2 * io_.decision(kCtxSubMbTypeB + 3, kKlassOther);
    type += io_.decision(kCtxSubMbTypeB + 3, kKlassOther);
    return type;
  }

  // ---- motion syntax ------------------------------------------------------
  // ref_idx (9.3.2.6 unary, 9.3.3.1.1.6 ctx). (bx,by): partition top-left in
  // 4x4 grid units.
  int decode_ref_idx(int list, int bx, int by) {
    int inc = ref_ctx_flag(list, bx - 1, by) + 2 * ref_ctx_flag(list, bx, by - 1);
    if (!io_.decision(kCtxRefIdx + inc, kKlassOther)) return 0;
    int val = 1;
    while (io_.decision(kCtxRefIdx + (val == 1 ? 4 : 5), kKlassOther)) {
      if (++val > 32) throw BitstreamError("ref_idx too large");
    }
    return val;
  }

  // refIdxZeroFlagN-based condTermFlagN for a neighbor 4x4 at grid (gx,gy)
  // (may be outside the MB). MBAFF (9.3.3.1.1.6): a field neighbor of a
  // frame MB has doubled reference indices, so "nonzero" means > 1 there.
  int ref_ctx_flag(int list, int gx, int gy) const {
    NbLoc n = locate_luma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy);
    const MBInfo* m = n.mb;
    if (!m) return 0;
    if (m->intra || m->skip) return 0;
    int b8 = ((n.lx >> 3) & 1) + 2 * ((n.ly >> 3) & 1);
    // B_Direct_16x16 / direct 8x8 partitions store ref = -1 (list unused).
    int r = m->ref[list][b8];
    int thresh = (mbaff_ && !cur_field_ && m->field) ? 1 : 0;
    return r > thresh ? 1 : 0;
  }

  // Effective reference list size: a FIELD macroblock of an MBAFF frame
  // addresses twice as many (field) references (7.4.5.2), so ref_idx is
  // coded even when the slice's active count is 1.
  int eff_num_ref(int list) const {
    int nref = list ? sh_.num_ref_idx_l1_active : sh_.num_ref_idx_l0_active;
    return (mbaff_ && cur_field_) ? 2 * nref : nref;
  }

  // Fine |mvd| neighbor-sum bucket for the learned-estimator keys (the aux
  // side-channel; model.h kMvdAuxBase). CABAC's own ctxIdxInc 3-buckets only
  // the first bin and leaves the prefix bins unconditioned; the learned bank
  // benefits from 8 buckets on every bin while the mirror keeps the real ctx.
  static int mvd_aux_bucket(int sum) {
    return sum == 0 ? 0
           : sum <= 1 ? 1
           : sum <= 2 ? 2
           : sum <= 4 ? 3
           : sum <= 8 ? 4
           : sum <= 16 ? 5
           : sum <= 32 ? 6
                       : 7;
  }

  // mvd (9.3.2.3 UEG3 uCoff=9 + sign, 9.3.3.1.1.7 ctx). comp: 0=x,1=y.
  int decode_mvd(int list, int comp, int bx, int by) {
    int sum = abs_mvd_at(list, comp, bx - 1, by) + abs_mvd_at(list, comp, bx, by - 1);
    int inc = sum < 3 ? 0 : (sum > 32 ? 2 : 1);
    int aux = mvd_aux_bucket(sum);
    int base = comp ? kCtxMvdY : kCtxMvdX;
    if (!io_.decision(base + inc, kKlassOther, aux)) return 0;
    int val = 1;
    while (val < 9) {
      int off = 3 + (val < 4 ? val - 1 : 3);  // binIdx 1,2,3 -> +3,+4,+5; >=4 -> +6
      if (!io_.decision(base + off, kKlassOther, aux)) break;
      ++val;
    }
    if (val == 9) {  // EG3 suffix, bypass (exponent bins keyed by index, v21)
      int k = 3;
      while (io_.bypass(kKlassBypassOther, k - 3)) {
        val += 1 << k;
        if (++k > 24) throw BitstreamError("mvd suffix too long");
      }
      while (k--) val += io_.bypass(kKlassBypassOther) << k;
    }
    // Motion fields are smooth: the mvd sign correlates with the neighbors'
    // signed mvd (v23/v24). Key the sign bypass bin on (component, sign of
    // the neighbor sum, |mvd| neighbor strength) — strong neighbors predict
    // the sign more reliably. 12 slow estimators per slice class.
    int ss = mvd_sign_at(list, comp, bx - 1, by) + mvd_sign_at(list, comp, bx, by - 1);
    int cls = ss < 0 ? 0 : (ss > 0 ? 2 : 1);
    if (io_.bypass(kKlassMvdSign, (comp * 3 + cls) * 2 + (sum >= 4 ? 1 : 0))) val = -val;
    return val;
  }

  int mvd_sign_at(int list, int comp, int gx, int gy) const {
    NbLoc n = locate_luma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy);
    const MBInfo* m = n.mb;
    if (!m || m->intra || m->skip) return 0;
    int v = m->mvd[list][(n.lx >> 2) + 4 * (n.ly >> 2)][comp];
    return v > 0 ? 1 : (v < 0 ? -1 : 0);  // unit scaling cannot flip a sign
  }

  int abs_mvd_at(int list, int comp, int gx, int gy) const {
    NbLoc n = locate_luma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy);
    const MBInfo* m = n.mb;
    if (!m) return 0;
    if (m->intra || m->skip) return 0;
    int v = m->mvd[list][(n.lx >> 2) + 4 * (n.ly >> 2)][comp];
    v = v < 0 ? -v : v;
    // MBAFF vertical-mvd unit conversion (9.3.3.1.1.7): field rows are half
    // frame rows, so a frame neighbor's vertical mvd halves into field units
    // and a field neighbor's doubles into frame units.
    if (mbaff_ && comp == 1 && m->field != uint8_t(cur_field_))
      v = cur_field_ ? v / 2 : v * 2;
    return v;
  }

  // ---- macroblock layer ---------------------------------------------------
  void decode_mb_layer(bool& prev_qp_delta_nonzero) {
    int mb_type;
    bool is_intra_mb = false;
    int intra_code = -1;  // 0=I_NxN, 1..24=I16, 25=PCM
    int inter_type = -1;
    if (sh_.is_intra()) {
      intra_code = decode_intra_mb_type(kCtxMbTypeI, true);
      is_intra_mb = true;
    } else if (sh_.is_p()) {
      mb_type = decode_p_mb_type();
      if (mb_type >= 5) { is_intra_mb = true; intra_code = mb_type - 5; }
      else inter_type = mb_type;
    } else {
      mb_type = decode_b_mb_type();
      if (mb_type >= 23) { is_intra_mb = true; intra_code = mb_type - 23; }
      else inter_type = mb_type;
    }

    int cbp_luma = 0, cbp_chroma = 0;
    bool i16 = false;
    if (is_intra_mb) {
      cur_->intra = 1;
      if (intra_code == 25) {
        // I_PCM (7.3.5): raw samples follow the mb_type terminate bin after
        // byte alignment; no pred modes, cbp, qp_delta, or residual syntax.
        // Neighbor contexts treat PCM as fully-coded via cur_->pcm.
        cur_->pcm = 1;
        io_.pcm_block(pcm_bytes_);
        prev_qp_delta_nonzero = false;
        return;
      }
      if (intra_code > 0) {
        i16 = true;
        cur_->i16 = 1;
        int v = intra_code - 1;
        cbp_luma = (v >= 12) ? 0xf : 0;
        // ChromaArrayType 0: CodedBlockPatternChroma is derived as 0 — no
        // chroma residual exists regardless of the I16 type's cbpc field.
        cbp_chroma = is400_ ? 0 : (v % 12) / 4;
      }
    }

    // transform_size_8x8_flag for I_NxN comes before intra pred modes.
    bool t8x8 = false;
    if (is_intra_mb && intra_code == 0) {
      if (pps_.transform_8x8_mode) t8x8 = decode_transform8x8();
      cur_->transform8x8 = t8x8;
      // Intra pred modes: 4 (8x8) or 16 (4x4) prev/rem pairs; values are
      // pixel-prediction only — no entropy state needed beyond the bins.
      int n = t8x8 ? 4 : 16;
      for (int i = 0; i < n; ++i) {
        if (!io_.decision(kCtxIntra4x4PredFlag, kKlassOther)) {
          // rem_intra_pred_mode: the spec codes all 3 FL bins under ONE
          // context; the model keys them on the binary-tree node (aux) so
          // the full 8-value rem distribution is learned (v20).
          int node = 1;
          for (int b = 0; b < 3; ++b)
            node = (node << 1) | io_.decision(kCtxIntra4x4PredRem, kKlassOther, node);
        }
      }
    }
    if (is_intra_mb && !is444_ && !is400_) decode_chroma_pred_mode();

    bool no_small_parts = true;  // NoSubMbPartSizeLessThan8x8Flag
    if (!is_intra_mb) {
      if (sh_.is_b() && inter_type == 0) {
        // B_Direct_16x16: no motion syntax.
        cur_->direct_or_skip = 1;
        no_small_parts = sps_.direct_8x8_inference;
      } else if (inter_type == (sh_.is_p() ? 3 : 22)) {
        no_small_parts = decode_sub_mb_pred();
      } else {
        decode_mb_pred(inter_type);
      }
    }

    if (!i16) {
      cbp_luma = decode_cbp_luma();
      cbp_chroma = (is444_ || is400_) ? 0 : decode_cbp_chroma();
      if (cbp_luma && pps_.transform_8x8_mode && !is_intra_mb && no_small_parts &&
          (inter_type != 0 || sps_.direct_8x8_inference)) {
        t8x8 = decode_transform8x8();
        cur_->transform8x8 = t8x8;
      }
    }
    cur_->cbp_luma = uint8_t(cbp_luma);
    cur_->cbp_chroma = uint8_t(cbp_chroma);

    if (cbp_luma || cbp_chroma || i16) {
      decode_qp_delta(prev_qp_delta_nonzero);
      if (is444_) decode_residual_444(i16, cbp_luma, t8x8);
      else decode_residual(i16, cbp_luma, cbp_chroma, t8x8);
    } else {
      prev_qp_delta_nonzero = false;
    }
  }

  bool decode_transform8x8() {
    const MBInfo* a = locate_luma(-1, 0).mb;
    const MBInfo* b = locate_luma(0, -1).mb;
    int inc = (a && a->transform8x8 ? 1 : 0) + (b && b->transform8x8 ? 1 : 0);
    return io_.decision(kCtxTransform8x8 + inc, kKlassOther) != 0;
  }

  void decode_chroma_pred_mode() {
    const MBInfo* a = locate_luma(-1, 0).mb;
    const MBInfo* b = locate_luma(0, -1).mb;
    int inc = (a && a->chroma_pred_nonzero ? 1 : 0) + (b && b->chroma_pred_nonzero ? 1 : 0);
    int mode = 0;
    if (io_.decision(kCtxChromaPred + inc, kKlassOther)) {
      mode = 1;
      if (io_.decision(kCtxChromaPred + 3, kKlassOther)) {
        mode = 2 + io_.decision(kCtxChromaPred + 3, kKlassOther);
      }
    }
    cur_->chroma_pred_nonzero = mode != 0;
  }

  void decode_mb_pred(int inter_type) {
    // Partition layout per slice type (Table 7-13/7-14).
    struct Part { int bx, by, w, h; int pred; };  // pred: bit0 L0, bit1 L1
    Part parts[2];
    int nparts = 1;
    if (sh_.is_p()) {
      switch (inter_type) {
        case 0: parts[0] = {0, 0, 4, 4, 1}; nparts = 1; break;
        case 1: parts[0] = {0, 0, 4, 2, 1}; parts[1] = {0, 2, 4, 2, 1}; nparts = 2; break;
        case 2: parts[0] = {0, 0, 2, 4, 1}; parts[1] = {2, 0, 2, 4, 1}; nparts = 2; break;
        default: throw BitstreamError("bad P partition type");
      }
    } else {
      // B types 1..21 (Table 7-14). pred codes: 1=L0, 2=L1, 3=Bi.
      static const int8_t kBPred[21][2] = {
          {1, 0}, {2, 0}, {3, 0},                          // 16x16 L0/L1/Bi
          {1, 1}, {1, 1}, {2, 2}, {2, 2}, {1, 2}, {1, 2},  // 4..9
          {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},  // 10..15
          {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3},  // 16..21
      };
      int t = inter_type - 1;
      if (t < 0 || t >= 21) throw BitstreamError("bad B partition type");
      if (t < 3) {
        parts[0] = {0, 0, 4, 4, kBPred[t][0]};
        nparts = 1;
      } else {
        bool vert = (inter_type & 1) != 0;  // odd types 5,7,..,21 are 8x16
        if (vert) {
          parts[0] = {0, 0, 2, 4, kBPred[t][0]};
          parts[1] = {2, 0, 2, 4, kBPred[t][1]};
        } else {
          parts[0] = {0, 0, 4, 2, kBPred[t][0]};
          parts[1] = {0, 2, 4, 2, kBPred[t][1]};
        }
        nparts = 2;
      }
    }

    // ref_idx: all L0 then all L1; commit each immediately (a later partition's
    // context may reference an earlier partition of this same MB).
    for (int list = 0; list < 2; ++list) {
      int nref = eff_num_ref(list);
      for (int p = 0; p < nparts; ++p) {
        if (!(parts[p].pred & (1 << list))) continue;
        int r = (nref > 1) ? decode_ref_idx(list, parts[p].bx, parts[p].by) : 0;
        for (int y = parts[p].by; y < parts[p].by + parts[p].h; y += 2)
          for (int x = parts[p].bx; x < parts[p].bx + parts[p].w; x += 2)
            cur_->ref[list][(x >> 1) + 2 * (y >> 1)] = int8_t(r);
      }
    }

    for (int list = 0; list < 2; ++list)
      for (int p = 0; p < nparts; ++p) {
        if (!(parts[p].pred & (1 << list))) continue;
        int mx = decode_mvd(list, 0, parts[p].bx, parts[p].by);
        int my = decode_mvd(list, 1, parts[p].bx, parts[p].by);
        for (int y = parts[p].by; y < parts[p].by + parts[p].h; ++y)
          for (int x = parts[p].bx; x < parts[p].bx + parts[p].w; ++x) {
            cur_->mvd[list][x + 4 * y][0] = int16_t(mx);
            cur_->mvd[list][x + 4 * y][1] = int16_t(my);
          }
      }
  }

  // P_8x8 / B_8x8. Returns NoSubMbPartSizeLessThan8x8Flag.
  bool decode_sub_mb_pred() {
    int sub[4];
    bool no_small = true;
    for (int i = 0; i < 4; ++i) {
      sub[i] = sh_.is_b() ? decode_b_sub_mb_type() : decode_p_sub_mb_type();
      if (sh_.is_b()) {
        if (sub[i] == 0) {
          if (!sps_.direct_8x8_inference) no_small = false;
        } else if (sub[i] >= 4) {
          no_small = false;
        }
      } else if (sub[i] != 0) {
        no_small = false;
      }
    }
    // pred usage per sub block. B sub types: pred bit0=L0, bit1=L1.
    auto sub_pred = [&](int s) -> int {
      if (!sh_.is_b()) return 1;
      static const int8_t kPred[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
      return kPred[s];
    };
    // Sub-partition geometry: list of (dx,dy,w,h) in 4x4 units within the 8x8.
    auto sub_parts = [&](int s, int (*out)[4]) -> int {
      if (!sh_.is_b()) {
        switch (s) {
          case 0: out[0][0]=0; out[0][1]=0; out[0][2]=2; out[0][3]=2; return 1;
          case 1: out[0][0]=0; out[0][1]=0; out[0][2]=2; out[0][3]=1;
                  out[1][0]=0; out[1][1]=1; out[1][2]=2; out[1][3]=1; return 2;
          case 2: out[0][0]=0; out[0][1]=0; out[0][2]=1; out[0][3]=2;
                  out[1][0]=1; out[1][1]=0; out[1][2]=1; out[1][3]=2; return 2;
          default:
            for (int k = 0; k < 4; ++k) { out[k][0]=k&1; out[k][1]=k>>1; out[k][2]=1; out[k][3]=1; }
            return 4;
        }
      }
      // B (Table 7-18): 1..3 -> 8x8; 4,6,8 -> 8x4; 5,7,9 -> 4x8; 10..12 -> 4x4.
      if (s <= 3) { out[0][0]=0; out[0][1]=0; out[0][2]=2; out[0][3]=2; return 1; }
      if (s == 4 || s == 6 || s == 8) {
        out[0][0]=0; out[0][1]=0; out[0][2]=2; out[0][3]=1;
        out[1][0]=0; out[1][1]=1; out[1][2]=2; out[1][3]=1; return 2;
      }
      if (s == 5 || s == 7 || s == 9) {
        out[0][0]=0; out[0][1]=0; out[0][2]=1; out[0][3]=2;
        out[1][0]=1; out[1][1]=0; out[1][2]=1; out[1][3]=2; return 2;
      }
      for (int k = 0; k < 4; ++k) { out[k][0]=k&1; out[k][1]=k>>1; out[k][2]=1; out[k][3]=1; }
      return 4;
    };

    // ref_idx: all L0 then all L1; commit each immediately (later 8x8s'
    // contexts may reference earlier 8x8s of this same MB).
    for (int list = 0; list < 2; ++list) {
      int nref = eff_num_ref(list);
      for (int i = 0; i < 4; ++i) {
        bool direct = sh_.is_b() && sub[i] == 0;
        if (direct || !(sub_pred(sub[i]) & (1 << list))) continue;
        int bx = 2 * kBlk8x8X[i], by = 2 * kBlk8x8Y[i];
        int r = (nref > 1) ? decode_ref_idx(list, bx, by) : 0;
        cur_->ref[list][kBlk8x8X[i] + 2 * kBlk8x8Y[i]] = int8_t(r);
      }
    }

    for (int list = 0; list < 2; ++list)
      for (int i = 0; i < 4; ++i) {
        bool direct = sh_.is_b() && sub[i] == 0;
        if (direct || !(sub_pred(sub[i]) & (1 << list))) continue;
        int parts[4][4];
        int np = sub_parts(sub[i], parts);
        int bx0 = 2 * kBlk8x8X[i], by0 = 2 * kBlk8x8Y[i];
        for (int p = 0; p < np; ++p) {
          int bx = bx0 + parts[p][0], by = by0 + parts[p][1];
          int mx = decode_mvd(list, 0, bx, by);
          int my = decode_mvd(list, 1, bx, by);
          for (int y = by; y < by + parts[p][3]; ++y)
            for (int x = bx; x < bx + parts[p][2]; ++x) {
              cur_->mvd[list][x + 4 * y][0] = int16_t(mx);
              cur_->mvd[list][x + 4 * y][1] = int16_t(my);
            }
        }
      }
    return no_small;
  }

  // ---- cbp / qp -----------------------------------------------------------
  // condTermFlagN for one cbp-luma decision (9.3.3.1.1.4 via the 8x8-block
  // neighbor, 6.4.11.2): the neighbor 8x8 containing the sample left of /
  // above the current 8x8's top-left. `partial` = bits decoded so far of the
  // current MB's cbp (in-MB neighbors). Unavailable or I_PCM neighbors act as
  // fully-coded (condTerm 0 under the inverted !(cbp&bit) formulation).
  int cbp_luma_cond(int b8, int partial, bool left) const {
    int x0 = 8 * (b8 & 1), y0 = 8 * (b8 >> 1);
    int xN = left ? x0 - 1 : x0;
    int yN = left ? y0 : y0 - 1;
    if (xN >= 0 && yN >= 0) {
      int bit = (xN >> 3) + 2 * (yN >> 3);
      return !((partial >> bit) & 1);
    }
    NbLoc n = locate_luma(xN, yN);
    if (!n.mb) return 0;  // unavailable -> treated as fully coded
    int cbp = n.mb->pcm ? 0xf : n.mb->cbp_luma;
    int bit = (n.lx >> 3) + 2 * (n.ly >> 3);
    return !((cbp >> bit) & 1);
  }

  int decode_cbp_luma() {
    int cbp = 0;
    for (int b8 = 0; b8 < 4; ++b8) {
      int inc = cbp_luma_cond(b8, cbp, true) + 2 * cbp_luma_cond(b8, cbp, false);
      // aux = the 8x8 index: the model keys the bin on the previous frame's
      // cbp bit for this same 8x8 (v27).
      cbp |= io_.decision(kCtxCbpLuma + inc, kKlassOther, b8) << b8;
    }
    return cbp;
  }

  int decode_cbp_chroma() {
    const MBInfo* a = locate_luma(-1, 0).mb;
    const MBInfo* b = locate_luma(0, -1).mb;
    int ca = a ? (a->pcm ? 2 : a->cbp_chroma) : 0;
    int cb = b ? (b->pcm ? 2 : b->cbp_chroma) : 0;
    int inc = (ca != 0 ? 1 : 0) + 2 * (cb != 0 ? 1 : 0);
    if (!io_.decision(kCtxCbpChroma + inc, kKlassOther)) return 0;
    inc = 4 + (ca == 2 ? 1 : 0) + 2 * (cb == 2 ? 1 : 0);
    return 1 + io_.decision(kCtxCbpChroma + inc, kKlassOther);
  }

  void decode_qp_delta(bool& prev_qp_delta_nonzero) {
    int inc = prev_qp_delta_nonzero ? 1 : 0;
    int val = 0;
    while (io_.decision(kCtxQpDelta + inc, kKlassOther)) {
      inc = (val == 0) ? 2 : 3;
      if (++val > 112) throw BitstreamError("mb_qp_delta too large");
    }
    prev_qp_delta_nonzero = val != 0;
    cur_->qp_delta_nonzero = val != 0;
  }

  // ---- residuals ----------------------------------------------------------
  void decode_residual(bool i16, int cbp_luma, int cbp_chroma, bool t8x8) {
    if (i16) {
      // Luma DC (cat 0) always present for I16x16.
      decode_block(kCatLumaDC, kSlotLumaDC, 16, cbf_ctx_luma_dc(), 16 /*cbf bit*/);
      for (int b8 = 0; b8 < 4; ++b8) {
        for (int k = 0; k < 4; ++k) {
          int blk = 4 * b8 + k;
          if (cbp_luma & (1 << b8))
            decode_block(kCatLumaAC, kSlotLuma4x4 + blk, 15, cbf_ctx_luma4x4(blk),
                         kBlk4x4X[blk] + 4 * kBlk4x4Y[blk]);
        }
      }
    } else {
      for (int b8 = 0; b8 < 4; ++b8) {
        if (!(cbp_luma & (1 << b8))) continue;
        if (t8x8) {
          // 4:2:0: no coded_block_flag for cat 5; cbf inferred 1 and mirrored
          // into the four covered 4x4 grid positions for later neighbors.
          decode_block(kCatLuma8x8, kSlotLuma8x8 + b8, 64, -1, -1);
          for (int k = 0; k < 4; ++k) {
            int gx = 2 * kBlk8x8X[b8] + (k & 1), gy = 2 * kBlk8x8Y[b8] + (k >> 1);
            cur_->cbf |= 1ull << (gx + 4 * gy);
          }
        } else {
          for (int k = 0; k < 4; ++k) {
            int blk = 4 * b8 + k;
            decode_block(kCatLuma4x4, kSlotLuma4x4 + blk, 16, cbf_ctx_luma4x4(blk),
                         kBlk4x4X[blk] + 4 * kBlk4x4Y[blk]);
          }
        }
      }
    }
    if (cbp_chroma) {
      // 4:2:2 (ChromaArrayType 2): NumC8x8 = 2 -> 8-coeff chroma DC blocks
      // and 8 AC blocks per component on a 2x4 grid (7.3.5.3.3).
      int nblk = 4 * numc8x8_;
      for (int c = 0; c < 2; ++c)
        decode_block(kCatChromaDC, kSlotChromaDC + c, nblk, cbf_ctx_chroma_dc(c), 17 + c);
      if (cbp_chroma == 2)
        for (int c = 0; c < 2; ++c)
          for (int k = 0; k < nblk; ++k)
            decode_block(kCatChromaAC, kSlotChromaAC + 8 * c + k, 15,
                         cbf_ctx_chroma_ac(c, k), 19 + 8 * c + k);
    }
  }

  // ChromaArrayType==3: residual_luma() per component; Cb/Cr use cats
  // 6-9/10-13 for contexts but are presented to the MODEL with their luma
  // analogue cats (0/1/2/5) and distinct slots — the model's key/billing
  // space stays 6 cats wide; plane separation rides the slot.
  void decode_residual_444(bool i16, int cbp_luma, bool t8x8) {
    for (int comp = 0; comp < 3; ++comp) {
      int cat_dc = comp == 0 ? kCatLumaDC : 6 + 4 * (comp - 1);
      int cat_ac = cat_dc + 1;
      int cat_4x4 = cat_dc + 2;
      int cat_8x8 = comp == 0 ? kCatLuma8x8 : 9 + 4 * (comp - 1);
      int slot_dc = comp == 0 ? kSlotLumaDC : kSlotPlaneDC + (comp - 1) * 21;
      int slot_4x4 = comp == 0 ? kSlotLuma4x4 : kSlotPlane4x4 + (comp - 1) * 21;
      int slot_8x8 = comp == 0 ? kSlotLuma8x8 : kSlotPlane8x8 + (comp - 1) * 21;
      int bit0 = comp * 17;  // per-plane cbf bits: 0..15 grid, 16 DC
      if (i16) {
        decode_block444(cat_dc, kCatLumaDC, slot_dc, 16, comp, -1, bit0 + 16);
        if (cbp_luma)
          for (int blk = 0; blk < 16; ++blk)
            decode_block444(cat_ac, kCatLumaAC, slot_4x4 + blk, 15, comp, blk,
                            bit0 + kBlk4x4X[blk] + 4 * kBlk4x4Y[blk]);
        continue;
      }
      for (int b8 = 0; b8 < 4; ++b8) {
        if (!(cbp_luma & (1 << b8))) continue;
        if (t8x8) {
          // 4:4:4 codes a real coded_block_flag for 8x8 cats (9.3.3.1.1.9).
          decode_block444(cat_8x8, kCatLuma8x8, slot_8x8 + b8, 64, comp, -2 - b8, -1);
        } else {
          for (int k = 0; k < 4; ++k) {
            int blk = 4 * b8 + k;
            decode_block444(cat_4x4, kCatLuma4x4, slot_4x4 + blk, 16, comp, blk,
                            bit0 + kBlk4x4X[blk] + 4 * kBlk4x4Y[blk]);
          }
        }
      }
    }
  }

  // blk >= 0: 4x4 block index (cbf ctx via grid neighbors); blk == -1: DC
  // (MB-level neighbors); blk == -2-b8: 8x8 block b8.
  void decode_block444(int cat, int model_cat, int slot, int max_coeff, int comp, int blk,
                       int cbf_bit) {
    int bit0 = comp * 17;
    int cbf_ctx_idx;
    if (blk == -1) {
      cbf_ctx_idx = kCbfCtxBase[cat] +
                    cond_mb(locate_luma(-1, 0).mb, 1ull << (bit0 + 16)) +
                    2 * cond_mb(locate_luma(0, -1).mb, 1ull << (bit0 + 16));
    } else if (blk >= 0) {
      int gx = kBlk4x4X[blk], gy = kBlk4x4Y[blk];
      cbf_ctx_idx = kCbfCtxBase[cat] + cond_plane4x4(comp, gx - 1, gy) +
                    2 * cond_plane4x4(comp, gx, gy - 1);
    } else {
      int b8 = -2 - blk;
      int gx = 2 * kBlk8x8X[b8], gy = 2 * kBlk8x8Y[b8];
      cbf_ctx_idx = kCbfCtxBase[cat] + cond_plane8x8(comp, gx - 1, gy) +
                    2 * cond_plane8x8(comp, gx, gy - 1);
    }
    io_.begin_block(slot, model_cat, max_coeff);
    int cbf = io_.decision(cbf_ctx_idx, kKlassCbf);
    if (cbf) {
      if (blk >= 0) cur_->cbf |= 1ull << (bit0 + kBlk4x4X[blk] + 4 * kBlk4x4Y[blk]);
      else if (blk == -1) cur_->cbf |= 1ull << (bit0 + 16);
      else {
        int b8 = -2 - blk;
        for (int k = 0; k < 4; ++k) {
          int gx = 2 * kBlk8x8X[b8] + (k & 1), gy = 2 * kBlk8x8Y[b8] + (k >> 1);
          cur_->cbf |= 1ull << (bit0 + gx + 4 * gy);
        }
      }
      decode_coeffs(cat, max_coeff);
    }
    io_.end_block();
  }

  int cond_plane4x4(int comp, int gx, int gy) const {
    NbLoc n = locate_luma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy);
    if (!n.mb) return cur_->intra ? 1 : 0;
    if (n.mb->pcm) return 1;
    return (n.mb->cbf >> (comp * 17 + (n.lx >> 2) + 4 * (n.ly >> 2))) & 1;
  }

  // condTermFlagN for an 8x8-cat coded_block_flag (9.3.3.1.1.9): the
  // neighboring 8x8 transform block exists only if mbAddrN itself used the
  // 8x8 transform; otherwise condTermFlagN is 0 regardless of its 4x4 cbf.
  int cond_plane8x8(int comp, int gx, int gy) const {
    NbLoc n = locate_luma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy);
    if (!n.mb) return cur_->intra ? 1 : 0;
    if (n.mb->pcm) return 1;
    if (!n.mb->transform8x8) return 0;
    return (n.mb->cbf >> (comp * 17 + (n.lx >> 2) + 4 * (n.ly >> 2))) & 1;
  }

  // coded_block_flag ctxIdxInc helpers (9.3.3.1.1.9). Each returns the full
  // ctxIdx for the block's cbf bin, or the condTerm pieces folded in.
  int cbf_ctx(int cat, int cond_a, int cond_b) const {
    return kCtxCbfBase + 4 * cat + cond_a + 2 * cond_b;
  }
  // condTermFlagN for an MB-level neighbor: PCM -> 1, unavailable ->
  // (current MB intra ? 1 : 0), else the given cbf bit of the neighbor.
  int cond_mb(const MBInfo* n, uint64_t bit_mask) const {
    if (!n) return cur_->intra ? 1 : 0;
    if (n->pcm) return 1;
    return (n->cbf & bit_mask) ? 1 : 0;
  }
  int cbf_ctx_luma_dc() const {
    return cbf_ctx(kCatLumaDC, cond_mb(locate_luma(-1, 0).mb, 1ull << 16),
                   cond_mb(locate_luma(0, -1).mb, 1ull << 16));
  }
  int cbf_ctx_chroma_dc(int c) const {
    return cbf_ctx(kCatChromaDC, cond_mb(locate_luma(-1, 0).mb, 1ull << (17 + c)),
                   cond_mb(locate_luma(0, -1).mb, 1ull << (17 + c)));
  }
  // Luma 4x4 / I16 AC: neighbor 4x4 at grid position; cross-MB wraps to the
  // adjacent MB's opposite column/row (MBAFF-mapped under locate_luma).
  int cbf_ctx_luma4x4(int blk) const {
    int gx = kBlk4x4X[blk], gy = kBlk4x4Y[blk];
    int cat = cur_->i16 ? kCatLumaAC : kCatLuma4x4;
    return cbf_ctx(cat, cond_luma4x4(gx - 1, gy), cond_luma4x4(gx, gy - 1));
  }
  int cond_luma4x4(int gx, int gy) const {
    NbLoc n = locate_luma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy);
    if (!n.mb) return cur_->intra ? 1 : 0;
    if (n.mb->pcm) return 1;
    return (n.mb->cbf >> ((n.lx >> 2) + 4 * (n.ly >> 2))) & 1;
  }
  // Chroma AC: 2x2 grid per component (2x4 for 4:2:2), in chroma samples.
  int cbf_ctx_chroma_ac(int c, int blk) const {
    int gx = blk & 1, gy = blk >> 1;
    return cbf_ctx(kCatChromaAC, cond_chroma_ac(c, gx - 1, gy), cond_chroma_ac(c, gx, gy - 1));
  }
  int cond_chroma_ac(int c, int gx, int gy) const {
    int mbh = 8 * numc8x8_;  // chroma MB height in samples (6.4.11.6)
    NbLoc n = locate_chroma(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy, mbh);
    if (!n.mb) return cur_->intra ? 1 : 0;
    if (n.mb->pcm) return 1;
    return (n.mb->cbf >> (19 + 8 * c + (n.lx >> 2) + 2 * (n.ly >> 2))) & 1;
  }

  // Decode one residual block: coded_block_flag (unless cat 5), significance
  // map with zero-cost-capable EOB bins, then levels in reverse scan order
  // (7.3.5.3.3). cbf_bit: index into cur_->cbf to set, or -1.
  void decode_block(int cat, int slot, int max_coeff, int cbf_ctx_idx, int cbf_bit) {
    io_.begin_block(slot, cat, max_coeff);
    int cbf = 1;
    if (cat != kCatLuma8x8) {
      cbf = io_.decision(cbf_ctx_idx, kKlassCbf);
      if (cbf && cbf_bit >= 0) cur_->cbf |= 1ull << cbf_bit;
    }
    if (cbf) decode_coeffs(cat, max_coeff);
    io_.end_block();
  }

  // Significance map + levels (9.3.3.1.3); cat may be any ctxBlockCat 0..13
  // (cats 6-13 = the ChromaArrayType==3 Cb/Cr banks).
  //
  // Built without loop unswitching. g++ 13.3 at -O3 miscompiles the
  // significance-map loop below once it is inlined into decode_block: it
  // unswitches the loop on the switch that sig_ctx's and last_ctx's tests
  // of cat become (cases 5, 9, 13: cat_is_8x8; case 3: kCatChromaDC), and
  // in the copy for cat outside {5, 9, 13} it drops case 3. A 4:2:2 chroma
  // DC block (NumC8x8 2) then gets the contexts base + pos instead of
  // base + Min(pos / 2, 2) and the decoder loses sync; 4:2:0 is spared
  // only because there pos < 3 and NumC8x8 is 1, where both agree. The
  // code is well defined: native/repro_unswitch.cc reduces it to a
  // standalone program that g++ 13.3 -O3 gets wrong. The attribute also
  // keeps the function out of line, so no caller's unswitching reaches the
  // loop. Defining ARTC_NO_UNSWITCH empty builds the engine without it
  // (tools/host_unswitch.py).
#ifndef ARTC_NO_UNSWITCH
#if defined(__GNUC__) && !defined(__clang__)
#define ARTC_NO_UNSWITCH __attribute__((optimize("no-unswitch-loops")))
#else
#define ARTC_NO_UNSWITCH
#endif
#endif
  ARTC_NO_UNSWITCH void decode_coeffs(int cat, int max_coeff) {
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
    // Levels, reverse scan order (9.3.3.1.3 context state machine).
    int num_eq1 = 0, num_gt1 = 0;
    int abs_base = kAbsCtxBase[cat];
    for (int p = last_pos; p >= 0; --p) {
      if (!sig[p]) continue;
      int ctx0 = (num_gt1 != 0) ? 0 : (num_eq1 + 1 < 4 ? num_eq1 + 1 : 4);
      if (io_.res_bin(abs_base + ctx0, p)) {
        // gt1 ctx clips at 3 for chroma DC (9.3.3.1.3 ctxBlockCat 3) - only
        // reachable with >4 gt1 coeffs, i.e. only in 4:2:2's 8-coeff DC.
        int gt1_cap = (cat == kCatChromaDC) ? 3 : 4;
        int ctx_n = 5 + (num_gt1 < gt1_cap ? num_gt1 : gt1_cap);
        int level = 2;
        while (level < 15 && io_.res_bin(abs_base + ctx_n, p)) ++level;
        if (level == 15) {  // UEG0 suffix (exponent bins keyed by index, v21)
          int k = 0;
          while (io_.bypass(kKlassBypassRes, k)) {
            level += 1 << k;
            if (++k > 24) throw BitstreamError("level suffix too long");
          }
          while (k--) level += io_.bypass(kKlassBypassRes) << k;
        }
        ++num_gt1;
      } else {
        ++num_eq1;
      }
      io_.bypass(kKlassSign);  // coeff_sign_flag
    }
  }

  static bool cat_is_8x8(int cat) { return cat == 5 || cat == 9 || cat == 13; }

  // Field-coded MBs (MBAFF field pairs and every MB of a PAFF field picture)
  // select the field rows of the context-base tables and the field
  // position-class row of the 8x8 offset table (9.3.3.1.3).
  int sig_ctx(int cat, int pos) const {
    int fld = cur_field_ ? 1 : 0;
    if (cat_is_8x8(cat)) return kSigCtxBase[fld][cat] + kSigCoeffFlagOffset8x8[fld][pos];
    if (cat == kCatChromaDC) {
      int p = pos / numc8x8_;  // Min(levelListIdx / NumC8x8, 2), 9.3.3.1.3
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

  const SPS& sps_;
  const PPS& pps_;
  const SliceHeader& sh_;
  PictureState& pic_;
  int slice_id_;
  int numc8x8_ = 1;  // 1 = 4:2:0, 2 = 4:2:2
  int pcm_bytes_ = 384;  // I_PCM payload size (bit-depth dependent)
  IO& io_;
  int mb_x_ = 0, mb_y_ = 0;
  bool is444_ = false;
  bool is400_ = false;
  bool mbaff_ = false;
  bool cur_bottom_ = false;  // MBAFF: bottom MB of the current pair
  bool cur_field_ = false;   // MBAFF: current pair is field-coded (or inferred)
  MBInfo* cur_ = nullptr;
};

}  // namespace artc
