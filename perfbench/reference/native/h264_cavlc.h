// CAVLC entropy-layer syntax engine (ITU-T H.264 clauses 7.3.5 with
// entropy_coding_mode_flag == 0, 9.1, 9.2).
//
// Capability extension over the reference: avrecode passes CAVLC slices
// through uncompressed (its hooks only fire on CABAC init — reference
// recode.cpp:143, 1275; SURVEY.md §7 M6). Here CAVLC slices are fully
// re-coded: the walker decodes every syntax VALUE, the model transports the
// values through adaptive binary estimators + rANS, and the writer
// regenerates the original bitstream bit-exactly (VLC codes are canonical,
// so value-level transport suffices; compress-time verification guards any
// encoder quirk).
//
// Scope (baseline/main/extended/high/high10/high422/high444 CAVLC):
// progressive frames, PAFF field pictures, and MBAFF frames; 4:0:0 / 4:2:0 /
// 4:2:2 / 4:4:4 chroma (+ separate colour planes); bit depths to 14;
// I/P/SP/B slices (all partition types incl. B_8x8/direct); 4x4 and 8x8
// transforms; I_PCM. Only FMO and SI slices fall back to passthrough (see
// docs/ARCHITECTURE.md — libavcodec cannot decode those at all).
//
// VIO concept (value transport, mirrored on compress/decompress):
//   uint32_t ue(Role, int ctx [, max]);  int32_t se(Role, int ctx);
//   uint32_t u(int nbits, Role, int ctx);
//   void coeff_token(int nc_class, int* total_coeff, int* t1s);
//   int t1_sign(int idx);                         // 1 = negative
//   int level_value(...) — handled via primitives below
//   uint32_t total_zeros(int tzVlcIndex, int dc_kind, int ctx);
//   uint32_t run_before(int zeros_left, int ctx);
//   uint32_t level_prefix(int suffix_length, int idx, int total_coeff);
//   uint32_t level_suffix_bits(int nbits, int suffix_length);
#pragma once

#include <cstdint>
#include <vector>

#include "bitstream.h"
#include "h264_params.h"
#include "h264_tables.h"
#include "gen/cavlc_tables.h"

namespace artc {

// Syntax roles for the value-model keys.
enum CavlcRole : uint8_t {
  kRMbSkipRun = 0,
  kRMbType = 1,
  kRIntraPredFlag = 2,   // prev_intra4x4_pred_mode_flag (1 bit)
  kRIntraPredRem = 3,    // rem_intra4x4_pred_mode (3 bits)
  kRChromaPred = 4,
  kRRefIdx = 5,
  kRMvd = 6,
  kRCbp = 7,
  kRQpDelta = 8,
  kRSubMbType = 9,
  kRTotalCoeff = 10,
  kRT1s = 11,
  kRT1Sign = 12,
  kRLevelPrefix = 13,
  kRLevelSuffix = 14,
  kRLevelSign = 15,
  kRTotalZeros = 16,
  kRRunBefore = 17,
  // I_PCM transport (fixed p=1/2 bins; no adaptive keys — see ModelEncoder).
  kRPcmPad = 18,   // alignment bits before the samples (aux = bit count)
  kRPcmByte = 19,  // one raw sample byte
  kRTransform8x8 = 20,  // transform_size_8x8_flag (1 bit, adaptive)
  kRMbField = 21,       // mb_field_decoding_flag (MBAFF, 1 bit)
  kNumCavlcRoles = 22,
};

// ---------------------------------------------------------------------------
// Bit-level CAVLC primitives: reader (decode from original stream) and writer
// (bit-exact regeneration). Both speak in syntax values.
class CavlcBitReader {
 public:
  CavlcBitReader(const uint8_t* rbsp, size_t size, size_t start_bit) : r_(rbsp, size) {
    r_.set_bit_pos(start_bit);
  }
  uint32_t ue() { return r_.read_ue(); }
  int32_t se() { return r_.read_se(); }
  uint32_t u(int n) { return r_.read_bits(n); }
  uint32_t u1() { return r_.read_bit(); }

  // coeff_token (Table 9-5). nc_class: 0..3 for luma nC ranges,
  // 4 = chroma DC (4:2:0, nC==-1), 5 = chroma DC (4:2:2, nC==-2).
  void coeff_token(int nc_class, int* total_coeff, int* t1s) {
    const uint8_t* len = nc_class == 4   ? kChromaDcCoeffTokenLen
                         : nc_class == 5 ? kChromaDc422CoeffTokenLen
                                         : kCoeffTokenLen[nc_class];
    const uint8_t* bits = nc_class == 4   ? kChromaDcCoeffTokenBits
                          : nc_class == 5 ? kChromaDc422CoeffTokenBits
                                          : kCoeffTokenBits[nc_class];
    int n = nc_class == 4 ? 20 : (nc_class == 5 ? 36 : 68);
    match_vlc(len, bits, n, total_coeff, t1s);
  }

  // dc_kind: 0 = luma/chroma AC, 1 = 4:2:0 chroma DC, 2 = 4:2:2 chroma DC.
  uint32_t total_zeros(int tz_idx, int dc_kind) {
    // tz_idx = total_coeff (1-based); tables indexed [total_coeff-1][value].
    const uint8_t* len = dc_kind == 1   ? kChromaDcTotalZerosLen[tz_idx - 1]
                         : dc_kind == 2 ? kChromaDc422TotalZerosLen[tz_idx - 1]
                                        : kTotalZerosLen[tz_idx - 1];
    const uint8_t* bits = dc_kind == 1   ? kChromaDcTotalZerosBits[tz_idx - 1]
                          : dc_kind == 2 ? kChromaDc422TotalZerosBits[tz_idx - 1]
                                         : kTotalZerosBits[tz_idx - 1];
    int n = dc_kind == 1 ? 4 : (dc_kind == 2 ? 8 : 16);
    int a;
    match_vlc1(len, bits, n, &a);
    return uint32_t(a);
  }

  uint32_t run_before(int zeros_left) {
    int zl = zeros_left < 7 ? zeros_left : 7;
    int v;
    match_vlc1(kRunBeforeLen[zl - 1], kRunBeforeBits[zl - 1], 16, &v);
    return uint32_t(v);
  }

  // level_prefix (9.2.2.1): count of leading zeros before a 1.
  uint32_t level_prefix() {
    uint32_t n = 0;
    while (r_.read_bit() == 0) {
      if (++n > 47) throw BitstreamError("level_prefix too long");
    }
    return n;
  }

  size_t bit_pos() const { return r_.bit_pos(); }

 private:
  // Match a (len,bits) VLC table: codes are MSB-first, lengths <= 16.
  void match_vlc(const uint8_t* len, const uint8_t* bits, int n, int* tc, int* t1) {
    uint32_t acc = 0;
    int have = 0;
    while (have < 20) {
      acc = (acc << 1) | r_.read_bit();
      ++have;
      for (int i = 0; i < n; ++i) {
        if (len[i] == have && bits[i] == acc) {
          *tc = i >> 2;
          *t1 = i & 3;
          return;
        }
      }
    }
    throw BitstreamError("bad coeff_token");
  }
  void match_vlc1(const uint8_t* len, const uint8_t* bits, int n, int* idx) {
    uint32_t acc = 0;
    int have = 0;
    while (have < 16) {
      acc = (acc << 1) | r_.read_bit();
      ++have;
      for (int i = 0; i < n; ++i) {
        if (len[i] == have && bits[i] == acc) {
          *idx = i;
          return;
        }
      }
    }
    throw BitstreamError("bad vlc code");
  }

  BitReader r_;
};

class CavlcBitWriter {
 public:
  explicit CavlcBitWriter(BitWriter& w) : w_(w) {}
  void ue(uint32_t v) { w_.put_ue(v); }
  void se(int32_t v) { w_.put_se(v); }
  void u(int n, uint32_t v) { w_.put_bits(v, n); }
  void coeff_token(int nc_class, int total_coeff, int t1s) {
    int idx = 4 * total_coeff + t1s;
    if (nc_class == 4) w_.put_bits(kChromaDcCoeffTokenBits[idx], kChromaDcCoeffTokenLen[idx]);
    else if (nc_class == 5)
      w_.put_bits(kChromaDc422CoeffTokenBits[idx], kChromaDc422CoeffTokenLen[idx]);
    else w_.put_bits(kCoeffTokenBits[nc_class][idx], kCoeffTokenLen[nc_class][idx]);
  }
  void total_zeros(int tz_idx, int dc_kind, uint32_t v) {
    if (dc_kind == 1) w_.put_bits(kChromaDcTotalZerosBits[tz_idx - 1][v],
                                  kChromaDcTotalZerosLen[tz_idx - 1][v]);
    else if (dc_kind == 2) w_.put_bits(kChromaDc422TotalZerosBits[tz_idx - 1][v],
                                       kChromaDc422TotalZerosLen[tz_idx - 1][v]);
    else w_.put_bits(kTotalZerosBits[tz_idx - 1][v], kTotalZerosLen[tz_idx - 1][v]);
  }
  void run_before(int zeros_left, uint32_t v) {
    int zl = zeros_left < 7 ? zeros_left : 7;
    w_.put_bits(kRunBeforeBits[zl - 1][v], kRunBeforeLen[zl - 1][v]);
  }
  void level_prefix(uint32_t n) {
    w_.put_bits(1, n + 1);  // n zeros then a 1
  }
  size_t bit_pos() const { return w_.bit_pos(); }

 private:
  BitWriter& w_;
};

// ---------------------------------------------------------------------------
// Per-MB CAVLC state: total_coeff per 4x4 block for nC derivation (6.4.10.5 /
// 9.2.1), plus the entropy-relevant flags shared with the walker design.
struct CavlcMB {
  uint16_t slice_id = 0xffff;
  uint8_t intra16 = 0, intra = 0, skip = 0;
  uint8_t field = 0;  // MBAFF: this MB's pair is field-coded
  // total_coeff per 4x4 per colour plane (plane 0 = luma; 1/2 used when
  // ChromaArrayType == 3, where Cb/Cr are coded with luma semantics).
  uint8_t plane_tc[3][16] = {{0}, {0}, {0}};
  // Chroma AC grids for ChromaArrayType 1/2: 2x2 (4:2:0) or 2x4 (4:2:2).
  uint8_t chroma_tc[2][8] = {{0}, {0}};
  // Signed mvd sum per component over all of the MB's partitions/lists
  // (saturated): the v25 neighbor context for mvd value coding — CAVLC has
  // no per-bin contexts, so this MB-level summary is the whole signal.
  int16_t mvd_sum[2] = {0, 0};
};

struct CavlcPicture {
  int mb_width = 0, mb_height = 0;
  std::vector<CavlcMB> mbs;
  void reset(int w, int h) {
    mb_width = w;
    mb_height = h;
    mbs.assign(size_t(w) * h, CavlcMB());
  }
};

// ---------------------------------------------------------------------------
// The CAVLC slice walker, templated on a value IO. IO must provide:
//   uint32_t ue(CavlcRole, int ctx); int32_t se(CavlcRole, int ctx);
//   uint32_t u(int nbits, CavlcRole, int ctx);
//   void coeff_token(int nc_class, int luma_nc /*for model ctx*/,
//                    int* total_coeff, int* t1s);
//   uint32_t total_zeros(int tz_idx, bool chroma_dc, int ctx);
//   uint32_t run_before(int zeros_left, int ctx);
//   uint32_t level_prefix(int ctx);
//   uint32_t level_suffix_bits(int nbits, int ctx);  // raw suffix bits
template <class IO>
class CavlcWalker {
 public:
  CavlcWalker(const SPS& sps, const PPS& pps, const SliceHeader& sh, CavlcPicture& pic,
              int slice_id, IO& io)
      : sps_(sps), pps_(pps), sh_(sh), pic_(pic), slice_id_(slice_id), io_(io) {
    if (sps.chroma_format_idc < 0 || sps.chroma_format_idc > 3)
      throw UnsupportedStream("cavlc: chroma_format not 4:0:0/4:2:0/4:2:2/4:4:4");
    mbaff_ = sps.mb_adaptive_frame_field && !sh.field_pic;
    // Monochrome and separate-colour-plane slices share ChromaArrayType == 0
    // semantics (see the CABAC walker note).
    is400_ = sps.chroma_format_idc == 0 || sps.separate_colour_plane;
    is444_ = sps.chroma_format_idc == 3 && !sps.separate_colour_plane;
    numc8x8_ = sps.chroma_format_idc == 2 ? 2 : 1;
    // VLC syntax is bit-depth agnostic apart from the I_PCM payload width.
    if (sps.bit_depth_luma > 14 || sps.bit_depth_chroma > 14)
      throw UnsupportedStream("cavlc: bit depth > 14");
    int pcm_bits = 256 * sps.bit_depth_luma +
                   (is400_ ? 0 : (is444_ ? 512 : 128 * numc8x8_) * sps.bit_depth_chroma);
    if (pcm_bits % 8) throw UnsupportedStream("cavlc: unaligned I_PCM payload");
    pcm_bytes_ = pcm_bits / 8;
  }

  // Walks slice_data(); IO signals end via more_data(). Returns MB count.
  int run() {
    if (mbaff_) return run_mbaff();
    int mb_addr = sh_.first_mb_in_slice;
    const int num_mbs = pic_.mb_width * pic_.mb_height;
    int count = 0;
    while (io_.more_data()) {
      int skip_run = 0;
      if (!sh_.is_intra()) {
        skip_run = int(io_.ue(kRMbSkipRun, prev_skip_ctx_));
        prev_skip_ctx_ = skip_run > 0;
        for (int i = 0; i < skip_run; ++i) {
          if (mb_addr >= num_mbs) throw BitstreamError("cavlc: skip past end");
          setup_mb(mb_addr);
          cur_->skip = 1;
          ++mb_addr;
          ++count;
        }
        if (!io_.more_data()) break;  // trailing skip run ends the slice
      }
      if (mb_addr >= num_mbs) throw BitstreamError("cavlc: mb past end");
      setup_mb(mb_addr);
      decode_mb();
      ++mb_addr;
      ++count;
    }
    return count;
  }

 private:
  // MBAFF slice_data() (7.3.4 with MbaffFrameFlag == 1, CAVLC):
  // CurrMbAddr iterates MBs with pair addressing (pair = addr/2, bottom =
  // addr&1). mb_field_decoding_flag is read before macroblock_layer() when
  // the MB is the top of its pair, or the bottom whose top was skipped; for
  // fully-skipped pairs it is inferred from the left, else above, pair
  // (7.4.4). The flag applies retroactively to a skipped top MB.
  int run_mbaff() {
    int mb_addr = 2 * sh_.first_mb_in_slice;
    const int pw = pic_.mb_width;
    const int num_mbs = pw * pic_.mb_height;
    int count = 0;
    bool top_skipped = false;     // top of the current pair consumed by skip run
    bool pair_flag_known = false;  // this pair's flag was read (coded top)
    while (io_.more_data()) {
      int skip_run = 0;
      if (!sh_.is_intra()) {
        skip_run = int(io_.ue(kRMbSkipRun, prev_skip_ctx_));
        prev_skip_ctx_ = skip_run > 0;
        for (int i = 0; i < skip_run; ++i) {
          if (mb_addr >= num_mbs) throw BitstreamError("cavlc: skip past end");
          bool bottom = (mb_addr & 1) != 0;
          // A skipped bottom whose pair flag was read (coded top) keeps it;
          // setup restamps cur_->field from the top member.
          setup_mb_mbaff(mb_addr, /*field_known=*/bottom && pair_flag_known);
          cur_->skip = 1;
          if (!bottom) {
            top_skipped = true;
            pair_flag_known = false;  // a new pair begins
          } else {
            // Inference (7.4.4) applies only when NEITHER member read the
            // flag (fully-skipped pair): left pair, else above, else 0.
            if (!pair_flag_known)
              set_pair_field(mb_addr >> 1, infer_pair_field(mb_addr >> 1));
            top_skipped = false;
          }
          ++mb_addr;
          ++count;
        }
        if (!io_.more_data()) {
          // Trailing skip run may end on a top MB; its pair's flag is
          // inferred (the bottom is outside the slice only at slice end).
          if (top_skipped) set_pair_field(mb_addr >> 1, infer_pair_field(mb_addr >> 1));
          break;
        }
      }
      if (mb_addr >= num_mbs) throw BitstreamError("cavlc: mb past end");
      bool bottom = (mb_addr & 1) != 0;
      bool flag_here = !bottom || top_skipped;
      if (!bottom) pair_flag_known = false;  // a new pair begins
      setup_mb_mbaff(mb_addr, /*field_known=*/!flag_here);
      if (flag_here) {
        cur_field_ = io_.u(1, kRMbField, 0) != 0;
        set_pair_field(mb_addr >> 1, cur_field_);
        pair_flag_known = true;
      }
      decode_mb();
      if (bottom) top_skipped = false;
      ++mb_addr;
      ++count;
    }
    return count;
  }

  // 7.4.4 inference: left pair of the same slice, else above pair, else 0.
  bool infer_pair_field(int pair_addr) const {
    int px = pair_addr % pic_.mb_width, py = pair_addr / pic_.mb_width;
    if (const CavlcMB* l = pair_top(px - 1, py)) return l->field != 0;
    if (const CavlcMB* a = pair_top(px, py - 1)) return a->field != 0;
    return false;
  }
  void set_pair_field(int pair_addr, bool fld) {
    int px = pair_addr % pic_.mb_width, py = pair_addr / pic_.mb_width;
    for (int m = 0; m < 2; ++m) {
      CavlcMB& mb = pic_.mbs[size_t(2 * py + m) * pic_.mb_width + px];
      if (mb.slice_id == slice_id_) mb.field = fld ? 1 : 0;
    }
  }
  const CavlcMB* pair_top(int px, int py) const {
    if (px < 0 || py < 0 || px >= pic_.mb_width || 2 * py >= pic_.mb_height) return nullptr;
    const CavlcMB& m = pic_.mbs[size_t(2 * py) * pic_.mb_width + px];
    return m.slice_id == slice_id_ ? &m : nullptr;
  }

  void setup_mb_mbaff(int addr, bool field_known) {
    int pair = addr >> 1;
    cur_bottom_ = (addr & 1) != 0;
    mb_x_ = pair % pic_.mb_width;
    int py = pair / pic_.mb_width;
    mb_y_ = 2 * py + (cur_bottom_ ? 1 : 0);
    cur_ = &pic_.mbs[size_t(mb_y_) * pic_.mb_width + mb_x_];
    *cur_ = CavlcMB();
    cur_->slice_id = uint16_t(slice_id_);
    if (field_known) {
      // Bottom MB of a pair whose flag was already read (or stamped).
      cur_field_ = pic_.mbs[size_t(2 * py) * pic_.mb_width + mb_x_].field != 0;
    }
    cur_->field = cur_field_ ? 1 : 0;
    io_.begin_mb(mb_x_, mb_y_);
  }

  void setup_mb(int addr) {
    mb_x_ = addr % pic_.mb_width;
    mb_y_ = addr / pic_.mb_width;
    cur_ = &pic_.mbs[addr];
    *cur_ = CavlcMB();
    cur_->slice_id = uint16_t(slice_id_);
    io_.begin_mb(mb_x_, mb_y_);
  }

  const CavlcMB* nb_mb(int dx, int dy) const {
    int x = mb_x_ + dx, y = mb_y_ + dy;
    if (x < 0 || y < 0 || x >= pic_.mb_width || y >= pic_.mb_height) return nullptr;
    const CavlcMB& m = pic_.mbs[size_t(y) * pic_.mb_width + x];
    return m.slice_id == slice_id_ ? &m : nullptr;
  }

  void decode_mb() {
    uint32_t mb_type = io_.ue(kRMbType, sh_.is_intra() ? 0 : (sh_.is_b() ? 2 : 1));
    int intra_code;
    bool is_intra;
    int inter_type = -1;
    uint32_t intra_base = sh_.is_b() ? 23 : 5;  // Table 7-14 / 7-13 offsets
    if (sh_.is_intra()) {
      intra_code = int(mb_type);
      is_intra = true;
    } else if (mb_type >= intra_base) {
      intra_code = int(mb_type) - int(intra_base);
      is_intra = true;
    } else {
      inter_type = int(mb_type);
      is_intra = false;
    }

    int cbp_luma = 0, cbp_chroma = 0;
    bool i16 = false;
    if (is_intra) {
      if (intra_code == 25) {
        // I_PCM (7.3.5): pcm_alignment bits + raw samples read directly from
        // the bitstream. Neighbor nC is 16 for every block of a PCM MB (9.2.1).
        cur_->intra = 1;
        for (int p = 0; p < 3; ++p)
          for (int i = 0; i < 16; ++i) cur_->plane_tc[p][i] = 16;
        for (int c = 0; c < 2; ++c)
          for (int i = 0; i < 8; ++i) cur_->chroma_tc[c][i] = 16;
        io_.pcm_block(pcm_bytes_);
        return;
      }
      if (intra_code > 25) throw BitstreamError("cavlc: bad intra mb_type");
      cur_->intra = 1;
      bool t8 = false;
      if (intra_code > 0) {
        i16 = true;
        cur_->intra16 = 1;
        int v = intra_code - 1;
        cbp_luma = (v >= 12) ? 0xf : 0;
        cbp_chroma = is400_ ? 0 : (v % 12) / 4;  // ChromaArrayType 0: derived 0
      } else {
        if (pps_.transform_8x8_mode) t8 = io_.u(1, kRTransform8x8, 0) != 0;
        int n = t8 ? 4 : 16;
        for (int b = 0; b < n; ++b) {
          if (io_.u(1, kRIntraPredFlag, 0) == 0) io_.u(3, kRIntraPredRem, 0);
        }
      }
      if (!is444_ && !is400_) io_.ue(kRChromaPred, 0);  // intra_chroma_pred_mode
      bool gray_cbp = is444_ || is400_;  // ChromaArrayType 0/3 me(v) mapping
      if (!i16) {
        uint32_t code = io_.ue(kRCbp, 0);
        if (code > (gray_cbp ? 15u : 47u)) throw BitstreamError("cavlc: bad cbp code");
        int cbp = gray_cbp ? kGolombToIntra4x4CbpGray[code] : kGolombToIntra4x4Cbp[code];
        cbp_luma = cbp & 0xf;
        cbp_chroma = cbp >> 4;
        if (cbp_chroma > 2) throw BitstreamError("cavlc: bad chroma cbp");
      }
      if (cbp_luma || cbp_chroma || i16) {
        io_.se(kRQpDelta, 0);
        decode_residual(i16, cbp_luma, cbp_chroma);
      }
      return;
    }

    // Inter MB (P or B).
    bool direct16 = sh_.is_b() && inter_type == 0;
    bool no_small = true;
    if (direct16) {
      no_small = sps_.direct_8x8_inference;
    } else {
      no_small = decode_inter_pred(inter_type);
    }
    uint32_t code = io_.ue(kRCbp, 1);
    bool gray_cbp = is444_ || is400_;
    if (code > (gray_cbp ? 15u : 47u)) throw BitstreamError("cavlc: bad cbp code");
    int cbp = gray_cbp ? kGolombToInterCbpGray[code] : kGolombToInterCbp[code];
    cbp_luma = cbp & 0xf;
    cbp_chroma = cbp >> 4;
    if (cbp_chroma > 2) throw BitstreamError("cavlc: bad chroma cbp");
    if (cbp_luma && pps_.transform_8x8_mode && no_small &&
        (!direct16 || sps_.direct_8x8_inference)) {
      // transform_size_8x8_flag: residual coding is unchanged in CAVLC (an
      // 8x8 is carried as 4 interleaved 4x4 blocks, 7.3.5.3.2).
      io_.u(1, kRTransform8x8, 1);
    }
    if (cbp_luma || cbp_chroma) {
      io_.se(kRQpDelta, 0);
      decode_residual(false, cbp_luma, cbp_chroma);
    }
  }

  // Returns NoSubMbPartSizeLessThan8x8Flag (gates the 8x8-transform flag).
  bool decode_inter_pred(int inter_type) {
    auto ref = [&](int list, int ctx) {
      int nref = list ? sh_.num_ref_idx_l1_active : sh_.num_ref_idx_l0_active;
      // A field MB of an MBAFF frame addresses twice as many (field)
      // references (7.4.5.2) — changes the te(v) binarization bound.
      if (mbaff_ && cur_field_) nref *= 2;
      if (nref <= 1) return;
      if (nref == 2) io_.u(1, kRRefIdx, ctx | (list << 2));  // te(v), cMax 1
      else io_.ue(kRRefIdx, ctx | (list << 2));
    };
    // v25: condition mvd values on the neighbors' MB-level signed mvd sums
    // (motion smoothness; the CABAC side does this per bin since v14/v23 —
    // CAVLC gets the whole se() tree keyed on (sign, strength) instead).
    // Raster-space left/up MBs, same slice; any deterministic rule is
    // format-valid, both codec sides run this identical walker code.
    int nb_sum[2] = {0, 0};
    if (const CavlcMB* a = nb_mb(-1, 0)) {
      nb_sum[0] += a->mvd_sum[0];
      nb_sum[1] += a->mvd_sum[1];
    }
    if (const CavlcMB* b = nb_mb(0, -1)) {
      nb_sum[0] += b->mvd_sum[0];
      nb_sum[1] += b->mvd_sum[1];
    }
    auto cls6 = [](int s) {
      // 0 = zero neighbor motion -> the original unconditioned key (cold
      // regions share the base estimator); 1/2 = negative/positive.
      return s == 0 ? 0 : (s < 0 ? 1 : 2);
    };
    const int aux_cls[2] = {cls6(nb_sum[0]) << 3, cls6(nb_sum[1]) << 3};
    auto acc = [&](int comp, int v) {
      int s = cur_->mvd_sum[comp] + (v < -8192 ? -8192 : (v > 8192 ? 8192 : v));
      cur_->mvd_sum[comp] = int16_t(s < -16384 ? -16384 : (s > 16384 ? 16384 : s));
    };
    auto mvd = [&](int list) {
      acc(0, io_.se(kRMvd, 0 | (list << 2) | aux_cls[0]));
      acc(1, io_.se(kRMvd, 1 | (list << 2) | aux_cls[1]));
    };
    if (!sh_.is_b()) {
      switch (inter_type) {
        case 0:  // P_L0_16x16
          ref(0, 0);
          mvd(0);
          return true;
        case 1:  // P_L0_L0_16x8
        case 2:  // P_L0_L0_8x16
          ref(0, 0);
          ref(0, 0);
          mvd(0);
          mvd(0);
          return true;
        case 3:    // P_8x8
        case 4: {  // P_8x8ref0
          int sub[4];
          bool no_small = true;
          for (int i = 0; i < 4; ++i) {
            sub[i] = int(io_.ue(kRSubMbType, 0));
            if (sub[i] > 3) throw BitstreamError("cavlc: bad sub_mb_type");
            if (sub[i] != 0) no_small = false;
          }
          if (inter_type == 3)
            for (int i = 0; i < 4; ++i) ref(0, 1);
          static const int kParts[4] = {1, 2, 2, 4};
          for (int i = 0; i < 4; ++i)
            for (int p = 0; p < kParts[sub[i]]; ++p) mvd(0);
          return no_small;
        }
        default:
          throw BitstreamError("cavlc: bad P mb_type");
      }
    }
    // B slice (Table 7-14; same value mapping as the CABAC walker).
    static const int8_t kBPred[22][2] = {
        {0, 0},                                          // 0 = direct (no pred)
        {1, 0}, {2, 0}, {3, 0},                          // 16x16 L0/L1/Bi
        {1, 1}, {1, 1}, {2, 2}, {2, 2}, {1, 2}, {1, 2},  // 4..9
        {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},  // 10..15
        {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3},  // 16..21
    };
    if (inter_type >= 1 && inter_type <= 21) {
      int nparts = inter_type <= 3 ? 1 : 2;
      for (int list = 0; list < 2; ++list)
        for (int p = 0; p < nparts; ++p)
          if (kBPred[inter_type][p] & (1 << list)) ref(list, 0);
      for (int list = 0; list < 2; ++list)
        for (int p = 0; p < nparts; ++p)
          if (kBPred[inter_type][p] & (1 << list)) mvd(list);
      return true;
    }
    if (inter_type == 22) {  // B_8x8
      static const int8_t kSubPred[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
      static const int8_t kSubParts[13] = {1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 4, 4, 4};
      int sub[4];
      bool no_small = true;
      for (int i = 0; i < 4; ++i) {
        sub[i] = int(io_.ue(kRSubMbType, 1));
        if (sub[i] > 12) throw BitstreamError("cavlc: bad B sub_mb_type");
        if (sub[i] == 0) {
          if (!sps_.direct_8x8_inference) no_small = false;
        } else if (sub[i] >= 4) {
          no_small = false;
        }
      }
      for (int list = 0; list < 2; ++list)
        for (int i = 0; i < 4; ++i)
          if (sub[i] != 0 && (kSubPred[sub[i]] & (1 << list))) ref(list, 1);
      for (int list = 0; list < 2; ++list)
        for (int i = 0; i < 4; ++i)
          if (sub[i] != 0 && (kSubPred[sub[i]] & (1 << list)))
            for (int p = 0; p < kSubParts[sub[i]]; ++p) mvd(list);
      return no_small;
    }
    throw BitstreamError("cavlc: bad B mb_type");
  }

  // ---- residuals (9.2) ----------------------------------------------------
  // nC for a plane 4x4 at grid (gx,gy): mean of available left/up total_coeff.
  int luma_nc(int plane, int gx, int gy) const {
    int na = tc_at(plane, gx - 1, gy, -1);
    int nb = tc_at(plane, gx, gy - 1, -1);
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }
  int tc_at(int plane, int gx, int gy, int def) const {
    if (mbaff_) {
      // Sample-space neighbour derivation (6.4.12 / 9.2.1): the 4x4 block
      // containing the luma sample one left/up of this block's top-left
      // (a negative block coord means the sample just outside, i.e. -1).
      auto n = locate_mbaff(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy, 16);
      if (!n.mb) return def;
      return n.mb->plane_tc[plane][(n.lx >> 2) + 4 * (n.ly >> 2)];
    }
    int dx = 0, dy = 0;
    if (gx < 0) { dx = -1; gx += 4; }
    if (gy < 0) { dy = -1; gy += 4; }
    const CavlcMB* m = (dx == 0 && dy == 0) ? cur_ : nb_mb(dx, dy);
    if (!m) return def;
    return m->plane_tc[plane][gx + 4 * gy];
  }
  // Chroma AC grid: 2 wide x 2*numc8x8 high (4:2:0 / 4:2:2).
  int chroma_nc(int c, int gx, int gy) const {
    int na = ctc_at(c, gx - 1, gy, -1);
    int nb = ctc_at(c, gx, gy - 1, -1);
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }
  int ctc_at(int c, int gx, int gy, int def) const {
    if (mbaff_) {
      auto n = locate_mbaff(gx < 0 ? -1 : 4 * gx, gy < 0 ? -1 : 4 * gy, 8 * numc8x8_, 8);
      if (!n.mb) return def;
      return n.mb->chroma_tc[c][(n.lx >> 2) + 2 * (n.ly >> 2)];
    }
    int dx = 0, dy = 0;
    if (gx < 0) { dx = -1; gx += 2; }
    if (gy < 0) { dy = -1; gy += 2 * numc8x8_; }
    const CavlcMB* m = (dx == 0 && dy == 0) ? cur_ : nb_mb(dx, dy);
    if (!m) return def;
    return m->chroma_tc[c][gx + 2 * gy];
  }

  struct NbLoc {
    const CavlcMB* mb = nullptr;
    int lx = 0, ly = 0;  // local sample coords within the neighbour MB
  };

  // MBAFF branch of 6.4.12 in pair-region sample space (same derivation as
  // the CABAC walker's locate_mbaff, on the CAVLC total_coeff state).
  NbLoc locate_mbaff(int xN, int yN, int mbh, int mbw = 16) const {
    const int pw = pic_.mb_width;
    const int py = mb_y_ >> 1;
    const bool cf = cur_field_;
    const bool bot = cur_bottom_;
    auto pair_row = [&](int y) {
      return cf ? (2 * y + (bot ? 1 : 0)) : (mbh * (bot ? 1 : 0) + y);
    };
    if (xN >= 0 && yN >= 0) {
      if (yN < mbh) return {cur_, xN, yN};
      return {};
    }
    if (xN < 0) {
      if (yN < 0) return {};
      const CavlcMB* ltop = pair_top(mb_x_ - 1, py);
      if (!ltop) return {};
      int gy = pair_row(yN);
      bool nf = ltop->field != 0;
      int member, ym;
      if (nf) { member = gy & 1; ym = gy >> 1; }
      else { member = gy >= mbh ? 1 : 0; ym = gy - member * mbh; }
      return {ltop + size_t(member) * pw, xN + mbw, ym};
    }
    int gy = pair_row(0) + (cf ? 2 * yN : yN);  // yN == -1
    if (gy >= 0) {
      int member, ym;
      if (cf) { member = gy & 1; ym = gy >> 1; }
      else { member = gy >= mbh ? 1 : 0; ym = gy - member * mbh; }
      const CavlcMB* m = &pic_.mbs[size_t(2 * py + member) * pw + mb_x_];
      if (m->slice_id != slice_id_) return {};
      return {m, xN, ym};
    }
    const CavlcMB* atop = pair_top(mb_x_, py - 1);
    if (!atop) return {};
    int gy2 = gy + 2 * mbh;
    bool nf = atop->field != 0;
    int member, ym;
    if (nf) { member = gy2 & 1; ym = gy2 >> 1; }
    else { member = gy2 >= mbh ? 1 : 0; ym = gy2 - member * mbh; }
    return {atop + size_t(member) * pw, xN, ym};
  }
  static int nc_class(int nc) {
    if (nc < 2) return 0;
    if (nc < 4) return 1;
    if (nc < 8) return 2;
    return 3;
  }

  void decode_residual(bool i16, int cbp_luma, int cbp_chroma) {
    // Plane 0 (luma), then — for ChromaArrayType 3 — Cb and Cr with identical
    // luma semantics (7.3.5.3.2); chroma DC/AC only for ChromaArrayType 1/2.
    for (int plane = 0; plane < (is444_ ? 3 : 1); ++plane)
      decode_plane_residual(plane, i16, cbp_luma);
    if (!is444_ && cbp_chroma) {
      // Chroma DC: (4 * NumC8x8) coefficients; 4:2:2 uses the nC == -2
      // coeff_token column (class 5) and the 9-9(b) total_zeros tables.
      int ncoeff = 4 * numc8x8_;
      for (int c = 0; c < 2; ++c)
        residual_block(0, ncoeff, /*dc_kind=*/numc8x8_ == 2 ? 2 : 1);
      if (cbp_chroma == 2)
        for (int c = 0; c < 2; ++c)
          for (int k = 0; k < 4 * numc8x8_; ++k) {
            int gx = k & 1, gy = k >> 1;
            int tc = residual_block(chroma_nc(c, gx, gy), 15, 0);
            cur_->chroma_tc[c][gx + 2 * gy] = uint8_t(tc);
          }
    }
  }

  void decode_plane_residual(int plane, bool i16, int cbp_luma) {
    if (i16) {
      // DC: 16 coefficients, nC from neighbors like block 0.
      residual_block(luma_nc(plane, 0, 0), 16, 0);
    }
    int max_luma = i16 ? 15 : 16;
    for (int b8 = 0; b8 < 4; ++b8)
      for (int k = 0; k < 4; ++k) {
        int blk = 4 * b8 + k;
        int gx = kBlk4x4X[blk], gy = kBlk4x4Y[blk];
        if (cbp_luma & (1 << b8)) {
          int tc = residual_block(luma_nc(plane, gx, gy), max_luma, 0);
          cur_->plane_tc[plane][gx + 4 * gy] = uint8_t(tc);
        }
      }
  }

  // One CAVLC residual block (9.2.1-9.2.4). nc_val = the derived nC (model
  // context; VLC table class derives from it). dc_kind: 0 = regular,
  // 1 = 4:2:0 chroma DC, 2 = 4:2:2 chroma DC. Returns total_coeff.
  int residual_block(int nc_val, int max_coeff, int dc_kind) {
    int ncls = nc_class(nc_val);
    int total_coeff, t1s;
    // total_coeff model context: capped spatial nC prediction + intra flag
    // (intra residuals carry systematically more coefficients; measured
    // -0.1..-0.3pp per CAVLC clip).
    int model_ctx = (nc_val < 7 ? nc_val : 7) | (cur_->intra ? 8 : 0);
    io_.coeff_token(dc_kind ? 3 + dc_kind : ncls, model_ctx, &total_coeff, &t1s);
    if (total_coeff > max_coeff) throw BitstreamError("cavlc: total_coeff too large");
    if (total_coeff == 0) return 0;
    for (int i = 0; i < t1s; ++i) io_.u(1, kRT1Sign, 0);
    // Levels (9.2.2): decoded high-frequency-first.
    int suffix_length = (total_coeff > 10 && t1s < 3) ? 1 : 0;
    for (int i = 0; i < total_coeff - t1s; ++i) {
      uint32_t prefix = io_.level_prefix(suffix_length, i, total_coeff);
      int level_suffix_size = suffix_length;
      if (prefix == 14 && suffix_length == 0) level_suffix_size = 4;
      else if (prefix >= 15) level_suffix_size = int(prefix) - 3;
      uint32_t suffix = 0;
      if (level_suffix_size > 0)
        suffix = io_.level_suffix_bits(level_suffix_size, suffix_length);
      int level_code = int((prefix < 15 ? prefix : 15) << suffix_length) + int(suffix);
      if (prefix >= 15 && suffix_length == 0) level_code += 15;
      if (prefix >= 16) level_code += (1 << (prefix - 3)) - 4096;
      if (i == 0 && t1s < 3) level_code += 2;
      int level = (level_code % 2 == 0) ? (level_code + 2) >> 1 : -((level_code + 1) >> 1);
      if (suffix_length == 0) suffix_length = 1;
      int abs_level = level < 0 ? -level : level;
      if (abs_level > (3 << (suffix_length - 1)) && suffix_length < 6) ++suffix_length;
    }
    // total_zeros + run_before (9.2.3).
    int zeros_left = 0;
    if (total_coeff < max_coeff) {
      zeros_left = int(io_.total_zeros(total_coeff, dc_kind, dc_kind ? 1 : 0));
    }
    for (int i = 0; i < total_coeff - 1 && zeros_left > 0; ++i) {
      // run_before conditioned on the coefficient index (runs shrink toward
      // low frequencies; measured -0.15..-0.25pp on 10-bit/4:4:4 clips).
      uint32_t run = io_.run_before(zeros_left, i < 3 ? i + 1 : 4);
      if (int(run) > zeros_left) throw BitstreamError("cavlc: bad run_before");
      zeros_left -= int(run);
    }
    return total_coeff;
  }

  const SPS& sps_;
  const PPS& pps_;
  const SliceHeader& sh_;
  CavlcPicture& pic_;
  int slice_id_;
  IO& io_;
  int mb_x_ = 0, mb_y_ = 0;
  CavlcMB* cur_ = nullptr;
  int prev_skip_ctx_ = 0;
  bool is444_ = false;
  bool is400_ = false;
  int numc8x8_ = 1;      // 1 = 4:2:0, 2 = 4:2:2
  int pcm_bytes_ = 384;  // I_PCM payload size (chroma format + depth)
  bool mbaff_ = false;
  bool cur_bottom_ = false;  // MBAFF: bottom MB of the current pair
  bool cur_field_ = false;   // MBAFF: current pair is field-coded
};

}  // namespace artc
