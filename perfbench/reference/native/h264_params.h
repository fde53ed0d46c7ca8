// H.264 parameter-set and slice-header parsing (ITU-T H.264 clauses 7.3.2.1,
// 7.3.2.2, 7.3.3). Only the fields that influence entropy-layer decoding are
// retained; parameter-set NALs themselves travel as literals in the container.
//
// Reference parity: the reference outsources all of this to libavformat/
// libavcodec (reference recode.cpp:107-133 + Appendix A of SURVEY.md); here it
// is native so the syntax walk needs no ffmpeg fork.
#pragma once

#include <array>
#include <cstdint>
#include <map>
#include <optional>

#include "bitstream.h"

namespace artc {

struct SPS {
  int profile_idc = 0;
  int level_idc = 0;
  int sps_id = 0;
  int chroma_format_idc = 1;  // 0=mono,1=420,2=422,3=444
  bool separate_colour_plane = false;
  int bit_depth_luma = 8;
  int bit_depth_chroma = 8;
  bool qpprime_y_zero_transform_bypass = false;
  int log2_max_frame_num = 4;
  int pic_order_cnt_type = 0;
  int log2_max_pic_order_cnt_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int num_ref_frames_in_pic_order_cnt_cycle = 0;
  int max_num_ref_frames = 0;
  bool gaps_in_frame_num_allowed = false;
  int pic_width_in_mbs = 0;
  int pic_height_in_map_units = 0;
  bool frame_mbs_only = true;
  bool mb_adaptive_frame_field = false;
  bool direct_8x8_inference = false;

  int mb_width() const { return pic_width_in_mbs; }
  int mb_height() const { return frame_mbs_only ? pic_height_in_map_units : 2 * pic_height_in_map_units; }
};

struct PPS {
  int pps_id = 0;
  int sps_id = 0;
  bool entropy_coding_mode = false;  // true = CABAC
  bool bottom_field_pic_order_in_frame_present = false;
  int num_slice_groups = 1;
  int num_ref_idx_l0_default = 1;
  int num_ref_idx_l1_default = 1;
  bool weighted_pred = false;
  int weighted_bipred_idc = 0;
  int pic_init_qp = 26;
  int pic_init_qs = 26;
  int chroma_qp_index_offset = 0;
  bool deblocking_filter_control_present = false;
  bool constrained_intra_pred = false;
  bool redundant_pic_cnt_present = false;
  bool transform_8x8_mode = false;
  int second_chroma_qp_index_offset = 0;
};

enum class SliceType { P = 0, B = 1, I = 2, SP = 3, SI = 4 };

struct SliceHeader {
  int first_mb_in_slice = 0;
  SliceType slice_type = SliceType::I;
  bool slice_type_fixed = false;  // slice_type value was >= 5 ("all slices same")
  int colour_plane_id = 0;  // separate_colour_plane streams: 0=Y 1=Cb 2=Cr
  int pps_id = 0;
  int frame_num = 0;
  bool field_pic = false;
  bool bottom_field = false;
  int idr_pic_id = -1;  // >=0 iff IDR
  int cabac_init_idc = 0;
  int slice_qp = 26;
  int num_ref_idx_l0_active = 1;
  int num_ref_idx_l1_active = 1;
  bool is_idr = false;
  // Bit position (in the slice NAL's RBSP) where slice_data() begins, i.e.
  // after cabac_alignment_one_bit for CABAC slices.
  size_t data_bit_offset = 0;
  // Bit position where the header ends (before alignment bits).
  size_t header_end_bit = 0;

  bool is_intra() const { return slice_type == SliceType::I || slice_type == SliceType::SI; }
  bool is_b() const { return slice_type == SliceType::B; }
  bool is_p() const { return slice_type == SliceType::P || slice_type == SliceType::SP; }
  // Height of THIS picture in MBs: a PAFF field picture is half frame height.
  template <class SPST>
  int pic_mb_height(const SPST& sps) const {
    return field_pic ? sps.mb_height() / 2 : sps.mb_height();
  }
};

class UnsupportedStream : public std::runtime_error {
 public:
  explicit UnsupportedStream(const std::string& m) : std::runtime_error(m) {}
};

inline void parse_scaling_list(BitReader& r, int size) {
  // 7.3.2.1.1.1: values affect dequantization only, not entropy decode; we
  // must still consume the exact bits.
  int last = 8, next = 8;
  for (int i = 0; i < size; ++i) {
    if (next != 0) {
      int delta = r.read_se();
      next = (last + delta + 256) % 256;
    }
    last = (next == 0) ? last : next;
  }
}

// Parses an SPS RBSP (nal_unit_type 7), excluding the NAL header byte.
inline SPS parse_sps(const uint8_t* rbsp, size_t size) {
  BitReader r(rbsp, size);
  SPS s;
  s.profile_idc = r.read_bits(8);
  r.read_bits(8);  // constraint flags + reserved
  s.level_idc = r.read_bits(8);
  s.sps_id = r.read_ue();
  if (s.profile_idc == 100 || s.profile_idc == 110 || s.profile_idc == 122 ||
      s.profile_idc == 244 || s.profile_idc == 44 || s.profile_idc == 83 ||
      s.profile_idc == 86 || s.profile_idc == 118 || s.profile_idc == 128) {
    s.chroma_format_idc = r.read_ue();
    if (s.chroma_format_idc == 3) s.separate_colour_plane = r.read_bit();
    s.bit_depth_luma = 8 + r.read_ue();
    s.bit_depth_chroma = 8 + r.read_ue();
    s.qpprime_y_zero_transform_bypass = r.read_bit();
    if (r.read_bit()) {  // seq_scaling_matrix_present
      int lists = (s.chroma_format_idc != 3) ? 8 : 12;
      for (int i = 0; i < lists; ++i)
        if (r.read_bit()) parse_scaling_list(r, i < 6 ? 16 : 64);
    }
  }
  s.log2_max_frame_num = 4 + r.read_ue();
  s.pic_order_cnt_type = r.read_ue();
  if (s.pic_order_cnt_type == 0) {
    s.log2_max_pic_order_cnt_lsb = 4 + r.read_ue();
  } else if (s.pic_order_cnt_type == 1) {
    s.delta_pic_order_always_zero = r.read_bit();
    r.read_se();  // offset_for_non_ref_pic
    r.read_se();  // offset_for_top_to_bottom_field
    s.num_ref_frames_in_pic_order_cnt_cycle = r.read_ue();
    for (int i = 0; i < s.num_ref_frames_in_pic_order_cnt_cycle; ++i) r.read_se();
  }
  s.max_num_ref_frames = r.read_ue();
  s.gaps_in_frame_num_allowed = r.read_bit();
  s.pic_width_in_mbs = 1 + r.read_ue();
  s.pic_height_in_map_units = 1 + r.read_ue();
  s.frame_mbs_only = r.read_bit();
  if (!s.frame_mbs_only) s.mb_adaptive_frame_field = r.read_bit();
  s.direct_8x8_inference = r.read_bit();
  // frame cropping + VUI: irrelevant to the entropy layer; not parsed.
  return s;
}

// Parses a PPS RBSP (nal_unit_type 8), excluding the NAL header byte.
inline PPS parse_pps(const uint8_t* rbsp, size_t size) {
  BitReader r(rbsp, size);
  PPS p;
  p.pps_id = r.read_ue();
  p.sps_id = r.read_ue();
  p.entropy_coding_mode = r.read_bit();
  p.bottom_field_pic_order_in_frame_present = r.read_bit();
  p.num_slice_groups = 1 + r.read_ue();
  if (p.num_slice_groups > 1) throw UnsupportedStream("FMO (num_slice_groups>1)");
  p.num_ref_idx_l0_default = 1 + r.read_ue();
  p.num_ref_idx_l1_default = 1 + r.read_ue();
  p.weighted_pred = r.read_bit();
  p.weighted_bipred_idc = r.read_bits(2);
  p.pic_init_qp = 26 + r.read_se();
  p.pic_init_qs = 26 + r.read_se();
  p.chroma_qp_index_offset = r.read_se();
  p.deblocking_filter_control_present = r.read_bit();
  p.constrained_intra_pred = r.read_bit();
  p.redundant_pic_cnt_present = r.read_bit();
  if (r.more_rbsp_data()) {
    p.transform_8x8_mode = r.read_bit();
    if (r.read_bit()) {  // pic_scaling_matrix_present
      int lists = 6 + (p.transform_8x8_mode ? 2 : 0);  // chroma_format_idc!=3 assumed
      for (int i = 0; i < lists; ++i)
        if (r.read_bit()) parse_scaling_list(r, i < 6 ? 16 : 64);
    }
    p.second_chroma_qp_index_offset = r.read_se();
  } else {
    p.second_chroma_qp_index_offset = p.chroma_qp_index_offset;
  }
  return p;
}

// Parses a slice header (7.3.3) from a slice NAL's RBSP (header byte excluded).
// nal_ref_idc / nal_unit_type come from the NAL header.
inline SliceHeader parse_slice_header(const uint8_t* rbsp, size_t size, int nal_unit_type,
                                      int nal_ref_idc, const std::map<int, SPS>& sps_map,
                                      const std::map<int, PPS>& pps_map, const SPS** sps_out,
                                      const PPS** pps_out) {
  BitReader r(rbsp, size);
  SliceHeader h;
  h.is_idr = (nal_unit_type == 5);
  h.first_mb_in_slice = r.read_ue();
  uint32_t st = r.read_ue();
  if (st > 9) throw UnsupportedStream("bad slice_type");
  h.slice_type_fixed = st >= 5;
  h.slice_type = SliceType(st % 5);
  h.pps_id = r.read_ue();
  auto pit = pps_map.find(h.pps_id);
  if (pit == pps_map.end()) throw UnsupportedStream("missing PPS");
  const PPS& pps = pit->second;
  auto sit = sps_map.find(pps.sps_id);
  if (sit == sps_map.end()) throw UnsupportedStream("missing SPS");
  const SPS& sps = sit->second;
  *sps_out = &sps;
  *pps_out = &pps;
  if (sps.separate_colour_plane) h.colour_plane_id = int(r.read_bits(2));
  h.frame_num = r.read_bits(sps.log2_max_frame_num);
  if (!sps.frame_mbs_only) {
    // PAFF field pictures (field_pic_flag=1): the picture is a single parity
    // field of half frame height; every MB is field-coded (field ctx-table
    // rows, 9.3.3.1.3) with plain raster addressing — no MBAFF pair
    // machinery, no ref_idx doubling (the header's active counts already
    // address field references, 7.4.5.2).
    h.field_pic = r.read_bit();
    if (h.field_pic) h.bottom_field = r.read_bit();
  }
  if (h.is_idr) h.idr_pic_id = r.read_ue();
  if (sps.pic_order_cnt_type == 0) {
    r.read_bits(sps.log2_max_pic_order_cnt_lsb);
    if (pps.bottom_field_pic_order_in_frame_present && !h.field_pic) r.read_se();
  } else if (sps.pic_order_cnt_type == 1 && !sps.delta_pic_order_always_zero) {
    r.read_se();
    if (pps.bottom_field_pic_order_in_frame_present && !h.field_pic) r.read_se();
  }
  if (pps.redundant_pic_cnt_present) r.read_ue();
  if (h.slice_type == SliceType::B) r.read_bit();  // direct_spatial_mv_pred
  h.num_ref_idx_l0_active = pps.num_ref_idx_l0_default;
  h.num_ref_idx_l1_active = pps.num_ref_idx_l1_default;
  if (h.slice_type == SliceType::P || h.slice_type == SliceType::SP ||
      h.slice_type == SliceType::B) {
    if (r.read_bit()) {  // num_ref_idx_active_override
      h.num_ref_idx_l0_active = 1 + r.read_ue();
      if (h.slice_type == SliceType::B) h.num_ref_idx_l1_active = 1 + r.read_ue();
    }
  }
  // ref_pic_list_modification (7.3.3.1)
  auto ref_list_mod = [&r]() {
    if (r.read_bit()) {
      uint32_t op;
      while ((op = r.read_ue()) != 3) {
        if (op > 3) throw UnsupportedStream("bad ref list modification op");
        r.read_ue();  // abs_diff_pic_num_minus1 / long_term_pic_num
      }
    }
  };
  if (!h.is_intra()) ref_list_mod();
  if (h.slice_type == SliceType::B) ref_list_mod();
  // pred_weight_table (7.3.3.2)
  if ((pps.weighted_pred && h.is_p()) || (pps.weighted_bipred_idc == 1 && h.is_b())) {
    r.read_ue();  // luma_log2_weight_denom
    if (sps.chroma_format_idc != 0) r.read_ue();  // chroma_log2_weight_denom
    auto weights = [&](int n) {
      for (int i = 0; i < n; ++i) {
        if (r.read_bit()) { r.read_se(); r.read_se(); }  // luma weight/offset
        if (sps.chroma_format_idc != 0 && r.read_bit())
          for (int j = 0; j < 2; ++j) { r.read_se(); r.read_se(); }
      }
    };
    weights(h.num_ref_idx_l0_active);
    if (h.is_b()) weights(h.num_ref_idx_l1_active);
  }
  // dec_ref_pic_marking (7.3.3.3)
  if (nal_ref_idc != 0) {
    if (h.is_idr) {
      r.read_bit();  // no_output_of_prior_pics
      r.read_bit();  // long_term_reference_flag
    } else if (r.read_bit()) {  // adaptive_ref_pic_marking_mode
      uint32_t op;
      while ((op = r.read_ue()) != 0) {
        if (op > 6) throw UnsupportedStream("bad MMCO op");
        if (op == 1 || op == 3) r.read_ue();
        if (op == 2) r.read_ue();
        if (op == 3 || op == 6) r.read_ue();
        if (op == 4) r.read_ue();
      }
    }
  }
  if (pps.entropy_coding_mode && !h.is_intra()) h.cabac_init_idc = r.read_ue();
  if (h.cabac_init_idc > 2) throw UnsupportedStream("bad cabac_init_idc");
  h.slice_qp = pps.pic_init_qp + r.read_se();
  // SP slices (Extended profile): the entropy layer is identical to P —
  // sp_for_switch_flag and slice_qs_delta only affect dequantization.
  // SI slices change mb_type semantics and stay a literal fallback.
  if (h.slice_type == SliceType::SP) {
    r.read_bit();  // sp_for_switch_flag
    r.read_se();   // slice_qs_delta
  }
  if (h.slice_type == SliceType::SI) throw UnsupportedStream("SI slices");
  if (pps.deblocking_filter_control_present) {
    uint32_t idc = r.read_ue();
    if (idc != 1) { r.read_se(); r.read_se(); }
  }
  h.header_end_bit = r.bit_pos();
  if (pps.entropy_coding_mode) {
    // cabac_alignment_one_bit: align to byte with 1-bits.
    while (!r.byte_aligned()) {
      if (r.read_bit() != 1) throw BitstreamError("bad cabac_alignment_one_bit");
    }
  }
  h.data_bit_offset = r.bit_pos();
  return h;
}

}  // namespace artc
