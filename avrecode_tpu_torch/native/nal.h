// NAL unit navigation for Annex-B byte streams and AVCC (length-prefixed)
// sample payloads (ITU-T H.264 Annex B; ISO 14496-15 for AVCC).
//
// Reference parity: the reference leans on libavformat packetization and
// locates slice bytes with memmem (reference recode.cpp:1275-1297), which can
// misfire on repeated content (SURVEY.md §7 hard-part 5); here every NAL's
// exact file extent is first-class.
#pragma once

#include <cstdint>
#include <cstddef>
#include <vector>

namespace artc {

struct NalUnit {
  size_t offset;       // file offset of the NAL header byte
  size_t size;         // bytes from header byte to end of NAL (EBSP domain)
  size_t start_code;   // length of the preceding start code (3 or 4; 0 for AVCC)
  int ref_idc;
  int type;
};

// Scans an Annex-B stream for NAL units. Returns units in file order; the
// region before the first start code (if any) is not a NAL.
inline std::vector<NalUnit> find_nals_annexb(const uint8_t* data, size_t size) {
  std::vector<NalUnit> nals;
  size_t i = 0;
  size_t prev_start = size;  // offset of current NAL's first byte
  size_t prev_sc = 0;
  auto close_prev = [&](size_t end) {
    if (prev_start < size) {
      NalUnit& n = nals.back();
      n.size = end - prev_start;
    }
  };
  while (i + 2 < size) {
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      size_t sc = 3;
      size_t sc_start = i;
      if (i > 0 && data[i - 1] == 0) { sc = 4; sc_start = i - 1; }
      close_prev(sc_start);
      size_t hdr = i + 3;
      if (hdr >= size) break;
      NalUnit n;
      n.offset = hdr;
      n.size = 0;  // fixed by close_prev
      n.start_code = sc;
      n.ref_idc = (data[hdr] >> 5) & 3;
      n.type = data[hdr] & 0x1f;
      nals.push_back(n);
      prev_start = hdr;
      prev_sc = sc;
      i = hdr + 1;
    } else {
      ++i;
    }
  }
  (void)prev_sc;
  close_prev(size);
  // Trim trailing zero bytes from the last NAL (trailing_zero_8bits).
  if (!nals.empty()) {
    NalUnit& n = nals.back();
    while (n.size > 1 && data[n.offset + n.size - 1] == 0) --n.size;
  }
  return nals;
}

// Walks AVCC length-prefixed NALs inside a sample buffer.
inline std::vector<NalUnit> find_nals_avcc(const uint8_t* data, size_t size, int length_size) {
  std::vector<NalUnit> nals;
  size_t i = 0;
  while (i + length_size <= size) {
    size_t len = 0;
    for (int k = 0; k < length_size; ++k) len = (len << 8) | data[i + k];
    size_t hdr = i + length_size;
    if (len == 0 || hdr + len > size) break;
    NalUnit n;
    n.offset = hdr;
    n.size = len;
    n.start_code = 0;
    n.ref_idc = (data[hdr] >> 5) & 3;
    n.type = data[hdr] & 0x1f;
    nals.push_back(n);
    i = hdr + len;
  }
  return nals;
}

}  // namespace artc
