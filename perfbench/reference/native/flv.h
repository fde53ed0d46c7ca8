// Minimal FLV demux for H.264 video: walks the tag stream, takes the AVC
// sequence header (AVCDecoderConfigurationRecord — the same ISO 14496-15
// record mp4.h parses) from the AVCPacketType-0 video tag, and enumerates
// the AVCC-framed sample extents of the AVCPacketType-1 tags, so CABAC/CAVLC
// slice NALs inside tag payloads recompress in place while every other byte
// of the file travels as a literal.
//
// Reference parity: the reference accepted FLV through libavformat
// (reference recode.cpp:92, 118); this gives the framework the same input
// class natively.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace artc {

class FlvReader {
 public:
  static bool looks_like_flv(const uint8_t* d, size_t n) {
    return n >= 9 && d[0] == 'F' && d[1] == 'L' && d[2] == 'V' && d[3] == 1;
  }

  struct Video {
    std::vector<uint8_t> avcc;  // decoder configuration record (may be empty)
    // (offset, size) extents of AVCC-framed sample data inside video tags.
    std::vector<std::pair<size_t, size_t>> samples;
  };

  static bool read(const uint8_t* d, size_t n, Video* out) {
    if (!looks_like_flv(d, n)) return false;
    uint64_t data_off = u32be(d + 5);
    if (data_off < 9 || data_off + 4 > n) return false;
    size_t p = size_t(data_off) + 4;  // skip PreviousTagSize0
    while (p + 11 <= n) {
      uint8_t type = d[p];
      uint32_t dsize = u24be(d + p + 1);
      size_t body = p + 11;
      if (body + dsize + 4 > n) break;  // truncated tail: stop cleanly
      if (type == 9 && dsize >= 5 && (d[body] & 0x0f) == 7) {
        // VideoTagHeader: frame_type<<4 | codec_id(7 = AVC), then
        // AVCPacketType (0 = sequence header, 1 = NALU) + s24 cts.
        uint8_t pkt = d[body + 1];
        if (pkt == 0)
          out->avcc.assign(d + body + 5, d + body + dsize);
        else if (pkt == 1 && dsize > 5)
          out->samples.emplace_back(body + 5, dsize - 5);
      }
      p = body + dsize + 4;  // skip PreviousTagSize
    }
    return !out->avcc.empty() && !out->samples.empty();
  }

 private:
  static uint32_t u32be(const uint8_t* p) {
    return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
  }
  static uint32_t u24be(const uint8_t* p) {
    return uint32_t(p[0]) << 16 | uint32_t(p[1]) << 8 | p[2];
  }
};

}  // namespace artc
