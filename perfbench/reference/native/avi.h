// Minimal RIFF/AVI demux for H.264 video: walks the RIFF tree to the 'movi'
// LIST and enumerates video frame chunks ('##dc'/'##db'), whose payloads
// carry Annex-B access units. Scanning NALs per chunk payload (instead of
// over the whole file) keeps AVI chunk headers / index data out of NAL
// extents, so every slice keeps a clean file extent and the headers stay in
// literal runs (compressed by the side-byte coder).
//
// Reference parity: the reference accepted AVI through libavformat
// (reference recode.cpp:92,118); this gives the framework the same input
// class natively.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace artc {

class AviReader {
 public:
  static bool looks_like_avi(const uint8_t* d, size_t n) {
    return n >= 12 && memcmp(d, "RIFF", 4) == 0 && memcmp(d + 8, "AVI ", 4) == 0;
  }

  // Payload extents (offset, size) of video frame chunks, file order.
  static void video_chunks(const uint8_t* d, size_t n,
                           std::vector<std::pair<size_t, size_t>>* out) {
    walk(d, 12, n, out, 0);
  }

 private:
  static uint32_t u32le(const uint8_t* p) {
    return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
           uint32_t(p[3]) << 24;
  }

  // True for '##dc' / '##db' (compressed / uncompressed video frame).
  static bool is_video_chunk(const uint8_t* id) {
    return id[0] >= '0' && id[0] <= '9' && id[1] >= '0' && id[1] <= '9' &&
           id[2] == 'd' && (id[3] == 'c' || id[3] == 'b');
  }

  static void walk(const uint8_t* d, size_t p, size_t end,
                   std::vector<std::pair<size_t, size_t>>* out, int depth) {
    if (depth > 8) return;
    while (p + 8 <= end) {
      const uint8_t* id = d + p;
      uint64_t size = u32le(d + p + 4);
      size_t body = p + 8;
      if (body + size > end) return;  // truncated: stop cleanly
      if (memcmp(id, "LIST", 4) == 0 || memcmp(id, "RIFF", 4) == 0) {
        // LIST body = 4-byte type + children; recurse into movi and 'rec '
        // groups (frames may be grouped for interleaving), skip the rest.
        if (size >= 4) {
          const uint8_t* ty = d + body;
          if (memcmp(ty, "movi", 4) == 0 || memcmp(ty, "rec ", 4) == 0)
            walk(d, body + 4, body + size, out, depth + 1);
        }
      } else if (is_video_chunk(id) && size > 0) {
        out->emplace_back(body, size_t(size));
      }
      p = body + size + (size & 1);  // chunks pad to even
    }
  }
};

}  // namespace artc
