// Minimal MPEG-PS (program stream) demux for H.264 video: walks the pack /
// system-header / PES layering and extracts the first video stream's
// elementary bytes plus their source extents. Rides the same transport
// machinery as MPEG-TS (the v17 run map is format-agnostic: "skip k skeleton
// bytes, take n ES bytes" reproduces ANY packetization byte-exactly), so PS
// needs no container change.
//
// Reference parity: the reference accepted MPEG-PS through libavformat
// (reference recode.cpp:92, 118) — and, like TS, its memmem segmentation
// could not locate PES-fragmented slices, so it stored PS essentially raw.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "ts.h"  // TsReader::Run — the shared transport run descriptor

namespace artc {

class PsReader {
 public:
  static bool looks_like_ps(const uint8_t* d, size_t n) {
    return n >= 14 && d[0] == 0 && d[1] == 0 && d[2] == 1 && d[3] == 0xBA;
  }

  // Extracts the first video (0xE0-0xEF) stream's ES. Returns false on any
  // structure this reader does not fully understand (MPEG-1-style PES,
  // scrambling, lost sync) — callers fall back to the literal path, which is
  // always bit-exact. `es` = concatenated payload bytes, `runs` = their
  // source extents in file order (maximal, non-overlapping, increasing).
  static bool extract(const uint8_t* d, size_t n, std::vector<uint8_t>* es,
                      std::vector<TsReader::Run>* runs) {
    if (!looks_like_ps(d, n)) return false;
    int video_id = -1;
    size_t p = 0;
    auto flush = [&](size_t off, size_t len) {
      if (!len) return;
      if (!runs->empty() && runs->back().off + runs->back().len == off) {
        runs->back().len += uint32_t(len);
      } else {
        runs->push_back({uint64_t(off), uint32_t(len)});
      }
      es->insert(es->end(), d + off, d + off + len);
    };
    while (p + 4 <= n) {
      if (d[p] != 0 || d[p + 1] != 0 || d[p + 2] != 1) return false;  // lost sync
      uint8_t id = d[p + 3];
      if (id == 0xB9) break;  // MPEG_program_end_code
      if (id == 0xBA) {       // pack header
        if (p + 14 > n) return false;
        if ((d[p + 4] >> 6) == 1) {            // MPEG-2: '01' marker
          p += 14 + (d[p + 13] & 7);           // + stuffing
        } else if ((d[p + 4] >> 4) == 2) {     // MPEG-1: '0010' marker
          p += 12;
        } else {
          return false;
        }
        continue;
      }
      if (id < 0xBB) return false;  // unexpected at pack level
      if (p + 6 > n) return false;
      size_t len = (size_t(d[p + 4]) << 8) | d[p + 5];
      size_t body = p + 6, end = body + len;
      if (end > n) return false;
      if (id >= 0xE0 && id <= 0xEF && (video_id < 0 || id == video_id)) {
        size_t skip;
        if (len >= 3 && (d[body] & 0xC0) == 0x80) {
          // MPEG-2 PES header: '10' marker, flags, header_data_length.
          if (d[body] & 0x30) return false;  // scrambled: cannot recompress
          skip = 3 + d[body + 2];
        } else {
          // MPEG-1 PES header: stuffing 0xFF*, optional STD ('01......',
          // 2 bytes), then PTS ('0010', 5), PTS+DTS ('0011', 10) or 0x0F.
          size_t q = 0;
          while (q < len && d[body + q] == 0xFF) ++q;
          if (q < len && (d[body + q] & 0xC0) == 0x40) q += 2;
          if (q >= len) return false;
          uint8_t b = d[body + q];
          if ((b >> 4) == 2) q += 5;
          else if ((b >> 4) == 3) q += 10;
          else if (b == 0x0F) q += 1;
          else return false;
          skip = q;
        }
        if (skip > len) return false;
        video_id = id;
        flush(body + skip, len - skip);
      }
      p = end;  // system header / PSM / audio / private: skeleton bytes
    }
    return video_id >= 0 && !es->empty();
  }
};

}  // namespace artc
