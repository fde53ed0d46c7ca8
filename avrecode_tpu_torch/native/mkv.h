// Minimal Matroska (MKV/WebM) demux for H.264 tracks: parses the EBML tree
// for TrackEntry CodecPrivate (avcC: SPS/PPS + NAL length size) and
// enumerates AVCC sample extents from SimpleBlock / BlockGroup>Block
// payloads, which are contiguous in-file — so every slice NAL keeps a
// first-class file extent, same as the ISO-BMFF path (mp4.h).
//
// Reference parity: the reference accepted MKV input through libavformat
// (reference recode.cpp:92 avformat_open_input, :118 av_read_frame); this
// gives the framework the same input class natively. Laced blocks (rare for
// video) are left un-enumerated: their bytes stay in literal runs, which the
// v13 side-byte coder still compresses — correctness is never at stake.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "mp4.h"  // Mp4Track + avcC parsing (ISO 14496-15 config record)

namespace artc {

class MkvReader {
 public:
  static bool looks_like_mkv(const uint8_t* d, size_t n) {
    return n >= 4 && d[0] == 0x1A && d[1] == 0x45 && d[2] == 0xDF && d[3] == 0xA3;
  }

  struct Block {
    uint64_t track;
    size_t offset;  // file offset of the AVCC payload (after the block header)
    size_t size;
  };
  struct Track {
    uint64_t number = 0;
    Mp4Track cfg;  // avcC config (SPS/PPS + NAL length size)
  };

  // Parses tracks (avcC config per AVC track) and block payload extents.
  static void read(const uint8_t* d, size_t n, std::vector<Track>* tracks,
                   std::vector<Block>* blocks) {
    walk(d, 0, n, tracks, blocks, /*depth=*/0);
  }

 private:
  // EBML element id: 1-4 bytes, length marker kept IN the value (matroska
  // convention). Returns 0 on malformed input.
  static uint64_t read_id(const uint8_t* d, size_t& p, size_t end) {
    if (p >= end) return 0;
    uint8_t b = d[p];
    int len = b & 0x80 ? 1 : b & 0x40 ? 2 : b & 0x20 ? 3 : b & 0x10 ? 4 : 0;
    if (!len || p + len > end) return 0;
    uint64_t v = 0;
    for (int i = 0; i < len; ++i) v = (v << 8) | d[p + i];
    p += len;
    return v;
  }

  // EBML size: 1-8 bytes, marker bit removed; all-value-bits-set = unknown.
  static constexpr uint64_t kUnknown = ~0ull;
  static uint64_t read_size(const uint8_t* d, size_t& p, size_t end) {
    if (p >= end) return kUnknown;
    uint8_t b = d[p];
    int len = 0;
    for (int i = 0; i < 8; ++i)
      if (b & (0x80 >> i)) { len = i + 1; break; }
    if (!len || p + len > end) return kUnknown;
    uint64_t v = b & (0xFF >> len);
    for (int i = 1; i < len; ++i) v = (v << 8) | d[p + i];
    p += len;
    // all value bits set = unknown size (stream until parent end)
    uint64_t all = (len == 8) ? ~0ull >> 8 : (1ull << (7 * len)) - 1;
    return v == all ? kUnknown : v;
  }

  struct TrackTmp {
    uint64_t number = 0;
    bool is_avc_codec = false;
    std::vector<uint8_t> codec_private;
  };

  static void walk(const uint8_t* d, size_t begin, size_t end,
                   std::vector<Track>* tracks, std::vector<Block>* blocks,
                   int depth, TrackTmp* cur_track = nullptr) {
    size_t p = begin;
    while (p < end) {
      uint64_t id = read_id(d, p, end);
      if (!id) return;
      uint64_t sz = read_size(d, p, end);
      size_t body = p;
      size_t body_end = sz == kUnknown ? end : body + sz;
      if (body_end > end || body_end < body) body_end = end;
      switch (id) {
        case 0x18538067:   // Segment
        case 0x1654AE6B:   // Tracks
        case 0x1F43B675:   // Cluster
        case 0xA0:         // BlockGroup
          if (depth < 8) walk(d, body, body_end, tracks, blocks, depth + 1);
          break;
        case 0xAE: {  // TrackEntry
          TrackTmp t;
          if (depth < 8) walk(d, body, body_end, tracks, blocks, depth + 1, &t);
          if (t.is_avc_codec && !t.codec_private.empty()) {
            Track mt;
            mt.number = t.number;
            Mp4Reader::parse_avcc(t.codec_private.data(), t.codec_private.size(),
                                  mt.cfg);
            if (mt.cfg.is_avc) tracks->push_back(std::move(mt));
          }
          break;
        }
        case 0xD7:  // TrackNumber
          if (cur_track) {
            uint64_t v = 0;
            for (size_t i = body; i < body_end; ++i) v = (v << 8) | d[i];
            cur_track->number = v;
          }
          break;
        case 0x86:  // CodecID
          if (cur_track)
            cur_track->is_avc_codec =
                body_end - body >= 15 &&
                memcmp(d + body, "V_MPEG4/ISO/AVC", 15) == 0;
          break;
        case 0x63A2:  // CodecPrivate
          if (cur_track) cur_track->codec_private.assign(d + body, d + body_end);
          break;
        case 0xA3:    // SimpleBlock
        case 0xA1: {  // Block (inside BlockGroup)
          size_t q = body;
          // Block header: track number (EBML varint, marker removed),
          // s16 relative timecode, u8 flags.
          uint64_t tn = read_size(d, q, body_end);
          if (tn == kUnknown || q + 3 > body_end) break;
          uint8_t flags = d[q + 2];
          q += 3;
          int lacing = (flags >> 1) & 3;
          if (lacing != 0) break;  // laced video blocks: leave as literals
          blocks->push_back({tn, q, body_end - q});
          break;
        }
        default:
          break;  // skip leaf
      }
      if (sz == kUnknown) {
        // Unknown-size element (typically Segment/Cluster while streaming):
        // its children were parsed to `end` above; nothing follows.
        return;
      }
      p = body_end;
    }
  }
};

}  // namespace artc
