// Minimal ISO-BMFF (MP4) reader: locates the AVC decoder configuration
// (avcC: SPS/PPS + NAL length size) and enumerates video sample extents via
// the stbl tables (stsd/stsz/stsc/stco/co64), so CABAC slice NALs inside mdat
// can be recompressed in place while every other byte of the file travels as a
// literal.
//
// Reference parity: the reference gets demux from libavformat and re-locates
// slice payloads with memmem (reference recode.cpp:92, 1275-1297); explicit
// sample tables make segmentation exact (SURVEY.md §7 hard-part 5).
#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace artc {

struct Mp4Track {
  bool is_avc = false;
  int nal_length_size = 4;
  uint32_t track_id = 0;
  std::vector<std::vector<uint8_t>> sps;  // RBSP-domain? no: raw EBSP NAL payloads incl header byte
  std::vector<std::vector<uint8_t>> pps;
  std::vector<uint64_t> sample_offsets;
  std::vector<uint32_t> sample_sizes;
};

class Mp4Reader {
 public:
  // Quick sniff: does this look like an ISO-BMFF file?
  static bool looks_like_mp4(const uint8_t* data, size_t size) {
    if (size < 16) return false;
    uint32_t t = rd32(data + 4);
    return t == tag("ftyp") || t == tag("moov") || t == tag("mdat") || t == tag("free") ||
           t == tag("styp") || t == tag("wide");
  }

 private:
  struct Ctx {
    const uint8_t* data;
    size_t size;
  };
  struct TrackBuild {
    Mp4Track t;
    std::vector<uint32_t> stsz;
    uint32_t stsz_fixed = 0;
    std::vector<uint64_t> chunk_offsets;
    struct StscEntry { uint32_t first_chunk, samples_per_chunk; };
    std::vector<StscEntry> stsc;
  };

  static uint32_t rd32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
  }
  static uint64_t rd64(const uint8_t* p) { return (uint64_t(rd32(p)) << 32) | rd32(p + 4); }
  static constexpr uint32_t tag(const char s[5]) {
    return (uint32_t(s[0]) << 24) | (uint32_t(s[1]) << 16) | (uint32_t(s[2]) << 8) | s[3];
  }

 public:
  // Full-track parse: returns tracks with resolved per-sample offsets.
  // Handles both plain MP4 (stbl sample tables) and fragmented MP4
  // (DASH/CMAF: moof/traf/trun runs with tfhd/trex defaults) — the reference
  // ingests fMP4 through libavformat (reference recode.cpp:92, 118); here the
  // fragment walk makes the sample extents explicit.
  static std::vector<Mp4Track> read_tracks(const uint8_t* data, size_t size) {
    std::vector<Mp4Track> out;
    std::map<uint32_t, uint32_t> trex_size;  // track_id -> default_sample_size
    Ctx c{data, size};
    iterate_boxes(c, 0, size, [&](uint32_t type, size_t body, size_t body_end) {
      if (type == tag("moov")) {
        iterate_boxes(c, body, body_end, [&](uint32_t t2, size_t b2, size_t e2) {
          if (t2 == tag("trak")) {
            TrackBuild tb;
            parse_trak(c, b2, e2, tb);
            if (tb.t.is_avc) {
              resolve_samples(tb);
              out.push_back(std::move(tb.t));
            }
          } else if (t2 == tag("mvex")) {
            iterate_boxes(c, b2, e2, [&](uint32_t t3, size_t b3, size_t e3) {
              if (t3 == tag("trex") && b3 + 20 <= e3)
                trex_size[rd32(c.data + b3 + 4)] = rd32(c.data + b3 + 16);
            });
          }
        });
      }
    });
    // Fragment pass (no-op on non-fragmented files): top-level moof boxes
    // append sample runs to the matching track. Manual walk because the
    // traf offset bookkeeping needs the moof box START, not just its body.
    std::map<uint32_t, Mp4Track*> by_id;
    for (auto& t : out) by_id[t.track_id] = &t;
    size_t p = 0;
    while (p + 8 <= size) {
      uint64_t bs = rd32(data + p);
      size_t hdr = 8;
      uint32_t bt = rd32(data + p + 4);
      if (bs == 1) {
        if (p + 16 > size) break;
        bs = rd64(data + p + 8);
        hdr = 16;
      } else if (bs == 0) {
        bs = size - p;
      }
      if (bs < hdr || p + bs > size) break;
      if (bt == tag("moof")) parse_moof(c, p, p + hdr, p + bs, by_id, trex_size);
      p += bs;
    }
    return out;
  }

 private:
  template <class F>
  static void iterate_boxes(Ctx& c, size_t begin, size_t end, F&& f) {
    size_t p = begin;
    while (p + 8 <= end) {
      uint64_t box_size = rd32(c.data + p);
      uint32_t box_type = rd32(c.data + p + 4);
      size_t hdr = 8;
      if (box_size == 1) {
        if (p + 16 > end) break;
        box_size = rd64(c.data + p + 8);
        hdr = 16;
      } else if (box_size == 0) {
        box_size = end - p;
      }
      if (box_size < hdr || p + box_size > end) break;
      f(box_type, p + hdr, p + box_size);
      p += box_size;
    }
  }

  // One moof box: each traf's tfhd supplies the track + defaults, each trun
  // enumerates a contiguous sample run. Offset rules (ISO 14496-12 §8.8.7):
  // base = explicit tfhd base_data_offset when flag 0x1, else the moof start
  // (the default-base-is-moof case and the first-traf convention coincide
  // there); a trun's data_offset is relative to base; a trun without one
  // continues where the previous run ended.
  static void parse_moof(Ctx& c, size_t moof_start, size_t begin, size_t end,
                         std::map<uint32_t, Mp4Track*>& by_id,
                         const std::map<uint32_t, uint32_t>& trex_size) {
    iterate_boxes(c, begin, end, [&](uint32_t t, size_t b, size_t e) {
      if (t != tag("traf")) return;
      const uint8_t* d = c.data;
      uint64_t base = moof_start;
      uint32_t track_id = 0, def_size = 0;
      iterate_boxes(c, b, e, [&](uint32_t t2, size_t b2, size_t e2) {
        if (t2 != tag("tfhd") || b2 + 8 > e2) return;
        uint32_t flags = rd32(d + b2) & 0xffffff;
        track_id = rd32(d + b2 + 4);
        size_t p = b2 + 8;
        if (flags & 0x1) {  // base-data-offset-present
          if (p + 8 <= e2) base = rd64(d + p);
          p += 8;
        }
        if (flags & 0x2) p += 4;  // sample-description-index
        if (flags & 0x8) p += 4;  // default-sample-duration
        if (flags & 0x10 && p + 4 <= e2) def_size = rd32(d + p);
      });
      auto it = by_id.find(track_id);
      if (it == by_id.end()) return;
      Mp4Track* trk = it->second;
      if (!def_size) {
        auto tx = trex_size.find(track_id);
        if (tx != trex_size.end()) def_size = tx->second;
      }
      uint64_t run_off = base;
      iterate_boxes(c, b, e, [&](uint32_t t2, size_t b2, size_t e2) {
        if (t2 != tag("trun") || b2 + 8 > e2) return;
        uint32_t flags = rd32(d + b2) & 0xffffff;
        uint32_t n = rd32(d + b2 + 4);
        size_t p = b2 + 8;
        uint64_t off = run_off;
        if (flags & 0x1) {  // data-offset-present (signed, relative to base)
          if (p + 4 > e2) return;
          off = base + int64_t(int32_t(rd32(d + p)));
          p += 4;
        }
        if (flags & 0x4) p += 4;  // first-sample-flags
        for (uint32_t s = 0; s < n; ++s) {
          uint32_t sz = def_size;
          if (flags & 0x100) p += 4;  // sample-duration
          if (flags & 0x200) {        // sample-size
            if (p + 4 > e2) return;
            sz = rd32(d + p);
            p += 4;
          }
          if (flags & 0x400) p += 4;  // sample-flags
          if (flags & 0x800) p += 4;  // sample-composition-time-offset
          if (!sz || off + sz > c.size) return;
          trk->sample_offsets.push_back(off);
          trk->sample_sizes.push_back(sz);
          off += sz;
        }
        run_off = off;
      });
    });
  }

  static void parse_trak(Ctx& c, size_t begin, size_t end, TrackBuild& tb) {
    iterate_boxes(c, begin, end, [&](uint32_t t, size_t b, size_t e) {
      if (t == tag("tkhd") && b + 4 <= e) {
        int ver = c.data[b];
        size_t idoff = b + 4 + (ver == 1 ? 16 : 8);  // skip create/modify times
        if (idoff + 4 <= e) tb.t.track_id = rd32(c.data + idoff);
      }
      if (t == tag("mdia")) {
        iterate_boxes(c, b, e, [&](uint32_t t2, size_t b2, size_t e2) {
          if (t2 == tag("minf")) {
            iterate_boxes(c, b2, e2, [&](uint32_t t3, size_t b3, size_t e3) {
              if (t3 == tag("stbl")) parse_stbl(c, b3, e3, tb);
            });
          }
        });
      }
    });
  }

  static void parse_stbl(Ctx& c, size_t begin, size_t end, TrackBuild& tb) {
    iterate_boxes(c, begin, end, [&](uint32_t t, size_t b, size_t e) {
      const uint8_t* d = c.data;
      if (t == tag("stsd")) {
        if (b + 8 > e) return;
        uint32_t n = rd32(d + b + 4);
        size_t p = b + 8;
        for (uint32_t i = 0; i < n && p + 8 <= e; ++i) {
          uint32_t esz = rd32(d + p);
          uint32_t etype = rd32(d + p + 4);
          if (esz < 8 || p + esz > e) break;
          if (etype == tag("avc1") || etype == tag("avc3")) {
            // VisualSampleEntry: 8 hdr + 78 fixed fields, then boxes (avcC...)
            size_t q = p + 8 + 78;
            iterate_boxes(c, q, p + esz, [&](uint32_t t4, size_t b4, size_t e4) {
              if (t4 == tag("avcC")) parse_avcc(d + b4, e4 - b4, tb.t);
            });
          }
          p += esz;
        }
      } else if (t == tag("stsz")) {
        if (b + 12 > e) return;
        tb.stsz_fixed = rd32(d + b + 4);
        uint32_t n = rd32(d + b + 8);
        if (tb.stsz_fixed == 0)
          for (uint32_t i = 0; i < n && b + 12 + 4 * i + 4 <= e; ++i)
            tb.stsz.push_back(rd32(d + b + 12 + 4 * i));
        else
          tb.stsz.assign(n, tb.stsz_fixed);
      } else if (t == tag("stco")) {
        uint32_t n = rd32(d + b + 4);
        for (uint32_t i = 0; i < n && b + 8 + 4 * i + 4 <= e; ++i)
          tb.chunk_offsets.push_back(rd32(d + b + 8 + 4 * i));
      } else if (t == tag("co64")) {
        uint32_t n = rd32(d + b + 4);
        for (uint32_t i = 0; i < n && b + 8 + 8 * i + 8 <= e; ++i)
          tb.chunk_offsets.push_back(rd64(d + b + 8 + 8 * i));
      } else if (t == tag("stsc")) {
        uint32_t n = rd32(d + b + 4);
        for (uint32_t i = 0; i < n && b + 8 + 12 * i + 12 <= e; ++i)
          tb.stsc.push_back({rd32(d + b + 8 + 12 * i), rd32(d + b + 8 + 12 * i + 4)});
      }
    });
  }

 public:
  // Also consumed by the Matroska reader (mkv.h): CodecPrivate for
  // V_MPEG4/ISO/AVC tracks is the same ISO 14496-15 config record.
  static void parse_avcc(const uint8_t* d, size_t n, Mp4Track& t) {
    if (n < 7) return;
    t.is_avc = true;
    t.nal_length_size = (d[4] & 3) + 1;
    size_t p = 5;
    int num_sps = d[p++] & 0x1f;
    for (int i = 0; i < num_sps && p + 2 <= n; ++i) {
      uint16_t len = (d[p] << 8) | d[p + 1];
      p += 2;
      if (p + len > n) return;
      t.sps.emplace_back(d + p, d + p + len);
      p += len;
    }
    if (p >= n) return;
    int num_pps = d[p++];
    for (int i = 0; i < num_pps && p + 2 <= n; ++i) {
      uint16_t len = (d[p] << 8) | d[p + 1];
      p += 2;
      if (p + len > n) return;
      t.pps.emplace_back(d + p, d + p + len);
      p += len;
    }
  }

  static void resolve_samples(TrackBuild& tb) {
    // stsc maps chunks -> samples-per-chunk; walk chunks accumulating offsets.
    size_t sample = 0;
    size_t n_samples = tb.stsz.size();
    for (size_t ci = 0; ci < tb.chunk_offsets.size() && sample < n_samples; ++ci) {
      uint32_t spc = 1;
      for (size_t k = 0; k < tb.stsc.size(); ++k) {
        if (tb.stsc[k].first_chunk <= ci + 1) spc = tb.stsc[k].samples_per_chunk;
        else break;
      }
      uint64_t off = tb.chunk_offsets[ci];
      for (uint32_t s = 0; s < spc && sample < n_samples; ++s, ++sample) {
        tb.t.sample_offsets.push_back(off);
        tb.t.sample_sizes.push_back(tb.stsz[sample]);
        off += tb.stsz[sample];
      }
    }
  }
};

}  // namespace artc
