// Minimal MPEG-TS (ISO 13818-1) demux for H.264 streams: PAT -> PMT ->
// video PID, then reassembles the H.264 elementary stream (Annex-B) from the
// 184-byte packet payloads, recording exactly which original file bytes each
// ES byte came from. The compressor runs its normal Annex-B pipeline over
// the virtual ES; the container stores the residue ("skeleton": TS/PES
// headers, PSI, audio, padding) plus an interleave run map, and the
// decompressor weaves the regenerated ES back between the skeleton bytes to
// reproduce the original file bit-exactly.
//
// Capability note: the reference accepted TS input through libavformat
// (reference recode.cpp:92,118) but could only recompress coded blocks it
// could locate CONTIGUOUSLY in the file bytes (memmem segmentation,
// reference recode.cpp:1275-1297) — TS fragments every slice across packets,
// so the reference stores TS essentially raw. Reassembling the ES makes TS a
// first-class recompression input here.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace artc {

class TsReader {
 public:
  static constexpr size_t kPkt = 188;

  static bool looks_like_ts(const uint8_t* d, size_t n) {
    if (n < 3 * kPkt) return false;
    for (int i = 0; i < 3; ++i)
      if (d[i * kPkt] != 0x47) return false;
    return true;
  }

  // One maximal run of ES bytes at original file offset `off`.
  struct Run {
    uint64_t off;
    uint32_t len;
  };

  // Extracts the first H.264 elementary stream. Returns false when no AVC
  // PID is announced (or the stream is scrambled) — callers fall back to the
  // literal path. `es` = concatenated Annex-B bytes, `runs` = their source
  // extents in file order (maximal, non-overlapping, strictly increasing).
  static bool extract(const uint8_t* d, size_t n, std::vector<uint8_t>* es,
                      std::vector<Run>* runs) {
    int pmt_pid = -1, avc_pid = -1;
    // Pass 1: find PAT -> first program's PMT -> first H.264 stream PID.
    for (size_t p = 0; p + kPkt <= n && avc_pid < 0; p += kPkt) {
      if (d[p] != 0x47) return false;  // lost sync: refuse, don't guess
      int pid = ((d[p + 1] & 0x1F) << 8) | d[p + 2];
      bool pusi = (d[p + 1] & 0x40) != 0;
      if (!pusi) continue;
      size_t pl_off, pl_len;
      if (!payload(d, p, &pl_off, &pl_len) || pl_len < 1) continue;
      const uint8_t* s = d + pl_off;
      size_t ptr = 1 + s[0];  // pointer_field
      if (ptr + 8 > pl_len) continue;
      const uint8_t* t = s + ptr;
      size_t tl = pl_len - ptr;
      if (pid == 0 && t[0] == 0x00) {
        // PAT: program_number(2) + PMT PID(13) entries after the 8-byte
        // section header; take the first non-NIT program.
        size_t slen = ((t[1] & 0x0F) << 8) | t[2];
        size_t end = 3 + slen - 4;  // minus CRC
        for (size_t q = 8; q + 4 <= end && q + 4 <= tl; q += 4) {
          int prog = (t[q] << 8) | t[q + 1];
          int mp = ((t[q + 2] & 0x1F) << 8) | t[q + 3];
          if (prog != 0) {
            pmt_pid = mp;
            break;
          }
        }
      } else if (pid == pmt_pid && t[0] == 0x02) {
        // PMT: skip program_info, scan stream entries for type 0x1B (AVC).
        size_t slen = ((t[1] & 0x0F) << 8) | t[2];
        size_t end = 3 + slen - 4;
        if (12 > tl) continue;
        size_t pil = ((t[10] & 0x0F) << 8) | t[11];
        for (size_t q = 12 + pil; q + 5 <= end && q + 5 <= tl;) {
          int stype = t[q];
          int spid = ((t[q + 1] & 0x1F) << 8) | t[q + 2];
          size_t esl = ((t[q + 3] & 0x0F) << 8) | t[q + 4];
          if (stype == 0x1B) {
            avc_pid = spid;
            break;
          }
          q += 5 + esl;
        }
      }
    }
    if (avc_pid < 0) return false;
    // Pass 2: concatenate the AVC PID's PES payload ES bytes.
    for (size_t p = 0; p + kPkt <= n; p += kPkt) {
      int pid = ((d[p + 1] & 0x1F) << 8) | d[p + 2];
      if (pid != avc_pid) continue;
      if (d[p + 3] & 0xC0) return false;  // scrambled: cannot recompress
      bool pusi = (d[p + 1] & 0x40) != 0;
      size_t pl_off, pl_len;
      if (!payload(d, p, &pl_off, &pl_len) || pl_len == 0) continue;
      size_t skip = 0;
      if (pusi) {
        // PES header: 00 00 01 stream_id len(2) flags(2) hdr_len(1) hdr...
        if (pl_len < 9 || d[pl_off] != 0 || d[pl_off + 1] != 0 ||
            d[pl_off + 2] != 1)
          return false;  // PUSI without a PES start: unsupported layering
        skip = 9 + d[pl_off + 8];
        if (skip > pl_len) return false;
      }
      size_t off = pl_off + skip, len = pl_len - skip;
      if (len == 0) continue;
      es->insert(es->end(), d + off, d + off + len);
      if (!runs->empty() && runs->back().off + runs->back().len == off)
        runs->back().len += uint32_t(len);
      else
        runs->push_back({off, uint32_t(len)});
    }
    return !es->empty();
  }

 private:
  // Payload extent of the packet at `p` (after the adaptation field).
  static bool payload(const uint8_t* d, size_t p, size_t* off, size_t* len) {
    int afc = (d[p + 3] >> 4) & 3;
    size_t hdr = 4;
    if (afc == 0 || afc == 2) return false;  // no payload
    if (afc == 3) {
      size_t al = d[p + 4];
      hdr = 5 + al;
      if (hdr > kPkt) return false;
    }
    *off = p + hdr;
    *len = kPkt - hdr;
    return true;
  }
};

}  // namespace artc
