// Adaptive order-1 byte coder for the container's verbatim side bytes
// (literal runs, slice headers, parameter sets, tail patches).
//
// The reference stored all of this raw and acknowledged the resulting
// overhead loss on small files (reference recode.cpp:1608-1618 prints the
// "overhead" line; its protobuf packaging could expand tiny inputs
// unboundedly). Here every byte the container would store verbatim runs
// through a small context-modeled binary coder over the same K-lane rANS
// codec as the main stream, with a store fallback when it does not pay
// (incompressible payloads cost 2 bytes of flag+length, never a blowup).
//
// Model: order-1 bit-tree — context = previous byte, then a 255-node binary
// tree over the current byte's bits, each node a counting estimator with
// window halving. 256 KB of state, no tables to ship; encoder and decoder
// replay identical updates (same pattern as the main PriorModel).
#pragma once

#include <cstdint>
#include <vector>

#include "rans.h"

namespace artc {

class ByteModel {
 public:
  ByteModel() : est_(256 * 256, {1, 1}) {}

  // Probability (q15) that the next bit at `node` is 1, given prev-byte ctx.
  uint32_t prob(int node) const {
    const Est& e = est_[ctx_ * 256 + node];
    uint32_t p = (uint32_t(e.pos) << 15) / (uint32_t(e.pos) + e.neg);
    return p < 1 ? 1 : (p > 32767 ? 32767 : p);
  }

  void update(int node, int bit) {
    Est& e = est_[ctx_ * 256 + node];
    if (bit) ++e.pos; else ++e.neg;
    if (e.pos + e.neg > kWindow) {
      e.pos = uint16_t((e.pos + 1) >> 1);
      e.neg = uint16_t((e.neg + 1) >> 1);
    }
  }

  void set_prev(uint8_t b) { ctx_ = b; }

 private:
  struct Est {
    uint16_t pos, neg;
  };
  static constexpr uint32_t kWindow = 1024;
  std::vector<Est> est_;
  int ctx_ = 0;
};

// Encodes `raw` with the byte model into a RansInterleaved blob.
inline std::vector<uint8_t> bytemodel_encode(const std::vector<uint8_t>& raw,
                                             int lanes = 4) {
  ByteModel m;
  std::vector<uint8_t> bits;
  std::vector<uint16_t> probs;
  bits.reserve(raw.size() * 8);
  probs.reserve(raw.size() * 8);
  for (uint8_t b : raw) {
    int node = 1;
    for (int i = 7; i >= 0; --i) {
      int bit = (b >> i) & 1;
      bits.push_back(uint8_t(bit));
      probs.push_back(uint16_t(m.prob(node)));
      m.update(node, bit);
      node = node * 2 + bit;
    }
    m.set_prev(b);
  }
  return RansInterleaved::encode(bits, probs, lanes);
}

// Decodes `n` bytes from a RansInterleaved blob written by bytemodel_encode.
inline std::vector<uint8_t> bytemodel_decode(const uint8_t* blob, size_t blob_len,
                                             size_t n) {
  ByteModel m;
  RansInterleavedDecoder dec(blob, blob_len);
  std::vector<uint8_t> out;
  out.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    int node = 1;
    for (int k = 0; k < 8; ++k) {
      int bit = dec.decode(m.prob(node));
      m.update(node, bit);
      node = node * 2 + bit;
    }
    uint8_t b = uint8_t(node & 0xff);
    out.push_back(b);
    m.set_prev(b);
  }
  return out;
}

}  // namespace artc
