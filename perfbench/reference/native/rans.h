// Binary rANS entropy coder with per-bin adaptive 15-bit probabilities —
// the recoded-stream format's lane codec.
//
// Design rationale (SURVEY.md §2.1 TPU note, §7): the reference uses a serial
// carry-propagating 64-bit range coder (reference arithmetic_code.h:31-320).
// rANS is carry-free, and because encoding runs in *reverse* over
// probabilities that are precomputed by the model pass, K interleaved lanes
// encode independently — exactly the structure a TPU vectorizes (one lane per
// VPU element). Decode is forward and strictly sequential per lane, matching
// the host serial decompressor. Both are bit-compatible with the JAX lane
// kernels in avrecode_tpu/ops/.
#pragma once

#include <cstdint>
#include <stdexcept>
#include <thread>
#include <vector>

namespace artc {

constexpr int kProbBits = 15;
constexpr uint32_t kProbScale = 1u << kProbBits;  // M
constexpr uint32_t kRansL = 1u << 16;             // normalized interval [L, L<<16)

// Exact division by the per-bin frequency via round-up magic multipliers:
// floor(x/f) == (x * ceil(2^48/f)) >> 48 for x < 2^32, f <= 2^15
// (excess e < 1 in the magic adds x*e/2^48 < 2^-16 to x/f, which cannot
// cross the next integer since frac(x/f) <= 1 - 1/f <= 1 - 2^-15). The
// encoder's x/f sits on the serial state chain — a ~25-cycle divide per
// bin; the 128-bit multiply is ~5. Table indexed by f (256 KB, L2-resident;
// the load is off the critical chain since f comes straight from probs[i]).
struct RansDivMagic {
  uint64_t m[kProbScale + 1];
  RansDivMagic() {
    m[0] = 0;
    for (uint64_t f = 1; f <= kProbScale; ++f)
      m[f] = ((uint64_t(1) << 48) + f - 1) / f;
  }
};
inline const RansDivMagic rans_div_magic_{};

// Encodes one lane's (bit, p1) pairs in reverse; produces a forward-decodable
// word stream (uint16 little-endian on the wire).
class RansLaneEncoder {
 public:
  // pairs processed from index `begin` stepping by `stride` over `bits`/`probs`
  // (the interleaving); call encode_all once.
  static std::vector<uint16_t> encode(const uint8_t* bits, const uint16_t* probs, size_t n,
                                      size_t begin, size_t stride) {
    // collect this lane's indices (reverse order)
    std::vector<uint16_t> words;
    uint32_t x = kRansL;
    // iterate lane elements in reverse
    if (n > begin) {
      size_t count = (n - 1 - begin) / stride + 1;
      for (size_t j = count; j-- > 0;) {
        size_t i = begin + j * stride;
        uint32_t p1 = probs[i];
        uint32_t f = bits[i] ? p1 : kProbScale - p1;
        uint32_t c = bits[i] ? kProbScale - p1 : 0;
        // renorm: x must stay < (L>>kProbBits)<<16)*f after push
        uint32_t x_max = f << (16 + 1);  // ((L>>15)<<16)*f = 2*f<<16
        if (x >= x_max) {
          words.push_back(uint16_t(x & 0xffff));
          x >>= 16;
        }
        // q < 2^17 (renorm keeps x < f<<17), so q << 15 fits in 32 bits.
        uint32_t q = uint32_t((unsigned __int128)x * rans_div_magic_.m[f] >> 48);
        x = (q << kProbBits) + (x - q * f) + c;
      }
    }
    words.push_back(uint16_t(x & 0xffff));
    words.push_back(uint16_t(x >> 16));
    // reverse so the decoder reads forward
    std::vector<uint16_t> out(words.rbegin(), words.rend());
    return out;
  }
};

class RansLaneDecoder {
 public:
  RansLaneDecoder() = default;
  void init(const uint16_t* words, size_t n) {
    words_ = words;
    n_ = n;
    pos_ = 0;
    if (n_ < 2) throw std::runtime_error("rans lane stream too short");
    x_ = (uint32_t(words_[0]) << 16) | words_[1];
    pos_ = 2;
  }
  int decode(uint32_t p1) {
    uint32_t f0 = kProbScale - p1;
    uint32_t s = x_ & (kProbScale - 1);
    int bit = s >= f0;
    uint32_t f = bit ? p1 : f0;
    uint32_t c = bit ? f0 : 0;
    x_ = f * (x_ >> kProbBits) + s - c;
    if (x_ < kRansL) {
      if (pos_ < n_) {
        x_ = (x_ << 16) | words_[pos_++];
      } else {
        x_ <<= 16;  // should not occur on well-formed input
      }
    }
    return bit;
  }

 private:
  const uint16_t* words_ = nullptr;
  size_t n_ = 0, pos_ = 0;
  uint32_t x_ = 0;
};

// K-lane interleaved codec over a full (bit, prob) sequence: bin i belongs to
// lane i % K. Wire format: [u32 K][u32 n_bins][u32 lane_len[K] in u16 words]
// [lane word streams, little-endian u16]. K is per-blob so the device path
// can use wide lanes (TPU vector width) on large chunks while small chunks
// stay lean.
struct RansInterleaved {
  static std::vector<uint8_t> encode(const std::vector<uint8_t>& bits,
                                     const std::vector<uint16_t>& probs, int K) {
    std::vector<uint8_t> out;
    auto put32 = [&out](uint32_t v) {
      out.push_back(v & 0xff);
      out.push_back((v >> 8) & 0xff);
      out.push_back((v >> 16) & 0xff);
      out.push_back((v >> 24) & 0xff);
    };
    put32(uint32_t(K));
    put32(uint32_t(bits.size()));
    std::vector<std::vector<uint16_t>> lanes(K);
    // Lanes encode independently; split them across a second thread for
    // large streams (output is byte-identical — assembly order is fixed).
    auto run = [&](int lo, int hi) {
      for (int l = lo; l < hi; ++l)
        lanes[l] = RansLaneEncoder::encode(bits.data(), probs.data(), bits.size(), l, K);
    };
    if (K >= 2 && bits.size() >= (1u << 20) && std::thread::hardware_concurrency() > 1) {
      std::thread t(run, 0, K / 2);
      run(K / 2, K);
      t.join();
    } else {
      run(0, K);
    }
    for (int l = 0; l < K; ++l) put32(uint32_t(lanes[l].size()));
    for (int l = 0; l < K; ++l)
      for (uint16_t w : lanes[l]) {
        out.push_back(w & 0xff);
        out.push_back(w >> 8);
      }
    return out;
  }
};

// Streaming K-lane decoder (forward order; used by the serial decompressor).
class RansInterleavedDecoder {
 public:
  // The lane count comes from the blob itself.
  explicit RansInterleavedDecoder(const uint8_t* data, size_t size) {
    auto get32 = [&]() {
      if (pos_ + 4 > size) throw std::runtime_error("rans chunk truncated");
      uint32_t v = data[pos_] | (data[pos_ + 1] << 8) | (data[pos_ + 2] << 16) |
                   (uint32_t(data[pos_ + 3]) << 24);
      pos_ += 4;
      return v;
    };
    K_ = int(get32());
    if (K_ < 1 || K_ > 65536) throw std::runtime_error("bad lane count");
    n_bins_ = get32();
    std::vector<uint32_t> lens(K_);
    for (int l = 0; l < K_; ++l) lens[l] = get32();
    words_.resize(K_);
    decs_.resize(K_);
    for (int l = 0; l < K_; ++l) {
      words_[l].resize(lens[l]);
      for (uint32_t i = 0; i < lens[l]; ++i) {
        if (pos_ + 2 > size) throw std::runtime_error("rans chunk truncated");
        words_[l][i] = uint16_t(data[pos_] | (data[pos_ + 1] << 8));
        pos_ += 2;
      }
      decs_[l].init(words_[l].data(), words_[l].size());
    }
  }

  int decode(uint32_t p1) {
    int bit = decs_[idx_ % K_].decode(p1);
    ++idx_;
    return bit;
  }
  uint32_t n_bins() const { return n_bins_; }
  size_t consumed() const { return pos_; }
  size_t decoded() const { return idx_; }

 private:
  int K_;
  uint32_t n_bins_ = 0;
  size_t pos_ = 0;
  size_t idx_ = 0;
  std::vector<std::vector<uint16_t>> words_;
  std::vector<RansLaneDecoder> decs_;
};

}  // namespace artc
