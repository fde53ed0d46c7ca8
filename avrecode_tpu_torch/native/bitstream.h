// Bitstream utilities for the H.264 entropy layer: MSB-first bit reader/writer,
// Exp-Golomb codes (ITU-T H.264 clause 9.1), and NAL EBSP<->RBSP escaping
// (clause 7.3.1 / 7.4.1.1).
//
// Reference parity: the reference delegates all of this to libavformat/ffmpeg
// (reference recode.cpp:12-16, 92, 118); here it is first-class host code so the
// decompressor can regenerate byte streams without a surrogate-stream hack
// (reference recode.cpp:1526-1544).
#pragma once

#include <cassert>
#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace artc {

class BitstreamError : public std::runtime_error {
 public:
  explicit BitstreamError(const std::string& msg) : std::runtime_error(msg) {}
};

// MSB-first bit reader over a byte buffer (RBSP domain: escapes already removed).
class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  uint32_t read_bit() {
    if (pos_ >= size_ * 8) throw BitstreamError("BitReader: read past end");
    uint32_t bit = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return bit;
  }

  uint32_t read_bits(int n) {
    assert(n >= 0 && n <= 32);
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  // ue(v): unsigned Exp-Golomb.
  uint32_t read_ue() {
    int zeros = 0;
    while (read_bit() == 0) {
      if (++zeros > 31) throw BitstreamError("ue(v) too long");
    }
    if (zeros == 0) return 0;
    return (1u << zeros) - 1 + read_bits(zeros);
  }

  // se(v): signed Exp-Golomb (clause 9.1.1).
  int32_t read_se() {
    uint32_t k = read_ue();
    int32_t v = (k + 1) >> 1;
    return (k & 1) ? v : -v;
  }

  size_t bit_pos() const { return pos_; }
  void set_bit_pos(size_t p) { pos_ = p; }
  size_t size_bits() const { return size_ * 8; }
  size_t bits_left() const { return size_ * 8 - pos_; }
  bool byte_aligned() const { return (pos_ & 7) == 0; }

  // more_rbsp_data(): true if there is data beyond the rbsp_stop_one_bit.
  bool more_rbsp_data() const {
    if (pos_ >= size_ * 8) return false;
    // Find last set bit in the stream (the stop bit).
    size_t last = size_ * 8;
    while (last > 0) {
      --last;
      if ((data_[last >> 3] >> (7 - (last & 7))) & 1) break;
    }
    return pos_ < last;
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
};

// MSB-first bit writer producing RBSP bytes.
class BitWriter {
 public:
  void put_bit(uint32_t b) {
    if ((nbits_ & 7) == 0) buf_.push_back(0);
    if (b) buf_.back() |= uint8_t(1u << (7 - (nbits_ & 7)));
    ++nbits_;
  }

  void put_bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) put_bit((v >> i) & 1);
  }

  void put_ue(uint32_t v) {
    uint32_t vp1 = v + 1;
    int nbits = 0;
    for (uint32_t t = vp1; t > 1; t >>= 1) ++nbits;
    put_bits(0, nbits);
    put_bits(vp1, nbits + 1);
  }

  void put_se(int32_t v) {
    uint32_t k = (v <= 0) ? uint32_t(-2 * int64_t(v)) : uint32_t(2 * int64_t(v) - 1);
    put_ue(k);
  }

  size_t bit_pos() const { return nbits_; }
  bool byte_aligned() const { return (nbits_ & 7) == 0; }
  const std::vector<uint8_t>& bytes() const { return buf_; }
  std::vector<uint8_t>&& take() { return std::move(buf_); }

 private:
  std::vector<uint8_t> buf_;
  size_t nbits_ = 0;
};

// EBSP -> RBSP: remove emulation_prevention_three_byte. Returns the RBSP and
// (optionally) a map from rbsp byte index -> ebsp byte index for offset math.
inline std::vector<uint8_t> ebsp_to_rbsp(const uint8_t* data, size_t size,
                                         std::vector<uint32_t>* rbsp_to_ebsp = nullptr) {
  std::vector<uint8_t> out;
  out.reserve(size);
  if (rbsp_to_ebsp) rbsp_to_ebsp->reserve(size);
  int zeros = 0;
  for (size_t i = 0; i < size; ++i) {
    uint8_t b = data[i];
    if (zeros >= 2 && b == 0x03 && i + 1 < size && data[i + 1] <= 0x03) {
      zeros = 0;
      continue;  // drop the escape byte
    }
    // Note: a 0x03 at the very end after two zeros is also an escape
    // (cabac_zero_word handling); treat uniformly.
    if (zeros >= 2 && b == 0x03 && i + 1 == size) {
      zeros = 0;
      continue;
    }
    out.push_back(b);
    if (rbsp_to_ebsp) rbsp_to_ebsp->push_back(uint32_t(i));
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  return out;
}

// RBSP -> EBSP: insert emulation_prevention_three_byte after any 00 00 when the
// next byte is <= 0x03 (deterministic, matches all conformant encoders).
inline std::vector<uint8_t> rbsp_to_ebsp(const uint8_t* data, size_t size) {
  std::vector<uint8_t> out;
  out.reserve(size + size / 64);
  int zeros = 0;
  for (size_t i = 0; i < size; ++i) {
    uint8_t b = data[i];
    if (zeros >= 2 && b <= 0x03) {
      out.push_back(0x03);
      zeros = 0;
    }
    out.push_back(b);
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  return out;
}

}  // namespace artc
