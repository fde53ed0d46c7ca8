// K-lane interleaved binary rANS encode and the per-lane compaction of its
// output.
//
// Replaces avrecode_tpu/ops/lanes.py::_lane_scan_dev (the reverse scan over
// bins [0, n)), ::_lane_scan (the same scan over [T, K] planes with an
// explicit valid mask, which need not be a prefix) and ::_lane_compact (the
// emitted-word compaction); byte-identical to the host codec (native/rans.h
// RansInterleaved::encode). The masked scan also serves the mesh steps
// (parallel/pipeline.py): their vmap over a device's chunks is a chunk grid
// dimension, and a cell's lane slice [l*k, (l+1)*k) of the chunks' [T, K]
// planes is read in place through a row stride (K) and a chunk stride, from a
// pointer at the slice's first column.
//
// What bounds the scans: each lane is one serial chain of T steps (T =
// 65,536 at bench size, 131,072 on the mesh's lane slices), and K <= 128
// lanes are only a few warps, so the card is nearly idle and the time is T
// times the latency of the dependent instructions of one step. Everything
// else (loads, the step's parameters, the stores) can be taken off that
// chain.
//
// Design: one block per chunk and group of 32 lanes. Warp 0, the consumer,
// runs one thread per lane and walks t = T-1 ... 0; it does only the chain:
//   x1 = x > thr ? x >> 16 : x                (compare, select)
//   q  = hi32(x1 * m + a) >> s                (multiply-high, shift: x1 / f)
//   x  = q * g + (x1 + c)                     (multiply-add)
// with g = 32768 - f, which is (q << 15) + x1 % f + c, and thr = (f << 17) - 1
// (emit iff x >= f << 17). The magic (m, s, a = inc ? m : 0) is exact for
// every f in [1, 32767] and every x1 < f << 17 (ops/lanes.py _magic_table
// proves it; f = 1 takes m = 2^32 - 1 with the increment). A step's record
// is 8 bytes, m and w = g << 17 | one << 6 | inc << 5 | s, unpacked off the
// chain (thr = ~(g << 17)); an invalid step is the record 0 (thr = 2^32 - 1,
// never exceeded; m = a = s = g = c = 0), an exact identity, so the chain has
// no branch. The consumer reads a block of records ahead from shared memory
// and writes back each state's low 16 bits and whether it emitted; a tile
// with no valid step (the padding past n, a chunk's end on the mesh) skips
// the chain. Four helper warps feed it through a ring of kSlots tiles of
// kSteps steps: for a tile they cp.async the raw bits, probabilities and
// mask into shared memory, 16 bytes (4 lanes) a copy where the rows allow
// (reading the planes in place), pack the records (m and inc from the magic
// table, copied into shared memory when the block starts), and, once the
// consumer has passed the tile, write words and emits and count the
// emissions. mbarriers order the two sides: full[slot] (helper -> consumer)
// and done[slot] (consumer -> helper). Helper h owns slot h and the tiles h,
// h + 4, ...; as soon as it has packed a tile it starts the copies of the
// next one into the raw planes, so they have four of the consumer's tiles to
// land. The loops are kept short rather than unrolled whole: with hot code
// several times larger, blocks on the two SMs of one TPC ran markedly
// slower than a block alone (on an H100; most likely instruction fetch).
//
// The outputs have JAX's widths: words u16 (int16 bit patterns), emits bool
// (a byte), x_final u32 (int32 bit patterns), counts int32: 3 bytes a (step,
// lane) slot.
//
// The compaction only moves the [T, K] planes (25.2 MB at bench chunk 0: T
// = 65,536, K = 128), so it is bound by how much of that traffic is in
// flight at once. Two launches over tiles of whole rows (steps); the work
// unit of both is a warp over a row group of 32 rows and a column of lanes,
// thread r on row 32 g + r, one 16-byte load a row (16 one-byte emits, or 8
// two-byte words), so that a ballot per lane is that lane's mask of the
// group. The count pass reads the emit plane, keeps each lane's emissions of
// the tile as lane masks (bit r of mask (g, l) is lane l's emission at the
// tile's row 32 g + r; a 32nd of the plane's entries), written by the
// warp's ballots with no atomics, sums their popcounts a lane in shared
// memory, and zeroes a slice of the int16 output. At bench chunk 0 a tile
// is 256 rows x 128 lanes (32 KB of emits): 64 units, 8 per warp, which is
// each thread's eight 16-byte loads in flight, so the 256 tiles have the
// whole 8.4 MB emit plane in flight at once. The write pass sums, with all
// its threads, the counts of the tiles before its own (at most 256 tiles,
// so at most 128 KB of counts a block at K = 128), turns the masks into each
// (row group, lane)'s first position, then, a unit of 8 lanes at a time,
// loads a row's words only where one of the 8 masks has its bit, and stores
// each word at its position: the group's first plus the popcount of the
// lane's mask below its row. Positions >= maxW drop. Where K is not a
// multiple of 16 (or a plane is unaligned) both passes take an entry a
// thread instead, with the masks built by shared atomics.
#include <atomic>

#include "common.cuh"

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kSteps = 32;   // steps per ring tile
constexpr int kChainBlock = kSteps / 2;  // steps per straight-line block of the consumer
constexpr int kHelpers = 4;  // helper warps, one ring slot each
constexpr int kSlots = kHelpers;
// Warp w is scheduled by the SM's scheduler w % 4. The consumer is warp 0;
// warp 4 would share its scheduler, so it idles, and the helpers are warps
// 1-3 and 5.
constexpr int kIdleWarp = 4;
constexpr int kScanThreads = 32 * (2 + kHelpers);
// The magic table (ops/lanes.py _magic_words): m by f, then the inc bits.
constexpr int kMagicWords = artc::kProbScale + artc::kProbScale / 32;

// One ring tile: kSteps steps x 32 lanes (16-byte aligned: 16-byte copies
// land in bit and prob).
struct alignas(16) Slot {
  uint2 rec[kSteps][32];       // m, w = g << 17 | one << 6 | inc << 5 | s
  uint32_t bit[kSteps][32];    // raw planes, cp.async'd
  uint32_t prob[kSteps][32];
  uint32_t state[kSteps][32];  // low 16 bits of the state before each step | emitted << 16
  uint8_t valid[kSteps][32];   // the masked scan's raw mask
  uint32_t any;                // whether any step of the tile is valid
};
constexpr int kRingBytes = kMagicWords * 4 + kSlots * int(sizeof(Slot));

struct ScanArgs {
  const int* bits;
  const int* probs;
  const uint8_t* valid;  // the masked scan's mask (null for the dense scan)
  const uint4* magic;    // kMagicWords words
  int* x_final;     // u32 bit patterns
  int16_t* words;   // u16 bit patterns
  uint8_t* emits;   // bool
  int* counts;
  long long n, T, K, chunk_stride, row_stride;
  bool vec;  // 16-byte rows: aligned planes, K and the strides multiples of 4
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// One step (ops/lanes.py _chain_step mirrors it): the record's fields are
// unpacked off the chain; `word` gets the state's low 16 bits and the
// emission at bit 16.
__device__ __forceinline__ uint32_t chain_step(uint32_t x, uint2 r, uint32_t& word) {
  const uint32_t thr = ~(r.y & 0xfffe0000u);  // (f << 17) - 1; 2^32 - 1 if invalid
  const uint32_t g = r.y >> 17;
  const uint32_t a = (r.y & 32u) ? r.x : 0u;
  const uint32_t c = (r.y & 64u) ? g : 0u;
  const bool emit = x > thr;
  word = (x & 0xffffu) | (emit ? 0x10000u : 0u);
  const uint32_t x1 = emit ? x >> 16 : x;
  const uint32_t q = uint32_t((uint64_t(x1) * r.x + a) >> 32) >> (r.y & 31u);
  return q * g + (x1 + c);
}

// A helper's view of the planes: step j of tile i is t = T - 1 - i*kSteps - j.
template <bool kDense>
struct Ring {
  ScanArgs a;
  Slot* slots;
  const uint32_t* magic;  // the table, in shared memory
  long long g, l;         // chunk, lane
  bool live;              // l < K
  int rows;               // steps t < rows may be valid (dense: the bins below n)

  __device__ long long in_index(long long t) const {
    return kDense ? t * a.K + l : g * a.chunk_stride + t * a.row_stride + l;
  }

  // Starts tile i's copies into its slot. A whole tile of aligned rows is
  // copied 16 bytes (4 lanes) at a time, 8 row pieces a thread; the last
  // tile, the dense stream's end and unaligned planes go a lane at a time.
  __device__ void issue(long long i) const {
    Slot& sl = slots[i % kSlots];
    const int ln = threadIdx.x & 31;
    const long long t0 = a.T - 1 - i * kSteps, lane0 = l - ln;
    const long long top0 = in_index(t0) - ln;  // lane0's index in row t0
    const long long step = kDense ? a.K : a.row_stride;
    const int lanes = a.K - lane0 < 32 ? int(a.K - lane0) : 32;  // the group's live lanes
    if (a.vec && t0 >= kSteps - 1 && (!kDense || top0 + lanes - 1 < a.n)) {
#pragma unroll
      for (int k = 0; k < kSteps / 4; ++k) {
        const int j = (ln >> 3) + 4 * k, c = 4 * (ln & 7);
        if (c < lanes) {
          const long long idx = top0 - j * step + c;
          cp_async16(&sl.bit[j][c], a.bits + idx);
          cp_async16(&sl.prob[j][c], a.probs + idx);
          if (!kDense) cp_async4(&sl.valid[j][c], a.valid + idx);
        }
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kSteps; ++j) {
        const long long t = t0 - j, idx = top0 + ln - j * step;
        if (live && t >= 0 && (!kDense || idx < a.n)) {  // dense: bins past n are padding
          cp_async4(&sl.bit[j][ln], a.bits + idx);
          cp_async4(&sl.prob[j][ln], a.probs + idx);
          if (!kDense) sl.valid[j][ln] = __ldg(a.valid + idx);
        }
      }
    }
  }

  // Waits for tile i's copies (the warp's: a thread reads pieces other
  // threads copied) and packs its records (ops/lanes.py _pack_steps mirrors
  // it), and whether the tile has a valid step at all. Eight steps at a
  // time, their loads batched ahead of the arithmetic; no branch: an invalid
  // step (stale raw values) packs a record and stores 0, the identity.
  __device__ void convert(long long i) const {
    constexpr int kGroup = 8;
    Slot& sl = slots[i % kSlots];
    const int ln = threadIdx.x & 31;
    const uint32_t* inc_bits = magic + artc::kProbScale;
    const int t0 = int(a.T - 1 - i * kSteps);
    uint32_t any = 0;
    cp_async_wait_all();
    __syncwarp();
#pragma unroll 1
    for (int j0 = 0; j0 < kSteps; j0 += kGroup) {
      uint32_t one[kGroup], f[kGroup], keep[kGroup], m[kGroup], inc[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int j = j0 + k;
        const int pv = int(sl.prob[j][ln]);
        const uint32_t p = uint32_t(kDense && pv < 1 ? 1 : pv);  // JAX floors the dense p at 1
        one[k] = sl.bit[j][ln] == 1u;
        f[k] = (one[k] ? p : artc::kProbScale - p) & (artc::kProbScale - 1);
        const int t = t0 - j;
        keep[k] = 0u - (uint32_t(live) & uint32_t(t >= 0) & uint32_t(t < rows) &
                        uint32_t(kDense || sl.valid[j][ln] != 0));
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        m[k] = magic[f[k]];
        inc[k] = inc_bits[f[k] >> 5];
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const uint32_t w = (artc::kProbScale - f[k]) << 17 | one[k] << 6 |
                           (inc[k] >> (f[k] & 31u) & 1u) << 5 |
                           (31u - __clz(f[k] | 1u));  // s = floor(log2 f)
        any |= keep[k];
        sl.rec[j0 + k][ln] = make_uint2(m[k] & keep[k], w & keep[k]);
      }
    }
    any = __any_sync(0xffffffffu, any != 0);
    if (ln == 0) sl.any = any;
  }

  // Writes tile i's words and emits; returns its emissions.
  __device__ int flush(long long i) const {
    Slot& sl = slots[i % kSlots];
    const int ln = threadIdx.x & 31;
    const long long t0 = a.T - 1 - i * kSteps, top = (g * a.T + t0) * a.K + l;
    const int last = t0 < kSteps - 1 ? int(t0) : kSteps - 1;  // the last tile ends at t = 0
    int count = 0;
    if (live) {
#pragma unroll 4
      for (int j = 0; j <= last; ++j) {
        const uint32_t w = sl.state[j][ln];
        a.words[top - j * a.K] = int16_t(w & 0xffffu);
        a.emits[top - j * a.K] = uint8_t(w >> 16);
        count += int(w >> 16);
      }
    }
    return count;
  }
};

template <bool kDense>
__device__ __forceinline__ void lane_scan_body(const ScanArgs& a) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  __shared__ uint64_t full[kSlots], done[kSlots];
  __shared__ int part[kHelpers][32];
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const long long l = (long long)blockIdx.x * 32 + ln;
  uint32_t* magic = reinterpret_cast<uint32_t*>(ring_smem);
  const int rows = !kDense ? int(a.T) : a.n > l ? int((a.n - l + a.K - 1) / a.K) : 0;
  const Ring<kDense> ring{a,  reinterpret_cast<Slot*>(ring_smem + kMagicWords * 4),
                          magic, (long long)blockIdx.y, l, l < a.K, rows};
  const long long ntiles = (a.T + kSteps - 1) / kSteps;
  for (int k = threadIdx.x; k < kMagicWords / 4; k += blockDim.x)
    reinterpret_cast<uint4*>(magic)[k] = __ldg(a.magic + k);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&done[s], 32);
    }
  }
  __syncthreads();
  uint32_t x = kRansL;
  if (warp == 0) {  // the consumer: the chain and nothing else
    for (long long i = 0; i < ntiles; ++i) {
      const int s = int(i % kSlots);
      mbar_wait(&full[s], uint32_t(i / kSlots) & 1u);
      Slot& sl = ring.slots[s];
      if (!sl.any) {  // every step is the identity: the state stays, no emission
#pragma unroll 8
        for (int j = 0; j < kSteps; ++j) sl.state[j][ln] = x & 0xffffu;
      } else {
#pragma unroll 1
        for (int j0 = 0; j0 < kSteps; j0 += kChainBlock) {  // short code: see the note
          uint2 r[kChainBlock];  // the records, all loads issued before the chain
#pragma unroll
          for (int j = 0; j < kChainBlock; ++j) r[j] = sl.rec[j0 + j][ln];
#pragma unroll
          for (int j = 0; j < kChainBlock; ++j) {
            uint32_t word;
            x = chain_step(x, r[j], word);
            sl.state[j0 + j][ln] = word;
          }
        }
      }
      __syncwarp();
      mbar_arrive(&done[s]);
    }
  } else if (warp != kIdleWarp) {  // helper h: slot h, tiles h, h + kHelpers, ...
    const int h = warp < kIdleWarp ? warp - 1 : warp - 2;
    int count = 0;
    if (h < ntiles) ring.issue(h);
    for (long long i = h; i < ntiles; i += kHelpers) {
      // Tile i's copies have landed (they had the consumer's last kHelpers
      // tiles of time): pack it, and start the copies of this slot's next
      // tile at once, into the raw planes it no longer needs.
      ring.convert(i);
      __syncwarp();
      mbar_arrive(&full[h]);
      if (i + kHelpers < ntiles) ring.issue(i + kHelpers);
      mbar_wait(&done[h], uint32_t(i / kSlots) & 1u);
      count += ring.flush(i);
    }
    part[h][ln] = count;
  }
  __syncthreads();
  if (warp == 0 && ring.live) {
    int total = 0;
#pragma unroll
    for (int h = 0; h < kHelpers; ++h) total += part[h][ln];
    a.x_final[ring.g * a.K + l] = int(x);
    a.counts[ring.g * a.K + l] = total;
  }
}

// Bins [0, n) of dense streams (bin t*K + l is lane l's step t); bins past n
// are padding: no emission, no state change.
__global__ void __launch_bounds__(kScanThreads, 1) lane_scan_dev_kernel(const ScanArgs a) {
  lane_scan_body<true>(a);
}

// The [T, K] planes of chunk blockIdx.y at g * chunk_stride + t * row_stride
// + l (a lane slice of wider planes, read in place); step [t, l] runs where
// valid is nonzero. Outputs are dense [G][T][K] and [G][K]. As in JAX's
// _lane_scan, p is taken as it is (valid probabilities are in [1, 32767]).
__global__ void __launch_bounds__(kScanThreads, 1) lane_scan_kernel(const ScanArgs a) {
  lane_scan_body<false>(a);
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// Per scan kernel, the devices (bit d: device d < 64) on which its shared
// memory limit is already raised to kRingBytes.
std::atomic<uint64_t> ring_ready[2];

template <typename Kernel>
int launch_scan(Kernel kernel, std::atomic<uint64_t>& ready, ScanArgs a, long long G,
                cudaStream_t st) {
  a.vec = aligned(a.bits, 16) && aligned(a.probs, 16) && a.K % 4 == 0 &&
          a.row_stride % 4 == 0 && a.chunk_stride % 4 == 0 &&
          (a.valid == nullptr || aligned(a.valid, 4));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (err == cudaSuccess && !(ready.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
    if (err == cudaSuccess) ready.fetch_or(bit);
  }
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(artc::grid_for(a.K, 32), unsigned(G)), kScanThreads, kRingBytes, st>>>(a);
  return int(cudaGetLastError());
}

// The compaction's tiles (ops/lanes.py _compact_rows mirrors this): at
// most kCompactTiles tiles and kCompactCounts counts (tiles x K), of whole
// rows, a multiple of 32 rows each and at most kMaskWords lane masks.
constexpr long long kCompactTiles = 256;
constexpr long long kCompactCounts = 32768;
constexpr long long kMaskWords = 8192;
constexpr int kCountThreads = 256;
constexpr int kWriteThreads = 512;
constexpr int kInFlight = 8;  // 16-byte loads a thread of the count pass keeps in flight
constexpr int kWriteInFlight = 4;  // and of the write pass

__host__ __device__ inline long long compact_rows(long long T, long long K) {
  if (K < 1) K = 1;
  long long tiles = kCompactCounts / K;
  if (tiles > kCompactTiles) tiles = kCompactTiles;
  if (tiles < 1) tiles = 1;
  long long rows = (T + tiles - 1) / tiles;
  rows = rows < 32 ? 32 : (rows + 31) / 32 * 32;
  long long cap = kMaskWords * 32 / K / 32 * 32;
  if (cap < 32) cap = 32;
  return rows < cap ? rows : cap;
}

struct Compact {
  const int16_t* words;  // [T, K] u16 bit patterns
  const uint8_t* emits;  // [T, K] bool
  int16_t* out;          // [maxW, K] u16 bit patterns
  int* tile_cnt;         // [ntile, K]
  uint32_t* masks;       // [ntile, rows / 32, K]
  long long T, K, maxW, rows, ntile;
  int vec;  // K % 16 == 0 and 16-byte aligned planes and out: the warp-unit paths
};

// The output's zeros: an equal share of its 16-byte units a tile.
__device__ void compact_zero(const Compact& C, long long tile) {
  const long long total = C.maxW * C.K;
  if (C.vec) {
    const long long units = total / 8, per = (units + C.ntile - 1) / C.ntile;
    const long long u1 = (tile + 1) * per < units ? (tile + 1) * per : units;
    for (long long u = tile * per + threadIdx.x; u < u1; u += blockDim.x)
      reinterpret_cast<int4*>(C.out)[u] = make_int4(0, 0, 0, 0);
    if (tile == C.ntile - 1)
      for (long long i = units * 8 + threadIdx.x; i < total; i += blockDim.x) C.out[i] = 0;
  } else {
    const long long per = (total + C.ntile - 1) / C.ntile;
    const long long i1 = (tile + 1) * per < total ? (tile + 1) * per : total;
    for (long long i = tile * per + threadIdx.x; i < i1; i += blockDim.x) C.out[i] = 0;
  }
}

// Launch 1: tile blockIdx.x's per-lane counts and lane masks, and its share
// of the output's zeros. Dynamic shared memory: K + rows / 32 * K ints (the
// lane masks live there only on the scalar path).
__global__ void __launch_bounds__(kCountThreads) compact_count_kernel(const Compact C) {
  extern __shared__ int cnt[];
  uint32_t* mask = reinterpret_cast<uint32_t*>(cnt + C.K);
  const long long tile = blockIdx.x;
  const long long groups = C.rows / 32, nmask = groups * C.K;
  const long long r0 = tile * C.rows;  // the tile's first row
  const long long r1 = r0 + C.rows < C.T ? r0 + C.rows : C.T;
  for (long long i = threadIdx.x; i < (C.vec ? C.K : C.K + nmask); i += blockDim.x) cnt[i] = 0;
  compact_zero(C, tile);
  __syncthreads();
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  if (C.vec) {
    // A warp unit: 32 rows (a row group g) x 16 lanes (column c), thread r
    // reading row 32 g + r's 16 emits in one load; 16 ballots are then the
    // 16 lanes' masks of the group, stored by lanes 0-15, no atomics.
    const long long cols = C.K / 16, units = groups * cols;
    uint32_t* tile_masks = C.masks + tile * nmask;
    for (long long u0 = warp; u0 < units; u0 += kInFlight * nwarp) {
      uint4 e[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long u = u0 + k * nwarp, g = u / cols, c = u - g * cols;
        const long long t = r0 + 32 * g + ln;
        e[k] = u < units && t < r1
                   ? __ldcs(reinterpret_cast<const uint4*>(C.emits + t * C.K + 16 * c))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        const long long u = u0 + k * nwarp, g = u / cols, c = u - g * cols;
        if (u >= units) break;  // warp-uniform
        const uint32_t q[4] = {e[k].x, e[k].y, e[k].z, e[k].w};
        uint32_t mine = 0;
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const uint32_t m = __ballot_sync(0xffffffffu, (q[b >> 2] >> (8 * (b & 3))) & 0xffu);
          if (ln == b) mine = m;
        }
        if (ln < 16) {
          tile_masks[g * C.K + 16 * c + ln] = mine;
          if (mine) atomicAdd(&cnt[16 * c + ln], __popc(mine));
        }
      }
    }
  } else {
    // Any K: an entry a thread, a shared atomic per emission.
    const uint32_t K = uint32_t(C.K);
    for (long long f = r0 * C.K + threadIdx.x; f < r1 * C.K; f += blockDim.x) {
      if (C.emits[f]) {
        const uint32_t rel = uint32_t(f - r0 * C.K), t = rel / K, l = rel - t * K;
        atomicAdd(&cnt[l], 1);
        atomicOr(&mask[(t >> 5) * K + l], 1u << (t & 31));
      }
    }
    __syncthreads();
    for (long long i = threadIdx.x; i < nmask; i += blockDim.x)
      C.masks[tile * nmask + i] = mask[i];
  }
  __syncthreads();
  for (long long l = threadIdx.x; l < C.K; l += blockDim.x) C.tile_cnt[tile * C.K + l] = cnt[l];
}

// Launch 2: tile blockIdx.x's emitted words at their positions. Dynamic
// shared memory: K + rows / 32 * K ints (the lanes' offsets, each (row
// group, lane)'s first position).
__global__ void __launch_bounds__(kWriteThreads, 2) compact_write_kernel(const Compact C) {
  extern __shared__ int pre[];
  int* first = pre + C.K;
  const long long tile = blockIdx.x;
  const long long K = C.K;
  const long long groups = C.rows / 32;
  const long long r0 = tile * C.rows;
  const long long r1 = r0 + C.rows < C.T ? r0 + C.rows : C.T;
  const uint32_t* mask = C.masks + tile * groups * K;
  for (long long l = threadIdx.x; l < K; l += blockDim.x) pre[l] = 0;
  __syncthreads();
  // The lanes' offsets: the counts of tiles [0, tile), summed by columns of
  // four lanes (one lane where K is not a multiple of 4), the tiles split
  // between the threads of a column.
  const bool v4 = K % 4 == 0;
  const long long cols4 = v4 ? K / 4 : K;
  const long long parts = cols4 < blockDim.x ? blockDim.x / cols4 : 1;
  for (long long idx = threadIdx.x; idx < cols4 * parts; idx += blockDim.x) {
    const long long c = idx % cols4, p = idx / cols4;
    if (v4) {
      int4 s = make_int4(0, 0, 0, 0);
#pragma unroll 8
      for (long long t = p; t < tile; t += parts) {
        const int4 v = *reinterpret_cast<const int4*>(C.tile_cnt + t * K + 4 * c);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      atomicAdd(&pre[4 * c], s.x);
      atomicAdd(&pre[4 * c + 1], s.y);
      atomicAdd(&pre[4 * c + 2], s.z);
      atomicAdd(&pre[4 * c + 3], s.w);
    } else {
      int s = 0;
#pragma unroll 8
      for (long long t = p; t < tile; t += parts) s += C.tile_cnt[t * K + c];
      atomicAdd(&pre[c], s);
    }
  }
  __syncthreads();
  for (long long l = threadIdx.x; l < K; l += blockDim.x) {
    int run = pre[l];
    for (long long g = 0; g < groups; ++g) {
      first[g * K + l] = run;
      run += __popc(mask[g * K + l]);
    }
  }
  __syncthreads();
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const uint32_t below = (1u << ln) - 1u;
  if (C.vec) {
    // A warp unit: 32 rows (row group g) x 8 lanes (column c), thread r
    // holding row 32 g + r's 8 words (one 16-byte load, taken only where
    // one of the 8 lanes' masks has the row's bit).
    const long long cols = K / 8, units = groups * cols;
    for (long long u0 = warp; u0 < units; u0 += kWriteInFlight * nwarp) {
      uint32_t m[kWriteInFlight][8];
      uint4 w[kWriteInFlight];
#pragma unroll
      for (int k = 0; k < kWriteInFlight; ++k) {
        const long long u = u0 + k * nwarp, g = u / cols, c = u - g * cols;
        const long long t = r0 + 32 * g + ln;
        bool any = false;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          m[k][b] = u < units ? __ldg(mask + g * K + 8 * c + b) : 0u;
          any |= (m[k][b] >> ln) & 1u;
        }
        w[k] = any && t < r1
                   ? __ldcs(reinterpret_cast<const uint4*>(C.words + t * K + 8 * c))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kWriteInFlight; ++k) {
        const long long u = u0 + k * nwarp, g = u / cols, c = u - g * cols;
        const uint32_t q[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if ((m[k][b] >> ln) & 1u) {
            const long long l = 8 * c + b;
            const long long pos = first[g * K + l] + __popc(m[k][b] & below);
            if (pos < C.maxW) C.out[pos * K + l] = int16_t(q[b >> 1] >> (16 * (b & 1)));
          }
        }
      }
    }
  } else {
    const uint32_t Ku = uint32_t(K);
    for (long long f = r0 * K + threadIdx.x; f < r1 * K; f += blockDim.x) {
      const uint32_t rel = uint32_t(f - r0 * K), t = rel / Ku, l = rel - t * Ku;
      const uint32_t mk = mask[(t >> 5) * Ku + l];
      if ((mk >> (t & 31)) & 1u) {
        const long long pos = first[(t >> 5) * Ku + l] + __popc(mk & ((1u << (t & 31)) - 1u));
        if (pos < C.maxW) C.out[pos * K + l] = C.words[f];
      }
    }
  }
}

// Launches of the last compaction call of this thread.
thread_local int g_compact_launches = 0;

}  // namespace

ARTC_API const char* artc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

ARTC_API int artc_lane_scan_dev(const int* bits, const int* probs, const void* magic,
                                int* x_final, int16_t* words, uint8_t* emits, int* counts,
                                long long n, long long T, long long K, void* stream) {
  const ScanArgs a{bits, probs, nullptr, static_cast<const uint4*>(magic),
                   x_final, words, emits, counts, n, T, K, /*chunk_stride=*/0, /*row_stride=*/K,
                   /*vec=*/false};
  return launch_scan(lane_scan_dev_kernel, ring_ready[0], a, 1,
                     static_cast<cudaStream_t>(stream));
}

ARTC_API int artc_lane_scan(const int* bits, const int* probs, const uint8_t* valid,
                            const void* magic, int* x_final, int16_t* words,
                            uint8_t* emits, int* counts, long long G, long long T, long long K,
                            long long chunk_stride, long long row_stride, void* stream) {
  if (G <= 0) return int(cudaGetLastError());
  const ScanArgs a{bits, probs, valid, static_cast<const uint4*>(magic),
                   x_final, words, emits, counts, /*n=*/0, T, K, chunk_stride, row_stride,
                   /*vec=*/false};
  return launch_scan(lane_scan_kernel, ring_ready[1], a, G, static_cast<cudaStream_t>(stream));
}

ARTC_API int artc_compact_launches(void) { return g_compact_launches; }

// words [T, K] int16 (u16 bit patterns), emits [T, K] bool; out [maxW, K]
// int16; scratch: the tile counts (ntile * K ints) then the lane masks
// (ntile * rows / 32 * K words), with rows = compact_rows(T, K) and ntile =
// ceil(T / rows).
ARTC_API int artc_lane_compact(const int16_t* words, const uint8_t* emits, void* out,
                               int* scratch, long long T, long long K, long long maxW,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  g_compact_launches = 0;
  if (T <= 0 || K <= 0 || maxW <= 0) return 0;
  if (T * K >= (1ll << 31) || K > 4096) return int(cudaErrorInvalidValue);
  Compact C;
  C.words = words;
  C.emits = emits;
  C.out = static_cast<int16_t*>(out);
  C.T = T;
  C.K = K;
  C.maxW = maxW;
  C.rows = compact_rows(T, K);
  C.ntile = (T + C.rows - 1) / C.rows;
  C.tile_cnt = scratch;
  C.masks = reinterpret_cast<uint32_t*>(scratch + C.ntile * K);
  C.vec = K % 16 == 0 && aligned(words, 16) && aligned(emits, 16) && aligned(out, 16);
  // K + at most kMaskWords ints: within the 48 KB a block has without opt-in.
  const size_t smem = size_t(K + C.rows / 32 * K) * sizeof(int);
  compact_count_kernel<<<unsigned(C.ntile), kCountThreads, smem, st>>>(C);
  ++g_compact_launches;
  int rc = int(cudaGetLastError());
  if (rc) return rc;
  compact_write_kernel<<<unsigned(C.ntile), kWriteThreads, smem, st>>>(C);
  ++g_compact_launches;
  return int(cudaGetLastError());
}
