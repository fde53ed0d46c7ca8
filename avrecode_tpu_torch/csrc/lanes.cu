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
// What bounds it: the scan is a serial recurrence of T steps per lane (T =
// 65,536 at bench size) with one integer division per step; its K lanes are
// only K threads (K <= 128), so the card is nearly idle and the time is T
// times the latency of one step. The compaction only moves the [T, K]
// planes (about 64 MB at bench size), so it is bound by how much of that
// traffic is in flight at once.
//
// Design: one thread per lane walks t = T-1 ... 0. Lane l reads bin t*K + l,
// so the K threads of a step read neighbouring words. The state is u32:
// f << 17 and (x / f) << 15 stay below 2^32. Each step records the low 16
// bits of the state and whether it emitted, at [t, l] as the JAX scan does.
// The compaction splits T into tiles of kTile steps: one thread per (tile,
// lane) counts the tile's emissions, one thread per lane scans its tile
// counts, and one thread per (tile, lane) writes its emitted words in
// ascending-t order into [maxW, K] from its tile's offset; a serial walk
// per lane would leave the card as idle as the scan. Spreading the scan's
// own recurrence is later work.
#include "common.cuh"

namespace {

constexpr uint32_t kRansL = 1u << 16;

// One encode step of state x for a bin of probability p (of a one) and value
// bit; returns 1 if the low 16 bits of x were emitted first.
__device__ inline int rans_step(uint32_t& x, uint32_t p, bool one) {
  const uint32_t f = one ? p : artc::kProbScale - p;
  const uint32_t c = one ? artc::kProbScale - p : 0u;
  int e = 0;
  if (x >= (f << 17)) {
    e = 1;
    x >>= 16;
  }
  x = ((x / f) << artc::kProbBits) + x % f + c;
  return e;
}

__global__ void lane_scan_dev_kernel(const int* __restrict__ bits,
                                     const int* __restrict__ probs, int* __restrict__ x_final,
                                     int* __restrict__ words, int* __restrict__ emits,
                                     int* __restrict__ counts, long long n, long long T,
                                     long long K) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= K) return;
  uint32_t x = kRansL;
  int count = 0;
  for (long long t = T - 1; t >= 0; --t) {
    const long long idx = t * K + l;
    const uint32_t word = x & 0xffffu;
    int e = 0;
    if (idx < n) {  // bins past n are padding: no emission, no state change
      const int pv = probs[idx];
      e = rans_step(x, uint32_t(pv > 1 ? pv : 1), bits[idx] == 1);
    }
    words[idx] = int(word);
    emits[idx] = e;
    count += e;
  }
  x_final[l] = int(x);
  counts[l] = count;
}

// The same walk over the [T, K] planes of chunk blockIdx.y; step [t, l] runs
// where valid[t, l] is nonzero, and an invalid step neither emits nor
// changes the state. The inputs sit at g * chunk_stride + t * row_stride + l
// (a lane slice of wider planes, read in place); the outputs are dense
// [G][T][K] and [G][K]. As in JAX's _lane_scan, p is taken as it is (valid
// probabilities are in [1, 32767]).
__global__ void lane_scan_kernel(const int* __restrict__ bits, const int* __restrict__ probs,
                                 const uint8_t* __restrict__ valid, int* __restrict__ x_final,
                                 int* __restrict__ words, int* __restrict__ emits,
                                 int* __restrict__ counts, long long T, long long K,
                                 long long chunk_stride, long long row_stride) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= K) return;
  const long long g = blockIdx.y;
  const long long in0 = g * chunk_stride + l, out0 = g * T * K + l;
  uint32_t x = kRansL;
  int count = 0;
  for (long long t = T - 1; t >= 0; --t) {
    const long long in = in0 + t * row_stride, out = out0 + t * K;
    const uint32_t word = x & 0xffffu;
    int e = 0;
    if (valid[in]) e = rans_step(x, uint32_t(probs[in]), bits[in] == 1);
    words[out] = int(word);
    emits[out] = e;
    count += e;
  }
  x_final[g * K + l] = int(x);
  counts[g * K + l] = count;
}

// ops/lanes.py _COMPACT_TILE sizes the per-tile scratch from this.
constexpr int kTile = 256;

// Thread (tile, lane): emissions of lane l in steps [tile*kTile, +kTile).
__global__ void compact_count_kernel(const int* __restrict__ emits,
                                     int* __restrict__ tile_cnt, long long T, long long K) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= K) return;
  const long long t0 = (long long)blockIdx.y * kTile;
  const long long t1 = t0 + kTile < T ? t0 + kTile : T;
  int c = 0;
  for (long long t = t0; t < t1; ++t) c += emits[t * K + l] != 0;
  tile_cnt[blockIdx.y * K + l] = c;
}

// Thread per lane: exclusive scan of its tile counts, in place.
__global__ void compact_scan_kernel(int* __restrict__ tile_cnt, long long ntile,
                                    long long K) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= K) return;
  int run = 0;
  for (long long i = 0; i < ntile; ++i) {
    const int c = tile_cnt[i * K + l];
    tile_cnt[i * K + l] = run;
    run += c;
  }
}

// Thread (tile, lane): the tile's emitted words, in ascending t, from the
// tile's offset in lane l's stream.
__global__ void compact_write_kernel(const int* __restrict__ words,
                                     const int* __restrict__ emits,
                                     const int* __restrict__ tile_off, int* __restrict__ out,
                                     long long T, long long K, long long maxW) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= K) return;
  const long long t0 = (long long)blockIdx.y * kTile;
  const long long t1 = t0 + kTile < T ? t0 + kTile : T;
  long long pos = tile_off[blockIdx.y * K + l];
  for (long long t = t0; t < t1; ++t) {
    const long long idx = t * K + l;
    if (emits[idx]) {
      if (pos < maxW) out[pos * K + l] = words[idx];
      ++pos;
    }
  }
}

}  // namespace

ARTC_API const char* artc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

ARTC_API int artc_lane_scan_dev(const int* bits, const int* probs, int* x_final, int* words,
                                int* emits, int* counts, long long n, long long T, long long K,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lane_scan_dev_kernel<<<artc::grid_for(K, 128), 128, 0, st>>>(bits, probs, x_final, words,
                                                              emits, counts, n, T, K);
  return int(cudaGetLastError());
}

ARTC_API int artc_lane_scan(const int* bits, const int* probs, const uint8_t* valid,
                            int* x_final, int* words, int* emits, int* counts, long long G,
                            long long T, long long K, long long chunk_stride,
                            long long row_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G <= 0) return int(cudaGetLastError());
  lane_scan_kernel<<<dim3(artc::grid_for(K, 128), unsigned(G)), 128, 0, st>>>(
      bits, probs, valid, x_final, words, emits, counts, T, K, chunk_stride, row_stride);
  return int(cudaGetLastError());
}

ARTC_API int artc_lane_compact(const int* words, const int* emits, int* out, int* tile_cnt,
                               long long T, long long K, long long maxW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntile = (T + kTile - 1) / kTile;
  if (ntile == 0) return int(cudaGetLastError());
  const dim3 grid(artc::grid_for(K, 128), unsigned(ntile));
  compact_count_kernel<<<grid, 128, 0, st>>>(emits, tile_cnt, T, K);
  compact_scan_kernel<<<artc::grid_for(K, 128), 128, 0, st>>>(tile_cnt, ntile, K);
  compact_write_kernel<<<grid, 128, 0, st>>>(words, emits, tile_cnt, out, T, K, maxW);
  return int(cudaGetLastError());
}
