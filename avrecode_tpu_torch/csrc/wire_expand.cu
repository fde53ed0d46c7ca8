// ANL5 slim-wire expand on the card.
//
// Replaces avrecode_tpu/ops/model_pass.py::wire_expand4_blob (with
// _unpack_dev and _div_floor2), in both forms: one fused u32 blob -> per-bin
// bit/kind/slot/prior planes + the per-sub-batch (ones, tot) update-delta
// table (recode.cc write_slim_chunk is the writer). In mesh mode the shapes
// are mesh-uniform (ud is the mesh-wide dual width) and sc[5] carries the
// chunk's real dual width ud_real: every COO slot cs >= ud_real moves up by
// ud - ud_real, so the chunk's sig slots land at [ud, ud + us) (JAX :350-355).
// The shift applies wherever a slot is unpacked: the per-bin slot lookup and
// the delta table's column.
//
// What bounds it: memory traffic. Per bin it reads half a byte of header
// nibble, about a byte of packed rank, a prior index and a COO-slot word of
// its sub-batch's run, and writes 16 bytes of planes; the delta table
// (nsub * U words, 42 MB at bench chunk 0) is written once. Only the rank
// positions need a scan over all bins.
//
// Design: every chunk of a call (the mesh's chunk axis) in one sequence of
// three launches, the chunk on the grid's y dimension:
//   1. per 2,048-bin block the packed (hot, cold) rank count and the prior
//      plane; per (chunk, sub-batch) one block that builds the sub-batch's
//      delta row in shared memory (zeroed, its COO run placed at its
//      slots) and writes it whole, with full sectors, and records the run's
//      start and its entries whose slot lies past the row;
//   2. per chunk one block scans the block counts (each thread sums a run
//      of them, then one block scan); beside it the prior escapes and the
//      rare entries whose flat index lies in a later row (stream order puts
//      them over the rows);
//   3. the bins: the header again, the in-block scan from the block's
//      offset, the rank unpack, the slot from the run and the three
//      remaining planes as 16-byte stores; beside it the count escapes at
//      their entries' (sub-batch, slot) found by a binary search of the run
//      starts (stream order puts them over the rows' nibble values).
// An entry's sub-batch is JAX's mark/cumsum: the last s with starts[s] <= j,
// so live entries past the sum of the runs belong to the last sub-batch.
// Divisions are 32-bit integer divisions (positions stay below 2^31); the
// TPU's float-reciprocal form existed only for its vector unit. Gathers JAX
// clamps (the COO slot words) clamp the same way, and the gathers JAX
// promises in bounds clamp too, which changes nothing for valid input but
// keeps every read inside the blob.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBinsPerBlock = kThreads * 8;  // two quads of bins a thread
constexpr int kScanThreads = 1024;

struct Wire {
  const uint32_t* w;   // chunk g's blob at w + g * wstride
  const int* sc;       // chunk g's [wa, wb, wcs, n, n_coo (, ud_real)] at sc + g * nsc
  int* bit;            // planes [G, m]
  int* kind;
  int* slot;
  int* prior;
  int* deltas;         // [G, nsub * U]
  unsigned long long* block_ab;  // [G, nblk] packed (hot, cold) counts, then their offsets
  int* starts;         // [G, nsub] COO run starts
  int* ovf;            // [G, nsub] entries of the run whose flat index is in a later row
  long long wstride, nw, m, nsub, U, ud, batch, Lh, Lc, npi, ne, nc, ncc, nblk;
  int nsc, mesh;
  int vec, rvec;       // the planes / the delta rows take 16-byte stores
  long long off[15];   // segment offsets (ops/model_pass._blob_layout_words)
};

__device__ inline const uint32_t* blob_of(const Wire& P, long long g) {
  return P.w + g * P.wstride;
}

__device__ inline const int* sc_of(const Wire& P, long long g) { return P.sc + g * P.nsc; }

__device__ inline const uint8_t* u8_at(const Wire& P, const uint32_t* w, int k) {
  return reinterpret_cast<const uint8_t*>(w + P.off[k]);
}

__device__ inline const uint16_t* u16_at(const Wire& P, const uint32_t* w, int k) {
  return reinterpret_cast<const uint16_t*>(w + P.off[k]);
}

// No-straddle w-bit entry `pos` of the stream at word `base` (BitPacker::
// put_ns: entry j lives wholly inside word j / (32/w)); the word index
// clamps at `last`. A 0-bit entry (the zero widths of the mesh's pad chunks)
// is 0.
__device__ inline uint32_t unpack_ns(const uint32_t* w, long long base, long long last,
                                     uint32_t pos, int width) {
  if (width <= 0) return 0u;
  const uint32_t epw = 32u / unsigned(width);
  const uint32_t q = pos / epw;
  const int shift = int(pos - q * epw) * width;
  long long wi = base + q;
  if (wi > last) wi = last;
  const uint32_t mask = width >= 32 ? 0xffffffffu : ((1u << width) - 1u);
  return (w[wi] >> shift) & mask;
}

// Consecutive entries of one w-bit stream from entry pos: the word and the
// entry within it, advanced without a division.
struct Cursor {
  uint32_t q = 0, r = 0, epw = 1;
  int width;
  __device__ Cursor(uint32_t pos, int w) : width(w) {
    if (w > 0) {
      epw = 32u / unsigned(w);
      q = pos / epw;
      r = pos - q * epw;
    }
  }
  __device__ uint32_t entry(const uint32_t* words, long long base, long long last) const {
    if (width <= 0) return 0u;
    long long wi = base + q;
    if (wi > last) wi = last;
    const uint32_t mask = width >= 32 ? 0xffffffffu : ((1u << width) - 1u);
    return (words[wi] >> (int(r) * width)) & mask;
  }
  __device__ void next() {
    if (++r == epw) {
      r = 0;
      ++q;
    }
  }
};

// COO slot entry j (the wcs-bit stream, word index clamped to its segment;
// an empty stream reads 0), shifted into the mesh-uniform dictionary space
// in mesh mode.
__device__ inline long long coo_slot(const Wire& P, const uint32_t* w, const int* sc,
                                     long long j) {
  long long c = P.nc > 0 ? unpack_ns(w, P.off[3], P.off[3] + P.Lc - 1, uint32_t(j), sc[2]) : 0;
  if (P.mesh) {
    const long long ud_real = sc[5];
    if (c >= ud_real) c += P.ud - ud_real;
  }
  return c;
}

// (ones, tot) of COO entry j widened from its nibble: ones low, tot high.
__device__ inline int nib_value(const Wire& P, const uint32_t* w, long long j) {
  const uint32_t b = u8_at(P, w, 9)[j];
  return int((b & 15u) | ((b >> 4) << 16));
}

// Entries [lo, hi) of sub-batch s: its run [starts[s], starts[s] + cnt[s]),
// the last sub-batch's run reaching to the live end, cut to the live
// entries [0, min(nc, n_coo)).
__device__ inline void run_of(const Wire& P, const uint32_t* w, const int* sc, long long s,
                              int start, long long& lo, long long& hi) {
  const long long live = P.nc < sc[4] ? P.nc : sc[4];
  lo = start;
  hi = s + 1 < P.nsub ? (long long)start + u16_at(P, w, 8)[s] : live;
  if (hi > live) hi = live;
}

// A thread's bins: quad h (0, 1) is bins [base(h), base(h) + 4), base(h) =
// block * kBinsPerBlock + h * kBinsPerBlock / 2 + 4 * thread, so each 16-byte
// store of a warp covers 512 contiguous bytes of a plane.
__device__ inline long long quad_base(long long b, int h) {
  return b * kBinsPerBlock + h * (kBinsPerBlock / 2) + 4ll * threadIdx.x;
}

// Header nibbles of the four bins at i0 (a multiple of 4; bins >= Lh * 8
// read 0); bins >= n are padding (kind 3, bit 0). Fills the per-bin fields
// and returns the quad's (hot, cold) rank counts as hot | cold << 16.
__device__ inline uint32_t decode4(const Wire& P, const uint32_t* w, long long i0, long long n,
                                   int* bit, int* kind, int* cls) {
  const uint32_t hdr = i0 < P.m && (i0 >> 3) < P.Lh
                           ? w[P.off[0] + (i0 >> 3)] >> (16 * ((i0 >> 2) & 1)) : 0u;
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t h = (hdr >> (4 * k)) & 15u;
    const bool live_n = i0 + k < n && i0 + k < P.m;
    bit[k] = live_n ? int(h >> 3) : 0;
    kind[k] = live_n ? int((h >> 1) & 3u) : 3;
    cls[k] = int(h & 1u);
    if (kind[k] != 3) s += cls[k] ? (1u << 16) : 1u;
  }
  return s;
}

// Four consecutive ints of a plane row at i (one 16-byte store where the
// planes allow it, else one int at a time up to m).
__device__ inline void store4(const Wire& P, int* row, long long i, const int* v) {
  if (i >= P.m) return;
  if (P.vec && i + 4 <= P.m) {
    *reinterpret_cast<int4*>(row + i) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < P.m) row[i + k] = v[k];
}

// The block's two quads' packed (hot, cold) counts -> the u64 (hot, cold)
// total of a thread's bins.
__device__ inline unsigned long long widen(uint32_t q) {
  return (unsigned long long)(q & 0xffffu) | ((unsigned long long)(q >> 16) << 32);
}

// Launch 1, a count block: the block's packed rank count and its prior
// plane (the u8 -> u16 dictionary; 0 on [npi, n), the neutral 1 from n).
__device__ void count_block(const Wire& P, long long g, long long b) {
  const uint32_t* w = blob_of(P, g);
  const int* sc = sc_of(P, g);
  const long long n = sc[3];
  const uint16_t* pdict = u16_at(P, w, 5);
  const uint32_t* pidx = w + P.off[4];
  unsigned long long s = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = quad_base(b, h);
    int bit[4], kind[4], cls[4], pr[4];
    s += widen(decode4(P, w, i0, n, bit, kind, cls));
    const uint32_t word = i0 < P.npi && i0 < n ? pidx[i0 >> 2] : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = i0 + k;
      pr[k] = i >= n ? 1 : (i < P.npi ? int(pdict[(word >> (8 * k)) & 255u]) : 0);
    }
    store4(P, P.prior + g * P.m, i0, pr);
  }
  unsigned long long total;
  artc::block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) P.block_ab[g * P.nblk + b] = total;
}

// Launch 1, a row block: sub-batch s's delta row built in shared memory
// and written whole; its run start and its count of entries whose flat
// index lies in a later row go to starts / ovf.
__device__ void row_block(const Wire& P, long long g, long long s, int* row) {
  const uint32_t* w = blob_of(P, g);
  const int* sc = sc_of(P, g);
  const uint16_t* cnt = u16_at(P, w, 8);
  for (long long c = threadIdx.x; c < P.U; c += blockDim.x) row[c] = 0;
  unsigned part = 0;  // the run start: the counts before s (int32 as JAX's cumsum)
  for (long long i = threadIdx.x; i < s; i += blockDim.x) part += cnt[i];
  unsigned start;
  artc::block_exclusive_scan(part, &start);  // synchronises: the zeroed row is in place
  long long lo, hi;
  run_of(P, w, sc, s, int(start), lo, hi);
  int later = 0;
  for (long long j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const long long c = coo_slot(P, w, sc, j);
    if (c < P.U) row[c] = nib_value(P, w, j);
    else if (c < (P.nsub - s) * P.U) ++later;
  }
  int n_later;
  artc::block_exclusive_scan(later, &n_later);
  int* dst = P.deltas + (g * P.nsub + s) * P.U;
  if (P.rvec) {
    const int4* src = reinterpret_cast<const int4*>(row);
    for (long long q = threadIdx.x; q < P.U / 4; q += blockDim.x)
      reinterpret_cast<int4*>(dst)[q] = src[q];
  } else {
    for (long long c = threadIdx.x; c < P.U; c += blockDim.x) dst[c] = row[c];
  }
  if (threadIdx.x == 0) {
    P.starts[g * P.nsub + s] = int(start);
    P.ovf[g * P.nsub + s] = n_later;
  }
}

// Grid (nsub row blocks + nblk count blocks, G); dynamic shared memory: U ints.
__global__ void __launch_bounds__(kThreads) rows_count_kernel(Wire P) {
  extern __shared__ int4 smem[];
  const long long g = blockIdx.y;
  if (blockIdx.x < P.nsub) row_block(P, g, blockIdx.x, reinterpret_cast<int*>(smem));
  else count_block(P, g, blockIdx.x - P.nsub);
}

// Launch 2. Blocks [0, G): chunk g's exclusive scan of its block counts, in
// place (each thread sums a run of them, one block scan, then the runs).
// The blocks after: a thread per (chunk, sub-batch) whose run has entries in
// later rows writes them at their flat index; then a thread per (chunk,
// prior escape) (pad indices >= npi drop; bins >= n keep their neutral 1).
__global__ void __launch_bounds__(kScanThreads) scan_fix_kernel(Wire P, long long G) {
  if (blockIdx.x < G) {
    const long long g = blockIdx.x;
    unsigned long long* ab = P.block_ab + g * P.nblk;
    const long long per = (P.nblk + kScanThreads - 1) / kScanThreads;
    const long long lo = threadIdx.x * per;
    const long long hi = lo + per < P.nblk ? lo + per : P.nblk;
    unsigned long long sum = 0;
    for (long long i = lo; i < hi; ++i) sum += ab[i];
    unsigned long long total;
    unsigned long long run = artc::block_exclusive_scan(sum, &total);
    for (long long i = lo; i < hi; ++i) {
      const unsigned long long v = ab[i];
      ab[i] = run;
      run += v;
    }
    return;
  }
  const long long t = (long long)(blockIdx.x - G) * blockDim.x + threadIdx.x;
  if (t < G * P.nsub) {
    if (P.ovf[t] == 0) return;
    const long long g = t / P.nsub, s = t - g * P.nsub;
    const uint32_t* w = blob_of(P, g);
    const int* sc = sc_of(P, g);
    long long lo, hi;
    run_of(P, w, sc, s, P.starts[t], lo, hi);
    for (long long j = lo; j < hi; ++j) {
      const long long c = coo_slot(P, w, sc, j);
      const long long flat = s * P.U + c;
      if (c >= P.U && flat < P.nsub * P.U) P.deltas[g * P.nsub * P.U + flat] = nib_value(P, w, j);
    }
    return;
  }
  const long long e = t - G * P.nsub;
  if (e >= G * P.ne) return;
  const long long g = e / P.ne, k = e - g * P.ne;
  const uint32_t* w = blob_of(P, g);
  const long long idx = w[P.off[6] + k];
  if (idx < P.npi && idx < sc_of(P, g)[3] && idx < P.m)
    P.prior[g * P.m + idx] = u16_at(P, w, 7)[k];
}

// Launch 3, a bins block: bit, kind and slot of its 2,048 bins.
__device__ void bins_block(const Wire& P, long long g, long long b) {
  const uint32_t* w = blob_of(P, g);
  const int* sc = sc_of(P, g);
  const int wa = sc[0], wb = sc[1];
  const long long n = sc[3];
  // Loads that do not wait for the scan, started before it.
  const unsigned long long off = P.block_ab[g * P.nblk + b];
  const int* starts = P.starts + g * P.nsub;
  const uint32_t batch = uint32_t(P.batch);
  int bit[2][4], kind[2][4], cls[2][4], run[2][4];
  uint32_t q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = quad_base(b, h);
    q[h] = decode4(P, w, i0, n, bit[h], kind[h], cls[h]);
    uint32_t sb = uint32_t(i0) / batch, rb = uint32_t(i0) - sb * batch;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run[h][k] = kind[h][k] != 3 ? starts[sb] : 0;
      if (++rb == batch) {
        rb = 0;
        ++sb;
      }
    }
  }
  // One scan of both quads' counts, 16 bits each (at most 1,024 a half).
  const unsigned long long packed =
      (unsigned long long)q[0] | ((unsigned long long)q[1] << 32);
  unsigned long long total;
  const unsigned long long ex = artc::block_exclusive_scan(packed, &total);
  if (quad_base(b, 0) >= P.m) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long i0 = quad_base(b, h);
    // Hot and cold positions of the quad's first bin.
    uint32_t hot = uint32_t(off) + uint32_t((ex >> (32 * h)) & 0xffffu);
    uint32_t cold = uint32_t(off >> 32) + uint32_t((ex >> (32 * h + 16)) & 0xffffu);
    if (h == 1) {
      hot += uint32_t(total & 0xffffu);
      cold += uint32_t((total >> 16) & 0xffffu);
    }
    Cursor ch(hot, wa), cc(cold, wb);
    uint32_t rank[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool c = cls[h][k] == 1;
      rank[k] = 0u;
      if (kind[h][k] != 3) {
        rank[k] = c ? cc.entry(w, P.off[2], P.nw - 1) : ch.entry(w, P.off[1], P.nw - 1);
        (c ? cc : ch).next();
      }
    }
    int slot[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      slot[k] = int(P.ud - 1);
      if (kind[h][k] != 3) {
        long long sidx = (long long)run[h][k] + rank[k];
        if (sidx > P.nc - 1) sidx = P.nc - 1;
        if (sidx < 0) sidx = 0;
        slot[k] = int(coo_slot(P, w, sc, sidx));
      }
    }
    store4(P, P.bit + g * P.m, i0, bit[h]);
    store4(P, P.kind + g * P.m, i0, kind[h]);
    store4(P, P.slot + g * P.m, i0, slot);
  }
}

// Launch 3, a count-escape thread: the exact (ones, tot) of an entry whose
// counts passed the nibble, at the entry's (sub-batch, slot).
__device__ void count_escape(const Wire& P, long long g, long long e) {
  if (e >= P.ncc) return;
  const uint32_t* w = blob_of(P, g);
  const int* sc = sc_of(P, g);
  const long long j = w[P.off[10] + e];
  const long long live = P.nc < sc[4] ? P.nc : sc[4];
  if (j >= live) return;
  const int* starts = P.starts + g * P.nsub;
  long long lo = 0, hi = P.nsub - 1;  // the last s with starts[s] <= j (starts[0] = 0)
  while (lo < hi) {
    const long long mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= j) lo = mid;
    else hi = mid - 1;
  }
  const long long flat = lo * P.U + coo_slot(P, w, sc, j);
  if (flat >= P.nsub * P.U) return;
  const uint16_t* ce = u16_at(P, w, 11);
  P.deltas[g * P.nsub * P.U + flat] = int(uint32_t(ce[2 * e]) | (uint32_t(ce[2 * e + 1]) << 16));
}

// Grid (the count-escape blocks + nblk bins blocks, G): the escapes' short
// searches run beside the bins rather than after them. At most 64 registers
// a thread, so that four blocks share an SM (8-12% faster than three at 78
// registers on an H100).
__global__ void __launch_bounds__(kThreads, 4) bins_kernel(Wire P, long long nesc) {
  const long long g = blockIdx.y;
  if (blockIdx.x < nesc) count_escape(P, g, (long long)blockIdx.x * blockDim.x + threadIdx.x);
  else bins_block(P, g, blockIdx.x - nesc);
}

// Devices (bit d: device d < 64) on which rows_count_kernel may take the
// largest dynamic shared memory the card allows a block.
std::atomic<uint64_t> smem_ready{0};

int allow_smem(int dev) {
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (smem_ready.load() & bit) return 0;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, rows_count_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rows_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - int(fa.sharedSizeBytes));
  if (err != cudaSuccess) return int(err);
  smem_ready.fetch_or(bit);
  return 0;
}

// Launches of the last expand call of this thread.
thread_local int g_expand_launches = 0;

}  // namespace

ARTC_API int artc_expand_launches(void) { return g_expand_launches; }

// blob [G, wstride] int32 (u32 words), sc [G, nsc]; planes [4, G, m]
// (bit, kind, slot, prior); deltas [G, nsub * U]; scratch: G * nblk u64
// then 2 * G * nsub ints.
ARTC_API int artc_wire_expand(const int* blob, const int* sc, int* planes, int* deltas,
                              void* scratch, const long long* offs, long long G,
                              long long wstride, long long nsc, long long blob_words,
                              long long m, long long nsub, long long U, long long ud,
                              long long batch, long long Lh, long long Lc, long long npi,
                              long long ne, long long nc, long long ncc, long long mesh,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  g_expand_launches = 0;
  if (G <= 0) return 0;
  if (G > 65535 || batch < 1 || m >= (1ll << 31)) return int(cudaErrorInvalidValue);
  Wire P;
  P.w = reinterpret_cast<const uint32_t*>(blob);
  P.sc = sc;
  P.wstride = wstride;
  P.nsc = int(nsc);
  P.nw = blob_words;
  P.m = m;
  P.nsub = nsub;
  P.U = U;
  P.ud = ud;
  P.batch = batch;
  P.Lh = Lh;
  P.Lc = Lc;
  P.npi = npi;
  P.ne = ne;
  P.nc = nc;
  P.ncc = ncc;
  P.mesh = int(mesh);
  P.nblk = (m + kBinsPerBlock - 1) / kBinsPerBlock;
  for (int k = 0; k < 15; ++k) P.off[k] = offs[k];
  P.bit = planes;
  P.kind = planes + G * m;
  P.slot = planes + 2 * G * m;
  P.prior = planes + 3 * G * m;
  P.deltas = deltas;
  P.block_ab = static_cast<unsigned long long*>(scratch);
  P.starts = reinterpret_cast<int*>(P.block_ab + G * P.nblk);
  P.ovf = P.starts + G * nsub;
  P.vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  P.rvec = U % 4 == 0 && reinterpret_cast<uintptr_t>(deltas) % 16 == 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  int rc = allow_smem(dev);
  if (rc) return rc;
  if (nsub + P.nblk > 0) {
    rows_count_kernel<<<dim3(unsigned(nsub + P.nblk), unsigned(G)), kThreads,
                        size_t(U) * sizeof(int), st>>>(P);
    ++g_expand_launches;
    if ((rc = int(cudaGetLastError()))) return rc;
  }
  const long long aux = (G * nsub + G * ne + kScanThreads - 1) / kScanThreads;
  scan_fix_kernel<<<unsigned(G + aux), kScanThreads, 0, st>>>(P, G);
  ++g_expand_launches;
  if ((rc = int(cudaGetLastError()))) return rc;
  const long long nesc = (ncc + kThreads - 1) / kThreads;
  if (P.nblk + nesc > 0) {
    bins_kernel<<<dim3(unsigned(P.nblk + nesc), unsigned(G)), kThreads, 0, st>>>(P, nesc);
    ++g_expand_launches;
    if ((rc = int(cudaGetLastError()))) return rc;
  }
  return 0;
}

// ------------------------------------------------ profile 0's narrow blob
//
// ops/dense.py's two kernels. A profile-0 chunk crosses the bus once, as one
// byte blob at the dense export's widths (u8 bits and kinds, u16 priors,
// prefix counts, dd/ds and start tables, u32 dictionary indices and keys;
// each segment on a 256-byte boundary), and is widened and padded here:
//   - dense_expand_kernel writes model_pass_v2's int32 inputs: the four bin
//     planes padded to m (kind 3, prior 1, prefix counts 0), dd and ds, and
//     the extended start tables (dual0 then rows of ones, sig0 then rows of
//     ones); bin_u and the key tables are read in place as int32 views;
//   - dense_lanes_kernel, after the pass, writes the masked lane scan's
//     [T, K] planes: the blob's bits, the pass's probs (their low 16 bits)
//     and the valid mask, bit 0 and probability 1 past n.
// Both are elementwise and bound by memory traffic: the expand reads 7 bytes
// a bin and 2 an entry of the tables and writes 16 and 4; the lane planes
// read 5 bytes a bin and write 9 a step. One launch each, every region of
// the expand in one grid (a region's blocks after the one before).

namespace {

constexpr int kDenseThreads = 256;
constexpr int kDenseItems = 8;  // elements a thread, a block's width apart
constexpr long long kDenseSpan = kDenseThreads * kDenseItems;

// One u16 table widened to int32: entries past nsrc are the extension's 1.
struct Widen {
  const uint16_t* src;
  int* dst;
  long long nsrc, count;
};

struct Dense {
  const uint8_t* kind;
  const uint16_t* prior;
  const uint16_t* pre1;
  const uint16_t* pret;
  int* planes;            // [4, m]: kinds, priors, pre1, pret
  long long n, m;
  Widen w[4];             // dd, ds, dual, sig
  long long first[6];     // the first block of each region (bins, then w); first[5] = grid
};

__global__ void __launch_bounds__(kDenseThreads) dense_expand_kernel(const Dense D) {
  const long long b = blockIdx.x;
  int r = 0;
  while (r < 4 && b >= D.first[r + 1]) ++r;
  const long long i0 = (b - D.first[r]) * kDenseSpan + threadIdx.x;
  if (r == 0) {
#pragma unroll
    for (int k = 0; k < kDenseItems; ++k) {
      const long long i = i0 + (long long)k * kDenseThreads;
      if (i >= D.m) break;
      const bool live = i < D.n;
      D.planes[i] = live ? int(D.kind[i]) : 3;
      D.planes[D.m + i] = live ? int(D.prior[i]) : 1;
      D.planes[2 * D.m + i] = live ? int(D.pre1[i]) : 0;
      D.planes[3 * D.m + i] = live ? int(D.pret[i]) : 0;
    }
    return;
  }
  const Widen& W = D.w[r - 1];
#pragma unroll
  for (int k = 0; k < kDenseItems; ++k) {
    const long long i = i0 + (long long)k * kDenseThreads;
    if (i >= W.count) break;
    W.dst[i] = i < W.nsrc ? int(W.src[i]) : 1;
  }
}

__global__ void __launch_bounds__(kDenseThreads) dense_lanes_kernel(
    const uint8_t* __restrict__ bit, const int* __restrict__ probs, int* __restrict__ bits,
    int* __restrict__ p, bool* __restrict__ valid, long long n, long long size) {
  const long long i0 = (long long)blockIdx.x * kDenseSpan + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kDenseItems; ++k) {
    const long long i = i0 + (long long)k * kDenseThreads;
    if (i >= size) break;
    const bool live = i < n;
    bits[i] = live ? int(bit[i]) : 0;
    p[i] = live ? (probs[i] & 0xffff) : 1;
    valid[i] = live;
  }
}

long long dense_blocks(long long count) { return (count + kDenseSpan - 1) / kDenseSpan; }

}  // namespace

// blob: the chunk's bytes, offs[12] its segments' byte offsets (ops/dense.py
// SEGMENTS); planes int32 [4, m]; dd [ndd], ds [nds]; dual [ndual] from nd0
// u16 entries, sig [nsig] from ns0.
ARTC_API int artc_dense_expand(const uint8_t* blob, const long long* offs, int* planes, int* dd,
                               int* ds, int* dual, int* sig, long long n, long long m,
                               long long ndd, long long nds, long long nd0, long long ndual,
                               long long ns0, long long nsig, void* stream) {
  if (n <= 0 || n > m || m >= (1ll << 31)) return int(cudaErrorInvalidValue);
  auto u16 = [&](int k) { return reinterpret_cast<const uint16_t*>(blob + offs[k]); };
  Dense D;
  D.kind = blob + offs[1];
  D.prior = u16(2);
  D.pre1 = u16(3);
  D.pret = u16(4);
  D.planes = planes;
  D.n = n;
  D.m = m;
  D.w[0] = Widen{u16(8), dd, ndd, ndd};
  D.w[1] = Widen{u16(9), ds, nds, nds};
  D.w[2] = Widen{u16(10), dual, nd0, ndual};
  D.w[3] = Widen{u16(11), sig, ns0, nsig};
  D.first[0] = 0;
  D.first[1] = dense_blocks(m);
  for (int r = 0; r < 4; ++r) D.first[r + 2] = D.first[r + 1] + dense_blocks(D.w[r].count);
  if (D.first[5] >= (1ll << 31)) return int(cudaErrorInvalidValue);
  dense_expand_kernel<<<unsigned(D.first[5]), kDenseThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(D);
  return int(cudaGetLastError());
}

// bits/probs int32 and valid bool, [size] = [T * K]; the blob's bits at
// byte off_bit, the pass's probs [>= n].
ARTC_API int artc_dense_lanes(const uint8_t* blob, const int* probs, int* bits, int* p,
                              bool* valid, long long off_bit, long long n, long long size,
                              void* stream) {
  if (n <= 0 || n > size || dense_blocks(size) >= (1ll << 31)) return int(cudaErrorInvalidValue);
  dense_lanes_kernel<<<unsigned(dense_blocks(size)), kDenseThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(blob + off_bit, probs, bits, p, valid,
                                                           n, size);
  return int(cudaGetLastError());
}
