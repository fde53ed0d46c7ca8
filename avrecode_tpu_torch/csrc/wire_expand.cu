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
// What bounds it: memory traffic and the latency of data-dependent reads.
// Per bin it reads half a byte of header nibble, about a byte of packed rank,
// a prior index and one random COO-slot word, and writes 16 bytes of planes;
// the delta table (nsub*U words, 50 MB at bench size) is zero-filled by the
// wrapper and scattered once. Only the rank positions need a scan over all
// bins.
//
// Design: a three-pass scan without a stored per-bin selector: pass 1
// counts hot/cold ranks per block of kBinsPerBlock bins (both counts packed
// in one u64), pass 2 scans the block totals and the sub-batch run lengths
// in one block, pass 3 redecodes the header nibbles, rescans inside the
// block and does the rank unpack, slot lookup and prior for every bin. The
// escape lists and the COO delta scatter follow as small kernels in stream
// order (an escape overrides the value written before it). Divisions are
// integer divisions; the TPU's float-reciprocal form existed only for its
// vector unit. Gathers JAX clamps (the COO slot words) clamp the same way,
// and the gathers JAX promises in bounds clamp too, which changes nothing
// for valid input but keeps every read inside the blob.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
// ops/model_pass.py _EXPAND_BINS sizes the per-block scratch from this.
constexpr int kBinsPerBlock = kThreads * kItems;

struct Wire {
  const uint32_t* w;  // the blob
  const int* sc;      // [wa, wb, wcs, n, n_coo (, ud_real in mesh mode)] on the device
  long long nw, m, nsub, U, ud, batch, Lh, Lc, npi, ne, nc, ncc;
  int mesh;           // 1: shift slots >= sc[5] up into the mesh-uniform space
  long long off[15];  // segment offsets (ops/model_pass._blob_layout_words)
};

__device__ inline const uint8_t* u8_at(const Wire& P, int k) {
  return reinterpret_cast<const uint8_t*>(P.w + P.off[k]);
}

__device__ inline const uint16_t* u16_at(const Wire& P, int k) {
  return reinterpret_cast<const uint16_t*>(P.w + P.off[k]);
}

// No-straddle w-bit entry `pos` of the stream at word `base` (BitPacker::
// put_ns: entry j lives wholly inside word j / (32/w)); the word index
// clamps at `last`. A 0-bit entry (the zero widths of the mesh's pad chunks)
// is 0.
__device__ inline uint32_t unpack_ns(const uint32_t* w, long long base, long long last,
                                     long long pos, int width) {
  if (width <= 0) return 0u;
  const int epw = 32 / width;
  const long long q = pos / epw;
  const int shift = int(pos - q * epw) * width;
  long long wi = base + q;
  if (wi > last) wi = last;
  const uint32_t mask = width >= 32 ? 0xffffffffu : ((1u << width) - 1u);
  return (w[wi] >> shift) & mask;
}

// COO slot entry j (the wcs-bit stream, word index clamped to its segment),
// shifted into the mesh-uniform dictionary space in mesh mode.
__device__ inline long long coo_slot(const Wire& P, long long j) {
  long long c = unpack_ns(P.w, P.off[3], P.off[3] + P.Lc - 1, j, P.sc[2]);
  if (P.mesh) {
    const long long ud_real = P.sc[5];
    if (c >= ud_real) c += P.ud - ud_real;
  }
  return c;
}

// Header nibble of bin i: bit<<3 | kind<<1 | cls; bins >= n are padding
// (kind 3, bit 0). Returns the packed (hot, cold) rank selector.
__device__ inline unsigned long long decode(const Wire& P, long long i, long long n,
                                            int& bit, int& kind, int& cls) {
  uint32_t hdr = 0;
  if (i < P.Lh * 8) hdr = (P.w[P.off[0] + (i >> 3)] >> (4 * (i & 7))) & 15u;
  const bool live_n = i < n;
  bit = live_n ? int(hdr >> 3) : 0;
  kind = live_n ? int((hdr >> 1) & 3u) : 3;
  cls = int(hdr & 1u);
  if (kind == 3) return 0ull;
  return cls ? (1ull << 32) : 1ull;
}

__global__ void count_kernel(Wire P, unsigned long long* block_ab) {
  const long long base = (long long)blockIdx.x * kBinsPerBlock + threadIdx.x * kItems;
  const long long n = P.sc[3];
  unsigned long long s = 0;
  int bit, kind, cls;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (base + k < P.m) s += decode(P, base + k, n, bit, kind, cls);
  unsigned long long total;
  artc::block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) block_ab[blockIdx.x] = total;
}

// One block: exclusive scans of the block totals (in place) and of the
// per-sub-batch COO run lengths (-> run starts).
__global__ void scan_kernel(Wire P, unsigned long long* block_ab, long long nblk,
                            int* starts) {
  artc::block_scan_array<unsigned long long>(
      [&](long long i) { return block_ab[i]; }, block_ab, nblk);
  const uint16_t* cnt = u16_at(P, 8);
  artc::block_scan_array<int>([&](long long i) { return int(cnt[i]); }, starts, P.nsub);
}

__global__ void bins_kernel(Wire P, const unsigned long long* __restrict__ block_ab,
                            const int* __restrict__ starts, int* __restrict__ bit_out,
                            int* __restrict__ kind_out, int* __restrict__ slot_out,
                            int* __restrict__ prior_out) {
  const long long base = (long long)blockIdx.x * kBinsPerBlock + threadIdx.x * kItems;
  const int wa = P.sc[0], wb = P.sc[1];
  const long long n = P.sc[3];
  int bit[kItems], kind[kItems], cls[kItems];
  unsigned long long sel[kItems], s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    sel[k] = base + k < P.m ? decode(P, base + k, n, bit[k], kind[k], cls[k]) : 0ull;
    s += sel[k];
  }
  unsigned long long total;
  unsigned long long pos = block_ab[blockIdx.x] + artc::block_exclusive_scan(s, &total);
  const uint8_t* pidx = u8_at(P, 4);
  const uint16_t* pdict = u16_at(P, 5);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i >= P.m) break;
    const bool cold = cls[k] == 1;
    const long long p = cold ? (long long)(pos >> 32) : (long long)(pos & 0xffffffffull);
    const uint32_t rank = unpack_ns(P.w, cold ? P.off[2] : P.off[1], P.nw - 1, p,
                                    cold ? wb : wa);
    pos += sel[k];
    int slot = int(P.ud - 1);
    if (kind[k] != 3) {
      long long sidx = (long long)starts[i / P.batch] + rank;
      if (sidx > P.nc - 1) sidx = P.nc - 1;
      slot = int(coo_slot(P, sidx));
    }
    bit_out[i] = bit[k];
    kind_out[i] = kind[k];
    slot_out[i] = slot;
    prior_out[i] = i < n ? int(pdict[pidx[i]]) : 1;
  }
}

// Prior escapes (pad indices >= npi drop; bins >= n keep their neutral 1).
__global__ void prior_esc_kernel(Wire P, int* prior) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.ne) return;
  const long long idx = P.w[P.off[6] + e];
  if (idx < P.npi && idx < P.sc[3]) prior[idx] = u16_at(P, 7)[e];
}

// One thread per sub-batch writes its own COO run's sub-batch index (the
// mark + cumsum of the JAX version, for the live entries).
__global__ void coo_sub_kernel(Wire P, const int* starts, int* coo_sub) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= P.nsub) return;
  long long end = (long long)starts[s] + u16_at(P, 8)[s];
  const long long live = P.nc < P.sc[4] ? P.nc : P.sc[4];
  if (end > live) end = live;
  for (long long j = starts[s]; j < end; ++j) coo_sub[j] = int(s);
}

__device__ inline void put_delta(const Wire& P, const int* coo_sub, int* deltas,
                                 long long j, uint32_t v) {
  const long long s = coo_sub[j];
  const long long c = coo_slot(P, j);
  const long long flat = s * P.U + c;
  if (s >= 0 && flat < P.nsub * P.U) deltas[flat] = int(v);
}

// One thread per live COO entry: (ones, tot) widened from the nibble to one
// u32 (ones low, tot high) at (sub-batch, slot).
__global__ void delta_kernel(Wire P, const int* coo_sub, int* deltas) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P.nc || j >= P.sc[4]) return;
  const uint32_t nib = u8_at(P, 9)[j];
  put_delta(P, coo_sub, deltas, j, (nib & 15u) | ((nib >> 4) << 16));
}

// Exact (ones, tot) for entries whose counts passed the nibble.
__global__ void delta_esc_kernel(Wire P, const int* coo_sub, int* deltas) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.ncc) return;
  const long long j = P.w[P.off[10] + e];
  if (j >= P.nc || j >= P.sc[4]) return;
  const uint16_t* ce = u16_at(P, 11);
  put_delta(P, coo_sub, deltas, j, uint32_t(ce[2 * e]) | (uint32_t(ce[2 * e + 1]) << 16));
}

}  // namespace

ARTC_API int artc_wire_expand(const int* blob, const int* sc, int* bit, int* kind,
                              int* slot, int* prior, int* deltas,
                              unsigned long long* block_ab, int* starts, int* coo_sub,
                              const long long* offs, long long blob_words, long long m,
                              long long nsub, long long U, long long ud, long long batch,
                              long long Lh, long long Lc, long long npi, long long ne,
                              long long nc, long long ncc, long long mesh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Wire P;
  P.w = reinterpret_cast<const uint32_t*>(blob);
  P.sc = sc;
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
  for (int k = 0; k < 15; ++k) P.off[k] = offs[k];
  const long long nblk = (m + kBinsPerBlock - 1) / kBinsPerBlock;
  if (nblk > 0) {
    count_kernel<<<unsigned(nblk), kThreads, 0, st>>>(P, block_ab);
    scan_kernel<<<1, 1024, 0, st>>>(P, block_ab, nblk, starts);
    bins_kernel<<<unsigned(nblk), kThreads, 0, st>>>(P, block_ab, starts, bit, kind,
                                                      slot, prior);
  }
  if (ne > 0) prior_esc_kernel<<<artc::grid_for(ne, 256), 256, 0, st>>>(P, prior);
  if (nsub > 0) coo_sub_kernel<<<artc::grid_for(nsub, 256), 256, 0, st>>>(P, starts, coo_sub);
  if (nc > 0) delta_kernel<<<artc::grid_for(nc, 256), 256, 0, st>>>(P, coo_sub, deltas);
  if (ncc > 0) delta_esc_kernel<<<artc::grid_for(ncc, 256), 256, 0, st>>>(P, coo_sub, deltas);
  return int(cudaGetLastError());
}
