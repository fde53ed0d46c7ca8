// The adaptive-model probability passes and their table set-up.
//
// Replaces, in avrecode_tpu/ops/model_pass.py:
//   - model_pass_v4 -> v3_core (profile 2, frozen batches), with its table
//     set-up (dual0 widened with ones scratch rows, sig0 zeros + warm-row
//     scatter) and dual0_expand (one launch over the wire-width dictionary);
//   - model_pass_v2 (profile 0, super-batched, host-shipped prefix counts);
//   - model_pass_dict (profile 0, per-batch dictionary pass);
//   - model_pass, impl "sort" and "mm" (profile 0, per-batch scatter-add pass);
// with the shared math of _halve_while, _halve_iters, _div_floor and
// _dual_prob.
//
// What bounds them: the serial dependency between steps (a step reads the
// table rows the previous step wrote), not bandwidth. Inside a step the rows
// are independent, and so are the bins. One stream carries every launch, so
// launch order is the step order.
//
// v3_core and model_pass_v2 are one persistent cooperative pass each
// (scan_kernel; its section below says how): per chunk, stage blocks walk
// the super-steps' sub-batches slot by slot while probability blocks work one
// super-step behind them, with one barrier of the chunk's blocks a
// super-step. v3_core takes a leading chunk axis (the mesh's vmap over a
// device's chunks, written out): chunk g is blockIdx.y and owns its planes,
// key tables, deltas, start tables and staging scratch, so G chunks of one
// shape are one launch (more only where they do not fit the card at once).
// The two passes differ only in where the deltas come from (one packed u32
// per slot, or separate dual and sig (ones, total) planes) and in v2's
// per-bin prefix adders.
//
// model_pass_dict and model_pass run as a pre-pass over every batch at once
// (the within-batch per-key exclusive prefix counts and update totals depend
// only on keys, kinds and bits, not on the tables, so they leave the serial
// chain) and one persistent kernel that walks the batches; their section
// below says how. The one-hot products of the TPU's dict pass are gathers
// here, and the "sort" and "mm" formulations of the prefix counts are one
// ordered walk with a hash table. Both are exact and deterministic: a live
// row has one writer a batch, and dict's scratch rows are never written.
// Integer division replaces the TPU's float-reciprocal divide (which existed
// only for its vector unit). All arithmetic is int32: every value stays below
// 2^31 (the CPU tests assert it).
#include "common.cuh"

namespace {

constexpr int kResDirAlpha = 32;  // native/model.h kResDirAlpha
constexpr int kResDirK = 2;       // native/model.h kResDirFastBoost
constexpr int kHalveDefault = 16; // _halve_while's default iteration count

struct Model {
  long long n_dual, n_sig, ns, sup, batch, ud, us, U;
  // Chunk strides (ints) of the chunk axis (blockIdx.y); unused with one chunk.
  long long plane_stride, dkd_stride, dks_stride, delta_stride, dual_stride, sig_stride;
  int fast_w, slow_w, sig_w, it_f, it_s, it_g, alpha_on, alpha_off;
};

__device__ inline int clamp_prob(int p) {
  return p < 1 ? 1 : (p > artc::kProbScale - 1 ? artc::kProbScale - 1 : p);
}

// floor(num / den) for num >= 0. A zero denominator only occurs in a branch
// whose bin kind discards it; it is read as 1, as the plain version does.
__device__ inline int div_floor(int num, int den) { return num / (den > 0 ? den : 1); }

// while (p + n > window) { p = (p+1)>>1; n = (n+1)>>1; }, at most `iters`
// times, as JAX's _halve_while unrolls it. JAX runs every iteration masked;
// a pair within its window is a fixed point of the masked step, so stopping
// at the first iteration that finds it there gives the same pair.
__device__ __forceinline__ void halve(int& p, int& n, int window, int iters) {
  for (int k = 0; k < iters && p + n > window; ++k) {
    p = (p + 1) >> 1;
    n = (n + 1) >> 1;
  }
}

// halve() with its first two iterations as selects, off the branch: (x + 1)
// >> 1 is ceil(x / 2) and ceilings compose, so two steps give (x + 3) >> 2,
// and both candidates are computed beside the window tests. The loop runs
// only for a pair still over its window after two steps.
__device__ __forceinline__ void halve_fast(int& p, int& n, int window, int iters) {
  const int p1 = (p + 1) >> 1, n1 = (n + 1) >> 1, p2 = (p + 3) >> 2, n2 = (n + 3) >> 2;
  const bool h1 = iters >= 1 && p + n > window;
  const bool h2 = h1 && iters >= 2 && p1 + n1 > window;
  p = h2 ? p2 : (h1 ? p1 : p);
  n = h2 ? n2 : (h1 ? n1 : n);
  if (h2 && iters > 2 && p + n > window) {
    for (int k = 2; k < iters && p + n > window; ++k) {
      p = (p + 1) >> 1;
      n = (n + 1) >> 1;
    }
  }
}

// One bin's probability by kind from its effective estimator state: kind 0
// the fast/slow (+ prior) mix or the v15 Dirichlet residual mix (prior bit 15
// tagged), kind 1 the slow voice, kind 2 the sig counts mixed with the prior
// at weight alpha_on or alpha_off (bit 15), kind 3 the prior passed through.
__device__ inline int bin_prob(int kind, int prior_raw, int dfp, int dfn, int dsp, int dsn,
                               int spos, int sneg, int alpha_on, int alpha_off) {
  const int prior_f = prior_raw & 0x7fff, tag = int(uint32_t(prior_raw) >> 15);
  int p;
  if (kind == 3) {
    p = prior_f;
  } else if (kind == 0) {
    if (tag) {
      p = div_floor(((kResDirK * dfp + dsp) << artc::kProbBits) + kResDirAlpha * prior_f,
                    kResDirK * (dfp + dfn) + dsp + dsn + kResDirAlpha);
    } else {  // fixed-weight linear mix of the fast and slow voices (+ prior)
      const int ps = div_floor(dsp << artc::kProbBits, dsp + dsn);
      const int pf = div_floor(dfp << artc::kProbBits, dfp + dfn);
      p = prior_f > 0 ? (3 * (pf + ps) + 2 * prior_f) >> 3 : (pf + ps) >> 1;
    }
  } else if (kind == 1) {
    p = div_floor(dsp << artc::kProbBits, dsp + dsn);
  } else {
    const int alpha = tag ? alpha_off : alpha_on;
    p = div_floor((spos << artc::kProbBits) + alpha * prior_f, spos + sneg + alpha);
  }
  return clamp_prob(p);
}

// ---------------------------------------------------------------- dual0_expand
//
// One launch over blocks of kDual0Rows contiguous table rows, reading the
// dictionary at the widths the wire ships it: rows u16[R][4], idx u8[n_dual],
// escape indices u32 (the live ones strictly ascending, as the native writer
// emits them and the host checks; padding = n_dual) and escape rows u16[4].
// A block stages the dictionary (2 KB) and its indices (read as 16-byte
// vectors) in shared memory. It narrows the ascending escape list to a
// window of at most one entry a thread that holds its first escape (rounds
// of one strided probe a thread: none for up to 256 escapes, one for up to
// 65,536), reads the list from there one entry a thread while the entries
// stay below its end, and drops each of its escapes into its row in shared
// memory with a flag. Each row is then built in registers (the escape, or
// the dictionary row) and stored once as one 16-byte int4. With 256
// escapes or fewer every global load of the block is issued before its
// first barrier. An escape index at or past n_dual (the padding) falls in
// no block and drops; a u8 index past the dictionary is clamped to its last
// row, as JAX's gather clamps.
constexpr int kDual0Threads = 256;
constexpr int kDual0Rows = 1024;  // 4 a thread
constexpr int kDual0Dict = 256;   // the rows a u8 index can name

__global__ void __launch_bounds__(kDual0Threads)
dual0_expand_kernel(const uint2* __restrict__ rows, const uint8_t* __restrict__ idx,
                    const uint32_t* __restrict__ esc_idx, const uint2* __restrict__ esc_val,
                    int4* __restrict__ out, int n_rows, long long n_dual, long long ne) {
  __shared__ uint2 dict[kDual0Dict];
  __shared__ __align__(16) uint8_t ix[kDual0Rows];
  __shared__ __align__(16) uint8_t escaped[kDual0Rows];
  __shared__ uint2 esc_row[kDual0Rows];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kDual0Rows;
  const int nb = n_dual - r0 < kDual0Rows ? int(n_dual - r0) : kDual0Rows;
  const long long r1 = r0 + nb;
  const int staged = n_rows < kDual0Dict ? n_rows : kDual0Dict;
  if (t < staged) dict[t] = rows[t];
  if (t < kDual0Rows / 16) {  // idx starts on 16 bytes (the wrapper checks)
    const int b = t * 16;
    if (b + 16 <= nb) {
      reinterpret_cast<uint4*>(ix)[t] = *reinterpret_cast<const uint4*>(idx + r0 + b);
    } else {
      for (int k = b; k < nb; ++k) ix[k] = idx[r0 + k];
    }
    reinterpret_cast<uint4*>(escaped)[t] = make_uint4(0, 0, 0, 0);
  }
  // Narrow [lo, hi] to hold the first escape >= r0 and span at most one
  // entry a thread. The probes lo + t * stride below r0 are a prefix (the
  // list ascends), so the count leaves a range shorter than the stride.
  long long lo = 0, hi = ne;
  while (hi - lo > kDual0Threads) {
    const long long stride = (hi - lo + kDual0Threads - 1) / kDual0Threads;
    const long long p = lo + t * stride;
    const int below = __syncthreads_count(p < hi && esc_idx[p] < r0);
    if (below > 0) {
      hi = lo + below * stride < hi ? lo + below * stride : hi;
      lo += (below - 1) * stride + 1;
    } else {
      hi = lo;
    }
  }
  long long e = lo + t;
  uint32_t k = e < ne ? esc_idx[e] : 0xffffffffu;
  uint2 v = e < ne ? esc_val[e] : make_uint2(0, 0);
  __syncthreads();  // dict, ix and the flags staged
  // Entries below r0 are skipped, the block's own are dropped into place,
  // and the walk goes on while every entry of a round is below r1. The
  // barrier that ends it also orders the drops before the stores.
  for (;;) {
    if (k >= r0 && k < r1) {
      esc_row[k - r0] = v;
      escaped[k - r0] = 1;
    }
    if (!__syncthreads_and(k < r1)) break;
    e += kDual0Threads;
    k = e < ne ? esc_idx[e] : 0xffffffffu;
    v = e < ne ? esc_val[e] : make_uint2(0, 0);
  }
  for (int j = t; j < nb; j += kDual0Threads) {
    const int r = ix[j];
    const uint2 w = escaped[j] ? esc_row[j] : dict[r < staged ? r : staged - 1];
    out[r0 + j] = make_int4(int(w.x & 0xffffu), int(w.x >> 16), int(w.y & 0xffffu),
                            int(w.y >> 16));
  }
}

// The launch floor: dual0_expand_kernel's grid and block doing nothing.
__global__ void launch_floor_kernel() {}

// v3_core, chunk blockIdx.y: dual = [dual0; ones(1 + ud)], sig = [zeros(n_sig);
// ones(us)].
__global__ void tables_init_kernel(const int* __restrict__ dual0, int* __restrict__ dual,
                                   int* __restrict__ sig, Model M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long g = blockIdx.y;
  dual0 += g * M.n_dual * 4;
  dual += g * M.dual_stride;
  sig += g * M.sig_stride;
  if (i < (M.n_dual + 1 + M.ud) * 4) dual[i] = i < M.n_dual * 4 ? dual0[i] : 1;
  if (i < (M.n_sig + M.us) * 2) sig[i] = i < M.n_sig * 2 ? 0 : 1;
}

// Sparse warm sig rows (v16 warm-started chunks) at their wire widths (u32
// index, u16 values), k per chunk blockIdx.y; pad rows (>= n_sig) drop.
__global__ void sig0_scatter_kernel(const int* __restrict__ idx,
                                    const uint16_t* __restrict__ val,
                                    int* __restrict__ sig, long long k, long long n_sig,
                                    long long sig_stride) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= k) return;
  const long long g = blockIdx.y;
  idx += g * k;
  val += g * k * 2;
  sig += g * sig_stride;
  const long long r = (long long)(uint32_t)idx[e];
  if (r >= n_sig) return;
  sig[r * 2] = val[e * 2];
  sig[r * 2 + 1] = val[e * 2 + 1];
}

// ------------------------------------------------- model_pass_dict / model_pass
//
// Both passes run as seven or eight launches whatever the number of batches
// (two copies, two clears, and three or four kernels): a pre-pass over every
// batch at once (everything that does not depend on the tables), and one
// persistent cooperative kernel that walks the batches.
//
// The only true dependency is between batches: batch b reads table rows as
// batch b - 1 left them. A batch touches a set of distinct rows, its
// entries: the host's dictionary for model_pass_dict, and for model_pass the
// distinct unified keys of the batch, found on the device by the pre-pass.
// Per entry the pre-pass leaves an int4 (dual row to read, sig row to read,
// packed dual totals, packed sig totals; the totals are masked by kind as in
// JAX, so they are not the prefix totals) and per bin its entry and its
// packed prefix counts. With that, the chain of a pass is per batch: load the
// entries' rows (they hit L2), add the totals, halve, store, one barrier.
// The probabilities are not on the chain at all: the chain stages every
// entry's start-of-batch row into a ring in device memory and publishes the
// batches (release); consumer blocks of the same launch wait for them
// (acquire), compute the probabilities from the staged rows plus the prefix
// counts, and hand the ring slots back. The launch is cooperative, so every
// block is resident and the waits cannot deadlock; a launch the card refuses
// is returned as an error.
//
//   - The chain of a chunk is a thread-block cluster of kCluster blocks on
//     neighbouring SMs, which meet at the cluster's hardware barrier once a
//     batch (release / acquire: rows stored before it are visible after it).
//     One SM could not run a batch's few hundred instructions an entry fast
//     enough: a single block took 3.7-6.1 us a batch on an H100, the cluster
//     1.9-2.1 us. Entry u belongs to block u % kCluster, so a batch of up to
//     2,048 entries is one entry a thread. The entries come from a
//     thread-private cp.async ring in shared memory, four batches ahead
//     (each thread copies what it will read itself, so the ring needs no
//     barrier of its own). Table loads bypass L1 (ld.global.cg): another SM
//     may have written the row one barrier earlier.
//   - A ninth warp in each chain block holds no entries and only keeps the
//     barriers' count; in block 0 it also publishes the staged batches and
//     watches the ring, between its arrival at a barrier and its wait, so no
//     warp with entries pays for a release fence or a poll.
//   - One writer per row: entries of a batch are distinct keys. A batch in
//     which a bin's key is out of range reads a clamped row that another
//     entry may write (gathers clamp, adds drop): such a batch, flagged by
//     the pre-pass, separates its loads from its stores by a second barrier.
//   - model_pass halves both whole tables after every batch in JAX. A row
//     within its window is a fixed point of the halving, and the rows a
//     batch touches are halved by their entries (the same 16 iterations), so
//     once every row is within its window, whole-table halving changes
//     nothing a batch did not touch, by induction over the batches. The
//     chain therefore halves the whole tables after batch 0 as JAX does,
//     counts the rows still over a window, and goes on halving whole tables
//     after each batch only while that count is not zero (entries then only
//     add, and the table pass halves every row once, as JAX does); it starts
//     again if an entry's 16 iterations leave a row over its window. Real
//     seeds are within their windows, so real streams halve whole tables
//     once.
//   - model_pass takes a leading chunk axis (blockIdx.y; every chunk its own
//     tables, ring, flags, chain cluster and consumers).
//   - The pre-pass counts earlier equal keys in order with one warp per
//     batch: 32 bins a step, __match_any_sync groups equal keys within the
//     step, and a hash table in shared memory (64-bit slots: key, entry)
//     carries each key's running (ones, total) between steps. It is linear in
//     the batch, where comparing every pair was quadratic.
//
// Bin kinds are 0-3. All counts stay below 2^15 (batch <= 12288), so (ones,
// total) pack into one word, and the per-entry totals are one atomic add a
// bin.

// Largest batch (and dictionary width): the chain's entry ring and the
// pre-pass's hash table must fit shared memory, and counts 15 bits.
constexpr long long kMaxPrefixBatch = 12288;
constexpr int kPassThreads = 1024;
constexpr int kCluster = 8;        // chain blocks of a chunk: one thread-block cluster
constexpr int kChainThreads = 256; // entry-owning threads of a chain block (warps 0-7)
constexpr int kLiveThreads = kChainThreads + 32;  // and its control warp (warp 8)
constexpr int kStages = 4;         // batches of entries copied ahead
constexpr int kMaxConsumerClusters = 6;  // clusters of consumer blocks a chunk
constexpr int kPublishEvery = 16;   // batches between two releases to the consumers
constexpr int kTotShift = 15;
constexpr uint32_t kCountMask = (1u << kTotShift) - 1;
constexpr uint32_t kLoadBit = 1u << 31;  // the row is read whatever the totals
constexpr uint32_t kLiveBit = 1u << 30;  // the row may be written
constexpr uint32_t kPending = 0xfffffffeu;
// Cycle counters (clock64) the kernel leaves behind the flags, so that a run
// can say what paced it: the time block 0's ninth warp was held up by a full
// ring; of block 0's thread 0 its waits at the batch barrier (the barrier
// itself and the slowest warp of the cluster) and for the entries' copies,
// its own loads-to-stores, and the rest (copies started, whole-table
// halvings); of the first consumer block's thread 0 its waits for a published
// batch and its batches' work.
enum PassProf { kProfRing, kProfBarrier, kProfCopies, kProfBody, kProfRest, kProfConsumerWait,
                kProfConsumerWork, kProf = 8 };
// Behind them, the chain cluster's own words: more[3] and over[3] (see
// chain_role).
constexpr int kCtl = 6;
constexpr int kSyncTail = kProf + kCtl;

struct Pass {
  const int *bits, *kinds, *priors;
  const int* keys;       // model_pass: keys; dict: bin_u
  const int* dict_keys;  // dict: [nb][U]
  const int* bin_e;      // each bin's entry (dict: bin_u; model_pass: from the pre-pass)
  int* bin_e_out;        // model_pass: the pre-pass writes bin_e here
  int* pre;              // per bin pre_ones | pre_tot << 16
  int4* entries;         // [G][nb][U]: dual row, sig row, dual totals, sig totals
  int2* meta;            // [G][nb]: entries in use, hazard
  int4* stage;           // [G][R][U][2]: staged dual row, staged sig row
  int* sync;             // [G][1 + R + kSyncTail]: batches published, per slot the batch
                         // consumed + 1, the cycle counters of PassProf, the chain's words
  int *dual, *sig;       // [G] working tables
  int* probs;
  long long nb, batch, U, n_dual, n_sig, R, g0;
  int K;  // entries a chain thread
  int slots_log2;
  int fast_w, slow_w, sig_w, alpha_on, alpha_off;
  int dict;  // 1: model_pass_dict (no key retarget, no whole-table halving)
};

__device__ __forceinline__ int clampi(long long v, long long hi) {
  return int(v < 0 ? 0 : (v > hi ? hi : v));
}

// Pre-pass, one warp per (batch, chunk): per bin the exclusive per-key prefix
// counts, in order; for model_pass also each bin's entry (keys numbered in
// order of first appearance), the entries' rows and the count of entries.
__global__ void __launch_bounds__(32) prefix_walk_kernel(Pass P) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  const long long slots = 1ll << P.slots_log2;
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(walk_smem);
  uint32_t* val = reinterpret_cast<uint32_t*>(slot + slots);  // running ones | total << 16
  const int lane = threadIdx.x;
  const uint32_t lt = (1u << lane) - 1u;
  const long long gb = (long long)blockIdx.y * P.nb + blockIdx.x;
  const long long base = gb * P.batch;
  int4* ent = P.entries + gb * P.U;
  for (long long s = lane; s < slots; s += 32) slot[s] = ~0ull;
  __syncwarp();
  int n_u = 0;
  // One step: 32 bins, in order. `ukey` and `bit` were loaded kAhead steps
  // ahead: a single warp has nothing else to hide the loads' latency behind.
  auto step = [&](long long i0, uint32_t ukey, uint32_t bit) {
    const long long i = i0 + lane;
    const bool active = i < P.batch;
    const uint32_t amask = __ballot_sync(0xffffffffu, active);
    if (active) {
      const uint32_t m = __match_any_sync(amask, ukey);
      const uint32_t bm = __ballot_sync(amask, bit != 0);
      const int leader = __ffs(m) - 1;
      uint32_t h = 0, e = 0, v = 0;
      bool isnew = false;
      if (lane == leader) {  // find the key's slot, or claim an empty one
        h = (ukey * 2654435761u) >> (32 - P.slots_log2);
        for (;;) {
          unsigned long long w = *reinterpret_cast<volatile unsigned long long*>(&slot[h]);
          if (w == ~0ull) {
            w = atomicCAS(&slot[h], ~0ull, (unsigned long long)ukey << 32 | kPending);
            if (w == ~0ull) {
              isnew = true;
              break;
            }
          }
          if (uint32_t(w >> 32) == ukey) {
            e = uint32_t(w);
            break;
          }
          h = (h + 1) & uint32_t(slots - 1);
        }
        if (!isnew) v = val[h];
      }
      __syncwarp(amask);
      const uint32_t newmask = __ballot_sync(amask, isnew);
      if (isnew) {
        e = uint32_t(n_u + __popc(newmask & lt));
        slot[h] = (unsigned long long)ukey << 32 | e;
        if (!P.dict) {
          const long long uk = int32_t(ukey), sk = uk - P.n_dual;
          ent[e] = make_int4(clampi(uk, P.n_dual - 1), clampi(sk, P.n_sig - 1),
                             int(uk >= 0 && uk < P.n_dual ? kLiveBit : 0u),
                             int(sk >= 0 && sk < P.n_sig ? kLiveBit : 0u));
        }
      }
      if (lane == leader) val[h] = v + (uint32_t(__popc(m & bm)) | uint32_t(__popc(m)) << 16);
      n_u += __popc(newmask);
      v = __shfl_sync(amask, v, leader);
      e = __shfl_sync(amask, e, leader);
      const uint32_t pre1 = (v & 0xffffu) + uint32_t(__popc(m & bm & lt));
      const uint32_t pret = (v >> 16) + uint32_t(__popc(m & lt));
      P.pre[base + i] = int(pre1 | pret << 16);
      if (!P.dict) P.bin_e_out[base + i] = int(e);
    }
    __syncwarp();
  };
  constexpr int kAhead = 8;  // steps whose inputs are in flight
  uint32_t nk[kAhead], nb_[kAhead];
  auto fetch = [&](long long i0) {
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long i = i0 + q * 32 + lane;
      nk[q] = nb_[q] = 0;
      if (i < P.batch) {
        nk[q] = uint32_t(P.keys[base + i]);
        if (!P.dict) {  // model_pass's unified key
          const int k = P.kinds[base + i];
          if (k == 3) nk[q] = uint32_t(P.n_dual - 1);
          else if (k == 2) nk[q] += uint32_t(P.n_dual);
        }
        nb_[q] = uint32_t(P.bits[base + i]) & 1u;
      }
    }
  };
  fetch(0);
  for (long long i0 = 0; i0 < P.batch; i0 += 32 * kAhead) {
    uint32_t ck[kAhead], cb[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      ck[q] = nk[q];
      cb[q] = nb_[q];
    }
    if (i0 + 32 * kAhead < P.batch) fetch(i0 + 32 * kAhead);
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {  // unrolled: ck and cb stay in registers
      if (i0 + q * 32 < P.batch) step(i0 + q * 32, ck[q], cb[q]);
    }
  }
  if (!P.dict && lane == 0) P.meta[gb].x = n_u;
}

// dict pre-pass, one thread per (batch, entry): the rows of dict entry dk. A
// dual key reads its dual row and the sig scratch row, a sig key (>= n_dual)
// its sig row and the dual scratch row; scratch rows are never written.
__global__ void dict_entries_kernel(Pass P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.nb * P.U) return;
  const long long dk = P.dict_keys[i];
  const bool is_sig = dk >= P.n_dual;
  const int d = clampi(is_sig ? P.n_dual - 1 : dk, P.n_dual - 1);
  const int s = clampi(is_sig ? dk - P.n_dual : P.n_sig - 1, P.n_sig - 1);
  P.entries[i] = make_int4(d, s, int(kLoadBit | (d != P.n_dual - 1 ? kLiveBit : 0u)),
                           int(kLoadBit | (s != P.n_sig - 1 ? kLiveBit : 0u)));
  if (i % P.U == 0) P.meta[i / P.U] = make_int2(int(P.U), 0);
}

// Pre-pass, one thread per bin: adds the bin to its entry's update totals,
// masked by kind as in JAX (kind 3 updates nothing, kind 2 only sig, the
// others only dual), and flags a model_pass batch that holds an out-of-range
// key.
__global__ void entry_totals_kernel(Pass P, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = P.kinds[i];
  if (k == 3) return;
  const long long gb = i / P.batch;
  const int e = clampi(P.bin_e[i], P.U - 1);
  int* t = reinterpret_cast<int*>(P.entries + gb * P.U + e);
  atomicAdd(t + (k == 2 ? 3 : 2), (P.bits[i] & 1) | (1 << kTotShift));
  if (!P.dict) {
    const long long key = P.keys[i];
    if (key < 0 || key >= (k == 2 ? P.n_sig : P.n_dual)) P.meta[gb].y = 1;
  }
}

// _halve_while's default count (the dict and sort/mm passes).
__device__ __forceinline__ void halve_until(int& p, int& n, int window) {
  halve(p, n, window, kHalveDefault);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async_entry(int4* dst, const int4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   uint32_t(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

struct EntryTotals {
  int ones, zeros;
  bool load, write;
};

__device__ __forceinline__ EntryTotals entry_totals(int packed) {
  const uint32_t z = uint32_t(packed);
  const int ones = int(z & kCountMask), tot = int((z >> kTotShift) & kCountMask);
  const bool load = (z & kLoadBit) != 0 || tot > 0;
  return {ones, tot - ones, load, load && (z & kLiveBit) != 0};
}

// One entry's update: the rows it may write take its totals and, unless a
// whole-table halving follows (`whole`), are halved. Returns whether a row
// it halved is still over its window (16 iterations were not enough).
__device__ __forceinline__ bool entry_update(const Pass& P, int* dual, int* sig, int4 en, int4 d,
                                             int2 s, bool whole) {
  const EntryTotals td = entry_totals(en.z), ts = entry_totals(en.w);
  bool over = false;
  if (td.write) {
    int fp = d.x + td.ones, fn = d.y + td.zeros, sp = d.z + td.ones, sn = d.w + td.zeros;
    if (!whole) {
      halve_until(fp, fn, P.fast_w);
      halve_until(sp, sn, P.slow_w);
      over = fp + fn > P.fast_w || sp + sn > P.slow_w;
    }
    *reinterpret_cast<int4*>(dual + (long long)en.x * 4) = make_int4(fp, fn, sp, sn);
  }
  if (ts.write) {
    int gp = s.x + ts.ones, gn = s.y + ts.zeros;
    if (!whole) {
      halve_until(gp, gn, P.sig_w);
      over = over || gp + gn > P.sig_w;
    }
    *reinterpret_cast<int2*>(sig + (long long)en.y * 2) = make_int2(gp, gn);
  }
  return over;
}

// model_pass's whole-table halving, rows first, first + stride, ...; returns
// how many of them are still over a window after the 16 iterations.
__device__ int halve_tables(const Pass& P, int* dual, int* sig, int first, int stride) {
  int over = 0;
  for (long long r = first; r < P.n_dual + P.n_sig; r += stride) {
    if (r < P.n_dual) {
      int4* row = reinterpret_cast<int4*>(dual) + r;
      int4 d = __ldcg(row);
      if (d.x + d.y > P.fast_w || d.z + d.w > P.slow_w) {
        halve_until(d.x, d.y, P.fast_w);
        halve_until(d.z, d.w, P.slow_w);
        *row = d;
        over += int(d.x + d.y > P.fast_w || d.z + d.w > P.slow_w);
      }
    } else {
      int2* row = reinterpret_cast<int2*>(sig) + (r - P.n_dual);
      int2 s = __ldcg(row);
      if (s.x + s.y > P.sig_w) {
        halve_until(s.x, s.y, P.sig_w);
        *row = s;
        over += int(s.x + s.y > P.sig_w);
      }
    }
  }
  return over;
}

// The chain cluster's barrier, for every thread of it that has not exited
// (release / acquire at cluster scope: what its blocks stored before their
// arrival is visible after the wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Warp 8 of a chain block: every barrier of the entry warps (chain_role),
// with nothing between them, so it arrives at a batch's first barrier as
// soon as the one before has passed. In block 0 it first makes sure the
// batch's ring slot is free (the consumers hand slots back; 32 slots a
// poll), and after arriving, while the batch runs, it releases the staged
// batches to the consumers every kPublishEvery batches and polls ahead.
__device__ void control_role(const Pass& P, int* sync, const int2* meta, const int* more,
                             const int* over, int rank, int lane) {
  const int nb = int(P.nb);
  long long fr = P.R < P.nb ? P.R : P.nb;  // batches < fr have a free ring slot
  long long waited = 0;
  auto poll = [&]() {  // batch fr + lane may be staged once batch fr + lane - R is consumed
    const long long q = fr + lane;
    const bool ok = q < P.nb && ld_acquire(sync + 1 + q % P.R) >= int(q - P.R + 1);
    const int ahead = __ffs(int(~__ballot_sync(0xffffffffu, ok))) - 1;  // leading oks
    fr += ahead < 0 ? 32 : ahead;
  };
  bool whole = !P.dict;
  int m3 = 0;
  cluster_arrive();
  for (int b = 0; b < nb; ++b) {
    cluster_wait();  // batch b - 1's rows are stored, in every block
    if (!P.dict && __ldcg(more + m3)) whole = true;
    if (__ldg(meta + b).y != 0) cluster_sync();  // a hazard batch's second barrier
    if (whole) {
      cluster_sync();
      cluster_sync();
      whole = __ldcg(over + m3) != 0;
    }
    if (rank == 0 && fr <= b + 1 && b + 1 < nb) {  // the ring is full: wait for a slot
      const long long t0 = clock64();
      while (fr <= b + 1) poll();
      waited += clock64() - t0;
    }
    cluster_arrive();  // batch b + 1's first barrier, or the last one
    if (rank == 0) {
      if (lane == 0 && b > 0 && b % kPublishEvery == 0) st_release(sync, b);  // batches < b
      if (fr < P.nb && fr - b < P.R / 2) poll();
    }
    m3 = m3 == 2 ? 0 : m3 + 1;
  }
  cluster_wait();
  if (rank == 0 && lane == 0) {
    st_release(sync, nb);
    sync[1 + P.R + kProfRing] = int(waited >> 4);  // units of 16 cycles
  }
}

// Block `rank` of chunk g's chain cluster. Entry u of a batch belongs to
// block u % kCluster, thread (u / kCluster) % kChainThreads. Warp 8 holds no
// entries; it runs the same barriers (control_role), and in block 0 it keeps
// the ring beside them, so that no warp with entries pays for a release fence
// or a poll.
__device__ void chain_role(const Pass& P, long long g, int rank) {
  extern __shared__ __align__(16) unsigned char pass_smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid >= kLiveThreads) return;  // exited threads do not count at cluster barriers
  const bool control = tid >= kChainThreads;
  int4* ring = reinterpret_cast<int4*>(pass_smem);  // [kStages][K][kChainThreads]
  int* sync = P.sync + g * (1 + P.R + kSyncTail);
  int* prof_out = sync + 1 + P.R;
  // more[(b + 1) % 3]: an entry of batch b left a row over its window, so
  // batch b + 1 halves the whole tables again; read at the top of batch
  // b + 1, cleared during batch b + 2, written again during batch b + 3.
  // over[b % 3]: rows over a window after batch b's whole-table halving;
  // cleared during batch b - 1. (Zero at the start.)
  int* more = prof_out + kProf;
  int* over = more + 3;
  long long prof[5] = {0, 0, 0, 0, 0}, t0 = clock64(), t1;
  auto lap = [&](int what) {  // the time since the last lap goes to `what`
    t1 = clock64();
    prof[what] += t1 - t0;
    t0 = t1;
  };
  const bool timed = rank == 0 && tid == 0;
  const int2* meta = P.meta + g * P.nb;
  const int4* ent = P.entries + g * P.nb * P.U + rank;
  int4* stage = P.stage + g * P.R * P.U * 2;
  int* dual = P.dual + g * P.n_dual * 4;
  int* sig = P.sig + g * P.n_sig * 2;
  const int K = P.K, nb = int(P.nb);
  const int stride = kChainThreads * kCluster;  // entries a round of the cluster
  if (control) {
    control_role(P, sync, meta, more, over, rank, lane);
    return;
  }
  for (int j = 0; j < kStages; ++j) {  // the first batches' entries -> ring stage j
    const int n_u = j < nb ? __ldg(meta + j).x : 0;
    for (int k = 0; k < K && (k * kChainThreads + tid) * kCluster + rank < n_u; ++k)
      cp_async_entry(ring + (j * K + k) * kChainThreads + tid,
                     ent + j * P.U + (k * kChainThreads + tid) * kCluster);
    cp_async_commit();
  }
  bool whole = !P.dict;
  int2 cur = __ldg(meta);
  // b % kStages, b % R and b % 3 as counters, and the copies' source as a
  // running pointer: a 64-bit remainder is a hundred instructions on a warp.
  int rs = 0, slot = 0, m3 = 0;
  const int4* src = ent + (long long)kStages * P.U + tid * kCluster;  // batch b + kStages
  for (int b = 0; b < nb; ++b) {
    const int m3n = m3 == 2 ? 0 : m3 + 1, m3p = m3 == 0 ? 2 : m3 - 1;  // (b + 1), (b + 2) % 3
    cluster_sync();  // batch b - 1's rows are stored, in every block
    if (timed) lap(kProfBarrier);
    const int2 next = b + 1 < nb ? __ldg(meta + b + 1) : make_int2(0, 0);
    const int far_n = b + kStages < nb ? __ldg(meta + b + kStages).x : 0;
    const int n_u = cur.x;
    const bool hazard = cur.y != 0;
    if (!P.dict) {
      if (__ldcg(more + m3)) whole = true;
      if (rank == 0 && tid == 0) more[m3p] = over[m3n] = 0;
    }
    bool left_over = false;
    int4* mine = ring + rs * K * kChainThreads + tid;
    int4* st = stage + ((long long)slot * P.U + tid * kCluster + rank) * 2;
    {
      cp_async_wait(kStages - 1);
      if (timed) lap(kProfCopies);
      constexpr int kGroup = 2;  // entries whose loads are in flight together
      for (int k0 = 0; k0 < K && k0 * stride + tid * kCluster + rank < n_u; k0 += kGroup) {
        int4 en[kGroup], d[kGroup];
        int2 s[kGroup];
        bool act[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int k = k0 + q;
          act[q] = k < K && k * stride + tid * kCluster + rank < n_u;
          d[q] = make_int4(0, 0, 0, 0);
          s[q] = make_int2(0, 0);
          if (act[q]) {
            en[q] = mine[k * kChainThreads];
            if (entry_totals(en[q].z).load)
              d[q] = __ldcg(reinterpret_cast<const int4*>(dual) + en[q].x);
            if (entry_totals(en[q].w).load)
              s[q] = __ldcg(reinterpret_cast<const int2*>(sig) + en[q].y);
          }
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (act[q]) {
            int4* o = st + (long long)(k0 + q) * stride * 2;
            o[0] = d[q];
            o[1] = make_int4(s[q].x, s[q].y, 0, 0);
            if (!hazard) left_over |= entry_update(P, dual, sig, en[q], d[q], s[q], whole);
          }
        }
      }
    }
    if (hazard) {  // every load of the batch comes before any of its stores
      cluster_sync();
      for (int k = 0; k < K && k * stride + tid * kCluster + rank < n_u; ++k) {
        const int4* o = st + (long long)k * stride * 2;
        const int4 s = __ldcg(o + 1);
        left_over |= entry_update(P, dual, sig, mine[k * kChainThreads], __ldcg(o),
                                  make_int2(s.x, s.y), whole);
      }
    }
    if (left_over) more[m3n] = 1;
    if (timed) lap(kProfBody);
    for (int k = 0; k < K && k * stride + tid * kCluster + rank < far_n; ++k)
      cp_async_entry(mine + k * kChainThreads, src + (long long)k * stride);
    cp_async_commit();
    src += P.U;
    if (whole) {
      cluster_sync();  // the batch's adds are stored
      const int n = halve_tables(P, dual, sig, rank * kChainThreads + tid, stride);
      if (n) atomicAdd(over + m3, n);
      cluster_sync();
      whole = __ldcg(over + m3) != 0;
    }
    cur = next;
    rs = rs + 1 == kStages ? 0 : rs + 1;
    slot = slot + 1 == int(P.R) ? 0 : slot + 1;
    m3 = m3n;
    if (timed) lap(kProfRest);
  }
  cluster_sync();
  if (timed) {
    lap(kProfBarrier);
    for (int q = kProfBarrier; q <= kProfRest; ++q) prof_out[q] = int(prof[q] >> 4);
  }
}

// A consumer block of chunk g: the probabilities of batches c, c + n, ...
__device__ void consumer_role(const Pass& P, long long g, long long c, long long n) {
  const int tid = threadIdx.x;
  int* sync = P.sync + g * (1 + P.R + kSyncTail);
  const int4* stage = P.stage + g * P.R * P.U * 2;
  long long waited = 0, worked = 0, t0 = clock64(), t1;
  for (long long b = c; b < P.nb; b += n) {
    if (tid == 0) {
      while (ld_acquire(sync) < int(b + 1)) __nanosleep(1000);
      t1 = clock64();
      waited += t1 - t0;
      t0 = t1;
    }
    __syncthreads();
    const int4* st = stage + (b % P.R) * P.U * 2;
    for (long long j = tid; j < P.batch; j += kPassThreads) {
      const long long i = (g * P.nb + b) * P.batch + j;
      const int k = P.kinds[i];
      const int pre = P.pre[i];
      const int ones = pre & 0xffff, zeros = (pre >> 16) - ones;
      const int4* row = st + (long long)clampi(P.bin_e[i], P.U - 1) * 2;
      int4 d = make_int4(0, 0, 0, 0), s = d;
      if (k == 0 || k == 1) d = __ldcg(row);
      else if (k != 3) s = __ldcg(row + 1);
      P.probs[i] = bin_prob(k, P.priors[i], d.x + ones, d.y + zeros, d.z + ones, d.w + zeros,
                            s.x + ones, s.y + zeros, P.alpha_on, P.alpha_off);
    }
    __syncthreads();  // every read of the slot is done
    if (tid == 0) {
      st_release(sync + 1 + b % P.R, int(b + 1));
      t1 = clock64();
      worked += t1 - t0;
      t0 = t1;
    }
  }
  if (tid == 0 && c == 0) {
    sync[1 + P.R + kProfConsumerWait] = int(waited >> 4);
    sync[1 + P.R + kProfConsumerWork] = int(worked >> 4);
  }
}

__global__ void __launch_bounds__(kPassThreads) pass_kernel(Pass P) {
  const long long g = P.g0 + blockIdx.y;
  if (blockIdx.x < kCluster) chain_role(P, g, int(blockIdx.x));
  else consumer_role(P, g, blockIdx.x - kCluster, gridDim.x - kCluster);
}

// Launches of the last model pass call of this thread (copies and clears
// included).
thread_local int g_pass_launches = 0;

int check_launch(int& count) {
  ++count;
  return int(cudaGetLastError());
}

// phases, a sum of: 1 = the pre-pass's ordered walk, 4 = its totals, 2 = the
// chain (each on the outputs of the phases before it, from this or an
// earlier call on the same buffers); 7 = the pass.
int run_pass(Pass P, long long G, const int* dual_in, const int* sig_in, int phases,
             cudaStream_t st) {
  int count = 0, rc = 0;
  g_pass_launches = 0;
  if (P.batch < 1 || P.batch > kMaxPrefixBatch || P.U < 1 || P.U > kMaxPrefixBatch ||
      G > 65535)
    return int(cudaErrorInvalidValue);
  if (P.nb == 0 || G == 0) return 0;
  const long long n = G * P.nb * P.batch;
  if (phases & 1) {
    cudaMemsetAsync(P.meta, 0, size_t(G * P.nb) * sizeof(int2), st);
    if ((rc = check_launch(count))) return rc;
    P.slots_log2 = 6;
    // slots >= batch: a batch of distinct keys fills the table and still ends
    // every probe; real batches repeat keys and leave it half empty. A small
    // table lets more walks share an SM.
    while ((1ll << P.slots_log2) < P.batch) ++P.slots_log2;
    const size_t smem = (size_t(1) << P.slots_log2) * 12;
    cudaFuncSetAttribute(prefix_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(smem));
    prefix_walk_kernel<<<dim3(unsigned(P.nb), unsigned(G)), 32, smem, st>>>(P);
    if ((rc = check_launch(count))) return rc;
  }
  if (phases & 4) {
    if (P.dict) {
      dict_entries_kernel<<<artc::grid_for(P.nb * P.U, 256), 256, 0, st>>>(P);
      if ((rc = check_launch(count))) return rc;
    }
    entry_totals_kernel<<<artc::grid_for(n, 256), 256, 0, st>>>(P, n);
    if ((rc = check_launch(count))) return rc;
  }
  if (phases & 2) {
    cudaMemcpyAsync(P.dual, dual_in, size_t(G * P.n_dual) * 4 * sizeof(int),
                    cudaMemcpyDeviceToDevice, st);
    if ((rc = check_launch(count))) return rc;
    cudaMemcpyAsync(P.sig, sig_in, size_t(G * P.n_sig) * 2 * sizeof(int),
                    cudaMemcpyDeviceToDevice, st);
    if ((rc = check_launch(count))) return rc;
    cudaMemsetAsync(P.sync, 0, size_t(G * (1 + P.R + kSyncTail)) * sizeof(int), st);
    if ((rc = check_launch(count))) return rc;
    const int round = kChainThreads * kCluster;  // entries a round of the chain cluster
    P.K = int((P.U + round - 1) / round);
    const size_t smem = size_t(kStages) * P.K * kChainThreads * sizeof(int4);
    cudaFuncSetAttribute(pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = kCluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * kCluster);
    cfg.blockDim = dim3(kPassThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    int resident = 0;  // clusters the card holds at once
    cudaOccupancyMaxActiveClusters(&resident, pass_kernel, &cfg);
    if ((rc = int(cudaGetLastError()))) return rc;
    if (resident < 2) return int(cudaErrorCooperativeLaunchTooLarge);
    cfg.numAttrs = 2;
    // Every block of a launch must be resident (the consumers wait for the
    // chain and the chain for ring slots): at most resident / 2 chunks a
    // launch, each with its chain cluster and at least one of consumers.
    long long want = (P.nb + kCluster - 1) / kCluster;
    if (want > kMaxConsumerClusters) want = kMaxConsumerClusters;
    for (long long g0 = 0; g0 < G; g0 += resident / 2) {
      const long long gs = G - g0 < resident / 2 ? G - g0 : resident / 2;
      const long long consumers = resident / gs - 1 < want ? resident / gs - 1 : want;
      P.g0 = g0;
      cfg.gridDim = dim3(unsigned(kCluster * (1 + consumers)), unsigned(gs));
      cudaLaunchKernelEx(&cfg, pass_kernel, P);
      if ((rc = check_launch(count))) return rc;
    }
  }
  g_pass_launches = count;
  return 0;
}

Pass common_pass(long long nb, long long batch, long long U, long long n_dual, long long n_sig,
                 long long R, long long fast_w, long long slow_w, long long sig_w,
                 long long alpha_on, long long alpha_off) {
  Pass P{};
  P.nb = nb;
  P.batch = batch;
  P.U = U;
  P.n_dual = n_dual;
  P.n_sig = n_sig;
  P.R = R;
  P.fast_w = int(fast_w);
  P.slow_w = int(slow_w);
  P.sig_w = int(sig_w);
  P.alpha_on = int(alpha_on);
  P.alpha_off = int(alpha_off);
  return P;
}

Model common_model(long long n_dual, long long n_sig, long long batch, long long fast_w,
                   long long slow_w, long long sig_w, long long alpha_on,
                   long long alpha_off) {
  Model M{};
  M.n_dual = n_dual;
  M.n_sig = n_sig;
  M.batch = batch;
  M.fast_w = int(fast_w);
  M.slow_w = int(slow_w);
  M.sig_w = int(sig_w);
  M.alpha_on = int(alpha_on);
  M.alpha_off = int(alpha_off);
  return M;
}

// ------------------------------------------------------ v3_core / model_pass_v2
//
// Both passes are one persistent cooperative kernel, scan_kernel, whatever
// ns and G (launches are split only where G chunks do not fit the card at
// once). A chunk (blockIdx.y) has S stage blocks, which own its U dictionary
// slots (one thread a slot), and P probability blocks; nothing is shared
// between chunks.
//
// Iteration t of a chunk stages super-step t and, side by side, turns the
// staged state of super-step t - 1 into probabilities; then the chunk's
// blocks meet at a barrier (an arrival counter in device memory). Step t's
// stage reads the rows that step t - 1 stored, whose owner may be another
// slot, so one barrier a super-step is the chain; the probabilities are not
// on it. The staged state is double-buffered (step t writes buffer t & 1,
// while the probabilities of t - 1 read the other): ns + 1 iterations and ns
// barriers. A ring of more staged steps with consumers further behind (as
// the per-batch passes below have) would not help: the barrier paces stage
// and probabilities alike, and two buffers already let them overlap.
//
//   - The stage's chain is per slot: sup sub-batches of (store the start
//     state, add the deltas, halve). A slot's deltas do not depend on the
//     chain, so they come from a shared-memory ring kRing sub-batches
//     ahead, and each step first asks L2 for the next step's delta lines
//     (prefetch.global.L2): no sub-batch waits for device memory.
//   - The halving stops at the first iteration that finds the pair within
//     its window; its first two iterations are selects in closed form
//     (halve_fast), so a sub-batch branches only for a pair still over its
//     window after two halvings.
//   - The staged state of a (sub-batch, slot) is one int4 (dual slots,
//     [sup][ud]) or one int2 (sig slots, [sup][us]) in L2-cached stores, so a
//     bin's gather is one load.
//   - The probabilities of a super-step are tiles of kTile bins that the
//     chunk's blocks take from a counter: probability blocks from the start
//     of the iteration, stage blocks once their stage is done, so no block
//     idles while the other role has work. A thread has kUnroll bins in
//     flight, their plane loads first, then the gathers.
//
// The launch is cooperative: every block is resident, so the barrier cannot
// deadlock, and a launch the card cannot hold is returned as an error. The
// grid is sized from the pass (P blocks give each probability thread about
// kBinsPerThread bins a super-step) and from the occupancy query, at most
// half the card beyond the stage blocks, so that mesh cells on one card run
// side by side: a cooperative pass that fills the card waits for every
// other kernel on it, and they for it.
// Table rows and staged state are read past L1 (ld.global.cg): another SM
// wrote them one barrier earlier.

constexpr int kScanThreads = 256;  // threads of a stage or probability block
constexpr int kRing = 16;          // sub-batches whose deltas are copied ahead (a power of 2)
constexpr int kBinsPerThread = 8;  // bins a probability thread takes a super-step
constexpr int kUnroll = 4;         // bins a probability thread has in flight
constexpr int kTile = kUnroll * kScanThreads;  // bins a block takes at a time
constexpr int kSyncStride = 32;    // ints of a chunk's barrier line (128 bytes)
// A chunk's barrier line: the arrival count; cycle counters (clock64, in
// units of 16 cycles) that say what paced the pass: stage block 0's thread 0
// staging, on probability tiles and at the barrier, and the first
// probability block's thread 0 on tiles and at the barrier; then the two
// tile counters.
enum ScanProf { kScanStage = 1, kScanStageWait, kScanProb, kScanProbWait, kScanStageProb,
                kScanProf, kScanNext = 8 };

struct Scan {
  Model M;
  const int *kind, *slot, *prior;  // [G][m]
  const int *pre1, *pret;          // model_pass_v2's prefix counts, or null
  const int *dk_d, *dk_s;          // [G] at chunk strides dkd_stride / dks_stride
  const uint32_t* deltas;          // v3_core: [G][ns * sup][U] (ones | total << 16)
  const int *dd, *ds;              // model_pass_v2: [ns * sup][ud | us][2]
  int *dual, *sig;                 // [G] working tables
  int* cst;                        // [G][2] staged state: [sup][ud] int4, then [sup][us] int2
  int* probs;                      // [G][m]
  int* sync;                       // [G][kSyncStride]
  long long buf_words;             // ints of one staged-state buffer
  long long g0;                    // first chunk of this launch
  int S;                           // stage blocks a chunk
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The 128-byte lines of [lo, hi] into L2.
__device__ __forceinline__ void prefetch_span(const void* lo, const void* hi) {
  for (uintptr_t a = uintptr_t(lo) & ~uintptr_t(127); a <= uintptr_t(hi); a += 128)
    prefetch_l2(reinterpret_cast<const void*>(a));
}

// Where slot r's (ones, total) of sub-batch ts lies.
__device__ __forceinline__ const uint32_t* delta_ptr(const Scan& Q, long long g, long long ts,
                                                     long long r, uint32_t*) {
  return Q.deltas + g * Q.M.delta_stride + ts * Q.M.U + r;
}

__device__ __forceinline__ const int2* delta_ptr(const Scan& Q, long long, long long ts,
                                                 long long r, int2*) {
  const Model& M = Q.M;
  return reinterpret_cast<const int2*>(r < M.ud ? Q.dd + (ts * M.ud + r) * 2
                                                : Q.ds + (ts * M.us + r - M.ud) * 2);
}

__device__ __forceinline__ void unpack(uint32_t w, int& one, int& tot) {
  one = int(w & 0xffffu);
  tot = int(w >> 16);
}

__device__ __forceinline__ void unpack(int2 w, int& one, int& tot) {
  one = w.x;
  tot = w.y;
}

// One word into shared memory, asynchronously (cp.async, 4 or 8 bytes).
__device__ __forceinline__ void cp_async_word(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(uint32_t(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_word(int2* dst, const int2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               ::"r"(uint32_t(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Super-step t's delta lines of this thread's warp into L2: lane l takes the
// sub-batches l, l + 32, ...
template <class Word>
__device__ void prefetch_deltas(const Scan& Q, long long g, long long t, long long r) {
  const Model& M = Q.M;
  const int lane = threadIdx.x & 31;
  const long long r0 = r - lane, r1 = r0 + 31 < M.U - 1 ? r0 + 31 : M.U - 1;
  if (r0 >= M.U) return;
  for (long long s = lane; s < M.sup; s += 32) {
    const long long ts = t * M.sup + s;
    if constexpr (sizeof(Word) == 4) {
      const uint32_t* row = Q.deltas + g * M.delta_stride + ts * M.U;
      prefetch_span(row + r0, row + r1);
    } else {
      if (r0 < M.ud) {
        const int* row = Q.dd + ts * M.ud * 2;
        prefetch_span(row + r0 * 2, row + (r1 < M.ud ? r1 : M.ud - 1) * 2 + 1);
      }
      if (r1 >= M.ud) {
        const int* row = Q.ds + (ts * M.us - M.ud) * 2;  // indexed by slot
        prefetch_span(row + (r0 > M.ud ? r0 : M.ud) * 2, row + r1 * 2 + 1);
      }
    }
  }
}

// Slot r's walk over super-step t's sub-batches: f(ones, total) in order.
// The deltas come through a ring of kRing sub-batches in shared memory that
// each thread fills with its own cp.async copies (one group a sub-batch) and
// reads itself, so the ring needs no barrier, and the chain waits only for
// the copy issued kRing sub-batches earlier. (A ring in registers is undone
// by the compiler: it copies the ring's registers at the top of each
// unrolled block, and the copies wait for the loads just issued.)
template <class Word, class F>
__device__ __forceinline__ void walk_deltas(const Scan& Q, long long g, long long t,
                                            long long r, Word* ring, F&& f) {
  const int sup = int(Q.M.sup);
  Word* mine = ring + threadIdx.x;
  const Word* src = delta_ptr(Q, g, t * Q.M.sup, r, mine);  // sub-batch 0's, then +step
  const long long step = delta_ptr(Q, g, t * Q.M.sup + 1, r, mine) - src;
#pragma unroll
  for (int q = 0; q < kRing; ++q) {
    if (q < sup) cp_async_word(mine + q * kScanThreads, src + q * step);
    cp_async_commit();
  }
  src += kRing * step;
  for (int s = 0; s < sup; ++s) {
    cp_async_wait_n<kRing - 1>();  // sub-batch s's copy has landed
    Word* slot = mine + (s & (kRing - 1)) * kScanThreads;
    const Word cur = *slot;
    if (s + kRing < sup) cp_async_word(slot, src);
    cp_async_commit();
    src += step;
    int one, tot;
    unpack(cur, one, tot);
    f(one, tot);
  }
}

// Super-step t of chunk g for slot r: stage every sub-batch's start state
// into buffer t & 1 and store the final row. The rows of a step are unique
// (sorted-unique keys), so each has one writer.
template <class Word>
__device__ void stage_step(const Scan& Q, long long g, long long t, long long r) {
  __shared__ Word ring[kRing * kScanThreads];
  const Model& M = Q.M;
  if (t + 1 < M.ns) prefetch_deltas<Word>(Q, g, t + 1, r);
  if (r >= M.U) return;
  // The windows and counts in registers: the chain must not wait on them.
  const int fast_w = M.fast_w, slow_w = M.slow_w, sig_w = M.sig_w;
  const int it_f = M.it_f, it_s = M.it_s, it_g = M.it_g;
  int* buf = Q.cst + (g * 2 + (t & 1)) * Q.buf_words;
  if (r < M.ud) {
    int4* out = reinterpret_cast<int4*>(buf) + r;
    int4* row = reinterpret_cast<int4*>(Q.dual + g * M.dual_stride) +
                __ldg(Q.dk_d + g * M.dkd_stride + t * M.ud + r);
    int4 v = __ldcg(row);
    walk_deltas<Word>(Q, g, t, r, ring, [&](int one, int tot) {
      __stcg(out, v);
      out += M.ud;
      v.x += one;
      v.y += tot - one;
      v.z += one;
      v.w += tot - one;
      halve_fast(v.x, v.y, fast_w, it_f);
      halve_fast(v.z, v.w, slow_w, it_s);
    });
    __stcg(row, v);
  } else {
    int2* out = reinterpret_cast<int2*>(buf + M.sup * M.ud * 4) + (r - M.ud);
    int2* row = reinterpret_cast<int2*>(Q.sig + g * M.sig_stride) +
                __ldg(Q.dk_s + g * M.dks_stride + t * M.us + (r - M.ud));
    int2 v = __ldcg(row);
    walk_deltas<Word>(Q, g, t, r, ring, [&](int one, int tot) {
      __stcg(out, v);
      out += M.us;
      v.x += one;
      v.y += tot - one;
      halve_fast(v.x, v.y, sig_w, it_g);
    });
    __stcg(row, v);
  }
}

// Super-step t of chunk g: each bin's probability by kind from its
// sub-batch's staged state at its slot, plus (model_pass_v2) its within-batch
// prefix counts on every column. Columns a slot does not stage read 1, as in
// JAX's (U, 6) layout. The block takes tiles of kTile bins from the chunk's
// counter `next` until none is left: probability blocks from the start of
// the iteration, stage blocks once their stage is done.
__device__ void prob_step(const Scan& Q, long long g, long long t, int* next) {
  __shared__ int tile_s;
  const Model& M = Q.M;
  const long long span = M.sup * M.batch, last = M.sup * M.U - 1;
  const long long base = g * M.plane_stride + t * span;
  const int* buf = Q.cst + (g * 2 + (t & 1)) * Q.buf_words;
  const int4* st_d = reinterpret_cast<const int4*>(buf);
  const int2* st_s = reinterpret_cast<const int2*>(buf + M.sup * M.ud * 4);
  const unsigned batch = unsigned(M.batch);
  const int tiles = int((span + kTile - 1) / kTile);
  for (;;) {
    if (threadIdx.x == 0) tile_s = atomicAdd(next, 1);
    __syncthreads();
    const int tile = tile_s;
    __syncthreads();  // tile_s is read before the next grab
    if (tile >= tiles) return;
    const long long j0 = (long long)tile * kTile + threadIdx.x;
    int k[kUnroll], pr[kUnroll], sl[kUnroll], ones[kUnroll], zeros[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long j = j0 + q * kScanThreads;
      k[q] = 3;
      pr[q] = sl[q] = ones[q] = zeros[q] = 0;
      if (j < span) {
        k[q] = __ldg(Q.kind + base + j);
        pr[q] = __ldg(Q.prior + base + j);
        sl[q] = __ldg(Q.slot + base + j);
        if (Q.pre1 != nullptr) {
          ones[q] = __ldg(Q.pre1 + base + j);
          zeros[q] = __ldg(Q.pret + base + j) - ones[q];
        }
      }
    }
    int4 d[kUnroll];
    int2 s[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      d[q] = make_int4(1, 1, 1, 1);
      s[q] = make_int2(1, 1);
      if (k[q] != 3) {
        // A JAX gather clamps an out-of-range row; slots are < U by
        // construction, so the clamp only mirrors that.
        const unsigned j = unsigned(j0 + q * kScanThreads);
        long long flat = (long long)(j / batch) * M.U + sl[q];
        flat = flat < 0 ? 0 : (flat > last ? last : flat);
        const long long sub = sl[q] >= 0 && sl[q] < M.U ? j / batch : flat / M.U;
        const long long r = flat - sub * M.U;
        if (r < M.ud) d[q] = __ldcg(st_d + sub * M.ud + r);
        else s[q] = __ldcg(st_s + sub * M.us + (r - M.ud));
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long j = j0 + q * kScanThreads;
      if (j < span) {
        const int a = ones[q], b = zeros[q];
        Q.probs[base + j] = bin_prob(k[q], pr[q], d[q].x + a, d[q].y + b, d[q].z + a,
                                     d[q].w + b, s[q].x + a, s[q].y + b, M.alpha_on,
                                     M.alpha_off);
      }
    }
  }
}

// The blocks of one chunk meet: what each stored before its arrival is
// visible to all after it. `count` only grows; the b-th barrier waits for b
// arrivals of every block.
__device__ __forceinline__ void chunk_barrier(int* count, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1);
    while (ld_acquire(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <class Word>
__global__ void __launch_bounds__(kScanThreads) scan_kernel(Scan Q) {
  const long long g = Q.g0 + blockIdx.y;
  const long long ns = Q.M.ns;
  int* sync = Q.sync + g * kSyncStride;
  const int nblk = int(gridDim.x);
  const bool stage = int(blockIdx.x) < Q.S;
  const long long r = (long long)blockIdx.x * kScanThreads + threadIdx.x;  // stage: its slot
  const bool timed = threadIdx.x == 0 && (blockIdx.x == 0 || int(blockIdx.x) == Q.S);
  long long prof[kScanProf] = {}, t0 = clock64(), t1;
  auto lap = [&](int what) {
    if (timed) {
      t1 = clock64();
      prof[what] += t1 - t0;
      t0 = t1;
    }
  };
  if (stage) prefetch_deltas<Word>(Q, g, 0, r);
  for (long long t = 0; t <= ns; ++t) {
    // Iteration t takes super-step t - 1's tiles from counter (t - 1) & 1;
    // the other one, last used in iteration t - 1, is cleared for t + 1.
    if (blockIdx.x == 0 && threadIdx.x == 0) sync[kScanNext + (t & 1)] = 0;
    if (stage && t < ns) {
      stage_step<Word>(Q, g, t, r);
      lap(kScanStage);
    }
    if (t > 0) prob_step(Q, g, t - 1, sync + kScanNext + ((t - 1) & 1));
    lap(stage ? kScanStageProb : kScanProb);
    if (t < ns) chunk_barrier(sync, int(t + 1) * nblk);
    lap(stage ? kScanStageWait : kScanProbWait);
  }
  if (timed)
    for (int q = 1; q < kScanProf; ++q)
      if (stage == (q == kScanStage || q == kScanStageProb || q == kScanStageWait))
        sync[q] = int(prof[q] >> 4);
}

// Launches the pass over G chunks: clears their barrier lines, then one
// cooperative launch, or more where the card cannot hold every chunk's
// stage blocks and one probability block each at once.
template <class Word>
int run_scan(Scan Q, long long G, int& count, cudaStream_t st) {
  const Model& M = Q.M;
  const long long span = M.sup * M.batch;
  Q.S = int((M.U + kScanThreads - 1) / kScanThreads);
  int dev = 0, sms = 0, per_sm = 0, rc = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<Word>, kScanThreads, 0);
  if ((rc = int(cudaGetLastError()))) return rc;
  const long long resident = (long long)sms * per_sm;  // blocks the card holds at once
  if (resident < Q.S + 1) return int(cudaErrorCooperativeLaunchTooLarge);
  long long want = (span + kScanThreads * kBinsPerThread - 1) / (kScanThreads * kBinsPerThread);
  if (want < 1) want = 1;
  const long long per_launch = resident / (Q.S + 1);  // chunks a launch
  cudaMemsetAsync(Q.sync, 0, size_t(G * kSyncStride) * sizeof(int), st);
  if ((rc = check_launch(count))) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  for (long long g0 = 0; g0 < G; g0 += per_launch) {
    const long long gs = G - g0 < per_launch ? G - g0 : per_launch;
    // Probability blocks up to half the card, so that a mesh cell's pass
    // leaves room beside it for its neighbours' kernels (the stage blocks
    // take tiles too once their stage is done); at least one a chunk.
    long long P = resident / (2 * gs) - Q.S < want ? resident / (2 * gs) - Q.S : want;
    if (P < 1) P = 1;
    Q.g0 = g0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unsigned(Q.S + P), unsigned(gs));
    cfg.blockDim = dim3(kScanThreads);
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, scan_kernel<Word>, Q);
    if ((rc = check_launch(count))) return rc;
  }
  return 0;
}

// Ints of one staged-state buffer: [sup][ud] int4, then [sup][us] int2 padded
// to 16 bytes.
long long scan_buf_words(const Model& M) {
  return M.sup * M.ud * 4 + ((M.sup * M.us * 2 + 3) & ~3ll);
}

}  // namespace

// Launches of the last artc_dual0_expand call of this thread.
thread_local int g_dual0_launches = 0;

ARTC_API int artc_dual0_launches(void) { return g_dual0_launches; }

ARTC_API int artc_dual0_expand(const void* rows, const void* idx, const void* esc_idx,
                               const void* esc_val, int* out, long long n_rows,
                               long long n_dual, long long ne, void* stream) {
  g_dual0_launches = 0;
  if (n_dual <= 0) return int(cudaGetLastError());
  if (n_rows < 1) return int(cudaErrorInvalidValue);
  dual0_expand_kernel<<<artc::grid_for(n_dual, kDual0Rows), kDual0Threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(rows), static_cast<const uint8_t*>(idx),
      static_cast<const uint32_t*>(esc_idx), static_cast<const uint2*>(esc_val),
      static_cast<int4*>(static_cast<void*>(out)), int(n_rows < kDual0Dict ? n_rows : kDual0Dict),
      n_dual, ne);
  return check_launch(g_dual0_launches);
}

// artc_dual0_expand's arguments and grid, launching the empty kernel.
ARTC_API int artc_launch_floor(const void*, const void*, const void*, const void*, int*,
                               long long, long long n_dual, long long, void* stream) {
  if (n_dual <= 0) return int(cudaGetLastError());
  launch_floor_kernel<<<artc::grid_for(n_dual, kDual0Rows), kDual0Threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

// G chunks of one shape: kind/slot/prior/probs [G][m], dk_d/dk_s [G] rows at
// chunk strides dkd_stride/dks_stride (ints: views into the chunks' blobs),
// deltas [G][ns*sup][U], dual0 [G][n_dual][4], sig0_idx/val [G][k_sig0](x2).
// Scratch per chunk: dual, sig (tables), cst (cst_words ints: two staged-state
// buffers) and sync (kSyncStride ints: the barrier line and its counters).
ARTC_API int artc_model_pass_v4(const int* kind, const int* slot, const int* prior,
                                const int* dk_d, const int* dk_s, const int* deltas,
                                const int* dual0, const int* sig0_idx,
                                const uint16_t* sig0_val,
                                int* dual, int* sig, int* cst, int* sync, int* probs,
                                long long G, long long dkd_stride, long long dks_stride,
                                long long k_sig0, long long n_dual, long long n_sig,
                                long long ns, long long sup, long long batch, long long ud,
                                long long us, long long fast_w, long long slow_w,
                                long long sig_w, long long it_f, long long it_s, long long it_g,
                                long long alpha_on, long long alpha_off, long long cst_words,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int count = 0, rc = 0;
  g_pass_launches = 0;
  Model M = common_model(n_dual, n_sig, batch, fast_w, slow_w, sig_w, alpha_on, alpha_off);
  M.ns = ns;
  M.sup = sup;
  M.ud = ud;
  M.us = us;
  M.U = ud + us;
  M.it_f = int(it_f);
  M.it_s = int(it_s);
  M.it_g = int(it_g);
  M.plane_stride = ns * sup * batch;
  M.dkd_stride = dkd_stride;
  M.dks_stride = dks_stride;
  M.delta_stride = ns * sup * M.U;
  M.dual_stride = (n_dual + 1 + ud) * 4;
  M.sig_stride = (n_sig + us) * 2;
  Scan Q{};
  Q.buf_words = scan_buf_words(M);
  if (cst_words < 2 * Q.buf_words || sup * batch >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  if (G <= 0 || ns <= 0) return int(cudaGetLastError());
  const long long init = M.dual_stride > M.sig_stride ? M.dual_stride : M.sig_stride;
  tables_init_kernel<<<dim3(artc::grid_for(init, 256), unsigned(G)), 256, 0, st>>>(dual0, dual,
                                                                                   sig, M);
  if ((rc = check_launch(count))) return rc;
  if (k_sig0 > 0) {
    sig0_scatter_kernel<<<dim3(artc::grid_for(k_sig0, 256), unsigned(G)), 256, 0, st>>>(
        sig0_idx, sig0_val, sig, k_sig0, n_sig, M.sig_stride);
    if ((rc = check_launch(count))) return rc;
  }
  Q.M = M;
  Q.kind = kind;
  Q.slot = slot;
  Q.prior = prior;
  Q.dk_d = dk_d;
  Q.dk_s = dk_s;
  Q.deltas = reinterpret_cast<const uint32_t*>(deltas);
  Q.dual = dual;
  Q.sig = sig;
  Q.cst = cst;
  Q.sync = sync;
  Q.probs = probs;
  if ((rc = run_scan<uint32_t>(Q, G, count, st))) return rc;
  g_pass_launches = count;
  return 0;
}

// dual_in int32[n_dual_rows, 4] and sig_in [n_sig_rows, 2] are the extended
// start tables (model_pass_v2's dual0 / sig0); they are copied into the
// working tables dual / sig, and the inputs stay unchanged. cst and sync as
// for artc_model_pass_v4 (one chunk).
ARTC_API int artc_model_pass_v2(const int* kind, const int* prior, const int* pre1,
                                const int* pret, const int* bin_u, const int* dk_d,
                                const int* dk_s, const int* dd, const int* ds,
                                const int* dual_in, const int* sig_in, int* dual, int* sig,
                                int* cst, int* sync, int* probs, long long n_dual_rows,
                                long long n_sig_rows, long long ns, long long sup,
                                long long batch, long long ud, long long us, long long fast_w,
                                long long slow_w, long long sig_w, long long it_f,
                                long long it_s, long long it_g, long long alpha_on,
                                long long alpha_off, long long cst_words, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int count = 0, rc = 0;
  g_pass_launches = 0;
  Model M = common_model(n_dual_rows, n_sig_rows, batch, fast_w, slow_w, sig_w, alpha_on,
                         alpha_off);
  M.ns = ns;
  M.sup = sup;
  M.ud = ud;
  M.us = us;
  M.U = ud + us;
  M.it_f = int(it_f);
  M.it_s = int(it_s);
  M.it_g = int(it_g);
  Scan Q{};
  Q.buf_words = scan_buf_words(M);
  if (cst_words < 2 * Q.buf_words || sup * batch >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  if (ns <= 0) return int(cudaGetLastError());
  cudaMemcpyAsync(dual, dual_in, size_t(n_dual_rows) * 4 * sizeof(int),
                  cudaMemcpyDeviceToDevice, st);
  if ((rc = check_launch(count))) return rc;
  cudaMemcpyAsync(sig, sig_in, size_t(n_sig_rows) * 2 * sizeof(int), cudaMemcpyDeviceToDevice,
                  st);
  if ((rc = check_launch(count))) return rc;
  Q.M = M;
  Q.kind = kind;
  Q.slot = bin_u;
  Q.prior = prior;
  Q.pre1 = pre1;
  Q.pret = pret;
  Q.dk_d = dk_d;
  Q.dk_s = dk_s;
  Q.dd = dd;
  Q.ds = ds;
  Q.dual = dual;
  Q.sig = sig;
  Q.cst = cst;
  Q.sync = sync;
  Q.probs = probs;
  if ((rc = run_scan<int2>(Q, 1, count, st))) return rc;
  g_pass_launches = count;
  return 0;
}

// bits/kinds/priors/bin_u int32[nb, batch], dict_keys [nb, U], dual_in
// [n_dual, 4] and sig_in [n_sig, 2] (both ending in their scratch row).
// Scratch: dual, sig (working tables), pre [nb * batch], entries [nb * U * 4],
// meta [nb * 2], stage [R * U * 8], sync [1 + R + 14]. phases: see run_pass.
ARTC_API int artc_model_pass_dict(const int* bits, const int* kinds, const int* priors,
                                  const int* bin_u, const int* dict_keys, const int* dual_in,
                                  const int* sig_in, int* dual, int* sig, int* pre,
                                  int* entries, int* meta, int* stage, int* sync, int* probs,
                                  long long nb, long long batch, long long U, long long n_dual,
                                  long long n_sig, long long R, long long fast_w,
                                  long long slow_w, long long sig_w, long long alpha_on,
                                  long long alpha_off, long long phases, void* stream) {
  Pass P = common_pass(nb, batch, U, n_dual, n_sig, R, fast_w, slow_w, sig_w, alpha_on,
                       alpha_off);
  P.bits = bits;
  P.kinds = kinds;
  P.priors = priors;
  P.keys = bin_u;
  P.bin_e = bin_u;
  P.dict_keys = dict_keys;
  P.dict = 1;
  P.dual = dual;
  P.sig = sig;
  P.pre = pre;
  P.entries = reinterpret_cast<int4*>(entries);
  P.meta = reinterpret_cast<int2*>(meta);
  P.stage = reinterpret_cast<int4*>(stage);
  P.sync = sync;
  P.probs = probs;
  return run_pass(P, 1, dual_in, sig_in, int(phases), static_cast<cudaStream_t>(stream));
}

// G chunks of one shape: bits/kinds/keys/priors int32[G][nb * batch], dual_in
// [G][n_dual, 4] (ending in the scratch row), sig_in [G][n_sig, 2]. Scratch
// per chunk: dual, sig, pre and bin_e [nb * batch], entries [nb * batch * 4],
// meta [nb * 2], stage [R * batch * 8], sync [1 + R + 14]. phases as above.
ARTC_API int artc_model_pass(const int* bits, const int* kinds, const int* keys,
                             const int* priors, const int* dual_in, const int* sig_in,
                             int* dual, int* sig, int* pre, int* bin_e, int* entries,
                             int* meta, int* stage, int* sync, int* probs, long long G,
                             long long nb, long long batch, long long n_dual, long long n_sig,
                             long long R, long long fast_w, long long slow_w, long long sig_w,
                             long long alpha_on, long long alpha_off, long long phases,
                             void* stream) {
  Pass P = common_pass(nb, batch, batch, n_dual, n_sig, R, fast_w, slow_w, sig_w, alpha_on,
                       alpha_off);
  P.bits = bits;
  P.kinds = kinds;
  P.priors = priors;
  P.keys = keys;
  P.bin_e = bin_e;
  P.bin_e_out = bin_e;
  P.dual = dual;
  P.sig = sig;
  P.pre = pre;
  P.entries = reinterpret_cast<int4*>(entries);
  P.meta = reinterpret_cast<int2*>(meta);
  P.stage = reinterpret_cast<int4*>(stage);
  P.sync = sync;
  P.probs = probs;
  return run_pass(P, G, dual_in, sig_in, int(phases), static_cast<cudaStream_t>(stream));
}

// Device-side launches (kernels, copies, clears) the calling thread's last
// model pass call made (v3_core, model_pass_v2, model_pass_dict, model_pass).
ARTC_API int artc_pass_launches(void) { return g_pass_launches; }
