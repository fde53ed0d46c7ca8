// The adaptive-model probability passes and their table set-up.
//
// Replaces, in avrecode_tpu/ops/model_pass.py:
//   - model_pass_v4 -> v3_core (profile 2, frozen batches), with its table
//     set-up (dual0 widened with ones scratch rows, sig0 zeros + warm-row
//     scatter) and dual0_expand;
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
// v3_core and model_pass_v2 run two launches per super-step. v3_core takes a
// leading chunk axis (the mesh's vmap over a device's chunks, written out):
// chunk g is blockIdx.y of both launches and owns its planes, key tables,
// deltas, start tables and staging scratch, so G chunks of one shape cost
// 2 x ns launches, not 2 x ns x G; a single chunk is G = 1. The stage
// kernel runs one thread per dictionary slot r < U: it loads its table row,
// walks the sup sub-batches in order (record the start state, add the
// deltas, halve per window with the bounded count of _halve_iters) and
// stores the row back; the rows of a step are unique (sorted-unique keys),
// so this is race-free. The staged state is kept as [sup][4][U] int32, so
// the stage stores coalesce across slots; the constant ones columns of the
// JAX (U, 6) layout are not stored (dual slots read sig columns as 1 and vice
// versa). The probability kernel runs one thread per bin. The two passes
// differ only in where the deltas come from (one packed u32 per slot, or
// separate dual and sig (ones, total) planes) and in v2's per-bin prefix
// adders.
//
// model_pass_dict and model_pass share one precompute launch over every
// batch at once: the within-batch per-key exclusive prefix counts depend only
// on (key, bit), not on the tables, so they leave the serial chain. One
// block per batch holds the batch's packed (key << 1 | bit) words in shared
// memory and each thread counts the earlier equal keys of its bins: the
// masked key-equality product of the "mm" formulation, which equals the
// sort-based segmented prefix of "sort". The one-hot products of the TPU's
// dict pass are gathers here. The serial part per batch is then:
//   - dict: probabilities from the gathered dict rows, then one thread per
//     dict entry updates and halves its row (16 iterations, _halve_while's
//     default). Padding entries duplicate the scratch key and every entry
//     aliases the other table's scratch row; a live row has exactly one
//     writer, and scratch rows are never written (they only feed padding and
//     kind-3 bins, whose probabilities do not read them or are trimmed), so
//     no write races at all and the pass is deterministic;
//   - sort/mm: probabilities, integer atomic adds of every bin's counts into
//     its row (duplicate keys; addition commutes, so the result is exact),
//     then the halving of the whole dual and sig tables (16 iterations), as
//     JAX does it.
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
  long long plane_stride, dkd_stride, dks_stride, delta_stride, dual_stride, sig_stride,
      cst_stride;
  int fast_w, slow_w, sig_w, it_f, it_s, it_g, alpha_on, alpha_off;
};

__device__ inline int clamp_prob(int p) {
  return p < 1 ? 1 : (p > artc::kProbScale - 1 ? artc::kProbScale - 1 : p);
}

// floor(num / den) for num >= 0. A zero denominator only occurs in a branch
// whose bin kind discards it; it is read as 1, as the plain version does.
__device__ inline int div_floor(int num, int den) { return num / (den > 0 ? den : 1); }

// while (p + n > window) { p = (p+1)>>1; n = (n+1)>>1; }, bounded as in JAX.
__device__ inline void halve(int& p, int& n, int window, int iters) {
  for (int k = 0; k < iters; ++k) {
    if (p + n > window) {
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

__global__ void dual0_gather_kernel(const int* __restrict__ rows, const int* __restrict__ idx,
                                    int* __restrict__ out, long long n_rows, long long n_dual) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_dual) return;
  long long r = idx[i];
  r = r < 0 ? 0 : (r > n_rows - 1 ? n_rows - 1 : r);
#pragma unroll
  for (int c = 0; c < 4; ++c) out[i * 4 + c] = rows[r * 4 + c];
}

__global__ void dual0_escape_kernel(const int* __restrict__ esc_idx,
                                    const int* __restrict__ esc_val, int* __restrict__ out,
                                    long long n_dual, long long ne) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  const long long k = (long long)(uint32_t)esc_idx[e];
  if (k >= n_dual) return;  // padding drops
#pragma unroll
  for (int c = 0; c < 4; ++c) out[k * 4 + c] = esc_val[e * 4 + c];
}

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

// Sparse warm sig rows (v16 warm-started chunks), k per chunk blockIdx.y; pad
// rows (>= n_sig) drop.
__global__ void sig0_scatter_kernel(const int* __restrict__ idx, const int* __restrict__ val,
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

// Update deltas of v3_core: one u32 (ones | total << 16) per (sub-batch, slot).
struct PackedDeltas {
  const int* d;  // [G][ns * sup][U]
  __device__ void get(const Model& M, long long g, long long t, long long s, long long r,
                      int& one, int& tot) const {
    const uint32_t v = uint32_t(d[g * M.delta_stride + (t * M.sup + s) * M.U + r]);
    one = int(v & 0xffffu);
    tot = int(v >> 16);
  }
};

// Update deltas of model_pass_v2 (one chunk, g = 0): dd int32[ns, sup, ud, 2],
// ds [ns, sup, us, 2].
struct SplitDeltas {
  const int* dd;
  const int* ds;
  __device__ void get(const Model& M, long long, long long t, long long s, long long r,
                      int& one, int& tot) const {
    const int* p = r < M.ud ? dd + ((t * M.sup + s) * M.ud + r) * 2
                            : ds + ((t * M.sup + s) * M.us + (r - M.ud)) * 2;
    one = p[0];
    tot = p[1];
  }
};

// Super-step t of chunk blockIdx.y, one thread per dictionary slot r: stage
// every sub-batch's start state into cst[s][c][r] and write the final row back.
template <class Deltas>
__global__ void stage_kernel(const int* __restrict__ dk_d, const int* __restrict__ dk_s,
                             Deltas D, int* __restrict__ dual, int* __restrict__ sig,
                             int* __restrict__ cst, Model M, long long t) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M.U) return;
  const long long g = blockIdx.y;
  dk_d += g * M.dkd_stride;
  dk_s += g * M.dks_stride;
  dual += g * M.dual_stride;
  sig += g * M.sig_stride;
  cst += g * M.cst_stride;
  int* out = cst + r;  // column c of sub-batch s at out[(4s + c) U]
  const long long U = M.U;
  int one, tot;
  if (r < M.ud) {
    int* row = dual + (long long)dk_d[t * M.ud + r] * 4;
    int fp = row[0], fn = row[1], sp = row[2], sn = row[3];
    for (long long s = 0; s < M.sup; ++s) {
      int* o = out + s * 4 * U;
      o[0] = fp;
      o[U] = fn;
      o[2 * U] = sp;
      o[3 * U] = sn;
      D.get(M, g, t, s, r, one, tot);
      fp += one;
      fn += tot - one;
      sp += one;
      sn += tot - one;
      halve(fp, fn, M.fast_w, M.it_f);
      halve(sp, sn, M.slow_w, M.it_s);
    }
    row[0] = fp;
    row[1] = fn;
    row[2] = sp;
    row[3] = sn;
  } else {
    int* row = sig + (long long)dk_s[t * M.us + (r - M.ud)] * 2;
    int gp = row[0], gn = row[1];
    for (long long s = 0; s < M.sup; ++s) {
      int* o = out + s * 4 * U;
      o[0] = gp;
      o[U] = gn;
      D.get(M, g, t, s, r, one, tot);
      gp += one;
      gn += tot - one;
      halve(gp, gn, M.sig_w, M.it_g);
    }
    row[0] = gp;
    row[1] = gn;
  }
}

// Super-step t of chunk blockIdx.y, one thread per bin: probability by kind
// from the bin's sub-batch's staged state at its slot, plus (model_pass_v2
// only, pre1 != nullptr) the bin's within-batch prefix counts on every column.
__global__ void scan_prob_kernel(const int* __restrict__ kind, const int* __restrict__ slot,
                                 const int* __restrict__ prior, const int* __restrict__ pre1,
                                 const int* __restrict__ pret, const int* __restrict__ cst,
                                 int* __restrict__ probs, Model M, long long t) {
  const long long span = M.sup * M.batch;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= span) return;
  const long long i = blockIdx.y * M.plane_stride + t * span + j;
  cst += blockIdx.y * M.cst_stride;
  const int k = kind[i];
  int c[6] = {1, 1, 1, 1, 1, 1};
  if (k != 3) {
    // A JAX gather clamps an out-of-range row; slots are < U by
    // construction, so the clamp only mirrors that.
    long long flat = (j / M.batch) * M.U + slot[i];
    flat = flat < 0 ? 0 : (flat > M.sup * M.U - 1 ? M.sup * M.U - 1 : flat);
    const long long s = flat / M.U, sl = flat - s * M.U;
    const int* o = cst + s * 4 * M.U + sl;
    const int base = sl < M.ud ? 0 : 4;
    c[base] = o[0];
    c[base + 1] = o[M.U];
    if (base == 0) {
      c[2] = o[2 * M.U];
      c[3] = o[3 * M.U];
    }
    if (pre1 != nullptr) {
      const int ones = pre1[i], zeros = pret[i] - pre1[i];
#pragma unroll
      for (int q = 0; q < 6; q += 2) {
        c[q] += ones;
        c[q + 1] += zeros;
      }
    }
  }
  probs[i] = bin_prob(k, prior[i], c[0], c[1], c[2], c[3], c[4], c[5], M.alpha_on,
                      M.alpha_off);
}

template <class Deltas>
void launch_scan(const int* kind, const int* slot, const int* prior, const int* pre1,
                 const int* pret, const int* dk_d, const int* dk_s, Deltas D, int* dual,
                 int* sig, int* cst, int* probs, const Model& M, long long G,
                 cudaStream_t st) {
  const dim3 stage_grid(artc::grid_for(M.U, 128), unsigned(G));
  const dim3 prob_grid(artc::grid_for(M.sup * M.batch, 256), unsigned(G));
  for (long long t = 0; t < M.ns; ++t) {
    stage_kernel<<<stage_grid, 128, 0, st>>>(dk_d, dk_s, D, dual, sig, cst, M, t);
    scan_prob_kernel<<<prob_grid, 256, 0, st>>>(kind, slot, prior, pre1, pret, cst, probs, M,
                                                t);
  }
}

// ------------------------------------------------- model_pass_dict / model_pass

// Largest batch the prefix kernel's shared memory holds (48 KB of int32).
constexpr long long kMaxPrefixBatch = 12288;

// One block per batch b: pre1[i] = #{j < i in the batch : key_j == key_i,
// bit_j == 1}, pret[i] = #{j < i : key_j == key_i}. With mode 0 the key is
// bin_u (dict); with mode 1 it is model_pass's unified key (kind 3 -> the
// dual scratch row n_dual - 1, kind 2 -> key + n_dual).
__global__ void prefix_kernel(const int* __restrict__ bits, const int* __restrict__ kinds,
                              const int* __restrict__ keys, int* __restrict__ pre1,
                              int* __restrict__ pret, long long batch, long long n_dual,
                              int mode) {
  extern __shared__ uint32_t packed[];  // key << 1 | bit, per bin of the batch
  const long long base = (long long)blockIdx.x * batch;
  for (long long j = threadIdx.x; j < batch; j += blockDim.x) {
    uint32_t key = uint32_t(keys[base + j]);
    if (mode == 1) {
      const int k = kinds[base + j];
      if (k == 3) key = uint32_t(n_dual - 1);
      else if (k == 2) key += uint32_t(n_dual);
    }
    packed[j] = (key << 1) | uint32_t(bits[base + j] & 1);
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < batch; i += blockDim.x) {
    const uint32_t key = packed[i] >> 1;
    int ones = 0, tot = 0;
    for (long long j = 0; j < i; ++j) {
      const uint32_t v = packed[j];
      if ((v >> 1) == key) {
        ++tot;
        ones += int(v & 1u);
      }
    }
    pre1[base + i] = ones;
    pret[base + i] = tot;
  }
}

// dict: per-(batch, entry) update totals (d_ones, d_tot, s_ones, s_tot),
// masked by kind as in JAX (kind 3 updates nothing, kind 2 only sig).
__global__ void dict_totals_kernel(const int* __restrict__ bits, const int* __restrict__ kinds,
                                   const int* __restrict__ bin_u, int* __restrict__ tot,
                                   long long n, long long batch, long long U) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = kinds[i];
  if (k == 3) return;
  long long u = bin_u[i];
  u = u < 0 ? 0 : (u > U - 1 ? U - 1 : u);
  int* row = tot + ((i / batch) * U + u) * 4 + (k == 2 ? 2 : 0);
  atomicAdd(row, bits[i]);
  atomicAdd(row + 1, 1);
}

struct DictRows {
  long long drow, srow;
};

// The table rows of dict entry dk: a dual key reads its dual row and the sig
// scratch row, a sig key (>= n_dual) its sig row and the dual scratch row.
__device__ inline DictRows dict_rows(long long dk, long long n_dual, long long n_sig) {
  const bool is_sig = dk >= n_dual;
  long long d = is_sig ? n_dual - 1 : dk, s = is_sig ? dk - n_dual : n_sig - 1;
  d = d < 0 ? 0 : (d > n_dual - 1 ? n_dual - 1 : d);
  s = s < 0 ? 0 : (s > n_sig - 1 ? n_sig - 1 : s);
  return {d, s};
}

// dict batch b, one thread per bin: start-of-batch row of its entry plus the
// prefix counts.
__global__ void dict_prob_kernel(const int* __restrict__ kinds, const int* __restrict__ priors,
                                 const int* __restrict__ bin_u,
                                 const int* __restrict__ dict_keys,
                                 const int* __restrict__ pre1, const int* __restrict__ pret,
                                 const int* __restrict__ dual, const int* __restrict__ sig,
                                 int* __restrict__ probs, Model M, long long b) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M.batch) return;
  const long long i = b * M.batch + j;
  long long u = bin_u[i];
  u = u < 0 ? 0 : (u > M.U - 1 ? M.U - 1 : u);
  const DictRows r = dict_rows(dict_keys[b * M.U + u], M.n_dual, M.n_sig);
  const int* d = dual + r.drow * 4;
  const int* s = sig + r.srow * 2;
  const int ones = pre1[i], zeros = pret[i] - pre1[i];
  probs[i] = bin_prob(kinds[i], priors[i], d[0] + ones, d[1] + zeros, d[2] + ones,
                      d[3] + zeros, s[0] + ones, s[1] + zeros, M.alpha_on, M.alpha_off);
}

// dict batch b, one thread per entry u: add the batch's totals to its live
// row and halve it. Scratch rows are never written (see the file comment).
__global__ void dict_update_kernel(const int* __restrict__ dict_keys,
                                   const int* __restrict__ tot, int* __restrict__ dual,
                                   int* __restrict__ sig, Model M, long long b) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= M.U) return;
  const DictRows r = dict_rows(dict_keys[b * M.U + u], M.n_dual, M.n_sig);
  const int* t = tot + (b * M.U + u) * 4;
  if (r.drow != M.n_dual - 1) {
    int* d = dual + r.drow * 4;
    int fp = d[0] + t[0], fn = d[1] + (t[1] - t[0]);
    int sp = d[2] + t[0], sn = d[3] + (t[1] - t[0]);
    halve(fp, fn, M.fast_w, kHalveDefault);
    halve(sp, sn, M.slow_w, kHalveDefault);
    d[0] = fp;
    d[1] = fn;
    d[2] = sp;
    d[3] = sn;
  }
  if (r.srow != M.n_sig - 1) {
    int* s = sig + r.srow * 2;
    int gp = s[0] + t[2], gn = s[1] + (t[3] - t[2]);
    halve(gp, gn, M.sig_w, kHalveDefault);
    s[0] = gp;
    s[1] = gn;
  }
}

// model_pass: a bin's dual row (the scratch row for sig bins and, through
// the kind-3 retarget, for kind-3 bins) and sig row (row 0 for non-sig
// bins). The gathers clamp, as JAX's do; the adds drop out-of-range rows.
struct SortRows {
  long long dkey, skey;
};

__device__ inline SortRows sort_rows(int kind, long long key, long long n_dual) {
  if (kind == 3) key = n_dual - 1;
  return {kind == 2 ? n_dual - 1 : key, kind == 2 ? key : 0};
}

__device__ inline long long clamp_row(long long r, long long n) {
  return r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
}

// model_pass batch b, one thread per bin: probability from the tables as of
// the batch start plus the prefix counts.
__global__ void sort_prob_kernel(const int* __restrict__ kinds, const int* __restrict__ keys,
                                 const int* __restrict__ priors, const int* __restrict__ pre1,
                                 const int* __restrict__ pret, const int* __restrict__ dual,
                                 const int* __restrict__ sig, int* __restrict__ probs, Model M,
                                 long long b) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M.batch) return;
  const long long i = b * M.batch + j;
  const int k = kinds[i];
  const SortRows r = sort_rows(k, keys[i], M.n_dual);
  const int* d = dual + clamp_row(r.dkey, M.n_dual) * 4;
  const int* s = sig + clamp_row(r.skey, M.n_sig) * 2;
  const int ones = pre1[i], zeros = pret[i] - pre1[i];
  probs[i] = bin_prob(k, priors[i], d[0] + ones, d[1] + zeros, d[2] + ones, d[3] + zeros,
                      s[0] + ones, s[1] + zeros, M.alpha_on, M.alpha_off);
}

// model_pass batch b, one thread per bin: scatter-add of its count.
__global__ void sort_add_kernel(const int* __restrict__ bits, const int* __restrict__ kinds,
                                const int* __restrict__ keys, int* __restrict__ dual,
                                int* __restrict__ sig, Model M, long long b) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M.batch) return;
  const long long i = b * M.batch + j;
  const int k = kinds[i];
  if (k == 3) return;  // kind 3 adds zeros
  const SortRows r = sort_rows(k, keys[i], M.n_dual);
  const int one = bits[i], zero = 1 - bits[i];
  if (k == 2) {
    if (r.skey < 0 || r.skey >= M.n_sig) return;
    int* s = sig + r.skey * 2;
    if (one) atomicAdd(s, one);
    if (zero) atomicAdd(s + 1, zero);
  } else {
    if (r.dkey < 0 || r.dkey >= M.n_dual) return;
    int* d = dual + r.dkey * 4;
    if (one) {
      atomicAdd(d, one);
      atomicAdd(d + 2, one);
    }
    if (zero) {
      atomicAdd(d + 1, zero);
      atomicAdd(d + 3, zero);
    }
  }
}

// model_pass, after each batch's adds: halve every row of both tables.
__global__ void halve_tables_kernel(int* __restrict__ dual, int* __restrict__ sig, Model M) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < M.n_dual) {
    int* d = dual + r * 4;
    int fp = d[0], fn = d[1], sp = d[2], sn = d[3];
    if (fp + fn > M.fast_w) {
      halve(fp, fn, M.fast_w, kHalveDefault);
      d[0] = fp;
      d[1] = fn;
    }
    if (sp + sn > M.slow_w) {
      halve(sp, sn, M.slow_w, kHalveDefault);
      d[2] = sp;
      d[3] = sn;
    }
  } else if (r < M.n_dual + M.n_sig) {
    int* s = sig + (r - M.n_dual) * 2;
    int gp = s[0], gn = s[1];
    if (gp + gn > M.sig_w) {
      halve(gp, gn, M.sig_w, kHalveDefault);
      s[0] = gp;
      s[1] = gn;
    }
  }
}

int launch_prefix(const int* bits, const int* kinds, const int* keys, int* pre1, int* pret,
                  long long nb, long long batch, long long n_dual, int mode, cudaStream_t st) {
  if (batch > kMaxPrefixBatch) return int(cudaErrorInvalidValue);
  const int threads = batch >= 1024 ? 1024 : int((batch + 31) / 32 * 32);
  prefix_kernel<<<unsigned(nb), threads, size_t(batch) * sizeof(int), st>>>(
      bits, kinds, keys, pre1, pret, batch, n_dual, mode);
  return int(cudaGetLastError());
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

}  // namespace

ARTC_API int artc_dual0_expand(const int* rows, const int* idx, const int* esc_idx,
                               const int* esc_val, int* out, long long n_rows,
                               long long n_dual, long long ne, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_dual > 0)
    dual0_gather_kernel<<<artc::grid_for(n_dual, 256), 256, 0, st>>>(rows, idx, out, n_rows,
                                                                    n_dual);
  if (ne > 0)
    dual0_escape_kernel<<<artc::grid_for(ne, 256), 256, 0, st>>>(esc_idx, esc_val, out,
                                                                 n_dual, ne);
  return int(cudaGetLastError());
}

// G chunks of one shape: kind/slot/prior/probs [G][m], dk_d/dk_s [G] rows at
// chunk strides dkd_stride/dks_stride (ints: views into the chunks' blobs),
// deltas [G][ns*sup][U], dual0 [G][n_dual][4], sig0_idx/val [G][k_sig0](x2);
// scratch dual/sig/cst [G][...] (tables and staging per chunk).
ARTC_API int artc_model_pass_v4(const int* kind, const int* slot, const int* prior,
                                const int* dk_d, const int* dk_s, const int* deltas,
                                const int* dual0, const int* sig0_idx, const int* sig0_val,
                                int* dual, int* sig, int* cst, int* probs, long long G,
                                long long dkd_stride, long long dks_stride, long long k_sig0,
                                long long n_dual, long long n_sig, long long ns, long long sup,
                                long long batch, long long ud, long long us, long long fast_w,
                                long long slow_w, long long sig_w, long long it_f,
                                long long it_s, long long it_g, long long alpha_on,
                                long long alpha_off, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  M.cst_stride = sup * 4 * M.U;
  if (G <= 0) return int(cudaGetLastError());
  const long long init = M.dual_stride > M.sig_stride ? M.dual_stride : M.sig_stride;
  tables_init_kernel<<<dim3(artc::grid_for(init, 256), unsigned(G)), 256, 0, st>>>(dual0, dual,
                                                                                   sig, M);
  if (k_sig0 > 0)
    sig0_scatter_kernel<<<dim3(artc::grid_for(k_sig0, 256), unsigned(G)), 256, 0, st>>>(
        sig0_idx, sig0_val, sig, k_sig0, n_sig, M.sig_stride);
  launch_scan(kind, slot, prior, nullptr, nullptr, dk_d, dk_s, PackedDeltas{deltas}, dual,
              sig, cst, probs, M, G, st);
  return int(cudaGetLastError());
}

// dual_in int32[n_dual_rows, 4] and sig_in [n_sig_rows, 2] are the extended
// start tables (model_pass_v2's dual0 / sig0); they are copied into the
// working tables dual / sig, and the inputs stay unchanged.
ARTC_API int artc_model_pass_v2(const int* kind, const int* prior, const int* pre1,
                                const int* pret, const int* bin_u, const int* dk_d,
                                const int* dk_s, const int* dd, const int* ds,
                                const int* dual_in, const int* sig_in, int* dual, int* sig,
                                int* cst, int* probs, long long n_dual_rows,
                                long long n_sig_rows, long long ns, long long sup,
                                long long batch, long long ud, long long us, long long fast_w,
                                long long slow_w, long long sig_w, long long it_f,
                                long long it_s, long long it_g, long long alpha_on,
                                long long alpha_off, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  cudaMemcpyAsync(dual, dual_in, size_t(n_dual_rows) * 4 * sizeof(int),
                  cudaMemcpyDeviceToDevice, st);
  cudaMemcpyAsync(sig, sig_in, size_t(n_sig_rows) * 2 * sizeof(int), cudaMemcpyDeviceToDevice,
                  st);
  launch_scan(kind, bin_u, prior, pre1, pret, dk_d, dk_s, SplitDeltas{dd, ds}, dual, sig,
              cst, probs, M, 1, st);
  return int(cudaGetLastError());
}

// bits/kinds/priors/bin_u int32[nb, batch], dict_keys [nb, U], dual_in
// [n_dual, 4] and sig_in [n_sig, 2] (both ending in their scratch row).
// Scratch: dual, sig (working tables), pre1, pret [nb * batch], tot
// [nb * U * 4] (zeroed by the caller).
ARTC_API int artc_model_pass_dict(const int* bits, const int* kinds, const int* priors,
                                  const int* bin_u, const int* dict_keys, const int* dual_in,
                                  const int* sig_in, int* dual, int* sig, int* pre1,
                                  int* pret, int* tot, int* probs, long long nb,
                                  long long batch, long long U, long long n_dual,
                                  long long n_sig, long long fast_w, long long slow_w,
                                  long long sig_w, long long alpha_on, long long alpha_off,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Model M = common_model(n_dual, n_sig, batch, fast_w, slow_w, sig_w, alpha_on, alpha_off);
  M.U = U;
  cudaMemcpyAsync(dual, dual_in, size_t(n_dual) * 4 * sizeof(int), cudaMemcpyDeviceToDevice,
                  st);
  cudaMemcpyAsync(sig, sig_in, size_t(n_sig) * 2 * sizeof(int), cudaMemcpyDeviceToDevice, st);
  if (nb == 0) return int(cudaGetLastError());
  const int rc = launch_prefix(bits, kinds, bin_u, pre1, pret, nb, batch, n_dual, 0, st);
  if (rc != 0) return rc;
  dict_totals_kernel<<<artc::grid_for(nb * batch, 256), 256, 0, st>>>(bits, kinds, bin_u, tot,
                                                                     nb * batch, batch, U);
  for (long long b = 0; b < nb; ++b) {
    dict_prob_kernel<<<artc::grid_for(batch, 256), 256, 0, st>>>(
        kinds, priors, bin_u, dict_keys, pre1, pret, dual, sig, probs, M, b);
    dict_update_kernel<<<artc::grid_for(U, 128), 128, 0, st>>>(dict_keys, tot, dual, sig, M,
                                                              b);
  }
  return int(cudaGetLastError());
}

// bits/kinds/keys/priors int32[nb * batch], dual_in [n_dual, 4] (ending in
// the scratch row), sig_in [n_sig, 2]. Scratch: dual, sig, pre1, pret.
ARTC_API int artc_model_pass(const int* bits, const int* kinds, const int* keys,
                             const int* priors, const int* dual_in, const int* sig_in,
                             int* dual, int* sig, int* pre1, int* pret, int* probs,
                             long long nb, long long batch, long long n_dual, long long n_sig,
                             long long fast_w, long long slow_w, long long sig_w,
                             long long alpha_on, long long alpha_off, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Model M = common_model(n_dual, n_sig, batch, fast_w, slow_w, sig_w, alpha_on, alpha_off);
  cudaMemcpyAsync(dual, dual_in, size_t(n_dual) * 4 * sizeof(int), cudaMemcpyDeviceToDevice,
                  st);
  cudaMemcpyAsync(sig, sig_in, size_t(n_sig) * 2 * sizeof(int), cudaMemcpyDeviceToDevice, st);
  if (nb == 0) return int(cudaGetLastError());
  const int rc = launch_prefix(bits, kinds, keys, pre1, pret, nb, batch, n_dual, 1, st);
  if (rc != 0) return rc;
  for (long long b = 0; b < nb; ++b) {
    sort_prob_kernel<<<artc::grid_for(batch, 256), 256, 0, st>>>(kinds, keys, priors, pre1,
                                                                pret, dual, sig, probs, M, b);
    sort_add_kernel<<<artc::grid_for(batch, 256), 256, 0, st>>>(bits, kinds, keys, dual, sig,
                                                               M, b);
    halve_tables_kernel<<<artc::grid_for(n_dual + n_sig, 256), 256, 0, st>>>(dual, sig, M);
  }
  return int(cudaGetLastError());
}
