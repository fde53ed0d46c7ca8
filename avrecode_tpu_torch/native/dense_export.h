// The dense (ANLZ) analysis of profile 0: write_dense_chunk, a chunk's
// export; start_dense, the producer (walker threads that walk and export
// chunks, claimed in order) for artc_session_analyze_begin; take_dense, the
// caller's hand-over of one chunk; gather_dense, the one-shot export's
// gather behind the header. A chunk's bytes, in order
// (analysis._parse_dense_chunk reads them; every field little-endian):
//   u64 n;
//   u8 bit[n]; u8 kind[n]; u32 key[n]; u16 prior[n];
//   u16 pre_ones[n]; u16 pre_tot[n]   (each bin's key's ones and total over
//                                      the earlier bins of its batch; 0 for
//                                      prior bins; kinds 0 and 1 share keys)
//   u16 probs[n];                     (the walk's host probabilities)
//   u16 dual0[4 * n_dual]             (fp, fn, sp, sn a key)
//   u32 n_sig_nz; u32 sig_idx[]; u16 sig_pos[]; u16 sig_neg[]
//                                     (sig0's nonzero rows: write_sig0_sparse)
//   the model_pass_v2 tables:
//   u32 ns; u32 ud; u32 us; u64 m     (super-steps of sup batches, bucketed
//                                      by bucket_steps; the dictionaries'
//                                      widths; m = ns * sup * batch)
//   u32 bin_u[m]                      (a dual bin's slot, ud + a sig bin's
//                                      slot; ud - 1 for prior and pad bins)
//   u32 dk_d[ns * ud]; u32 dk_s[ns * us]
//                                     (each step's keys of a kind, sorted,
//                                      then distinct out-of-range pad keys)
//   u16 dd[ns * sup * ud * 2]; u16 ds[ns * sup * us * 2]
//                                     ((ones, total) a sub-batch and slot)
//
// recode.cc includes this file inside its C ABI block, after bucket_steps,
// AnalyzeState, ArtcSession, g_error and the slim export, and it relies on
// the standard headers recode.cc includes, as slim_export.h does.
//
// A chunk's export is one malloc'd block, never value-initialised: the
// streams (everything before the tables) are written into a block of exact
// size, sized from n, the dual0 rows and sig0's nonzero rows before the
// trace is read; once the widest step is known, the block grows by the
// tables' exact size (realloc moves a large block's pages, not its bytes)
// and the tables are written behind the streams. The block goes to the
// caller as it is. The trace is read twice:
//   - one sweep, a batch at a time, stores each bin's four planes and its
//     prefix counts at their offsets, eight bins a store in each of the six
//     streams. A key-indexed record keeps the key's batch and super-step and
//     its running (ones, total): the first touch in a batch restarts the
//     counts, and the first in a step (a step is whole batches, so it is a
//     first touch in a batch too) lists the key among the step's keys of its
//     kind;
//   - once each step's list is sorted and ud and us are known, a read a step
//     maps each bin's key to its slot through a key-indexed table, stores
//     bin_u (eight bins a store) and counts each sub-batch's (ones, total)
//     into dd and ds, which are zeroed in place first.

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the dense export stores fields in the host's order; the reader takes little-endian");

struct FreeBytes {
  void operator()(uint8_t* p) const { free(p); }
};

// A chunk's export: n bytes of malloc'd memory (freed with free, artc_free).
struct DenseBlock {
  std::unique_ptr<uint8_t[], FreeBytes> p;
  size_t n = 0;
};

static uint8_t* malloc_or_throw(size_t n) {
  uint8_t* p = static_cast<uint8_t*>(malloc(n ? n : 1));
  if (!p) throw std::bad_alloc();
  return p;
}

// Chunk ci's export; records native.dense_export (its bytes) and, inside
// it, native.v2_tables (the tables' bytes).
static DenseBlock write_dense_chunk(SessionTrace& st, int64_t ci,
                              const std::vector<artc::PriorModel::Coded>& trace,
                              const std::vector<uint16_t>& probs,
                              const std::vector<artc::Dual>& dual0,
                              const std::vector<artc::Estimator>& sig0, uint32_t batch,
                              uint32_t sup_u) {
  using namespace artc;
  using Coded = PriorModel::Coded;
  static_assert(sizeof(Dual) == 8, "Dual is (fp, fn, sp, sn) as 4 u16");
  Phase xport(st, "native.dense_export", ci);
  const uint64_t n = trace.size();
  const uint64_t span = uint64_t(sup_u) * batch;
  const uint64_t ns = bucket_steps(uint32_t((n + span - 1) / span));  // 1 when n is 0
  const uint64_t m = ns * span;
  const uint32_t n_dual = uint32_t(PriorModel::kNumDualKeys);
  const uint32_t n_sig = uint32_t(PriorModel::kNumSigKeys);
  const Coded* tr = trace.data();

  // The streams' section.
  std::vector<uint32_t> sig_nz;
  for (uint32_t i = 0; i < sig0.size(); ++i)
    if (sig0[i].pos | sig0[i].neg) sig_nz.push_back(i);
  DenseBlock a;
  a.n = 8 + 12 * n + 2 * probs.size() + 8 * dual0.size() + 4 + 8 * sig_nz.size();
  a.p.reset(malloc_or_throw(a.n));
  memcpy(a.p.get(), &n, 8);
  uint8_t* const bit_at = a.p.get() + 8;
  uint8_t* const kind_at = bit_at + n;
  uint8_t* const key_at = kind_at + n;
  uint8_t* const prior_at = key_at + 4 * n;
  uint8_t* const ones_at = prior_at + 2 * n;
  uint8_t* const tot_at = ones_at + 2 * n;

  // Key (sig keys after the dual ones) -> the batch and the step that last
  // touched it, and its (ones, total) in that batch so far.
  struct KeyRun {
    uint32_t batch, step;
    uint16_t ones, tot;
  };
  std::vector<KeyRun> runs(size_t(n_dual) + n_sig, KeyRun{~0u, ~0u, 0, 0});
  KeyRun* kr = runs.data();
  // Each step's keys of each kind, first touch first; step s's are
  // [step_end[s - 1], step_end[s]).
  std::vector<uint32_t> step_keys[2], step_end[2];
  for (uint32_t sg = 0; sg < 2; ++sg) step_end[sg].reserve(ns);
  uint32_t step = 0, bidx = 0;
  // A bin's prefix counts, ones | total << 16, from its key's record.
  auto count = [&](const Coded& c) -> uint32_t {
    if (c.kind == PriorModel::kKindPrior) return 0;
    const uint32_t sg = c.kind == PriorModel::kKindSig;
    KeyRun& k = kr[c.key + (sg ? n_dual : 0)];
    if (k.batch != bidx) {
      k.batch = bidx;
      k.ones = k.tot = 0;
      if (k.step != step) {
        k.step = step;
        step_keys[sg].push_back(c.key);
      }
    }
    const uint16_t ones = k.ones, tot = k.tot;
    k.ones = uint16_t(ones + (c.bit ? 1 : 0));
    k.tot = uint16_t(tot + 1);
    return ones | uint32_t(tot) << 16;
  };
  for (uint64_t s = 0; s < ns; ++s) {
    step = uint32_t(s);
    const uint64_t lo = s * span, hi = std::min<uint64_t>(lo + span, n);
    for (uint64_t b0 = lo; b0 < hi; b0 += batch) {
      bidx = uint32_t(b0 / batch);
      const uint64_t b1 = std::min<uint64_t>(b0 + batch, hi);
      // Eight bins at a time, one store a plane: a store a bin and plane
      // made this loop two to three times slower on an H100 server's host
      // CPU (on another x86 CPU it made no difference).
      uint64_t i = b0;
      for (; i + 8 <= b1; i += 8) {
        uint64_t bits = 0, kinds = 0;
        uint32_t keys[8];
        uint16_t priors[8], ones[8], tots[8];
        for (uint32_t j = 0; j < 8; ++j) {
          const Coded& c = tr[i + j];
          bits |= uint64_t(c.bit) << (8 * j);
          kinds |= uint64_t(c.kind) << (8 * j);
          keys[j] = c.key;
          priors[j] = c.prior;
          const uint32_t pc = count(c);
          ones[j] = uint16_t(pc);
          tots[j] = uint16_t(pc >> 16);
        }
        memcpy(bit_at + i, &bits, 8);
        memcpy(kind_at + i, &kinds, 8);
        memcpy(key_at + 4 * i, keys, 32);
        memcpy(prior_at + 2 * i, priors, 16);
        memcpy(ones_at + 2 * i, ones, 16);
        memcpy(tot_at + 2 * i, tots, 16);
      }
      for (; i < b1; ++i) {
        const Coded& c = tr[i];
        bit_at[i] = c.bit;
        kind_at[i] = c.kind;
        memcpy(key_at + 4 * i, &c.key, 4);
        memcpy(prior_at + 2 * i, &c.prior, 2);
        const uint32_t pc = count(c);
        const uint16_t ones = uint16_t(pc), tot = uint16_t(pc >> 16);
        memcpy(ones_at + 2 * i, &ones, 2);
        memcpy(tot_at + 2 * i, &tot, 2);
      }
    }
    for (uint32_t sg = 0; sg < 2; ++sg) step_end[sg].push_back(uint32_t(step_keys[sg].size()));
  }
  if (timing_enabled())
    fprintf(stderr, "[artc] analyze chunk %lld: streams+prefix %.3fs\n", (long long)ci,
            double(now_ns() - xport.t0) * 1e-9);
  const int64_t t_mid = timing_enabled() ? now_ns() : 0;
  uint8_t* o = tot_at + 2 * n;
  if (!probs.empty()) memcpy(o, probs.data(), 2 * probs.size());
  o += 2 * probs.size();
  if (!dual0.empty()) memcpy(o, dual0.data(), 8 * dual0.size());
  o += 8 * dual0.size();
  const uint32_t n_nz = uint32_t(sig_nz.size());
  memcpy(o, &n_nz, 4);
  o += 4;
  if (n_nz) memcpy(o, sig_nz.data(), 4 * size_t(n_nz));
  o += 4 * size_t(n_nz);
  for (uint32_t i : sig_nz) {
    memcpy(o, &sig0[i].pos, 2);
    memcpy(o + 2 * size_t(n_nz), &sig0[i].neg, 2);
    o += 2;
  }

  // The tables' section.
  Phase v2(st, "native.v2_tables", ci);
  uint32_t max_keys[2] = {1, 1};
  for (uint32_t sg = 0; sg < 2; ++sg)
    for (uint64_t s = 0; s < ns; ++s) {
      const uint32_t b = s ? step_end[sg][s - 1] : 0, e = step_end[sg][s];
      std::sort(step_keys[sg].begin() + b, step_keys[sg].begin() + e);
      max_keys[sg] = std::max(max_keys[sg], e - b);
    }
  const uint32_t ud = bucket_pow2(max_keys[0] + 1), us = bucket_pow2(max_keys[1] + 1);
  const uint64_t n_dk = ns * (uint64_t(ud) + us), n_dx = ns * sup_u * (uint64_t(ud) + us) * 2;
  const size_t b_n = 20 + 4 * m + 4 * n_dk + 2 * n_dx;
  // The block grows by the tables' section, which is written in place.
  uint8_t* const grown = static_cast<uint8_t*>(realloc(a.p.get(), a.n + b_n));
  if (!grown) throw std::bad_alloc();
  a.p.release();
  a.p.reset(grown);
  uint8_t* const b = grown + a.n;
  const uint32_t ns32 = uint32_t(ns);
  memcpy(b, &ns32, 4);
  memcpy(b + 4, &ud, 4);
  memcpy(b + 8, &us, 4);
  memcpy(b + 12, &m, 8);
  // The streams' length is even, so the u16 tables are aligned in malloc's
  // block, but the u32 ones may not be: they are stored with memcpy.
  uint8_t* const bin_u = b + 20;
  uint8_t* const dk[2] = {bin_u + 4 * m, bin_u + 4 * (m + ns * ud)};
  uint16_t* const dd = reinterpret_cast<uint16_t*>(bin_u + 4 * (m + n_dk));
  uint16_t* const dx[2] = {dd, dd + ns * sup_u * uint64_t(ud) * 2};
  memset(dx[0], 0, 2 * n_dx);
  const uint32_t width[2] = {ud, us}, pad[2] = {n_dual + 1, n_sig};
  // Key (sig keys after the dual ones) -> its slot in the current step.
  std::unique_ptr<uint32_t[]> slot(new uint32_t[size_t(n_dual) + n_sig]);
  uint32_t* const sl_of = slot.get();
  for (uint64_t s = 0; s < ns; ++s) {
    for (uint32_t sg = 0; sg < 2; ++sg) {
      const uint32_t b0 = s ? step_end[sg][s - 1] : 0, k = step_end[sg][s] - b0;
      const uint32_t* keys = step_keys[sg].data() + b0;
      uint8_t* row = dk[sg] + 4 * s * width[sg];
      uint32_t* sl = sl_of + (sg ? n_dual : 0);
      memcpy(row, keys, 4 * size_t(k));
      for (uint32_t j = 0; j < k; ++j) sl[keys[j]] = j;
      for (uint32_t j = k; j < width[sg]; ++j) {
        const uint32_t key = pad[sg] + (j - k);
        memcpy(row + 4 * j, &key, 4);
      }
    }
    const uint64_t lo = s * span, hi = std::min<uint64_t>(lo + span, n);
    for (uint64_t b0 = lo, q = 0; b0 < hi; b0 += batch, ++q) {
      const uint64_t b1 = std::min<uint64_t>(b0 + batch, hi);
      uint16_t* const cells_d = dx[0] + (s * sup_u + q) * ud * 2;
      uint16_t* const cells_s = dx[1] + (s * sup_u + q) * us * 2;
      // A bin's bin_u entry; counts it into its sub-batch's cell.
      auto slot_of = [&](const Coded& c) -> uint32_t {
        if (c.kind == PriorModel::kKindPrior) return ud - 1;
        const bool sig = c.kind == PriorModel::kKindSig;
        const uint32_t sl = sl_of[c.key + (sig ? n_dual : 0)];
        uint16_t* const cell = (sig ? cells_s : cells_d) + 2 * sl;
        cell[0] = uint16_t(cell[0] + (c.bit ? 1 : 0));
        cell[1] = uint16_t(cell[1] + 1);
        return sig ? ud + sl : sl;
      };
      uint64_t i = b0;
      for (; i + 8 <= b1; i += 8) {  // eight bins a store, as in the sweep
        uint32_t u[8];
        for (uint32_t j = 0; j < 8; ++j) u[j] = slot_of(tr[i + j]);
        memcpy(bin_u + 4 * i, u, 32);
      }
      for (; i < b1; ++i) {
        const uint32_t u = slot_of(tr[i]);
        memcpy(bin_u + 4 * i, &u, 4);
      }
    }
  }
  const uint32_t pad_u = ud - 1;
  for (uint64_t i = n; i < m; ++i) memcpy(bin_u + 4 * i, &pad_u, 4);
  v2.end(b_n);
  a.n += b_n;
  xport.end(a.n);
  if (timing_enabled())
    fprintf(stderr, "[artc] analyze chunk %lld: v2 dicts+serialize %.3fs\n", (long long)ci,
            double(now_ns() - t_mid) * 1e-9);
  return a;
}

// flags bit 2 of artc_session_analyze_begin: the dense analysis.
static constexpr int kAnalyzeDense = 4;

// How many chunks may be ahead of the caller: claimed by a walker and not
// yet taken, whether being walked, exported or waiting. Three let three
// walkers run while the caller parses and runs a chunk on the card, and
// bound the exports the host holds at once: these three and the one being
// parsed, where the one-shot export held every chunk. It is also the most
// walkers.
static constexpr size_t kDenseAhead = 3;

// The dense producer: walkers claim chunks in order, each walks its chunk,
// writes its export and publishes it in `as` (status 1) under its mutex, at
// most kDenseAhead chunks ahead of the chunks taken. Chunk 0's walk makes
// the warm snapshot that every later chunk starts from (WarmCtx), so the
// later chunks walk in parallel, as profile 2's workers do, and the bytes
// do not depend on the schedule. An error fails its chunk (status 2; the
// first message in as->err); one of chunk 0 also fails the snapshot, so
// the chunks waiting on it fail too. The state's destructor stops the
// walkers once the chunks they are writing are done, and joins them.
// ARTC_DENSE_FAULT_CHUNK=i fails chunk i as an error of its walk would: the
// way a test reaches the error path.
static void start_dense(ArtcSession* se, AnalyzeState* as, uint32_t sup_u) {
  using namespace artc;
  const size_t n_chunks = se->ranges.size();
  as->dense = true;
  as->blocks.assign(n_chunks, nullptr);
  as->block_len.assign(n_chunks, 0);
  size_t fault = SIZE_MAX;
  if (const char* e = getenv("ARTC_DENSE_FAULT_CHUNK"))
    if (*e) fault = strtoull(e, nullptr, 10);
  auto warm = std::make_shared<WarmCtx>();
  warm->src_slices = se->warm_slices;
  auto work = [se, as, sup_u, fault, n_chunks, warm] {
    const uint32_t batch = se->opt.batch_size ? se->opt.batch_size : 1;
    for (;;) {
      size_t ci;
      {
        std::unique_lock<std::mutex> lock(as->mu);
        as->cv.wait(lock, [&] {
          return as->stop || as->next >= n_chunks || as->next < as->taken + kDenseAhead;
        });
        if (as->stop || as->next >= n_chunks) return;
        ci = as->next++;
      }
      try {
        if (ci == fault)
          throw std::runtime_error("dense analysis: fault injected at chunk " +
                                   std::to_string(ci));
        auto [b, e] = se->ranges[ci];
        std::vector<PriorModel::Coded> trace;
        std::vector<uint16_t> probs;
        std::vector<Dual> dual0;
        std::vector<Estimator> sig0;
        Stats tmp;
        Phase walk(se->trace, "native.dense_walk", int64_t(ci));
        run_chunk_model(se->p1.slices, b, e, se->opt, tmp, &trace, &probs, &dual0,
                        se->nz_modes[ci], /*encode_blob=*/false,
                        ci == 0 && warm->src_slices ? warm.get() : nullptr,
                        ci > 0 && warm->src_slices ? warm.get() : nullptr, &sig0,
                        se->alpha_off);
        const double sec = walk.end(trace.size());
        if (timing_enabled())
          fprintf(stderr, "[artc] analyze chunk %zu: trace walk %.3fs (%zu bins)\n", ci, sec,
                  trace.size());
        DenseBlock blk = write_dense_chunk(se->trace, int64_t(ci), trace, probs, dual0, sig0,
                                           batch, sup_u);
        std::lock_guard<std::mutex> lock(as->mu);
        as->blocks[ci] = blk.p.release();
        as->block_len[ci] = blk.n;
        as->status[ci] = 1;
        as->cv.notify_all();
      } catch (const std::exception& e) {
        {
          std::lock_guard<std::mutex> lock(as->mu);
          if (as->err.empty()) as->err = e.what();
          as->status[ci] = 2;
          as->cv.notify_all();
        }
        if (ci == 0) warm->fail();
      }
    }
  };
  const size_t n_walkers = std::min<size_t>(
      {kDenseAhead, n_chunks, std::max(1u, std::thread::hardware_concurrency())});
  for (size_t t = 0; t < n_walkers; ++t) as->workers.emplace_back(work);
}

// The caller's hand-over of chunk idx (native.rendezvous while it waits,
// native.copyout for the hand-over): the walker's block itself, freed by
// the caller, with no copy. Chunks are taken once each, in order, or the
// walkers, held at kDenseAhead, could wait for a chunk the caller skips.
// False with g_error set on an error.
static bool take_dense(ArtcSession* se, AnalyzeState* as, uint32_t idx, uint8_t** out,
                       size_t* out_len) {
  std::unique_lock<std::mutex> lock(as->mu);
  if (idx != as->taken) {
    g_error = "dense analysis chunks are taken once each, in order";
    return false;
  }
  Phase wait(se->trace, "native.rendezvous", idx);
  as->cv.wait(lock, [&] { return as->status[idx] != 0; });
  wait.end();
  if (as->status[idx] == 2) {
    g_error = as->err;
    return false;
  }
  Phase copy(se->trace, "native.copyout", idx);
  *out = as->blocks[idx];
  as->blocks[idx] = nullptr;
  *out_len = as->block_len[idx];
  ++as->taken;
  lock.unlock();
  as->cv.notify_all();
  copy.end(*out_len);
  return true;
}

// The one-shot export's copy-out: the header and every chunk's block, in
// order, in one malloc'd buffer (*out, freed with artc_free); each block is
// freed once copied. Returns the buffer's length.
static size_t gather_dense(const std::vector<uint8_t>& header, std::vector<DenseBlock>& parts,
                           uint8_t** out) {
  size_t total = header.size();
  for (const DenseBlock& p : parts) total += p.n;
  uint8_t* o = malloc_or_throw(total);
  *out = o;
  memcpy(o, header.data(), header.size());
  o += header.size();
  for (DenseBlock& p : parts) {
    memcpy(o, p.p.get(), p.n);
    o += p.n;
    p.p.reset();
  }
  return total;
}
