// The slim (ANL5) per-chunk export, write_slim_chunk: the layout is the
// comment above this header's #include in recode.cc, but for two sections
// that comment shows in an older form: the dual0 table is a row dictionary
// (write_dual0_rows) and the COO (ones, total) pairs are one nibble pair a
// byte with an escape list (the last lines of write_slim_chunk's layout).
//
// recode.cc includes this file inside its C ABI block, after bucket_steps
// and write_sig0_sparse, and it relies on the standard headers recode.cc
// includes: it includes nothing itself, and defines no function template,
// which C linkage forbids.
//
// It reads the trace once and each bin's word once more:
//   - the trace, a sub-batch at a time: each bin's key gets its cell (the
//     key's number in first-touch order within the super-step, from a
//     key-indexed table cleared as the step ends), the cell's (ones, total)
//     count, and a stamp that lists the sub-batch's cells in first-touch
//     order; the bin leaves one word (prior, bit, kind, cell). Each run is
//     ranked by a counting sort as soon as its sub-batch ends. A run's order
//     does not depend on the keys' sorted order, which the step's end reads
//     off a bitmap of its keys, so the cells become slots only when the slot
//     stream is packed;
//   - the words, a sub-batch at a time: the run maps each cell to its rank,
//     and one sweep writes the nibbles, the hot and the cold rank streams
//     (entry j of a w-bit stream in word j / (32 / w)), the prior indices
//     and the escapes in place, into an export sized once from the layout;
//   - the prior and the dual0 row dictionaries select from the distinct
//     values only, in the order, ties included, that the selection over
//     every value or row gave.

static uint32_t ceil_log2(uint32_t x) {  // bits to hold values in [0, x)
  uint32_t b = 1;
  while ((1u << b) < x) ++b;
  return b;
}

// Words that `count` w-bit entries fill when none straddles a word (32 mod
// w tail bits a word stay zero): the wa sweep's cost.
static uint64_t slim_ns_words(uint64_t count, uint32_t w) {
  const uint64_t epw = 32 / w;
  return (count + epw - 1) / epw;
}

// The words a packed stream ships: through the last entry's word, plus one
// tail word so the device's straddle gather (words[wi + 1]) stays in
// bounds; two for an empty stream.
static uint64_t slim_stream_words(uint64_t count, uint32_t w) {
  return count ? (count - 1) / (32 / w) + 2 : 2;
}

// Packs v's leading entries into whole words of a w-bit no-straddle
// stream at out (entry j of a word at bit j * w) and moves the entries
// that fill no whole word to the front; returns the end of the words.
static uint8_t* slim_pack_words(uint16_t* v, uint32_t* count, uint32_t w, uint8_t* out) {
  const uint32_t epw = 32 / w, words = *count / epw;
  for (uint32_t k = 0; k < words; ++k) {
    uint32_t acc = 0;
    for (uint32_t q = 0; q < epw; ++q) acc |= uint32_t(v[k * epw + q]) << (q * w);
    memcpy(out + 4 * k, &acc, 4);
  }
  const uint32_t rest = *count - words * epw;
  memmove(v, v + words * epw, rest * 2);
  *count = rest;
  return out + 4 * words;
}

// Stores the last, partial word of the stream (count < 32 / w entries).
static void slim_pack_tail(const uint16_t* v, uint32_t count, uint32_t w, uint8_t* out) {
  uint32_t acc = 0;
  for (uint32_t q = 0; q < count; ++q) acc |= uint32_t(v[q]) << (q * w);
  if (count) memcpy(out, &acc, 4);
}

// The dual0 row dictionary: u16 nd; nd rows (fp, fn, sp, sn); a u8 per row
// (255 = escape); u32 n_esc; the escape rows' indices and their rows. The
// nd <= 255 most frequent rows are those std::partial_sort picks from the
// distinct rows in a std::unordered_map's iteration order (ties broken as
// that order and the heap selection leave them), the map filled in the
// rows' first-occurrence order after reserve(rows / 16). The map holds the
// distinct rows only. A table's rows mostly repeat the row before (98% of a
// CABAC-init seed's), so the work is per run of equal rows: an
// open-addressed table numbers each run's row, and each run's dictionary
// index fills its bytes at once.
static void write_dual0_rows(artc::Writer& w, const std::vector<artc::Dual>& dual0) {
  static_assert(sizeof(artc::Dual) == 8, "Dual is (fp, fn, sp, sn) as 4 u16");
  const size_t rows = dual0.size();
  auto row = [&](size_t i) {
    uint64_t v;
    memcpy(&v, &dual0[i], 8);
    return v;
  };
  std::vector<uint64_t> dv;  // distinct rows, in first-occurrence order
  std::vector<uint32_t> dc;  // and their counts
  uint32_t bits = 8;
  std::vector<uint64_t> hkey(size_t(1) << bits);
  std::vector<uint32_t> hid(size_t(1) << bits, ~0u);
  auto slot_of = [&](uint64_t v) {
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    uint64_t h = (v * 0x9E3779B97F4A7C15ull) >> (64 - bits);
    while (hid[h] != ~0u && hkey[h] != v) h = (h + 1) & mask;
    return h;
  };
  auto id_of = [&](uint64_t v) {
    uint64_t h = slot_of(v);
    if (hid[h] == ~0u) {
      if (2 * (dv.size() + 1) > hkey.size()) {  // keep the table under half full
        ++bits;
        hkey.assign(size_t(1) << bits, 0);
        hid.assign(size_t(1) << bits, ~0u);
        for (uint32_t d = 0; d < dv.size(); ++d) {
          const uint64_t g = slot_of(dv[d]);
          hkey[g] = dv[d];
          hid[g] = d;
        }
        h = slot_of(v);
      }
      hkey[h] = v;
      hid[h] = uint32_t(dv.size());
      dv.push_back(v);
      dc.push_back(0);
    }
    return hid[h];
  };
  std::vector<uint32_t> run_start, run_id;  // each run's first row and distinct row
  for (size_t i = 0; i < rows; ++i)
    if (i == 0 || row(i) != row(i - 1)) {
      run_start.push_back(uint32_t(i));
      run_id.push_back(id_of(row(i)));
    }
  run_start.push_back(uint32_t(rows));
  for (size_t r = 0; r + 1 < run_start.size(); ++r) dc[run_id[r]] += run_start[r + 1] - run_start[r];
  std::unordered_map<uint64_t, uint32_t> cnt;
  cnt.reserve(rows / 16);
  for (size_t d = 0; d < dv.size(); ++d) cnt[dv[d]] = dc[d];
  std::vector<std::pair<uint32_t, uint64_t>> by_freq;
  by_freq.reserve(cnt.size());
  for (const auto& kv : cnt) by_freq.push_back({kv.second, kv.first});
  const size_t nd = std::min<size_t>(by_freq.size(), 255);
  std::partial_sort(by_freq.begin(), by_freq.begin() + nd, by_freq.end(),
                    [](const auto& a, const auto& b) { return a.first > b.first; });
  std::vector<uint8_t> dict_of(dv.size(), 255);
  std::vector<uint16_t> head(1 + 4 * nd);
  head[0] = uint16_t(nd);
  for (size_t j = 0; j < nd; ++j) {
    const uint64_t v = by_freq[j].second;
    dict_of[hid[slot_of(v)]] = uint8_t(j);
    for (int q = 0; q < 4; ++q) head[1 + 4 * j + q] = uint16_t(v >> (16 * q));
  }
  w.bytes(reinterpret_cast<const uint8_t*>(head.data()), head.size() * 2);
  const size_t at = w.buf.size();
  w.buf.resize(at + rows);
  std::vector<uint32_t> esc;
  for (size_t r = 0; r + 1 < run_start.size(); ++r) {
    const uint8_t k = dict_of[run_id[r]];
    memset(w.buf.data() + at + run_start[r], k, run_start[r + 1] - run_start[r]);
    if (k == 255)
      for (uint32_t i = run_start[r]; i < run_start[r + 1]; ++i) esc.push_back(i);
  }
  w.u32(uint32_t(esc.size()));
  w.bytes(reinterpret_cast<const uint8_t*>(esc.data()), esc.size() * 4);
  for (uint32_t i : esc) w.bytes(reinterpret_cast<const uint8_t*>(&dual0[i]), 8);
}

// Stores into the export's bytes, whatever their alignment.
struct SlimCursor {
  uint8_t* p;
  void u8(uint8_t v) { *p++ = v; }
  void u16(uint16_t v) { memcpy(p, &v, 2); p += 2; }
  void u32(uint32_t v) { memcpy(p, &v, 4); p += 4; }
  void u64(uint64_t v) { memcpy(p, &v, 8); p += 8; }
  uint8_t* skip(size_t k) {
    uint8_t* q = p;
    p += k;
    return q;
  }
  void bytes(const void* q, size_t k) {
    if (k) memcpy(p, q, k);
    p += k;
  }
};

static void write_slim_chunk(artc::Writer& w,
                             const std::vector<artc::PriorModel::Coded>& trace,
                             const std::vector<uint16_t>& probs, bool has_probs,
                             const std::vector<artc::Dual>& dual0,
                             const std::vector<artc::Estimator>& sig0, uint32_t batch,
                             uint32_t sup_u, bool share_dual0, bool share_sig0) {
  using namespace artc;
  using Coded = PriorModel::Coded;
  const uint64_t n = trace.size();
  const uint64_t span = uint64_t(sup_u) * batch;
  uint64_t ns = bucket_steps(uint32_t((n + span - 1) / span));
  if (ns == 0) ns = 1;
  const uint64_t m = ns * span;
  const uint32_t n_dual = uint32_t(PriorModel::kNumDualKeys);
  const uint32_t n_sig = uint32_t(PriorModel::kNumSigKeys);
  const uint32_t kPrior = PriorModel::kKindPrior;
  const Coded* tr = trace.data();

  // A cell is a super-step's key of one kind, numbered in first-touch order,
  // bit 12 set for sig keys. A super-step with 4096 keys of one kind makes
  // that kind's dictionary 8192 wide and the two together wider than 8192,
  // so numbers stop at 4094; cell 8191 stands for a prior bin's "none".
  constexpr uint32_t kSigCell = 1u << 12, kMaxCells = 4095, kNoCell = 8191;
  std::vector<uint32_t> freq(65536, 0);
  // Key (sig keys after the dual ones) -> 1 + its cell in this super-step,
  // 0 if untouched; cleared for the step's keys when it ends.
  std::vector<uint16_t> key_cell(size_t(n_dual) + n_sig, 0);
  // This super-step's keys of each kind, a bit a key and a bit a nonzero
  // word of those: read in order as the step ends, they are its keys sorted.
  std::vector<uint64_t> key_bits[2], word_bits[2];
  for (uint32_t sg = 0; sg < 2; ++sg) {
    key_bits[sg].assign(((sg ? n_sig : n_dual) + 63) / 64, 0);
    word_bits[sg].assign((key_bits[sg].size() + 63) / 64, 0);
  }
  // Every super-step's keys of each kind, sorted, and each cell's place
  // among them (by step: [key_end[s - 1], key_end[s])).
  std::vector<uint32_t> sorted_keys[2], key_end[2];
  std::vector<uint16_t> place[2];
  uint32_t n_cells[2], max_keys[2] = {1, 1};
  // Per bin: prior << 16 | bit << 15 | kind << 13 | cell (bits are 0 or 1);
  // every one is written, so none is zeroed first.
  std::unique_ptr<uint32_t[]> bin_word(new uint32_t[n]);
  std::vector<uint16_t> coo_cnt(ns * sup_u, 0);
  std::vector<uint16_t> coo_cell;  // the runs' cells, each run in rank order
  std::vector<uint8_t> coo_nib;    // and their (ones, total) nibble pairs
  std::vector<uint32_t> cesc_idx;
  std::vector<uint16_t> cesc_ones, cesc_tot;
  coo_cell.reserve(n / 4);
  coo_nib.reserve(n / 4);
  std::vector<uint64_t> rank_hist(8192, 0);
  uint32_t max_run = 1;
  // The sub-batch's run: cell -> total << 32 | ones (exact; the wire holds
  // them as u16) and the last sub-batch that touched it; the run's cells in
  // first-touch order.
  std::vector<uint64_t> counts(2 * kSigCell, 0);
  std::vector<uint32_t> stamp(2 * kSigCell, ~0u), count_at;
  std::vector<uint16_t> run_cells(2 * kSigCell);
  uint32_t* fq = freq.data();
  uint16_t* kc = key_cell.data();
  uint64_t* cnt = counts.data();
  uint32_t* stp = stamp.data();
  uint16_t* rc = run_cells.data();
  uint32_t* word = bin_word.get();

  for (uint64_t s = 0; s * span < n; ++s) {
    const uint64_t lo = s * span, hi = std::min<uint64_t>(lo + span, n);
    n_cells[0] = n_cells[1] = 0;
    for (uint64_t b0 = lo; b0 < hi; b0 += batch) {
      const uint32_t subg = uint32_t(b0 / batch);  // global sub-batch index
      const uint64_t b1 = std::min<uint64_t>(b0 + batch, hi);
      uint32_t len = 0;
      for (uint64_t i = b0; i < b1; ++i) {
        const Coded& c = tr[i];
        ++fq[c.prior];
        const uint32_t kind = c.kind, bit = c.bit;
        uint32_t cell = kNoCell;
        if (kind != kPrior) {  // prior bins have no slot and no update
          const uint32_t sg = kind == PriorModel::kKindSig;
          const uint32_t key = c.key + (sg ? n_dual : 0);
          uint32_t cell1 = kc[key];
          if (!cell1) {
            if (n_cells[sg] == kMaxCells)
              throw std::runtime_error("slim analysis: dict width > 8192 (use fat export)");
            key_bits[sg][c.key >> 6] |= uint64_t(1) << (c.key & 63);
            word_bits[sg][c.key >> 12] |= uint64_t(1) << (c.key >> 6 & 63);
            cell1 = (sg << 12 | n_cells[sg]++) + 1;
            kc[key] = uint16_t(cell1);
          }
          cell = cell1 - 1;
          cnt[cell] += uint64_t(1) << 32 | bit;
          const uint32_t fresh = stp[cell] != subg;
          stp[cell] = subg;
          rc[len] = uint16_t(cell);
          len += fresh;
        }
        word[i] = uint32_t(c.prior) << 16 | bit << 15 | kind << 13 | cell;
      }
      // Order the run by descending total (as u16; stable: ties keep
      // first-touch order) so hot slots get small ranks: a counting sort.
      coo_cnt[subg] = uint16_t(len);
      max_run = std::max(max_run, len);
      uint32_t max_tot = 0;
      for (uint32_t j = 0; j < len; ++j)
        max_tot = std::max<uint32_t>(max_tot, uint16_t(cnt[rc[j]] >> 32));
      count_at.assign(max_tot + 1, 0);
      for (uint32_t j = 0; j < len; ++j) ++count_at[uint16_t(cnt[rc[j]] >> 32)];
      uint32_t acc = 0;  // count_at[t] -> first rank for totals == t (descending)
      for (uint32_t t = max_tot; t > 0; --t) {
        const uint32_t k = count_at[t];
        count_at[t] = acc;
        acc += k;
      }
      const size_t run = coo_cell.size(), run_esc = cesc_idx.size();
      coo_cell.resize(run + len);
      coo_nib.resize(run + len);
      uint16_t* cells = coo_cell.data() + run;
      uint8_t* nib = coo_nib.data() + run;
      for (uint32_t j = 0; j < len; ++j) {
        const uint32_t cell = rc[j];
        const uint64_t k = cnt[cell];
        cnt[cell] = 0;
        const uint32_t r = count_at[uint16_t(k >> 32)]++;
        cells[r] = uint16_t(cell);
        rank_hist[r] += k >> 32;
        // (ones, total) as a 4+4-bit nibble pair; either half >= 15 escapes.
        const uint16_t o = uint16_t(k), t = uint16_t(k >> 32);
        nib[r] = uint8_t((o > 15 ? 15 : o) | ((t > 15 ? 15 : t) << 4));
        if (o > 15 || t > 15) {
          cesc_idx.push_back(uint32_t(run + r));
          cesc_ones.push_back(o);
          cesc_tot.push_back(t);
        }
      }
      // The run's escapes by rank (a handful, found in first-touch order).
      for (size_t e = run_esc + 1; e < cesc_idx.size(); ++e)
        for (size_t f = e; f > run_esc && cesc_idx[f - 1] > cesc_idx[f]; --f) {
          std::swap(cesc_idx[f - 1], cesc_idx[f]);
          std::swap(cesc_ones[f - 1], cesc_ones[f]);
          std::swap(cesc_tot[f - 1], cesc_tot[f]);
        }
    }
    // The super-step's dictionaries: its keys of each kind, sorted, and each
    // cell's place there.
    for (uint32_t sg = 0; sg < 2; ++sg) {
      const uint32_t k = n_cells[sg];
      const size_t b = sorted_keys[sg].size();
      place[sg].resize(b + k);
      sorted_keys[sg].resize(b + k);
      uint16_t* pl = place[sg].data() + b;
      uint32_t* sk = sorted_keys[sg].data() + b;
      uint16_t* kcs = kc + (sg ? n_dual : 0);
      uint32_t j = 0;
      for (uint32_t sw = 0; sw < word_bits[sg].size(); ++sw) {
        for (uint64_t words = word_bits[sg][sw]; words; words &= words - 1) {
          const uint32_t wi = sw << 6 | uint32_t(__builtin_ctzll(words));
          for (uint64_t bits = key_bits[sg][wi]; bits; bits &= bits - 1, ++j) {
            const uint32_t key = wi << 6 | uint32_t(__builtin_ctzll(bits));
            pl[(kcs[key] - 1) & 0xFFF] = uint16_t(j);
            sk[j] = key;
            kcs[key] = 0;
          }
          key_bits[sg][wi] = 0;
        }
        word_bits[sg][sw] = 0;
      }
      key_end[sg].push_back(uint32_t(sorted_keys[sg].size()));
      max_keys[sg] = std::max(max_keys[sg], k);
    }
  }
  const uint32_t ud = bucket_pow2(max_keys[0] + 1), us = bucket_pow2(max_keys[1] + 1);
  const uint32_t U = ud + us;  // <= 8192: each kind has at most 4094 keys a step
  for (uint32_t sg = 0; sg < 2; ++sg)  // steps past n: no keys
    key_end[sg].resize(ns, uint32_t(sorted_keys[sg].size()));

  // Prior dictionary: the 255 most frequent u16 priors, in the order
  // std::partial_sort leaves them when it selects from all 65536 values by
  // descending count. Its heap selection starts from values 0-254 and
  // passes over every later value whose count is 0, so selecting from those
  // 255 and the later values that occur does the same steps.
  std::vector<uint32_t> by_freq(255);
  for (uint32_t i = 0; i < 255; ++i) by_freq[i] = i;
  for (uint32_t i = 255; i < 65536; ++i)
    if (freq[i]) by_freq.push_back(i);
  std::partial_sort(by_freq.begin(), by_freq.begin() + 255, by_freq.end(),
                    [&](uint32_t a, uint32_t b) { return freq[a] > freq[b]; });
  std::vector<uint16_t> dict;
  std::vector<uint8_t> pidx_map(65536, 255);
  uint64_t n_esc = n;
  for (int i = 0; i < 255 && freq[by_freq[i]] > 0; ++i) {
    pidx_map[by_freq[i]] = uint8_t(dict.size());
    dict.push_back(uint16_t(by_freq[i]));
    n_esc -= freq[by_freq[i]];
  }

  // Hot-rank width: sweep wa for the fewest words (ranks >= 2^wa pay the
  // full wb bits in the cold stream).
  const uint32_t wb = ceil_log2(std::max(max_run, 2u));
  uint64_t live_total = 0;
  for (uint32_t r = 0; r < max_run; ++r) live_total += rank_hist[r];
  for (uint32_t r = 1; r < max_run; ++r) rank_hist[r] += rank_hist[r - 1];
  auto hot_count = [&](uint32_t width) {
    return (1ull << width) >= max_run ? live_total : rank_hist[(1ull << width) - 1];
  };
  uint32_t wa = wb;
  uint64_t best_cost = ~0ull;
  for (uint32_t cand = 1; cand <= wb; ++cand) {
    const uint64_t hot = hot_count(cand);
    const uint64_t cost = slim_ns_words(hot, cand) + slim_ns_words(live_total - hot, wb);
    if (cost < best_cost) { best_cost = cost; wa = cand; }
  }
  const uint64_t nA = hot_count(wa), nB = live_total - nA;

  // COO slots (dual keys first, then sig keys at ud + place), and the
  // super-steps' dictionaries padded to ud and us with distinct
  // out-of-range keys.
  const uint32_t wcs = ceil_log2(std::max(U, 2u));
  const uint64_t n_coo = coo_cell.size();
  std::vector<uint32_t> cs_words(slim_stream_words(n_coo, wcs), 0);
  {
    std::vector<uint16_t> slots(4096 + 32);
    uint32_t pending = 0;
    uint8_t* out = reinterpret_cast<uint8_t*>(cs_words.data());
    uint64_t e = 0;
    for (uint64_t s = 0; s < ns; ++s) {
      const uint16_t* pd = place[0].data() + (s ? key_end[0][s - 1] : 0);
      const uint16_t* ps = place[1].data() + (s ? key_end[1][s - 1] : 0);
      uint64_t e1 = e;
      for (uint64_t q = s * sup_u; q < (s + 1) * sup_u; ++q) e1 += coo_cnt[q];
      for (; e < e1; ++e) {
        const uint32_t cell = coo_cell[e];
        slots[pending++] = uint16_t(cell & kSigCell ? ud + ps[cell & 0xFFF] : pd[cell]);
        if (pending >= 4096) out = slim_pack_words(slots.data(), &pending, wcs, out);
      }
    }
    out = slim_pack_words(slots.data(), &pending, wcs, out);
    slim_pack_tail(slots.data(), pending, wcs, out);
  }
  std::vector<uint32_t> dk_d(ns * ud), dk_s(ns * us);
  for (uint32_t sg = 0; sg < 2; ++sg) {
    const uint32_t u = sg ? us : ud, pad = sg ? n_sig : n_dual + 1;
    uint32_t* dk = sg ? dk_s.data() : dk_d.data();
    for (uint64_t s = 0; s < ns; ++s) {
      const uint32_t b = s ? key_end[sg][s - 1] : 0, k = key_end[sg][s] - b;
      for (uint32_t j = 0; j < u; ++j)
        dk[s * u + j] = j < k ? sorted_keys[sg][b + j] : pad + (j - k);
    }
  }
  // ANL5: the dual table rows are massively redundant (the CABAC-init seed
  // has ~90 distinct (fp,fn,sp,sn) patterns; even a warm snapshot's top 255
  // rows cover ~99%): a u8 row dictionary and exact escape rows instead of
  // 8 dense bytes per row.
  Writer tables;
  if (!share_dual0) write_dual0_rows(tables, dual0);
  if (!share_sig0) write_sig0_sparse(tables, sig0);

  // The layout, sized once; the per-bin sections are written in place.
  const uint64_t nw_hdr = slim_stream_words(n, 4), nwA = slim_stream_words(nA, wa),
                 nwB = slim_stream_words(nB, wb);
  const size_t w0 = w.buf.size();
  w.buf.resize(w0 + 8 + 12 + 8 + 1 + 2 + dict.size() * 2 + 4 + n_esc * 6 + 3 + 8 + nw_hdr * 4 +
               16 + nwA * 4 + 16 + nwB * 4 + n + (dk_d.size() + dk_s.size()) * 4 +
               tables.buf.size() + 8 + coo_cnt.size() * 2 + 8 + cs_words.size() * 4 + n_coo +
               4 + cesc_idx.size() * 8 + (has_probs ? probs.size() * 2 : 0));
  SlimCursor o{w.buf.data() + w0};
  o.u64(n);
  o.u32(uint32_t(ns));
  o.u32(ud);
  o.u32(us);
  o.u64(m);
  o.u8((has_probs ? 1 : 0) | (share_dual0 ? 2 : 0) | (share_sig0 ? 4 : 0));
  o.u16(uint16_t(dict.size()));
  o.bytes(dict.data(), dict.size() * 2);
  o.u32(uint32_t(n_esc));
  uint8_t* esc_idx_at = o.skip(n_esc * 4);
  uint8_t* esc_val_at = o.skip(n_esc * 2);
  o.u8(uint8_t(wa));
  o.u8(uint8_t(wb));
  o.u8(uint8_t(wcs));
  o.u64(nw_hdr);
  uint8_t* hdr_at = o.skip(nw_hdr * 4);
  o.u64(nA);
  o.u64(nwA);
  uint8_t* a_at = o.skip(nwA * 4);
  o.u64(nB);
  o.u64(nwB);
  uint8_t* b_at = o.skip(nwB * 4);
  uint8_t* prior_at = o.skip(n);
  o.bytes(dk_d.data(), dk_d.size() * 4);
  o.bytes(dk_s.data(), dk_s.size() * 4);
  o.bytes(tables.buf.data(), tables.buf.size());
  o.u64(n_coo);
  o.bytes(coo_cnt.data(), coo_cnt.size() * 2);
  o.u64(cs_words.size());
  o.bytes(cs_words.data(), cs_words.size() * 4);
  o.bytes(coo_nib.data(), n_coo);
  o.u32(uint32_t(cesc_idx.size()));
  o.bytes(cesc_idx.data(), cesc_idx.size() * 4);
  o.bytes(cesc_ones.data(), cesc_ones.size() * 2);
  o.bytes(cesc_tot.data(), cesc_tot.size() * 2);
  if (has_probs) o.bytes(probs.data(), probs.size() * 2);

  // Per bin, a sub-batch at a time (its run gives each cell its rank; a
  // prior bin's rank is 0, never cold): the nibble bit << 3 | kind << 1 |
  // cold, two to a byte of the header words; the rank into the hot (wa-bit)
  // or the cold (wb-bit) stream, each packed as its words fill; the prior's
  // dictionary index, or 255 and an escape (the bin's index, its prior).
  {
    const uint32_t cold_at = 1u << wa;
    std::vector<uint16_t> rank_of(2 * kSigCell, 0), hot(batch + 32), cold(batch + 32);
    std::vector<uint8_t> nibs(batch);
    uint16_t* ro = rank_of.data();
    uint32_t n_hot = 0, n_cold = 0;
    uint64_t run = 0, e = 0;
    for (uint64_t b0 = 0; b0 < n; b0 += batch) {
      const uint64_t b1 = std::min<uint64_t>(b0 + batch, n);
      const uint32_t len = coo_cnt[b0 / batch];
      for (uint32_t r = 0; r < len; ++r) ro[coo_cell[run + r]] = uint16_t(r);
      run += len;
      uint16_t* ph = hot.data() + n_hot;
      uint16_t* pc = cold.data() + n_cold;
      uint8_t* nb = nibs.data();
      for (uint64_t i = b0; i < b1; ++i) {
        const uint32_t v = word[i], r = ro[v & 0x1FFF], is_cold = r >= cold_at;
        nb[i - b0] = uint8_t((v >> 12 & 0xE) | is_cold);
        *ph = uint16_t(r);
        ph += (v & 0x6000) != 0x6000 && !is_cold;
        *pc = uint16_t(r);
        pc += is_cold;
        const uint8_t pi = pidx_map[v >> 16];
        prior_at[i] = pi;
        if (pi == 255) {
          const uint32_t idx = uint32_t(i);
          const uint16_t p = uint16_t(v >> 16);
          memcpy(esc_idx_at + 4 * e, &idx, 4);
          memcpy(esc_val_at + 2 * e, &p, 2);
          ++e;
        }
      }
      uint64_t i = b0;
      if (i & 1) hdr_at[i++ >> 1] |= uint8_t(nb[0] << 4);
      for (; i + 1 < b1; i += 2) hdr_at[i >> 1] = uint8_t(nb[i - b0] | nb[i + 1 - b0] << 4);
      if (i < b1) hdr_at[i >> 1] = nb[i - b0];
      n_hot = uint32_t(ph - hot.data());
      n_cold = uint32_t(pc - cold.data());
      a_at = slim_pack_words(hot.data(), &n_hot, wa, a_at);
      b_at = slim_pack_words(cold.data(), &n_cold, wb, b_at);
    }
    slim_pack_tail(hot.data(), n_hot, wa, a_at);
    slim_pack_tail(cold.data(), n_cold, wb, b_at);
  }
}
