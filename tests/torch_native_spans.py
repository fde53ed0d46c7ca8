"""The edits to the port's copy of recode.cc (avrecode_tpu_torch/native) that
record its spans (native/trace.h; avrecode_tpu_torch/trace.py reads them):
each pair is a text of the original (avrecode_tpu/native/recode.cc) and
the text the copy holds in its place, applied in order, each old text
found exactly once. The phases' clock pairs become Phase spans whose
readings the ARTC_TIMING lines print; the session keeps the records and
hands them over through artc_trace_enable and artc_session_trace. The test
that holds the copy to its original is test_torch_host_copy.py."""

RECODE_SPANS = [
    ('#include "bytemodel.h"\n'
     '\n',
     '#include "bytemodel.h"\n'
     '#include "trace.h"\n'
     '\n'),
    ('  std::vector<ParamSet> paramsets;\n'
     '  // MPEG-TS transport (v17): the pipeline codes the reassembled elementary\n',
     '  std::vector<ParamSet> paramsets;\n'
     "  unsigned n_threads = 1;  // the phase-B walk's threads\n"
     '  // MPEG-TS transport (v17): the pipeline codes the reassembled elementary\n'),
    ('  n_workers = std::min<size_t>(n_workers, jobs.size() ? jobs.size() : 1);\n'
     '  std::atomic<size_t> next{0};\n',
     '  n_workers = std::min<size_t>(n_workers, jobs.size() ? jobs.size() : 1);\n'
     '  outp->n_threads = n_workers;\n'
     '  std::atomic<size_t> next{0};\n'),
    ('\n'
     '// Streaming analyze state: background workers walk + export chunks as they\n',
     '\n'
     'using artc::ArtcTraceRecord;\n'
     'using artc::Phase;\n'
     'using artc::SessionTrace;\n'
     '\n'
     '// Streaming analyze state: background workers walk + export chunks as they\n'),
    ('  std::unique_ptr<AnalyzeState> astate;  // live streaming analyze, if any\n'
     '  std::thread pipe;    // probe + chunk-0 pre-analyze (outlives the opener)\n',
     '  std::unique_ptr<AnalyzeState> astate;  // live streaming analyze, if any\n'
     '  SessionTrace trace;  // its spans, if g_trace_on at open\n'
     '  std::thread pipe;    // probe + chunk-0 pre-analyze (outlives the opener)\n'),
    ('static bool session_ready(ArtcSession* s) {\n'
     '  std::unique_lock<std::mutex> l(s->smu);\n'
     '  s->scv.wait(l, [&] { return s->open_done; });\n'
     '  if (!s->open_err.empty()) {\n',
     'static bool session_ready(ArtcSession* s) {\n'
     '  Phase ph(s->trace, "native.ready_wait");\n'
     '  std::unique_lock<std::mutex> l(s->smu);\n'
     '  s->scv.wait(l, [&] { return s->open_done; });\n'
     '  ph.end();\n'
     '  if (!s->open_err.empty()) {\n'),
    ('    s->alpha_off = PriorModel::kSigMixAlphaOff;\n'
     "    // Pipe: probe as soon as chunk 0's extent is known (mid-pass1 on\n",
     '    s->alpha_off = PriorModel::kSigMixAlphaOff;\n'
     '    s->trace.on = artc::g_trace_on.load();\n'
     "    // Pipe: probe as soon as chunk 0's extent is known (mid-pass1 on\n"),
    ('        if (any) {\n'
     '          const auto& sl = *s->prog.slices;\n',
     '        if (any) {\n'
     '          Phase ph(s->trace, "native.nz_probe", 0);\n'
     '          const auto& sl = *s->prog.slices;\n'),
    ('          s->warm.src_slices = multi ? pick_warm_slices_range(sl, 0, e0) : 0;\n'
     '        }\n',
     '          s->warm.src_slices = multi ? pick_warm_slices_range(sl, 0, e0) : 0;\n'
     '          ph.end();\n'
     '        }\n'),
    ('        Stats tmp;\n'
     '        double t0 = timing_enabled() ? now_s() : 0;\n'
     '        run_chunk_model(sl, 0, e0, s->opt, tmp, &trace, &probs, &dual0, modes0,\n',
     '        Stats tmp;\n'
     '        Phase walk(s->trace, "native.trace_walk", 0);\n'
     '        run_chunk_model(sl, 0, e0, s->opt, tmp, &trace, &probs, &dual0, modes0,\n'),
    ('                        alpha0, /*trace_only=*/true);\n'
     '        if (timing_enabled())\n'
     '          fprintf(stderr, "[artc] analyze chunk 0: trace walk %.3fs (%zu bins, pre)\\n",\n'
     '                  now_s() - t0, trace.size());\n'
     '        t0 = timing_enabled() ? now_s() : 0;\n'
     '        Writer cw;\n',
     '                        alpha0, /*trace_only=*/true);\n'
     '        double sec = walk.end(trace.size());\n'
     '        if (timing_enabled())\n'
     '          fprintf(stderr, "[artc] analyze chunk 0: trace walk %.3fs (%zu bins, pre)\\n",\n'
     '                  sec, trace.size());\n'
     '        Phase xport(s->trace, "native.export", 0);\n'
     '        Writer cw;\n'),
    ('                         false, false);\n'
     '        if (timing_enabled())\n'
     '          fprintf(stderr, "[artc] analyze chunk 0: slim export %.3fs (pre, sup %u)\\n",\n'
     '                  now_s() - t0, s->c0_sup);\n'
     '        std::lock_guard<std::mutex> l(s->smu);\n',
     '                         false, false);\n'
     '        sec = xport.end(cw.buf.size());\n'
     '        if (timing_enabled())\n'
     '          fprintf(stderr, "[artc] analyze chunk 0: slim export %.3fs (pre, sup %u)\\n",\n'
     '                  sec, s->c0_sup);\n'
     '        std::lock_guard<std::mutex> l(s->smu);\n'),
    ('      std::string err;\n'
     '      try {\n',
     '      std::string err;\n'
     '      Phase ph(s->trace, "native.pass1");\n'
     '      try {\n'),
    ('      }\n'
     '      bool probed = false;\n',
     '      }\n'
     '      ph.end(s->p1.slices.size(), s->p1.n_threads);\n'
     '      bool probed = false;\n'),
    ('                  sl.unlock();\n'
     '                  double t0 = timing_enabled() ? now_s() : 0;\n'
     '                  Writer cw;\n',
     '                  sl.unlock();\n'
     '                  Phase xport(se->trace, "native.export", 0);\n'
     '                  Writer cw;\n'),
    ('                                   sup_u, false, false);\n'
     '                  if (timing_enabled())\n',
     '                                   sup_u, false, false);\n'
     '                  const double sec = xport.end(cw.buf.size());\n'
     '                  if (timing_enabled())\n'),
    ('                            "sup %u != pre-produced %u)\\n",\n'
     '                            now_s() - t0, sup_u, se->c0_sup);\n'
     '                  buf = std::move(cw.buf);\n',
     '                            "sup %u != pre-produced %u)\\n",\n'
     '                            sec, sup_u, se->c0_sup);\n'
     '                  buf = std::move(cw.buf);\n'),
    ('          Stats tmp;\n'
     '          double t0 = timing_enabled() ? now_s() : 0;\n'
     '          run_chunk_model(se->p1.slices, b, e, se->opt, tmp, &trace, &probs, &dual0,\n',
     '          Stats tmp;\n'
     '          Phase walk(se->trace, "native.trace_walk", int64_t(ci));\n'
     '          run_chunk_model(se->p1.slices, b, e, se->opt, tmp, &trace, &probs, &dual0,\n'),
    ('                          se->alpha_off, /*trace_only=*/!want_probs);\n'
     '          if (timing_enabled())\n'
     '            fprintf(stderr, "[artc] analyze chunk %zu: trace walk %.3fs (%zu bins)\\n",\n'
     '                    ci, now_s() - t0, trace.size());\n'
     '          t0 = timing_enabled() ? now_s() : 0;\n'
     '          // All warm chunks start from the same v16 snapshot: chunks >= 2\n',
     '                          se->alpha_off, /*trace_only=*/!want_probs);\n'
     '          double sec = walk.end(trace.size());\n'
     '          if (timing_enabled())\n'
     '            fprintf(stderr, "[artc] analyze chunk %zu: trace walk %.3fs (%zu bins)\\n",\n'
     '                    ci, sec, trace.size());\n'
     '          Phase xport(se->trace, "native.export", int64_t(ci));\n'
     '          // All warm chunks start from the same v16 snapshot: chunks >= 2\n'),
    ('                           share, share);\n'
     '          if (timing_enabled())\n'
     '            fprintf(stderr, "[artc] analyze chunk %zu: slim export %.3fs\\n",\n'
     '                    ci, now_s() - t0);\n'
     '          std::lock_guard<std::mutex> lock(as->mu);\n',
     '                           share, share);\n'
     '          sec = xport.end(cw.buf.size());\n'
     '          if (timing_enabled())\n'
     '            fprintf(stderr, "[artc] analyze chunk %zu: slim export %.3fs\\n", ci, sec);\n'
     '          std::lock_guard<std::mutex> lock(as->mu);\n'),
    ('  {\n'
     '    std::unique_lock<std::mutex> lock(as->mu);\n'
     '    as->cv.wait(lock, [&] { return as->status[idx] != 0; });\n'
     '    if (as->status[idx] == 2) {\n',
     '  {\n'
     '    Phase wait(se->trace, "native.rendezvous", idx);\n'
     '    std::unique_lock<std::mutex> lock(as->mu);\n'
     '    as->cv.wait(lock, [&] { return as->status[idx] != 0; });\n'
     '    wait.end();\n'
     '    if (as->status[idx] == 2) {\n'),
    ('  }\n'
     '  *out = static_cast<uint8_t*>(malloc(buf.size()));\n',
     '  }\n'
     '  Phase copy(se->trace, "native.copyout", idx);\n'
     '  *out = static_cast<uint8_t*>(malloc(buf.size()));\n'),
    ('  *out_len = buf.size();\n'
     '  return 0;\n',
     '  *out_len = buf.size();\n'
     '  copy.end(buf.size());\n'
     '  return 0;\n'),
    ('      uint64_t modes = se->nz_modes[ci];\n'
     '      double t0 = timing_enabled() ? now_s() : 0;\n'
     '      run_chunk_model(p1.slices, b, e, opt, tmp, &trace, &probs, &dual0, modes,\n',
     '      uint64_t modes = se->nz_modes[ci];\n'
     '      Phase walk(se->trace, "native.dense_walk", int64_t(ci));\n'
     '      run_chunk_model(p1.slices, b, e, opt, tmp, &trace, &probs, &dual0, modes,\n'),
    ('                      se->alpha_off);\n'
     '      if (timing_enabled())\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: trace walk %.3fs (%zu bins)\\n",\n'
     '                ci, now_s() - t0, trace.size());\n'
     '      t0 = timing_enabled() ? now_s() : 0;\n'
     '      w.u64(trace.size());\n',
     '                      se->alpha_off);\n'
     '      const double sec = walk.end(trace.size());\n'
     '      if (timing_enabled())\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: trace walk %.3fs (%zu bins)\\n",\n'
     '                ci, sec, trace.size());\n'
     '      // The export: the streams and prefix counts, then the v2 tables (an\n'
     '      // ARTC_TIMING line each, the first from a reading between them).\n'
     '      Phase xport(se->trace, "native.dense_export", int64_t(ci));\n'
     '      const size_t w0 = w.buf.size();\n'
     '      w.u64(trace.size());\n'),
    ('      }\n'
     '      if (timing_enabled()) {\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: streams+prefix %.3fs\\n", ci, now_s() - t0);\n'
     '        t0 = now_s();\n'
     '      }\n'
     '      for (uint16_t p : probs) w.u16(p);\n',
     '      }\n'
     '      if (timing_enabled())\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: streams+prefix %.3fs\\n", ci,\n'
     '                double(now_ns() - xport.t0) * 1e-9);\n'
     '      const int64_t t_mid = timing_enabled() ? now_ns() : 0;\n'
     '      for (uint16_t p : probs) w.u16(p);\n'),
    ('      write_sig0_sparse(w, sig0);\n'
     '      // ---- model_pass_v2 tables: per-super-step sorted-unique dicts,\n',
     '      write_sig0_sparse(w, sig0);\n'
     '      Phase v2(se->trace, "native.v2_tables", int64_t(ci));\n'
     '      const size_t w1 = w.buf.size();\n'
     '      // ---- model_pass_v2 tables: per-super-step sorted-unique dicts,\n'),
    ('      }\n'
     '      if (timing_enabled())\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: v2 dicts+serialize %.3fs\\n", ci, now_s() - t0);\n'
     '    }\n'
     '    *out = static_cast<uint8_t*>(malloc(w.buf.size()));\n'
     '    memcpy(*out, w.buf.data(), w.buf.size());\n'
     '    *out_len = w.buf.size();\n'
     '    return 0;\n',
     '      }\n'
     '      v2.end(w.buf.size() - w1);\n'
     '      xport.end(w.buf.size() - w0);\n'
     '      if (timing_enabled())\n'
     '        fprintf(stderr, "[artc] analyze chunk %zu: v2 dicts+serialize %.3fs\\n", ci,\n'
     '                double(now_ns() - t_mid) * 1e-9);\n'
     '    }\n'
     '    Phase copy(se->trace, "native.copyout");\n'
     '    *out = static_cast<uint8_t*>(malloc(w.buf.size()));\n'
     '    memcpy(*out, w.buf.data(), w.buf.size());\n'
     '    *out_len = w.buf.size();\n'
     '    copy.end(w.buf.size());\n'
     '    return 0;\n'),
    ('    }\n'
     '    Stats st = se->st;  // copy: pack may run more than once per session\n',
     '    }\n'
     '    Phase ph(se->trace, "native.pack");\n'
     '    Stats st = se->st;  // copy: pack may run more than once per session\n'),
    ('                                se->alpha_off);\n'
     '    *out = static_cast<uint8_t*>(malloc(v.size()));\n'
     '    memcpy(*out, v.data(), v.size());\n'
     '    *out_len = v.size();\n'
     '    fill_stats(st, stats);\n'
     '    return 0;\n',
     '                                se->alpha_off);\n'
     '    *out = static_cast<uint8_t*>(malloc(v.size()));\n'
     '    memcpy(*out, v.data(), v.size());\n'
     '    *out_len = v.size();\n'
     '    fill_stats(st, stats);\n'
     '    ph.end(v.size());\n'
     '    return 0;\n'),
    ('  } catch (const std::exception& e) {\n'
     '    g_error = e.what();\n'
     '    return -1;\n'
     '  }\n'
     '}\n'
     '\n'
     '// One-shot analysis export (opens and closes a session internally).\n',
     '  } catch (const std::exception& e) {\n'
     '    g_error = e.what();\n'
     '    return -1;\n'
     '  }\n'
     '}\n'
     '\n'
     '// Switches span recording for the sessions opened from now on (0 off).\n'
     'void artc_trace_enable(int on) { artc::g_trace_on.store(on != 0); }\n'
     '\n'
     '// Hands over the spans the session recorded since the last call, as\n'
     '// ArtcTraceRecord[*out_len / sizeof(ArtcTraceRecord)] (freed with\n'
     '// artc_free); none (*out null, *out_len 0) when it records none.\n'
     'int artc_session_trace(void* h, uint8_t** out, size_t* out_len) {\n'
     '  auto* se = static_cast<ArtcSession*>(h);\n'
     '  std::vector<ArtcTraceRecord> recs;\n'
     '  {\n'
     '    std::lock_guard<std::mutex> l(se->trace.mu);\n'
     '    recs.swap(se->trace.recs);\n'
     '  }\n'
     '  *out = nullptr;\n'
     '  *out_len = 0;\n'
     '  if (recs.empty()) return 0;\n'
     '  const size_t n = recs.size() * sizeof(ArtcTraceRecord);\n'
     '  *out = static_cast<uint8_t*>(malloc(n));\n'
     '  if (!*out) {\n'
     '    g_error = "out of memory";\n'
     '    return -1;\n'
     '  }\n'
     '  memcpy(*out, recs.data(), n);\n'
     '  *out_len = n;\n'
     '  return 0;\n'
     '}\n'
     '\n'
     '// One-shot analysis export (opens and closes a session internally).\n'),
]
