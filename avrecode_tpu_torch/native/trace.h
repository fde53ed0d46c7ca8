// Span recording of the port's host engine (artc_trace_enable,
// artc_session_trace in recode.cc): the records a session keeps, one per
// phase per chunk, and the clock they read. The clock is
// std::chrono::steady_clock, CLOCK_MONOTONIC under libstdc++ on Linux: the
// clock of Python's time.monotonic_ns(), so native and Python spans share
// one timeline.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <sys/syscall.h>
#include <unistd.h>

namespace artc {

static bool timing_enabled();  // ARTC_TIMING (recode.cc)

static std::atomic<bool> g_trace_on{false};

static int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static int64_t thread_id() {
  static thread_local const int64_t tid = int64_t(syscall(SYS_gettid));
  return tid;
}

// One span as artc_session_trace hands it over (72 bytes, no padding).
struct ArtcTraceRecord {
  char name[24];     // NUL-terminated
  int64_t start_ns;  // steady_clock
  int64_t end_ns;
  int64_t thread;    // the OS thread id (gettid)
  int64_t chunk;     // chunk index, or -1
  uint64_t count;    // bins (trace walk), slices (pass 1), bytes (export, copy-out)
  uint64_t count2;   // pass 1's thread count; 0 elsewhere
};
static_assert(sizeof(ArtcTraceRecord) == 72, "the ABI's record size");

// A session's spans: appended once per phase (per chunk) from any of its
// threads; `on` is fixed when the session opens.
struct SessionTrace {
  bool on = false;
  std::mutex mu;
  std::vector<ArtcTraceRecord> recs;
  void add(const char* name, int64_t t0, int64_t t1, int64_t chunk, uint64_t count,
           uint64_t count2) {
    if (!on) return;
    ArtcTraceRecord r{};
    strncpy(r.name, name, sizeof(r.name) - 1);
    r.start_ns = t0;
    r.end_ns = t1;
    r.thread = thread_id();
    r.chunk = chunk;
    r.count = count;
    r.count2 = count2;
    std::lock_guard<std::mutex> l(mu);
    recs.push_back(r);
  }
};

// One phase: its two clock readings, taken when the session records spans
// or ARTC_TIMING is set; end() records the span and returns its seconds,
// which the ARTC_TIMING lines print.
struct Phase {
  SessionTrace& tr;
  const char* name;
  int64_t chunk;
  int64_t t0 = 0;
  Phase(SessionTrace& tr, const char* name, int64_t chunk = -1)
      : tr(tr), name(name), chunk(chunk) {
    if (tr.on || timing_enabled()) t0 = now_ns();
  }
  double end(uint64_t count = 0, uint64_t count2 = 0) {
    if (!(tr.on || timing_enabled())) return 0;
    const int64_t t1 = now_ns();
    tr.add(name, t0, t1, chunk, count, count2);
    return double(t1 - t0) * 1e-9;
  }
};

}  // namespace artc
