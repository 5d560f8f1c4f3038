// Flight recorder: the engine-side telemetry subsystem.
//
// The reference's only observability was printk-and-read-dmesg
// (amdp2p.c:57-64) and this repo's Python tracer covered only the
// Python tiers — everything inside the engine (chunk post → wire →
// land → verify → fold → complete, seal NAK/retransmit, copy-pool
// work) was invisible except as aggregate counters bridged after the
// fact. This file is the missing half: a bounded ring of fixed-size
// timestamped events, log2-bucket latency/bandwidth histograms, and a
// unified counter registry, all behind a single TDR_TELEMETRY gate
// whose off state costs one predicted branch per event site.
//
// Concurrency model: producers are the posting threads and each QP's
// progress thread. Events are 40 bytes; recording takes a short
// mutex-protected append (the "drained under the engine lock" option
// the design allows — contention is negligible next to the payload
// copies the instrumented paths perform, and a mutex keeps the drain
// and overwrite-oldest semantics trivially correct under ASan/TSan).
// The ring OVERWRITES OLDEST when full — flight-recorder semantics:
// after an unbounded soak the recent past is what the crash report
// needs — and counts every overwrite in `dropped`.
//
// Clock: CLOCK_MONOTONIC ns, the same clock CPython's time.monotonic()
// reads on Linux, so native and Python events merge with no epoch
// translation.

#include <time.h>

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include "common.h"
#include "tdr/tdr.h"

namespace tdr {

std::atomic<int> g_tel_state{0};

namespace {

constexpr size_t kRingDefault = 65536;
constexpr size_t kRingMin = 1024;
constexpr size_t kRingMax = 4u << 20;

std::mutex g_mu;  // guards the ring, its cursors, and reconfiguration
std::vector<tdr_tel_event> g_ring;
size_t g_head = 0;   // oldest live event
size_t g_count = 0;  // live events in the ring
std::atomic<uint64_t> g_recorded{0};
std::atomic<uint64_t> g_dropped{0};

// Histograms are log-linear ("log2 × 8"): 8 linear sub-buckets per
// power-of-two octave, values 0..15 exact. BENCH_r06 showed why pure
// log2 buckets are not enough: every latency percentile sat at an
// octave upper edge (8191/32767/65535 µs) — the estimate was the
// bucket, not the value. Sub-bucketing bounds the relative error at
// 12.5% while keeping the same O(1) atomic-increment recording; the
// legacy 64-octave read view is derived by folding sub-buckets.
std::atomic<uint64_t> g_hists[TDR_HIST_COUNT][TDR_HIST_FINE_BUCKETS];

std::atomic<uint32_t> g_next_engine{0};
std::atomic<uint32_t> g_next_qp{0};

size_t ring_capacity_env() {
  const char *env = getenv("TDR_TELEMETRY_RING");
  if (env && *env) {
    long long v = atoll(env);
    if (v >= static_cast<long long>(kRingMin))
      return static_cast<size_t>(
          v > static_cast<long long>(kRingMax) ? kRingMax : v);
    if (v > 0) return kRingMin;  // clamp UP, like TDR_TRACE_RING
  }
  return kRingDefault;
}

int bucket_of(uint64_t v) {
  // Octave index: bucket 0 holds zeros; bucket b (1..63) holds
  // [2^(b-1), 2^b) — i.e. b = bit_length(v), mirroring Python's
  // int.bit_length(). Values with bit 63 set would index bucket 64:
  // clamp into the last bucket instead of storing past the row.
  int b = v ? 64 - __builtin_clzll(v) : 0;
  return b > 63 ? 63 : b;
}

// Fine (log-linear) bucket: values < 16 index themselves; above that,
// the 3 bits below the MSB select one of 8 linear sub-buckets inside
// the value's octave. Contiguous: v=15 -> 15, v=16 -> 16.
int fine_bucket_of(uint64_t v) {
  if (v < 16) return static_cast<int>(v);
  int b = 64 - __builtin_clzll(v);  // bit_length, >= 5
  int sub = static_cast<int>((v >> (b - 4)) & 7);
  int idx = (b - 4) * 8 + 8 + sub;
  return idx >= TDR_HIST_FINE_BUCKETS ? TDR_HIST_FINE_BUCKETS - 1 : idx;
}

// Inclusive upper edge of a fine bucket (the conservative percentile
// estimate the Python side mirrors byte-for-byte).
uint64_t fine_upper_of(int idx) {
  if (idx < 16) return idx < 0 ? 0 : static_cast<uint64_t>(idx);
  int b = (idx - 8) / 8 + 4;       // octave (bit_length of members)
  int sub = (idx - 8) % 8;
  // Members are [ (8+sub) << (b-4), (8+sub+1) << (b-4) ); the << can
  // reach 2^64 at the top octave — unsigned wrap makes the -1 yield
  // UINT64_MAX, which is exactly the intended edge.
  return (static_cast<uint64_t>(8 + sub + 1) << (b - 4)) - 1;
}

// Octave a fine bucket belongs to — the legacy 64-bucket fold
// (buckets below 16 hold exact values, so their octave is bucket_of
// of the value itself). Clamped at 63 like bucket_of: the top fine
// buckets (bit-length-64 values) must fold into the last octave row,
// not index out[64] past the caller's array.
int fine_to_octave(int idx) {
  if (idx < 16) return bucket_of(static_cast<uint64_t>(idx));
  int oct = (idx - 8) / 8 + 4;
  return oct > 63 ? 63 : oct;
}

const char *kEventNames[] = {
    "none",       "post_send", "post_recv", "post_write", "post_read",
    "wire_tx",    "wire_rx",   "land",      "verify_ok",  "verify_fail",
    "nak",        "retx",      "fold",      "wc",         "copy_enq",
    "copy_run",   "ring_begin", "ring_end", "fold_off",   "shard",
    "fault_injected",
};
constexpr int kEventCount =
    static_cast<int>(sizeof(kEventNames) / sizeof(kEventNames[0]));

const char *kHistNames[TDR_HIST_COUNT] = {
    "chunk_lat_us", "chunk_bytes", "copy_bytes", "ring_lat_us", "ring_MBps",
};

}  // namespace

int tel_state_init() {
  std::lock_guard<std::mutex> g(g_mu);
  int s = g_tel_state.load(std::memory_order_relaxed);
  if (s != 0) return s;
  s = env_set("TDR_TELEMETRY") ? 2 : 1;
  if (s == 2 && g_ring.empty()) g_ring.resize(ring_capacity_env());
  g_tel_state.store(s, std::memory_order_release);
  return s;
}

uint64_t tel_now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
         static_cast<uint64_t>(ts.tv_nsec);
}

void tel_emit(uint16_t type, uint16_t engine, uint32_t qp, uint64_t id,
              uint64_t arg, uint64_t coll) {
  tdr_tel_event ev{tel_now_ns(), type, engine, qp, id, arg, coll};
  std::lock_guard<std::mutex> g(g_mu);
  if (g_ring.empty()) return;  // reset raced a producer: drop quietly
  size_t cap = g_ring.size();
  if (g_count == cap) {
    g_ring[g_head] = ev;  // overwrite oldest
    g_head = (g_head + 1) % cap;
    g_dropped.fetch_add(1, std::memory_order_relaxed);
  } else {
    g_ring[(g_head + g_count) % cap] = ev;
    g_count++;
  }
  g_recorded.fetch_add(1, std::memory_order_relaxed);
}

void tel_hist_add(int which, uint64_t value) {
  if (which < 0 || which >= TDR_HIST_COUNT) return;
  g_hists[which][fine_bucket_of(value)].fetch_add(
      1, std::memory_order_relaxed);
}

uint16_t tel_next_engine_id() {
  return static_cast<uint16_t>(
      g_next_engine.fetch_add(1, std::memory_order_relaxed) + 1);
}

uint32_t tel_next_qp_id() {
  return g_next_qp.fetch_add(1, std::memory_order_relaxed) + 1;
}

uint32_t tel_thread_track() {
  // One lane per helper thread, drawn lazily from the QP track space
  // the first time the thread emits — fold workers and progress
  // shards get stable exported lanes without pre-registration.
  thread_local uint32_t track = tel_next_qp_id();
  return track;
}

}  // namespace tdr

extern "C" {

int tdr_tel_enabled(void) { return tdr::tel_on() ? 1 : 0; }

void tdr_tel_reset(void) {
  std::lock_guard<std::mutex> g(tdr::g_mu);
  tdr::g_tel_state.store(0, std::memory_order_relaxed);
  int s = tdr::env_set("TDR_TELEMETRY") ? 2 : 1;
  tdr::g_ring.clear();
  if (s == 2) tdr::g_ring.resize(tdr::ring_capacity_env());
  tdr::g_head = 0;
  tdr::g_count = 0;
  tdr::g_recorded.store(0, std::memory_order_relaxed);
  tdr::g_dropped.store(0, std::memory_order_relaxed);
  for (auto &h : tdr::g_hists)
    for (auto &b : h) b.store(0, std::memory_order_relaxed);
  tdr::g_tel_state.store(s, std::memory_order_release);
}

uint64_t tdr_tel_now_ns(void) { return tdr::tel_now_ns(); }

int tdr_tel_drain(tdr_tel_event *out, int max) {
  if (!out || max <= 0) return 0;
  std::lock_guard<std::mutex> g(tdr::g_mu);
  size_t cap = tdr::g_ring.size();
  int n = 0;
  while (n < max && tdr::g_count > 0) {
    out[n++] = tdr::g_ring[tdr::g_head];
    tdr::g_head = (tdr::g_head + 1) % cap;
    tdr::g_count--;
  }
  return n;
}

uint64_t tdr_tel_recorded(void) {
  return tdr::g_recorded.load(std::memory_order_relaxed);
}

uint64_t tdr_tel_dropped(void) {
  return tdr::g_dropped.load(std::memory_order_relaxed);
}

const char *tdr_tel_event_name(int type) {
  return (type >= 0 && type < tdr::kEventCount) ? tdr::kEventNames[type]
                                                : "unknown";
}

int tdr_tel_hist_count(void) { return TDR_HIST_COUNT; }

const char *tdr_tel_hist_name(int which) {
  return (which >= 0 && which < TDR_HIST_COUNT) ? tdr::kHistNames[which]
                                                : "unknown";
}

void tdr_tel_hist_read(int which, uint64_t out[64]) {
  // Legacy 64-octave view, derived by folding the fine sub-buckets —
  // existing consumers (tdr_top sparklines, /metrics quantiles) keep
  // their shape; percentile consumers should read the fine view.
  if (!out) return;
  memset(out, 0, 64 * sizeof(uint64_t));
  if (which < 0 || which >= TDR_HIST_COUNT) return;
  for (int b = 0; b < TDR_HIST_FINE_BUCKETS; b++) {
    uint64_t c = tdr::g_hists[which][b].load(std::memory_order_relaxed);
    if (c) out[tdr::fine_to_octave(b)] += c;
  }
}

int tdr_tel_hist_fine_buckets(void) { return TDR_HIST_FINE_BUCKETS; }

uint64_t tdr_tel_hist_fine_upper(int idx) { return tdr::fine_upper_of(idx); }

int tdr_tel_hist_read_fine(int which, uint64_t *out, int max) {
  if (!out || max <= 0) return 0;
  int n = max < TDR_HIST_FINE_BUCKETS ? max : TDR_HIST_FINE_BUCKETS;
  if (which < 0 || which >= TDR_HIST_COUNT) {
    memset(out, 0, static_cast<size_t>(n) * sizeof(uint64_t));
    return n;
  }
  for (int b = 0; b < n; b++)
    out[b] = tdr::g_hists[which][b].load(std::memory_order_relaxed);
  return n;
}

int tdr_tel_engine_id(const tdr_engine *e) {
  return e ? reinterpret_cast<const tdr::Engine *>(e)->tel_id : 0;
}

int tdr_tel_qp_id(const tdr_qp *qp) {
  return qp ? static_cast<int>(reinterpret_cast<const tdr::Qp *>(qp)->tel_id)
            : 0;
}

/* ------------------------------------------------------------------ *
 * Counter registry: the one native surface every engine-side counter
 * lives behind. Each entry is a named getter over the subsystem's own
 * atomics — registering here does not move the counter, it unifies
 * how it is read (one call, one consistent snapshot, stable names).
 * ------------------------------------------------------------------ */

namespace {

const char *kCounterNames[] = {
    "integrity.sealed",   "integrity.verified", "integrity.failed",
    "integrity.retransmitted", "fault.seen",    "fault.hits",
    "copy.nt_bytes",      "copy.plain_bytes",   "telemetry.recorded",
    "telemetry.dropped",  "fold.jobs",          "fold.busy_us",
    "fold.pending",       "progress.shards",    "progress.wakeups",
    "progress.wc",        "probe.sent",         "probe.pong",
    "probe.timeout",
};
constexpr int kRegistryCount =
    static_cast<int>(sizeof(kCounterNames) / sizeof(kCounterNames[0]));

// One pass per subsystem: counters that share a producer lock (the
// fault clauses) or a producer call (the copy tiers) are read
// TOGETHER, so a snapshot can never show impossible relations like
// hits > seen. Counters from different subsystems are still
// individually-atomic monotonic reads, not a global freeze.
void read_all(uint64_t out[kRegistryCount]) {
  for (int i = 0; i < 4; i++) out[i] = tdr::seal_counter(i);
  tdr::fault_totals(&out[4], &out[5]);
  tdr::copy_counters(&out[6], &out[7]);
  out[8] = tdr::g_recorded.load(std::memory_order_relaxed);
  out[9] = tdr::g_dropped.load(std::memory_order_relaxed);
  out[10] = tdr::fold_jobs();
  out[11] = tdr::fold_busy_us();
  out[12] = tdr::fold_pending();
  tdr::progress_counters(&out[13], &out[14], &out[15]);
  for (int i = 0; i < 3; i++) out[16 + i] = tdr::probe_counter(i);
}

}  // namespace

int tdr_counter_count(void) { return kRegistryCount; }

const char *tdr_counter_name(int idx) {
  return (idx >= 0 && idx < kRegistryCount) ? kCounterNames[idx] : "";
}

int tdr_counters_read(uint64_t *out, int max) {
  if (!out || max <= 0) return 0;
  uint64_t vals[kRegistryCount];
  read_all(vals);
  int n = max < kRegistryCount ? max : kRegistryCount;
  for (int i = 0; i < n; i++) out[i] = vals[i];
  return n;
}

}  // extern "C"
