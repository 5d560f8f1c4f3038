// Ring allreduce over the engine: reduce-scatter + all-gather.
//
// The reference stops at the transport (its consumers were MPI apps on
// IB Verbs, README.md:64); this file is the in-framework consumer that
// BASELINE.md configs 3-4 require — the collective that cross-slice
// gradient sync rides. Buffers are registered once per (buffer, ring)
// pair and cached, preserving the reference's front-loaded-registration
// invariant: steady-state steps post work requests only.
//
// Large segments are split into chunks (TDR_RING_CHUNK, default 4 MiB)
// with a small window of pre-posted receives, so the wire transfer of
// chunk i+1 overlaps the reduction of chunk i and the link never idles
// behind the ALU.
//
// Multi-channel striping (tdr_ring_create_channels): the ring may hold
// TDR_RING_CHANNELS independent QPs per neighbor; every striped
// schedule routes chunk i over channel i % channels, so the wire
// transfer, seal verification, and fold of CONSECUTIVE chunks run on
// independent progress engines instead of serializing on one QP's
// thread. FIFO recv matching holds per channel (both sides stripe by
// the same index rule, and channel c here is connected to channel c
// on the neighbor by bootstrap construction); cross-channel completion
// order is arbitrary, so the schedules track per-stream done-masks and
// use the in-order completed PREFIX wherever a dependency needs
// "everything before me landed". Scratch-window folds are handed to
// the fold-offload pool (TDR_FOLD_THREADS, copy_pool.cc) so the poll
// loop keeps posting while predecessors fold; the scratch window is
// sized at two slots per channel — a chunk can land while its
// predecessor on the same channel is still folding.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.h"
#include "tdr/tdr.h"

namespace {

// 4 MiB (was 8): striping needs at least `channels` chunks per ring
// segment to engage, and the finer grain pipelines land/fold/verify
// better on every schedule — measured on the bench host: world-2
// +25% median, world-4 best-median config (chunks below ~1 MiB start
// paying per-frame overhead instead). TDR_RING_CHUNK still overrides.
constexpr size_t kDefaultChunk = 4u << 20;
constexpr int kWindow = 4;  // pre-posted recv slots per step
// Cap on work requests in flight per direction, below the verbs
// backend's QP depth (max_send_wr/max_recv_wr = 512) with headroom —
// tiny TDR_RING_CHUNK values otherwise overflow ibv_post_* on large
// segments (the emu backend's unbounded queues would hide that).
constexpr size_t kMaxOutstanding = 256;

// Recv-window bound for reduce-recvs on a QP: engines that stage
// reduce-on-receive through bounded slots (verbs) advertise a budget
// via tdr_qp_rr_window; 0 means unbounded (emu folds off the wire).
size_t reduce_recv_window(tdr_qp *qp) {
  size_t w = tdr_qp_rr_window(qp);
  return w ? std::min(w, kMaxOutstanding) : kMaxOutstanding;
}

size_t ring_chunk_bytes() {
  const char *env = getenv("TDR_RING_CHUNK");
  if (env && *env) {
    long long v = atoll(env);
    if (v >= 4096) return static_cast<size_t>(v);
  }
  return kDefaultChunk;
}

using tdr::dtype_size;
using tdr::reduce_any;
using tdr::ring_timeout_ms;

// Human-readable WC status for the completion-error messages: the
// Python taxonomy keys off both the numeric status and message
// markers, and "integrity" must be visible to operators without a
// decoder ring.
const char *wc_status_name(int st) {
  switch (st) {
    case TDR_WC_SUCCESS:
      return "success";
    case TDR_WC_REM_ACCESS_ERR:
      return "rem_access_err";
    case TDR_WC_LOC_ACCESS_ERR:
      return "loc_access_err";
    case TDR_WC_FLUSH_ERR:
      return "flush_err";
    case TDR_WC_GENERAL_ERR:
      return "general_err";
    case TDR_WC_INTEGRITY_ERR:
      return "integrity_err";
    default:
      return "unknown";
  }
}

std::string wc_status_label(int st) {
  return std::to_string(st) + " (" + wc_status_name(st) + ")";
}

// wr_id tags for the pipeline: high 16 bits the kind, low bits the
// chunk index, so one poll loop can route recv completions (in posted
// order) and send acks (order-independent, only counted).
constexpr uint64_t kWrRecv = 0x5245ull << 48;
constexpr uint64_t kWrSend = 0x5345ull << 48;
constexpr uint64_t kWrKindMask = 0xffffull << 48;

// Flight recorder: per-collective call ordinal (process-wide) so
// ring_begin/ring_end pair up in the exported timeline.
std::atomic<uint64_t> g_ring_call_seq{0};

// Sharded progress engine accounting (registry progress.*): shard
// threads launched, idle wakeups, completions consumed on shards.
std::atomic<uint64_t> g_prog_shards{0};
std::atomic<uint64_t> g_prog_wakeups{0};
std::atomic<uint64_t> g_prog_wc{0};

// Bracket one collective call: RING_BEGIN/RING_END events plus the
// whole-collective latency and bandwidth histograms. Zero-cost when
// telemetry is off (the ctor takes the one-branch guard and leaves
// every field 0). Return paths route through finish(rc) to record
// the true status; the destructor is the backstop — a path that
// skips finish still emits a (failed) RING_END, so begin/end events
// always pair in exported timelines.
struct RingTelScope {
  uint16_t eng = 0;
  uint64_t seq = 0;
  uint64_t nbytes = 0;
  uint64_t t0 = 0;
  uint64_t coll = 0;
  bool done = false;
  RingTelScope(tdr_ring *r, uint64_t bytes);
  void record(int rc) {
    done = true;
    uint64_t dt_ns = tdr::tel_now_ns() - t0;
    tdr::tel_emit(TDR_TEL_RING_END, eng, 0, seq, rc == 0 ? 0 : 1, coll);
    tdr::tel_hist_add(TDR_HIST_RING_LAT_US, dt_ns / 1000);
    if (rc == 0 && dt_ns > 0)
      tdr::tel_hist_add(TDR_HIST_RING_MBPS, nbytes * 1000 / dt_ns);
  }
  int finish(int rc) {
    if (t0 && !done) record(rc);
    return rc;
  }
  ~RingTelScope() {
    if (t0 && !done) record(-1);
  }
};

}  // namespace

namespace tdr {

// Resolved progress-shard count for a `channels`-channel ring
// (TDR_PROGRESS_SHARDS). 0 = the legacy single-poll loop. Default:
// one shard per channel — the DMA-streaming model of one progress
// engine per buffer chain — capped at the host's usable cores, and 0
// on a 1-core host: shards win by polling in parallel with posting,
// and a single core can only interleave them with context switches
// (measured 5-10% WORSE than the inline loop — the same 1-core rule
// the fold pool applies). Per-PROCESS execution strategy, never
// negotiated and never in the schedule digest: any mix of shard
// counts across ranks is wire-compatible and bitwise-identical.
// Parsed per collective (getenv is nanoseconds next to an MB-scale
// collective) so tests may flip the knob between worlds.
size_t progress_shards_for(size_t channels) {
  if (channels < 1) channels = 1;
  const char *env = getenv("TDR_PROGRESS_SHARDS");
  if (env && *env) {
    long v = atol(env);
    if (v <= 0) return 0;
    return std::min(static_cast<size_t>(v), channels);
  }
  size_t cores = usable_cores();
  if (cores <= 1) return 0;
  return std::min(channels, cores);
}

void progress_counters(uint64_t *shards, uint64_t *wakeups, uint64_t *wc) {
  if (shards) *shards = g_prog_shards.load(std::memory_order_relaxed);
  if (wakeups) *wakeups = g_prog_wakeups.load(std::memory_order_relaxed);
  if (wc) *wc = g_prog_wc.load(std::memory_order_relaxed);
}

}  // namespace tdr

struct tdr_ring {
  tdr_engine *eng;
  // Channel 0 aliases: the chain collectives (reduce/broadcast/
  // alltoall — inherently order-dependent store-and-forward pipelines)
  // and the digest-era callers run on channel 0; the striped
  // schedules use the full vectors.
  tdr_qp *left;   // receive from
  tdr_qp *right;  // send to
  std::vector<tdr_qp *> lefts, rights;  // lefts[c] pairs with the
                                        // neighbor's rights[c]
  int rank;
  int world;
  size_t chunk = kDefaultChunk;
  int last_sched = TDR_SCHED_NONE;
  std::vector<char> tmp;
  tdr_mr *tmp_mr = nullptr;
  // MRs for buffers the CALLER promised stable (tdr_ring_register) —
  // the front-loaded-registration fast path. Arbitrary buffers are
  // registered per call instead: a VA-keyed implicit cache would hand
  // out stale pins when an address gets recycled by the allocator
  // (the underlying physical pages of a dead buffer, not the new one).
  std::unordered_map<uint64_t, tdr_mr *> registered;
  // Keys of ADOPTED entries (tdr_ring_adopt_mr): the MR is owned by
  // the caller (a dma-buf MR over device memory); never dereg it here.
  std::unordered_set<uint64_t> borrowed;
  std::mutex mu;

  // Returns the MR and whether it is borrowed (cached) or owned by
  // this call (must be deregistered before returning).
  tdr_mr *data_mr(void *base, size_t len, bool *owned) {
    uint64_t key = reinterpret_cast<uint64_t>(base);
    auto it = registered.find(key);
    if (it != registered.end() && tdr_mr_len(it->second) >= len) {
      *owned = false;
      return it->second;
    }
    *owned = true;
    return tdr_reg_mr(eng, base, len, 0);
  }

  tdr_mr *scratch(size_t len) {
    if (tmp.size() < len || !tmp_mr) {
      if (tmp_mr) {
        tdr_dereg_mr(tmp_mr);
        tmp_mr = nullptr;
      }
      tmp.resize(len);
      tmp_mr = tdr_reg_mr(eng, tmp.data(), tmp.size(), 0);
    }
    return tmp_mr;
  }

  // Collective trace ids (fleet tracing). next_coll: the id the
  // CALLER stamped for the next collective (tdr_ring_set_coll;
  // sticky, captured at blocking entry or async submission).
  // auto_coll: fallback counter for rings whose caller never stamps —
  // auto ids carry bit 63 so the two id spaces never collide.
  // cur_coll: the id of the collective currently RUNNING on this ring
  // (what the fold/fold_off event sites read).
  std::atomic<uint64_t> next_coll{0};
  std::atomic<uint64_t> auto_coll{0};
  std::atomic<uint64_t> cur_coll{0};

  // Async driver (tdr_ring_start): one dedicated thread per ring,
  // spawned at the first start and joined at destroy, executing
  // queued ops strictly in submission order — submission order IS the
  // SPMD contract, and serializing on this one thread keeps the wire
  // sequence identical to back-to-back blocking calls. After any
  // failure the driver fails the remaining queue fast (the ring is
  // suspect; the recovery ladder replaces it at rebuild) instead of
  // posting into a broken ring and eating a stall deadline per op.
  std::mutex amu;
  std::condition_variable acv;
  std::deque<tdr_ring_op *> aq;
  std::thread adrv;
  bool adrv_up = false;   // under amu
  bool astop = false;     // under amu
  bool afailed = false;   // under amu: sticky for this ring's lifetime
  std::string aerr;       // under amu
};

// Handle for one nonblocking collective (tdr_ring_start). Owned by
// the caller; the driver only writes it under op->mu and never
// touches it after marking done, so freeing a COMPLETED op is race-
// free. tdr_ring_op_free on a pending op blocks until completion
// (every op terminates — the stall deadline bounds a wedged ring).
struct tdr_ring_op {
  void *data = nullptr;
  size_t count = 0;
  int dtype = 0;
  int red_op = 0;
  // Which collective the driver runs for this op: the async surface
  // covers the allreduce AND its standalone phases (the hierarchical
  // schedule chains reduce-scatter → delegate allreduce → all-gather
  // through these handles), plus the int8 wire-compressed allreduce.
  enum {
    kAllreduce = 0,
    kReduceScatter = 1,
    kAllGather = 2,
    kAllreduceQ8 = 3
  };
  int kind = kAllreduce;
  // kAllreduceQ8 only: the per-bucket symmetric scale the caller
  // quantized with, and the f32 output buffer the dequantized result
  // lands in (both ride the op because the driver runs it later).
  float scale_in = 0.0f;
  float *f32_out = nullptr;
  // Collective trace id captured at SUBMISSION (the caller stamps the
  // ring, then starts): the driver re-arms it when the op actually
  // runs, so a queue of bucketed ops keeps per-op ids whatever the
  // interleaving of set_coll calls for later submissions.
  uint64_t coll = 0;
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;  // under mu
  int rc = 0;         // under mu
  std::string err;    // under mu
};

namespace {

// Driver-forced collective id: the async driver hands each op's
// captured id to the blocking collective it runs on its own thread —
// a thread-local, so it can never race a caller thread's
// set_coll/start pair for a LATER op.
thread_local uint64_t t_forced_coll = 0;

// Resolve the collective trace id for a collective that is starting:
// the driver's forced id, else the caller-stamped next_coll, else an
// auto id (bit 63 set — disjoint from caller-stamped ids).
uint64_t take_coll(tdr_ring *r) {
  uint64_t v = t_forced_coll;
  if (v) {
    t_forced_coll = 0;
    return v;
  }
  v = r->next_coll.load(std::memory_order_relaxed);
  if (v) return v;
  return (1ull << 63) |
         (r->auto_coll.fetch_add(1, std::memory_order_relaxed) + 1);
}

void op_complete(tdr_ring_op *op, int rc, const std::string &err) {
  {
    std::lock_guard<std::mutex> g(op->mu);
    op->rc = rc;
    op->err = err;
    op->done = true;
  }
  op->cv.notify_all();
}

// The ring's async driver thread: pop in submission order, run the
// blocking collective, publish the result on the handle. Thread-local
// errors are bridged onto the HANDLE here — the waiting thread could
// never read this thread's tdr_last_error slot.
void async_driver(tdr_ring *r) {
  for (;;) {
    tdr_ring_op *op = nullptr;
    bool failed = false;
    std::string ferr;
    {
      std::unique_lock<std::mutex> lk(r->amu);
      r->acv.wait(lk, [&] { return r->astop || !r->aq.empty(); });
      if (r->aq.empty()) return;  // astop and drained
      op = r->aq.front();
      r->aq.pop_front();
      failed = r->afailed;
      if (failed) ferr = r->aerr;
    }
    if (failed) {
      op_complete(op, -1,
                  "ring async: aborted after earlier failure (" + ferr +
                      ")");
      continue;
    }
    int rc;
    t_forced_coll = op->coll;  // submission-time id, re-armed at run
    switch (op->kind) {
      case tdr_ring_op::kReduceScatter:
        rc = tdr_ring_reduce_scatter(r, op->data, op->count, op->dtype,
                                     op->red_op, nullptr, nullptr);
        break;
      case tdr_ring_op::kAllGather:
        rc = tdr_ring_all_gather(r, op->data, op->count, op->dtype);
        break;
      case tdr_ring_op::kAllreduceQ8:
        rc = tdr_ring_allreduce_q8(r, op->data, op->count, op->scale_in,
                                   op->f32_out);
        break;
      default:
        rc = tdr_ring_allreduce(r, op->data, op->count, op->dtype,
                                op->red_op);
    }
    std::string err = rc == 0 ? std::string() : tdr::get_error();
    if (rc != 0) {
      std::lock_guard<std::mutex> g(r->amu);
      r->afailed = true;
      r->aerr = err;
    }
    op_complete(op, rc, err);
  }
}

// Stop the driver and fail whatever it never started. Pending ops are
// completed with a retryable-classed error (teardown mid-flight is a
// transient, exactly like a connection drop) — never silently
// dropped, so a waiting thread always wakes.
void async_stop(tdr_ring *r) {
  std::deque<tdr_ring_op *> orphans;
  bool join = false;
  {
    std::lock_guard<std::mutex> g(r->amu);
    r->astop = true;
    orphans.swap(r->aq);
    join = r->adrv_up;
  }
  r->acv.notify_all();
  for (tdr_ring_op *op : orphans)
    op_complete(op, -1,
                "ring destroyed (connection down for pending async op)");
  if (join) {
    r->adrv.join();
    std::lock_guard<std::mutex> g(r->amu);
    r->adrv_up = false;
  }
}

}  // namespace

namespace {
RingTelScope::RingTelScope(tdr_ring *r, uint64_t bytes) {
  if (!tdr::tel_on()) return;
  eng = reinterpret_cast<tdr::Engine *>(r->eng)->tel_id;
  seq = g_ring_call_seq.fetch_add(1, std::memory_order_relaxed) + 1;
  nbytes = bytes;
  // Resolve and propagate the collective trace id: the ring remembers
  // it for the fold event sites, and every neighbor QP's posting path
  // (and, FEAT_COLL_ID negotiated, its outbound frame headers) stamps
  // it until the next collective re-stamps. One store per QP per
  // collective — noise next to the MB-scale transfers it labels.
  coll = take_coll(r);
  r->cur_coll.store(coll, std::memory_order_relaxed);
  for (tdr_qp *q : r->lefts)
    reinterpret_cast<tdr::Qp *>(q)->cur_coll.store(
        coll, std::memory_order_relaxed);
  for (tdr_qp *q : r->rights)
    reinterpret_cast<tdr::Qp *>(q)->cur_coll.store(
        coll, std::memory_order_relaxed);
  t0 = tdr::tel_now_ns();
  tdr::tel_emit(TDR_TEL_RING_BEGIN, eng, 0, seq, nbytes, coll);
}
}  // namespace

extern "C" {

tdr_ring *tdr_ring_create_channels(tdr_engine *e, tdr_qp *const *lefts,
                                   tdr_qp *const *rights, int channels,
                                   int rank, int world) {
  if (!e || !lefts || !rights || channels < 1 || world < 2 || rank < 0 ||
      rank >= world) {
    tdr::set_error("ring_create: bad topology");
    return nullptr;
  }
  for (int c = 0; c < channels; c++) {
    if (!lefts[c] || !rights[c]) {
      tdr::set_error("ring_create: null channel QP");
      return nullptr;
    }
  }
  // Capability skew across channels would desynchronize a striped
  // schedule mid-collective (chunk i fused, chunk i+1 not): all
  // channels to one neighbor must have negotiated identical features.
  // Same peer + same env makes this true in practice; a half-failed
  // handshake is caught here instead of as a wedged collective.
  for (int c = 1; c < channels; c++) {
    if (tdr_qp_has_recv_reduce(lefts[c]) !=
            tdr_qp_has_recv_reduce(lefts[0]) ||
        tdr_qp_has_send_foldback(rights[c]) !=
            tdr_qp_has_send_foldback(rights[0]) ||
        tdr_qp_has_send_foldback(lefts[c]) !=
            tdr_qp_has_send_foldback(lefts[0]) ||
        tdr_qp_has_fused2(lefts[c]) != tdr_qp_has_fused2(lefts[0]) ||
        tdr_qp_has_fused2(rights[c]) != tdr_qp_has_fused2(rights[0]) ||
        tdr_qp_has_seal(lefts[c]) != tdr_qp_has_seal(lefts[0]) ||
        tdr_qp_has_seal(rights[c]) != tdr_qp_has_seal(rights[0])) {
      tdr::set_error("ring_create: channel " + std::to_string(c) +
                     " negotiated different capabilities than channel 0");
      return nullptr;
    }
  }
  auto *r = new tdr_ring();
  r->eng = e;
  r->lefts.assign(lefts, lefts + channels);
  r->rights.assign(rights, rights + channels);
  r->left = r->lefts[0];
  r->right = r->rights[0];
  r->rank = rank;
  r->world = world;
  r->chunk = ring_chunk_bytes();
  // Stamp link identity on every channel QP: netem riders scope by
  // (lane, rank, peer) and stall/health attribution reads the same
  // labels. Ring neighbors: left = rank-1, right = rank+1 (mod world).
  for (int c = 0; c < channels; c++) {
    tdr_qp_set_link(r->lefts[c], c, rank, (rank + world - 1) % world);
    tdr_qp_set_link(r->rights[c], c, rank, (rank + 1) % world);
  }
  return r;
}

tdr_ring *tdr_ring_create(tdr_engine *e, tdr_qp *left, tdr_qp *right,
                          int rank, int world) {
  return tdr_ring_create_channels(e, &left, &right, 1, rank, world);
}

int tdr_ring_channels(const tdr_ring *r) {
  return r ? static_cast<int>(r->lefts.size()) : 0;
}

size_t tdr_ring_chunk_bytes(void) { return ring_chunk_bytes(); }

void tdr_ring_set_coll(tdr_ring *r, uint64_t coll_id) {
  if (r) r->next_coll.store(coll_id, std::memory_order_relaxed);
}

void tdr_ring_destroy(tdr_ring *r) {
  if (!r) return;
  // Quiesce the async driver FIRST: a queued op must fail fast (its
  // waiter wakes with a retryable error), and a running op must
  // finish before the MRs it posts against are deregistered below.
  async_stop(r);
  for (auto &kv : r->registered)
    if (!r->borrowed.count(kv.first)) tdr_dereg_mr(kv.second);
  if (r->tmp_mr) tdr_dereg_mr(r->tmp_mr);
  delete r;
}

static tdr_ring_op *ring_start_kind(tdr_ring *r, void *data, size_t count,
                                    int dtype, int red_op, int kind,
                                    float scale_in = 0.0f,
                                    float *f32_out = nullptr) {
  if (!r || !data) {
    tdr::set_error("ring_start: null ring or data");
    return nullptr;
  }
  if (dtype_size(dtype) == 0) {
    tdr::set_error("ring: bad dtype");
    return nullptr;
  }
  // The reducing kinds reject the byte-transport dtype; all_gather
  // moves bytes only (no folds) and accepts it, like the blocking API.
  if (dtype == TDR_DT_U8 && kind != tdr_ring_op::kAllGather) {
    tdr::set_error(
        "ring_start: u8 is byte-transport only (no fold semantics)");
    return nullptr;
  }
  // int8 only reduces through the scale-carrying q8 schedule (a plain
  // int8 sum overflows); byte transport via all_gather is fine.
  if (dtype == TDR_DT_I8 && kind != tdr_ring_op::kAllGather &&
      kind != tdr_ring_op::kAllreduceQ8) {
    tdr::set_error("ring_start: i8 reduces only via tdr_ring_start_q8");
    return nullptr;
  }
  auto *op = new tdr_ring_op();
  op->data = data;
  op->count = count;
  op->dtype = dtype;
  op->red_op = red_op;
  op->kind = kind;
  op->scale_in = scale_in;
  op->f32_out = f32_out;
  // Capture the caller-stamped trace id NOW (submission order is the
  // SPMD contract, so submission is when the id binds); the driver
  // re-arms it when the op runs.
  op->coll = take_coll(r);
  {
    std::lock_guard<std::mutex> g(r->amu);
    if (r->astop) {
      tdr::set_error("ring_start: ring is being destroyed");
      delete op;
      return nullptr;
    }
    if (!r->adrv_up) {
      r->adrv = std::thread(async_driver, r);
      r->adrv_up = true;
    }
    r->aq.push_back(op);
  }
  r->acv.notify_all();
  return op;
}

tdr_ring_op *tdr_ring_start(tdr_ring *r, void *data, size_t count,
                            int dtype, int red_op) {
  return ring_start_kind(r, data, count, dtype, red_op,
                         tdr_ring_op::kAllreduce);
}

tdr_ring_op *tdr_ring_start_reduce_scatter(tdr_ring *r, void *data,
                                           size_t count, int dtype,
                                           int red_op) {
  return ring_start_kind(r, data, count, dtype, red_op,
                         tdr_ring_op::kReduceScatter);
}

tdr_ring_op *tdr_ring_start_all_gather(tdr_ring *r, void *data,
                                       size_t count, int dtype) {
  return ring_start_kind(r, data, count, dtype, TDR_RED_SUM,
                         tdr_ring_op::kAllGather);
}

tdr_ring_op *tdr_ring_start_q8(tdr_ring *r, void *q8, size_t count,
                               float scale_in, float *f32_out) {
  if (!f32_out) {
    tdr::set_error("ring_start_q8: null f32_out");
    return nullptr;
  }
  return ring_start_kind(r, q8, count, TDR_DT_I8, TDR_RED_SUM,
                         tdr_ring_op::kAllreduceQ8, scale_in, f32_out);
}

int tdr_ring_owned_segment(tdr_ring *r, size_t count, int dtype,
                           size_t *own_off, size_t *own_len) {
  if (!r) {
    tdr::set_error("ring_owned_segment: null ring");
    return -1;
  }
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    tdr::set_error("ring: bad dtype");
    return -1;
  }
  // Same layout math the collectives run (seg_layout + the
  // (rank+1) % world ownership convention) — one source of truth, so
  // async callers can never drift from what reduce_scatter leaves.
  size_t base = count / static_cast<size_t>(r->world);
  size_t rem = count % static_cast<size_t>(r->world);
  size_t own = static_cast<size_t>((r->rank + 1) % r->world);
  size_t off = own * base + std::min(own, rem);
  size_t len = base + (own < rem ? 1 : 0);
  if (own_off) *own_off = off * esz;
  if (own_len) *own_len = len * esz;
  return 0;
}

int tdr_ring_test(tdr_ring_op *op) {
  if (!op) {
    tdr::set_error("ring_test: null op");
    return -1;
  }
  std::lock_guard<std::mutex> g(op->mu);
  if (!op->done) return 0;
  if (op->rc != 0) {
    tdr::set_error(op->err);
    return -1;
  }
  return 1;
}

int tdr_ring_wait(tdr_ring_op *op, int timeout_ms) {
  if (!op) {
    tdr::set_error("ring_wait: null op");
    return -1;
  }
  std::unique_lock<std::mutex> lk(op->mu);
  if (timeout_ms < 0) {
    op->cv.wait(lk, [&] { return op->done; });
  } else if (!op->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                              [&] { return op->done; })) {
    tdr::set_error("ring_wait: timeout waiting for async collective");
    return -1;
  }
  if (op->rc != 0) {
    tdr::set_error(op->err);
    return -1;
  }
  return 0;
}

const char *tdr_ring_op_error(tdr_ring_op *op) {
  if (!op) return "";
  std::lock_guard<std::mutex> g(op->mu);
  return op->done && op->rc != 0 ? op->err.c_str() : "";
}

int tdr_ring_op_done(tdr_ring_op *op) {
  if (!op) return 0;
  std::lock_guard<std::mutex> g(op->mu);
  return op->done ? 1 : 0;
}

void tdr_ring_op_free(tdr_ring_op *op) {
  if (!op) return;
  {
    // A pending op is still owned by the driver: block until it
    // completes (bounded by the collective's own stall deadline)
    // rather than freeing memory another thread will write.
    std::unique_lock<std::mutex> lk(op->mu);
    op->cv.wait(lk, [&] { return op->done; });
  }
  delete op;
}

// Pre-register a buffer whose lifetime the caller guarantees to
// outlast the ring (or until tdr_ring_unregister). Steady-state
// allreduces on it then post work requests only — the front-loaded
// registration invariant of the reference (SURVEY.md §3.3).
int tdr_ring_register(tdr_ring *r, void *base, size_t len) {
  if (!r || !base || !len) {
    tdr::set_error("ring_register: bad args");
    return -1;
  }
  std::lock_guard<std::mutex> g(r->mu);
  uint64_t key = reinterpret_cast<uint64_t>(base);
  auto it = r->registered.find(key);
  if (it != r->registered.end()) {
    if (r->borrowed.count(key)) {
      // The key holds an ADOPTED (caller-owned) MR: silently
      // succeeding would bind this caller to the owner's MR (its
      // later unregister then orphans the owner's zero-copy binding),
      // and replacing/deregistering would double-free when the owner
      // deregisters. The owner must drop_buffer() first.
      tdr::set_error(
          "ring_register: key holds an adopted MR (drop it first)");
      return -1;
    }
    if (tdr_mr_len(it->second) >= len) return 0;
    tdr_dereg_mr(it->second);
    r->registered.erase(it);
  }
  tdr_mr *mr = tdr_reg_mr(r->eng, base, len, 0);
  if (!mr) return -1;
  r->registered[key] = mr;
  return 0;
}

int tdr_ring_last_schedule(const tdr_ring *r) {
  return r ? r->last_sched : TDR_SCHED_NONE;
}

int tdr_ring_unregister(tdr_ring *r, void *base) {
  if (!r) return -1;
  std::lock_guard<std::mutex> g(r->mu);
  uint64_t key = reinterpret_cast<uint64_t>(base);
  auto it = r->registered.find(key);
  if (it == r->registered.end()) return -1;
  if (r->borrowed.erase(key) == 0) tdr_dereg_mr(it->second);
  r->registered.erase(it);
  return 0;
}

// Adopt a caller-owned MR (dma-buf over device memory, iova == base)
// as the data MR for `base` — the zero-copy collective path. The
// caller retains ownership: unregister/destroy never dereg it.
int tdr_ring_adopt_mr(tdr_ring *r, void *base, tdr_mr *mr) {
  if (!r || !base || !mr) {
    tdr::set_error("ring_adopt_mr: bad args");
    return -1;
  }
  if (tdr_mr_addr(mr) != reinterpret_cast<uint64_t>(base)) {
    tdr::set_error("ring_adopt_mr: MR iova does not match base");
    return -1;
  }
  std::lock_guard<std::mutex> g(r->mu);
  uint64_t key = reinterpret_cast<uint64_t>(base);
  auto it = r->registered.find(key);
  if (it != r->registered.end()) {
    if (r->borrowed.erase(key) == 0) tdr_dereg_mr(it->second);
    r->registered.erase(it);
  }
  r->registered[key] = mr;
  r->borrowed.insert(key);
  return 0;
}

// The schedule structs and helpers below are C++ (templates) inside a
// file whose API surface is extern "C": reopen C++ linkage for them.
extern "C++" {
namespace {

// ------------------------------------------------------------------
// Progress plumbing shared by the striped schedules.
//
// A schedule exposes a THREAD-SAFE `int on_wc(bool left_side, size_t
// chan, const tdr_wc &wc)` (per-channel FIFO counters under the hub's
// per-channel locks, cross-channel watermarks/masks under the hub
// mutex) plus `post_more()`, `finished_locked()`, `owed_channel()`,
// and `stall_detail()`. Two drivers consume that surface:
//
//  - run_* legacy loop (TDR_PROGRESS_SHARDS=0): the calling thread
//    owns all polling — sweep_side() drains every channel without
//    blocking, wait_owed() parks a bounded slice on the channel owed
//    the oldest outstanding completion. One thread, one blocking
//    poll: wire progress on channel A can wait out a park owed to
//    channel B (the BENCH_r06 vs_bound gap).
//
//  - drive_sharded() (default): TDR_PROGRESS_SHARDS dedicated
//    progress threads, each polling ONLY its channel group's QPs and
//    publishing completion watermarks through on_wc; the schedule's
//    calling thread becomes a pure consumer — it posts what the
//    watermarks allow and sleeps on the hub's ONE condvar, which
//    every completion, fold, and failure notifies. No channel's
//    progress ever waits behind a blocking poll owed to another.
// ------------------------------------------------------------------

constexpr int kShardSliceMs = 2;  // shard park bound (verbs has no pulse)

template <typename S>
int sweep_side(const std::vector<tdr_qp *> &qps, S &sched, bool left) {
  tdr_wc wc[16];
  int total = 0;
  for (size_t c = 0; c < qps.size(); c++) {
    for (;;) {
      int n = tdr_poll(qps[c], wc, 16, 0);
      if (n < 0) return -1;
      for (int i = 0; i < n; i++)
        if (sched.on_wc(left, c, wc[i]) != 0) return -1;
      total += n;
      if (n < 16) break;
    }
  }
  return total;
}

// Block up to slice_ms on the channel the schedule says is OWED the
// oldest outstanding completion (sched.owed_channel — per-channel
// FIFO makes "oldest outstanding recv" a exact channel choice, so the
// blocking poll parks where the critical-path completion will arrive,
// not on an arbitrary channel while work queues elsewhere).
// Deadlock-free regardless of the choice: every owed completion
// eventually arrives on its own channel, and the caller re-sweeps all
// channels after each wake; a wrong guess costs at most slice_ms.
template <typename S>
int wait_owed(tdr_ring *r, S &sched, int slice_ms) {
  bool left = true;
  size_t chan = 0;
  sched.owed_channel(&left, &chan);
  tdr_qp *qp = (left ? r->lefts : r->rights)[chan];
  tdr_wc wc[16];
  int n = tdr_poll(qp, wc, 16, slice_ms);
  if (n < 0) return -1;
  for (int i = 0; i < n; i++)
    if (sched.on_wc(left, chan, wc[i]) != 0) return -1;
  return n;
}

// Watermark hub: the schedules' shared done-mask state. Fine-grained
// per-channel locks guard each channel's FIFO counters (single
// writer: the shard owning the channel — or the one polling thread in
// legacy mode); the hub mutex guards the cross-channel aggregates,
// masks, in-order-prefix frontiers, and fold bookkeeping; the ONE
// condvar carries every watermark publication. Lock discipline:
// chan_mu[c] and mu are never held together.
struct ProgressHub {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::mutex> chan_mu;
  std::atomic<bool> stop{false};
  bool failed = false;   // under mu
  std::string err;       // under mu (thread-local errors bridged here:
                         // a shard's set_error is invisible to the
                         // posting thread's tdr_last_error slot)
  uint64_t stamp = 0;    // watermark publication count, under mu

  void init(size_t nc) {
    while (chan_mu.size() < nc) chan_mu.emplace_back();
    std::lock_guard<std::mutex> g(mu);
    failed = false;
    err.clear();
    stop.store(false, std::memory_order_relaxed);
  }
  void bump_locked() {
    stamp++;
    cv.notify_all();
  }
  void fail(const std::string &msg) {
    std::lock_guard<std::mutex> g(mu);
    if (!failed) {
      failed = true;
      err = msg;
    }
    bump_locked();
  }
};

// Error helpers: record in the calling thread's error slot AND the
// hub (on_wc may run on a shard thread whose thread-local error the
// posting thread can never read).
int wc_fail(ProgressHub &hub, const char *label, const tdr_wc &wc) {
  std::string msg = std::string(label) + ": completion error status " +
                    wc_status_label(wc.status);
  tdr::set_error(msg);
  hub.fail(msg);
  return -1;
}

int order_fail(ProgressHub &hub, const char *label, const char *what,
               size_t chan) {
  std::string msg = std::string(label) + ": " + what + " on channel " +
                    std::to_string(chan);
  tdr::set_error(msg);
  hub.fail(msg);
  return -1;
}

// Shared stall-deadline bookkeeping (factored from the schedules'
// previously-duplicated poll-timeout blocks): the deadline re-arms on
// ANY progress; expiry produces one labeled error whose detail names
// the owed channel/watermark, so a stall report says WHERE the
// schedule is blocked, not just that it is.
struct StallClock {
  std::chrono::steady_clock::time_point dl;
  // Hard per-collective deadline (TDR_COLL_DEADLINE_MS): unlike the
  // stall deadline it does NOT re-arm on progress — it bounds the
  // whole collective, so a link crawling under netem delay/throttle
  // that never quite stalls still trips it. Disabled (the default)
  // when the env knob is unset.
  std::chrono::steady_clock::time_point hard_dl;
  bool hard = false;
  StallClock() {
    int cd = tdr::coll_deadline_ms();
    if (cd > 0) {
      hard = true;
      hard_dl = std::chrono::steady_clock::now() +
                std::chrono::milliseconds(cd);
    }
    bump();
  }
  void bump() {
    dl = std::chrono::steady_clock::now() +
         std::chrono::milliseconds(ring_timeout_ms());
  }
  bool expired() const { return std::chrono::steady_clock::now() >= dl; }
  bool deadline_exceeded() const {
    return hard && std::chrono::steady_clock::now() >= hard_dl;
  }
};

// Hung-peer classification at expiry time: PING both ring neighbors
// (channel 0 — all channels reach the same peer processes) and fold
// the verdicts, worst first: a hung peer (probe sent, no pong inside
// the window) outranks a dead connection outranks "alive but slow".
// -2 = probing not negotiated anywhere (legacy peer / TDR_NO_PROBE),
// in which case error messages stay byte-identical to the pre-probe
// wording.
int stall_probe(tdr_ring *r) {
  int to = ring_timeout_ms() / 4;
  if (to < 50) to = 50;
  if (to > 2000) to = 2000;
  int verdict = -2;
  tdr_qp *qps[2] = {r->lefts[0], r->rights[0]};
  auto rank_of = [](int v) {
    return v == 0 ? 3 : v == -1 ? 2 : v == 1 ? 1 : 0;
  };
  for (tdr_qp *q : qps) {
    if (!q) continue;
    int pr = tdr_qp_probe(q, to);
    if (rank_of(pr) > rank_of(verdict)) verdict = pr;
  }
  return verdict;
}

// Verdict suffix appended to stall/deadline errors. The markers are
// load-bearing: the Python taxonomy keys retryability and `kind` off
// "peer hung" / "connection down" / plain timeout (see engine.py).
void append_probe_verdict(std::string *msg, int verdict) {
  if (verdict == 0)
    *msg += "; peer hung (probe unanswered)";
  else if (verdict == -1)
    *msg += "; peer connection down";
  else if (verdict == 1)
    *msg += "; peer alive (slow link)";
  // -2: keep the legacy message byte-identical.
}

int stall_fail(tdr_ring *r, const char *label, const std::string &detail) {
  std::string msg =
      std::string(label) + ": poll timeout (" + detail + ")";
  append_probe_verdict(&msg, r ? stall_probe(r) : -2);
  tdr::set_error(msg);
  return -1;
}

int deadline_fail(tdr_ring *r, const char *label,
                  const std::string &detail) {
  std::string msg = std::string(label) + ": collective deadline exceeded (" +
                    std::to_string(tdr::coll_deadline_ms()) + "ms; " +
                    detail + ")";
  append_probe_verdict(&msg, r ? stall_probe(r) : -2);
  tdr::set_error(msg);
  return -1;
}

// Channel holding the oldest outstanding item of one striped stream:
// per-channel FIFO means channel c's next completion is index
// c + done[c]*nc, so the argmin over channels with posted > done IS
// the stream's oldest outstanding chunk. SIZE_MAX when none. Reads
// each channel's counters under its own lock.
inline size_t oldest_outstanding(ProgressHub &hub,
                                 const std::vector<size_t> &posted,
                                 const std::vector<size_t> &done,
                                 size_t nc, size_t *chan) {
  size_t best = static_cast<size_t>(-1);
  for (size_t c = 0; c < nc; c++) {
    std::lock_guard<std::mutex> g(hub.chan_mu[c]);
    if (posted[c] <= done[c]) continue;
    size_t idx = c + done[c] * nc;
    if (idx < best) {
      best = idx;
      *chan = c;
    }
  }
  return best;
}

// One run's progress shards: shard s owns channels {s, s+n, ...} of
// both sides (each QP has exactly one poller), feeding completions
// through the schedule's thread-safe on_wc and — for the windowed
// schedule — enqueuing folds onto the fold pool straight from the
// shard thread. When its channels are idle the shard parks on the
// ENGINE's completion pulse: event-driven on emu (every CQ delivery
// pulses), a bounded kShardSliceMs slice on verbs.
template <typename S>
class ShardCrew {
 public:
  ShardCrew(tdr_ring *r, S *sched, ProgressHub *hub, size_t nshards,
            bool two_sides)
      : hub_(hub) {
    size_t nc = r->lefts.size();
    if (nshards > nc) nshards = nc;
    g_prog_shards.fetch_add(nshards, std::memory_order_relaxed);
    for (size_t s = 0; s < nshards; s++) {
      std::vector<Owned> own;
      for (size_t c = s; c < nc; c += nshards) {
        own.push_back({r->lefts[c], true, c});
        if (two_sides) own.push_back({r->rights[c], false, c});
      }
      threads_.emplace_back(
          [this, r, sched, own = std::move(own), s] {
            loop(r, sched, own, s);
          });
    }
  }
  ~ShardCrew() {
    hub_->stop.store(true, std::memory_order_release);
    for (auto &t : threads_) t.join();  // park is kShardSliceMs-bounded
  }

 private:
  struct Owned {
    tdr_qp *qp;
    bool left;
    size_t chan;
  };

  void loop(tdr_ring *r, S *sched, const std::vector<Owned> &own,
            size_t ordinal) {
    auto *eng = reinterpret_cast<tdr::Engine *>(r->eng);
    tdr_wc wc[16];
    uint64_t consumed = 0;
    while (!hub_->stop.load(std::memory_order_acquire)) {
      // Stamp BEFORE the sweep: a completion landing mid-sweep on an
      // already-swept QP moves the stamp, so the wait below returns
      // immediately instead of sleeping on work that already arrived.
      uint64_t seen = eng->cq_stamp();
      int got = 0;
      for (const Owned &o : own) {
        for (;;) {
          int n = tdr_poll(o.qp, wc, 16, 0);
          if (n < 0) {
            hub_->fail(std::string("ring progress shard: ") +
                       tdr::get_error());
            return;
          }
          for (int i = 0; i < n; i++)
            if (sched->on_wc(o.left, o.chan, wc[i]) != 0) return;
          got += n;
          if (n < 16) break;
        }
      }
      if (got > 0) {
        consumed += static_cast<uint64_t>(got);
        g_prog_wc.fetch_add(static_cast<uint64_t>(got),
                            std::memory_order_relaxed);
        // Process-level lane (engine=0, like the copy pool's events):
        // drain-batch boundaries ride thread timing and must not
        // perturb per-engine replay shapes.
        TDR_TEL(TDR_TEL_SHARD, 0, tdr::tel_thread_track(), ordinal,
                consumed);
        continue;
      }
      g_prog_wakeups.fetch_add(1, std::memory_order_relaxed);
      eng->cq_wait(seen, kShardSliceMs);
    }
  }

  ProgressHub *hub_;
  std::vector<std::thread> threads_;
};

// Watermark-consumer driver (sharded mode): posting stays on the
// calling thread; polling lives on the shards. The loop body is the
// whole schedule now — post what the watermarks allow, then sleep on
// the hub condvar until they move. The special-case idle states the
// legacy loops carry (fold-only wait, wire-idle-but-fold-gated)
// collapse into the one wait because folds publish on the same cv.
template <typename S>
int drive_sharded(tdr_ring *r, S &s, ProgressHub &hub, size_t nshards,
                  bool two_sides, const char *label) {
  ShardCrew<S> crew(r, &s, &hub, nshards, two_sides);
  StallClock clock;
  for (;;) {
    {
      std::lock_guard<std::mutex> g(hub.mu);
      if (hub.failed) {
        tdr::set_error(hub.err);
        return -1;
      }
      if (s.finished_locked()) return 0;
    }
    if (clock.deadline_exceeded())
      return deadline_fail(r, label, s.stall_detail());
    int p = s.post_more();
    if (p < 0) return -1;
    if (p > 0) {
      clock.bump();
      continue;
    }
    bool moved;
    {
      std::unique_lock<std::mutex> lk(hub.mu);
      uint64_t seen = hub.stamp;
      hub.cv.wait_for(lk, std::chrono::milliseconds(50), [&] {
        return hub.stamp != seen || hub.failed;
      });
      moved = hub.stamp != seen || hub.failed;
    }
    if (moved) {
      clock.bump();
      continue;
    }
    if (clock.expired()) return stall_fail(r, label, s.stall_detail());
  }
}

struct StepPipe {
  tdr_ring *r = nullptr;
  tdr_mr *dmr = nullptr;
  char *cdata = nullptr;
  int dtype = 0, red_op = 0;
  size_t esz = 0;

  StepPipe(tdr_ring *ring, tdr_mr *mr, char *data, int dt, int op,
           size_t elem)
      : r(ring), dmr(mr), cdata(data), dtype(dt), red_op(op), esz(elem) {}

  // ---- per-run state (reset at the top of run()) ----
  size_t chunk = 0, nc = 1;
  size_t send_off_ = 0, send_len_ = 0, recv_off_ = 0, recv_len_ = 0;
  size_t n_send = 0, n_recv = 0;
  bool fused = false, windowed = false;
  size_t slots = 0, slot_bytes = 0;
  // Posting cursors: single-writer (the posting thread).
  size_t posted_r = 0, posted_s = 0;
  // Completion watermarks. The per-channel FIFO counters live under
  // hub.chan_mu[c] (single writer: the shard owning channel c, or the
  // one polling thread in legacy mode); the cross-channel aggregates
  // and fold bookkeeping live under hub.mu.
  std::vector<size_t> posted_rc, done_rc, posted_sc, acked_sc;
  size_t done_r = 0, acked_s = 0;      // under hub.mu
  std::vector<size_t> rwin_c, swin_c;  // per-channel window budgets

  // Async fold tracking (windowed mode). fold_done gates scratch-slot
  // reuse: recv for chunk i may repost only once chunk i-slots has
  // FOLDED (not merely landed) — the slot is its fold's source. All
  // under hub.mu; fold completions publish on the hub condvar.
  bool offload = false;
  uint16_t eng_tel = 0;
  ProgressHub hub;
  std::vector<uint8_t> fold_done;
  size_t folds_out = 0;  // submitted to the pool, not yet finished
  size_t folded = 0;     // chunks whose fold completed (any path)

  size_t chunk_len(size_t total, size_t i) const {
    return std::min(chunk, total - i * chunk);
  }

  void fold_chunk(size_t idx) {
    size_t len = chunk_len(recv_len_, idx);
    // Single-threaded on the fold worker: parallelism comes from
    // channels × workers, not from forking each fold (which would
    // serialize jobs on the copy pool's one-region lock).
    tdr::reduce_any(cdata + recv_off_ + idx * chunk,
                    r->tmp.data() + (idx % slots) * slot_bytes, len / esz,
                    dtype, red_op);
    TDR_TELC(TDR_TEL_FOLD, eng_tel, tdr::tel_thread_track(), idx, len,
             r->cur_coll.load(std::memory_order_relaxed));
    std::lock_guard<std::mutex> g(hub.mu);
    fold_done[idx] = 1;
    folded++;
    folds_out--;
    hub.bump_locked();
  }

  bool fold_ready(size_t i) {
    if (!windowed || i < slots) return true;
    std::lock_guard<std::mutex> g(hub.mu);
    return fold_done[i - slots] != 0;
  }

  int post_recv_chunk(size_t i) {
    size_t len = chunk_len(recv_len_, i);
    size_t c = i % nc;
    tdr_qp *qp = r->lefts[c];
    int rc;
    if (fused)
      rc = tdr_post_recv_reduce(qp, dmr, recv_off_ + i * chunk, len, dtype,
                                red_op, kWrRecv | i);
    else if (windowed)
      rc = tdr_post_recv(qp, r->scratch(slots * slot_bytes),
                         (i % slots) * slot_bytes, len, kWrRecv | i);
    else
      rc = tdr_post_recv(qp, dmr, recv_off_ + i * chunk, len, kWrRecv | i);
    if (rc == 0) {
      std::lock_guard<std::mutex> g(hub.chan_mu[c]);
      posted_rc[c]++;
    }
    return rc;
  }

  // Where the oldest outstanding completion will arrive: the recv
  // stream first (it is the critical path — folds and the peer's send
  // window both key off landed chunks), else any channel owing a send
  // ack.
  void owed_channel(bool *left, size_t *chan) {
    size_t c = 0;
    if (oldest_outstanding(hub, posted_rc, done_rc, nc, &c) !=
        static_cast<size_t>(-1)) {
      *left = true;
      *chan = c;
      return;
    }
    for (size_t i = 0; i < nc; i++) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i]);
      if (posted_sc[i] > acked_sc[i]) {
        *left = false;
        *chan = i;
        return;
      }
    }
    *left = true;
    *chan = 0;
  }

  int on_wc(bool left, size_t chan, const tdr_wc &wc) {
    (void)left;
    if (wc.status != TDR_WC_SUCCESS) return wc_fail(hub, "ring", wc);
    uint64_t kind = wc.wr_id & kWrKindMask;
    size_t idx = wc.wr_id & ~kWrKindMask;
    if (kind == kWrSend) {
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[idx % nc]);
        acked_sc[idx % nc]++;
      }
      std::lock_guard<std::mutex> g(hub.mu);
      acked_s++;
      hub.bump_locked();
      return 0;
    }
    if (kind != kWrRecv) return 0;
    // Per-channel FIFO: channel c carries chunks c, c+nc, c+2nc, …
    // in posted order; cross-channel arrival order is free.
    {
      std::lock_guard<std::mutex> g(hub.chan_mu[chan]);
      if (idx != chan + done_rc[chan] * nc)
        goto out_of_order;
      done_rc[chan]++;
    }
    if (!windowed) {
      std::lock_guard<std::mutex> g(hub.mu);
      done_r++;
      hub.bump_locked();
      return 0;
    }
    {
      size_t len = chunk_len(recv_len_, idx);
      if (offload) {
        {
          std::lock_guard<std::mutex> g(hub.mu);
          done_r++;
          folds_out++;
          hub.bump_locked();
        }
        // Fold enqueued straight from the progress (shard) thread;
        // the job publishes its watermark back on the hub condvar.
        TDR_TELC(TDR_TEL_FOLD_OFF, eng_tel, tdr::tel_thread_track(), idx,
                 len, r->cur_coll.load(std::memory_order_relaxed));
        tdr::fold_submit([this, idx] { fold_chunk(idx); });
      } else {
        // Inline fallback (no fold workers): the legacy path, with
        // the copy pool forking the fold itself.
        tdr::par_reduce(cdata + recv_off_ + idx * chunk,
                        r->tmp.data() + (idx % slots) * slot_bytes,
                        len / esz, dtype, red_op);
        std::lock_guard<std::mutex> g(hub.mu);
        done_r++;
        fold_done[idx] = 1;
        folded++;
        hub.bump_locked();
      }
    }
    return 0;
  out_of_order:
    return order_fail(hub, "ring", "out-of-order recv completion", chan);
  }

  bool finished_locked() const {
    return done_r == n_recv && acked_s == n_send &&
           (!windowed || folded == n_recv);
  }

  std::string stall_detail() {
    bool left = true;
    size_t chan = 0;
    owed_channel(&left, &chan);
    size_t dr, as, fo;
    {
      std::lock_guard<std::mutex> g(hub.mu);
      dr = done_r;
      as = acked_s;
      fo = folded;
    }
    std::string d = std::string("owed ") + (left ? "recv" : "send-ack") +
                    " on channel " + std::to_string(chan) + "; s " +
                    std::to_string(as) + "/" + std::to_string(n_send) +
                    " r " + std::to_string(dr) + "/" +
                    std::to_string(n_recv);
    if (windowed)
      d += " folded " + std::to_string(fo) + "/" + std::to_string(n_recv);
    return d;
  }

  // Posting side, shared by both drivers: post whatever the windows
  // (and, windowed, the fold watermarks) allow, strictly in global
  // chunk order — which IS per-channel posted order, all FIFO
  // matching needs. Returns progress, or -1.
  int post_more() {
    bool progressed = false;
    while (posted_r < n_recv) {
      size_t c = posted_r % nc;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        if (posted_rc[c] - done_rc[c] >= rwin_c[c]) break;
      }
      if (windowed && !fold_ready(posted_r)) break;
      if (post_recv_chunk(posted_r) != 0) return -1;
      posted_r++;
      progressed = true;
    }
    // Keep outbound traffic moving: in stream mode the post blocks
    // while the chunk drains into the socket (the progress threads
    // land inbound chunks concurrently); in CMA mode it just queues a
    // descriptor. The windowed throttle tracks LANDED chunks (the
    // peer's symmetric scratch window), not folds.
    while (posted_s < n_send) {
      size_t c = posted_s % nc;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        if (posted_sc[c] - acked_sc[c] >= swin_c[c]) break;
      }
      if (windowed && n_recv) {
        std::lock_guard<std::mutex> g(hub.mu);
        if (posted_s >= done_r + slots) break;
      }
      size_t len = chunk_len(send_len_, posted_s);
      if (tdr_post_send(r->rights[c], dmr, send_off_ + posted_s * chunk,
                        len, kWrSend | posted_s) != 0)
        return -1;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        posted_sc[c]++;
      }
      posted_s++;
      progressed = true;
    }
    return progressed ? 1 : 0;
  }

  // One neighbor-exchange step: stream `send_len` bytes of the data
  // buffer at `send_off` rightward while receiving `recv_len` bytes
  // from the left, chunk i striped over channel i % channels.
  //
  // reduce=true → phase-1 semantics: inbound chunks are folded into
  // data at recv_off. On engines with reduce-on-receive the fold
  // happens in the transport's progress engine directly from the
  // inbound bytes (no scratch at all); otherwise chunks land in a
  // double-buffered windowed scratch (two slots per channel) and fold
  // on the fold-offload pool — the poll loop keeps posting while
  // predecessors fold, and a chunk lands while the previous chunk on
  // its channel is still folding.
  // reduce=false → phase-2 semantics: receives land directly in the
  // data MR at recv_off (no copy, no reduce).
  int run(size_t send_off, size_t send_len, size_t recv_off, size_t recv_len,
          bool reduce) {
    chunk = r->chunk;
    nc = r->lefts.size();
    send_off_ = send_off;
    send_len_ = send_len;
    recv_off_ = recv_off;
    recv_len_ = recv_len;
    n_send = send_len ? (send_len + chunk - 1) / chunk : 0;
    n_recv = recv_len ? (recv_len + chunk - 1) / chunk : 0;
    fused = reduce && tdr_qp_has_recv_reduce(r->lefts[0]);
    windowed = reduce && !fused;
    // Double-buffered per channel (so landing i+nc overlaps folding i
    // on every channel), never below the legacy window depth.
    slots = windowed
                ? std::min(n_recv ? n_recv : 1,
                           std::max(static_cast<size_t>(kWindow), 2 * nc))
                : 0;
    slot_bytes = windowed ? std::min(chunk, recv_len ? recv_len : 1) : 0;
    if (windowed && n_recv && !r->scratch(slots * slot_bytes)) return -1;

    posted_r = posted_s = 0;
    posted_rc.assign(nc, 0);
    done_rc.assign(nc, 0);
    posted_sc.assign(nc, 0);
    acked_sc.assign(nc, 0);
    offload = windowed && tdr::fold_pool_workers() > 0;
    eng_tel = reinterpret_cast<tdr::Engine *>(r->eng)->tel_id;
    hub.init(nc);
    {
      std::lock_guard<std::mutex> g(hub.mu);
      done_r = acked_s = 0;
      fold_done.assign(windowed ? n_recv : 0, 0);
      folds_out = 0;
      folded = 0;
    }
    // Whatever happens below, never return while a fold job still
    // references the scratch window or the data buffer. Declared
    // FIRST so it drains AFTER the sharded driver has joined its
    // shard threads (destructors run in reverse order) — no shard can
    // submit a fold once the drain starts counting.
    struct FoldDrain {
      StepPipe *p;
      ~FoldDrain() {
        std::unique_lock<std::mutex> lk(p->hub.mu);
        p->hub.cv.wait(lk, [&] { return p->folds_out == 0; });
      }
    } fold_drain{this};
    (void)fold_drain;

    rwin_c.assign(nc, 0);
    swin_c.assign(nc, 0);
    for (size_t c = 0; c < nc; c++) {
      rwin_c[c] = fused ? reduce_recv_window(r->lefts[c]) : kMaxOutstanding;
      // In-flight send bound: the schedule is symmetric, so the peer's
      // reduce-recv window (≈ ours, same config) caps how many phase-1
      // sends can land — racing further ahead just RNR-NAK-storms a
      // real HCA (the mock and emu absorb it, hiding the collapse).
      swin_c[c] = reduce ? reduce_recv_window(r->rights[c])
                         : kMaxOutstanding;
    }

    const bool same_qp = (r->lefts[0] == r->rights[0]);
    const size_t shards = tdr::progress_shards_for(nc);
    // Tiny runs (a barrier's one chunk, a short tail segment) post
    // and finish faster than a shard thread spawns: keep them on the
    // legacy inline loop regardless of the knob.
    if (shards > 0 && n_recv + n_send >= 4)
      return drive_sharded(r, *this, hub, shards, !same_qp, "ring");
    return run_polled(same_qp);
  }

  // Legacy single-poll loop (TDR_PROGRESS_SHARDS=0, and tiny runs):
  // the calling thread owns all polling and folds gate its waits.
  int run_polled(bool same_qp) {
    StallClock clock;
    size_t last_folded = 0;
    for (;;) {
      {
        std::lock_guard<std::mutex> g(hub.mu);
        if (finished_locked()) break;
        if (folded != last_folded) {
          last_folded = folded;
          clock.bump();
        }
      }
      if (clock.deadline_exceeded())
        return deadline_fail(r, "ring", stall_detail());
      int p = post_more();
      if (p < 0) return -1;
      int nl = sweep_side(r->lefts, *this, true);
      if (nl < 0) return -1;
      int nr = same_qp ? 0 : sweep_side(r->rights, *this, false);
      if (nr < 0) return -1;
      if (p > 0 || nl > 0 || nr > 0) {
        clock.bump();
        continue;
      }
      size_t dr, as;
      {
        std::lock_guard<std::mutex> g(hub.mu);
        dr = done_r;
        as = acked_s;
      }
      if (dr == n_recv && as == n_send) {
        // Only folds left: they are pure local CPU work — wait on the
        // hub cv (fold completions publish there), not the wire.
        std::unique_lock<std::mutex> lk(hub.mu);
        hub.cv.wait(lk, [&] { return folded == n_recv; });
        continue;
      }
      // Wire idle but fold-gated (every posted recv landed, every
      // send acked, posting blocked on scratch slots): the only
      // possible progress is offloaded folds, and a fold completion
      // notifies the hub cv — a QP poll would just sleep its slice.
      if (windowed && posted_r == dr && posted_s == as) {
        bool fold_moved;
        {
          std::unique_lock<std::mutex> lk(hub.mu);
          hub.cv.wait_for(lk, std::chrono::milliseconds(50),
                          [&] { return folded != last_folded; });
          fold_moved = folded != last_folded;
        }
        if (!fold_moved && clock.expired())
          return stall_fail(r, "ring", "fold stall; " + stall_detail());
        continue;
      }
      // Nothing postable, nothing completed: block a slice on the
      // channel owed the oldest outstanding completion, so the wake
      // happens where the critical path advances and a genuine stall
      // still trips the ring deadline.
      int n = wait_owed(r, *this, 50);
      if (n < 0) return -1;
      if (n > 0) {
        clock.bump();
        continue;
      }
      bool fold_moved;
      {
        std::lock_guard<std::mutex> g(hub.mu);
        fold_moved = folded != last_folded;
      }
      if (!fold_moved && clock.expired())
        return stall_fail(r, "ring", stall_detail());
    }
    return 0;
  }
};

}  // namespace

namespace {

// World-2 fused exchange: reduce-scatter and all-gather overlapped
// (C++ linkage continues through these schedule structs; the linkage
// block closes before the extern-C collective entry points.)
// chunk-wise. The generic schedule runs the two phases back to back;
// for world=2 they use OPPOSITE directions of the two neighbor QPs
// (phase 1 rides right→peer-left, phase 2 rides left→peer-right), so
// there is no FIFO-matching conflict in running them concurrently:
// the moment chunk c of my reduce segment is folded, the reduced
// chunk is sent back while the next inbound chunk is still in flight.
// Besides hiding the phase-2 latency behind phase 1, the return
// transfer reads bytes the fold JUST wrote — LLC-hot instead of a
// DRAM re-read, which on a bandwidth-bound host is the difference
// between 5 and 6 passes over the buffer per allreduce.
//
// Requires reduce-on-receive (folds happen in the transport's
// progress engine as chunks arrive) and distinct left/right QPs; the
// caller falls back to the generic two-phase pipeline otherwise.
struct FusedTwo {
  tdr_ring *r = nullptr;
  tdr_mr *dmr = nullptr;
  int dtype = 0, red_op = 0;

  size_t chunk = 0;
  // A = the segment this rank sends out first and receives back
  // reduced; B = the segment it folds locally and returns.
  size_t a_off = 0, a_len = 0, b_off = 0, b_len = 0;
  size_t n_a = 0, n_b = 0;
  // Foldback mode: A chunks go out as fold-and-write-back sends whose
  // acks mean "the reduced final landed in place" — the two return
  // streams (reduced-B sends, A-final recvs) disappear entirely, and
  // the fold+return is one pass in the peer's progress engine.
  bool use_fb = false;

  // Stream bookkeeping, striped chunk i → channel i % nc. Recv
  // completions may arrive out of GLOBAL order across channels (per
  // channel they stay FIFO — asserted via the per-channel counters,
  // which live under the hub's per-channel locks), so both inbound
  // streams keep done-masks; the B stream also keeps the in-order
  // folded PREFIX (fr_rB) because returning reduced chunk k to the
  // peer requires k's fold complete AND FIFO order on the left
  // channel k % nc. Masks, prefixes, and aggregates live under
  // hub.mu — the in-order-prefix dependency state the one condvar
  // publishes.
  size_t nc = 1;
  size_t posted_rB = 0, posted_sB = 0;  // posting cursors (one writer)
  size_t posted_sA = 0, posted_rA = 0;
  size_t done_rB = 0, acked_sB = 0;     // aggregates, under hub.mu
  size_t acked_sA = 0, done_rA = 0;
  size_t need_sB = 0;
  std::vector<uint8_t> mask_rB, mask_rA;           // under hub.mu
  size_t fr_rB = 0;  // in-order folded prefix, under hub.mu
  std::vector<size_t> done_rBc, done_rAc;      // per-channel order check
  std::vector<size_t> pc_rB, pc_rA, pc_sA, ac_sA;  // per-channel windows
  std::vector<size_t> pc_sB, ac_sB;  // per-channel sB accounting
  std::vector<size_t> rb_win, sa_win;
  ProgressHub hub;

  static size_t nchunks(size_t len, size_t chunk) {
    return len ? (len + chunk - 1) / chunk : 0;
  }
  size_t clen(size_t total, size_t i) const {
    return std::min(chunk, total - i * chunk);
  }

  int post_recv_b(size_t i) {
    int rc = tdr_post_recv_reduce(r->lefts[i % nc], dmr, b_off + i * chunk,
                                  clen(b_len, i), dtype, red_op,
                                  kWrRecv | i);
    if (rc == 0) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i % nc]);
      pc_rB[i % nc]++;
    }
    return rc;
  }
  int post_recv_a(size_t i) {
    int rc = tdr_post_recv(r->rights[i % nc], dmr, a_off + i * chunk,
                           clen(a_len, i), kWrRecv | i);
    if (rc == 0) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i % nc]);
      pc_rA[i % nc]++;
    }
    return rc;
  }

  int on_wc(bool left, size_t chan, const tdr_wc &wc) {
    if (wc.status != TDR_WC_SUCCESS)
      return wc_fail(hub, "ring(fused2)", wc);
    uint64_t kind = wc.wr_id & kWrKindMask;
    size_t idx = wc.wr_id & ~kWrKindMask;
    if (kind == kWrSend) {
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[idx % nc]);
        (left ? ac_sB : ac_sA)[idx % nc]++;
      }
      std::lock_guard<std::mutex> g(hub.mu);
      (left ? acked_sB : acked_sA)++;
      hub.bump_locked();
      return 0;
    }
    if (kind != kWrRecv) return 0;
    bool ooo = false;
    {
      std::lock_guard<std::mutex> g(hub.chan_mu[chan]);
      std::vector<size_t> &done_c = left ? done_rBc : done_rAc;
      if (idx != chan + done_c[chan] * nc)
        ooo = true;
      else
        done_c[chan]++;
    }
    if (!ooo) {
      std::lock_guard<std::mutex> g(hub.mu);
      std::vector<uint8_t> &mask = left ? mask_rB : mask_rA;
      if (idx >= mask.size() || mask[idx]) {
        ooo = true;
      } else {
        mask[idx] = 1;
        if (left) {
          done_rB++;
          while (fr_rB < n_b && mask_rB[fr_rB]) fr_rB++;
        } else {
          done_rA++;
        }
        hub.bump_locked();
      }
    }
    if (ooo)
      return order_fail(hub, "ring(fused2)",
                        "out-of-order recv completion", chan);
    return 0;
  }

  // Oldest outstanding completion: the B fold stream first (it gates
  // the reduced-return sends), then the A final stream, then send
  // acks on either side.
  void owed_channel(bool *left, size_t *chan) {
    size_t c = 0;
    if (oldest_outstanding(hub, pc_rB, done_rBc, nc, &c) !=
        static_cast<size_t>(-1)) {
      *left = true;
      *chan = c;
      return;
    }
    if (!use_fb && oldest_outstanding(hub, pc_rA, done_rAc, nc, &c) !=
                       static_cast<size_t>(-1)) {
      *left = false;
      *chan = c;
      return;
    }
    for (size_t i = 0; i < nc; i++) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i]);
      if (pc_sA[i] > ac_sA[i]) {
        *left = false;
        *chan = i;
        return;
      }
      if (pc_sB[i] > ac_sB[i]) {
        *left = true;
        *chan = i;
        return;
      }
    }
    *left = true;
    *chan = 0;
  }

  bool finished_locked() const {
    return done_rB >= n_b && acked_sB >= need_sB && done_rA >= n_a &&
           acked_sA >= n_a;
  }

  std::string stall_detail() {
    bool left = true;
    size_t chan = 0;
    owed_channel(&left, &chan);
    size_t rB, sB, rA, sA;
    {
      std::lock_guard<std::mutex> g(hub.mu);
      rB = done_rB;
      sB = acked_sB;
      rA = done_rA;
      sA = acked_sA;
    }
    return std::string("owed ") + (left ? "left" : "right") +
           " channel " + std::to_string(chan) + "; rB " +
           std::to_string(rB) + "/" + std::to_string(n_b) + " sB " +
           std::to_string(sB) + "/" + std::to_string(posted_sB) + " rA " +
           std::to_string(rA) + "/" + std::to_string(n_a) + " sA " +
           std::to_string(sA) + "/" + std::to_string(posted_sA);
  }

  // Post the inbound streams deep (every target is a disjoint slice
  // of the data MR) and the outbound streams as their gates open,
  // all in global chunk order — which is per-channel FIFO order.
  int post_more() {
    bool progressed = false;
    while (posted_rB < n_b) {
      size_t c = posted_rB % nc;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        if (pc_rB[c] - done_rBc[c] >= rb_win[c]) break;
      }
      if (post_recv_b(posted_rB) != 0) return -1;
      posted_rB++;
      progressed = true;
    }
    if (!use_fb) {
      while (posted_rA < n_a) {
        size_t c = posted_rA % nc;
        {
          std::lock_guard<std::mutex> g(hub.chan_mu[c]);
          if (pc_rA[c] - done_rAc[c] >= kMaxOutstanding) break;
        }
        if (post_recv_a(posted_rA) != 0) return -1;
        posted_rA++;
        progressed = true;
      }
    }
    while (posted_sA < n_a) {
      size_t c = posted_sA % nc;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        if (pc_sA[c] - ac_sA[c] >= sa_win[c]) break;
      }
      int rc = use_fb
                   ? tdr_post_send_foldback(r->rights[c], dmr,
                                            a_off + posted_sA * chunk,
                                            clen(a_len, posted_sA),
                                            kWrSend | posted_sA)
                   : tdr_post_send(r->rights[c], dmr,
                                   a_off + posted_sA * chunk,
                                   clen(a_len, posted_sA),
                                   kWrSend | posted_sA);
      if (rc != 0) return -1;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        pc_sA[c]++;
      }
      posted_sA++;
      progressed = true;
    }
    // Non-foldback: return a reduced B chunk the moment its fold
    // completes (cache-hot). The gate is the in-order folded
    // prefix, so the peer's rA stream sees its per-channel FIFO.
    while (!use_fb) {
      {
        std::lock_guard<std::mutex> g(hub.mu);
        if (!(posted_sB < fr_rB && posted_sB - acked_sB < kMaxOutstanding))
          break;
      }
      size_t c = posted_sB % nc;
      if (tdr_post_send(r->lefts[c], dmr, b_off + posted_sB * chunk,
                        clen(b_len, posted_sB), kWrSend | posted_sB) != 0)
        return -1;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        pc_sB[c]++;
      }
      posted_sB++;
      progressed = true;
    }
    return progressed ? 1 : 0;
  }

  int run() {
    nc = r->lefts.size();
    hub.init(nc);
    {
      std::lock_guard<std::mutex> g(hub.mu);
      mask_rB.assign(n_b, 0);
      mask_rA.assign(use_fb ? 0 : n_a, 0);
      fr_rB = 0;
      done_rB = acked_sB = acked_sA = done_rA = 0;
      if (use_fb) done_rA = n_a;  // stream does not exist
    }
    need_sB = use_fb ? 0 : n_b;  // ditto
    done_rBc.assign(nc, 0);
    done_rAc.assign(nc, 0);
    pc_rB.assign(nc, 0);
    pc_rA.assign(nc, 0);
    pc_sA.assign(nc, 0);
    ac_sA.assign(nc, 0);
    pc_sB.assign(nc, 0);
    ac_sB.assign(nc, 0);
    rb_win.assign(nc, 0);
    sa_win.assign(nc, 0);
    for (size_t c = 0; c < nc; c++) {
      rb_win[c] = reduce_recv_window(r->lefts[c]);
      // A-chunks land in the peer's reduce-recvs: bound in-flight
      // sends by its window (≈ ours) so a real HCA doesn't
      // RNR-NAK-storm.
      sa_win[c] = reduce_recv_window(r->rights[c]);
    }

    const size_t shards = tdr::progress_shards_for(nc);
    if (shards > 0 && n_a + n_b >= 4)
      return drive_sharded(r, *this, hub, shards, true, "ring(fused2)");

    StallClock clock;
    for (;;) {
      {
        std::lock_guard<std::mutex> g(hub.mu);
        if (finished_locked()) break;
      }
      if (clock.deadline_exceeded())
        return deadline_fail(r, "ring(fused2)", stall_detail());
      int p = post_more();
      if (p < 0) return -1;
      int nl = sweep_side(r->lefts, *this, true);
      if (nl < 0) return -1;
      int nr = sweep_side(r->rights, *this, false);
      if (nr < 0) return -1;
      if (p > 0 || nl > 0 || nr > 0) {
        clock.bump();
        continue;
      }
      int n = wait_owed(r, *this, 50);
      if (n < 0) return -1;
      if (n > 0) {
        clock.bump();
        continue;
      }
      if (clock.expired())
        return stall_fail(r, "ring(fused2)", stall_detail());
    }
    return 0;
  }
};

bool wavefront_disabled() { return tdr::env_set("TDR_NO_WAVEFRONT"); }

// ------------------------------------------------------------------
// Wavefront ring (world > 2, reduce-on-receive engines): the classic
// schedule is 2(world-1) steps separated by barriers — the link idles
// while the last chunks of a step fold, and every step pays a full
// drain. Here the WHOLE schedule is flattened into two lexicographic
// (step, chunk) sequences — one of sends (right QP), one of receives
// (left QP) — and chunks advance through steps independently behind a
// sliding window. Correctness with FIFO recv matching holds because
// both sides post strictly in schedule order and TCP preserves it;
// the data dependency is exactly "send (t,c) needs recv (t-1,c)",
// and send step t's segment IS recv step t-1's segment, so a single
// monotone completed-receives counter encodes readiness.
// ------------------------------------------------------------------
struct WaveItem {
  size_t off;
  size_t len;
  bool reduce;     // recv side: fold vs place
  size_t dep = 0;  // send side: required done_recv count
  bool fb = false;  // send side: fold-and-write-back (last RS step)
};

struct Wavefront {
  tdr_ring *r = nullptr;
  tdr_mr *dmr = nullptr;
  int dtype = 0, red_op = 0;
  std::vector<WaveItem> sends, recvs;

  size_t nc = 1;
  size_t posted_s = 0, posted_r = 0;  // posting cursors (one writer)
  size_t acked_s = 0, done_r = 0;     // aggregates, under hub.mu
  // Completion bookkeeping tolerates out-of-schedule-order recv
  // completions: channels complete independently, and a foldback
  // recv's completion is DEFERRED until the peer's write-back pull
  // acks, so a later recv can complete first. Matching is still FIFO
  // per channel at the transport — only cross-channel reporting
  // reorders — and send dependencies use the in-order completed
  // PREFIX (frontier), never the raw count. Mask + frontier live
  // under hub.mu: they ARE the watermark the posting side consumes.
  std::vector<uint8_t> done_mask;
  size_t frontier = 0;
  // Per-channel in-flight accounting (window bounds) and send acks,
  // under the hub's per-channel locks.
  std::vector<size_t> pc_r, dc_r, pc_s, ac_s;
  std::vector<size_t> r_win;
  ProgressHub hub;

  int post_send_item(size_t i) {
    const WaveItem &it = sends[i];
    tdr_qp *qp = r->rights[i % nc];
    int rc = it.fb
                 ? tdr_post_send_foldback(qp, dmr, it.off, it.len,
                                          kWrSend | i)
                 : tdr_post_send(qp, dmr, it.off, it.len, kWrSend | i);
    if (rc == 0) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i % nc]);
      pc_s[i % nc]++;
    }
    return rc;
  }
  int post_recv_item(size_t i) {
    const WaveItem &it = recvs[i];
    tdr_qp *qp = r->lefts[i % nc];
    int rc = it.reduce
                 ? tdr_post_recv_reduce(qp, dmr, it.off, it.len, dtype,
                                        red_op, kWrRecv | i)
                 : tdr_post_recv(qp, dmr, it.off, it.len, kWrRecv | i);
    if (rc == 0) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i % nc]);
      pc_r[i % nc]++;
    }
    return rc;
  }

  int on_wc(bool left, size_t chan, const tdr_wc &wc) {
    (void)left;
    if (wc.status != TDR_WC_SUCCESS) return wc_fail(hub, "ring(wave)", wc);
    uint64_t kind = wc.wr_id & kWrKindMask;
    size_t idx = wc.wr_id & ~kWrKindMask;
    if (kind == kWrSend) {
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[idx % nc]);
        ac_s[idx % nc]++;
      }
      std::lock_guard<std::mutex> g(hub.mu);
      acked_s++;
      hub.bump_locked();
      return 0;
    }
    if (kind != kWrRecv) return 0;
    bool bad = false;
    {
      std::lock_guard<std::mutex> g(hub.mu);
      if (idx >= done_mask.size() || done_mask[idx] || idx % nc != chan)
        bad = true;
    }
    if (bad)
      return order_fail(hub, "ring(wave)",
                        "duplicate/foreign recv completion", chan);
    // Per-channel counter BEFORE the watermark publication (the
    // StepPipe/FusedTwo order): a consumer woken by the bump must see
    // the recv window already refilled, or it re-sleeps its full
    // slice with nothing left to notify it.
    {
      std::lock_guard<std::mutex> g(hub.chan_mu[chan]);
      dc_r[chan]++;
    }
    std::lock_guard<std::mutex> g(hub.mu);
    done_mask[idx] = 1;
    done_r++;
    while (frontier < done_mask.size() && done_mask[frontier]) frontier++;
    hub.bump_locked();
    return 0;
  }

  // The frontier's channel owes the oldest outstanding recv (it is
  // what every send dependency waits on); else any channel owing a
  // send ack.
  void owed_channel(bool *left, size_t *chan) {
    size_t c = 0;
    if (oldest_outstanding(hub, pc_r, dc_r, nc, &c) !=
        static_cast<size_t>(-1)) {
      *left = true;
      *chan = c;
      return;
    }
    for (size_t i = 0; i < nc; i++) {
      std::lock_guard<std::mutex> g(hub.chan_mu[i]);
      if (pc_s[i] > ac_s[i]) {
        *left = false;
        *chan = i;
        return;
      }
    }
    *left = true;
    *chan = 0;
  }

  bool finished_locked() const {
    return acked_s >= sends.size() && done_r >= recvs.size();
  }

  std::string stall_detail() {
    bool left = true;
    size_t chan = 0;
    owed_channel(&left, &chan);
    size_t as, dr, fr, dep = 0;
    {
      std::lock_guard<std::mutex> g(hub.mu);
      as = acked_s;
      dr = done_r;
      fr = frontier;
    }
    if (posted_s < sends.size()) dep = sends[posted_s].dep;
    return std::string("owed ") + (left ? "recv" : "send-ack") +
           " on channel " + std::to_string(chan) + "; s " +
           std::to_string(as) + "/" + std::to_string(sends.size()) +
           " r " + std::to_string(dr) + "/" +
           std::to_string(recvs.size()) + " frontier " +
           std::to_string(fr) + " next-dep " + std::to_string(dep);
  }

  int post_more() {
    bool progressed = false;
    // Keep the recv windows deep (disjoint targets; per-channel
    // FIFO-matched because global order IS per-channel order).
    while (posted_r < recvs.size()) {
      size_t c = posted_r % nc;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        if (pc_r[c] - dc_r[c] >= r_win[c]) break;
      }
      if (post_recv_item(posted_r) != 0) return -1;
      posted_r++;
      progressed = true;
    }
    // Post sends strictly in schedule order as their dependency
    // (the same-segment recv of the previous step) completes.
    // In-flight sends bounded by the peer's per-channel recv window
    // (≈ r_win; symmetric schedule) to avoid RNR storms on real
    // HCAs.
    while (posted_s < sends.size()) {
      size_t c = posted_s % nc;
      {
        std::lock_guard<std::mutex> g(hub.chan_mu[c]);
        if (pc_s[c] - ac_s[c] >= r_win[c]) break;
      }
      {
        std::lock_guard<std::mutex> g(hub.mu);
        if (frontier < sends[posted_s].dep) break;
      }
      if (post_send_item(posted_s) != 0) return -1;
      posted_s++;
      progressed = true;
    }
    return progressed ? 1 : 0;
  }

  int run() {
    nc = r->lefts.size();
    hub.init(nc);
    const size_t N = sends.size(), M = recvs.size();
    {
      std::lock_guard<std::mutex> g(hub.mu);
      done_mask.assign(M, 0);
      frontier = 0;
      acked_s = done_r = 0;
    }
    pc_r.assign(nc, 0);
    dc_r.assign(nc, 0);
    pc_s.assign(nc, 0);
    ac_s.assign(nc, 0);
    r_win.assign(nc, 0);
    // Mixed reduce/place recv stream: bound each channel's window by
    // its engine-side reduce-recv budget (conservative for place-only
    // spans, but the window refills as completions retire).
    for (size_t c = 0; c < nc; c++)
      r_win[c] = reduce_recv_window(r->lefts[c]);

    const size_t shards = tdr::progress_shards_for(nc);
    if (shards > 0 && N + M >= 4)
      return drive_sharded(r, *this, hub, shards, true, "ring(wave)");

    StallClock clock;
    for (;;) {
      {
        std::lock_guard<std::mutex> g(hub.mu);
        if (finished_locked()) break;
      }
      if (clock.deadline_exceeded())
        return deadline_fail(r, "ring(wave)", stall_detail());
      int p = post_more();
      if (p < 0) return -1;
      int nl = sweep_side(r->lefts, *this, true);
      if (nl < 0) return -1;
      int nr = sweep_side(r->rights, *this, false);
      if (nr < 0) return -1;
      if (p > 0 || nl > 0 || nr > 0) {
        clock.bump();
        continue;
      }
      int n = wait_owed(r, *this, 50);
      if (n < 0) return -1;
      if (n > 0) {
        clock.bump();
        continue;
      }
      if (clock.expired()) return stall_fail(r, "ring(wave)", stall_detail());
    }
    return 0;
  }
};


// Segment layout shared by allreduce and the standalone phases:
// world segments, first `rem` get one extra element.
void seg_layout(int world, size_t count, size_t esz,
                std::vector<size_t> *off, std::vector<size_t> *len) {
  off->resize(world);
  len->resize(world);
  size_t base = count / world, rem = count % world;
  size_t o = 0;
  for (int i = 0; i < world; i++) {
    (*off)[i] = o * esz;
    (*len)[i] = (base + (static_cast<size_t>(i) < rem ? 1 : 0)) * esz;
    o += base + (static_cast<size_t>(i) < rem ? 1 : 0);
  }
}

// Deregister a per-call (non-front-loaded) data MR on scope exit.
struct OwnedMrGuard {
  tdr_mr *mr;
  bool active;
  ~OwnedMrGuard() {
    if (active && mr) tdr_dereg_mr(mr);
  }
};

// Per-call-MR teardown race fix (documented by PR 7's conn-drop test):
// when a collective FAILS on this rank while its data MR was
// per-call-registered, returning immediately deregisters that MR while
// the peer may still have landings in flight on the surviving
// channels — those landings then complete the PEER's sends with
// LOC_ACCESS_ERR (non-retryable by taxonomy) even though the
// underlying fault was a transient drop. Defer the invalidation: keep
// the MR alive through a bounded quiet-interval drain, discarding
// completions until the QPs go quiet (the owed in-flight landings have
// materialized, or the sockets are dead and nothing more can arrive),
// and only then let OwnedMrGuard dereg. Success paths never get here —
// a finished schedule consumed every owed completion — so the steady
// state pays nothing; the discarded completions belong to the failed
// collective, which the caller recovers from by rebuilding.
void quiesce_before_dereg(tdr_ring *r, bool owned) {
  if (!owned) return;
  using clock = std::chrono::steady_clock;
  const auto quiet = std::chrono::milliseconds(100);
  const auto deadline =
      clock::now() +
      std::chrono::milliseconds(std::min(2000, ring_timeout_ms()));
  auto quiet_dl = clock::now() + quiet;
  tdr_wc wc[16];
  const bool same_qp = (r->lefts[0] == r->rights[0]);
  while (clock::now() < deadline && clock::now() < quiet_dl) {
    int got = 0;
    for (tdr_qp *qp : r->lefts) {
      int n = tdr_poll(qp, wc, 16, 0);
      if (n > 0) got += n;
    }
    if (!same_qp) {
      for (tdr_qp *qp : r->rights) {
        int n = tdr_poll(qp, wc, 16, 0);
        if (n > 0) got += n;
      }
    }
    if (got)
      quiet_dl = clock::now() + quiet;
    else
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
  }
}

// The generic schedule's two phases, shared verbatim between
// allreduce and the standalone reduce_scatter/all_gather so the
// documented bit-for-bit composition identity cannot drift.
// Phase 1: reduce-scatter. After step s, segment (rank-s-1) holds the
// partial sum of s+2 ranks; after world-1 steps each rank owns the
// full reduction of segment (rank+1) mod world.
int run_rs_phase(StepPipe &pipe, tdr_ring *r,
                 const std::vector<size_t> &seg_off,
                 const std::vector<size_t> &seg_len) {
  const int world = r->world;
  for (int s = 0; s < world - 1; s++) {
    int send_seg = ((r->rank - s) % world + world) % world;
    int recv_seg = ((r->rank - s - 1) % world + world) % world;
    if (pipe.run(seg_off[send_seg], seg_len[send_seg], seg_off[recv_seg],
                 seg_len[recv_seg], /*reduce=*/true) != 0)
      return -1;
  }
  return 0;
}

// Phase 2: all-gather — fully-reduced segments circulate; received
// bytes land directly in the data MR (no scratch, no extra copy).
int run_ag_phase(StepPipe &pipe, tdr_ring *r,
                 const std::vector<size_t> &seg_off,
                 const std::vector<size_t> &seg_len) {
  const int world = r->world;
  for (int s = 0; s < world - 1; s++) {
    int send_seg = ((r->rank + 1 - s) % world + world) % world;
    int recv_seg = ((r->rank - s) % world + world) % world;
    if (pipe.run(seg_off[send_seg], seg_len[send_seg], seg_off[recv_seg],
                 seg_len[recv_seg], /*reduce=*/false) != 0)
      return -1;
  }
  return 0;
}

}  // namespace
}  // extern "C++"

int tdr_ring_allreduce(tdr_ring *r, void *data, size_t count, int dtype,
                       int red_op) {
  if (!r || !data) {
    tdr::set_error("ring_allreduce: null ring or data");
    return -1;
  }
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    tdr::set_error("ring: bad dtype");
    return -1;
  }
  if (dtype == TDR_DT_U8) {
    tdr::set_error("ring_allreduce: u8 is byte-transport only (no fold semantics)");
    return -1;
  }
  if (dtype == TDR_DT_I8) {
    tdr::set_error(
        "ring_allreduce: i8 reduces only via tdr_ring_allreduce_q8 "
        "(a scale-less int8 sum overflows)");
    return -1;
  }
  if (count == 0) return 0;
  // Fault-plan site "ring" (TDR_FAULT_PLAN, fault.cc): a transient
  // collective failure injected BEFORE any posting — the recovery
  // layer's deterministic trigger. The caller sees the same shape of
  // error a mid-step peer loss produces (retryable, nothing posted).
  {
    int f = tdr::fault_point("ring");
    if (f >= 0) {
      tdr::set_error("ring: fault injected (completion error status " +
                     std::to_string(f) + ")");
      return -1;
    }
  }
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  const size_t nbytes = count * esz;
  RingTelScope tel(r, nbytes);

  std::vector<size_t> seg_off, seg_len;
  seg_layout(world, count, esz, &seg_off, &seg_len);

  bool owned = false;
  tdr_mr *dmr = r->data_mr(data, nbytes, &owned);
  if (!dmr) return tel.finish(-1);
  if (!tdr_mr_cpu_foldable(dmr)) {
    // EVERY schedule folds host-side somewhere (recv_reduce slots or
    // the scratch window into the data pointer) — over a CPU-less
    // dma-buf MR that would scribble through a device IOVA. Fail
    // clearly up front; such buffers need switch offload or a
    // host-visible mapping (the emu backend mmaps its dma-bufs, so
    // only real-HCA device memory lands here).
    if (owned) tdr_dereg_mr(dmr);
    tdr::set_error(
        "ring_allreduce: data MR has no CPU mapping (verbs dma-buf); "
        "host-side reduction is impossible — register CPU-visible "
        "memory or use a host-staged collective");
    return tel.finish(-1);
  }
  OwnedMrGuard guard{dmr, owned};
  (void)guard;

  // World-2 fast path: phases overlapped chunk-wise (see FusedTwo).
  // Segment roles per the generic schedule below at world=2: this rank
  // sends seg[rank] out first (phase-1 send) and folds seg[1-rank].
  // Entry is gated on the NEGOTIATED fused2 capability (both ends
  // advertised it in the handshake; TDR_NO_FUSED2 acts there), so a
  // per-rank opt-out degrades BOTH ranks to the compatible rightward
  // schedule instead of a wire mismatch.
  if (world == 2 && r->left != r->right &&
      tdr_qp_has_recv_reduce(r->left) && tdr_qp_has_fused2(r->left) &&
      tdr_qp_has_fused2(r->right)) {
    FusedTwo f;
    f.r = r;
    f.dmr = dmr;
    f.dtype = dtype;
    f.red_op = red_op;
    f.chunk = r->chunk;
    f.a_off = seg_off[r->rank];
    f.a_len = seg_len[r->rank];
    f.b_off = seg_off[1 - r->rank];
    f.b_len = seg_len[1 - r->rank];
    f.n_a = FusedTwo::nchunks(f.a_len, f.chunk);
    f.n_b = FusedTwo::nchunks(f.b_len, f.chunk);
    // Foldback is a NEGOTIATED capability (both ends advertised it in
    // the QP handshake, where TDR_NO_FOLDBACK/TDR_NO_FUSED2 act), so
    // both ranks take the same branch here by construction.
    f.use_fb = tdr_qp_has_send_foldback(r->right);
    r->last_sched = f.use_fb ? TDR_SCHED_FUSED2_FB : TDR_SCHED_FUSED2;
    int rc = f.run();
    if (rc != 0) quiesce_before_dereg(r, owned);
    return tel.finish(rc);
  }

  // General wavefront path: the full 2(world-1)-step schedule
  // flattened into windowed lexicographic send/recv streams (see
  // Wavefront above). Needs reduce-on-receive (folds land in the data
  // MR from the progress engine) and distinct neighbor QPs.
  if (r->left != r->right && tdr_qp_has_recv_reduce(r->left) &&
      !wavefront_disabled()) {
    const size_t chunk = r->chunk;
    auto nch = [&](size_t len) {
      return len ? (len + chunk - 1) / chunk : size_t(0);
    };
    auto clen = [&](size_t total, size_t c) {
      return std::min(chunk, total - c * chunk);
    };
    const int steps = 2 * (world - 1);
    auto segs_at = [&](int t, int *send_seg, int *recv_seg) {
      if (t < world - 1) {  // reduce-scatter
        *send_seg = ((r->rank - t) % world + world) % world;
        *recv_seg = ((r->rank - t - 1) % world + world) % world;
      } else {  // all-gather
        int s2 = t - (world - 1);
        *send_seg = ((r->rank + 1 - s2) % world + world) % world;
        *recv_seg = ((r->rank - s2) % world + world) % world;
      }
    };
    // Last-RS-step foldback: the sends of step world-2 become
    // fold-and-write-back sends, so each rank's fully-reduced owned
    // segment comes back IN PLACE as the write-back — which is byte-
    // for-byte what the LAST all-gather step would have delivered.
    // That whole step (its sends and recvs, one full segment of
    // traffic and latency per rank) disappears: 2(world-1) steps
    // become 2*world-3. Every rank must take the same branch: the
    // gating condition (both neighbor QPs negotiated foldback) is
    // part of the Python layer's schedule digest, so a ring with
    // per-rank foldback divergence fails fast instead of
    // desynchronizing.
    const bool wave_fb = tdr_qp_has_send_foldback(r->right) &&
                         tdr_qp_has_send_foldback(r->left) &&
                         !tdr::env_set("TDR_NO_WAVE_FB");
    const int eff_steps = wave_fb ? steps - 1 : steps;
    Wavefront wf;
    wf.r = r;
    wf.dmr = dmr;
    wf.dtype = dtype;
    wf.red_op = red_op;
    std::vector<size_t> rprefix(steps + 1, 0);
    for (int t = 0; t < steps; t++) {
      int ss, rs;
      segs_at(t, &ss, &rs);
      rprefix[t + 1] = rprefix[t] + nch(seg_len[rs]);
    }
    for (int t = 0; t < eff_steps; t++) {
      int ss, rs;
      segs_at(t, &ss, &rs);
      const bool fold = t < world - 1;
      for (size_t c = 0; c < nch(seg_len[ss]); c++) {
        WaveItem it{seg_off[ss] + c * chunk, clen(seg_len[ss], c), false,
                    0, wave_fb && t == world - 2};
        // send (t,c) forwards the bytes recv (t-1,c) produced —
        // send_seg(t) IS recv_seg(t-1) — so its dependency is that
        // many completed receives.
        if (t > 0) it.dep = rprefix[t - 1] + c + 1;
        wf.sends.push_back(it);
      }
      for (size_t c = 0; c < nch(seg_len[rs]); c++)
        wf.recvs.push_back({seg_off[rs] + c * chunk, clen(seg_len[rs], c),
                            fold, 0});
    }
    r->last_sched = TDR_SCHED_WAVEFRONT;
    int rc = wf.run();
    if (rc != 0) quiesce_before_dereg(r, owned);
    return tel.finish(rc);
  }

  r->last_sched = TDR_SCHED_GENERIC;
  StepPipe pipe{r, dmr, static_cast<char *>(data), dtype, red_op, esz};
  int rc = run_rs_phase(pipe, r, seg_off, seg_len);
  if (rc == 0) rc = run_ag_phase(pipe, r, seg_off, seg_len);
  if (rc != 0) quiesce_before_dereg(r, owned);
  return tel.finish(rc);
}

// ------------------------------------------------------------------
// Standalone reduce-scatter / all-gather / broadcast — the rest of
// the MPI-app collective surface (SURVEY §1 L5, README.md:64: "IB
// Verbs interface must be used"; perftest/MPI consumers expect more
// than allreduce). reduce_scatter/all_gather ARE the allreduce's two
// generic phases (run_rs_phase/run_ag_phase — shared code, so the
// bit-for-bit composition identity cannot drift), with the same
// segment layout and the (rank+1) % world ownership convention.
// They always run the barrier-stepped generic schedule; the fused
// world-2 exchange and the flattened wavefront interleave the two
// phases and so exist only for the full allreduce — callers hot
// enough to care should call tdr_ring_allreduce, not the
// composition (measured 1.53x at world 4, SWEEP_W4_r05.json).
// ------------------------------------------------------------------

int tdr_ring_reduce_scatter(tdr_ring *r, void *data, size_t count,
                            int dtype, int red_op, size_t *own_off,
                            size_t *own_len) {
  if (!r || !data) {
    tdr::set_error("ring_reduce_scatter: null ring or data");
    return -1;
  }
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    tdr::set_error("ring: bad dtype");
    return -1;
  }
  if (dtype == TDR_DT_U8 || dtype == TDR_DT_I8) {
    tdr::set_error("ring_reduce_scatter: u8/i8 is byte-transport only (no fold semantics)");
    return -1;
  }
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  std::vector<size_t> seg_off, seg_len;
  seg_layout(world, count, esz, &seg_off, &seg_len);
  const int own = (r->rank + 1) % world;
  if (own_off) *own_off = seg_off[own];
  if (own_len) *own_len = seg_len[own];
  if (count == 0 || world == 1) return 0;
  RingTelScope tel(r, count * esz);
  bool owned = false;
  tdr_mr *dmr = r->data_mr(data, count * esz, &owned);
  if (!dmr) return tel.finish(-1);
  OwnedMrGuard guard{dmr, owned};
  (void)guard;
  if (!tdr_mr_cpu_foldable(dmr)) {
    tdr::set_error("ring_reduce_scatter: data MR has no CPU mapping");
    return tel.finish(-1);
  }
  StepPipe pipe{r, dmr, static_cast<char *>(data), dtype, red_op, esz};
  int rc = run_rs_phase(pipe, r, seg_off, seg_len);
  if (rc != 0) quiesce_before_dereg(r, owned);
  return tel.finish(rc);
}

int tdr_ring_all_gather(tdr_ring *r, void *data, size_t count, int dtype) {
  if (!r || !data) {
    tdr::set_error("ring_all_gather: null ring or data");
    return -1;
  }
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    tdr::set_error("ring: bad dtype");
    return -1;
  }
  if (count == 0) return 0;
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  if (world == 1) return 0;
  std::vector<size_t> seg_off, seg_len;
  seg_layout(world, count, esz, &seg_off, &seg_len);
  RingTelScope tel(r, count * esz);
  bool owned = false;
  tdr_mr *dmr = r->data_mr(data, count * esz, &owned);
  if (!dmr) return tel.finish(-1);
  OwnedMrGuard guard{dmr, owned};
  (void)guard;
  StepPipe pipe{r, dmr, static_cast<char *>(data), dtype, TDR_RED_SUM, esz};
  int rc = run_ag_phase(pipe, r, seg_off, seg_len);
  if (rc != 0) quiesce_before_dereg(r, owned);
  return tel.finish(rc);
}

namespace {

// Shared progress pump for the CHAIN collectives (broadcast down the
// ring, reduce converging toward root): window-bounded recv posting
// on the left QP, dependency-gated forwarding on the right (chunk i
// forwards only after chunk i landed, unless this rank is the chain
// head), opportunistic then blocking drains. The two callers differ
// ONLY in how a recv posts (plain vs reduce-on-receive), the window
// sizes, and the error label.
struct ChainPump {
  tdr_ring *r;
  size_t n_recv, n_send;
  size_t recv_win, send_win;
  bool head;  // no upstream: sends gate on nothing
  const char *label;
  // Dependency slack: send i may post once done_r >= i+1-send_lead.
  // 0 (chain collectives): forwarding send i needs recv i landed.
  // 1 (alltoall): send 0 carries locally-built data and must go
  // unconditionally or every rank deadlocks waiting for a first recv;
  // send i>=1 forwards the tail of recv i-1.
  size_t send_lead = 0;

  size_t posted_r = 0, done_r = 0, posted_s = 0, acked_s = 0;

  int run(const std::function<int(size_t)> &post_recv,
          const std::function<int(size_t)> &post_send) {
    const bool same_qp = (r->left == r->right);
    auto drain = [&](tdr_qp *qp, int timeout_ms) -> int {
      tdr_wc wc[16];
      int c = tdr_poll(qp, wc, 16, timeout_ms);
      if (c < 0) return -1;
      for (int i = 0; i < c; i++) {
        if (wc[i].status != TDR_WC_SUCCESS) {
          tdr::set_error(std::string(label) + ": completion error status " +
                         wc_status_label(wc[i].status));
          return -1;
        }
        uint64_t kind = wc[i].wr_id & kWrKindMask;
        if (kind == kWrSend) {
          acked_s++;
        } else if (kind == kWrRecv) {
          size_t idx = wc[i].wr_id & ~kWrKindMask;
          if (idx != done_r) {
            tdr::set_error(std::string(label) +
                           ": out-of-order recv completion");
            return -1;
          }
          done_r++;
        }
      }
      return c;
    };

    while (done_r < n_recv || acked_s < n_send) {
      bool progressed = false;
      while (posted_r < n_recv && posted_r - done_r < recv_win) {
        if (post_recv(posted_r) != 0) return -1;
        posted_r++;
        progressed = true;
      }
      while (posted_s < n_send && posted_s - acked_s < send_win &&
             (head || posted_s < done_r + send_lead)) {
        if (post_send(posted_s) != 0) return -1;
        posted_s++;
        progressed = true;
      }
      int nl = n_recv ? drain(r->left, 0) : 0;
      if (nl < 0) return -1;
      int nr = (n_send && !same_qp) ? drain(r->right, 0) : 0;
      if (nr < 0) return -1;
      if (nl > 0 || nr > 0) progressed = true;
      if (!progressed) {
        tdr_qp *qp = (done_r < n_recv) ? r->left : r->right;
        int c = drain(qp, ring_timeout_ms());
        if (c < 0) return -1;
        if (c == 0) {
          tdr::set_error(std::string(label) + ": poll timeout (s " +
                         std::to_string(acked_s) + "/" +
                         std::to_string(n_send) + " r " +
                         std::to_string(done_r) + "/" +
                         std::to_string(n_recv) + ")");
          return -1;
        }
      }
    }
    return 0;
  }
};

}  // namespace

int tdr_ring_reduce(tdr_ring *r, void *data, size_t count, int dtype,
                    int red_op, int root) {
  if (!r || !data) {
    tdr::set_error("ring_reduce: null ring or data");
    return -1;
  }
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    tdr::set_error("ring: bad dtype");
    return -1;
  }
  if (dtype == TDR_DT_U8 || dtype == TDR_DT_I8) {
    tdr::set_error("ring_reduce: u8/i8 is byte-transport only (no fold semantics)");
    return -1;
  }
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  if (root < 0 || root >= world) {
    tdr::set_error("ring_reduce: bad root");
    return -1;
  }
  if (count == 0 || world == 1) return 0;
  const size_t nbytes = count * esz;
  RingTelScope tel(r, nbytes);
  bool owned = false;
  tdr_mr *dmr = r->data_mr(data, nbytes, &owned);
  if (!dmr) return tel.finish(-1);
  OwnedMrGuard guard{dmr, owned};
  (void)guard;
  if (!tdr_mr_cpu_foldable(dmr)) {
    tdr::set_error("ring_reduce: data MR has no CPU mapping");
    return tel.finish(-1);
  }
  if (!tdr_qp_has_recv_reduce(r->left)) {
    // Only the RECEIVING side needs the fused op (a plain SEND
    // matches a posted recv_reduce fine); both in-repo engines
    // advertise it, so this guards future engines only.
    tdr::set_error("ring_reduce: engine lacks reduce-on-receive");
    return tel.finish(-1);
  }

  // Converging fold toward root, rightward along the ring: the chain
  // head ((root+1) % world) streams its buffer right; every
  // intermediate rank reduce-receives inbound chunks INTO its own
  // buffer (the fused recv_reduce op — fold completion IS the recv
  // completion) and forwards the folded chunk on; root only
  // reduce-receives. One N-byte pass per link, chunk-pipelined.
  // In-place and destructive on non-root ranks: their buffers end
  // holding the partial sums that passed through them. Windows: recv
  // bounded by OUR reduce-recv budget, sends by the downstream
  // peer's (symmetric config).
  const size_t chunk = r->chunk;
  const size_t n = (nbytes + chunk - 1) / chunk;
  const int d = ((r->rank - root) % world + world) % world;
  auto clen = [&](size_t i) { return std::min(chunk, nbytes - i * chunk); };
  ChainPump pump{r,
                 /*n_recv=*/d != 1 ? n : 0,
                 /*n_send=*/d != 0 ? n : 0,
                 /*recv_win=*/reduce_recv_window(r->left),
                 /*send_win=*/reduce_recv_window(r->right),
                 /*head=*/d == 1,
                 "ring(reduce)"};
  return tel.finish(pump.run(
      [&](size_t i) {
        return tdr_post_recv_reduce(r->left, dmr, i * chunk, clen(i),
                                    dtype, red_op, kWrRecv | i);
      },
      [&](size_t i) {
        return tdr_post_send(r->right, dmr, i * chunk, clen(i),
                             kWrSend | i);
      }));
}

int tdr_ring_broadcast(tdr_ring *r, void *data, size_t nbytes, int root) {
  if (!r || !data) {
    tdr::set_error("ring_broadcast: null ring or data");
    return -1;
  }
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  if (root < 0 || root >= world) {
    tdr::set_error("ring_broadcast: bad root");
    return -1;
  }
  if (nbytes == 0 || world == 1) return 0;
  RingTelScope tel(r, nbytes);
  bool owned = false;
  tdr_mr *dmr = r->data_mr(data, nbytes, &owned);
  if (!dmr) return tel.finish(-1);
  OwnedMrGuard guard{dmr, owned};
  (void)guard;

  // Store-and-forward pipeline down the ring: the root streams chunks
  // rightward; middle ranks forward chunk i the moment its receive
  // lands (bytes are final — each chunk is received exactly once, so
  // the forwarding send may safely read the data MR); the last rank
  // ((root-1+world) % world) only receives. Bandwidth-optimal for
  // large messages, latency (world-1) extra chunks.
  const size_t chunk = r->chunk;
  const size_t n = (nbytes + chunk - 1) / chunk;
  const int d = ((r->rank - root) % world + world) % world;
  auto clen = [&](size_t i) { return std::min(chunk, nbytes - i * chunk); };
  ChainPump pump{r,
                 /*n_recv=*/d != 0 ? n : 0,
                 /*n_send=*/d != world - 1 ? n : 0,
                 /*recv_win=*/kMaxOutstanding,
                 /*send_win=*/kMaxOutstanding,
                 /*head=*/d == 0,
                 "ring(bcast)"};
  return tel.finish(pump.run(
      [&](size_t i) {
        return tdr_post_recv(r->left, dmr, i * chunk, clen(i),
                             kWrRecv | i);
      },
      [&](size_t i) {
        return tdr_post_send(r->right, dmr, i * chunk, clen(i),
                             kWrSend | i);
      }));
}

namespace {
// The alltoall staging can dwarf what any other collective retains:
// keep small scratch cached (steady-state reuse) but release
// oversized growth rather than pinning it for the ring's lifetime.
void release_big_scratch(tdr_ring *r, size_t total) {
  if (total <= (64u << 20)) return;
  if (r->tmp_mr) {
    tdr_dereg_mr(r->tmp_mr);
    r->tmp_mr = nullptr;
  }
  r->tmp.clear();
  r->tmp.shrink_to_fit();
}
}  // namespace

/* In-place all-to-all (MPI_Alltoall with MPI_IN_PLACE semantics):
 * ``data`` holds ``world`` equal segments; segment j is FOR rank j on
 * entry and FROM rank j on return (this rank's own segment is
 * untouched). Bundle-shrink ring schedule: rank r first sends the
 * w-1 foreign segments ordered by destination distance
 * [dst r+1, r+2, ...]; each received bundle's head is addressed to
 * this rank (kept) and its tail IS the next step's send bundle,
 * forwarded straight out of the receive slot — no re-pack copy. Per
 * link w(w-1)/2 segments cross, the ring-topology optimum for
 * store-and-forward all-to-all. */
int tdr_ring_alltoall(tdr_ring *r, void *data, size_t count, int dtype) {
  if (!r || !data) {
    tdr::set_error("ring_alltoall: null ring or data");
    return -1;
  }
  size_t esz = dtype_size(dtype);
  if (esz == 0) {
    tdr::set_error("ring: bad dtype");
    return -1;
  }
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  if (count % static_cast<size_t>(world) != 0) {
    tdr::set_error("ring_alltoall: count must divide evenly by world "
                   "(equal segments, MPI_Alltoall semantics)");
    return -1;
  }
  if (count == 0 || world == 1) return 0;
  RingTelScope tel(r, count * esz);
  const size_t segsz = count / world * esz;
  const int rank = r->rank;
  const size_t steps = static_cast<size_t>(world) - 1;

  if (world == 2) {
    // Direct exchange: ONE foreign segment each way. Stage only the
    // outgoing segment (its slot in `data` is about to be overwritten
    // by the inbound one — sending straight from `data` would race
    // the landing recv), receive the peer's segment directly into
    // place. One local copy instead of the bundle path's three.
    const size_t peer = static_cast<size_t>(1 - rank);
    char *db = static_cast<char *>(data);
    // Prefer a caller-registered full-buffer MR (front-loaded
    // registration); otherwise pin ONLY the received segment — the
    // wire never touches the rest of the buffer.
    tdr_mr *dmr = nullptr;
    bool owned = false;
    size_t roff = peer * segsz;
    auto it = r->registered.find(reinterpret_cast<uint64_t>(data));
    if (it != r->registered.end() &&
        tdr_mr_len(it->second) >= count * esz) {
      dmr = it->second;
    } else {
      dmr = tdr_reg_mr(r->eng, db + peer * segsz, segsz, 0);
      owned = true;
      roff = 0;
    }
    if (!dmr) return tel.finish(-1);
    OwnedMrGuard guard{dmr, owned};
    (void)guard;
    tdr_mr *smr = r->scratch(segsz);
    if (!smr) return tel.finish(-1);
    std::memcpy(r->tmp.data(), db + peer * segsz, segsz);
    ChainPump pump{r, /*n_recv=*/1, /*n_send=*/1, 1, 1, /*head=*/true,
                   "ring(alltoall2)"};
    int rc = pump.run(
        [&](size_t) {
          return tdr_post_recv(r->left, dmr, roff, segsz, kWrRecv | 0);
        },
        [&](size_t) {
          return tdr_post_send(r->right, smr, 0, segsz, kWrSend | 0);
        });
    if (rc == 0) release_big_scratch(r, segsz);
    return tel.finish(rc);
  }
  // No data MR on the general path: the user buffer never touches the
  // wire — bundles stage through the scratch MR and the buffer is
  // only memcpy'd, so registering it would be a pure per-call
  // pin/unpin tax.

  // Scratch: the outgoing first bundle (w-1 segments) + one receive
  // slot per step, slot ri sized (w-1-ri) segments.
  std::vector<size_t> slot_off(steps);
  size_t total = steps * segsz;  // first-bundle staging at offset 0
  for (size_t ri = 0; ri < steps; ri++) {
    slot_off[ri] = total;
    total += (steps - ri) * segsz;
  }
  tdr_mr *smr = r->scratch(total);
  if (!smr) return tel.finish(-1);
  char *sb = r->tmp.data();
  char *db = static_cast<char *>(data);

  // First bundle: foreign segments by destination distance.
  for (size_t i = 0; i < steps; i++) {
    int dst = static_cast<int>((rank + 1 + i) % world);
    std::memcpy(sb + i * segsz, db + static_cast<size_t>(dst) * segsz,
                segsz);
  }

  ChainPump pump{r,
                 /*n_recv=*/steps,
                 /*n_send=*/steps,
                 /*recv_win=*/kMaxOutstanding,
                 /*send_win=*/kMaxOutstanding,
                 /*head=*/false,
                 "ring(alltoall)"};
  pump.send_lead = 1;  // send 0 is locally built; send i forwards recv i-1
  int rc = pump.run(
      [&](size_t ri) {
        return tdr_post_recv(r->left, smr, slot_off[ri],
                             (steps - ri) * segsz, kWrRecv | ri);
      },
      [&](size_t i) {
        size_t off = i == 0 ? 0 : slot_off[i - 1] + segsz;
        return tdr_post_send(r->right, smr, off, (steps - i) * segsz,
                             kWrSend | i);
      });
  if (rc != 0) return tel.finish(rc);

  // Keep every bundle head: recv step ri carried the segment from
  // src (rank-1-ri) mod world addressed to this rank.
  for (size_t ri = 0; ri < steps; ri++) {
    int src = static_cast<int>(
        ((rank - 1 - static_cast<int>(ri)) % world + world) % world);
    std::memcpy(db + static_cast<size_t>(src) * segsz, sb + slot_off[ri],
                segsz);
  }
  release_big_scratch(r, total);
  return tel.finish(0);
}

/* int8 wire-compressed allreduce (see tdr.h): the textbook RS+AG ring
 * where every wire piece is [f32 running scale][int8 segment] inside
 * an ordinary sealed SEND payload — no frame-format change, so seal
 * verification and the NAK/retransmit heal apply to the compressed
 * pieces exactly as to any other payload. The fold REQUANTIZES under
 * the summed scale (fold_q8, util.cc), so magnitudes never clip at
 * any world size; the all-gather then circulates the reduced
 * [scale][q8] pieces VERBATIM, which is what makes the final dequant
 * bitwise identical on every rank (each segment's bits were produced
 * once, by its owner's fold chain, in ring order). Pieces stage
 * through the ring-owned scratch MR (the alltoall staging precedent):
 * the caller's q8/f32_out buffers never touch the wire, so no
 * per-call data MR and no quiesce-before-dereg hazard on failure. */
int tdr_ring_allreduce_q8(tdr_ring *r, void *q8, size_t count,
                          float scale_in, float *f32_out) {
  if (!r || !q8 || !f32_out) {
    tdr::set_error("ring_allreduce_q8: null ring or buffer");
    return -1;
  }
  // Capability gate, fatal: the peer must run the SAME quantized
  // schedule (piece sizes halve), so an un-negotiated ring fails fast
  // here instead of desynchronizing the wire. The Python digest pins
  // the fleet-wide agreement; this pins the per-link handshake.
  for (size_t c = 0; c < r->lefts.size(); c++) {
    if (!tdr_qp_has_wire_q8(r->lefts[c]) ||
        !tdr_qp_has_wire_q8(r->rights[c])) {
      tdr::set_error(
          "ring_allreduce_q8: FEAT_WIRE_Q8 not negotiated on this ring "
          "(legacy peer or TDR_NO_WIRE_Q8)");
      return -1;
    }
  }
  if (count == 0) return 0;
  // Same deterministic fault trigger as the blocking allreduce.
  {
    int f = tdr::fault_point("ring");
    if (f >= 0) {
      tdr::set_error("ring: fault injected (completion error status " +
                     std::to_string(f) + ")");
      return -1;
    }
  }
  std::lock_guard<std::mutex> g(r->mu);
  const int world = r->world;
  int8_t *q = static_cast<int8_t *>(q8);
  RingTelScope tel(r, count);  // semantic payload: count int8 bytes
  r->last_sched = TDR_SCHED_Q8;

  // esz 1: offsets/lengths are in elements AND bytes.
  std::vector<size_t> seg_off, seg_len;
  seg_layout(world, count, 1, &seg_off, &seg_len);
  size_t max_len = 0;
  for (size_t l : seg_len) max_len = std::max(max_len, l);
  const size_t piece = sizeof(float) + max_len;
  // Scratch: [send piece][recv piece]. Sends drain fully (send acked)
  // before the next step restages, so one slot each suffices.
  tdr_mr *smr = r->scratch(2 * piece);
  if (!smr) return tel.finish(-1);
  char *sb = r->tmp.data();
  char *rb = r->tmp.data() + piece;

  // Per-segment running scales: every rank starts from its own
  // per-bucket scale; a fold advances the receiving segment's scale
  // to the sum of the contributions folded so far.
  std::vector<float> scales(static_cast<size_t>(world), scale_in);

  // One ring step: stage [scale][q8] of send_seg, exchange with the
  // neighbors (recv posted before send, ChainPump discipline). Empty
  // segments still move their 4-byte scale header so the step count
  // stays uniform across ranks whatever count % world is.
  auto xfer = [&](int send_seg, int recv_seg) -> int {
    std::memcpy(sb, &scales[static_cast<size_t>(send_seg)], sizeof(float));
    std::memcpy(sb + sizeof(float), q + seg_off[send_seg],
                seg_len[send_seg]);
    ChainPump pump{r, /*n_recv=*/1, /*n_send=*/1, 1, 1, /*head=*/true,
                   "ring(q8)"};
    return pump.run(
        [&](size_t) {
          return tdr_post_recv(r->left, smr, piece,
                               sizeof(float) + seg_len[recv_seg],
                               kWrRecv | 0);
        },
        [&](size_t) {
          return tdr_post_send(r->right, smr, 0,
                               sizeof(float) + seg_len[send_seg],
                               kWrSend | 0);
        });
  };

  // Phase 1: reduce-scatter with the requantizing dequant-fold —
  // run_rs_phase's segment walk, piece-sized steps.
  int rc = 0;
  for (int s = 0; s < world - 1 && rc == 0; s++) {
    int send_seg = ((r->rank - s) % world + world) % world;
    int recv_seg = ((r->rank - s - 1) % world + world) % world;
    rc = xfer(send_seg, recv_seg);
    if (rc != 0) break;
    float s_f;
    std::memcpy(&s_f, rb, sizeof(float));
    tdr::fold_q8(q + seg_off[recv_seg],
                 scales[static_cast<size_t>(recv_seg)],
                 reinterpret_cast<const int8_t *>(rb + sizeof(float)),
                 s_f, seg_len[recv_seg]);
    scales[static_cast<size_t>(recv_seg)] += s_f;
  }

  // Phase 2: all-gather — the reduced [scale][q8] pieces circulate
  // verbatim (byte transport, no refold), run_ag_phase's walk.
  for (int s = 0; s < world - 1 && rc == 0; s++) {
    int send_seg = ((r->rank + 1 - s) % world + world) % world;
    int recv_seg = ((r->rank - s) % world + world) % world;
    rc = xfer(send_seg, recv_seg);
    if (rc != 0) break;
    std::memcpy(&scales[static_cast<size_t>(recv_seg)], rb,
                sizeof(float));
    std::memcpy(q + seg_off[recv_seg], rb + sizeof(float),
                seg_len[recv_seg]);
  }

  if (rc == 0) {
    for (int i = 0; i < world; i++)
      tdr::dequant_q8(f32_out + seg_off[i], q + seg_off[i], seg_len[i],
                      scales[static_cast<size_t>(i)]);
    release_big_scratch(r, 2 * piece);
  }
  return tel.finish(rc);
}

}  // extern "C"
