// Internal engine interfaces shared by the emulated and verbs backends.
#ifndef TDR_COMMON_H_
#define TDR_COMMON_H_

#include <sys/types.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>

#include "tdr/tdr.h"

namespace tdr {

// Thread-local error slot surfaced via tdr_last_error().
void set_error(const std::string &msg);
const char *get_error();

// ------------------------------------------------------------------
// Flight recorder (telemetry.cc): the engine-side event ring +
// log2-bucket histograms behind TDR_TELEMETRY (see tdr.h for the
// public surface and event taxonomy). The contract every call site
// honors: when telemetry is off, the site costs ONE predicted branch
// (an atomic relaxed load) — no clock read, no lock, no store — so
// the zero-copy hot path is unchanged. Track ids are assigned
// unconditionally (they are just counters) so exported timelines stay
// stable whether recording was on from the start or enabled later.
// ------------------------------------------------------------------
// 0 = not yet parsed, 1 = off, 2 = on.
extern std::atomic<int> g_tel_state;
int tel_state_init();  // parses TDR_TELEMETRY once; returns 1 or 2
inline bool tel_on() {
  int s = g_tel_state.load(std::memory_order_relaxed);
  if (__builtin_expect(s == 0, 0)) s = tel_state_init();
  return s == 2;
}
uint64_t tel_now_ns();
// coll = collective trace id (0 = none): posting sites pass the
// ring-stamped id; landing sites pass the frame-carried one.
void tel_emit(uint16_t type, uint16_t engine, uint32_t qp, uint64_t id,
              uint64_t arg, uint64_t coll = 0);
void tel_hist_add(int which, uint64_t value);
uint16_t tel_next_engine_id();
uint32_t tel_next_qp_id();
// Stable per-THREAD track id (lazily drawn from the QP track space):
// names the timeline lane of helper threads that are not QPs — fold
// workers and ring progress shards — so exported traces show their
// work as parallel lanes instead of folding it into the engine track.
uint32_t tel_thread_track();

// One-branch event site: evaluates its arguments only when recording.
#define TDR_TEL(type, eng, qp, id, arg)                                  \
  do {                                                                   \
    if (tdr::tel_on()) tdr::tel_emit((type), (eng), (qp), (id), (arg));  \
  } while (0)

// Collective-tagged variant (same one-branch guard).
#define TDR_TELC(type, eng, qp, id, arg, coll)                           \
  do {                                                                   \
    if (tdr::tel_on())                                                   \
      tdr::tel_emit((type), (eng), (qp), (id), (arg), (coll));           \
  } while (0)

class Engine;

class Mr {
 public:
  virtual ~Mr() = default;
  Engine *engine = nullptr;
  uint64_t addr = 0;  // registered VA (or IOVA for dma-buf MRs)
  uint64_t len = 0;
  uint32_t lkey = 0;
  uint32_t rkey = 0;
  int access = 0;
  std::atomic<bool> valid{true};
  // Whether the CPU can fold into this MR's memory (reduce-on-receive
  // and the scratch-fold schedules need it). False only for verbs
  // dma-buf MRs, which have no CPU mapping — an allreduce over such a
  // buffer needs switch offload (SHARP-class) or a host bounce, and
  // the ring fails it up front with a clear error instead of
  // scribbling through a device IOVA as if it were a pointer.
  virtual bool cpu_foldable() const { return true; }
  // Revoke: remote access must start failing immediately.
  virtual int invalidate() = 0;
};

class Qp {
 public:
  virtual ~Qp() = default;
  // Telemetry track id — a process-wide bring-up ordinal, assigned
  // whether or not recording is on (it names the exported timeline).
  const uint32_t tel_id = tel_next_qp_id();
  // Owning engine for live-QP accounting (set by the C API at
  // bring-up; the engine must outlive its QPs, which the close
  // discipline — QPs first, engine last — already requires).
  Engine *owner = nullptr;
  // Collective trace id of the collective currently posting on this
  // QP (0 = none): stamped by the ring layer at collective entry, read
  // by the posting-path event sites and — when FEAT_COLL_ID is
  // negotiated — written into outbound frame headers. Purely
  // observational; a stale value mislabels a telemetry event, never
  // a result.
  std::atomic<uint64_t> cur_coll{0};
  virtual int post_write(Mr *lmr, size_t loff, uint64_t raddr, uint32_t rkey,
                         size_t len, uint64_t wr_id) = 0;
  virtual int post_read(Mr *lmr, size_t loff, uint64_t raddr, uint32_t rkey,
                        size_t len, uint64_t wr_id) = 0;
  virtual int post_send(Mr *lmr, size_t loff, size_t len, uint64_t wr_id) = 0;
  virtual int post_recv(Mr *lmr, size_t loff, size_t maxlen,
                        uint64_t wr_id) = 0;
  // Fused reduce-on-receive (the SHARP-style offload): the inbound
  // SEND payload is folded into the recv buffer (dst op= src) by the
  // progress engine instead of overwriting it — no scratch buffer, no
  // second pass. Engines without the capability return -1.
  virtual int post_recv_reduce(Mr *, size_t, size_t, int /*dtype*/,
                               int /*red_op*/, uint64_t) {
    set_error("recv_reduce: not supported by this engine");
    return -1;
  }
  virtual bool has_recv_reduce() const { return false; }
  // Fused fold-and-write-back send: the peer folds the payload into
  // its matched recv_reduce buffer and writes the folded result back
  // in place over this send's source; completion fires after the
  // write-back lands (see tdr.h).
  virtual int post_send_foldback(Mr *, size_t, size_t, uint64_t) {
    set_error("send_foldback: not supported by this engine");
    return -1;
  }
  virtual bool has_send_foldback() const { return false; }
  // Negotiated participation in the world-2 fused exchange schedule
  // (wire-incompatible with the rightward-only schedules); both ends
  // must advertise it in the handshake before a ring may enter it.
  virtual bool has_fused2() const { return false; }
  // THREAD-SAFETY CONTRACT for poll(): poll may run concurrently with
  // posts on the same QP and with polls/posts on OTHER QPs (each
  // backend's completion queue is internally locked). Concurrent
  // polls on the SAME QP are also safe — each completion is delivered
  // to exactly one poller — but they race for completions, so the
  // sharded progress engine assigns every QP to exactly one shard.
  // Engines whose reduce-on-receive stages through bounded slots (the
  // verbs backend: an HCA has no fold ALU) advertise how many
  // recv_reduce postings may be in flight; 0 = unbounded (emu folds
  // straight off the wire). The ring layer sizes its recv window to
  // this so staging memory stays at window * chunk bytes.
  virtual size_t rr_window_hint() const { return 0; }
  // Whether payload sealing (CRC32C + incarnation tag, NAK/retransmit
  // on verify failure) was negotiated with the peer. Emu-only: the
  // verbs wire has ICRC; host-side sealing there would double-touch
  // every byte for protection the link already provides.
  virtual bool has_seal() const { return false; }
  // Whether the negotiated seal's CRC covers the PAYLOAD bytes: true
  // on the stream tier, false on the CMA tier unless both ends
  // advertised FEAT_SEAL_CMA_FULL (the tag/steering fields are always
  // covered on sealed connections).
  virtual bool has_seal_payload() const { return has_seal(); }
  // Whether FEAT_COLL_ID was negotiated (frames carry the collective
  // trace id to the peer; emu only, and only when both ends were
  // recording at handshake time).
  virtual bool has_coll_id() const { return false; }
  // Whether FEAT_WIRE_Q8 was negotiated: both ends are willing to run
  // the int8 quantized ring schedule (tdr_ring_allreduce_q8). Queried
  // per link by the health ladder's int8 rung.
  virtual bool has_wire_q8() const { return false; }
  // Link identity for fault riders and health attribution: the ring
  // layer stamps (lane, self rank, peer rank) at channel bring-up so
  // netem clauses can scope to one link and the probe/stall telemetry
  // names the edge. -1 = unstamped (control QPs, direct API users).
  std::atomic<int> link_lane{-1};
  std::atomic<int> link_rank{-1};
  std::atomic<int> link_peer{-1};
  void set_link(int lane, int rank, int peer) {
    link_lane.store(lane, std::memory_order_relaxed);
    link_rank.store(rank, std::memory_order_relaxed);
    link_peer.store(peer, std::memory_order_relaxed);
  }
  // Hung-peer probe: send a zero-byte PING on this connection and wait
  // up to timeout_ms for the peer's progress engine to PONG it back.
  // Returns 1 (peer alive), 0 (no pong within the timeout — peer hung
  // or wedged), -1 (connection down), -2 (uninformative: the backend
  // has no probe or FEAT_PROBE was not negotiated). The stall
  // escalation path treats -2 as "no new information" and keeps the
  // legacy stall verdict.
  virtual int probe(int timeout_ms) {
    (void)timeout_ms;
    return -2;
  }
  virtual int poll(tdr_wc *wc, int max, int timeout_ms) = 0;
  virtual int close_qp() = 0;
};

class Engine {
 public:
  virtual ~Engine() = default;
  // Telemetry track id (open ordinal; see Qp::tel_id).
  const uint16_t tel_id = tel_next_engine_id();
  // Engine-wide completion pulse: a monotonically-stamped "some QP on
  // this engine delivered a completion" signal, so a waiter watching
  // SEVERAL QPs (a progress shard owning a channel group) can park on
  // one condvar instead of blind-slicing a single QP's poll — the
  // single-poll stall the sharded progress engine exists to kill.
  // Backends whose completions are produced by their own threads
  // (emu) call cq_pulse() at every CQ delivery; purely poll-driven
  // backends (verbs) never pulse, and cq_wait degrades to a bounded
  // sleep slice — correct, just not event-driven. The no-waiter fast
  // path is one atomic add + one atomic load: the pulse rides every
  // hot-path completion, so it must cost nothing when no shard is
  // parked.
  uint64_t cq_stamp() { return cq_stamp_.load(std::memory_order_acquire); }
  void cq_pulse() {
    cq_stamp_.fetch_add(1, std::memory_order_release);
    if (cq_waiters_.load(std::memory_order_acquire) > 0) {
      // Empty critical section: a waiter between its predicate check
      // and its sleep holds cq_mu_, so taking it here orders this
      // notify after that sleep — no missed wakeup.
      { std::lock_guard<std::mutex> g(cq_mu_); }
      cq_cv_.notify_all();
    }
  }
  // Wait until the stamp moves past `seen` (true) or timeout (false).
  bool cq_wait(uint64_t seen, int timeout_ms) {
    std::unique_lock<std::mutex> lk(cq_mu_);
    cq_waiters_.fetch_add(1, std::memory_order_acq_rel);
    bool moved = cq_cv_.wait_for(
        lk, std::chrono::milliseconds(timeout_ms), [&] {
          return cq_stamp_.load(std::memory_order_acquire) != seen;
        });
    cq_waiters_.fetch_sub(1, std::memory_order_acq_rel);
    return moved;
  }
  // Live-QP accounting for multi-tenant engines (several concurrent
  // worlds sharing one engine under a budget). qp_limit 0 = unlimited.
  // Admission reserves a slot BEFORE the connection is attempted, so
  // an over-budget bring-up fails fast without consuming the peer's
  // accept; a failed bring-up releases the reservation.
  std::atomic<int> qp_live{0};
  std::atomic<int> qp_limit{0};
  bool qp_admit() {
    for (;;) {
      int limit = qp_limit.load(std::memory_order_relaxed);
      int live = qp_live.load(std::memory_order_relaxed);
      if (limit > 0 && live >= limit) return false;
      if (qp_live.compare_exchange_weak(live, live + 1,
                                        std::memory_order_relaxed))
        return true;
    }
  }
  void qp_release() { qp_live.fetch_sub(1, std::memory_order_relaxed); }
  virtual int kind() const = 0;
  virtual const char *name() const = 0;
  virtual Mr *reg_mr(void *addr, size_t len, int access) = 0;
  virtual Mr *reg_dmabuf_mr(int fd, size_t offset, size_t len, uint64_t iova,
                            int access) = 0;
  virtual int dereg_mr(Mr *mr) = 0;
  // timeout_ms bounds the accept wait (-1 = forever): elastic callers
  // (RingWorld.rebuild) must never leak a thread blocked in accept on
  // a port the next rendezvous attempt needs. flags: TDR_CONN_* —
  // TDR_CONN_FORCE_STREAM refuses the CMA fast path for this
  // connection (the emulated inter-host tier; verbs ignores it).
  virtual Qp *listen(const char *bind_host, int port, int timeout_ms,
                     int flags) = 0;
  virtual Qp *connect(const char *host, int port, int timeout_ms,
                      int flags) = 0;
  // Seal context (tdr_seal_context): the incarnation+1 and training
  // step stamped into outbound seals and checked at land time. A
  // no-op on engines without sealing (verbs).
  virtual void set_seal_ctx(uint64_t /*gen_plus1*/, uint64_t /*step*/) {}

 private:
  std::mutex cq_mu_;
  std::condition_variable cq_cv_;
  std::atomic<uint64_t> cq_stamp_{0};
  std::atomic<int> cq_waiters_{0};
};

Engine *create_emu_engine(std::string *err);
Engine *create_verbs_engine(const std::string &device, std::string *err);

// Feature bits advertised during connection bring-up — shared by BOTH
// backends so a verbs QP negotiates the fused capabilities exactly the
// way the emu Hello does. Wire-protocol- or schedule-changing
// capabilities MUST be negotiated (mine & theirs), never assumed from
// local state: a per-rank env override that silently changed the
// frames/schedule one side runs would wedge the other.
enum : uint32_t {
  FEAT_FOLDBACK = 1u << 0,
  // Participation in the world-2 fused exchange schedule (FusedTwo).
  // Schedule-changing rather than frame-changing: a rank running
  // FusedTwo sends phase-2 reduced-B chunks on its LEFT QP while the
  // rightward-only schedules send everything rightward.
  FEAT_FUSED2 = 1u << 1,
  // Payload sealing (CRC32C + incarnation tag trailers, NAK-driven
  // chunk retransmit). Frame-changing: sealed frames carry a trailer
  // the unsealed parser would misread as the next header, so it MUST
  // be negotiated (TDR_NO_SEAL acts at the advertising stage).
  FEAT_SEAL = 1u << 2,
  // FULL payload CRC on the CMA tier. By default a sealed CMA-tier
  // connection seals the TAG ONLY (generation fence, chunk seq, and
  // the landing-steering header fields stay CRC-covered; the payload
  // does not): the "wire" there is a kernel memcpy with no bit-flip
  // failure mode a payload CRC could catch — the ICRC rationale the
  // verbs backend already applies (has_seal=0). TDR_SEAL_CMA=1
  // advertises this bit; both ends must set it (it changes what the
  // trailer CRC covers, so a unilateral switch would fail every
  // verification). The TCP stream tier always seals the payload.
  FEAT_SEAL_CMA_FULL = 1u << 3,
  // Collective trace ids on the wire: frames carry the posting rank's
  // coll id in an 8-byte header extension so the peer's telemetry
  // events join the sender's by key. Frame-changing, so negotiated;
  // advertised only when TDR_TELEMETRY was on at handshake time —
  // with the feature off, frames are byte-identical to the
  // pre-trace-id wire format (acceptance-pinned).
  FEAT_COLL_ID = 1u << 4,
  // Hung-peer probe frames (OP_PING/OP_PONG, zero-byte, sealed with a
  // tag-only CRC on sealed connections). Frame-changing — an
  // un-negotiated peer's parser would misread the new opcodes — so it
  // is negotiated exactly like FEAT_COLL_ID: with the feature off,
  // frames stay byte-identical to the legacy wire format
  // (TDR_NO_PROBE acts at the advertising stage).
  FEAT_PROBE = 1u << 5,
  // int8 wire compression (tdr_ring_allreduce_q8): willingness to run
  // the quantized ring schedule, whose pieces carry a per-segment f32
  // scale IN the sealed payload ([scale][q8 bytes] over ordinary
  // SEND/recv frames — no frame-format change, so frames stay
  // byte-identical with the feature off; the bit exists because the
  // SCHEDULE differs and per-link capability must be queryable by the
  // health ladder before it downgrades a degraded link to int8).
  // Schedule-changing like FEAT_FUSED2, so negotiated (mine & theirs);
  // TDR_NO_WIRE_Q8 acts at the advertising stage.
  FEAT_WIRE_Q8 = 1u << 6,
};

// Locally-willing feature set (TDR_NO_FOLDBACK / TDR_NO_FUSED2 act
// here, at the advertising stage, so an opted-out rank degrades the
// WHOLE connection instead of emitting mismatched wire traffic).
uint32_t local_features();

// True when an env flag is set and not "0" — the one truthiness rule
// for all TDR_* opt-out knobs.
bool env_set(const char *name);

// The ring stall deadline (TDR_RING_TIMEOUT_MS, clamped >= 100ms,
// default 30s) — shared so the engines' quiesce backstops cannot
// undercut the deadline they are meant to exceed.
int ring_timeout_ms();

// Deterministic fault injection (fault.cc): the TDR_FAULT_PLAN
// registry. fault_point(site, chunk) evaluates every clause for the
// named site and returns the TDR_WC_* status to inject (>= 0),
// TDR_FAULT_DROP to kill the connection, or TDR_FAULT_NONE; stall_ms
// clauses sleep inline before returning. Counters are process-wide.
constexpr int TDR_FAULT_NONE = -1;
constexpr int TDR_FAULT_DROP = -2;
int fault_point(const char *site, long long chunk = -1);
// Corruption injection (sealed connections): returns the number of
// payload bytes a matching corrupt=N clause wants flipped at this
// arrival (0 = none). Corrupt clauses are evaluated ONLY here — never
// by fault_point — so their seen/hit counters stay truthful. Valid
// sites: send (frame transmission time, wire copy only) and land
// (after the payload materializes, before verification).
long long fault_corrupt(const char *site, long long chunk = -1);
// The landing-window hook: honors the legacy TDR_FAULT_LANDING_DELAY_MS
// knob, then the plan's "land" site.
void fault_land_delay();
size_t fault_clause_count();
uint64_t fault_clause_hits(size_t idx);
uint64_t fault_clause_seen(size_t idx);
// Re-parse TDR_FAULT_PLAN from the environment, zeroing all counters.
void fault_plan_reset();
// Whole-plan aggregates (sum over clauses) for the native counter
// registry: seen and hits are gathered in ONE locked pass, so a
// registry snapshot can never show hits > seen.
void fault_totals(uint64_t *seen, uint64_t *hits);
uint64_t fault_total_hits();
uint64_t fault_total_seen();

// Netem-style riders (fault.cc): delay/jitter, reorder, dup and
// throttle clauses scoped per link (chunk + lane + rank/peer + tier).
// Evaluated at frame-transmission time by the emu send path. The
// returned action says what the sender must do; delay_us already
// includes deterministic jitter and throttle pacing. Reorder is
// two-phase for counter honesty: fault_netem RESERVES the hold (the
// clause's seen advances, hits does not) and hands back a commit key;
// the sender calls fault_netem_commit once the held frame's fate is
// known — swapped=true (a later frame overtook it: the injection
// happened, hits++) or swapped=false (flushed in original order: the
// reservation is refunded so a later frame can still be reordered).
struct NetemAction {
  long long delay_us = 0;  // total pre-transmit sleep (delay+jitter+pace)
  bool dup = false;        // transmit a duplicate after this frame
  bool reorder = false;    // hold this frame behind its successor
  int reorder_clause = -1; // commit key: clause index
  uint64_t plan_gen = 0;   // commit key: plan generation at reserve time
};
// tier_cma: 1 = CMA/desc tier, 0 = stream tier. Returns true when any
// rider matched (action populated).
bool fault_netem(long long chunk, int tier_cma, int lane, int rank,
                 int peer, unsigned long long bytes, NetemAction *out);
void fault_netem_commit(int clause_idx, uint64_t plan_gen, bool swapped);
// Fast-path gate: any netem clause armed at all (parse-time constant).
bool fault_netem_armed();

// CRC32C (Castagnoli), hardware-accelerated when the build has
// SSE4.2, table-driven otherwise. Incremental: seed with the previous
// return value to extend a running checksum (crc32c(b, crc32c(a, 0))
// == crc32c(a||b, 0)).
uint32_t crc32c(const void *data, size_t len, uint32_t seed);

// Process-wide integrity counters (util.cc): sealed / verified /
// failed / retransmitted — exported via tdr_seal_counters so tests
// and the tracer observe the whole detect→retransmit path.
enum SealCounter {
  kSealSealed = 0,
  kSealVerified = 1,
  kSealFailed = 2,
  kSealRetx = 3,
};
void seal_count(int which);
uint64_t seal_counter(int which);
void seal_counters_reset();

// Process-wide hung-peer probe counters (util.cc): pings sent, pongs
// received, probes that timed out — surfaced through the native
// counter registry so the health ladder and /metrics observe the
// probe traffic without a side channel.
enum ProbeCounter {
  kProbeSent = 0,
  kProbePong = 1,
  kProbeTimeout = 2,
};
void probe_count(int which);
uint64_t probe_counter(int which);

// Deterministic 64-bit mix (splitmix64 finalizer): the seeded-jitter
// primitive shared by the netem delay rider and the NAK backoff —
// same inputs, same jitter, on every run (no rand()).
uint64_t mix64(uint64_t x);

// Per-collective hard deadline (TDR_COLL_DEADLINE_MS, 0 = disabled):
// unlike the soft stall clock — which re-arms on every completion —
// this bounds the WHOLE collective, so a link that crawls while still
// making progress eventually escalates instead of starving training
// forever.
int coll_deadline_ms();

// Per-chunk retransmit budget (TDR_SEAL_RETRY, default 3, clamped to
// [0, 100]): how many NAK-driven re-posts a receiver requests before
// completing the chunk with TDR_WC_INTEGRITY_ERR.
int seal_retry_budget();

// Element size for a TDR_DT_*; 0 for unknown.
size_t dtype_size(int dt);
// int8 wire-compression kernels (next to the bf16 fold kernels in
// util.cc). fold_q8: requantizing dequant-fold of two symmetric-scale
// int8 vectors — q_l[i] := round((s_l*q_l[i] + s_f*q_f[i]) / (s_l +
// s_f)), the running-scale rule that keeps |q| <= 127 at every hop of
// the ring without clipping (the caller advances its scale to
// s_l + s_f). dequant_q8: out[i] = q[i] * scale.
void fold_q8(int8_t *q_l, float s_l, const int8_t *q_f, float s_f,
             size_t n);
void dequant_q8(float *out, const int8_t *q, size_t n, float scale);
// dst[i] op= src[i] for n elements of dtype dt (bf16 accumulates in
// f32 with round-to-nearest-even, matching TPU semantics).
void reduce_any(void *dst, const void *src, size_t n, int dt, int op);
// Fused exchange fold: res = dst op src written to BOTH buffers in
// one pass (bit-identical on both sides; bf16 rounds once).
void reduce2_any(void *dst, void *src, size_t n, int dt, int op);

// Parallel data movement (copy_pool.cc): a process-wide worker pool —
// the emulated NIC's DMA-engine array. All entry points fall back to
// the serial path on 1-core machines or short lengths; parallel
// reductions are bit-exact with serial ones (element-disjoint slices).
size_t copy_pool_workers();
// Fold-offload pool (copy_pool.cc): dedicated workers that run the
// ring layer's scratch-window folds OFF the poll loop, so a chunk can
// land while its predecessor folds (TDR_FOLD_THREADS; 0 and 1-core
// hosts run folds inline — fold_pool_workers() returns 0 and
// fold_submit executes the job on the calling thread). Jobs are
// opaque closures; ordering between jobs is the CALLER's problem
// (the ring gates slot reuse on per-chunk completion flags).
size_t fold_pool_workers();
void fold_submit(std::function<void()> fn);
// Registry counters: jobs executed and cumulative busy time — the
// bench derives fold-offload occupancy (busy/wall) from these — plus
// the instantaneous submitted-but-not-finished depth (diagnostics:
// a deep queue with idle wire means the fold pool is the bottleneck).
uint64_t fold_jobs();
uint64_t fold_busy_us();
uint64_t fold_pending();
// Usable cores (affinity-mask truth; shared by every pool-sizing and
// shard-sizing policy so they cannot disagree about the host).
size_t usable_cores();

// Sharded progress engine (ring_allreduce.cc): the resolved shard
// count for a channel count (TDR_PROGRESS_SHARDS; 0 = legacy single
// poll loop) and the progress.* registry counters — shard threads
// launched, idle wakeups taken, completions consumed on shard
// threads.
size_t progress_shards_for(size_t channels);
void progress_counters(uint64_t *shards, uint64_t *wakeups, uint64_t *wc);
// Cumulative bytes moved via the streaming (non-temporal) vs cached
// (memcpy) copy tiers — bench/diagnostic visibility into which path
// carried the traffic.
void copy_counters(uint64_t *nt, uint64_t *plain);
void par_memcpy(void *dst, const void *src, size_t len);
void par_reduce(void *dst, const void *src, size_t n, int dt, int op);
// Cross-memory attach primitives (single copy between address spaces)
// and their pool-parallel wrappers. The same-process fast path is
// explicit: pass kCmaSameProcess to memcpy in-place. A raw pid is
// never compared against getpid() — pid values are namespace-relative
// and collide across containers (two "pid 1"s on one host).
constexpr pid_t kCmaSameProcess = -1;
bool cma_copy_from(pid_t pid, void *dst, uint64_t src, size_t len);
bool cma_copy_to(pid_t pid, uint64_t dst, const void *src, size_t len);
bool par_cma_copy_from(pid_t pid, void *dst, uint64_t src, size_t len);
bool par_cma_copy_to(pid_t pid, uint64_t dst, const void *src, size_t len);
bool par_cma_reduce_from(pid_t pid, void *dst, uint64_t src, size_t bytes,
                         int dt, int op);
// Non-temporal copy for large cold destinations (streaming stores;
// bypasses the read-for-ownership a cached store pays).
void copy_nt(char *dst, const char *src, size_t len);
// Fused exchange fold: res = dst op src; written to BOTH dst (cached)
// and src (streamed) — the one-pass kernel behind send_foldback when
// both buffers are in this address space.
void par_reduce2_local(void *dst, void *src, size_t n, int dt, int op);
// Cross-process variant: fold peer bytes at `src` (pid's address
// space) into dst, writing the folded result back to the peer — one
// windowed pass. Returns false on CMA failure. The CALLER guarantees
// the peer region stays resident (the foldback sender holds an
// active inflight ref on its MR from post to completion).
bool par_cma_reduce2(pid_t pid, void *dst, uint64_t src, size_t bytes,
                     int dt, int op);

// TCP helpers (bootstrap for both backends; data path for emu).
// timeout_ms bounds the accept wait (-1 = forever).
int tcp_listen_accept(const char *bind_host, int port, std::string *err,
                      int timeout_ms = -1);
int tcp_connect_retry(const char *host, int port, int timeout_ms,
                      std::string *err);
bool read_full(int fd, void *buf, size_t len);
bool write_full(int fd, const void *buf, size_t len);
bool write_hdr_payload(int fd, const void *hdr, size_t hdrlen,
                       const void *payload, size_t len);
void tune_socket(int fd);

}  // namespace tdr

#endif  // TDR_COMMON_H_
