/* tdr.h — C API of the TPU-Direct-RDMA native engine (libtdr).
 *
 * Role in the stack: the userspace half of what the reference split
 * between OFED ib_core and the amdp2p bridge (amdp2p.c). Where the
 * reference's public surface is a callback table polled by the kernel
 * (the 7-entry peer_memory_client ops, amdp2p.c:363-371), this engine
 * exposes the registration + RC queue-pair surface directly to the
 * framework: register memory (host pointer or dma-buf fd), bring up a
 * reliable connection, post one-sided WRITE/READ and two-sided
 * SEND/RECV, poll completions.
 *
 * Invariant preserved from the reference (SURVEY.md §3.3): all mapping
 * work is front-loaded into registration; posting a transfer performs
 * no per-byte software work beyond handing the NIC (or the emulated
 * progress engine) a descriptor.
 *
 * Two backends, selected at runtime:
 *   - "verbs": real InfiniBand via dlopen(libibverbs.so.1), including
 *     ibv_reg_dmabuf_mr for accelerator HBM (SURVEY.md §7 design
 *     stance: dma-buf is the idiomatic modern path).
 *   - "emu":   hardware-free emulation over TCP with a progress thread
 *     standing in for the HCA — the "fake L2 backend" SURVEY.md §4
 *     calls out as the reference's biggest testing gap.
 */
#ifndef TDR_H_
#define TDR_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct tdr_engine tdr_engine;
typedef struct tdr_mr tdr_mr;
typedef struct tdr_qp tdr_qp;

enum {
  TDR_ENGINE_EMU = 0,
  TDR_ENGINE_VERBS = 1,
};

/* Completion statuses (subset of ibv_wc_status semantics). */
enum {
  TDR_WC_SUCCESS = 0,
  TDR_WC_REM_ACCESS_ERR = 1, /* bad, out-of-range, or revoked rkey */
  TDR_WC_LOC_ACCESS_ERR = 2, /* local MR invalid / recv too small */
  TDR_WC_FLUSH_ERR = 3,      /* QP torn down with the op in flight */
  TDR_WC_GENERAL_ERR = 4,
  /* Payload-integrity verification failed at land time and the
   * per-chunk retransmit budget is exhausted (or the frame carried a
   * stale-incarnation seal). Retryable: the elastic layer rebuilds the
   * world, exactly as it does for FLUSH/GENERAL. */
  TDR_WC_INTEGRITY_ERR = 5,
};

/* MR access flags (ibv_access_flags semantics). */
enum {
  TDR_ACCESS_LOCAL = 0,
  TDR_ACCESS_REMOTE_WRITE = 1 << 0,
  TDR_ACCESS_REMOTE_READ = 1 << 1,
};

/* Work-completion opcodes. */
enum {
  TDR_OP_WRITE = 0,
  TDR_OP_READ = 1,
  TDR_OP_SEND = 2,
  TDR_OP_RECV = 3,
};

typedef struct {
  uint64_t wr_id;
  int32_t status; /* TDR_WC_* */
  int32_t opcode; /* TDR_OP_* */
  uint64_t len;   /* payload bytes (meaningful for RECV) */
} tdr_wc;

/* Last error message for the calling thread ("" if none). */
const char *tdr_last_error(void);

/* Number of workers in the process-wide parallel copy/reduce pool
 * (the emulated NIC's DMA-engine array; TDR_COPY_THREADS overrides). */
size_t tdr_copy_pool_workers(void);

/* Workers in the fold-offload pool (TDR_FOLD_THREADS): the threads
 * that run the ring's scratch-window folds off the poll loop. 0 means
 * folds run inline on the polling thread (1-core hosts, or the knob
 * set to 0). */
size_t tdr_fold_pool_workers(void);

/* Effective progress-shard count for a ring with `channels` channels
 * (the sharded progress engine, TDR_PROGRESS_SHARDS): how many
 * dedicated poll threads a striped collective will run, each owning a
 * disjoint channel group. 0 = the legacy single-poll loop (the
 * schedule's calling thread owns all polling; TDR_PROGRESS_SHARDS=0
 * forces it). Default: one shard per channel, capped at the host's
 * usable cores — a core-starved host gains nothing from shards that
 * only preempt each other. Per-PROCESS execution strategy: never
 * negotiated, never part of the schedule digest (any mix of shard
 * counts across ranks is wire-compatible and bitwise-identical). */
int tdr_progress_shards(int channels);

/* Cumulative bytes moved via the streaming (non-temporal) vs cached
 * (memcpy) copy tiers since process start — which path carried the
 * traffic (bench/diagnostics). */
void tdr_copy_counters(uint64_t *nt_bytes, uint64_t *plain_bytes);

/* ------------------------------------------------------------------ *
 * Deterministic fault injection — the TDR_FAULT_PLAN registry.
 *
 * TDR_FAULT_PLAN holds comma-separated clauses of the form
 * site[:match...]:action (grammar in README.md "Failure semantics"),
 * e.g. "send:chunk=3:once=general_err,conn:drop_after=2". Sites:
 * send (emu SEND-class posts: the WR completes with the injected
 * status instead of transmitting), conn (emu posts: the QP's socket
 * drops after N posts), land (the landing-time window; generalizes
 * TDR_FAULT_LANDING_DELAY_MS), ring (tdr_ring_allreduce entry: the
 * collective call fails before posting). Status actions are valid at
 * send/ring only, drop_after at conn only, corrupt=NBYTES at
 * send/land only (flip NBYTES payload bytes AFTER sealing on send /
 * BEFORE verification on land — sealed connections only; the source
 * buffer is never touched, so retransmissions can be clean),
 * stall_ms anywhere; clauses whose action the site cannot apply are
 * rejected at parse time so a hit counter never reports an injection
 * that did not happen.
 *
 * Per-clause hit counters are exported so tests assert the fault
 * ACTUALLY fired — a green test whose fault never armed is a lie.
 * Counters are process-wide; reset re-parses the environment.
 * ------------------------------------------------------------------ */
int tdr_fault_plan_clauses(void);
uint64_t tdr_fault_plan_hits(int idx);  /* times clause idx fired   */
uint64_t tdr_fault_plan_seen(int idx);  /* site arrivals it matched */
void tdr_fault_plan_reset(void);

/* ------------------------------------------------------------------ *
 * Sealed chunks — end-to-end payload integrity on the emu transport.
 *
 * When both ends of a QP negotiate FEAT_SEAL (default on; TDR_NO_SEAL
 * opts a rank out at the handshake), every payload-bearing frame
 * (SEND/recv_reduce/foldback and RDMA_WRITE landings) carries a seal:
 * CRC32C over the payload plus a (generation, step, chunk-seq) tag,
 * verified at land time BEFORE the chunk is folded into any
 * accumulator. A verification failure NAKs the chunk seq back to the
 * sender, which re-posts it from the still-live source buffer (the
 * pending op holds an inflight MR ref until the final ack); the
 * per-chunk retransmit budget is TDR_SEAL_RETRY (default 3), and
 * exhausting it completes BOTH sides' WRs with TDR_WC_INTEGRITY_ERR —
 * retryable, so the elastic layer escalates to RingWorld.rebuild().
 * ------------------------------------------------------------------ */

/* CRC32C (Castagnoli, reflected 0x82F63B78): hardware (SSE4.2) when
 * compiled in, software slicing otherwise. Incremental: pass the
 * previous return value as seed to continue a running checksum. */
uint32_t tdr_crc32c(const void *data, size_t len, uint32_t seed);

/* Process-wide integrity counters: out[0]=frames sealed at send,
 * out[1]=landings verified ok, out[2]=verification failures,
 * out[3]=retransmissions performed. */
void tdr_seal_counters(uint64_t out[4]);
void tdr_seal_counters_reset(void);

/* The per-chunk retransmit budget as the ENGINE parses it
 * (TDR_SEAL_RETRY, default 3) — the schedule digest records this
 * value, so the Python layer must not re-parse the env and risk
 * certifying a budget the transport is not using. */
int tdr_seal_retry_budget(void);

/* Stamp the engine's seal context: gen_plus1 = ring incarnation + 1
 * (0 = unset, checks skipped) and the training step. Outbound seals
 * carry both; a landing whose seal names a DIFFERENT non-zero
 * incarnation than the local engine's is a stale-incarnation ghost
 * write and fails verification even when its bytes are intact. */
void tdr_seal_context(tdr_engine *e, uint64_t gen_plus1, uint64_t step);

/* Whether this QP negotiated sealing with its peer (emu only; the
 * verbs backend relies on the wire's ICRC and advertises 0). */
int tdr_qp_has_seal(tdr_qp *qp);

/* Whether the negotiated seal's CRC covers the PAYLOAD bytes. True on
 * the TCP stream tier; on the CMA tier (same-host kernel-memcpy
 * "wire" — no payload bit-flip failure mode, the ICRC rationale) the
 * default is tag-only sealing (generation fence + chunk seq +
 * steering fields stay covered) and this returns 0 unless BOTH ends
 * set TDR_SEAL_CMA=1 (FEAT_SEAL_CMA_FULL). */
int tdr_qp_has_seal_payload(tdr_qp *qp);

/* Whether this QP negotiated FEAT_COLL_ID (emu only): frames carry
 * the posting rank's collective trace id in an 8-byte header
 * extension, so the receiver's telemetry events tag with the SAME id
 * the sender stamped (retransmits keep it; tag-only CMA seals carry
 * it too). Advertised only when TDR_TELEMETRY was on at handshake
 * time — with the feature off the wire format is byte-identical to
 * the pre-trace-id framing. */
int tdr_qp_has_coll_id(tdr_qp *qp);

/* 1 when FEAT_WIRE_Q8 was negotiated on this QP: both ends accept the
 * int8 quantized ring schedule (tdr_ring_allreduce_q8). The quantized
 * pieces are ordinary sealed SEND payloads ([f32 scale][int8 bytes]) —
 * no frame-format change, so with the feature off the wire is
 * byte-identical to the legacy framing; the bit gates the SCHEDULE and
 * lets the health ladder query per-link int8 capability before
 * engaging its rung below bf16. TDR_NO_WIRE_Q8 suppresses the
 * advertisement. */
int tdr_qp_has_wire_q8(tdr_qp *qp);

/* Hung-peer probe: send a zero-byte PING (sealed with a tag-only CRC
 * on sealed connections) and wait up to timeout_ms for the peer's
 * progress engine to PONG it back. Returns 1 = peer alive, 0 = no
 * pong within the timeout (peer hung/wedged), -1 = connection down,
 * -2 = uninformative (backend has no probe, or FEAT_PROBE was not
 * negotiated — with it off, frames stay byte-identical to the legacy
 * wire format; TDR_NO_PROBE=1 disables the advertisement). */
int tdr_qp_probe(tdr_qp *qp, int timeout_ms);

/* Stamp the QP's link identity (channel lane, local rank, peer rank)
 * so netem fault riders can scope to one link and stall/probe
 * telemetry names the edge. The ring layer calls this at channel
 * bring-up; -1 = unknown. Purely observational. */
void tdr_qp_set_link(tdr_qp *qp, int lane, int rank, int peer);

/* ------------------------------------------------------------------ *
 * Flight recorder — the engine-side telemetry subsystem.
 *
 * When TDR_TELEMETRY is set (and not "0"), every stage of the chunk
 * lifecycle on both backends (post → wire tx/rx → land → seal
 * verify/NAK/retransmit → fold → completion, plus copy-pool
 * enqueue/run and ring-collective begin/end) records a fixed-size
 * timestamped event into a bounded process-wide ring, and log2-bucket
 * latency/bandwidth histograms accumulate alongside. When the knob is
 * off, every event site costs exactly one predicted branch — no
 * clock reads, no stores — and tdr_tel_recorded()/tdr_tel_dropped()
 * stay 0 (the bench smoke asserts this).
 *
 * Clock domain: CLOCK_MONOTONIC nanoseconds — the same clock Python's
 * time.monotonic() reads on Linux, so native events and the Python
 * tracer's ring merge into one timeline without translation
 * (tdr_tel_now_ns anchors the correspondence).
 *
 * Ring capacity: TDR_TELEMETRY_RING events (default 65536, clamped to
 * [1024, 4Mi]). When full, the OLDEST event is overwritten (flight-
 * recorder semantics: the recent past survives a long soak) and the
 * dropped counter counts the overwrite.
 * ------------------------------------------------------------------ */

/* Event types (tdr_tel_event.type). */
enum {
  TDR_TEL_NONE = 0,
  TDR_TEL_POST_SEND = 1,   /* id=wr_id, arg=bytes                     */
  TDR_TEL_POST_RECV = 2,   /* id=wr_id, arg=maxlen                    */
  TDR_TEL_POST_WRITE = 3,  /* id=wr_id, arg=bytes                     */
  TDR_TEL_POST_READ = 4,   /* id=wr_id, arg=bytes                     */
  TDR_TEL_WIRE_TX = 5,     /* frame leaves the wire/desc path:
                              id=frame seq, arg=bytes                 */
  TDR_TEL_WIRE_RX = 6,     /* frame header arrived: id=seq, arg=bytes */
  TDR_TEL_LAND = 7,        /* payload materialized at its target      */
  TDR_TEL_VERIFY_OK = 8,   /* seal verification passed: id=seq        */
  TDR_TEL_VERIFY_FAIL = 9, /* seal verification failed: id=seq        */
  TDR_TEL_NAK = 10,        /* receiver NAKs chunk seq (arg=attempt)   */
  TDR_TEL_RETX = 11,       /* sender re-posts chunk seq (arg=bytes)   */
  TDR_TEL_FOLD = 12,       /* payload folded into an accumulator      */
  TDR_TEL_WC = 13,         /* completion delivered: id=wr_id,
                              arg=TDR_WC_* status                     */
  TDR_TEL_COPY_ENQ = 14,   /* copy-pool job submitted: arg=work units */
  TDR_TEL_COPY_RUN = 15,   /* copy-pool job finished: arg=duration us */
  TDR_TEL_RING_BEGIN = 16, /* collective entry: id=call seq, arg=bytes*/
  TDR_TEL_RING_END = 17,   /* collective exit: arg=0 ok / 1 failed    */
  TDR_TEL_FOLD_OFF = 18,   /* scratch fold handed to the fold pool:
                              id=chunk index, arg=bytes (the matching
                              FOLD event fires when the worker runs
                              it — the gap between the two is queue
                              wait, fold-pool pressure made visible) */
  TDR_TEL_SHARD = 19,      /* progress-shard drain batch: qp=the
                              shard thread's track id, id=shard
                              ordinal, arg=completions consumed.
                              Emitted with engine=0 (process-level,
                              like the copy pool's events): batch
                              boundaries ride thread timing, so they
                              must not perturb per-engine replay
                              shapes. */
  TDR_TEL_FAULT = 20,      /* netem rider fired on an outbound frame
                              (delay/jitter sleep, throttle pacing
                              wait, duplicate, or reorder hold):
                              id=frame seq, arg=bytes. Emitted once
                              per frame however many riders matched;
                              the per-clause hit counters carry the
                              breakdown. */
};

/* Histograms. Recorded at log-linear ("log2 × 8") resolution: 8
 * linear sub-buckets per power-of-two octave (values 0..15 exact),
 * bounding the relative quantization error at 12.5% — percentile
 * estimates are real numbers, not octave edges (the BENCH_r06
 * saturation: every latency percentile read 8191/32767/65535).
 * tdr_tel_hist_read folds the fine rows back into the legacy
 * 64-octave view; tdr_tel_hist_read_fine exposes the fine rows. */
enum {
  TDR_HIST_CHUNK_LAT_US = 0, /* post → completion latency, us    */
  TDR_HIST_CHUNK_BYTES = 1,  /* completed op payload sizes       */
  TDR_HIST_COPY_BYTES = 2,   /* copy-pool memcpy sizes           */
  TDR_HIST_RING_LAT_US = 3,  /* whole-collective latency, us     */
  TDR_HIST_RING_MBPS = 4,    /* whole-collective bandwidth, MB/s */
  TDR_HIST_COUNT = 5,
};

/* Fine rows: 16 exact small-value buckets + 8 sub-buckets for each of
 * the 60 octaves above them (indices 16..495), padded to 512. */
#define TDR_HIST_FINE_BUCKETS 512

typedef struct {
  uint64_t ts_ns;  /* CLOCK_MONOTONIC */
  uint16_t type;   /* TDR_TEL_* */
  uint16_t engine; /* engine track id (tdr_tel_engine_id) */
  uint32_t qp;     /* qp track id (tdr_tel_qp_id), 0 = none */
  uint64_t id;     /* wr_id / frame seq / call seq */
  uint64_t arg;    /* bytes / status / attempt (per type) */
  /* Collective trace id (0 = none): the per-world monotonically
   * increasing id of the collective this event belongs to, stamped by
   * the posting rank (tdr_ring_set_coll) and CARRIED IN THE FRAME
   * HEADER to the peer when both ends negotiated FEAT_COLL_ID — so
   * two ranks' wire_rx/land/verify/fold/wc events for one collective
   * join by key across a merged fleet timeline. Ids with bit 63 set
   * were auto-assigned by the ring (caller never set one). */
  uint64_t coll;
} tdr_tel_event;

int tdr_tel_enabled(void);
/* Re-read TDR_TELEMETRY / TDR_TELEMETRY_RING and clear the ring,
 * histograms, and recorded/dropped counts (tests toggle the env then
 * call this, like tdr_fault_plan_reset). */
void tdr_tel_reset(void);
uint64_t tdr_tel_now_ns(void);
/* Remove up to `max` events from the ring, oldest first. */
int tdr_tel_drain(tdr_tel_event *out, int max);
uint64_t tdr_tel_recorded(void); /* events recorded since reset */
uint64_t tdr_tel_dropped(void);  /* events overwritten unread   */
const char *tdr_tel_event_name(int type);
int tdr_tel_hist_count(void);
const char *tdr_tel_hist_name(int which);
void tdr_tel_hist_read(int which, uint64_t out[64]);
/* Fine (log2 × 8) histogram rows: bucket count, the inclusive upper
 * edge of a fine bucket (the conservative percentile estimate — the
 * Python side calls this instead of re-deriving the edge math), and
 * the row itself (fills min(max, TDR_HIST_FINE_BUCKETS), returns the
 * number written). */
int tdr_tel_hist_fine_buckets(void);
uint64_t tdr_tel_hist_fine_upper(int idx);
int tdr_tel_hist_read_fine(int which, uint64_t *out, int max);
/* Stable per-process track ids (assigned at open/bring-up whether or
 * not telemetry is enabled — they also label exported timelines). */
int tdr_tel_engine_id(const tdr_engine *e);
int tdr_tel_qp_id(const tdr_qp *qp);

/* Unified native counter registry: one call reads every engine-side
 * counter — the seal/integrity ladder, fault-plan aggregates, copy
 * tiers, and the telemetry ring's own accounting — under stable
 * dotted names, replacing per-subsystem polling (whose multi-call
 * windows could double-count deltas). Counters that share a producer
 * (fault seen/hits; the copy tiers) are gathered in one pass so a
 * snapshot never shows impossible relations (hits > seen); counters
 * from DIFFERENT subsystems are individually-atomic monotonic reads,
 * not a global freeze. */
int tdr_counter_count(void);
const char *tdr_counter_name(int idx);
/* Fill out[0..min(max, count)) in registry order; returns the number
 * written. */
int tdr_counters_read(uint64_t *out, int max);

/* spec: "emu", "verbs", "verbs:<device>", or "auto" (verbs, else emu). */
tdr_engine *tdr_engine_open(const char *spec);
void tdr_engine_close(tdr_engine *e);
int tdr_engine_kind(const tdr_engine *e);
const char *tdr_engine_name(const tdr_engine *e);

/* ------------------------------------------------------------------ *
 * Per-engine QP accounting — multi-tenant engines (one engine hosting
 * several concurrent named worlds) get a hard cap on live QPs, checked
 * at bring-up: when the limit is set (> 0; 0 = unlimited) and reached,
 * tdr_listen/tdr_connect fail fast with a budget error BEFORE touching
 * the network, so an over-budget world dies at bring-up instead of
 * starving a co-tenant world of connections mid-soak. Accounting is
 * backend-independent (enforced at the C API boundary); the count
 * covers every live QP on the engine regardless of which world owns
 * it. Budget errors are non-retryable: rebuilding cannot create QP
 * headroom.
 * ------------------------------------------------------------------ */
void tdr_engine_set_qp_limit(tdr_engine *e, int limit);
int tdr_engine_qp_limit(const tdr_engine *e);
int tdr_engine_qp_live(const tdr_engine *e);

/* Registration. Mirrors the reference's acquire+get_pages+dma_map
 * front-loading (amdp2p.c:112-264) collapsed into one call; dereg
 * mirrors put_pages+release (amdp2p.c:283-313, 345-360). */
tdr_mr *tdr_reg_mr(tdr_engine *e, void *addr, size_t len, int access);
tdr_mr *tdr_reg_dmabuf_mr(tdr_engine *e, int fd, size_t offset, size_t len,
                          uint64_t iova, int access);
int tdr_dereg_mr(tdr_mr *mr);
uint32_t tdr_mr_lkey(const tdr_mr *mr);
uint32_t tdr_mr_rkey(const tdr_mr *mr);
uint64_t tdr_mr_addr(const tdr_mr *mr);
uint64_t tdr_mr_len(const tdr_mr *mr);

/* Revocation: the free-while-registered flow (amdp2p.c:88-109). After
 * this, remote access to the MR completes with TDR_WC_REM_ACCESS_ERR
 * and local posts fail; dereg remains safe (idempotent teardown, the
 * free_callback_called handshake of amdp2p.c:299-302). */
int tdr_mr_invalidate(tdr_mr *mr);

/* Whether the CPU can fold into this MR's memory (false for verbs
 * dma-buf MRs — no CPU mapping). Ring allreduces over non-foldable
 * MRs fail up front with a clear error. */
int tdr_mr_cpu_foldable(const tdr_mr *mr);

/* Connection bring-up over an out-of-band TCP rendezvous (the role
 * perftest's TCP port plays). Blocking; one QP per call.
 * tdr_listen_timeout bounds the accept wait (-1 = forever) so an
 * elastic rendezvous whose peer never arrives returns instead of
 * stranding a thread in accept on the port the next attempt needs. */
tdr_qp *tdr_listen(tdr_engine *e, const char *bind_host, int port);
tdr_qp *tdr_listen_timeout(tdr_engine *e, const char *bind_host, int port,
                           int timeout_ms);
tdr_qp *tdr_connect(tdr_engine *e, const char *host, int port,
                    int timeout_ms);

/* Connection flags for the tiered bring-up variants below. */
enum {
  /* Refuse the CMA fast path for this connection even when the probe
   * would succeed: the QP negotiates the STREAM tier (socket payloads,
   * full payload seals). The hierarchical inter-host ring uses this so
   * a two-host topology EMULATED on one machine (host-key override)
   * still exercises real stream-tier framing — payload CRCs, NAK
   * retransmit, corrupt riders — on the tier that models the slow
   * inter-host links. One side forcing is enough: it reports its probe
   * as failed, so both ends agree on the tier (the handshake's
   * both-directions-verified rule). */
  TDR_CONN_FORCE_STREAM = 1 << 0,
};
tdr_qp *tdr_listen_tier(tdr_engine *e, const char *bind_host, int port,
                        int timeout_ms, int flags);
tdr_qp *tdr_connect_tier(tdr_engine *e, const char *host, int port,
                         int timeout_ms, int flags);
int tdr_qp_close(tdr_qp *qp);

/* Work posting. Returns 0 on success, -1 on immediate local failure.
 * Completion (incl. remote status) arrives via tdr_poll. */
int tdr_post_write(tdr_qp *qp, tdr_mr *lmr, size_t loff, uint64_t raddr,
                   uint32_t rkey, size_t len, uint64_t wr_id);
int tdr_post_read(tdr_qp *qp, tdr_mr *lmr, size_t loff, uint64_t raddr,
                  uint32_t rkey, size_t len, uint64_t wr_id);
int tdr_post_send(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t len,
                  uint64_t wr_id);
int tdr_post_recv(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t maxlen,
                  uint64_t wr_id);

/* Fused reduce-on-receive (the SHARP-style in-transport reduction):
 * like tdr_post_recv, but the inbound SEND payload is folded into the
 * buffer (dst op= src, with TDR_DT_ / TDR_RED_ semantics) by the
 * progress engine — no scratch buffer or second pass. Capability-gated:
 * tdr_qp_has_recv_reduce() returns 1 on engines that support it (emu);
 * on others the post fails and callers fall back to recv + reduce. */
int tdr_post_recv_reduce(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t maxlen,
                         int dtype, int red_op, uint64_t wr_id);
int tdr_qp_has_recv_reduce(tdr_qp *qp);

/* Fused fold-and-write-back send (the other half of an in-transport
 * allreduce exchange): like tdr_post_send, but the peer — having
 * matched this message to a tdr_post_recv_reduce — folds the payload
 * into its buffer AND writes the folded result back IN PLACE over
 * this send's source region, all in one pass while the data is hot.
 * The send completion fires only after the write-back has landed, so
 * for a symmetric exchange no separate return transfer (all-gather
 * phase) is needed at all. Capability-gated like recv_reduce. */
int tdr_post_send_foldback(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t len,
                           uint64_t wr_id);
int tdr_qp_has_send_foldback(tdr_qp *qp);

/* Whether BOTH ends of this QP negotiated participation in the world-2
 * fused exchange schedule (TDR_NO_FUSED2 opts a rank out at the
 * handshake, degrading the whole connection to the compatible
 * rightward schedules instead of a per-rank wire mismatch). */
int tdr_qp_has_fused2(tdr_qp *qp);

/* Max recv_reduce postings this QP wants in flight (bounded staging
 * engines — verbs — return their slot budget; 0 = unbounded). The
 * ring layer sizes its recv window to this. */
size_t tdr_qp_rr_window(tdr_qp *qp);

/* Poll up to `max` completions; waits up to timeout_ms (0 = non-block,
 * -1 = forever). Returns count, or -1 on error. */
int tdr_poll(tdr_qp *qp, tdr_wc *wc, int max, int timeout_ms);

/* ------------------------------------------------------------------ *
 * Ring allreduce — the cross-slice collective consumer (the layer the
 * reference left to MPI/NCCL userspace, SURVEY.md §2 "Distributed
 * communication backend inventory"). Classic reduce-scatter +
 * all-gather over the neighbor QPs; per-rank traffic is
 * 2*(world-1)/world of the buffer, the textbook bus-bandwidth-optimal
 * schedule.
 * ------------------------------------------------------------------ */

typedef struct tdr_ring tdr_ring;

enum {
  TDR_DT_F32 = 0,
  TDR_DT_F64 = 1,
  TDR_DT_I32 = 2,
  TDR_DT_I64 = 3,
  TDR_DT_BF16 = 4, /* accumulated in f32 */
  TDR_DT_U8 = 5,   /* byte transport (alltoall/all_gather/broadcast);
                      reducing collectives reject it */
  TDR_DT_I8 = 6,   /* int8 wire compression: quantized payload of the
                      scale-carrying q8 schedule. Plain reducing
                      collectives reject it (a scale-less int8 sum
                      overflows); use tdr_ring_allreduce_q8. */
};

enum { TDR_RED_SUM = 0, TDR_RED_MAX = 1, TDR_RED_MIN = 2 };

/* left/right: QPs to the ring neighbors (the same QP for world == 2).
 * The ring borrows the QPs; it does not close them. */
tdr_ring *tdr_ring_create(tdr_engine *e, tdr_qp *left, tdr_qp *right,
                          int rank, int world);
/* Multi-channel ring: `channels` independent QPs per neighbor, chunk
 * i of every striped schedule riding channel i % channels — the wire
 * transfer, seal verification, and fold of consecutive chunks proceed
 * in parallel on independent progress engines. lefts[c] on this rank
 * must be connected to rights[c] on the left neighbor (the Python
 * bootstrap brings channels up in index order, which guarantees it).
 * Every channel must have negotiated identical capabilities
 * (reduce-on-receive, foldback, fused2, seal) — creation fails
 * otherwise, because a schedule striped across capability-divergent
 * channels would desynchronize mid-collective. Completion ordering,
 * verify-before-fold, NAK/retransmit budgets, and generation fencing
 * all hold PER CHANNEL (each channel is its own QP: seal state and
 * retransmit bookkeeping are channel-local by construction).
 * channels == 1 is exactly tdr_ring_create. */
tdr_ring *tdr_ring_create_channels(tdr_engine *e, tdr_qp *const *lefts,
                                   tdr_qp *const *rights, int channels,
                                   int rank, int world);
/* Channel count of a ring (1 for tdr_ring_create rings). */
int tdr_ring_channels(const tdr_ring *r);
/* EFFECTIVE ring chunk size in bytes (TDR_RING_CHUNK override or the
 * built-in default): the value schedule digests must hash — the raw
 * env string hides a changed built-in default from the digest. */
size_t tdr_ring_chunk_bytes(void);
/* Stamp the collective trace id for the NEXT collective on this ring
 * (blocking call or async start): the id lands in every telemetry
 * event of that collective and — when FEAT_COLL_ID is negotiated —
 * rides the frame header to the peer. Sticky until replaced; the
 * caller (the world layer) sets a fresh per-world monotonic id before
 * every collective. Rings whose caller never sets one auto-assign
 * ids with bit 63 set, so caller-assigned and auto ids never
 * collide. Purely observational: never negotiated, never part of the
 * schedule digest, and results are unaffected. */
void tdr_ring_set_coll(tdr_ring *r, uint64_t coll_id);
int tdr_ring_allreduce(tdr_ring *r, void *data, size_t count, int dtype,
                       int red_op);
/* The rest of the MPI-app collective surface, sharing the
 * allreduce's segment layout and ownership convention:
 * reduce_scatter is its phase 1 — on return this rank's OWNED range
 * (the fully-reduced segment (rank+1) % world) is reported via
 * own_off/own_len (byte offset/length into data; either may be
 * NULL); all_gather is its phase 2 and assumes that same ownership;
 * broadcast streams root's nbytes down the ring, store-and-forward
 * per chunk. allreduce ≡ reduce_scatter; all_gather. */
int tdr_ring_reduce_scatter(tdr_ring *r, void *data, size_t count,
                            int dtype, int red_op, size_t *own_off,
                            size_t *own_len);
int tdr_ring_all_gather(tdr_ring *r, void *data, size_t count, int dtype);
int tdr_ring_broadcast(tdr_ring *r, void *data, size_t nbytes, int root);
/* In-place MPI_Alltoall: ``data`` = world equal segments, segment j
 * FOR rank j on entry, FROM rank j on return. count must divide by
 * world. Bundle-shrink ring schedule, w(w-1)/2 segments per link. */
int tdr_ring_alltoall(tdr_ring *r, void *data, size_t count, int dtype);
/* Root-reduce: converging fold toward root (one N-byte pass per
 * link, chunk-pipelined through the fused recv_reduce op). In-place
 * and DESTRUCTIVE on non-root ranks: their buffers end holding the
 * partial sums that passed through them; only root holds the full
 * reduction. */
int tdr_ring_reduce(tdr_ring *r, void *data, size_t count, int dtype,
                    int red_op, int root);
/* int8 wire-compressed allreduce (FEAT_WIRE_Q8 on every channel QP,
 * else fails fast): `q8` holds count int8 elements quantized with the
 * symmetric per-bucket `scale_in` (true value = q[i] * scale_in, the
 * caller computed scale_in = absmax/127 and keeps the error-feedback
 * residual). Runs the textbook RS+AG ring but each wire piece is
 * [f32 running scale][int8 segment] inside an ordinary sealed SEND
 * payload, and the fold REQUANTIZES under the summed scale
 * (q := round((s_l*q_l + s_f*q_f)/(s_l+s_f))) so magnitudes never
 * clip no matter the world size. The all-gather circulates the
 * reduced [scale][q8] pieces verbatim, so every rank dequantizes
 * IDENTICAL bits: f32_out[i] = q[i] * scale_of_segment, bitwise equal
 * across ranks. `q8` is scratch (destroyed); f32_out receives the
 * count-element f32 result and may be any host buffer (never posted
 * to the wire). Wire bytes ~= half of the bf16 schedule's for the
 * same count (+4 bytes of scale per piece). */
int tdr_ring_allreduce_q8(tdr_ring *r, void *q8, size_t count,
                          float scale_in, float *f32_out);
/* Front-load registration for a caller-stable buffer; allreduces on it
 * post work requests only. Unregistered buffers are registered per
 * call (safe for arbitrary/recycled addresses, slower). */
int tdr_ring_register(tdr_ring *r, void *base, size_t len);
int tdr_ring_unregister(tdr_ring *r, void *base);
/* Adopt an externally-owned MR (typically a dma-buf MR over device
 * memory, tdr_reg_dmabuf_mr with iova = the device VA) as the data MR
 * for allreduces whose data pointer equals `base`. The ring NEVER
 * deregisters an adopted MR — the caller keeps ownership and must
 * tdr_ring_unregister(base) before invalidating/deregistering it.
 * This is the zero-copy collective path: the ring posts directly
 * against pinned device memory, no host staging. */
int tdr_ring_adopt_mr(tdr_ring *r, void *base, tdr_mr *mr);
void tdr_ring_destroy(tdr_ring *r);

/* ------------------------------------------------------------------ *
 * Nonblocking ring collectives — handle-based allreduce.
 *
 * tdr_ring_start posts an allreduce onto the ring's async driver (one
 * dedicated thread per ring, spawned lazily at the first start and
 * joined at destroy) and returns immediately with a handle. Ops
 * execute STRICTLY in submission order — submission order is the SPMD
 * contract: every rank must start the same ops in the same order, and
 * the driver serializes them on the ring exactly as back-to-back
 * blocking calls would, so a mixed async/blocking fleet stays
 * wire-compatible and results are bitwise identical to the blocking
 * API. While an op is in flight the CALLER's thread never parks on
 * the progress machinery (the shard threads own polling; the driver
 * thread owns posting/consuming), which is what lets a training step
 * overlap its backward pass with the wire.
 *
 * Failure is HANDLE-SCOPED: a failed op records its error on the
 * handle; tdr_ring_wait/tdr_ring_test surface it into the calling
 * thread's tdr_last_error slot with the same status labels as the
 * blocking API, so the existing retryable/fatal taxonomy (and the
 * elastic rebuild ladder above it) applies unchanged. After any async
 * failure the driver fails subsequent queued ops fast ("aborted after
 * earlier failure") instead of posting into a broken ring — the
 * caller's recovery is a world rebuild, which replaces the ring.
 *
 * The data buffer must stay alive and untouched until the handle
 * completes. Do not run OTHER collectives on the ring between start
 * and wait unless every rank interleaves them identically (they would
 * serialize correctly but a cross-rank order divergence desyncs the
 * wire, exactly as with blocking calls from two threads).
 *
 * tdr_ring_op_free on a still-pending handle blocks until the op
 * completes (every op terminates: the stall deadline bounds a wedged
 * collective), then releases it.
 * ------------------------------------------------------------------ */
typedef struct tdr_ring_op tdr_ring_op;
tdr_ring_op *tdr_ring_start(tdr_ring *r, void *data, size_t count,
                            int dtype, int red_op);
/* Nonblocking standalone phases on the same async driver — the
 * hierarchical schedule's building blocks (intra-host reduce-scatter
 * and all-gather overlap the inter-host ring through these). Same
 * submission-order/SPMD contract, handle surface, and failure
 * taxonomy as tdr_ring_start; results are bitwise the blocking
 * phases'. The reduce-scatter handle reports no ownership outparams —
 * callers read the (pure, layout-deterministic) segment bounds via
 * tdr_ring_owned_segment below. */
tdr_ring_op *tdr_ring_start_reduce_scatter(tdr_ring *r, void *data,
                                           size_t count, int dtype,
                                           int red_op);
tdr_ring_op *tdr_ring_start_all_gather(tdr_ring *r, void *data,
                                       size_t count, int dtype);
/* Nonblocking tdr_ring_allreduce_q8 — same driver, submission-order,
 * and failure contract as tdr_ring_start. Both `q8` and `f32_out`
 * must stay alive and untouched until the handle completes. */
tdr_ring_op *tdr_ring_start_q8(tdr_ring *r, void *q8, size_t count,
                               float scale_in, float *f32_out);
/* The BYTE offset/length of the segment this rank owns after a
 * reduce-scatter of `count` elements of `dtype` — the same
 * (rank+1) % world convention and remainder layout the collectives
 * use, exposed so async callers never re-derive the segment math. */
int tdr_ring_owned_segment(tdr_ring *r, size_t count, int dtype,
                           size_t *own_off, size_t *own_len);
/* 1 = done ok, 0 = still in flight, -1 = failed (error in
 * tdr_last_error and tdr_ring_op_error). */
int tdr_ring_test(tdr_ring_op *op);
/* Block until the op completes (timeout_ms < 0 = forever). 0 = done
 * ok; -1 = failed or timed out (tdr_last_error distinguishes; a
 * timeout leaves the op in flight and wait may be called again). */
int tdr_ring_wait(tdr_ring_op *op, int timeout_ms);
/* The op's recorded error ("" while pending or on success). */
const char *tdr_ring_op_error(tdr_ring_op *op);
/* 1 once the op completed (ok or failed). Unlike tdr_ring_test this
 * NEVER writes the calling thread's error slot — safe from finalizer
 * contexts that must not clobber an error another call is reading. */
int tdr_ring_op_done(tdr_ring_op *op);
void tdr_ring_op_free(tdr_ring_op *op);

/* Which schedule the LAST tdr_ring_allreduce on this ring ran —
 * introspection for tests/benches asserting that the negotiated
 * capabilities actually selected the fused paths. */
enum {
  TDR_SCHED_NONE = 0,     /* no allreduce yet */
  TDR_SCHED_GENERIC = 1,  /* two-phase pipeline (scratch fold) */
  TDR_SCHED_FUSED2 = 2,   /* world-2 fused exchange */
  TDR_SCHED_FUSED2_FB = 3,/* world-2 fused exchange with foldback */
  TDR_SCHED_WAVEFRONT = 4,/* world>2 flattened wavefront */
  TDR_SCHED_Q8 = 5,       /* int8 scale-carrying RS+AG (allreduce_q8) */
};
int tdr_ring_last_schedule(const tdr_ring *r);

#ifdef __cplusplus
}
#endif

#endif /* TDR_H_ */
