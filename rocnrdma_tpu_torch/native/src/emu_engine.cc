// Emulated RDMA backend: RC semantics over TCP, no hardware required.
//
// This is the "fake L2 backend" SURVEY.md §4 prescribes: the reference
// could only be tested on a Fiji GPU + ConnectX HCA; this backend lets
// the full registration → transfer → revocation lifecycle run anywhere.
//
// Model: each QP is one TCP connection plus a progress thread that
// plays the HCA role on the passive side — it applies inbound RDMA
// WRITEs directly into registered memory, serves READs out of it, and
// generates completions. rkey checks happen remotely, exactly where a
// real HCA checks its MTT: a revoked MR (tdr_mr_invalidate) makes
// in-flight and future remote ops complete with REM_ACCESS_ERR, which
// is how the reference's free-while-registered invalidation
// (amdp2p.c:88-109) becomes observable to the peer.
//
// Transport tiers (the UCX/NCCL split — shm/CMA intra-node, network
// inter-node): when the connection handshake proves both peers share a
// host and cross-memory access works (a probed process_vm_readv, or
// the same process), data moves by a single direct copy between the
// registered regions — descriptor frames on the socket, payload via
// CMA — at memory bandwidth. Otherwise payloads stream on the socket.
// Both tiers keep the reference's invariant: the post path does no
// per-byte work beyond the gathered submission out of the registered
// buffer itself; there is no intermediate staging copy.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace tdr {
namespace {

enum WireOp : uint8_t {
  OP_WRITE = 1,
  OP_WRITE_ACK = 2,
  OP_READ_REQ = 3,
  OP_READ_RESP = 4,
  OP_SEND = 5,
  OP_SEND_ACK = 6,
  OP_GOODBYE = 7,
  // Descriptor-mode ops (CMA tier): no payload follows the header;
  // `aux` carries the peer-side VA and the receiver moves the bytes
  // with one process_vm_readv/writev (plain memcpy within a process).
  OP_WRITE_DESC = 8,
  OP_READ_REQ_DESC = 9,
  OP_SEND_DESC = 10,
  // Fold-and-write-back sends (tdr_post_send_foldback): the receiver
  // folds the payload into its matched recv_reduce buffer and returns
  // the folded result in place over the sender's source. Stream tier:
  // payload follows the FB frame and the folded bytes ride back on
  // the ack (a copy independent of the receiver's buffer). CMA tier:
  // the receiver's ONE-PASS fused kernel (par_cma_reduce2) folds and
  // writes the peer's memory directly, then the bare ack releases the
  // sender — push-before-ack makes the ordering safe (the sender's
  // bytes are final before either side completes), and the sender's
  // pending op holds an ACTIVE inflight ref on its MR from post to
  // completion, so revocation/dereg quiesce across the push instead
  // of letting the owner reclaim the pages under it.
  OP_SEND_FB = 11,
  OP_SEND_FB_DESC = 12,
  OP_SEND_FB_ACK = 13,
  // Sealed-connection chunk NAK (receiver → sender): land-time seal
  // verification failed for frame `seq`; re-post it from the
  // still-live source buffer. The pending op on the sender holds an
  // inflight MR ref until the final ack, so the source cannot be
  // reclaimed while retransmissions are possible.
  OP_NAK = 14,
  // Hung-peer probe (FEAT_PROBE, negotiated like FEAT_COLL_ID so
  // legacy frames stay byte-identical): a zero-byte PING answered by
  // the peer's PROGRESS THREAD with a PONG echoing the token in aux.
  // A pong proves the peer process is alive and draining its socket —
  // distinguishing "alive but slow" (degrade) from "gone/frozen"
  // (escalate) at the stall site. Sealed connections append a
  // tag-only trailer (CRC over the tag + steering fields; there is no
  // payload).
  OP_PING = 15,
  OP_PONG = 16,
};

// Seal: CRC32C over the payload, then extended over the (generation,
// step, chunk-seq) tag — so a flipped payload byte, a flipped tag, OR
// a stale-incarnation ghost frame all fail the same verification.
// Carried after the payload on stream frames and directly after the
// header on desc frames (the "piggybacked seal frame": desc payloads
// move via CMA, never the socket).
#pragma pack(push, 1)
struct SealTrailer {
  uint32_t crc;
  uint32_t gen;   // sender incarnation + 1 (0 = unset, fence skipped)
  uint32_t step;  // training step (low 32 bits; informational, CRC'd)
  uint32_t cseq;  // frame sequence (low 32 bits)
};
#pragma pack(pop)
static_assert(sizeof(SealTrailer) == 16, "wire format");

struct FrameHdr;
// Declared after FrameHdr below: the seal CRC covers the payload, the
// trailer tag, AND the landing-steering header fields.
uint32_t seal_crc(const SealTrailer &t, const FrameHdr &h,
                  const void *data, size_t len);

#pragma pack(push, 1)
struct FrameHdr {
  uint8_t op;
  uint8_t status;
  uint16_t pad;
  uint32_t rkey;
  uint64_t seq;
  uint64_t raddr;
  uint64_t len;
  uint64_t aux;  // desc mode: source (WRITE/SEND) or dest (READ) VA
  // Collective trace id (FEAT_COLL_ID extension). On the wire ONLY
  // when both ends negotiated the feature (telemetry on at handshake
  // on both ranks) — connections without it send/read exactly the
  // first kFrameHdrWireBase bytes, byte-identical to the
  // pre-trace-id framing. Retransmissions rebuild the header from the
  // pending op, which keeps the original id. Deliberately not
  // CRC-covered: a flipped id mislabels a telemetry event, never a
  // landing.
  uint64_t coll;
};
#pragma pack(pop)
static_assert(sizeof(FrameHdr) == 48, "wire format");
constexpr size_t kFrameHdrWireBase = 40;  // bytes without FEAT_COLL_ID

// Seal CRC material: payload bytes, the trailer tag (gen/step/cseq),
// then the header fields that STEER the landing (len, raddr) — a
// flipped length or write address must fail the seal instead of
// landing intact bytes in the wrong place (the misdirected-WRITE
// case). The frame sequence is enforced by the explicit
// t.cseq == h.seq check at verify time; op/status are deliberately
// uncovered (status legitimately differs between a first transmission
// and its retransmission).
uint32_t seal_crc(const SealTrailer &t, const FrameHdr &h,
                  const void *data, size_t len) {
  uint32_t c = crc32c(data, len, 0);
  c = crc32c(&t.gen, 12, c);
  c = crc32c(&h.len, sizeof(h.len), c);
  c = crc32c(&h.raddr, sizeof(h.raddr), c);
  return c;
}

// Feature bits (FEAT_FOLDBACK / FEAT_FUSED2) and the local_features()
// advertising helper are shared with the verbs backend — see common.h.

// Connection handshake: each side announces identity and a probe
// address; each side then attempts a cross-memory read of the peer's
// probe word and reports the result. CMA turns on only if BOTH
// directions verified — no configuration, no guessing about ptrace
// scope or container boundaries.
#pragma pack(push, 1)
struct Hello {
  uint64_t magic;
  uint32_t version;
  int32_t pid;
  uint32_t uid;
  char boot_id[40];
  uint64_t probe_addr;
  uint64_t probe_val;
  // Random per-process token: the only trustworthy same-process test.
  // pid comparison is namespace-relative (two containers both have a
  // "pid 1"), so it is never used to decide the memcpy fast path.
  uint64_t proc_token;
  uint32_t features;  // FEAT_* this side is willing to speak
  uint32_t pad;
};
struct HelloResult {
  uint8_t cma_ok;
};
#pragma pack(pop)
constexpr uint64_t kHelloMagic = 0x7464725f656d7531ull;  // "tdr_emu1"

uint64_t process_token() {
  static const uint64_t tok = [] {
    uint64_t t = 0;
    int fd = ::open("/dev/urandom", O_RDONLY);
    if (fd >= 0) {
      if (::read(fd, &t, sizeof(t)) != sizeof(t)) t = 0;
      ::close(fd);
    }
    if (t == 0) {
      // Fallback mix: ASLR'd address ^ pid ^ clock.
      t = reinterpret_cast<uint64_t>(&tok) ^
          (static_cast<uint64_t>(getpid()) << 32) ^
          static_cast<uint64_t>(
              std::chrono::steady_clock::now().time_since_epoch().count());
    }
    return t;
  }();
  return tok;
}

std::string read_boot_id() {
  char buf[64] = {0};
  int fd = ::open("/proc/sys/kernel/random/boot_id", O_RDONLY);
  if (fd >= 0) {
    ssize_t n = ::read(fd, buf, sizeof(buf) - 1);
    ::close(fd);
    if (n > 0) buf[n] = 0;
  }
  return std::string(buf);
}

bool cma_disabled() { return env_set("TDR_NO_CMA"); }

// Fault injection (tests): the landing-time hook widens the window
// between an inbound message matching a posted recv and the
// landing-time MR re-validation to a deterministic size, so the
// free-while-landing interleaving (amdp2p.c:88-109 — the subtlest
// behavior the reference exists to handle) can be forced rather than
// raced for. It and the post-path hooks below are driven by the
// TDR_FAULT_PLAN registry (fault.cc); the legacy
// TDR_FAULT_LANDING_DELAY_MS knob still works through it.
void fault_landing_delay() { fault_land_delay(); }

// Payload-size sanity cap for wire-controlled allocations (bounced
// unexpected messages, foldback buffers): a corrupt peer must not be
// able to bad_alloc the progress thread. Legit messages are ring
// chunks — MBs.
constexpr uint64_t kMaxUnexpectedBytes = 1ull << 30;

// Single-copy moves between address spaces (cma_copy_from/to) live in
// copy_pool.cc along with the pool-parallel wrappers used below — the
// emulated analogue of an HCA's parallel DMA engines.

class EmuEngine;

class EmuMr : public Mr {
 public:
  EmuEngine *eng = nullptr;
  void *mapped = nullptr;  // dma-buf mmap base (owned), else null
  size_t maplen = 0;
  // In-flight accesses ("NIC" DMA in progress): every WRITE into this
  // MR's memory (recv landings, READ-response landings) AND every
  // pending op whose local buffer the peer may still touch (desc-tier
  // WRITE/SEND/foldback sources the peer reads or writes back into,
  // READ destinations the peer pushes into) — held from post to
  // completion/flush. dereg and invalidate block on this reaching
  // zero, matching ibv_dereg_mr's guarantee that the NIC never
  // touches the memory after teardown returns. The wait is bounded in
  // practice by the peer's progress threads (acks are generated by
  // the transport, not by user polls) and, in wedged-collective error
  // states, by the stall deadline after which connections close and
  // the flush drops the refs; both waiters also carry a hard deadline
  // (see quiesce_wait) as a backstop. KNOWN RESIDUAL of the emulation
  // model (present in every revision): after a connection dies, the
  // flush drops pending refs while the PEER process may still be
  // mid-CMA-write into this buffer — the emulated "HCA" is split
  // across processes, so teardown here cannot stop the other side's
  // copy engine the way a real QP error state stops the one shared
  // HCA. The window requires connection loss + immediate reclamation
  // + a peer mid-write; closing it fully needs per-write completion
  // handshakes (measured ~30% off the fused exchange).
  std::atomic<int> inflight{0};
  // Object-lifetime references: queued recvs (PostedRecv::mr) hold
  // the EmuMr alive so the landing path can re-validate through it.
  // Unlike inflight, a queued recv may never match — dereg must NOT
  // wait for these, so a dereg'd MR with live recv_refs parks in the
  // engine graveyard instead of being freed.
  std::atomic<int> recv_refs{0};
  // Revocation QUIESCES: mark invalid first (no new landings start,
  // no new posts accepted), then wait out in-flight DMA and pending
  // exposures — the owner reclaims the pages only after free_callback
  // returns, so an invalidate that returned mid-access would hand
  // reclaimed memory to a still-running copy (the reference's
  // free_callback contract: KFD reclaims on callback return,
  // amdp2p.c:105-107, which is only safe because the IB teardown
  // inside the callback quiesced the NIC first). The engine-mutex
  // barrier between the store and the wait serializes against
  // landing_begin's check-then-increment (held under that same
  // mutex): any landing that read valid==true has raised inflight
  // before the barrier returns; later ones observe valid==false.
  // Defined out of line — EmuEngine is incomplete here.
  int invalidate() override;
  // Wait for in-flight accesses to drain, with a hard deadline (the
  // ring stall deadline + slack) as a backstop for doubly-wedged
  // error states where no flush will ever run. Returns false on
  // timeout (the guarantee is degraded; callers surface it).
  bool quiesce_wait();
  ~EmuMr() override {
    if (mapped) munmap(mapped, maplen);
  }
};

class EmuQp;

class EmuEngine : public Engine {
 public:
  int kind() const override { return TDR_ENGINE_EMU; }
  const char *name() const override { return "emu"; }

  // Seal context (tdr_seal_context): stamped into every outbound seal
  // and compared at land time — the fence that turns a
  // stale-incarnation ghost write into a detected integrity failure
  // instead of silently averaged garbage. Engine-scoped (one engine
  // per rank), not process-wide: in-process multi-rank tests must not
  // share it.
  void set_seal_ctx(uint64_t gen_plus1, uint64_t step) override {
    seal_gen_.store(gen_plus1, std::memory_order_relaxed);
    seal_step_.store(step, std::memory_order_relaxed);
  }
  uint64_t seal_gen() const {
    return seal_gen_.load(std::memory_order_relaxed);
  }
  uint64_t seal_step() const {
    return seal_step_.load(std::memory_order_relaxed);
  }

  Mr *reg_mr(void *addr, size_t len, int access) override {
    if (!addr || len == 0) {
      set_error("reg_mr: null addr or zero len");
      return nullptr;
    }
    auto *mr = new EmuMr();
    mr->engine = this;
    mr->eng = this;
    mr->addr = reinterpret_cast<uint64_t>(addr);
    mr->len = len;
    mr->access = access;
    std::lock_guard<std::mutex> g(mu_);
    mr->lkey = mr->rkey = next_key_++;
    mrs_[mr->rkey] = mr;
    return mr;
  }

  // Emulated dma-buf path: mmap the fd so the "device" memory behind it
  // is addressable, then register the mapping. On the verbs backend the
  // same API goes to ibv_reg_dmabuf_mr with no CPU mapping at all.
  Mr *reg_dmabuf_mr(int fd, size_t offset, size_t len, uint64_t iova,
                    int access) override {
    if (len == 0) {
      set_error("reg_dmabuf_mr: zero len");
      return nullptr;
    }
    long pagesz = sysconf(_SC_PAGESIZE);
    size_t map_off = offset & ~static_cast<size_t>(pagesz - 1);
    size_t head = offset - map_off;
    void *m = mmap(nullptr, len + head, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, static_cast<off_t>(map_off));
    if (m == MAP_FAILED) {
      set_error(std::string("reg_dmabuf_mr: mmap: ") + strerror(errno));
      return nullptr;
    }
    auto *mr = new EmuMr();
    mr->engine = this;
    mr->eng = this;
    mr->mapped = m;
    mr->maplen = len + head;
    char *base = static_cast<char *>(m) + head;
    // The MR's address space is the IOVA the caller chose (defaulting
    // to the CPU mapping), so remote raddr arithmetic works the same
    // way as for plain MRs.
    mr->addr = iova ? iova : reinterpret_cast<uint64_t>(base);
    mr->len = len;
    mr->access = access;
    std::lock_guard<std::mutex> g(mu_);
    mr->lkey = mr->rkey = next_key_++;
    mrs_[mr->rkey] = mr;
    cpu_base_[mr->rkey] = base;
    return mr;
  }

  int dereg_mr(Mr *mr) override {
    auto *emr = static_cast<EmuMr *>(mr);
    // A dereg'd MR is no longer a valid landing target, whatever the
    // caller did about invalidate() first.
    emr->valid.store(false, std::memory_order_release);
    {
      std::lock_guard<std::mutex> g(mu_);
      mrs_.erase(mr->rkey);  // no new resolves from here on
      cpu_base_.erase(mr->rkey);
    }
    // Wait out in-flight "DMA" before freeing — ibv_dereg_mr
    // semantics (deadline-backstopped; see EmuMr::quiesce_wait).
    emr->quiesce_wait();
    // Queued recvs may still hold this MR (they check `valid` before
    // touching memory, but dereference the object to do so) — and may
    // never match, so waiting here could hang forever. Park the MR in
    // the graveyard instead; parked entries are reaped here once their
    // recv_refs drain (bounding the graveyard for long-lived engines
    // that cycle register→post→dereg), and engine close frees the rest.
    std::lock_guard<std::mutex> g(mu_);
    auto parked = [](EmuMr *m) {
      // recv_refs: queued recvs that may never match. inflight: a
      // timed-out quiesce (wedged peer) — the pending op's ref will
      // still be dropped at flush/completion, which must not touch a
      // freed object. Either parks the MR in the graveyard.
      return m->recv_refs.load(std::memory_order_acquire) > 0 ||
             m->inflight.load(std::memory_order_acquire) > 0;
    };
    for (auto it = graveyard_.begin(); it != graveyard_.end();) {
      if (!parked(*it)) {
        delete *it;
        it = graveyard_.erase(it);
      } else {
        ++it;
      }
    }
    if (parked(emr))
      graveyard_.push_back(emr);
    else
      delete emr;
    return 0;
  }

  ~EmuEngine() override {
    for (EmuMr *mr : graveyard_) delete mr;
  }

  // Resolve (rkey, raddr, len) to a CPU pointer, enforcing validity,
  // access rights, and bounds — the emulated MTT lookup. On success the
  // MR's inflight count is raised; caller must dma_done(mr) after I/O.
  char *resolve(uint32_t rkey, uint64_t raddr, uint64_t len, int need_access,
                EmuMr **out_mr) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = mrs_.find(rkey);
    if (it == mrs_.end()) return nullptr;
    EmuMr *mr = it->second;
    if (!mr->valid.load(std::memory_order_acquire)) return nullptr;
    if (need_access && !(mr->access & need_access)) return nullptr;
    if (raddr < mr->addr || len > mr->len ||
        raddr - mr->addr > mr->len - len)
      return nullptr;
    uint64_t off = raddr - mr->addr;
    auto cb = cpu_base_.find(rkey);
    char *base = (cb != cpu_base_.end())
                     ? cb->second
                     : reinterpret_cast<char *>(mr->addr);
    mr->inflight.fetch_add(1, std::memory_order_acq_rel);
    *out_mr = mr;
    return base + off;
  }

  static void dma_done(EmuMr *mr) {
    if (mr) mr->inflight.fetch_sub(1, std::memory_order_acq_rel);
  }

  // Serialize with any landing_begin in progress: acquiring the mutex
  // landing_begin holds for its check-then-increment guarantees that
  // a concurrent landing which read valid==true has already raised
  // inflight by the time this returns (EmuMr::invalidate's barrier).
  void quiesce_barrier() { std::lock_guard<std::mutex> g(mu_); }

  // Begin a landing write into a posted recv's MR: raise inflight and
  // re-check validity as one step under the engine mutex — the same
  // mutex dereg_mr holds while revoking — so dereg_mr's inflight wait
  // also covers in-progress recv landings. Without this, dereg_mr
  // could return while a landing write into the MR's memory was still
  // running and the owner could reclaim the pages mid-write (the
  // ibv_dereg_mr guarantee the reference's put_pages path preserves,
  // amdp2p.c:283-313). Caller must dma_done(mr) when the write ends.
  bool landing_begin(EmuMr *mr) {
    if (!mr) return true;
    std::lock_guard<std::mutex> g(mu_);
    if (!mr->valid.load(std::memory_order_acquire)) return false;
    mr->inflight.fetch_add(1, std::memory_order_acq_rel);
    return true;
  }

  // Local-side resolve for the posting path (lkey semantics).
  char *local_ptr(Mr *mr, size_t loff, size_t len) {
    if (!mr->valid.load(std::memory_order_acquire)) return nullptr;
    if (loff > mr->len || len > mr->len - loff) return nullptr;
    std::lock_guard<std::mutex> g(mu_);
    auto cb = cpu_base_.find(mr->rkey);
    char *base = (cb != cpu_base_.end())
                     ? cb->second
                     : reinterpret_cast<char *>(mr->addr);
    return base + loff;
  }

  Qp *listen(const char *bind_host, int port, int timeout_ms,
             int flags) override;
  Qp *connect(const char *host, int port, int timeout_ms,
              int flags) override;

 private:
  std::mutex mu_;
  std::unordered_map<uint32_t, EmuMr *> mrs_;
  std::unordered_map<uint32_t, char *> cpu_base_;  // dma-buf MRs only
  // MRs dereg'd while queued recvs still referenced them (see
  // dereg_mr); freed at engine close.
  std::vector<EmuMr *> graveyard_;
  uint32_t next_key_ = 0x1000;
  std::atomic<uint64_t> seal_gen_{0};
  std::atomic<uint64_t> seal_step_{0};
};

struct PendingOp {
  uint64_t wr_id;
  int opcode;     // TDR_OP_*
  char *dst;      // READ destination
  uint64_t len;
  // Local MR whose memory the peer may touch until this op completes
  // (desc-tier source it reads or folds back into, READ destination
  // it pushes into). Holds an ACTIVE inflight ref from post to
  // completion/flush, so revocation/dereg quiesce across the access;
  // ack-time landings additionally re-validate through it.
  EmuMr *mr = nullptr;
  // Retransmit state (sealed connections): everything needed to
  // re-post the wire frame from the still-live source on a NAK. The
  // inflight ref above is what makes reading `src` safe — an owner
  // invalidate/dereg blocks until this op's final ack drops it.
  uint8_t wire_op = 0;
  const char *src = nullptr;
  uint64_t raddr = 0;
  uint32_t rkey = 0;
  // Flight recorder: post timestamp feeding the post→completion
  // latency histogram. 0 when telemetry is off (no clock read).
  uint64_t post_ns = 0;
  // Collective trace id at post time (0 = none): retransmissions and
  // the completion's WC event keep reporting the ORIGINAL collective
  // whatever the QP's cur_coll has advanced to.
  uint64_t coll = 0;
  // NAK count for this op: drives the adaptive retransmit backoff
  // (exponential with deterministic jitter) — a corrupt storm backs
  // off instead of melting into a NAK/retx busy loop.
  uint32_t naks = 0;
};

// RAII pair for EmuEngine::landing_begin: guarantees the inflight ref
// drops on every exit path — a leaked ref would make dereg_mr spin
// forever. Null mr is a no-op.
struct DmaGuard {
  EmuMr *mr;
  ~DmaGuard() { EmuEngine::dma_done(mr); }
};

struct PostedRecv {
  uint64_t wr_id;
  char *dst;
  uint64_t maxlen;
  // Fused reduce-on-receive (post_recv_reduce): fold instead of store.
  bool is_reduce = false;
  int dtype = 0;
  int red_op = 0;
  // The MR dst resolves into. Holds a recv_ref from post until the
  // recv completes/flushes, so the landing path can (a) re-check
  // validity — a free-while-registered between post and landing must
  // fail the recv, not write reclaimed memory — and (b) trust that
  // the EmuMr object (and its dma-buf mapping) is still alive.
  EmuMr *mr = nullptr;
  // Posted-order ticket: recv COMPLETIONS are delivered to the CQ in
  // posted order even when a NAK/retransmit cycle finishes a later
  // recv first (the ring layers assume FIFO recv completion).
  uint64_t ticket = 0;
  // Flight recorder: post timestamp (0 = telemetry off at post time).
  uint64_t post_ns = 0;
  // Collective trace id at post time (0 = none).
  uint64_t coll = 0;
};

bool EmuMr::quiesce_wait() {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(ring_timeout_ms() + 5000);
  while (inflight.load(std::memory_order_acquire) > 0) {
    if (std::chrono::steady_clock::now() >= deadline) return false;
    std::this_thread::yield();
  }
  return true;
}

int EmuMr::invalidate() {
  valid.store(false, std::memory_order_release);
  if (eng) eng->quiesce_barrier();
  if (!quiesce_wait()) {
    // The collective is fatally wedged AND its stall deadline did not
    // flush the refs — the quiesce guarantee is degraded: report it
    // instead of silently handing back pages that may still see a
    // late write.
    set_error("mr_invalidate: quiesce timed out with DMA still in "
              "flight (wedged peer?)");
    return -1;
  }
  return 0;
}

class EmuQp : public Qp {
 public:
  EmuQp(EmuEngine *eng, int fd, int flags = 0)
      : eng_(eng), fd_(fd),
        force_stream_((flags & TDR_CONN_FORCE_STREAM) != 0) {
    handshake();
    progress_ = std::thread([this] { progress_loop(); });
  }

  ~EmuQp() override {
    close_qp();
    if (progress_.joinable()) progress_.join();
  }

  // Flight-recorder event bound to this QP's (engine, qp) tracks —
  // one predicted branch when TDR_TELEMETRY is off. `coll` tags the
  // event with its collective trace id: posting sites pass the
  // ring-stamped cur_coll, landing sites the frame-carried id.
  void tel(uint16_t type, uint64_t id, uint64_t arg, uint64_t coll = 0) {
    TDR_TELC(type, eng_->tel_id, tel_id, id, arg, coll);
  }

  // Completion accounting: the WC event plus the post→completion
  // latency and payload-size histograms. Successful ops only for
  // both: errored lengths are not traffic, and a flushed WR's
  // "latency" is the stall-until-teardown duration — recording it
  // would let one fault run poison the p99 the bench record diffs.
  void tel_wc(uint64_t wr_id, int status, uint64_t len, uint64_t post_ns,
              uint64_t coll = 0) {
    if (!tel_on()) return;
    tel_emit(TDR_TEL_WC, eng_->tel_id, tel_id, wr_id,
             static_cast<uint64_t>(status), coll);
    if (status != TDR_WC_SUCCESS) return;
    if (post_ns)
      tel_hist_add(TDR_HIST_CHUNK_LAT_US, (tel_now_ns() - post_ns) / 1000);
    if (len) tel_hist_add(TDR_HIST_CHUNK_BYTES, len);
  }

  // Fault-plan hook shared by every post path: a conn-drop clause
  // shuts this QP's socket down (the post then flushes, and the peer
  // sees RC connection loss); a send-site clause completes the WR
  // with the injected status instead of transmitting. Returns true
  // when the WR was consumed by an injection.
  bool fault_post(const char *site, int opcode, uint64_t wr_id) {
    if (fault_point("conn") == TDR_FAULT_DROP)
      ::shutdown(fd_, SHUT_RDWR);
    if (site) {
      int f = fault_point(site,
                          static_cast<long long>(wr_id & 0xffffffffffffull));
      if (f >= 0) {
        push_wc({wr_id, f, opcode, 0});
        return true;
      }
    }
    return false;
  }

  int post_write(Mr *lmr, size_t loff, uint64_t raddr, uint32_t rkey,
                 size_t len, uint64_t wr_id) override {
    uint64_t coll = cur_coll.load(std::memory_order_relaxed);
    tel(TDR_TEL_POST_WRITE, wr_id, len, coll);
    fault_post(nullptr, TDR_OP_WRITE, wr_id);
    char *src = eng_->local_ptr(lmr, loff, len);
    auto *emr = static_cast<EmuMr *>(lmr);
    if (!src) {
      set_error("post_write: invalid local MR range");
      return -1;
    }
    // Active exposure ref (validity-checked): held by the pending op
    // until completion/flush so revocation quiesces across the peer's
    // access to this buffer.
    if (!eng_->landing_begin(emr)) {
      set_error("post_write: MR invalidated");
      return -1;
    }
    FrameHdr h{};
    h.op = cma_ ? OP_WRITE_DESC : OP_WRITE;
    h.rkey = rkey;
    h.raddr = raddr;
    h.len = len;
    h.aux = reinterpret_cast<uint64_t>(src);
    h.coll = coll;
    h.seq = new_pending(wr_id, TDR_OP_WRITE, nullptr, len, emr, h.op, src,
                        raddr, rkey, coll);
    if (!send_frame_sealed(h, src, len, cma_, wr_id))
      return fail_pending(h.seq);
    return 0;
  }

  int post_read(Mr *lmr, size_t loff, uint64_t raddr, uint32_t rkey,
                size_t len, uint64_t wr_id) override {
    uint64_t coll = cur_coll.load(std::memory_order_relaxed);
    tel(TDR_TEL_POST_READ, wr_id, len, coll);
    fault_post(nullptr, TDR_OP_READ, wr_id);
    char *dst = eng_->local_ptr(lmr, loff, len);
    auto *emr = static_cast<EmuMr *>(lmr);
    if (!dst) {
      set_error("post_read: invalid local MR range");
      return -1;
    }
    // Active exposure ref (validity-checked): held by the pending op
    // until completion/flush so revocation quiesces across the peer's
    // access to this buffer.
    if (!eng_->landing_begin(emr)) {
      set_error("post_read: MR invalidated");
      return -1;
    }
    FrameHdr h{};
    h.op = cma_ ? OP_READ_REQ_DESC : OP_READ_REQ;
    h.rkey = rkey;
    h.raddr = raddr;
    h.len = len;
    h.aux = reinterpret_cast<uint64_t>(dst);
    h.coll = coll;
    h.seq = new_pending(wr_id, TDR_OP_READ, dst, len, emr, 0, nullptr, 0, 0,
                        coll);
    if (!send_frame(h, nullptr, 0)) return fail_pending(h.seq);
    return 0;
  }

  int post_send(Mr *lmr, size_t loff, size_t len, uint64_t wr_id) override {
    uint64_t coll = cur_coll.load(std::memory_order_relaxed);
    tel(TDR_TEL_POST_SEND, wr_id, len, coll);
    if (fault_post("send", TDR_OP_SEND, wr_id)) return 0;
    char *src = eng_->local_ptr(lmr, loff, len);
    auto *emr = static_cast<EmuMr *>(lmr);
    if (!src) {
      set_error("post_send: invalid local MR range");
      return -1;
    }
    // Active exposure ref (validity-checked): held by the pending op
    // until completion/flush so revocation quiesces across the peer's
    // access to this buffer.
    if (!eng_->landing_begin(emr)) {
      set_error("post_send: MR invalidated");
      return -1;
    }
    FrameHdr h{};
    h.op = cma_ ? OP_SEND_DESC : OP_SEND;
    h.len = len;
    h.aux = reinterpret_cast<uint64_t>(src);
    h.coll = coll;
    h.seq = new_pending(wr_id, TDR_OP_SEND, nullptr, len, emr, h.op, src,
                        0, 0, coll);
    if (!send_frame_sealed(h, src, len, cma_, wr_id))
      return fail_pending(h.seq);
    return 0;
  }

  int post_recv(Mr *lmr, size_t loff, size_t maxlen, uint64_t wr_id) override {
    char *dst = eng_->local_ptr(lmr, loff, maxlen);
    if (!dst) {
      set_error("post_recv: invalid local MR range");
      return -1;
    }
    auto *emr = static_cast<EmuMr *>(lmr);
    emr->recv_refs.fetch_add(1, std::memory_order_acq_rel);
    return queue_recv({wr_id, dst, maxlen, false, 0, 0, emr});
  }

  int post_send_foldback(Mr *lmr, size_t loff, size_t len,
                         uint64_t wr_id) override {
    if (!(features_ & FEAT_FOLDBACK)) {
      set_error("post_send_foldback: not negotiated with peer");
      return -1;
    }
    uint64_t coll = cur_coll.load(std::memory_order_relaxed);
    tel(TDR_TEL_POST_SEND, wr_id, len, coll);
    if (fault_post("send", TDR_OP_SEND, wr_id)) return 0;
    char *src = eng_->local_ptr(lmr, loff, len);
    auto *emr = static_cast<EmuMr *>(lmr);
    if (!src) {
      set_error("post_send_foldback: invalid local MR range");
      return -1;
    }
    // Active exposure ref (validity-checked): held by the pending op
    // until completion/flush so revocation quiesces across the peer's
    // access to this buffer.
    if (!eng_->landing_begin(emr)) {
      set_error("post_send_foldback: MR invalidated");
      return -1;
    }
    FrameHdr h{};
    h.op = cma_ ? OP_SEND_FB_DESC : OP_SEND_FB;
    h.len = len;
    h.aux = reinterpret_cast<uint64_t>(src);
    h.coll = coll;
    // dst = src: the folded result lands back over the source region.
    // Stream tier: the ack payload is read into it (landing
    // re-validated at the ack handler); CMA tier: the receiver's
    // fused kernel writes it directly before acking, made safe by the
    // active inflight ref this post holds until completion.
    h.seq = new_pending(wr_id, TDR_OP_SEND, src, len, emr, h.op, src, 0, 0,
                        coll);
    if (!send_frame_sealed(h, src, len, cma_, wr_id))
      return fail_pending(h.seq);
    return 0;
  }

  bool has_send_foldback() const override {
    return (features_ & FEAT_FOLDBACK) != 0;
  }

  bool has_fused2() const override {
    return (features_ & FEAT_FUSED2) != 0;
  }

  int post_recv_reduce(Mr *lmr, size_t loff, size_t maxlen, int dtype,
                       int red_op, uint64_t wr_id) override {
    if (dtype_size(dtype) == 0) {
      set_error("post_recv_reduce: bad dtype");
      return -1;
    }
    char *dst = eng_->local_ptr(lmr, loff, maxlen);
    if (!dst) {
      set_error("post_recv_reduce: invalid local MR range");
      return -1;
    }
    auto *emr = static_cast<EmuMr *>(lmr);
    emr->recv_refs.fetch_add(1, std::memory_order_acq_rel);
    return queue_recv({wr_id, dst, maxlen, true, dtype, red_op, emr});
  }

  // Local (receiver-side) capability, not negotiated: a plain SEND
  // matches either recv flavor, so disabling it only changes OUR
  // posted-recv type. TDR_NO_RECV_REDUCE forces the ring onto the
  // windowed-scratch schedule — the fold-offload path's test/bench
  // hook (set it on ALL ranks, like TDR_NO_WAVEFRONT: schedule
  // selection keys off it).
  bool has_recv_reduce() const override {
    return !env_set("TDR_NO_RECV_REDUCE");
  }

  bool has_seal() const override { return seal_; }

  bool has_seal_payload() const override { return seal_payload_; }

  bool has_coll_id() const override { return coll_wire_; }

  // int8 wire compression: pure capability bit (mine & theirs at
  // handshake, like FEAT_FUSED2) — the q8 pieces are ordinary sealed
  // SEND payloads, so no frame parsing changes with it either way.
  bool has_wire_q8() const override {
    return (features_ & FEAT_WIRE_Q8) != 0;
  }

  // Hung-peer probe: PING the peer's PROGRESS THREAD and wait for the
  // echoed PONG. A pong proves the peer process is alive and draining
  // its socket even though the collective is stalled — "slow, degrade"
  // rather than "gone, escalate". Sealed connections carry a tag-only
  // trailer on both frames. Returns 1 alive, 0 no pong (hung), -1
  // connection down, -2 not negotiated (legacy peer / TDR_NO_PROBE —
  // frames stay byte-identical with the feature off).
  int probe(int timeout_ms) override {
    if (!(features_ & FEAT_PROBE)) return -2;
    uint64_t token;
    {
      std::lock_guard<std::mutex> g(mu_);
      if (dead_) return -1;
      token = ++probe_token_;
    }
    FrameHdr h{};
    h.op = OP_PING;
    h.aux = token;
    probe_count(kProbeSent);
    bool sent;
    if (seal_) {
      SealTrailer t{};
      t.cseq = static_cast<uint32_t>(token);
      t.crc = seal_crc(t, h, nullptr, 0);
      sent = send_frame(h, nullptr, 0, &t);
    } else {
      sent = send_frame(h, nullptr, 0);
    }
    if (!sent) return -1;
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms < 0 ? 0 : timeout_ms),
                 [&] { return dead_ || pong_token_ >= token; });
    if (pong_token_ >= token) return 1;
    if (dead_) return -1;
    probe_count(kProbeTimeout);
    return 0;
  }

  int poll(tdr_wc *wc, int max, int timeout_ms) override {
    // Stale reorder-hold flush rides the poll path: by the time a
    // driver is polling with nothing left to send, a held last frame
    // has no swap partner coming.
    netem_poll_flush();
    std::unique_lock<std::mutex> lk(mu_);
    if (cq_.empty() && timeout_ms != 0) {
      auto pred = [this] { return !cq_.empty() || dead_; };
      if (timeout_ms < 0)
        cv_.wait(lk, pred);
      else
        cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
    }
    int n = 0;
    while (n < max && !cq_.empty()) {
      wc[n++] = cq_.front();
      cq_.pop_front();
    }
    return n;
  }

  int close_qp() override {
    bool expected = false;
    if (!closing_.compare_exchange_strong(expected, true)) return 0;
    {
      // A reorder-held frame must precede the GOODBYE (original
      // order — its swap never happened, so the reservation refunds).
      std::lock_guard<std::mutex> g(send_mu_);
      flush_held_locked(/*swapped=*/false);
    }
    FrameHdr h{};
    h.op = OP_GOODBYE;
    send_frame(h, nullptr, 0);
    ::shutdown(fd_, SHUT_RDWR);
    return 0;
  }

 private:
  // An inbound message that arrived before any recv was posted. For
  // plain sends the payload is materialized (and already acked); for
  // foldback sends the ACK MUST WAIT for the fold, so the entry keeps
  // the seq (and, desc tier, the peer VA) and is resolved when a recv
  // shows up.
  struct Unexpected {
    std::vector<char> payload;
    bool fb = false;
    bool desc = false;
    uint64_t seq = 0;
    uint64_t src_va = 0;
    uint64_t len = 0;
    // Frame-carried collective trace id (0 = none / not negotiated).
    uint64_t coll = 0;
    // Sealed connections: the message arrived corrupt with no recv
    // posted. The entry holds the message's POSITION in the FIFO (so
    // later messages keep matching later recvs) while its payload
    // waits for a clean retransmission; a recv that reaches it parks
    // (parked_) instead of consuming it.
    bool awaiting_retx = false;
  };

  // Drop a consumed recv's MR reference (the last act of every path
  // that popped it — landing, flush, or immediate match).
  static void release_recv(const PostedRecv &r) {
    if (r.mr) r.mr->recv_refs.fetch_sub(1, std::memory_order_acq_rel);
  }

  // A recv's landing target is re-validated at LANDING time via
  // EmuEngine::landing_begin — a free-while-registered between post
  // and landing (owner revocation, amdp2p.c:88-109) must fail the
  // recv, never write through the stale pointer — and the landing
  // write itself holds an inflight ref so dereg_mr waits it out.

  // Common tail of post_recv/post_recv_reduce: consume a buffered
  // unexpected message if one raced ahead, else enqueue. Tickets are
  // assigned here, in posted order, under the same lock that orders
  // the match — delivery order == posted order by construction.
  int queue_recv(PostedRecv r) {
    if (tel_on()) {
      r.post_ns = tel_now_ns();
      r.coll = cur_coll.load(std::memory_order_relaxed);
      tel_emit(TDR_TEL_POST_RECV, eng_->tel_id, tel_id, r.wr_id, r.maxlen,
               r.coll);
    }
    std::unique_lock<std::mutex> lk(mu_);
    r.ticket = recv_head_++;
    if (!unexpected_.empty()) {
      if (unexpected_.front().awaiting_retx) {
        // The front message is a corrupt arrival awaiting its clean
        // retransmission: this recv is its match — park it (keyed by
        // the frame seq the retransmission will carry) and drop the
        // placeholder so later messages keep pairing with later
        // recvs.
        parked_[unexpected_.front().seq] = r;
        unexpected_.pop_front();
        return 0;
      }
      Unexpected u = std::move(unexpected_.front());
      unexpected_.pop_front();
      lk.unlock();
      if (!u.fb) {
        complete_recv(r,
                      deliver_buffer_wc(r, u.payload.data(),
                                        u.payload.size()));
      } else if (seal_payload_) {
        // Full sealing stages foldback payloads (verify-before-fold);
        // tag-only connections resolved the tag at arrival and fold
        // one-pass like unsealed ones.
        finish_foldback_sealed(r, u);
      } else {
        finish_foldback(r, u);
      }
      release_recv(r);
      return 0;
    }
    recvs_.push_back(r);
    return 0;
  }

  // Shared tail of every foldback delivery (matched immediately or
  // deferred): validate, fold + write back, ack (which releases the
  // sender), then deliver the local completion. The payload source is
  // the peer VA (desc tier) or `u.payload`, folded in place and
  // returned on the ack (stream tier). Returns the ack write's
  // success.
  bool finish_foldback(const PostedRecv &r, Unexpected &u) {
    fault_landing_delay();
    FrameHdr ack{};
    ack.op = OP_SEND_FB_ACK;
    ack.seq = u.seq;
    bool fold_ok = r.is_reduce && u.len <= r.maxlen &&
                   dtype_size(r.dtype) != 0 &&
                   u.len % dtype_size(r.dtype) == 0 &&
                   eng_->landing_begin(r.mr);
    // landing_begin only ran (and succeeded) when fold_ok is true.
    DmaGuard guard{fold_ok ? r.mr : nullptr};
    (void)guard;
    bool sent;
    if (!fold_ok) {
      ack.status = TDR_WC_LOC_ACCESS_ERR;
      sent = send_frame(ack, nullptr, 0);
      complete_recv(r,
                    {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, u.len});
      return sent;
    }
    if (u.desc) {
      // ONE fused pass: fold the peer's bytes into OUR buffer while
      // writing the folded result back into the peer's source — safe
      // because the sender's pending op holds an active inflight ref
      // on that source from post until our ack completes it, so
      // revocation on its side quiesces rather than reclaiming the
      // pages under this write. Push-before-ack also makes ordering
      // safe: by the time either side completes, both buffers are
      // final.
      bool ok = par_cma_reduce2(peer_pid_, r.dst, u.src_va, u.len, r.dtype,
                                r.red_op);
      if (ok) {
        tel(TDR_TEL_FOLD, u.seq, u.len, u.coll ? u.coll : r.coll);
        // The foldback return leg moves u.len bytes back into the
        // sender's buffer (process_vm here, ack payload on the stream
        // tier). It must count as wire_tx like the forward desc frame
        // does, or foldback schedules report half their real traffic
        // and cross-schedule byte comparisons lie. The ack itself
        // stays bare (len 0): the FB_ACK reader consumes h.len
        // payload bytes, and CMA already wrote the result back.
        tel(TDR_TEL_WIRE_TX, u.seq, u.len, u.coll ? u.coll : r.coll);
      }
      ack.status = ok ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
      sent = send_frame(ack, nullptr, 0);
      complete_recv(r,
                    {r.wr_id, ok ? TDR_WC_SUCCESS : TDR_WC_LOC_ACCESS_ERR,
                     TDR_OP_RECV, u.len});
      return sent;
    }
    // Stream tier: fold the payload in place (it ends up holding the
    // folded values) and return it on the ack. Parallel fold — MB-sized
    // chunks must not serialize on the progress thread when every other
    // landing path (par_reduce, par_cma_reduce_from) uses the copy pool.
    par_reduce2_local(r.dst, u.payload.data(),
                      u.len / dtype_size(r.dtype), r.dtype, r.red_op);
    tel(TDR_TEL_FOLD, u.seq, u.len, u.coll ? u.coll : r.coll);
    ack.status = TDR_WC_SUCCESS;
    ack.len = u.len;
    ack.coll = u.coll;
    // The folded result riding the ack is real socket traffic —
    // send_frame() emits no telemetry, so without this event the
    // foldback schedule's entire return leg would be invisible to
    // wire accounting.
    tel(TDR_TEL_WIRE_TX, u.seq, u.len, u.coll ? u.coll : r.coll);
    sent = send_frame(ack, u.payload.data(), u.payload.size());
    complete_recv(r, {r.wr_id, TDR_WC_SUCCESS, TDR_OP_RECV, u.len});
    return sent;
  }

  // Sealed foldback delivery: the payload was already VERIFIED (and
  // always materialized — the one-pass CMA fused kernel would fold
  // unverified bytes, so seal mode trades it for stage→verify→fold).
  // The folded result always returns as the ack's payload, itself
  // sealed; the sender verifies it at the write-back landing.
  bool finish_foldback_sealed(const PostedRecv &r, Unexpected &u) {
    fault_landing_delay();
    FrameHdr ack{};
    ack.op = OP_SEND_FB_ACK;
    ack.seq = u.seq;
    bool fold_ok = r.is_reduce && u.len <= r.maxlen &&
                   dtype_size(r.dtype) != 0 &&
                   u.len % dtype_size(r.dtype) == 0 &&
                   eng_->landing_begin(r.mr);
    DmaGuard guard{fold_ok ? r.mr : nullptr};
    (void)guard;
    if (!fold_ok) {
      ack.status = TDR_WC_LOC_ACCESS_ERR;
      bool sent = send_frame(ack, nullptr, 0);
      complete_recv(r,
                    {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, u.len});
      return sent;
    }
    par_reduce2_local(r.dst, u.payload.data(),
                      u.len / dtype_size(r.dtype), r.dtype, r.red_op);
    tel(TDR_TEL_FOLD, u.seq, u.len, u.coll ? u.coll : r.coll);
    ack.status = TDR_WC_SUCCESS;
    ack.len = u.len;
    ack.coll = u.coll;
    SealTrailer t{};
    t.gen = static_cast<uint32_t>(eng_->seal_gen());
    t.step = static_cast<uint32_t>(eng_->seal_step());
    t.cseq = static_cast<uint32_t>(ack.seq);
    t.crc = seal_crc(t, ack, u.payload.data(), u.len);
    seal_count(kSealSealed);
    // Sealed foldback returns bypass send_frame_sealed (the trailer is
    // hand-built over the folded bytes), so emit the wire_tx event the
    // normal sealed path would have.
    tel(TDR_TEL_WIRE_TX, u.seq, u.len, u.coll ? u.coll : r.coll);
    bool sent = send_frame(ack, u.payload.data(), u.payload.size(), &t);
    complete_recv(r, {r.wr_id, TDR_WC_SUCCESS, TDR_OP_RECV, u.len});
    return sent;
  }

  // Read the wire trailer and verify `len` landed payload bytes at
  // `data`. Applies land-site corrupt=N injection BEFORE the verify
  // ("flip bytes before verify on land"), then checks the CRC and the
  // incarnation fence. Returns false only on connection loss.
  bool read_and_verify_trailer(const FrameHdr &h, char *data, uint64_t len,
                               bool *ok_out) {
    SealTrailer t{};
    if (!rd(&t, sizeof(t))) return false;
    long long nb = fault_corrupt("land", static_cast<long long>(h.seq));
    if (nb > 0 && data && len) {
      size_t n = std::min<size_t>(static_cast<size_t>(nb),
                                  static_cast<size_t>(len));
      for (size_t i = 0; i < n; i++) data[i] ^= static_cast<char>(0xff);
    }
    // The CRC covers payload + tag + steering header fields; the
    // explicit cseq comparison additionally catches a flipped header
    // seq (which would otherwise route a retransmission to the wrong
    // parked recv — parked_/retx_attempts_ are keyed by it).
    bool ok = seal_crc(t, h, data, len) == t.crc &&
              t.cseq == static_cast<uint32_t>(h.seq);
    // Incarnation fence: intact bytes stamped by a DIFFERENT live
    // incarnation are a ghost from a stale world — reject them the
    // same way as corruption (detected, contained, retry-bounded).
    uint64_t local = eng_->seal_gen();
    if (ok && t.gen != 0 && local != 0 &&
        t.gen != static_cast<uint32_t>(local))
      ok = false;
    seal_count(ok ? kSealVerified : kSealFailed);
    tel(ok ? TDR_TEL_VERIFY_OK : TDR_TEL_VERIFY_FAIL, h.seq, len, h.coll);
    *ok_out = ok;
    return true;
  }

  // Land a payload already in local memory into a posted recv (store
  // or fold); returns the completion (caller pushes it — see
  // handle_send_inbound for why delivery is deferred).
  tdr_wc deliver_buffer_wc(const PostedRecv &r, const char *data,
                           size_t len) {
    fault_landing_delay();
    if (len > r.maxlen ||
        (r.is_reduce && len % dtype_size(r.dtype) != 0))
      return {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, len};
    // Landing holds an inflight ref on the target MR for the duration
    // of the write (see EmuEngine::landing_begin).
    if (!eng_->landing_begin(r.mr))
      return {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, len};
    DmaGuard guard{r.mr};
    (void)guard;
    tel(TDR_TEL_LAND, r.wr_id, len, r.coll);
    if (r.is_reduce) {
      par_reduce(r.dst, data, len / dtype_size(r.dtype), r.dtype, r.red_op);
      tel(TDR_TEL_FOLD, r.wr_id, len, r.coll);
    } else {
      par_memcpy(r.dst, data, len);
    }
    return {r.wr_id, TDR_WC_SUCCESS, TDR_OP_RECV, len};
  }

  // Land a streamed payload from the socket into *wc. Reduce recvs
  // fold the wire bytes through a small stack window — streaming
  // reduction, no scratch allocation. Returns false only on
  // connection loss.
  bool land_stream_wc(const PostedRecv &r, uint64_t len, tdr_wc *wc) {
    fault_landing_delay();
    if (len > r.maxlen ||
        (r.is_reduce && len % dtype_size(r.dtype) != 0) ||
        !eng_->landing_begin(r.mr)) {
      if (!drain(len)) return false;
      *wc = {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, len};
      return true;
    }
    DmaGuard guard{r.mr};
    (void)guard;
    tel(TDR_TEL_LAND, r.wr_id, len, r.coll);
    if (!r.is_reduce) {
      if (!rd(r.dst, len)) return false;
    } else {
      const size_t esz = dtype_size(r.dtype);
      char window[64 << 10];
      const size_t step = sizeof(window) - sizeof(window) % esz;
      char *dst = r.dst;
      uint64_t left = len;
      while (left > 0) {
        size_t chunk = left < step ? static_cast<size_t>(left) : step;
        if (!rd(window, chunk)) return false;
        reduce_any(dst, window, chunk / esz, r.dtype, r.red_op);
        dst += chunk;
        left -= chunk;
      }
      tel(TDR_TEL_FOLD, r.wr_id, len, r.coll);
    }
    *wc = {r.wr_id, TDR_WC_SUCCESS, TDR_OP_RECV, len};
    return true;
  }

  // Land a CMA payload (peer VA `src`) into *wc. Same-process reduce
  // reads the peer buffer in place — zero intermediate bytes;
  // cross-process reduce streams through a cache-sized window.
  // Returns whether the data movement succeeded (the ack status).
  bool land_cma_wc(const PostedRecv &r, uint64_t src, uint64_t len,
                   tdr_wc *wc) {
    fault_landing_delay();
    if (len > r.maxlen ||
        (r.is_reduce && len % dtype_size(r.dtype) != 0) ||
        !eng_->landing_begin(r.mr)) {
      *wc = {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, len};
      return true;  // desc mode: nothing on the wire to drain
    }
    DmaGuard guard{r.mr};
    (void)guard;
    tel(TDR_TEL_LAND, r.wr_id, len, r.coll);
    bool ok;
    if (!r.is_reduce) {
      ok = par_cma_copy_from(peer_pid_, r.dst, src, len);
    } else {
      ok = par_cma_reduce_from(peer_pid_, r.dst, src, len, r.dtype, r.red_op);
      if (ok) tel(TDR_TEL_FOLD, r.wr_id, len, r.coll);
    }
    *wc = {r.wr_id, ok ? TDR_WC_SUCCESS : TDR_WC_LOC_ACCESS_ERR,
           TDR_OP_RECV, len};
    return ok;
  }

  // Negotiate the data-path tier before any work is posted. A probe
  // failure degrades to the streaming tier; a peer that never speaks
  // the protocol (port scanner, crashed client) is shut down after a
  // bounded wait — the QP comes up dead-and-flushing, never hung.
  void handshake() {
    timeval tv{10, 0};
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    probe_val_ = kHelloMagic ^ reinterpret_cast<uint64_t>(this);
    Hello mine{};
    mine.magic = kHelloMagic;
    mine.version = 5;
    mine.pid = getpid();
    mine.uid = getuid();
    mine.features = local_features();
    std::string boot = read_boot_id();
    strncpy(mine.boot_id, boot.c_str(), sizeof(mine.boot_id) - 1);
    mine.probe_addr = reinterpret_cast<uint64_t>(&probe_val_);
    mine.probe_val = probe_val_;
    mine.proc_token = process_token();

    Hello peer{};
    if (!write_full(fd_, &mine, sizeof(mine)) ||
        !read_full(fd_, &peer, sizeof(peer)) ||
        peer.magic != kHelloMagic || peer.version != mine.version) {
      // Not a protocol peer (or it died): unusable for framing — any
      // later bytes could be a half-consumed Hello. Kill the socket so
      // the progress loop flushes everything posted.
      ::shutdown(fd_, SHUT_RDWR);
      tv = {0, 0};
      setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      return;
    }

    // Wire-changing features require agreement from both ends.
    features_ = mine.features & peer.features;
    // Sealed framing is wire-changing: only speak it when BOTH ends
    // advertised it (TDR_NO_SEAL opts out at the advertising stage, so
    // a mismatched pair degrades to plain frames, never misparses).
    seal_ = (features_ & FEAT_SEAL) != 0;
    seal_budget_ = seal_retry_budget();
    // Wire-carried collective trace ids: both ends were recording at
    // handshake time, so every frame header grows the 8-byte id word
    // (send_frame/progress_loop agree on the length per connection).
    coll_wire_ = (features_ & FEAT_COLL_ID) != 0;
    // seal_payload_ is resolved AFTER the CMA probe below: whether the
    // trailer CRC covers the payload depends on the negotiated tier.

    // Same process is decided by the random token, never by pid (pids
    // are namespace-relative). An unreadable boot_id fails CLOSED:
    // "can't prove same host" must not become "assume same host".
    bool same_process =
        peer.proc_token == process_token() && peer.pid == getpid();
    peer_pid_ = same_process ? kCmaSameProcess : peer.pid;
    bool same_host =
        boot[0] != '\0' &&
        strncmp(mine.boot_id, peer.boot_id, sizeof(mine.boot_id)) == 0;
    uint8_t my_ok = 0;
    // TDR_CONN_FORCE_STREAM: report the probe as failed so BOTH ends
    // resolve to the stream tier (cma_ = mine && theirs) — the
    // emulated inter-host link keeps full payload seals even when the
    // peer is actually CMA-reachable (host-key-override topologies).
    if ((same_process || same_host) && !cma_disabled() && !force_stream_) {
      uint64_t got = 0;
      if (cma_copy_from(peer_pid_, &got, peer.probe_addr, sizeof(got)) &&
          got == peer.probe_val)
        my_ok = 1;
    }
    HelloResult res{my_ok}, peer_res{};
    bool ok = write_full(fd_, &res, sizeof(res)) &&
              read_full(fd_, &peer_res, sizeof(peer_res));
    timeval off{0, 0};
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
    if (!ok) {
      ::shutdown(fd_, SHUT_RDWR);
      return;
    }
    cma_ = my_ok && peer_res.cma_ok;
    // CMA tier: tag-only sealing by default. The "wire" there is a
    // kernel memcpy (process_vm_readv / same-process memcpy) with no
    // payload bit-flip failure mode a CRC could catch — the same
    // rationale under which the verbs backend advertises has_seal=0
    // (the link's ICRC already covers the bytes). The trailer still
    // travels and is still verified: the generation fence, chunk seq,
    // and landing-steering fields (len/raddr) stay CRC-covered, so
    // stale-incarnation ghosts and misdirected frames fail exactly as
    // before — only the per-byte payload CRC (and with it the forced
    // stage→verify→fold staging copy) is dropped, restoring the
    // one-pass fused kernels on the hot path. FEAT_SEAL_CMA_FULL
    // (TDR_SEAL_CMA=1, both ends) reinstates full payload sealing —
    // the integrity tests drive the whole detect→NAK→retransmit
    // ladder through it. Both sides compute this identically (cma_
    // and features_ are agreed), so the CRC coverage never skews.
    seal_payload_ =
        seal_ && (!cma_ || (features_ & FEAT_SEAL_CMA_FULL) != 0);
  }

  // Caller already holds an ACTIVE inflight ref on `mr`
  // (landing_begin at the post path); ownership passes to the pending
  // entry and is dropped at completion, failure, or flush.
  uint64_t new_pending(uint64_t wr_id, int opcode, char *dst, uint64_t len,
                       EmuMr *mr, uint8_t wire_op = 0,
                       const char *src = nullptr, uint64_t raddr = 0,
                       uint32_t rkey = 0, uint64_t coll = 0) {
    PendingOp p{wr_id, opcode, dst, len, mr, wire_op, src, raddr, rkey, 0,
                coll};
    if (tel_on()) p.post_ns = tel_now_ns();
    std::lock_guard<std::mutex> g(mu_);
    uint64_t seq = next_seq_++;
    pending_[seq] = p;
    return seq;
  }

  static void release_pending_mr(EmuMr *mr) { EmuEngine::dma_done(mr); }

  int fail_pending(uint64_t seq) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = pending_.find(seq);
    if (it != pending_.end()) {
      tdr_wc wc{it->second.wr_id, TDR_WC_FLUSH_ERR, it->second.opcode, 0};
      uint64_t post_ns = it->second.post_ns;
      uint64_t coll = it->second.coll;
      cq_.push_back(wc);
      release_pending_mr(it->second.mr);
      pending_.erase(it);
      cv_.notify_all();
      lk.unlock();
      eng_->cq_pulse();
      tel_wc(wc.wr_id, wc.status, 0, post_ns, coll);
    }
    set_error("post: connection down");
    return -1;
  }

  bool send_frame(const FrameHdr &h, const void *payload, size_t len,
                  const SealTrailer *trailer = nullptr) {
    // Header wire length is fixed per CONNECTION at handshake time
    // (FEAT_COLL_ID appends the trace-id word); both ends agreed, so
    // the parser can never misframe.
    size_t hb = coll_wire_ ? sizeof(FrameHdr) : kFrameHdrWireBase;
    std::lock_guard<std::mutex> g(send_mu_);
    if (payload && len) {
      if (!write_hdr_payload(fd_, &h, hb, payload, len)) return false;
    } else {
      if (!write_full(fd_, &h, hb)) return false;
    }
    if (trailer && !write_full(fd_, trailer, sizeof(*trailer))) return false;
    // Any frame leaving after a reorder-held one is its swap partner:
    // the held frame follows it out, completing the injection.
    return flush_held_locked(/*swapped=*/true);
  }

  // ---- Netem sender riders -----------------------------------------
  // A reorder-held frame lives here, fully serialized, until a
  // successor frame overtakes it (flush under send_mu_ right after
  // that frame's bytes) or a stale-hold flush releases it in original
  // order. One-deep by construction.

  std::string serialize_frame(const FrameHdr &h, const char *payload,
                              size_t len, const SealTrailer *t) {
    size_t hb = coll_wire_ ? sizeof(FrameHdr) : kFrameHdrWireBase;
    std::string f;
    f.reserve(hb + len + (t ? sizeof(*t) : 0));
    f.append(reinterpret_cast<const char *>(&h), hb);
    if (payload && len) f.append(payload, len);
    if (t) f.append(reinterpret_cast<const char *>(t), sizeof(*t));
    return f;
  }

  // Flush the held frame (caller holds send_mu_). swapped=true when a
  // later frame overtook it — the reorder injection happened and its
  // clause's hit counter advances; false when it leaves in original
  // order (stale flush, close, teardown) — the reservation refunds so
  // the counters never claim a reorder that did not occur.
  bool flush_held_locked(bool swapped) {
    if (held_.empty()) return true;
    std::string f = std::move(held_);
    held_.clear();
    held_flag_.store(false, std::memory_order_release);
    fault_netem_commit(held_clause_, held_gen_, swapped);
    held_clause_ = -1;
    bool dup = held_dup_;
    held_dup_ = false;
    if (!write_full(fd_, f.data(), f.size())) return false;
    return !dup || write_full(fd_, f.data(), f.size());
  }

  // Stale-hold flush (called from poll, off the send path): a held
  // frame whose swap partner never came — the collective's last frame
  // — must still leave, or the peer waits on it until its stall
  // clock fires. 1ms grace keeps a hot send loop winning the swap.
  void netem_poll_flush() {
    if (!held_flag_.load(std::memory_order_acquire)) return;
    std::lock_guard<std::mutex> g(send_mu_);
    if (held_.empty()) return;
    uint64_t now = static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count());
    if (now - held_at_ns_ < 1000000ull) return;
    flush_held_locked(/*swapped=*/false);
  }

  // Seal-aware frame submission for every payload-bearing request
  // (SEND-class and WRITE, fresh posts and retransmissions). Computes
  // the CRC32C + (generation, step, chunk-seq) trailer over the SOURCE
  // bytes, then applies any matching send-site corrupt=N clause to the
  // WIRE copy only — the source buffer stays intact so a NAK-driven
  // retransmission can be clean ("flip bytes after seal on send").
  // Desc frames carry no payload on the socket, so their injected
  // corruption flips the CRC instead.
  bool send_frame_sealed(FrameHdr h, const char *src, size_t len, bool desc,
                         uint64_t wr_id) {
    tel(TDR_TEL_WIRE_TX, h.seq, len, h.coll);
    // Netem riders fire at frame-transmission time, scoped by the
    // link identity the ring stamped. The delay (delay/jitter rider +
    // throttle pacing) sleeps OUTSIDE send_mu_ so the progress
    // thread's acks/pongs keep flowing while this frame crawls.
    NetemAction act{};
    if (fault_netem_armed()) {
      bool fired =
          fault_netem(static_cast<long long>(wr_id & 0xffffffffffffull),
                      cma_ ? 1 : 0, link_lane.load(std::memory_order_relaxed),
                      link_rank.load(std::memory_order_relaxed),
                      link_peer.load(std::memory_order_relaxed), len, &act);
      if (fired) tel(TDR_TEL_FAULT, h.seq, len, h.coll);
      // Retransmissions bypass the receiver's ordering gate (their seq
      // sits below the watermark by design), so dup/reorder must not
      // touch them — a duplicated retx would land twice. Delay and
      // throttle still apply: a slow wire is slow for retx too.
      if (h.status != 0) {
        if (act.reorder)
          fault_netem_commit(act.reorder_clause, act.plan_gen, false);
        act.reorder = false;
        act.dup = false;
      }
      if (act.delay_us > 0)
        std::this_thread::sleep_for(std::chrono::microseconds(act.delay_us));
    }
    SealTrailer t{};
    const char *wire_src = desc ? nullptr : src;
    size_t wire_len = desc ? 0 : len;
    std::vector<char> wire;
    if (seal_) {
      t.gen = static_cast<uint32_t>(eng_->seal_gen());
      t.step = static_cast<uint32_t>(eng_->seal_step());
      t.cseq = static_cast<uint32_t>(h.seq);
      // Tag-only mode (CMA tier default): the CRC covers the tag and
      // the steering fields, not the payload — both ends agreed on the
      // coverage at handshake time, so verification stays symmetric.
      t.crc = seal_payload_ ? seal_crc(t, h, src, len)
                            : seal_crc(t, h, nullptr, 0);
      seal_count(kSealSealed);
      long long nb = fault_corrupt(
          "send", static_cast<long long>(wr_id & 0xffffffffffffull));
      if (nb > 0) {
        if (desc) {
          t.crc ^= 0xffffffffu;
        } else {
          // Corrupt the WIRE copy only — the source stays intact so a
          // NAK-driven retransmission can be clean.
          wire.assign(src, src + len);
          size_t n = std::min<size_t>(static_cast<size_t>(nb), len);
          for (size_t i = 0; i < n; i++) wire[i] ^= static_cast<char>(0xff);
          wire_src = wire.data();
        }
      }
    }
    if (!act.dup && !act.reorder)
      return send_frame(h, wire_src, wire_len, seal_ ? &t : nullptr);
    // Dup/reorder need the frame as one reusable byte string.
    std::string f =
        serialize_frame(h, wire_src, wire_len, seal_ ? &t : nullptr);
    std::lock_guard<std::mutex> g(send_mu_);
    if (act.reorder && held_.empty()) {
      held_ = std::move(f);
      held_clause_ = act.reorder_clause;
      held_gen_ = act.plan_gen;
      held_dup_ = act.dup;
      held_at_ns_ = static_cast<uint64_t>(
          std::chrono::duration_cast<std::chrono::nanoseconds>(
              std::chrono::steady_clock::now().time_since_epoch())
              .count());
      held_flag_.store(true, std::memory_order_release);
      return true;
    }
    if (act.reorder)  // one-deep hold: refund and transmit in order
      fault_netem_commit(act.reorder_clause, act.plan_gen, false);
    if (!write_full(fd_, f.data(), f.size())) return false;
    if (act.dup && !write_full(fd_, f.data(), f.size())) return false;
    return flush_held_locked(/*swapped=*/true);
  }

  // Recv completions reach the CQ in posted-ticket order: a chunk
  // stuck in a NAK/retransmit cycle holds back the delivery (not the
  // landing) of later chunks' completions, preserving the FIFO
  // completion order the ring schedules assert.
  void complete_recv(const PostedRecv &r, tdr_wc wc, uint64_t coll = 0) {
    // The WC event fires when the completion is RECORDED; CQ delivery
    // may still be withheld behind an earlier ticket (posted-order
    // contract) — the timeline shows the truth, not the FIFO.
    // `coll` is the landed frame's trace id when the caller has it;
    // the posted recv's own id is the fallback (SPMD keeps them equal
    // except across skewed collective boundaries).
    tel_wc(wc.wr_id, wc.status, wc.len, r.post_ns, coll ? coll : r.coll);
    {
      std::lock_guard<std::mutex> g(mu_);
      recv_done_[r.ticket] = wc;
      drain_recv_done_locked();
      cv_.notify_all();
    }
    // Engine-wide pulse AFTER the QP lock drops: a multi-QP waiter
    // (progress shard) re-sweeps on the pulse and must find the
    // completion already visible to tdr_poll.
    eng_->cq_pulse();
  }

  void drain_recv_done_locked() {
    while (!recv_done_.empty() &&
           recv_done_.begin()->first == recv_tail_) {
      cq_.push_back(recv_done_.begin()->second);
      recv_done_.erase(recv_done_.begin());
      recv_tail_++;
    }
  }

  void push_wc(tdr_wc wc) {
    tel_wc(wc.wr_id, wc.status, wc.len, 0);
    {
      std::lock_guard<std::mutex> g(mu_);
      cq_.push_back(wc);
      cv_.notify_all();
    }
    eng_->cq_pulse();
  }

  // Shared OP_SEND / OP_SEND_DESC skeleton, end to end: match the
  // inbound message to a posted recv (else bounce-buffer the payload
  // and re-check — a recv may have been posted while the payload was
  // being fetched; it saw unexpected_ empty and queued itself, so
  // deliver rather than strand it), write the ack, THEN deliver the
  // local completion. Ack-before-completion is load-bearing: a peer
  // whose collective finishes on the heels of our completion may
  // close the QP immediately, and an ack queued after the local push
  // can lose the send_mu_ race to that close's GOODBYE — and be cut
  // off entirely by its socket shutdown — flushing the peer's last
  // send with an error. Returns false on connection loss.
  bool handle_send_inbound(const FrameHdr &h, bool desc) {
    PostedRecv r{};
    bool have = false;
    {
      std::lock_guard<std::mutex> g(mu_);
      if (!recvs_.empty()) {
        r = recvs_.front();
        recvs_.pop_front();
        have = true;
      }
    }
    FrameHdr ack{};
    ack.op = OP_SEND_ACK;
    ack.seq = h.seq;
    if (have) {
      tdr_wc wc;
      if (desc) {
        ack.status = land_cma_wc(r, h.aux, h.len, &wc)
                         ? TDR_WC_SUCCESS
                         : TDR_WC_GENERAL_ERR;
      } else {
        if (!land_stream_wc(r, h.len, &wc)) {
          release_recv(r);
          return false;
        }
        ack.status = TDR_WC_SUCCESS;
      }
      release_recv(r);
      bool sent = send_frame(ack, nullptr, 0);
      complete_recv(r, wc, h.coll);
      return sent;
    }
    // Unexpected message: materialize it now. In desc mode the
    // sender's buffer is only promised stable until its completion,
    // which our ack produces — so the copy must happen before the ack.
    // The bounce buffer's size is wire-controlled: cap it (an
    // oversized frame kills this QP only — RC flush semantics, not
    // process death).
    if (h.len > kMaxUnexpectedBytes) return false;
    std::vector<char> buf(h.len);
    bool ok;
    if (desc) {
      ok = h.len == 0 ||
           par_cma_copy_from(peer_pid_, buf.data(), h.aux, h.len);
    } else {
      if (h.len && !rd(buf.data(), h.len)) return false;
      ok = true;
    }
    if (!ok) buf.clear();
    ack.status = ok ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
    bool sent = send_frame(ack, nullptr, 0);
    PostedRecv r2{};
    bool have2 = false;
    {
      std::lock_guard<std::mutex> g(mu_);
      if (!recvs_.empty()) {
        r2 = recvs_.front();
        recvs_.pop_front();
        have2 = true;
      } else if (ok) {
        Unexpected u;
        u.payload = std::move(buf);
        u.len = h.len;
        u.coll = h.coll;
        unexpected_.push_back(std::move(u));
      }
    }
    if (have2) {
      if (ok)
        complete_recv(r2,
                      deliver_buffer_wc(r2, buf.data(), buf.size()),
                      h.coll);
      else
        complete_recv(r2,
                      {r2.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, h.len},
                      h.coll);
      release_recv(r2);
    }
    return sent;
  }

  // OP_SEND_FB / OP_SEND_FB_DESC: fold into the matched recv_reduce
  // buffer and return the folded result to the sender — via a direct
  // CMA write-back (desc) or as the ack's payload (stream). Ack
  // before local completion, as everywhere; if no recv is posted yet
  // the ACK MUST WAIT for the fold, so the message is stashed and
  // resolved at post_recv_reduce time. Returns false on connection
  // loss.
  bool handle_foldback_inbound(const FrameHdr &h, bool desc) {
    if (h.len > kMaxUnexpectedBytes) return false;
    Unexpected u;
    u.fb = true;
    u.desc = desc;
    u.seq = h.seq;
    u.src_va = h.aux;
    u.len = h.len;
    u.coll = h.coll;
    if (!desc) {
      // Materialize the stream payload up front (it is consumed from
      // the socket either way; a doomed fold still must drain it).
      u.payload.resize(h.len);
      if (h.len && !rd(u.payload.data(), h.len)) return false;
    }
    PostedRecv r{};
    bool have = false;
    {
      std::lock_guard<std::mutex> g(mu_);
      if (!recvs_.empty()) {
        r = recvs_.front();
        recvs_.pop_front();
        have = true;
      } else {
        unexpected_.push_back(std::move(u));
      }
    }
    if (have) {
      bool sent = finish_foldback(r, u);
      release_recv(r);
      return sent;
    }
    return true;
  }

  // In-place sealed landing for a claimed plain recv (the fast path
  // in handle_sealed_inbound): land into r.dst under the MR's
  // inflight ref, verify there, ack on success; on verify failure
  // NAK + park the recv for the retransmission, which lands in place
  // again. Ownership: `r` was popped from recvs_/parked_ by the
  // caller; every exit either re-parks it or completes + releases it.
  bool land_sealed_inplace(const FrameHdr &h, bool desc, PostedRecv r) {
    fault_landing_delay();
    FrameHdr ack{};
    ack.op = OP_SEND_ACK;
    ack.seq = h.seq;
    if (!eng_->landing_begin(r.mr)) {
      // Target revoked between post and landing: consume the frame,
      // fail the recv — the unsealed land paths' error shape (no
      // retransmit; retrying cannot un-revoke an MR).
      if (!desc && !drain(h.len)) {
        release_recv(r);
        return false;
      }
      SealTrailer t{};
      if (!rd(&t, sizeof(t))) {
        release_recv(r);
        return false;
      }
      {
        std::lock_guard<std::mutex> g(mu_);
        retx_attempts_.erase(h.seq);
      }
      bool sent = send_frame(ack, nullptr, 0);
      complete_recv(r,
                    {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, h.len},
                    h.coll);
      release_recv(r);
      return sent;
    }
    bool moved = true;
    bool conn_ok = true;
    bool verified = false;
    {
      // The inflight ref is held across the landing write AND the
      // verification read of r.dst.
      DmaGuard guard{r.mr};
      (void)guard;
      tel(TDR_TEL_LAND, h.seq, h.len, h.coll);
      if (desc) {
        moved = h.len == 0 ||
                par_cma_copy_from(peer_pid_, r.dst, h.aux, h.len);
      } else if (h.len && !rd(r.dst, h.len)) {
        conn_ok = false;
      }
      if (conn_ok) {
        if (!moved) {
          SealTrailer t{};  // raw: no verify accounting for CMA errors
          if (!rd(&t, sizeof(t))) conn_ok = false;
        } else if (!read_and_verify_trailer(h, r.dst, h.len, &verified)) {
          conn_ok = false;
        }
      }
    }
    if (!conn_ok) {
      release_recv(r);
      return false;
    }
    if (!moved || verified) {
      {
        std::lock_guard<std::mutex> g(mu_);
        retx_attempts_.erase(h.seq);
      }
      ack.status = moved ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
      bool sent = send_frame(ack, nullptr, 0);
      complete_recv(r,
                    {r.wr_id,
                     moved ? TDR_WC_SUCCESS : TDR_WC_LOC_ACCESS_ERR,
                     TDR_OP_RECV, h.len},
                    h.coll);
      release_recv(r);
      return sent;
    }
    int att;
    {
      std::lock_guard<std::mutex> g(mu_);
      att = ++retx_attempts_[h.seq];
      if (att <= seal_budget_) parked_[h.seq] = r;  // keep the recv ref
      else retx_attempts_.erase(h.seq);
    }
    if (att <= seal_budget_) {
      tel(TDR_TEL_NAK, h.seq, static_cast<uint64_t>(att), h.coll);
      FrameHdr nak{};
      nak.op = OP_NAK;
      nak.seq = h.seq;
      return send_frame(nak, nullptr, 0);
    }
    ack.status = TDR_WC_INTEGRITY_ERR;
    bool sent = send_frame(ack, nullptr, 0);
    complete_recv(r,
                  {r.wr_id, TDR_WC_INTEGRITY_ERR, TDR_OP_RECV, h.len},
                  h.coll);
    release_recv(r);
    return sent;
  }

  // Sealed SEND-class arrival (plain or foldback, stream or desc,
  // fresh or retransmitted). Reduce and foldback payloads materialize
  // into a staging buffer first — the seal must be verified before
  // any byte is folded into an accumulator (the desc tier's one-pass
  // fused kernels are traded for stage→verify→fold under seal); plain
  // matched recvs take the in-place fast path above instead. Then:
  //   verified    → land into the parked/FIFO recv, or buffer it;
  //   corrupt     → NAK the chunk seq back to the sender (bounded
  //                 per-chunk budget). A matched recv PARKS (keyed by
  //                 seq) so later messages keep pairing with later
  //                 recvs; an unmatched corrupt message leaves an
  //                 awaiting_retx placeholder holding its FIFO slot.
  //   budget out  → the recv completes TDR_WC_INTEGRITY_ERR and the
  //                 ack carries the same status to the sender.
  bool handle_sealed_inbound(const FrameHdr &h, bool desc, bool fb) {
    const bool retx = h.status == 1;
    if (h.len > kMaxUnexpectedBytes) return false;

    // Fast path: a PLAIN (non-reduce) recv is already posted (or
    // parked awaiting this retransmission) and large enough — land
    // directly into its buffer and verify IN PLACE, like writes: no
    // staging allocation or extra copy on the sealed hot path. A
    // verify failure leaves the recv parked with undefined contents
    // (the WR has not completed) until a clean retransmission
    // overwrites them. Reduce recvs never take this path — a fold is
    // destructive, so they must stage→verify→fold.
    if (!fb) {
      PostedRecv r{};
      bool claim = false;
      {
        std::lock_guard<std::mutex> g(mu_);
        if (retx) {
          auto it = parked_.find(h.seq);
          if (it != parked_.end() && !it->second.is_reduce &&
              h.len <= it->second.maxlen) {
            r = it->second;
            parked_.erase(it);
            claim = true;
          }
        } else if (unexpected_.empty() && !recvs_.empty() &&
                   !recvs_.front().is_reduce &&
                   h.len <= recvs_.front().maxlen) {
          r = recvs_.front();
          recvs_.pop_front();
          claim = true;
        }
      }
      if (claim) return land_sealed_inplace(h, desc, r);
    }

    std::vector<char> buf(h.len);
    bool moved;
    if (desc) {
      moved = h.len == 0 ||
              par_cma_copy_from(peer_pid_, buf.data(), h.aux, h.len);
    } else {
      if (h.len && !rd(buf.data(), h.len)) return false;
      moved = true;
    }
    bool verified = false;
    if (!moved) {
      // CMA failure, not corruption: consume the trailer RAW —
      // verification accounting and land-site corruption injection
      // must not run against a payload that never materialized, or
      // integrity.failed / clause hit counters would report a
      // corruption that never happened.
      SealTrailer t{};
      if (!rd(&t, sizeof(t))) return false;
    } else if (!read_and_verify_trailer(h, buf.data(), h.len, &verified)) {
      return false;
    }

    FrameHdr ack{};
    ack.op = fb ? OP_SEND_FB_ACK : OP_SEND_ACK;
    ack.seq = h.seq;

    if (!moved) {
      // No retransmit can fix a CMA failure — the unsealed desc
      // path's error shape.
      PostedRecv r{};
      bool have = false;
      {
        std::lock_guard<std::mutex> g(mu_);
        auto it = parked_.find(h.seq);
        if (retx && it != parked_.end()) {
          r = it->second;
          have = true;
          parked_.erase(it);
        } else if (!retx && !recvs_.empty()) {
          r = recvs_.front();
          recvs_.pop_front();
          have = true;
        }
        // An awaiting placeholder for this seq is dead: the sender
        // completes with the error ack below and will never
        // retransmit — leaving it would park the next posted recv
        // forever and wedge every later completion behind its ticket.
        for (auto uit = unexpected_.begin(); uit != unexpected_.end();
             ++uit)
          if (uit->awaiting_retx && uit->seq == h.seq) {
            unexpected_.erase(uit);
            break;
          }
        retx_attempts_.erase(h.seq);
      }
      ack.status = TDR_WC_GENERAL_ERR;
      bool sent = send_frame(ack, nullptr, 0);
      if (have) {
        complete_recv(r,
                      {r.wr_id, TDR_WC_LOC_ACCESS_ERR, TDR_OP_RECV, h.len});
        release_recv(r);
      }
      return sent;
    }

    // Route under ONE lock with the recv FIFO so a recv posted while
    // the payload was in flight either matched here or sees the
    // buffered/placeholder entry — never both stranded.
    PostedRecv r{};
    bool have = false, was_parked = false, send_nak = false,
         give_up = false, ack_now = false;
    int att = 0;
    {
      std::lock_guard<std::mutex> g(mu_);
      Unexpected *ph = nullptr;
      if (retx) {
        auto it = parked_.find(h.seq);
        if (it != parked_.end()) {
          r = it->second;
          have = true;
          was_parked = true;
        } else {
          for (auto &u : unexpected_)
            if (u.awaiting_retx && u.seq == h.seq) {
              ph = &u;
              break;
            }
          if (!ph) return true;  // already given up / flushed: drop
        }
      } else if (!recvs_.empty()) {
        r = recvs_.front();
        recvs_.pop_front();
        have = true;
      }

      if (verified) {
        retx_attempts_.erase(h.seq);
        if (was_parked) parked_.erase(h.seq);
        if (!have) {
          if (ph) {
            ph->payload = std::move(buf);
            ph->len = h.len;
            ph->fb = fb;
            ph->coll = h.coll;
            ph->awaiting_retx = false;
          } else {
            Unexpected u;
            u.fb = fb;
            u.seq = h.seq;
            u.len = h.len;
            u.coll = h.coll;
            u.payload = std::move(buf);
            unexpected_.push_back(std::move(u));
          }
          // Plain sends ack at materialization (the sender's buffer
          // is only promised stable until its completion); foldback
          // acks MUST wait for the fold.
          ack_now = !fb;
        }
      } else {
        att = ++retx_attempts_[h.seq];
        if (att <= seal_budget_) {
          send_nak = true;
          if (have && !was_parked) parked_[h.seq] = r;
          if (!have && !ph) {
            Unexpected u;
            u.fb = fb;
            u.seq = h.seq;
            u.len = h.len;
            u.coll = h.coll;
            u.awaiting_retx = true;
            unexpected_.push_back(std::move(u));
          }
        } else {
          give_up = true;
          retx_attempts_.erase(h.seq);
          if (was_parked) parked_.erase(h.seq);
          if (ph) {
            for (auto it = unexpected_.begin(); it != unexpected_.end();
                 ++it)
              if (it->awaiting_retx && it->seq == h.seq) {
                unexpected_.erase(it);
                break;
              }
          }
        }
      }
    }

    if (verified && have) {
      if (fb) {
        Unexpected u;
        u.fb = true;
        u.seq = h.seq;
        u.len = h.len;
        u.coll = h.coll;
        u.payload = std::move(buf);
        bool sent = finish_foldback_sealed(r, u);
        release_recv(r);
        return sent;
      }
      tdr_wc wc = deliver_buffer_wc(r, buf.data(), h.len);
      ack.status = TDR_WC_SUCCESS;
      bool sent = send_frame(ack, nullptr, 0);
      complete_recv(r, wc, h.coll);
      release_recv(r);
      return sent;
    }
    if (ack_now) {
      ack.status = TDR_WC_SUCCESS;
      return send_frame(ack, nullptr, 0);
    }
    if (send_nak) {
      tel(TDR_TEL_NAK, h.seq, static_cast<uint64_t>(att), h.coll);
      FrameHdr nak{};
      nak.op = OP_NAK;
      nak.seq = h.seq;
      return send_frame(nak, nullptr, 0);
    }
    if (give_up) {
      ack.status = TDR_WC_INTEGRITY_ERR;
      bool sent = send_frame(ack, nullptr, 0);
      if (have) {
        complete_recv(r,
                      {r.wr_id, TDR_WC_INTEGRITY_ERR, TDR_OP_RECV, h.len},
                      h.coll);
        release_recv(r);
      }
      return sent;
    }
    return true;  // verified foldback buffered: ack comes at fold time
  }

  // Sealed OP_WRITE / OP_WRITE_DESC: land in place, verify, ack — or
  // NAK for a bounded retransmit. Landing before verifying is safe
  // for writes (nothing is folded): the WR has not completed, its
  // target's contents are undefined until it does, and a clean
  // retransmission overwrites the rejected bytes.
  bool handle_sealed_write(const FrameHdr &h, bool desc) {
    EmuMr *tmr = nullptr;
    char *dst = eng_->resolve(h.rkey, h.raddr, h.len,
                              TDR_ACCESS_REMOTE_WRITE, &tmr);
    FrameHdr ack{};
    ack.op = OP_WRITE_ACK;
    ack.seq = h.seq;
    if (!dst) {
      if (!desc && !drain(h.len)) return false;
      SealTrailer t{};
      if (!rd(&t, sizeof(t))) return false;
      ack.status = TDR_WC_REM_ACCESS_ERR;
      return send_frame(ack, nullptr, 0);
    }
    bool moved;
    tel(TDR_TEL_LAND, h.seq, h.len, h.coll);
    if (desc) {
      moved = par_cma_copy_from(peer_pid_, dst, h.aux, h.len);
    } else {
      if (!rd(dst, h.len)) {
        EmuEngine::dma_done(tmr);
        return false;
      }
      moved = true;
    }
    if (!moved) {
      EmuEngine::dma_done(tmr);
      SealTrailer t{};
      if (!rd(&t, sizeof(t))) return false;
      ack.status = TDR_WC_GENERAL_ERR;
      return send_frame(ack, nullptr, 0);
    }
    // Verification reads the landed region, so the inflight ref is
    // held across it — the owner cannot reclaim the pages mid-check.
    bool verified = false;
    bool alive = read_and_verify_trailer(h, dst, h.len, &verified);
    EmuEngine::dma_done(tmr);
    if (!alive) return false;
    if (verified) {
      std::lock_guard<std::mutex> g(mu_);
      retx_attempts_.erase(h.seq);
      ack.status = TDR_WC_SUCCESS;
    } else {
      int att;
      {
        std::lock_guard<std::mutex> g(mu_);
        att = ++retx_attempts_[h.seq];
      }
      if (att <= seal_budget_) {
        tel(TDR_TEL_NAK, h.seq, static_cast<uint64_t>(att), h.coll);
        FrameHdr nak{};
        nak.op = OP_NAK;
        nak.seq = h.seq;
        return send_frame(nak, nullptr, 0);
      }
      {
        std::lock_guard<std::mutex> g(mu_);
        retx_attempts_.erase(h.seq);
      }
      ack.status = TDR_WC_INTEGRITY_ERR;
    }
    return send_frame(ack, nullptr, 0);
  }

  // Verify a tag-only trailer (CMA tier default): CRC over the tag +
  // steering fields, the cseq echo, and the incarnation fence — no
  // payload bytes needed, so this runs BEFORE any data movement or
  // recv consumption. Returns false on connection loss.
  bool read_and_verify_tag(const FrameHdr &h, bool *ok_out) {
    SealTrailer t{};
    if (!rd(&t, sizeof(t))) return false;
    bool ok = seal_crc(t, h, nullptr, 0) == t.crc &&
              t.cseq == static_cast<uint32_t>(h.seq);
    uint64_t local = eng_->seal_gen();
    if (ok && t.gen != 0 && local != 0 &&
        t.gen != static_cast<uint32_t>(local))
      ok = false;
    seal_count(ok ? kSealVerified : kSealFailed);
    tel(ok ? TDR_TEL_VERIFY_OK : TDR_TEL_VERIFY_FAIL, h.seq, h.len, h.coll);
    *ok_out = ok;
    return true;
  }

  // Tag-only sealed SEND-class arrival (CMA tier): verify the trailer
  // FIRST — it needs no payload bytes — then run the clean frame down
  // the UNSEALED one-pass data path (fused folds straight off peer
  // memory, in-place landings, bare acks): verify-before-fold holds
  // with zero staging. A failed tag NAKs for a bounded retransmit
  // without consuming a recv; FIFO pairing across the failure uses
  // the same parked-recv / placeholder machinery as full sealing (a
  // later clean message must not steal the failed frame's recv).
  bool handle_tagonly_inbound(const FrameHdr &h, bool fb) {
    if (h.len > kMaxUnexpectedBytes) return false;
    const bool retx = h.status == 1;
    bool verified = false;
    if (!read_and_verify_tag(h, &verified)) return false;

    if (verified) {
      PostedRecv r{};
      bool have_parked = false, placeholder = false;
      {
        std::lock_guard<std::mutex> g(mu_);
        retx_attempts_.erase(h.seq);
        if (retx) {
          auto it = parked_.find(h.seq);
          if (it != parked_.end()) {
            r = it->second;
            parked_.erase(it);
            have_parked = true;
          } else {
            for (auto &u : unexpected_)
              if (u.awaiting_retx && u.seq == h.seq) {
                placeholder = true;
                break;
              }
            if (!placeholder) return true;  // given up / flushed: drop
          }
        }
      }
      if (have_parked) {
        // Deliver into the recv parked for this seq (its FIFO claim).
        if (fb) {
          Unexpected u;
          u.fb = true;
          u.desc = true;
          u.seq = h.seq;
          u.src_va = h.aux;
          u.len = h.len;
          bool sent = finish_foldback(r, u);
          release_recv(r);
          return sent;
        }
        FrameHdr ack{};
        ack.op = OP_SEND_ACK;
        ack.seq = h.seq;
        tdr_wc wc;
        bool moved = land_cma_wc(r, h.aux, h.len, &wc);
        ack.status = moved ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
        bool sent = send_frame(ack, nullptr, 0);
        complete_recv(r, wc, h.coll);
        release_recv(r);
        return sent;
      }
      if (placeholder) {
        // Placeholder held the failed frame's FIFO slot: materialize
        // the clean payload into it now. The poll thread may convert
        // a front placeholder into a parked_ recv at any moment
        // (queue_recv pop_front()s it, invalidating deque pointers),
        // so the placeholder is re-resolved BY SEQ under one lock —
        // never through a pointer cached across an unlock.
        if (fb) {
          PostedRecv pr{};
          {
            std::lock_guard<std::mutex> g(mu_);
            Unexpected *u = nullptr;
            for (auto &cand : unexpected_)
              if (cand.awaiting_retx && cand.seq == h.seq) {
                u = &cand;
                break;
              }
            if (u) {
              // Foldback acks at fold time: the placeholder just
              // becomes a normal pending foldback.
              u->fb = true;
              u->desc = true;
              u->src_va = h.aux;
              u->len = h.len;
              u->coll = h.coll;
              u->awaiting_retx = false;
              return true;
            }
            auto it = parked_.find(h.seq);
            if (it == parked_.end()) return true;  // flushed: drop
            pr = it->second;
            parked_.erase(it);
          }
          Unexpected u;
          u.fb = true;
          u.desc = true;
          u.seq = h.seq;
          u.src_va = h.aux;
          u.len = h.len;
          u.coll = h.coll;
          bool sent = finish_foldback(pr, u);
          release_recv(pr);
          return sent;
        }
        // Plain send: the copy needs only the frame descriptor, so it
        // runs unlocked; the destination (placeholder, or the recv it
        // was parked into meanwhile) is resolved after, in one scope.
        std::vector<char> buf(h.len);
        bool moved = h.len == 0 ||
                     par_cma_copy_from(peer_pid_, buf.data(), h.aux, h.len);
        FrameHdr ack{};
        ack.op = OP_SEND_ACK;
        ack.seq = h.seq;
        ack.status = moved ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
        PostedRecv pr{};
        bool now_parked = false, resolved = false;
        {
          std::lock_guard<std::mutex> g(mu_);
          for (auto it = unexpected_.begin(); it != unexpected_.end();
               ++it)
            if (it->awaiting_retx && it->seq == h.seq) {
              if (moved) {
                it->payload = std::move(buf);
                it->len = h.len;
                it->fb = false;
                it->coll = h.coll;
                it->awaiting_retx = false;
              } else {
                // CMA failure: the placeholder is dead (sender
                // completes with the error ack, no retransmit).
                unexpected_.erase(it);
              }
              resolved = true;
              break;
            }
          if (!resolved) {
            auto it = parked_.find(h.seq);
            if (it != parked_.end()) {
              pr = it->second;
              parked_.erase(it);
              now_parked = true;
            }
          }
        }
        if (now_parked) {
          if (moved) {
            complete_recv(pr, deliver_buffer_wc(pr, buf.data(),
                                                buf.size()),
                          h.coll);
          } else {
            complete_recv(pr,
                          {pr.wr_id, TDR_WC_GENERAL_ERR, TDR_OP_RECV,
                           h.len},
                          h.coll);
          }
          release_recv(pr);
        } else if (!resolved) {
          return true;  // flushed while copying: drop, no ack
        }
        return send_frame(ack, nullptr, 0);
      }
      // Fresh clean frame: exactly the unsealed data path.
      return fb ? handle_foldback_inbound(h, /*desc=*/true)
                : handle_send_inbound(h, /*desc=*/true);
    }

    // Tag corrupt or stale incarnation: NAK within the budget. The
    // frame consumed nothing, but its recv claim must survive the
    // retry — park the FIFO-front recv (fresh failure) or leave the
    // placeholder standing (repeat failure).
    FrameHdr ack{};
    ack.op = fb ? OP_SEND_FB_ACK : OP_SEND_ACK;
    ack.seq = h.seq;
    PostedRecv r{};
    bool have = false, was_parked = false, send_nak = false;
    int att = 0;
    {
      std::lock_guard<std::mutex> g(mu_);
      Unexpected *ph = nullptr;
      if (retx) {
        auto it = parked_.find(h.seq);
        if (it != parked_.end()) {
          r = it->second;
          have = true;
          was_parked = true;
        } else {
          for (auto &u : unexpected_)
            if (u.awaiting_retx && u.seq == h.seq) {
              ph = &u;
              break;
            }
          if (!ph) return true;  // already given up: drop
        }
      } else if (!recvs_.empty()) {
        r = recvs_.front();
        recvs_.pop_front();
        have = true;
      }
      att = ++retx_attempts_[h.seq];
      if (att <= seal_budget_) {
        send_nak = true;
        if (have && !was_parked) parked_[h.seq] = r;
        if (!have && !ph) {
          Unexpected u;
          u.fb = fb;
          u.desc = true;
          u.seq = h.seq;
          u.src_va = h.aux;
          u.len = h.len;
          u.coll = h.coll;
          u.awaiting_retx = true;
          unexpected_.push_back(std::move(u));
        }
      } else {
        retx_attempts_.erase(h.seq);
        if (was_parked) parked_.erase(h.seq);
        if (ph) {
          for (auto it = unexpected_.begin(); it != unexpected_.end(); ++it)
            if (it->awaiting_retx && it->seq == h.seq) {
              unexpected_.erase(it);
              break;
            }
        }
      }
    }
    if (send_nak) {
      tel(TDR_TEL_NAK, h.seq, static_cast<uint64_t>(att), h.coll);
      FrameHdr nak{};
      nak.op = OP_NAK;
      nak.seq = h.seq;
      return send_frame(nak, nullptr, 0);
    }
    ack.status = TDR_WC_INTEGRITY_ERR;
    bool sent = send_frame(ack, nullptr, 0);
    if (have) {
      complete_recv(r,
                    {r.wr_id, TDR_WC_INTEGRITY_ERR, TDR_OP_RECV, h.len},
                    h.coll);
      release_recv(r);
    }
    return sent;
  }

  // Tag-only sealed WRITE (CMA tier): verify the trailer, then the
  // unsealed desc-write body. No recv FIFO involved — a failed tag
  // just NAKs for retransmit from the pending source.
  bool handle_tagonly_write(const FrameHdr &h) {
    bool verified = false;
    if (!read_and_verify_tag(h, &verified)) return false;
    if (!verified) {
      int att;
      {
        std::lock_guard<std::mutex> g(mu_);
        att = ++retx_attempts_[h.seq];
        if (att > seal_budget_) retx_attempts_.erase(h.seq);
      }
      if (att <= seal_budget_) {
        tel(TDR_TEL_NAK, h.seq, static_cast<uint64_t>(att), h.coll);
        FrameHdr nak{};
        nak.op = OP_NAK;
        nak.seq = h.seq;
        return send_frame(nak, nullptr, 0);
      }
      FrameHdr ack{};
      ack.op = OP_WRITE_ACK;
      ack.seq = h.seq;
      ack.status = TDR_WC_INTEGRITY_ERR;
      return send_frame(ack, nullptr, 0);
    }
    {
      std::lock_guard<std::mutex> g(mu_);
      retx_attempts_.erase(h.seq);
    }
    EmuMr *tmr = nullptr;
    char *dst = eng_->resolve(h.rkey, h.raddr, h.len,
                              TDR_ACCESS_REMOTE_WRITE, &tmr);
    FrameHdr ack{};
    ack.op = OP_WRITE_ACK;
    ack.seq = h.seq;
    if (dst) {
      tel(TDR_TEL_LAND, h.seq, h.len, h.coll);
      bool ok = par_cma_copy_from(peer_pid_, dst, h.aux, h.len);
      EmuEngine::dma_done(tmr);
      ack.status = ok ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
    } else {
      ack.status = TDR_WC_REM_ACCESS_ERR;
    }
    return send_frame(ack, nullptr, 0);
  }

  // ---- Netem receiver gate -----------------------------------------
  // Fresh request frames carry the sender's monotone seq; TCP delivers
  // transmission order, which the reorder/dup riders deliberately
  // perturb. The gate restores POST order: early frames are staged
  // (whole wire bytes) and replayed through the pushback buffer once
  // the gap fills; frames below the watermark are rider duplicates and
  // drop here. Handlers never see either case, so every landing,
  // seal-verify, and recv-match path runs on in-order traffic — the
  // bitwise-parity-under-chaos guarantee. Zero-cost on healthy wires:
  // frames arrive exactly at the watermark and fall straight through.

  // Progress-thread read: drain the pushback buffer (replayed staged
  // frames) before the socket.
  bool rd(void *p, size_t n) {
    if (!rdbuf_.empty()) {
      size_t take = rdbuf_.size() < n ? rdbuf_.size() : n;
      memcpy(p, rdbuf_.data(), take);
      rdbuf_.erase(0, take);
      if (take == n) return true;
      return read_full(fd_, static_cast<char *>(p) + take, n - take);
    }
    return read_full(fd_, p, n);
  }

  static bool gate_is_request(uint8_t op) {
    switch (op) {
      case OP_WRITE:
      case OP_WRITE_DESC:
      case OP_SEND:
      case OP_SEND_DESC:
      case OP_SEND_FB:
      case OP_SEND_FB_DESC:
      case OP_READ_REQ:
      case OP_READ_REQ_DESC:
        return true;
      default:
        return false;
    }
  }

  // Wire bytes that FOLLOW a request frame's header.
  uint64_t request_body_len(const FrameHdr &h) const {
    uint64_t n = 0;
    if (h.op == OP_WRITE || h.op == OP_SEND || h.op == OP_SEND_FB)
      n = h.len;
    if (seal_ && h.op != OP_READ_REQ && h.op != OP_READ_REQ_DESC)
      n += sizeof(SealTrailer);
    return n;
  }

  // Stage an early frame: header + body, verbatim, keyed by seq.
  bool stage_frame(const FrameHdr &h) {
    uint64_t body = request_body_len(h);
    // A runaway gap is a protocol error, not a rider (the rider holds
    // at most one frame): bound the staging memory.
    if (staged_.size() >= 64 || body > (64ull << 20)) return false;
    size_t hb = coll_wire_ ? sizeof(FrameHdr) : kFrameHdrWireBase;
    std::string f;
    f.reserve(hb + static_cast<size_t>(body));
    f.append(reinterpret_cast<const char *>(&h), hb);
    size_t off = f.size();
    f.resize(off + static_cast<size_t>(body));
    if (body && !rd(&f[off], static_cast<size_t>(body))) return false;
    staged_.emplace(h.seq, std::move(f));
    return true;
  }

  // Drain len payload bytes we cannot place (bad rkey etc.).
  bool drain(uint64_t len) {
    char scratch[65536];
    while (len > 0) {
      size_t chunk = len < sizeof(scratch) ? len : sizeof(scratch);
      if (!rd(scratch, chunk)) return false;
      len -= chunk;
    }
    return true;
  }

  void progress_loop() {
    FrameHdr h;
    for (;;) {
      // Replay a staged frame whose turn has come: its verbatim wire
      // bytes re-enter through the pushback buffer, so it flows
      // through the normal read-dispatch path below.
      if (!staged_.empty()) {
        auto it = staged_.find(gate_expect_);
        if (it != staged_.end()) {
          rdbuf_.insert(0, it->second);
          staged_.erase(it);
        }
      }
      if (!rd(&h, kFrameHdrWireBase)) break;
      // FEAT_COLL_ID extension: the trace-id word follows the base
      // header on every frame of this connection (length agreed at
      // handshake — never guessed per frame).
      if (coll_wire_) {
        if (!rd(&h.coll, sizeof(h.coll))) break;
      } else {
        h.coll = 0;
      }
      // Netem receiver gate: fresh requests re-enter sender post
      // order; duplicates drop. Retransmissions (status != 0) bypass —
      // their seq sits below the watermark by design.
      if (gate_is_request(h.op) && h.status == 0) {
        if (h.seq < gate_expect_) {
          if (!drain(request_body_len(h))) break;  // rider duplicate
          continue;
        }
        if (h.seq > gate_expect_) {
          if (!stage_frame(h)) break;  // early: wait for the gap
          continue;
        }
        gate_expect_++;
      }
      if (tel_on()) {
        switch (h.op) {
          case OP_WRITE:
          case OP_WRITE_DESC:
          case OP_SEND:
          case OP_SEND_DESC:
          case OP_SEND_FB:
          case OP_SEND_FB_DESC:
          case OP_READ_RESP:
            tel_emit(TDR_TEL_WIRE_RX, eng_->tel_id, tel_id, h.seq, h.len,
                     h.coll);
            break;
          case OP_SEND_FB_ACK:
            // Stream-tier foldback acks carry the folded result as
            // payload; CMA acks are bare (len 0) because the result
            // was written back before acking — only count the former.
            if (h.len)
              tel_emit(TDR_TEL_WIRE_RX, eng_->tel_id, tel_id, h.seq, h.len,
                       h.coll);
            break;
          default:
            break;
        }
      }
      switch (h.op) {
        case OP_WRITE: {
          if (seal_) {
            if (!handle_sealed_write(h, /*desc=*/false)) goto out;
            break;
          }
          EmuMr *tmr = nullptr;
          char *dst = eng_->resolve(h.rkey, h.raddr, h.len,
                                    TDR_ACCESS_REMOTE_WRITE, &tmr);
          FrameHdr ack{};
          ack.op = OP_WRITE_ACK;
          ack.seq = h.seq;
          if (dst) {
            bool ok = rd(dst, h.len);
            EmuEngine::dma_done(tmr);
            if (!ok) goto out;
            ack.status = TDR_WC_SUCCESS;
          } else {
            if (!drain(h.len)) goto out;
            ack.status = TDR_WC_REM_ACCESS_ERR;
          }
          if (!send_frame(ack, nullptr, 0)) goto out;
          break;
        }
        case OP_READ_REQ: {
          EmuMr *tmr = nullptr;
          char *src = eng_->resolve(h.rkey, h.raddr, h.len,
                                    TDR_ACCESS_REMOTE_READ, &tmr);
          FrameHdr resp{};
          resp.op = OP_READ_RESP;
          resp.seq = h.seq;
          resp.coll = h.coll;  // echo: the requester's landing joins
                               // its own collective
          if (src) {
            resp.status = TDR_WC_SUCCESS;
            resp.len = h.len;
            bool ok = send_frame(resp, src, h.len);
            EmuEngine::dma_done(tmr);
            if (!ok) goto out;
          } else {
            resp.status = TDR_WC_REM_ACCESS_ERR;
            resp.len = 0;
            if (!send_frame(resp, nullptr, 0)) goto out;
          }
          break;
        }
        case OP_SEND: {
          if (seal_) {
            if (!handle_sealed_inbound(h, /*desc=*/false, /*fb=*/false))
              goto out;
            break;
          }
          if (!handle_send_inbound(h, /*desc=*/false)) goto out;
          break;
        }
        case OP_WRITE_DESC: {
          // Desc ops are only valid after both sides negotiated the
          // CMA tier; peer_pid_ is meaningless otherwise.
          if (!cma_) goto out;
          if (seal_) {
            if (seal_payload_) {
              if (!handle_sealed_write(h, /*desc=*/true)) goto out;
            } else {
              if (!handle_tagonly_write(h)) goto out;
            }
            break;
          }
          EmuMr *tmr = nullptr;
          char *dst = eng_->resolve(h.rkey, h.raddr, h.len,
                                    TDR_ACCESS_REMOTE_WRITE, &tmr);
          FrameHdr ack{};
          ack.op = OP_WRITE_ACK;
          ack.seq = h.seq;
          if (dst) {
            bool ok = par_cma_copy_from(peer_pid_, dst, h.aux, h.len);
            EmuEngine::dma_done(tmr);
            ack.status = ok ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
          } else {
            ack.status = TDR_WC_REM_ACCESS_ERR;
          }
          if (!send_frame(ack, nullptr, 0)) goto out;
          break;
        }
        case OP_READ_REQ_DESC: {
          if (!cma_) goto out;
          EmuMr *tmr = nullptr;
          char *src = eng_->resolve(h.rkey, h.raddr, h.len,
                                    TDR_ACCESS_REMOTE_READ, &tmr);
          FrameHdr resp{};
          resp.op = OP_READ_RESP;
          resp.seq = h.seq;
          resp.coll = h.coll;
          resp.len = 0;  // bytes move via CMA, none follow on the wire
          if (src) {
            // Push into the requester's destination: safe because its
            // pending op holds an active inflight ref on that MR from
            // post to completion, so its revocation quiesces across
            // this write; our source is bracketed by resolve/dma_done.
            bool ok = par_cma_copy_to(peer_pid_, h.aux, src, h.len);
            EmuEngine::dma_done(tmr);
            resp.status = ok ? TDR_WC_SUCCESS : TDR_WC_GENERAL_ERR;
          } else {
            resp.status = TDR_WC_REM_ACCESS_ERR;
          }
          if (!send_frame(resp, nullptr, 0)) goto out;
          break;
        }
        case OP_SEND_DESC: {
          if (!cma_) goto out;
          if (seal_) {
            if (seal_payload_) {
              if (!handle_sealed_inbound(h, /*desc=*/true, /*fb=*/false))
                goto out;
            } else {
              if (!handle_tagonly_inbound(h, /*fb=*/false)) goto out;
            }
            break;
          }
          if (!handle_send_inbound(h, /*desc=*/true)) goto out;
          break;
        }
        case OP_SEND_FB: {
          if (seal_) {
            if (!handle_sealed_inbound(h, /*desc=*/false, /*fb=*/true))
              goto out;
            break;
          }
          if (!handle_foldback_inbound(h, /*desc=*/false)) goto out;
          break;
        }
        case OP_SEND_FB_DESC: {
          if (!cma_) goto out;
          if (seal_) {
            if (seal_payload_) {
              if (!handle_sealed_inbound(h, /*desc=*/true, /*fb=*/true))
                goto out;
            } else {
              if (!handle_tagonly_inbound(h, /*fb=*/true)) goto out;
            }
            break;
          }
          if (!handle_foldback_inbound(h, /*desc=*/true)) goto out;
          break;
        }
        case OP_NAK: {
          // Peer's land-time verification failed for frame `seq`:
          // re-post it from the still-live source (the pending op's
          // inflight MR ref holds revocation off until the final
          // ack). Retransmissions re-run the send-site fault walk, so
          // an always-corrupt clause keeps corrupting them — that is
          // how the budget boundary is tested deterministically.
          PendingOp p{};
          bool have = false;
          {
            std::lock_guard<std::mutex> g(mu_);
            auto it = pending_.find(h.seq);
            if (it != pending_.end() && it->second.src) {
              p = it->second;
              have = true;
            }
          }
          if (have) {
            uint32_t attempt = 0;
            {
              std::lock_guard<std::mutex> g(mu_);
              auto it = pending_.find(h.seq);
              if (it != pending_.end()) attempt = ++it->second.naks;
            }
            // Adaptive retransmit backoff: the first NAK re-posts
            // immediately (one bit flip heals at full speed); repeat
            // NAKs back off exponentially (100us doubling to 6.4ms)
            // with deterministic seeded jitter, so a corrupt storm
            // cannot melt into a NAK/retx busy loop yet replays
            // identically run-to-run (TDR_REBUILD_SEED convention).
            if (attempt > 1) {
              uint64_t base = 100ull << std::min(attempt - 2, 6u);
              uint64_t j = mix64(nak_seed_ ^
                                 (h.seq * 0x9e3779b97f4a7c15ull) ^ attempt) %
                           (base / 2 + 1);
              std::this_thread::sleep_for(
                  std::chrono::microseconds(base + j));
            }
            seal_count(kSealRetx);
            tel(TDR_TEL_RETX, h.seq, p.len, p.coll);
            FrameHdr rh{};
            rh.op = p.wire_op;
            rh.status = 1;  // retransmission marker
            rh.seq = h.seq;
            rh.rkey = p.rkey;
            rh.raddr = p.raddr;
            rh.len = p.len;
            rh.aux = reinterpret_cast<uint64_t>(p.src);
            // Retransmissions keep the ORIGINAL collective id — the
            // pending op recorded it at post time, so the healed
            // frame's landing events still join the first attempt's.
            rh.coll = p.coll;
            bool desc = p.wire_op == OP_WRITE_DESC ||
                        p.wire_op == OP_SEND_DESC ||
                        p.wire_op == OP_SEND_FB_DESC;
            if (!send_frame_sealed(rh, p.src, p.len, desc, p.wr_id))
              goto out;
          }
          break;
        }
        case OP_SEND_FB_ACK: {
          // Land the folded result over the pending send's source
          // region (the in-place final): the stream tier carries it
          // as the ack payload, landed here under MR re-validation;
          // in the CMA tier the receiver already wrote it before
          // acking (guarded by this op's held inflight ref), so the
          // ack is bare and only completes the pending.
          char *dst = nullptr;
          uint64_t want = 0;
          EmuMr *pmr = nullptr;
          {
            std::lock_guard<std::mutex> g(mu_);
            auto it = pending_.find(h.seq);
            if (it != pending_.end()) {
              dst = it->second.dst;
              want = it->second.len;
              pmr = it->second.mr;
            }
          }
          uint8_t st = h.status;
          if (h.len) {  // stream tier
            bool can = st == TDR_WC_SUCCESS && dst && h.len == want &&
                       eng_->landing_begin(pmr);
            if (can) {
              bool ok = rd(dst, h.len);
              if (ok && seal_) {
                // The write-back is a landing too: verify the folded
                // bytes before the exchange completes. No retransmit
                // for this direction (the fold already consumed the
                // forward payload) — failure surfaces as an integrity
                // completion and the elastic ladder takes it.
                bool vok = false;
                ok = read_and_verify_trailer(h, dst, h.len, &vok);
                if (ok && !vok) st = TDR_WC_INTEGRITY_ERR;
              }
              EmuEngine::dma_done(pmr);
              if (!ok) goto out;
            } else {
              if (!drain(h.len)) goto out;
              if (seal_) {
                SealTrailer t{};
                if (!rd(&t, sizeof(t))) goto out;
              }
              if (st == TDR_WC_SUCCESS) st = TDR_WC_LOC_ACCESS_ERR;
            }
          }
          complete_pending(h.seq, st, nullptr, 0);
          break;
        }
        case OP_WRITE_ACK:
        case OP_SEND_ACK: {
          complete_pending(h.seq, h.status, nullptr, 0);
          break;
        }
        case OP_READ_RESP: {
          char *dst = nullptr;
          uint64_t want = 0;
          EmuMr *pmr = nullptr;
          {
            std::lock_guard<std::mutex> g(mu_);
            auto it = pending_.find(h.seq);
            if (it != pending_.end()) {
              dst = it->second.dst;
              want = it->second.len;
              pmr = it->second.mr;
            }
          }
          uint8_t st = h.status;
          if (st == TDR_WC_SUCCESS && h.len) {  // stream tier payload
            bool can = dst && h.len == want && eng_->landing_begin(pmr);
            if (can) {
              bool ok = rd(dst, h.len);
              EmuEngine::dma_done(pmr);
              if (!ok) goto out;
            } else {
              if (!drain(h.len)) goto out;
              st = TDR_WC_LOC_ACCESS_ERR;
            }
          }
          complete_pending(h.seq, st, nullptr, 0);
          break;
        }
        case OP_PING: {
          // Hung-peer probe (FEAT_PROBE): reply OP_PONG echoing the
          // token so the prober can tell "alive but slow" from "gone".
          // Zero-byte frames; sealed connections add a tag-only
          // trailer so a corrupted probe is dropped, not trusted.
          if (!(features_ & FEAT_PROBE)) goto out;
          if (seal_) {
            SealTrailer t{};
            if (!rd(&t, sizeof(t))) goto out;
            if (seal_crc(t, h, nullptr, 0) != t.crc) break;
          }
          FrameHdr pong{};
          pong.op = OP_PONG;
          pong.aux = h.aux;
          pong.coll = h.coll;
          if (seal_) {
            SealTrailer t2{};
            t2.cseq = static_cast<uint32_t>(h.aux);
            t2.crc = seal_crc(t2, pong, nullptr, 0);
            if (!send_frame(pong, nullptr, 0, &t2)) goto out;
          } else {
            if (!send_frame(pong, nullptr, 0)) goto out;
          }
          break;
        }
        case OP_PONG: {
          if (seal_) {
            SealTrailer t{};
            if (!rd(&t, sizeof(t))) goto out;
            if (seal_crc(t, h, nullptr, 0) != t.crc) break;
          }
          probe_count(kProbePong);
          {
            std::lock_guard<std::mutex> g(mu_);
            if (h.aux > pong_token_) pong_token_ = h.aux;
          }
          cv_.notify_all();
          break;
        }
        case OP_GOODBYE:
          goto out;
        default:
          goto out;
      }
    }
  out:
    // A frame held back by a reorder rider must not leak its counter
    // reservation when the connection dies with the swap never
    // happening: refund it (swapped=false keeps hits truthful).
    {
      std::lock_guard<std::mutex> g(send_mu_);
      if (!held_.empty()) {
        fault_netem_commit(held_clause_, held_gen_, /*swapped=*/false);
        held_.clear();
        held_clause_ = -1;
        held_dup_ = false;
        held_flag_.store(false, std::memory_order_release);
      }
    }
    // Connection gone: flush every in-flight op and pending recv, the
    // RC flush semantics (TDR_WC_FLUSH_ERR). Recv flushes route
    // through the ticket map so completions withheld behind a parked
    // (retransmit-pending) chunk drain in posted order.
    {
      std::lock_guard<std::mutex> g(mu_);
      dead_ = true;
      for (auto &kv : pending_) {
        cq_.push_back(
            {kv.second.wr_id, TDR_WC_FLUSH_ERR, kv.second.opcode, 0});
        tel_wc(kv.second.wr_id, TDR_WC_FLUSH_ERR, 0, kv.second.post_ns,
               kv.second.coll);
        release_pending_mr(kv.second.mr);
      }
      pending_.clear();
      for (auto &r : recvs_) {
        recv_done_[r.ticket] = {r.wr_id, TDR_WC_FLUSH_ERR, TDR_OP_RECV, 0};
        tel_wc(r.wr_id, TDR_WC_FLUSH_ERR, 0, r.post_ns, r.coll);
        release_recv(r);
      }
      recvs_.clear();
      for (auto &kv : parked_) {
        recv_done_[kv.second.ticket] =
            {kv.second.wr_id, TDR_WC_FLUSH_ERR, TDR_OP_RECV, 0};
        tel_wc(kv.second.wr_id, TDR_WC_FLUSH_ERR, 0, kv.second.post_ns,
               kv.second.coll);
        release_recv(kv.second);
      }
      parked_.clear();
      retx_attempts_.clear();
      drain_recv_done_locked();
      cv_.notify_all();
    }
    eng_->cq_pulse();
  }

  void complete_pending(uint64_t seq, uint8_t status, char *, uint64_t) {
    std::unique_lock<std::mutex> lk(mu_);
    auto it = pending_.find(seq);
    if (it == pending_.end()) return;
    tdr_wc wc{it->second.wr_id, status, it->second.opcode, it->second.len};
    uint64_t post_ns = it->second.post_ns;
    uint64_t coll = it->second.coll;
    cq_.push_back(wc);
    release_pending_mr(it->second.mr);
    pending_.erase(it);
    cv_.notify_all();
    lk.unlock();
    eng_->cq_pulse();
    tel_wc(wc.wr_id, wc.status, wc.len, post_ns, coll);
  }

  EmuEngine *eng_;
  int fd_;
  std::thread progress_;
  std::atomic<bool> closing_{false};

  // CMA tier state and negotiated features, fixed at handshake time.
  bool cma_ = false;
  // TDR_CONN_FORCE_STREAM at bring-up: this side reports its CMA
  // probe as failed, pinning the connection to the stream tier.
  bool force_stream_ = false;
  pid_t peer_pid_ = -1;
  uint64_t probe_val_ = 0;
  uint32_t features_ = 0;
  // Sealed framing (FEAT_SEAL negotiated) and the per-chunk
  // retransmit budget, both fixed at handshake time. seal_payload_:
  // whether the trailer CRC covers the payload bytes (always on the
  // stream tier; CMA tier only under FEAT_SEAL_CMA_FULL — see
  // handshake()).
  bool seal_ = false;
  bool seal_payload_ = false;
  int seal_budget_ = 3;
  // FEAT_COLL_ID negotiated: frame headers carry the collective trace
  // id (fixed at handshake; both ends read/write the extended length).
  bool coll_wire_ = false;

  std::mutex send_mu_;  // serializes frame submission on the socket

  // Netem reorder rider: at most one serialized frame held back under
  // send_mu_ until the next frame passes it (or poll()/close flushes
  // it). held_flag_ is the lock-free fast-path check for poll().
  std::string held_;
  int held_clause_ = -1;
  uint64_t held_gen_ = 0;
  bool held_dup_ = false;
  uint64_t held_at_ns_ = 0;
  std::atomic<bool> held_flag_{false};

  // Netem receiver ordering gate (progress thread only): staged whole
  // wire frames keyed by seq, replayed through the rd() pushback
  // buffer once the watermark catches up. Fresh request frames all
  // draw from the sender's single next_seq_ counter, so one watermark
  // restores posted order across every request class.
  std::string rdbuf_;
  std::map<uint64_t, std::string> staged_;
  uint64_t gate_expect_ = 1;

  // Hung-peer probe tokens (guarded by mu_; pong wakes cv_).
  uint64_t probe_token_ = 0;
  uint64_t pong_token_ = 0;

  // NAK-backoff jitter seed: deterministic per TDR_REBUILD_SEED (the
  // seeded-rng convention) so retransmit storms replay identically.
  const uint64_t nak_seed_ = [] {
    uint64_t s = 0x9e3779b97f4a7c15ull;
    if (const char *env = getenv("TDR_REBUILD_SEED"))
      for (const char *p = env; *p; ++p)
        s = mix64(s ^ static_cast<uint64_t>(static_cast<unsigned char>(*p)));
    return s;
  }();

  std::mutex mu_;  // guards cq_, pending_, recvs_, unexpected_,
                   // parked_, retx_attempts_, and the ticket state
  std::condition_variable cv_;
  std::deque<tdr_wc> cq_;
  std::unordered_map<uint64_t, PendingOp> pending_;
  std::deque<PostedRecv> recvs_;
  std::deque<Unexpected> unexpected_;
  // Sealed-connection retransmit state: recvs parked for a
  // retransmission (keyed by frame seq) and per-seq attempt counts.
  std::unordered_map<uint64_t, PostedRecv> parked_;
  std::unordered_map<uint64_t, int> retx_attempts_;
  // Posted-order recv completion delivery (see complete_recv).
  uint64_t recv_head_ = 0;
  uint64_t recv_tail_ = 0;
  std::map<uint64_t, tdr_wc> recv_done_;
  uint64_t next_seq_ = 1;
  bool dead_ = false;
};

Qp *EmuEngine::listen(const char *bind_host, int port, int timeout_ms,
                      int flags) {
  std::string err;
  int fd = tcp_listen_accept(bind_host, port, &err, timeout_ms);
  if (fd < 0) {
    set_error("listen: " + err);
    return nullptr;
  }
  return new EmuQp(this, fd, flags);
}

Qp *EmuEngine::connect(const char *host, int port, int timeout_ms,
                       int flags) {
  std::string err;
  int fd = tcp_connect_retry(host, port, timeout_ms, &err);
  if (fd < 0) {
    set_error("connect: " + err);
    return nullptr;
  }
  return new EmuQp(this, fd, flags);
}

}  // namespace

Engine *create_emu_engine(std::string *err) {
  (void)err;
  return new EmuEngine();
}

}  // namespace tdr
