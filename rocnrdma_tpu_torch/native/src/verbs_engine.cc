// Real InfiniBand backend: RC queue pairs over libibverbs, resolved at
// runtime via dlopen so the framework runs (and CI passes) on machines
// without rdma-core headers or HCAs.
//
// This is the layer the reference delegated to OFED + perftest
// (README.md:64 "IB Verbs interface must be used"): device open, PD,
// MR registration — including dma-buf registration via
// ibv_reg_dmabuf_mr, the modern path SURVEY.md §7 prescribes in place
// of the reference's peer_memory_client bounce through the kernel —
// RC QP bring-up with a TCP rendezvous, and one-sided WRITE/READ.
//
// MR revocation here is an actual dereg (the effect the reference's
// free_callback→invalidate_peer_memory chain, amdp2p.c:88-109, has on
// the NIC: the MTT entry dies and remote access faults).
//
// Fused capabilities (parity with the emu backend, negotiated the same
// way — FEAT_* bits exchanged during bring-up, both ends must agree):
//
//  - reduce-on-receive: an HCA has no fold ALU, so inbound payloads
//    land in a small pool of registered staging slots and are folded
//    into the destination by the CPU at completion-translation time
//    (tdr_poll). The wire transfer of chunk i+1 still overlaps the
//    fold of chunk i — the NIC keeps streaming into the other slots.
//  - fold-and-write-back sends: the sender pre-posts a RECV over its
//    own source region, then SENDs the payload WITH_IMM (the imm word
//    tags it as a foldback). The receiver folds it into its matched
//    reduce-recv buffer and answers with a plain SEND carrying the
//    folded bytes, which lands in the pre-posted recv — in place over
//    the source. The user's send completion is surfaced when that
//    reply lands, preserving tdr.h's "completion means the exchange
//    finished on both sides" contract. RC's ordered, credit-matched
//    SEND/RECV streams make the pairing deterministic: recvs complete
//    in posted order, and the reply to foldback i is generated by the
//    peer in arrival order i.
//
// Testability without hardware: TDR_VERBS_LIB points the dlopen at an
// alternative provider (tests use the in-process mock_ibverbs.cc,
// playing the role the mock kernel plays for the kernel modules) —
// the SAME engine code runs under CI and on real HCAs.

#include <dlfcn.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <chrono>
#include <map>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.h"
#include "verbs_abi.h"

namespace tdr {
namespace {

struct VerbsLib {
  void *handle = nullptr;
  fn_ibv_get_device_list get_device_list = nullptr;
  fn_ibv_free_device_list free_device_list = nullptr;
  fn_ibv_get_device_name get_device_name = nullptr;
  fn_ibv_open_device open_device = nullptr;
  fn_ibv_close_device close_device = nullptr;
  fn_ibv_alloc_pd alloc_pd = nullptr;
  fn_ibv_dealloc_pd dealloc_pd = nullptr;
  fn_ibv_reg_mr reg_mr = nullptr;
  fn_ibv_reg_dmabuf_mr reg_dmabuf_mr = nullptr;  // optional (rdma-core >= 34)
  fn_ibv_dereg_mr dereg_mr = nullptr;
  fn_ibv_create_cq create_cq = nullptr;
  fn_ibv_destroy_cq destroy_cq = nullptr;
  fn_ibv_create_qp create_qp = nullptr;
  fn_ibv_modify_qp modify_qp = nullptr;
  fn_ibv_destroy_qp destroy_qp = nullptr;
  fn_ibv_query_port query_port = nullptr;
  fn_ibv_query_gid query_gid = nullptr;
};

VerbsLib *load_verbs(std::string *err) {
  static std::mutex mu;
  // Keyed by library path: tests switch providers (TDR_VERBS_LIB →
  // the mock) within one process, so a failed or different load must
  // not poison later ones.
  static std::map<std::string, VerbsLib *> libs;
  static std::map<std::string, std::string> load_errs;
  const char *env = getenv("TDR_VERBS_LIB");
  std::string path = env && *env ? env : "libibverbs.so.1";
  std::lock_guard<std::mutex> g(mu);
  auto it = libs.find(path);
  if (it != libs.end()) return it->second;
  auto eit = load_errs.find(path);
  if (eit != load_errs.end()) {
    *err = eit->second;
    return nullptr;
  }
  void *h = dlopen(path.c_str(), RTLD_NOW | RTLD_GLOBAL);
  if (!h && path == "libibverbs.so.1")
    h = dlopen("libibverbs.so", RTLD_NOW | RTLD_GLOBAL);
  if (!h) {
    load_errs[path] = std::string("dlopen ") + path + ": " + dlerror();
    *err = load_errs[path];
    return nullptr;
  }
  auto *l = new VerbsLib();
  l->handle = h;
  bool ok = true;
  std::string sym_err;
  auto sym = [&](const char *name, bool required) -> void * {
    void *p = dlsym(h, name);
    if (!p && required) {
      sym_err = std::string("missing symbol: ") + name;
      ok = false;
    }
    return p;
  };
  l->get_device_list = (fn_ibv_get_device_list)sym("ibv_get_device_list", true);
  l->free_device_list =
      (fn_ibv_free_device_list)sym("ibv_free_device_list", true);
  l->get_device_name = (fn_ibv_get_device_name)sym("ibv_get_device_name", true);
  l->open_device = (fn_ibv_open_device)sym("ibv_open_device", true);
  l->close_device = (fn_ibv_close_device)sym("ibv_close_device", true);
  l->alloc_pd = (fn_ibv_alloc_pd)sym("ibv_alloc_pd", true);
  l->dealloc_pd = (fn_ibv_dealloc_pd)sym("ibv_dealloc_pd", true);
  l->reg_mr = (fn_ibv_reg_mr)sym("ibv_reg_mr", true);
  l->reg_dmabuf_mr = (fn_ibv_reg_dmabuf_mr)sym("ibv_reg_dmabuf_mr", false);
  l->dereg_mr = (fn_ibv_dereg_mr)sym("ibv_dereg_mr", true);
  l->create_cq = (fn_ibv_create_cq)sym("ibv_create_cq", true);
  l->destroy_cq = (fn_ibv_destroy_cq)sym("ibv_destroy_cq", true);
  l->create_qp = (fn_ibv_create_qp)sym("ibv_create_qp", true);
  l->modify_qp = (fn_ibv_modify_qp)sym("ibv_modify_qp", true);
  l->destroy_qp = (fn_ibv_destroy_qp)sym("ibv_destroy_qp", true);
  l->query_port = (fn_ibv_query_port)sym("ibv_query_port", true);
  l->query_gid = (fn_ibv_query_gid)sym("ibv_query_gid", true);
  if (!ok) {
    delete l;
    load_errs[path] = sym_err;
    *err = sym_err;
    return nullptr;
  }
  libs[path] = l;
  return l;
}

// ibv_wc_status values we map specially (rdma-core numbering).
constexpr int kIbvWcWrFlushErr = 5;
constexpr int kIbvWcRemAccessErr = 10;

int map_status(int ibv_status) {
  switch (ibv_status) {
    case IBV_WC_SUCCESS:
      return TDR_WC_SUCCESS;
    case kIbvWcWrFlushErr:
      return TDR_WC_FLUSH_ERR;
    case kIbvWcRemAccessErr:
      return TDR_WC_REM_ACCESS_ERR;
    default:
      return TDR_WC_GENERAL_ERR;
  }
}

int map_access(int tdr_access) {
  int a = IBV_ACCESS_LOCAL_WRITE;
  if (tdr_access & TDR_ACCESS_REMOTE_WRITE) a |= IBV_ACCESS_REMOTE_WRITE;
  if (tdr_access & TDR_ACCESS_REMOTE_READ) a |= IBV_ACCESS_REMOTE_READ;
  return a;
}

// Immediate-data tag marking a SEND as a foldback (expects the folded
// bytes back as a reply SEND). Any WITH_IMM send carrying a different
// imm word is treated as a plain message.
constexpr uint32_t kFbImm = 0x54445246u;  // "TDRF"

// Staging-slot budget for reduce-on-receive (the recv window the ring
// layer respects via tdr_qp_rr_window): bounds staging memory at
// window * chunk bytes while keeping enough slots in flight that the
// NIC streams chunk i+1 while chunk i folds.
size_t rr_window() {
  const char *env = getenv("TDR_VERBS_RR_WINDOW");
  if (env && *env) {
    long v = atol(env);
    if (v >= 1 && v <= 256) return static_cast<size_t>(v);
  }
  return 8;
}

class VerbsEngine;

class VerbsMr : public Mr {
 public:
  VerbsLib *lib = nullptr;
  ibv_mr *mr = nullptr;
  bool dmabuf = false;  // no CPU mapping: host-side folds are impossible
  bool cpu_foldable() const override { return !dmabuf; }
  // Outstanding recv_reduce postings referencing this object (their
  // completion-time fold re-validates and dereferences it) — the same
  // bookkeeping the emu backend's recv_refs does. A dereg with live
  // refs parks the object in the engine graveyard instead of freeing.
  std::atomic<int> recv_refs{0};
  std::mutex mu;
  // invalidate() takes mu, which the completion-time fold also holds
  // while writing — so a concurrent invalidate/dereg waits out an
  // in-progress landing instead of freeing the pages under it (the
  // landing_begin semantics of the emu backend; the guarantee the
  // reference's put_pages path preserves, amdp2p.c:283-313).
  int invalidate() override {
    std::lock_guard<std::mutex> g(mu);
    valid.store(false, std::memory_order_release);
    if (mr) {
      lib->dereg_mr(mr);
      mr = nullptr;
    }
    return 0;
  }
  ~VerbsMr() override { invalidate(); }
};

// Exchanged over the TCP rendezvous during bring-up, both directions.
// The magic/version gate turns a build mismatch into a clean bring-up
// error instead of a garbled QP bring-up.
#pragma pack(push, 1)
struct ConnInfo {
  uint64_t magic;
  uint32_t version;
  uint32_t features;  // FEAT_* this side is willing to speak
  uint32_t qpn;
  uint32_t psn;
  uint16_t lid;
  uint8_t gid[16];
  uint8_t mtu;
  uint8_t link_layer;
};
#pragma pack(pop)
constexpr uint64_t kVerbsMagic = 0x7464725f76726273ull;  // "tdr_vrbs"
constexpr uint32_t kVerbsVersion = 2;

class VerbsQp : public Qp {
 public:
  VerbsQp(VerbsLib *lib, ibv_context *ctx, ibv_pd *pd)
      : lib_(lib), ctx_(ctx), pd_(pd) {}

  // Flight-recorder engine track (set at bring_up; the chunk
  // lifecycle on verbs is post → WC, the HCA owning the middle).
  uint16_t tel_eng_ = 0;

  bool setup(int sock, uint8_t port_num, int gid_index, std::string *err) {
    sock_ = sock;
    // Bounded rendezvous: a peer that never speaks (port scanner,
    // crashed rank, mixed-build struct-size mismatch) must produce a
    // clean bring-up error, not a wedged read_full.
    timeval tv{10, 0};
    setsockopt(sock_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    cq_ = lib_->create_cq(ctx_, 1024, nullptr, nullptr, 0);
    if (!cq_) {
      *err = "ibv_create_cq failed";
      return false;
    }
    ibv_qp_init_attr ia;
    memset(&ia, 0, sizeof(ia));
    ia.send_cq = cq_;
    ia.recv_cq = cq_;
    ia.cap.max_send_wr = 512;
    ia.cap.max_recv_wr = 512;
    ia.cap.max_send_sge = 1;
    ia.cap.max_recv_sge = 1;
    ia.qp_type = IBV_QPT_RC;
    qp_ = lib_->create_qp(pd_, &ia);
    if (!qp_) {
      *err = "ibv_create_qp failed";
      return false;
    }

    ibv_port_attr pattr;
    memset(&pattr, 0, sizeof(pattr));
    if (lib_->query_port(ctx_, port_num, &pattr) != 0) {
      *err = "ibv_query_port failed";
      return false;
    }
    union ibv_gid gid;
    memset(&gid, 0, sizeof(gid));
    lib_->query_gid(ctx_, port_num, gid_index, &gid);

    ConnInfo mine;
    memset(&mine, 0, sizeof(mine));
    mine.magic = kVerbsMagic;
    mine.version = kVerbsVersion;
    mine.features = local_features();
    mine.qpn = qp_->qp_num;
    mine.psn = static_cast<uint32_t>(
                   reinterpret_cast<uintptr_t>(this) ^
                   static_cast<uintptr_t>(
                       std::chrono::steady_clock::now().time_since_epoch()
                           .count())) &
               0xffffff;
    mine.lid = pattr.lid;
    memcpy(mine.gid, gid.raw, 16);
    mine.mtu = static_cast<uint8_t>(pattr.active_mtu);
    mine.link_layer = pattr.link_layer;
    if (!write_full(sock_, &mine, sizeof(mine)) ||
        !read_full(sock_, &peer_, sizeof(peer_))) {
      *err = "rendezvous exchange failed";
      return false;
    }
    if (peer_.magic != kVerbsMagic || peer_.version != kVerbsVersion) {
      *err = "rendezvous magic/version mismatch (mixed builds?)";
      return false;
    }
    // Schedule-changing capabilities require agreement from both ends
    // — negotiated exactly like the emu backend's Hello.
    features_ = mine.features & peer_.features;

    // INIT
    ibv_qp_attr a;
    memset(&a, 0, sizeof(a));
    a.qp_state = IBV_QPS_INIT;
    a.pkey_index = 0;
    a.port_num = port_num;
    a.qp_access_flags =
        IBV_ACCESS_LOCAL_WRITE | IBV_ACCESS_REMOTE_WRITE | IBV_ACCESS_REMOTE_READ;
    if (lib_->modify_qp(qp_, &a,
                        IBV_QP_STATE | IBV_QP_PKEY_INDEX | IBV_QP_PORT |
                            IBV_QP_ACCESS_FLAGS) != 0) {
      *err = "modify_qp INIT failed";
      return false;
    }
    // RTR
    memset(&a, 0, sizeof(a));
    a.qp_state = IBV_QPS_RTR;
    a.path_mtu = peer_.mtu < static_cast<uint8_t>(pattr.active_mtu)
                     ? peer_.mtu
                     : pattr.active_mtu;
    a.dest_qp_num = peer_.qpn;
    a.rq_psn = peer_.psn;
    a.max_dest_rd_atomic = 16;
    a.min_rnr_timer = 12;
    a.ah_attr.dlid = peer_.lid;
    a.ah_attr.sl = 0;
    a.ah_attr.src_path_bits = 0;
    a.ah_attr.port_num = port_num;
    if (peer_.link_layer == IBV_LINK_LAYER_ETHERNET || peer_.lid == 0) {
      a.ah_attr.is_global = 1;
      memcpy(a.ah_attr.grh.dgid.raw, peer_.gid, 16);
      a.ah_attr.grh.sgid_index = static_cast<uint8_t>(gid_index);
      a.ah_attr.grh.hop_limit = 64;
    }
    if (lib_->modify_qp(qp_, &a,
                        IBV_QP_STATE | IBV_QP_AV | IBV_QP_PATH_MTU |
                            IBV_QP_DEST_QPN | IBV_QP_RQ_PSN |
                            IBV_QP_MAX_DEST_RD_ATOMIC |
                            IBV_QP_MIN_RNR_TIMER) != 0) {
      *err = "modify_qp RTR failed";
      return false;
    }
    // RTS
    memset(&a, 0, sizeof(a));
    a.qp_state = IBV_QPS_RTS;
    a.timeout = 14;
    a.retry_cnt = 7;
    a.rnr_retry = 7;
    a.sq_psn = mine.psn;
    a.max_rd_atomic = 16;
    if (lib_->modify_qp(qp_, &a,
                        IBV_QP_STATE | IBV_QP_TIMEOUT | IBV_QP_RETRY_CNT |
                            IBV_QP_RNR_RETRY | IBV_QP_SQ_PSN |
                            IBV_QP_MAX_QP_RD_ATOMIC) != 0) {
      *err = "modify_qp RTS failed";
      return false;
    }
    // Barrier: both sides fully in RTS before any data flows.
    char tok = 1, peer_tok = 0;
    if (!write_full(sock_, &tok, 1) || !read_full(sock_, &peer_tok, 1)) {
      *err = "rendezvous barrier failed";
      return false;
    }
    timeval off{0, 0};
    setsockopt(sock_, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
    return true;
  }

  int post_write(Mr *lmr, size_t loff, uint64_t raddr, uint32_t rkey,
                 size_t len, uint64_t wr_id) override {
    TDR_TELC(TDR_TEL_POST_WRITE, tel_eng_, tel_id, wr_id, len,
             cur_coll.load(std::memory_order_relaxed));
    return post_one(lmr, loff, len, stash(Meta::normal(wr_id, TDR_OP_WRITE)),
                    IBV_WR_RDMA_WRITE, raddr, rkey, 0);
  }
  int post_read(Mr *lmr, size_t loff, uint64_t raddr, uint32_t rkey,
                size_t len, uint64_t wr_id) override {
    TDR_TELC(TDR_TEL_POST_READ, tel_eng_, tel_id, wr_id, len,
             cur_coll.load(std::memory_order_relaxed));
    return post_one(lmr, loff, len, stash(Meta::normal(wr_id, TDR_OP_READ)),
                    IBV_WR_RDMA_READ, raddr, rkey, 0);
  }
  int post_send(Mr *lmr, size_t loff, size_t len, uint64_t wr_id) override {
    TDR_TELC(TDR_TEL_POST_SEND, tel_eng_, tel_id, wr_id, len,
             cur_coll.load(std::memory_order_relaxed));
    return post_one(lmr, loff, len, stash(Meta::normal(wr_id, TDR_OP_SEND)),
                    IBV_WR_SEND, 0, 0, 0);
  }

  int post_recv(Mr *lmr, size_t loff, size_t maxlen, uint64_t wr_id) override {
    TDR_TELC(TDR_TEL_POST_RECV, tel_eng_, tel_id, wr_id, maxlen,
             cur_coll.load(std::memory_order_relaxed));
    return post_recv_raw(lmr, loff, maxlen,
                         stash(Meta::normal(wr_id, TDR_OP_RECV)));
  }

  // Reduce-on-receive: the payload lands in a registered staging slot;
  // the fold into (lmr + loff) runs at completion-translation time.
  int post_recv_reduce(Mr *lmr, size_t loff, size_t maxlen, int dtype,
                       int red_op, uint64_t wr_id) override {
    TDR_TELC(TDR_TEL_POST_RECV, tel_eng_, tel_id, wr_id, maxlen,
             cur_coll.load(std::memory_order_relaxed));
    size_t esz = dtype_size(dtype);
    if (esz == 0) {
      set_error("post_recv_reduce: bad dtype");
      return -1;
    }
    auto *vmr = static_cast<VerbsMr *>(lmr);
    if (vmr->dmabuf) {
      // Device-only MR: the CPU cannot fold into it. Callers use the
      // plain windowed-scratch schedule for such buffers (a real
      // in-network fold needs SHARP-class switch offload).
      set_error("post_recv_reduce: dma-buf MR has no CPU mapping to fold "
                "into; use post_recv + host reduction");
      return -1;
    }
    int slot;
    char *dst;
    uint32_t reply_lkey;
    {
      std::lock_guard<std::mutex> g(vmr->mu);
      if (!vmr->mr) {
        set_error("post_recv_reduce: MR invalidated");
        return -1;
      }
      if (loff > vmr->len || maxlen > vmr->len - loff) {
        set_error("post_recv_reduce: range outside MR");
        return -1;
      }
      dst = static_cast<char *>(vmr->mr->addr) + loff;
      reply_lkey = vmr->mr->lkey;
    }
    slot = acquire_slot(maxlen);
    if (slot < 0) return -1;
    Meta m;
    m.kind = Meta::kRecvReduce;
    m.user = wr_id;
    m.opcode = TDR_OP_RECV;
    m.dst = dst;
    m.maxlen = maxlen;
    m.dtype = dtype;
    m.red_op = red_op;
    m.slot = slot;
    m.lmr = vmr;
    m.reply_addr = reinterpret_cast<uint64_t>(dst);
    m.reply_lkey = reply_lkey;
    vmr->recv_refs.fetch_add(1, std::memory_order_acq_rel);
    uint64_t cookie = stash(m);
    std::lock_guard<std::mutex> g(slot_mu_);
    Slot &s = slots_[slot];
    ibv_sge sge{reinterpret_cast<uint64_t>(s.buf),
                static_cast<uint32_t>(maxlen), s.mr->lkey};
    ibv_recv_wr wr;
    memset(&wr, 0, sizeof(wr));
    wr.wr_id = cookie;
    wr.sg_list = &sge;
    wr.num_sge = 1;
    ibv_recv_wr *bad = nullptr;
    if (qp_->context->ops.post_recv(qp_, &wr, &bad) != 0) {
      s.busy = false;
      vmr->recv_refs.fetch_sub(1, std::memory_order_acq_rel);
      unstash(cookie);
      set_error("ibv_post_recv failed");
      return -1;
    }
    return 0;
  }

  bool has_recv_reduce() const override { return true; }

  // Fold-and-write-back: send the payload WITH_IMM, then post a recv
  // over the source region (the reply's landing site — in place). The
  // user completion is the reply recv's completion. Send-before-recv
  // keeps a failed send from leaving an orphan recv that would shift
  // the reply FIFO for the QP's lifetime; the reverse race — the
  // peer's reply beating our recv post — is absorbed by RC flow
  // control (rnr_retry=7 = retry forever; the mock queues inbound).
  int post_send_foldback(Mr *lmr, size_t loff, size_t len,
                         uint64_t wr_id) override {
    if (!(features_ & FEAT_FOLDBACK)) {
      set_error("post_send_foldback: not negotiated with peer");
      return -1;
    }
    TDR_TELC(TDR_TEL_POST_SEND, tel_eng_, tel_id, wr_id, len,
             cur_coll.load(std::memory_order_relaxed));
    Meta reply;
    reply.kind = Meta::kFbReply;
    reply.user = wr_id;
    reply.opcode = TDR_OP_SEND;
    reply.want = len;
    uint64_t cookieR = stash(reply);
    Meta send;
    send.kind = Meta::kFbSend;
    send.user = wr_id;
    send.opcode = TDR_OP_SEND;
    send.partner = cookieR;
    uint64_t cookieS = stash(send);
    set_partner(cookieR, cookieS);
    if (post_one(lmr, loff, len, cookieS, IBV_WR_SEND_WITH_IMM, 0, 0,
                 kFbImm) != 0) {
      unstash(cookieR);  // nothing on the wire; clean unwind
      return -1;
    }
    if (post_recv_raw(lmr, loff, len, cookieR) != 0) {
      // Payload is in flight but its reply has no landing site: the
      // peer's reply RNR-retries until the ring's stall deadline
      // surfaces the failure. Report the local failure now — and mark
      // the in-flight send cookie so its eventual (likely errored)
      // CQE is swallowed instead of surfacing a ghost completion for
      // an op the caller already error-handled.
      std::lock_guard<std::mutex> g(mu_);
      if (inflight_.count(cookieS)) swallow_.insert(cookieS);
      return -1;
    }
    return 0;
  }

  bool has_send_foldback() const override {
    return (features_ & FEAT_FOLDBACK) != 0;
  }
  bool has_fused2() const override { return (features_ & FEAT_FUSED2) != 0; }
  size_t rr_window_hint() const override { return rr_window(); }
  // No host-side sealing on verbs: the IB/RoCE wire already carries a
  // per-packet ICRC the HCA verifies, so a software CRC here would
  // re-touch every byte for protection the link provides — and the
  // seal trailer is an emu wire-format construct the RDMA transports
  // have no frame to piggyback on. FEAT_SEAL may be negotiated in the
  // ConnInfo features word (both backends share local_features) but
  // is deliberately never consulted; tdr_qp_has_seal reports 0 so the
  // Python layer's schedule digest records the true seal state.
  bool has_seal() const override { return false; }

  // Thread-safety: ibv_poll_cq is thread-safe per the verbs contract,
  // so this may run concurrently with posts on this QP and with
  // polls on other QPs (the sharded progress engine's usage). This
  // backend never calls Engine::cq_pulse — completions appear only
  // under polling — so multi-QP waiters' cq_wait degrades to its
  // bounded sleep slice instead of an event-driven wake.
  int poll(tdr_wc *out, int max, int timeout_ms) override {
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
    ibv_wc wcs[64];
    for (;;) {
      // Each raw CQE yields at most one user completion, so capping
      // the fetch at `max` keeps the out array sufficient even before
      // swallowed (internal) completions shrink the count.
      int want = max < 64 ? max : 64;
      int n = qp_->context->ops.poll_cq(cq_, want, wcs);
      if (n < 0) {
        set_error("ibv_poll_cq failed");
        return -1;
      }
      int users = 0;
      for (int i = 0; i < n; i++) users += translate(wcs[i], &out[users]);
      if (users > 0) {
        if (tel_on()) {
          for (int u = 0; u < users; u++) {
            tel_emit(TDR_TEL_WC, tel_eng_, tel_id, out[u].wr_id,
                     static_cast<uint64_t>(out[u].status),
                     cur_coll.load(std::memory_order_relaxed));
            if (out[u].status == TDR_WC_SUCCESS && out[u].len)
              tel_hist_add(TDR_HIST_CHUNK_BYTES, out[u].len);
          }
        }
        return users;
      }
      // n > 0 with users == 0 (all internal) loops again immediately.
      if (n == 0) {
        if (timeout_ms == 0) return 0;
        if (timeout_ms > 0 && std::chrono::steady_clock::now() >= deadline)
          return 0;
        std::this_thread::yield();
      }
    }
  }

  int close_qp() override {
    if (qp_) {
      lib_->destroy_qp(qp_);
      qp_ = nullptr;
    }
    if (cq_) {
      lib_->destroy_cq(cq_);
      cq_ = nullptr;
    }
    {
      std::lock_guard<std::mutex> g(slot_mu_);
      for (Slot &s : slots_) {
        if (s.mr) lib_->dereg_mr(s.mr);
        free(s.buf);
      }
      slots_.clear();
    }
    if (sock_ >= 0) {
      ::close(sock_);
      sock_ = -1;
    }
    return 0;
  }

  ~VerbsQp() override { close_qp(); }

 private:
  // Completion-translation metadata, one entry per posted work request
  // (the wr_id indirection also maps error completions — whose ibv
  // opcode field is undefined — back to the op they were posted as).
  struct Meta {
    uint64_t user = 0;
    int opcode = TDR_OP_WRITE;
    enum Kind { kNormal = 0, kRecvReduce, kFbSend, kFbReply, kReplyOut };
    int kind = kNormal;
    // kRecvReduce
    char *dst = nullptr;
    size_t maxlen = 0;
    int dtype = 0, red_op = 0;
    int slot = -1;
    VerbsMr *lmr = nullptr;   // holds a recv_ref until translate time
    uint64_t reply_addr = 0;  // raw addr+lkey captured at post time so
    uint32_t reply_lkey = 0;  // the reply posting needs no Mr lookup
    // kFbSend / kFbReply pairing
    uint64_t partner = 0;
    size_t want = 0;
    // Flight recorder: stash (≈ post) timestamp feeding the
    // post→completion latency histogram; 0 when telemetry is off.
    uint64_t post_ns = 0;

    static Meta normal(uint64_t user, int opcode) {
      Meta m;
      m.user = user;
      m.opcode = opcode;
      return m;
    }
  };

  struct Slot {
    char *buf = nullptr;
    size_t cap = 0;
    ibv_mr *mr = nullptr;
    bool busy = false;
  };

  int post_recv_raw(Mr *lmr, size_t loff, size_t maxlen, uint64_t cookie) {
    auto *vmr = static_cast<VerbsMr *>(lmr);
    std::lock_guard<std::mutex> g(vmr->mu);
    if (!vmr->mr) {
      unstash(cookie);
      set_error("post_recv: MR invalidated");
      return -1;
    }
    ibv_sge sge;
    sge.addr = reinterpret_cast<uint64_t>(vmr->mr->addr) + loff;
    sge.length = static_cast<uint32_t>(maxlen);
    sge.lkey = vmr->mr->lkey;
    ibv_recv_wr wr;
    memset(&wr, 0, sizeof(wr));
    wr.wr_id = cookie;
    wr.sg_list = &sge;
    wr.num_sge = 1;
    ibv_recv_wr *bad = nullptr;
    if (qp_->context->ops.post_recv(qp_, &wr, &bad) != 0) {
      unstash(cookie);
      set_error("ibv_post_recv failed");
      return -1;
    }
    return 0;
  }

  int post_one(Mr *lmr, size_t loff, size_t len, uint64_t cookie, int ibv_op,
               uint64_t raddr, uint32_t rkey, uint32_t imm) {
    auto *vmr = static_cast<VerbsMr *>(lmr);
    std::lock_guard<std::mutex> g(vmr->mu);
    if (!vmr->mr) {
      unstash(cookie);
      set_error("post: MR invalidated");
      return -1;
    }
    ibv_sge sge;
    sge.addr = reinterpret_cast<uint64_t>(vmr->mr->addr) + loff;
    sge.length = static_cast<uint32_t>(len);
    sge.lkey = vmr->mr->lkey;
    ibv_send_wr wr;
    memset(&wr, 0, sizeof(wr));
    wr.wr_id = cookie;
    wr.sg_list = &sge;
    wr.num_sge = 1;
    wr.opcode = ibv_op;
    wr.send_flags = IBV_SEND_SIGNALED;
    wr.imm_data = imm;
    wr.wr.rdma.remote_addr = raddr;
    wr.wr.rdma.rkey = rkey;
    ibv_send_wr *bad = nullptr;
    if (qp_->context->ops.post_send(qp_, &wr, &bad) != 0) {
      unstash(cookie);
      set_error("ibv_post_send failed");
      return -1;
    }
    return 0;
  }

  // Reply to a foldback: a plain SEND carrying the folded bytes (or a
  // 0-length SEND on fold failure — the peer sees byte_len != want and
  // errors its send). Never touches the VerbsMr object: addr/lkey were
  // captured at post_recv_reduce time.
  void post_reply(const Meta &m, size_t len) {
    Meta rm;
    rm.kind = Meta::kReplyOut;
    uint64_t cookie = stash(rm);
    ibv_sge sge{m.reply_addr, static_cast<uint32_t>(len), m.reply_lkey};
    ibv_send_wr wr;
    memset(&wr, 0, sizeof(wr));
    wr.wr_id = cookie;
    wr.sg_list = len ? &sge : nullptr;
    wr.num_sge = len ? 1 : 0;
    wr.opcode = IBV_WR_SEND;
    wr.send_flags = IBV_SEND_SIGNALED;
    ibv_send_wr *bad = nullptr;
    if (qp_->context->ops.post_send(qp_, &wr, &bad) != 0) {
      // Posting failed (QP dead): the peer's reply recv will flush
      // when the connection tears down; nothing to surface locally.
      unstash(cookie);
    }
  }

  // Successful user completion: feed the post→completion latency
  // histogram from the Meta's stash timestamp (success only — a
  // flushed WR's stall is not a latency).
  static void tel_lat(const Meta &m, int st) {
    if (st == TDR_WC_SUCCESS && m.post_ns && tel_on())
      tel_hist_add(TDR_HIST_CHUNK_LAT_US, (tel_now_ns() - m.post_ns) / 1000);
  }

  // One raw CQE → 0 or 1 user completions (internal completions —
  // foldback payload sends, reply-out sends — are swallowed).
  int translate(const ibv_wc &w, tdr_wc *out) {
    Meta m = unstash(w.wr_id);
    int st = map_status(w.status);
    switch (m.kind) {
      case Meta::kNormal:
        tel_lat(m, st);
        *out = {m.user, st, m.opcode, w.byte_len};
        return 1;
      case Meta::kRecvReduce: {
        bool want_reply = st == TDR_WC_SUCCESS &&
                          (w.wc_flags & IBV_WC_WITH_IMM) && w.imm_data == kFbImm;
        bool replied = false;
        if (st == TDR_WC_SUCCESS) {
          size_t esz = dtype_size(m.dtype);
          if (w.byte_len > m.maxlen || w.byte_len % esz != 0) {
            st = TDR_WC_LOC_ACCESS_ERR;
          } else {
            char *src;
            {
              std::lock_guard<std::mutex> g(slot_mu_);
              src = slots_[m.slot].buf;
            }
            // Landing write: re-validate the target MR and hold its
            // lock for the fold (and the reply, whose sge reads the
            // folded region), so a concurrent invalidate/dereg waits
            // out the write instead of freeing the pages under it —
            // a free between post and landing must FAIL the recv,
            // never scribble on reclaimed memory (the emu backend's
            // landing_begin; amdp2p.c:88-109 revocation semantics).
            std::lock_guard<std::mutex> lg(m.lmr->mu);
            if (!m.lmr->mr) {
              st = TDR_WC_LOC_ACCESS_ERR;
            } else {
              // The fold itself is pool-parallel (par_reduce forks
              // across the copy workers), so a chunk-sized fold uses
              // every core even though completion translation stays
              // sequential; the FOLD event gives the slot fold its
              // own timeline instant on this QP's channel lane.
              par_reduce(m.dst, src, w.byte_len / esz, m.dtype, m.red_op);
              TDR_TELC(TDR_TEL_FOLD, tel_eng_, tel_id, m.user, w.byte_len,
                       cur_coll.load(std::memory_order_relaxed));
              if (want_reply) {
                post_reply(m, w.byte_len);
                replied = true;
              }
            }
          }
        }
        release_slot(m.slot);
        if (m.lmr) m.lmr->recv_refs.fetch_sub(1, std::memory_order_acq_rel);
        if (want_reply && !replied) post_reply(m, 0);
        tel_lat(m, st);
        *out = {m.user, st, TDR_OP_RECV, w.byte_len};
        return 1;
      }
      case Meta::kFbSend: {
        std::lock_guard<std::mutex> g(mu_);
        // Always clear any mark the (errored) reply left for us — an
        // unerased entry for a consumed cookie would pin the set.
        bool marked = swallow_.erase(w.wr_id) > 0;
        if (w.status == IBV_WC_SUCCESS || marked)
          return 0;  // reply is authoritative / already surfaced
        // Mark the partner for swallowing only while it is still
        // outstanding — a consumed cookie can never be erased.
        if (inflight_.count(m.partner)) swallow_.insert(m.partner);
        *out = {m.user, st, TDR_OP_SEND, 0};
        return 1;
      }
      case Meta::kFbReply: {
        {
          std::lock_guard<std::mutex> g(mu_);
          if (swallow_.erase(w.wr_id)) return 0;
        }
        if (st == TDR_WC_SUCCESS && w.byte_len != m.want)
          st = TDR_WC_GENERAL_ERR;  // peer's fold failed (0-length reply)
        if (st != TDR_WC_SUCCESS) {
          std::lock_guard<std::mutex> g(mu_);
          if (inflight_.count(m.partner)) swallow_.insert(m.partner);
        }
        tel_lat(m, st);
        *out = {m.user, st, TDR_OP_SEND, w.byte_len};
        return 1;
      }
      case Meta::kReplyOut:
      default:
        return 0;  // internal; errors surface as the peer's flush
    }
  }

  int acquire_slot(size_t len) {
    std::lock_guard<std::mutex> g(slot_mu_);
    for (size_t i = 0; i < slots_.size(); i++) {
      if (!slots_[i].busy && slots_[i].cap >= len) {
        slots_[i].busy = true;
        return static_cast<int>(i);
      }
    }
    Slot s;
    s.cap = len;
    s.buf = static_cast<char *>(aligned_alloc(64, (len + 63) & ~size_t(63)));
    if (!s.buf) {
      set_error("recv_reduce: staging allocation failed");
      return -1;
    }
    s.mr = lib_->reg_mr(pd_, s.buf, len, IBV_ACCESS_LOCAL_WRITE);
    if (!s.mr) {
      free(s.buf);
      set_error("recv_reduce: staging reg_mr failed");
      return -1;
    }
    s.busy = true;
    slots_.push_back(s);
    return static_cast<int>(slots_.size() - 1);
  }

  void release_slot(int i) {
    if (i < 0) return;
    std::lock_guard<std::mutex> g(slot_mu_);
    slots_[static_cast<size_t>(i)].busy = false;
  }

  uint64_t stash(const Meta &m) {
    std::lock_guard<std::mutex> g(mu_);
    uint64_t cookie = next_cookie_++;
    inflight_[cookie] = m;
    if (tel_on()) inflight_[cookie].post_ns = tel_now_ns();
    return cookie;
  }
  void set_partner(uint64_t cookie, uint64_t partner) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = inflight_.find(cookie);
    if (it != inflight_.end()) it->second.partner = partner;
  }
  Meta unstash(uint64_t cookie) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = inflight_.find(cookie);
    if (it == inflight_.end()) return Meta::normal(cookie, TDR_OP_WRITE);
    Meta v = it->second;
    inflight_.erase(it);
    return v;
  }

  VerbsLib *lib_;
  ibv_context *ctx_;
  ibv_pd *pd_;
  ibv_cq *cq_ = nullptr;
  ibv_qp *qp_ = nullptr;
  int sock_ = -1;
  ConnInfo peer_{};
  uint32_t features_ = 0;
  std::mutex mu_;
  std::unordered_map<uint64_t, Meta> inflight_;
  // Cookies whose completion must be dropped because their foldback
  // partner already surfaced the (error) result.
  std::unordered_set<uint64_t> swallow_;
  uint64_t next_cookie_ = 1;
  std::mutex slot_mu_;
  std::vector<Slot> slots_;
};

class VerbsEngine : public Engine {
 public:
  VerbsEngine(VerbsLib *lib, ibv_context *ctx, ibv_pd *pd, std::string dev,
              uint8_t port, int gid_index)
      : lib_(lib),
        ctx_(ctx),
        pd_(pd),
        dev_(std::move(dev)),
        port_(port),
        gid_index_(gid_index) {}

  ~VerbsEngine() override {
    {
      std::lock_guard<std::mutex> g(gy_mu_);
      for (VerbsMr *mr : graveyard_) delete mr;
      graveyard_.clear();
    }
    if (pd_) lib_->dealloc_pd(pd_);
    if (ctx_) lib_->close_device(ctx_);
  }

  int kind() const override { return TDR_ENGINE_VERBS; }
  const char *name() const override { return dev_.c_str(); }

  Mr *reg_mr(void *addr, size_t len, int access) override {
    ibv_mr *m = lib_->reg_mr(pd_, addr, len, map_access(access));
    if (!m) {
      set_error("ibv_reg_mr failed");
      return nullptr;
    }
    return wrap(m, access, /*dmabuf=*/false);
  }

  Mr *reg_dmabuf_mr(int fd, size_t offset, size_t len, uint64_t iova,
                    int access) override {
    if (!lib_->reg_dmabuf_mr) {
      set_error("ibv_reg_dmabuf_mr not available (rdma-core too old)");
      return nullptr;
    }
    ibv_mr *m =
        lib_->reg_dmabuf_mr(pd_, offset, len, iova, fd, map_access(access));
    if (!m) {
      set_error("ibv_reg_dmabuf_mr failed");
      return nullptr;
    }
    return wrap(m, access, /*dmabuf=*/true);
  }

  int dereg_mr(Mr *mr) override {
    auto *vmr = static_cast<VerbsMr *>(mr);
    // Kills the ibv MR now (waiting out any in-progress landing fold,
    // which holds vmr->mu) so the NIC never touches the memory after
    // this returns — ibv_dereg_mr semantics.
    vmr->invalidate();
    // Outstanding recv_reduce postings still hold the object (their
    // completion-time translate re-checks validity through it, then
    // drops recv_refs) — and may never complete if the QP idles, so
    // waiting here could hang. Park such MRs in a graveyard, reaped as
    // refs drain on later deregs and freed at engine close (the emu
    // backend's scheme).
    std::lock_guard<std::mutex> g(gy_mu_);
    for (auto it = graveyard_.begin(); it != graveyard_.end();) {
      if ((*it)->recv_refs.load(std::memory_order_acquire) == 0) {
        delete *it;
        it = graveyard_.erase(it);
      } else {
        ++it;
      }
    }
    if (vmr->recv_refs.load(std::memory_order_acquire) > 0)
      graveyard_.push_back(vmr);
    else
      delete vmr;
    return 0;
  }

  // flags (TDR_CONN_FORCE_STREAM) are a tiering concept of the
  // emulated transport; a real HCA has no CMA fast path to refuse.
  Qp *listen(const char *bind_host, int port, int timeout_ms,
             int /*flags*/) override {
    std::string err;
    int fd = tcp_listen_accept(bind_host, port, &err, timeout_ms);
    if (fd < 0) {
      set_error("listen: " + err);
      return nullptr;
    }
    return bring_up(fd);
  }

  Qp *connect(const char *host, int port, int timeout_ms,
              int /*flags*/) override {
    std::string err;
    int fd = tcp_connect_retry(host, port, timeout_ms, &err);
    if (fd < 0) {
      set_error("connect: " + err);
      return nullptr;
    }
    return bring_up(fd);
  }

 private:
  Mr *wrap(ibv_mr *m, int access, bool dmabuf) {
    auto *mr = new VerbsMr();
    mr->engine = this;
    mr->lib = lib_;
    mr->mr = m;
    mr->dmabuf = dmabuf;
    mr->addr = reinterpret_cast<uint64_t>(m->addr);
    mr->len = m->length;
    mr->lkey = m->lkey;
    mr->rkey = m->rkey;
    mr->access = access;
    return mr;
  }

  Qp *bring_up(int fd) {
    auto *qp = new VerbsQp(lib_, ctx_, pd_);
    qp->tel_eng_ = tel_id;  // flight-recorder track label
    std::string err;
    if (!qp->setup(fd, port_, gid_index_, &err)) {
      set_error("verbs bring-up: " + err);
      // setup() stored fd as sock_; ~VerbsQp closes it exactly once.
      delete qp;
      return nullptr;
    }
    return qp;
  }

  VerbsLib *lib_;
  ibv_context *ctx_;
  ibv_pd *pd_;
  std::string dev_;
  uint8_t port_;
  int gid_index_;
  std::mutex gy_mu_;
  std::vector<VerbsMr *> graveyard_;
};

}  // namespace

Engine *create_verbs_engine(const std::string &device, std::string *err) {
  VerbsLib *lib = load_verbs(err);
  if (!lib) return nullptr;
  int num = 0;
  ibv_device **list = lib->get_device_list(&num);
  if (!list || num == 0) {
    if (list) lib->free_device_list(list);
    *err = "no RDMA devices present";
    return nullptr;
  }
  ibv_device *chosen = nullptr;
  std::string chosen_name;
  for (int i = 0; i < num; i++) {
    const char *n = lib->get_device_name(list[i]);
    if (device.empty() || device == n) {
      chosen = list[i];
      chosen_name = n ? n : "?";
      break;
    }
  }
  if (!chosen) {
    lib->free_device_list(list);
    *err = "device not found: " + device;
    return nullptr;
  }
  ibv_context *ctx = lib->open_device(chosen);
  lib->free_device_list(list);
  if (!ctx) {
    *err = "ibv_open_device failed";
    return nullptr;
  }
  ibv_pd *pd = lib->alloc_pd(ctx);
  if (!pd) {
    lib->close_device(ctx);
    *err = "ibv_alloc_pd failed";
    return nullptr;
  }
  const char *gid_env = getenv("TDR_GID_INDEX");
  int gid_index = gid_env ? atoi(gid_env) : 0;
  const char *port_env = getenv("TDR_IB_PORT");
  uint8_t port = port_env ? static_cast<uint8_t>(atoi(port_env)) : 1;
  return new VerbsEngine(lib, ctx, pd, chosen_name, port, gid_index);
}

}  // namespace tdr
