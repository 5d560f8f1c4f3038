// mock_ibverbs.cc — an in-process fake libibverbs provider.
//
// Built as its own shared object (libmockibverbs.so); tests point
// TDR_VERBS_LIB at it and the UNMODIFIED verbs backend
// (verbs_engine.cc) runs against it — bring-up, MR registration, RC
// SEND/RECV with FIFO matching and RNR queueing, one-sided WRITE/READ
// with rkey/bounds/access checks, WITH_IMM delivery, and CQ polling.
// This plays the role kernelmod/mock plays for the kernel modules
// (SURVEY.md §4's "fake backend" lesson): the product path is
// exercised by CI on machines with no HCA, and the same engine binary
// talks to real hardware unchanged.
//
// Model: one process-global registry pairs QPs by dest_qp_num (set at
// RTR, exactly what the real rendezvous exchanges), so two Engine
// instances in one process form a loopback "fabric". Placement is
// synchronous at post/match time under one lock; CQEs appear in
// posted order, which satisfies RC's ordering guarantees.
//
// Deliberately NOT implemented: SRQs, atomics, UD, multi-sge — the
// engine uses none of them.

#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <set>
#include <unordered_map>
#include <vector>

#include "verbs_abi.h"

namespace {

constexpr int kWcFlushErr = 5;     // IBV_WC_WR_FLUSH_ERR
constexpr int kWcRemAccessErr = 10;  // IBV_WC_REM_ACCESS_ERR
constexpr int kWcGeneralErr = 13;  // IBV_WC_REM_OP_ERR (any generic)
constexpr int kWcOpRecv = 1 << 7;  // IBV_WC_RECV

struct MockCq {
  ibv_cq cq;  // ABI view — must be first (pointer-cast identity)
  std::deque<ibv_wc> wcs;
};

struct PostedRecv {
  uint64_t wr_id;
  uint64_t addr;
  uint32_t len;
};

struct Inbound {
  std::vector<char> data;
  uint32_t imm = 0;
  bool has_imm = false;
  uint32_t src_qpn = 0;   // deferred sender completion on match
  uint64_t src_wr_id = 0;
};

struct MockQp {
  ibv_qp qp;  // ABI view — must be first
  uint32_t dest = 0;
  MockCq *scq = nullptr;
  MockCq *rcq = nullptr;
  std::deque<PostedRecv> recvs;
  std::deque<Inbound> inbound;
};

struct MockMr {
  ibv_mr mr;  // ABI view — must be first
  int access = 0;
};

struct Global {
  std::mutex mu;
  std::unordered_map<uint32_t, MockQp *> qps;        // qp_num → qp
  std::unordered_map<uint32_t, MockMr *> mrs;        // rkey → mr
  std::set<MockCq *> live_cqs;
  uint32_t next_qpn = 1000;
  uint32_t next_key = 0x4000;
  uint16_t next_lid = 7;
};

Global &g() {
  static Global *inst = new Global();
  return *inst;
}

void push_wc(MockCq *cq, const ibv_wc &wc) {
  if (cq && g().live_cqs.count(cq)) cq->wcs.push_back(wc);
}

ibv_wc make_wc(uint64_t wr_id, int status, int opcode, uint32_t byte_len,
               uint32_t imm = 0, bool with_imm = false) {
  ibv_wc wc;
  memset(&wc, 0, sizeof(wc));
  wc.wr_id = wr_id;
  wc.status = status;
  wc.opcode = opcode;
  wc.byte_len = byte_len;
  wc.imm_data = imm;
  wc.wc_flags = with_imm ? IBV_WC_WITH_IMM : 0;
  return wc;
}

// Place an inbound message into a posted recv; generates the receiver
// CQE and the (possibly deferred) sender CQE. Caller holds g().mu.
void deliver(MockQp *dst, const PostedRecv &r, Inbound &in) {
  MockQp *src = nullptr;
  auto sit = g().qps.find(in.src_qpn);
  if (sit != g().qps.end()) src = sit->second;
  if (in.data.size() > r.len) {
    push_wc(dst->rcq, make_wc(r.wr_id, kWcGeneralErr, kWcOpRecv, 0));
    if (src) push_wc(src->scq, make_wc(in.src_wr_id, kWcGeneralErr, 0, 0));
    return;
  }
  if (!in.data.empty())
    memcpy(reinterpret_cast<void *>(r.addr), in.data.data(), in.data.size());
  push_wc(dst->rcq,
          make_wc(r.wr_id, IBV_WC_SUCCESS, kWcOpRecv,
                  static_cast<uint32_t>(in.data.size()), in.imm, in.has_imm));
  if (src)
    push_wc(src->scq, make_wc(in.src_wr_id, IBV_WC_SUCCESS, 0,
                              static_cast<uint32_t>(in.data.size())));
}

int mock_post_send(ibv_qp *qp, ibv_send_wr *wr, ibv_send_wr **bad) {
  auto *mq = reinterpret_cast<MockQp *>(qp);
  std::lock_guard<std::mutex> lk(g().mu);
  for (; wr; wr = wr->next) {
    uint64_t laddr = 0;
    uint32_t llen = 0;
    if (wr->num_sge > 0) {
      laddr = wr->sg_list[0].addr;
      llen = wr->sg_list[0].length;
    }
    switch (wr->opcode) {
      case IBV_WR_SEND:
      case IBV_WR_SEND_WITH_IMM: {
        auto it = g().qps.find(mq->dest);
        if (it == g().qps.end()) {
          push_wc(mq->scq, make_wc(wr->wr_id, kWcFlushErr, 0, 0));
          break;
        }
        MockQp *peer = it->second;
        Inbound in;
        in.data.assign(reinterpret_cast<char *>(laddr),
                       reinterpret_cast<char *>(laddr) + llen);
        in.has_imm = wr->opcode == IBV_WR_SEND_WITH_IMM;
        in.imm = wr->imm_data;
        in.src_qpn = mq->qp.qp_num;
        in.src_wr_id = wr->wr_id;
        if (!peer->recvs.empty()) {
          PostedRecv r = peer->recvs.front();
          peer->recvs.pop_front();
          deliver(peer, r, in);
        } else {
          peer->inbound.push_back(std::move(in));  // RNR queue
        }
        break;
      }
      case IBV_WR_RDMA_WRITE:
      case IBV_WR_RDMA_READ: {
        auto it = g().mrs.find(wr->wr.rdma.rkey);
        bool write = wr->opcode == IBV_WR_RDMA_WRITE;
        int need = write ? IBV_ACCESS_REMOTE_WRITE : IBV_ACCESS_REMOTE_READ;
        uint64_t ra = wr->wr.rdma.remote_addr;
        if (it == g().mrs.end() || !(it->second->access & need) ||
            ra < reinterpret_cast<uint64_t>(it->second->mr.addr) ||
            ra + llen > reinterpret_cast<uint64_t>(it->second->mr.addr) +
                            it->second->mr.length) {
          push_wc(mq->scq, make_wc(wr->wr_id, kWcRemAccessErr,
                                   write ? 0 : 2, 0));
          break;
        }
        if (write)
          memcpy(reinterpret_cast<void *>(ra),
                 reinterpret_cast<void *>(laddr), llen);
        else
          memcpy(reinterpret_cast<void *>(laddr),
                 reinterpret_cast<void *>(ra), llen);
        push_wc(mq->scq,
                make_wc(wr->wr_id, IBV_WC_SUCCESS, write ? 0 : 2, llen));
        break;
      }
      default:
        if (bad) *bad = wr;
        return 95;  // EOPNOTSUPP
    }
  }
  return 0;
}

int mock_post_recv(ibv_qp *qp, ibv_recv_wr *wr, ibv_recv_wr **bad) {
  (void)bad;
  auto *mq = reinterpret_cast<MockQp *>(qp);
  std::lock_guard<std::mutex> lk(g().mu);
  for (; wr; wr = wr->next) {
    PostedRecv r{wr->wr_id,
                 wr->num_sge > 0 ? wr->sg_list[0].addr : 0,
                 wr->num_sge > 0 ? wr->sg_list[0].length : 0};
    if (!mq->inbound.empty()) {
      Inbound in = std::move(mq->inbound.front());
      mq->inbound.pop_front();
      deliver(mq, r, in);
    } else {
      mq->recvs.push_back(r);
    }
  }
  return 0;
}

int mock_poll_cq(ibv_cq *cq, int num, ibv_wc *out) {
  auto *mc = reinterpret_cast<MockCq *>(cq);
  std::lock_guard<std::mutex> lk(g().mu);
  int n = 0;
  while (n < num && !mc->wcs.empty()) {
    out[n++] = mc->wcs.front();
    mc->wcs.pop_front();
  }
  return n;
}

// The fake device list: one device, identity carried in the pointer.
int g_device_token;

}  // namespace

extern "C" {

struct ibv_device **ibv_get_device_list(int *num) {
  auto **list = static_cast<ibv_device **>(calloc(2, sizeof(void *)));
  list[0] = reinterpret_cast<ibv_device *>(&g_device_token);
  list[1] = nullptr;
  if (num) *num = 1;
  return list;
}

void ibv_free_device_list(struct ibv_device **list) { free(list); }

const char *ibv_get_device_name(struct ibv_device *dev) {
  (void)dev;
  return "mock0";
}

struct ibv_context *ibv_open_device(struct ibv_device *dev) {
  (void)dev;
  auto *ctx = static_cast<ibv_context *>(calloc(1, sizeof(ibv_context)));
  ctx->ops.poll_cq = mock_poll_cq;
  ctx->ops.post_send = mock_post_send;
  ctx->ops.post_recv = mock_post_recv;
  return ctx;
}

int ibv_close_device(struct ibv_context *ctx) {
  free(ctx);
  return 0;
}

struct ibv_pd *ibv_alloc_pd(struct ibv_context *ctx) {
  auto *pd = static_cast<ibv_pd *>(calloc(1, sizeof(ibv_pd)));
  pd->context = ctx;
  return pd;
}

int ibv_dealloc_pd(struct ibv_pd *pd) {
  free(pd);
  return 0;
}

struct ibv_mr *ibv_reg_mr(struct ibv_pd *pd, void *addr, size_t len,
                          int access) {
  auto *m = new MockMr();
  memset(&m->mr, 0, sizeof(m->mr));
  m->mr.pd = pd;
  m->mr.addr = addr;
  m->mr.length = len;
  m->access = access;
  std::lock_guard<std::mutex> lk(g().mu);
  m->mr.lkey = m->mr.rkey = g().next_key++;
  g().mrs[m->mr.rkey] = m;
  return &m->mr;
}

int ibv_dereg_mr(struct ibv_mr *mr) {
  auto *m = reinterpret_cast<MockMr *>(mr);
  std::lock_guard<std::mutex> lk(g().mu);
  g().mrs.erase(mr->rkey);
  delete m;
  return 0;
}

struct ibv_cq *ibv_create_cq(struct ibv_context *ctx, int cqe, void *arg,
                             struct ibv_comp_channel *ch, int vec) {
  (void)cqe;
  (void)arg;
  (void)ch;
  (void)vec;
  auto *c = new MockCq();
  memset(&c->cq, 0, sizeof(c->cq));
  c->cq.context = ctx;
  std::lock_guard<std::mutex> lk(g().mu);
  g().live_cqs.insert(c);
  return &c->cq;
}

int ibv_destroy_cq(struct ibv_cq *cq) {
  auto *c = reinterpret_cast<MockCq *>(cq);
  std::lock_guard<std::mutex> lk(g().mu);
  g().live_cqs.erase(c);
  delete c;
  return 0;
}

struct ibv_qp *ibv_create_qp(struct ibv_pd *pd,
                             struct ibv_qp_init_attr *attr) {
  auto *q = new MockQp();
  memset(&q->qp, 0, sizeof(q->qp));
  q->qp.context = pd->context;
  q->qp.pd = pd;
  q->scq = reinterpret_cast<MockCq *>(attr->send_cq);
  q->rcq = reinterpret_cast<MockCq *>(attr->recv_cq);
  std::lock_guard<std::mutex> lk(g().mu);
  q->qp.qp_num = g().next_qpn++;
  g().qps[q->qp.qp_num] = q;
  return &q->qp;
}

int ibv_modify_qp(struct ibv_qp *qp, struct ibv_qp_attr *attr, int mask) {
  auto *q = reinterpret_cast<MockQp *>(qp);
  std::lock_guard<std::mutex> lk(g().mu);
  if (mask & IBV_QP_DEST_QPN) q->dest = attr->dest_qp_num;
  if (mask & IBV_QP_STATE) q->qp.state = attr->qp_state;
  return 0;
}

int ibv_destroy_qp(struct ibv_qp *qp) {
  auto *q = reinterpret_cast<MockQp *>(qp);
  std::lock_guard<std::mutex> lk(g().mu);
  g().qps.erase(q->qp.qp_num);
  // RC flush semantics: posted recvs die with the QP.
  for (const PostedRecv &r : q->recvs)
    push_wc(q->rcq, make_wc(r.wr_id, kWcFlushErr, kWcOpRecv, 0));
  delete q;
  return 0;
}

int ibv_query_port(struct ibv_context *ctx, uint8_t port,
                   struct ibv_port_attr *attr) {
  (void)ctx;
  (void)port;
  memset(attr, 0, sizeof(*attr));
  attr->state = IBV_PORT_ACTIVE;
  attr->active_mtu = IBV_MTU_4096;
  attr->max_mtu = IBV_MTU_4096;
  attr->link_layer = IBV_LINK_LAYER_INFINIBAND;
  std::lock_guard<std::mutex> lk(g().mu);
  attr->lid = g().next_lid++;
  return 0;
}

int ibv_query_gid(struct ibv_context *ctx, uint8_t port, int index,
                  union ibv_gid *gid) {
  (void)ctx;
  (void)port;
  (void)index;
  memset(gid, 0, sizeof(*gid));
  return 0;
}

}  // extern "C"
