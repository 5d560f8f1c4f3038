// C API surface of libtdr — thin dispatch onto the backend classes.
#include <cstdlib>
#include <cstring>
#include <string>

#include "common.h"
#include "tdr/tdr.h"

using tdr::Engine;
using tdr::Mr;
using tdr::Qp;

extern "C" {

const char *tdr_last_error(void) { return tdr::get_error(); }

size_t tdr_copy_pool_workers(void) { return tdr::copy_pool_workers(); }

size_t tdr_fold_pool_workers(void) { return tdr::fold_pool_workers(); }

int tdr_progress_shards(int channels) {
  return tdr::progress_shards_for(channels < 1 ? 1 : channels);
}

void tdr_copy_counters(uint64_t *nt_bytes, uint64_t *plain_bytes) {
  tdr::copy_counters(nt_bytes, plain_bytes);
}

/* Fault-plan introspection (fault.cc): per-clause hit counters so a
 * test can assert the injected fault actually fired. */
int tdr_fault_plan_clauses(void) {
  return static_cast<int>(tdr::fault_clause_count());
}

uint64_t tdr_fault_plan_hits(int idx) {
  return idx < 0 ? 0 : tdr::fault_clause_hits(static_cast<size_t>(idx));
}

uint64_t tdr_fault_plan_seen(int idx) {
  return idx < 0 ? 0 : tdr::fault_clause_seen(static_cast<size_t>(idx));
}

void tdr_fault_plan_reset(void) { tdr::fault_plan_reset(); }

/* Sealed-chunk integrity surface: CRC32C for tests, process-wide
 * sealed/verified/failed/retransmitted counters, and the per-engine
 * incarnation context stamped into seals. */
uint32_t tdr_crc32c(const void *data, size_t len, uint32_t seed) {
  return tdr::crc32c(data, len, seed);
}

void tdr_seal_counters(uint64_t out[4]) {
  for (int i = 0; i < 4; i++) out[i] = tdr::seal_counter(i);
}

void tdr_seal_counters_reset(void) { tdr::seal_counters_reset(); }

int tdr_seal_retry_budget(void) { return tdr::seal_retry_budget(); }

void tdr_seal_context(tdr_engine *e, uint64_t gen_plus1, uint64_t step) {
  if (e) reinterpret_cast<Engine *>(e)->set_seal_ctx(gen_plus1, step);
}

int tdr_qp_has_seal(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_seal() ? 1 : 0;
}

int tdr_qp_has_seal_payload(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_seal_payload() ? 1 : 0;
}

int tdr_qp_has_coll_id(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_coll_id() ? 1 : 0;
}

int tdr_qp_has_wire_q8(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_wire_q8() ? 1 : 0;
}

int tdr_qp_probe(tdr_qp *qp, int timeout_ms) {
  return reinterpret_cast<Qp *>(qp)->probe(timeout_ms);
}

void tdr_qp_set_link(tdr_qp *qp, int lane, int rank, int peer) {
  reinterpret_cast<Qp *>(qp)->set_link(lane, rank, peer);
}

tdr_engine *tdr_engine_open(const char *spec) {
  std::string s = spec ? spec : "auto";
  std::string err;
  Engine *e = nullptr;
  if (s == "emu") {
    e = tdr::create_emu_engine(&err);
  } else if (s == "verbs" || s.rfind("verbs:", 0) == 0) {
    std::string dev = s.size() > 6 ? s.substr(6) : "";
    e = tdr::create_verbs_engine(dev, &err);
  } else if (s == "auto") {
    e = tdr::create_verbs_engine("", &err);
    if (!e) e = tdr::create_emu_engine(&err);
  } else {
    tdr::set_error("unknown engine spec: " + s);
    return nullptr;
  }
  if (!e) tdr::set_error("engine_open(" + s + "): " + err);
  return reinterpret_cast<tdr_engine *>(e);
}

void tdr_engine_close(tdr_engine *e) { delete reinterpret_cast<Engine *>(e); }

int tdr_engine_kind(const tdr_engine *e) {
  return reinterpret_cast<const Engine *>(e)->kind();
}

const char *tdr_engine_name(const tdr_engine *e) {
  return reinterpret_cast<const Engine *>(e)->name();
}

tdr_mr *tdr_reg_mr(tdr_engine *e, void *addr, size_t len, int access) {
  return reinterpret_cast<tdr_mr *>(
      reinterpret_cast<Engine *>(e)->reg_mr(addr, len, access));
}

tdr_mr *tdr_reg_dmabuf_mr(tdr_engine *e, int fd, size_t offset, size_t len,
                          uint64_t iova, int access) {
  return reinterpret_cast<tdr_mr *>(
      reinterpret_cast<Engine *>(e)->reg_dmabuf_mr(fd, offset, len, iova,
                                                   access));
}

int tdr_dereg_mr(tdr_mr *mr) {
  Mr *m = reinterpret_cast<Mr *>(mr);
  return m->engine->dereg_mr(m);
}

uint32_t tdr_mr_lkey(const tdr_mr *mr) {
  return reinterpret_cast<const Mr *>(mr)->lkey;
}
uint32_t tdr_mr_rkey(const tdr_mr *mr) {
  return reinterpret_cast<const Mr *>(mr)->rkey;
}
uint64_t tdr_mr_addr(const tdr_mr *mr) {
  return reinterpret_cast<const Mr *>(mr)->addr;
}
uint64_t tdr_mr_len(const tdr_mr *mr) {
  return reinterpret_cast<const Mr *>(mr)->len;
}

int tdr_mr_invalidate(tdr_mr *mr) {
  return reinterpret_cast<Mr *>(mr)->invalidate();
}

int tdr_mr_cpu_foldable(const tdr_mr *mr) {
  return reinterpret_cast<const Mr *>(mr)->cpu_foldable() ? 1 : 0;
}

/* QP bring-up with engine-level budget accounting: the slot is
 * reserved BEFORE the network is touched (an over-budget world fails
 * fast without consuming the peer's accept) and released again when
 * bring-up fails. Budget exhaustion is a configuration condition, not
 * a transient — rebuilding cannot create QP headroom — so the error
 * message deliberately matches no retryable marker. */
namespace {

bool qp_budget_admit(Engine *e) {
  if (e->qp_admit()) return true;
  tdr::set_error("qp budget exhausted: " +
                 std::to_string(e->qp_live.load(std::memory_order_relaxed)) +
                 " live of limit " +
                 std::to_string(e->qp_limit.load(std::memory_order_relaxed)) +
                 " on this engine");
  return false;
}

tdr_qp *qp_budget_finish(Engine *e, Qp *q) {
  if (!q) {
    e->qp_release();
    return nullptr;
  }
  q->owner = e;
  return reinterpret_cast<tdr_qp *>(q);
}

}  // namespace

tdr_qp *tdr_listen(tdr_engine *e, const char *bind_host, int port) {
  return tdr_listen_tier(e, bind_host, port, -1, 0);
}

tdr_qp *tdr_listen_timeout(tdr_engine *e, const char *bind_host, int port,
                           int timeout_ms) {
  return tdr_listen_tier(e, bind_host, port, timeout_ms, 0);
}

tdr_qp *tdr_listen_tier(tdr_engine *e, const char *bind_host, int port,
                        int timeout_ms, int flags) {
  Engine *eng = reinterpret_cast<Engine *>(e);
  if (!qp_budget_admit(eng)) return nullptr;
  return qp_budget_finish(eng,
                          eng->listen(bind_host, port, timeout_ms, flags));
}

tdr_qp *tdr_connect(tdr_engine *e, const char *host, int port,
                    int timeout_ms) {
  return tdr_connect_tier(e, host, port, timeout_ms, 0);
}

tdr_qp *tdr_connect_tier(tdr_engine *e, const char *host, int port,
                         int timeout_ms, int flags) {
  Engine *eng = reinterpret_cast<Engine *>(e);
  if (!qp_budget_admit(eng)) return nullptr;
  return qp_budget_finish(eng, eng->connect(host, port, timeout_ms, flags));
}

int tdr_qp_close(tdr_qp *qp) {
  Qp *q = reinterpret_cast<Qp *>(qp);
  Engine *owner = q->owner;
  delete q;  // dtor performs the close/flush
  if (owner) owner->qp_release();
  return 0;
}

void tdr_engine_set_qp_limit(tdr_engine *e, int limit) {
  if (e)
    reinterpret_cast<Engine *>(e)->qp_limit.store(
        limit < 0 ? 0 : limit, std::memory_order_relaxed);
}

int tdr_engine_qp_limit(const tdr_engine *e) {
  return e ? reinterpret_cast<const Engine *>(e)->qp_limit.load(
                 std::memory_order_relaxed)
           : 0;
}

int tdr_engine_qp_live(const tdr_engine *e) {
  return e ? reinterpret_cast<const Engine *>(e)->qp_live.load(
                 std::memory_order_relaxed)
           : 0;
}

int tdr_post_write(tdr_qp *qp, tdr_mr *lmr, size_t loff, uint64_t raddr,
                   uint32_t rkey, size_t len, uint64_t wr_id) {
  return reinterpret_cast<Qp *>(qp)->post_write(
      reinterpret_cast<Mr *>(lmr), loff, raddr, rkey, len, wr_id);
}

int tdr_post_read(tdr_qp *qp, tdr_mr *lmr, size_t loff, uint64_t raddr,
                  uint32_t rkey, size_t len, uint64_t wr_id) {
  return reinterpret_cast<Qp *>(qp)->post_read(reinterpret_cast<Mr *>(lmr),
                                               loff, raddr, rkey, len, wr_id);
}

int tdr_post_send(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t len,
                  uint64_t wr_id) {
  return reinterpret_cast<Qp *>(qp)->post_send(reinterpret_cast<Mr *>(lmr),
                                               loff, len, wr_id);
}

int tdr_post_recv(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t maxlen,
                  uint64_t wr_id) {
  return reinterpret_cast<Qp *>(qp)->post_recv(reinterpret_cast<Mr *>(lmr),
                                               loff, maxlen, wr_id);
}

int tdr_post_recv_reduce(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t maxlen,
                         int dtype, int red_op, uint64_t wr_id) {
  return reinterpret_cast<Qp *>(qp)->post_recv_reduce(
      reinterpret_cast<Mr *>(lmr), loff, maxlen, dtype, red_op, wr_id);
}

int tdr_qp_has_recv_reduce(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_recv_reduce() ? 1 : 0;
}

int tdr_post_send_foldback(tdr_qp *qp, tdr_mr *lmr, size_t loff, size_t len,
                           uint64_t wr_id) {
  return reinterpret_cast<Qp *>(qp)->post_send_foldback(
      reinterpret_cast<Mr *>(lmr), loff, len, wr_id);
}

int tdr_qp_has_send_foldback(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_send_foldback() ? 1 : 0;
}

int tdr_qp_has_fused2(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->has_fused2() ? 1 : 0;
}

size_t tdr_qp_rr_window(tdr_qp *qp) {
  return reinterpret_cast<Qp *>(qp)->rr_window_hint();
}

int tdr_poll(tdr_qp *qp, tdr_wc *wc, int max, int timeout_ms) {
  return reinterpret_cast<Qp *>(qp)->poll(wc, max, timeout_ms);
}

}  // extern "C"
