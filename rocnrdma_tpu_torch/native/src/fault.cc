// Deterministic fault injection: the TDR_FAULT_PLAN registry.
//
// The one-shot TDR_FAULT_LANDING_DELAY_MS hook proved the emulation
// can force the reference's subtlest interleaving instead of racing
// for it; this generalizes that into a parseable plan that injects
// transient WR failures, connection drops, and stalls at NAMED points,
// with per-clause hit counters exported through the C API so tests can
// assert the fault actually fired (never "the test passed because the
// fault silently failed to arm").
//
// Grammar (documented for users in README.md "Failure semantics"):
//
//   TDR_FAULT_PLAN := clause[,clause...]
//   clause         := site[:match...]:action
//   site           := send | conn | land | ring
//   match          := chunk=K     (send: ring chunk index — the low
//                                  48 bits of the wr_id; land corrupt
//                                  clauses match the frame sequence)
//                     nth=N       (fire on the Nth matching arrival at
//                                  the site, 1-based, process-wide)
//                     lane=K      (netem clauses only: channel lane of
//                                  the QP, as stamped by the ring)
//                     rank=K      (netem clauses only: posting rank)
//                     peer=K      (netem clauses only: remote rank)
//                     tier=T      (netem clauses only: stream | cma)
//   action         := once=STATUS   (send/ring only: inject STATUS
//                                    once, then disarm)
//                     always=STATUS (send/ring only: inject on every
//                                    match)
//                     stall_ms=MS   (any site: sleep MS at the site)
//                     drop_after=N  (conn only: the first N posts go
//                                    through, the next one finds the
//                                    connection dead)
//                     corrupt=N     (send/land only, sealed
//                                    connections: flip N payload
//                                    bytes after sealing on send /
//                                    before verification on land;
//                                    fires on every match — combine
//                                    with nth=K for single-shot)
//   netem riders (site "send" only, applied at frame-transmission
//   time by the emu engine — the tc-netem vocabulary, deterministic):
//                     delay=US[:JIT] (sleep US microseconds before
//                                    transmitting each matched frame;
//                                    an optional bare :JIT token adds
//                                    deterministic jitter in [0,JIT])
//                     reorder=N     (hold the first N matched frames
//                                    so their successor overtakes
//                                    them on the wire)
//                     dup=N         (transmit the first N matched
//                                    frames twice; the receiver gate
//                                    drops the duplicate)
//                     throttle=MBPS (pace matched frames to MBPS
//                                    megabytes/second — the brownout
//                                    rider)
//   Clauses whose action the site cannot apply are rejected at parse
//   time (a counted-but-unapplied injection would be a lie); the same
//   rule rejects lane/rank/peer/tier matches on non-netem clauses
//   (only the emu frame-transmission site knows the link identity) and
//   netem riders mixed with status/corrupt/drop actions.
//   STATUS         := general_err | rem_access_err | loc_access_err |
//                     flush_err
//
// Sites:
//   send — emu post_send / post_send_foldback, before any wire work:
//          an injected status completes the WR with that error instead
//          of transmitting (the transient-WR-failure model).
//   conn — every emu post (write/read/send/foldback): when a
//          drop_after clause fires, the QP's socket is shut down and
//          the post flushes — RC connection loss, deterministically.
//   land — the landing-time window in the emu progress engine (the
//          generalization of TDR_FAULT_LANDING_DELAY_MS, which is
//          still honored).
//   ring — entry of tdr_ring_allreduce: an injected status fails the
//          collective call before any posting (a transient collective
//          fault the elastic layer must recover from).
//
// Counters are PROCESS-WIDE (all engines/QPs share the registry), so
// nth=N is deterministic under single-threaded posting and
// deterministic-at-collective-granularity when ranks share a process.
// The plan is parsed once, lazily; tdr_fault_plan_reset() re-reads the
// environment (tests set the plan, then reset).

#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <atomic>
#include <chrono>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "common.h"

namespace tdr {
namespace {

struct FaultClause {
  std::string spec;  // original text, for diagnostics
  std::string site;
  long long chunk = -1;       // match: wr_id low 48 bits
  long long nth = -1;         // match: Nth arrival (1-based)
  long long drop_after = -1;  // conn: posts that survive
  long long stall_ms = 0;
  long long corrupt = -1;     // send/land: payload bytes to flip
  bool once = false;
  int status = -1;  // TDR_WC_* to inject
  // Netem riders (site "send", frame-transmission time).
  long long delay_us = -1;       // fixed pre-transmit delay
  long long jitter_us = 0;       // deterministic jitter on top of delay
  long long reorder = -1;        // frames to hold behind their successor
  long long dup = -1;            // frames to duplicate
  long long throttle_mbps = -1;  // pace matched frames to this rate
  // Netem link matches (-1 = any).
  long long lane = -1;
  long long rank = -1;
  long long peer = -1;
  int tier = -1;  // 0 = stream, 1 = cma
  // Runtime state (guarded by g_mu).
  uint64_t seen = 0;
  uint64_t hits = 0;
  bool spent = false;
  uint64_t pace_ns = 0;      // throttle pacer horizon (steady clock)
  uint64_t reorder_used = 0;  // holds reserved (committed or in flight)
  uint64_t dup_used = 0;

  bool netem() const {
    return delay_us >= 0 || reorder >= 1 || dup >= 1 || throttle_mbps >= 1;
  }
};

std::mutex g_mu;                  // guards g_clauses and their counters
std::vector<FaultClause> g_clauses;
bool g_parsed = false;
std::atomic<bool> g_init{false};  // fast-path gate: plan parsed at all
std::atomic<bool> g_active{false};
std::atomic<bool> g_netem{false};  // fast-path gate: any netem rider armed
// Plan generation: bumped on every (re)parse so a reorder commit from
// a hold reserved against an older plan cannot touch the counters of
// whatever clause now sits at that index.
std::atomic<uint64_t> g_plan_gen{0};

int status_by_name(const std::string &name) {
  if (name == "general_err") return TDR_WC_GENERAL_ERR;
  if (name == "rem_access_err") return TDR_WC_REM_ACCESS_ERR;
  if (name == "loc_access_err") return TDR_WC_LOC_ACCESS_ERR;
  if (name == "flush_err") return TDR_WC_FLUSH_ERR;
  return -1;
}

bool parse_ll(const std::string &v, long long *out) {
  if (v.empty()) return false;
  char *end = nullptr;
  long long r = strtoll(v.c_str(), &end, 10);
  if (!end || *end) return false;
  *out = r;
  return true;
}

// One clause: site[:k=v...]. Returns false (and warns) on bad specs so
// a typo'd plan is loud, not a silently green test.
bool parse_clause(const std::string &text, FaultClause *c) {
  c->spec = text;
  size_t pos = 0;
  bool first = true;
  bool after_delay = false;  // a bare numeric token after delay= is jitter
  while (pos <= text.size()) {
    size_t colon = text.find(':', pos);
    std::string tok = text.substr(
        pos, colon == std::string::npos ? std::string::npos : colon - pos);
    pos = colon == std::string::npos ? text.size() + 1 : colon + 1;
    if (tok.empty()) continue;
    if (first) {
      first = false;
      if (tok != "send" && tok != "conn" && tok != "land" && tok != "ring")
        return false;
      c->site = tok;
      continue;
    }
    size_t eq = tok.find('=');
    if (eq == std::string::npos) {
      // delay=US:JIT — ':' is the clause-token separator, so the
      // jitter arrives as a bare numeric token right after delay=.
      if (after_delay && parse_ll(tok, &c->jitter_us) && c->jitter_us >= 0) {
        after_delay = false;
        continue;
      }
      return false;
    }
    after_delay = false;
    std::string key = tok.substr(0, eq), val = tok.substr(eq + 1);
    if (key == "chunk") {
      if (!parse_ll(val, &c->chunk) || c->chunk < 0) return false;
    } else if (key == "nth") {
      if (!parse_ll(val, &c->nth) || c->nth < 1) return false;
    } else if (key == "drop_after") {
      if (!parse_ll(val, &c->drop_after) || c->drop_after < 0) return false;
    } else if (key == "stall_ms") {
      if (!parse_ll(val, &c->stall_ms) || c->stall_ms < 0) return false;
    } else if (key == "corrupt") {
      if (!parse_ll(val, &c->corrupt) || c->corrupt < 1) return false;
    } else if (key == "delay") {
      if (!parse_ll(val, &c->delay_us) || c->delay_us < 0) return false;
      after_delay = true;
    } else if (key == "reorder") {
      if (!parse_ll(val, &c->reorder) || c->reorder < 1) return false;
    } else if (key == "dup") {
      if (!parse_ll(val, &c->dup) || c->dup < 1) return false;
    } else if (key == "throttle") {
      if (!parse_ll(val, &c->throttle_mbps) || c->throttle_mbps < 1)
        return false;
    } else if (key == "lane") {
      if (!parse_ll(val, &c->lane) || c->lane < 0) return false;
    } else if (key == "rank") {
      if (!parse_ll(val, &c->rank) || c->rank < 0) return false;
    } else if (key == "peer") {
      if (!parse_ll(val, &c->peer) || c->peer < 0) return false;
    } else if (key == "tier") {
      if (val == "stream")
        c->tier = 0;
      else if (val == "cma")
        c->tier = 1;
      else
        return false;
    } else if (key == "once" || key == "always") {
      c->status = status_by_name(val);
      if (c->status < 0) return false;
      c->once = (key == "once");
    } else {
      return false;
    }
  }
  // Per-site capability validation: a clause whose action the site
  // cannot apply must be REJECTED at parse time — otherwise its hit
  // counter would report an injection that never happened (the exact
  // lie the counters exist to prevent). Status injections exist at
  // send (WR completion) and ring (collective entry); conn drops
  // connections; land (and every site) can stall.
  if (c->status >= 0 && c->site != "send" && c->site != "ring")
    return false;
  if (c->drop_after >= 0 && c->site != "conn") return false;
  // corrupt flips payload bytes — only sites that carry a payload can
  // apply it, and a clause mixing it with a status injection would
  // make either counter a half-truth.
  if (c->corrupt >= 0 &&
      (c->site == "conn" || c->site == "ring" || c->status >= 0))
    return false;
  // Netem riders exist only at the emu frame-transmission site ("send"
  // is the name; they are evaluated by fault_netem, never fault_point)
  // and cannot share a clause with a status/corrupt/drop action — one
  // clause, one behavior, one truthful counter.
  if (c->netem() &&
      (c->site != "send" || c->status >= 0 || c->corrupt >= 0 ||
       c->drop_after >= 0 || c->stall_ms > 0))
    return false;
  // jitter without delay is meaningless; link matches require a netem
  // action (fault_point carries no link identity — a lane= match on a
  // plain send clause would arm a clause that can never fire).
  if (c->jitter_us > 0 && c->delay_us < 0) return false;
  if ((c->lane >= 0 || c->rank >= 0 || c->peer >= 0 || c->tier >= 0) &&
      !c->netem())
    return false;
  // A clause must DO something.
  return c->status >= 0 || c->stall_ms > 0 || c->drop_after >= 0 ||
         c->corrupt >= 1 || c->netem();
}

void parse_locked() {
  g_clauses.clear();
  g_parsed = true;
  const char *env = getenv("TDR_FAULT_PLAN");
  if (env && *env) {
    std::string plan(env);
    size_t pos = 0;
    while (pos <= plan.size()) {
      size_t comma = plan.find(',', pos);
      std::string text = plan.substr(
          pos, comma == std::string::npos ? std::string::npos : comma - pos);
      pos = comma == std::string::npos ? plan.size() + 1 : comma + 1;
      if (text.empty()) continue;
      FaultClause c;
      if (parse_clause(text, &c)) {
        g_clauses.push_back(std::move(c));
      } else {
        fprintf(stderr, "tdr: ignoring bad TDR_FAULT_PLAN clause '%s'\n",
                text.c_str());
      }
    }
  }
  g_active.store(!g_clauses.empty(), std::memory_order_release);
  bool netem = false;
  for (const auto &c : g_clauses) netem = netem || c.netem();
  g_netem.store(netem, std::memory_order_release);
  g_plan_gen.fetch_add(1, std::memory_order_acq_rel);
}

void ensure_parsed() {
  if (g_init.load(std::memory_order_acquire)) return;
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_parsed) parse_locked();
  g_init.store(true, std::memory_order_release);
}

}  // namespace

int fault_point(const char *site, long long chunk) {
  ensure_parsed();
  if (!g_active.load(std::memory_order_acquire)) return TDR_FAULT_NONE;
  long long stall = 0;
  int inject = TDR_FAULT_NONE;
  {
    std::lock_guard<std::mutex> g(g_mu);
    for (auto &c : g_clauses) {
      // Corrupt clauses are evaluated exclusively by fault_corrupt
      // (at frame-transmission / payload-landing time) and netem
      // clauses exclusively by fault_netem; visiting either here
      // would double-count their arrivals.
      if (c.corrupt >= 0 || c.netem()) continue;
      if (c.site != site) continue;
      if (c.chunk >= 0 && chunk != c.chunk) continue;
      c.seen++;
      if (c.nth >= 1 && static_cast<long long>(c.seen) != c.nth) continue;
      if (c.drop_after >= 0) {
        // The first drop_after arrivals pass; the next one drops the
        // connection (fires once — the dead socket handles the rest).
        if (static_cast<long long>(c.seen) <= c.drop_after || c.spent)
          continue;
        c.spent = true;
        c.hits++;
        if (inject == TDR_FAULT_NONE) inject = TDR_FAULT_DROP;
        continue;
      }
      if (c.once && c.spent) continue;
      if (c.once) c.spent = true;
      c.hits++;
      stall += c.stall_ms;
      if (c.status >= 0 && inject == TDR_FAULT_NONE) inject = c.status;
    }
  }
  if (stall > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(stall));
  return inject;
}

long long fault_corrupt(const char *site, long long chunk) {
  ensure_parsed();
  if (!g_active.load(std::memory_order_acquire)) return 0;
  long long stall = 0;
  long long nbytes = 0;
  {
    std::lock_guard<std::mutex> g(g_mu);
    for (auto &c : g_clauses) {
      if (c.corrupt < 1) continue;  // the corrupt-only pass
      if (c.site != site) continue;
      if (c.chunk >= 0 && chunk != c.chunk) continue;
      c.seen++;
      if (c.nth >= 1 && static_cast<long long>(c.seen) != c.nth) continue;
      c.hits++;
      stall += c.stall_ms;
      if (nbytes == 0) nbytes = c.corrupt;
    }
  }
  if (stall > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(stall));
  return nbytes;
}

namespace {

uint64_t steady_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

// Jitter seed: the PR 6 seeded-rng convention (TDR_REBUILD_SEED is the
// fleet's one determinism knob) folded down to 64 bits — same seed,
// same rider jitter, every run.
uint64_t jitter_seed() {
  static const uint64_t seed = [] {
    uint64_t h = 0x9e3779b97f4a7c15ull;
    if (const char *env = getenv("TDR_REBUILD_SEED")) {
      for (const char *p = env; *p; ++p)
        h = mix64(h ^ static_cast<uint64_t>(static_cast<unsigned char>(*p)));
    }
    return h;
  }();
  return seed;
}

}  // namespace

bool fault_netem_armed() {
  ensure_parsed();
  return g_netem.load(std::memory_order_acquire);
}

bool fault_netem(long long chunk, int tier_cma, int lane, int rank,
                 int peer, unsigned long long bytes, NetemAction *out) {
  ensure_parsed();
  if (!g_netem.load(std::memory_order_acquire)) return false;
  bool any = false;
  long long delay = 0;
  {
    std::lock_guard<std::mutex> g(g_mu);
    uint64_t gen = g_plan_gen.load(std::memory_order_relaxed);
    for (size_t i = 0; i < g_clauses.size(); ++i) {
      FaultClause &c = g_clauses[i];
      if (!c.netem()) continue;
      if (c.chunk >= 0 && chunk != c.chunk) continue;
      if (c.lane >= 0 && lane != c.lane) continue;
      if (c.rank >= 0 && rank != c.rank) continue;
      if (c.peer >= 0 && peer != c.peer) continue;
      if (c.tier >= 0 && tier_cma != c.tier) continue;
      c.seen++;
      if (c.nth >= 1 && static_cast<long long>(c.seen) != c.nth) continue;
      if (c.delay_us >= 0) {
        long long d = c.delay_us;
        if (c.jitter_us > 0)
          d += static_cast<long long>(
              mix64(jitter_seed() ^ (i * 0x632be59bd9b4e019ull) ^ c.seen) %
              static_cast<uint64_t>(c.jitter_us + 1));
        if (d > 0) {
          c.hits++;
          delay += d;
          any = true;
        }
      }
      if (c.throttle_mbps >= 1) {
        // Token-bucket-free pacer: each matched frame pushes the
        // clause's horizon out by its serialization time at the
        // configured rate; the sender sleeps until its start slot.
        // bytes/(MB/s) = bytes*1000 ns.
        uint64_t now = steady_ns();
        uint64_t start = c.pace_ns > now ? c.pace_ns : now;
        uint64_t dur =
            bytes * 1000ull / static_cast<uint64_t>(c.throttle_mbps);
        c.pace_ns = start + dur;
        long long wait_us = static_cast<long long>((start - now) / 1000);
        if (wait_us > 0) {
          c.hits++;
          delay += wait_us;
          any = true;
        }
      }
      if (c.dup >= 1 && c.dup_used < static_cast<uint64_t>(c.dup)) {
        c.dup_used++;
        c.hits++;
        out->dup = true;
        any = true;
      }
      if (c.reorder >= 1 &&
          c.reorder_used < static_cast<uint64_t>(c.reorder) &&
          out->reorder_clause < 0) {
        // Reserve only: hits advances at commit time, when the hold
        // provably produced an out-of-order transmission (an
        // order-preserving flush refunds the reservation instead).
        c.reorder_used++;
        out->reorder = true;
        out->reorder_clause = static_cast<int>(i);
        out->plan_gen = gen;
        any = true;
      }
    }
  }
  out->delay_us = delay;
  return any;
}

void fault_netem_commit(int clause_idx, uint64_t plan_gen, bool swapped) {
  if (clause_idx < 0) return;
  std::lock_guard<std::mutex> g(g_mu);
  if (plan_gen != g_plan_gen.load(std::memory_order_relaxed)) return;
  if (static_cast<size_t>(clause_idx) >= g_clauses.size()) return;
  FaultClause &c = g_clauses[clause_idx];
  if (swapped)
    c.hits++;
  else if (c.reorder_used > 0)
    c.reorder_used--;
}

void fault_land_delay() {
  // Legacy one-shot knob, kept working: the free-while-landing window
  // widener the fault plan generalizes.
  const char *env = getenv("TDR_FAULT_LANDING_DELAY_MS");
  if (env && *env) {
    int ms = atoi(env);
    if (ms > 0) std::this_thread::sleep_for(std::chrono::milliseconds(ms));
  }
  fault_point("land");
}

size_t fault_clause_count() {
  ensure_parsed();
  std::lock_guard<std::mutex> g(g_mu);
  return g_clauses.size();
}

uint64_t fault_clause_hits(size_t idx) {
  ensure_parsed();
  std::lock_guard<std::mutex> g(g_mu);
  return idx < g_clauses.size() ? g_clauses[idx].hits : 0;
}

uint64_t fault_clause_seen(size_t idx) {
  ensure_parsed();
  std::lock_guard<std::mutex> g(g_mu);
  return idx < g_clauses.size() ? g_clauses[idx].seen : 0;
}

void fault_totals(uint64_t *seen, uint64_t *hits) {
  ensure_parsed();
  std::lock_guard<std::mutex> g(g_mu);
  uint64_t s = 0, h = 0;
  for (const auto &c : g_clauses) {
    s += c.seen;
    h += c.hits;
  }
  if (seen) *seen = s;
  if (hits) *hits = h;
}

uint64_t fault_total_hits() {
  uint64_t h = 0;
  fault_totals(nullptr, &h);
  return h;
}

uint64_t fault_total_seen() {
  uint64_t s = 0;
  fault_totals(&s, nullptr);
  return s;
}

void fault_plan_reset() {
  std::lock_guard<std::mutex> g(g_mu);
  parse_locked();
  g_init.store(true, std::memory_order_release);
}

}  // namespace tdr
