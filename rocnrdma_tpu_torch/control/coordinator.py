"""Rendezvous coordinator: named worlds, leases, arbitrated rejoin (the
port's own copy of ``rocnrdma_tpu/control/coordinator.py``).

A small single-process TCP service (stdlib-only) that owns the
lifecycle state the pairwise bootstrap used to infer per rank: it
names worlds, hands out ring positions, base ports, and generation
numbers, and arbitrates elastic rejoin. "The DMA Streaming Framework"
discipline applied to membership: ONE owner of lifecycle state instead
of N peers independently guessing the next generation.

**Model.** A *world* is a named, multi-tenant resource: fixed size,
a base port carved from the coordinator's port pool (so two jobs
sharing a NIC never fight for listen ports), a monotonic generation,
and one member slot per ring position. Members hold *leases* renewed
by heartbeats; a member that misses its lease is declared dead by the
coordinator — never by a peer's guess — which bumps the generation.
Generation bumps happen in exactly three places, all here: a lease
expiry, a membership change (rejoin/supersede/leave) after the world
first became ready, and a member's failure report. Ranks NEVER bump
locally on the arbitrated path.

**Rendezvous barrier.** ``join`` (new/restarted member) and ``sync``
(surviving member re-rendezvousing during rebuild) both park the
caller at the world's barrier. When every slot is filled by a live
member and all of them are parked, the coordinator atomically builds
ONE membership view — generation, epoch, base port, peer hosts — and
answers every parked member with it. Two ranks can therefore never
act on different views of the same incarnation; the epoch is the view
counter and is stamped (with the generation) into the schedule digest
by the member side.

**Wire protocol.** One JSON object per line, one request per
connection; the response is one JSON line. The same port also answers
``GET /metrics`` (and ``GET /healthz``) with a Prometheus-style text
exposition: coordinator state (generation, members, rebuilds, lease
expiries) plus the member-pushed native counter registry and log2
histograms (heartbeats carry snapshots), rendered as ``tdr_*`` series
with per-world labels — chunk p99, retransmit rate, NAK count, and
rebuild count become scrapeable SLOs.

In-process caveat: multi-rank test harnesses run many members in one
process, which share one process-wide native registry — summed
counter series over-count by the member multiplier there. Production
members are one process each, where the sum is exact.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from rocnrdma_tpu_torch.telemetry.recorder import hist_percentile
from rocnrdma_tpu_torch.utils.trace import trace

# Histograms surfaced as quantile series on /metrics (names match the
# native recorder's tdr_tel_hist_name table).
_QUANTILES = (50, 90, 99)

# Protocol / metrics contract version (served on /metrics so scrapers
# can pin the names they parse).
PROTOCOL_VERSION = 1


class _Member:
    __slots__ = ("rank", "incarnation", "host", "host_key",
                 "lease_deadline", "alive", "waiting", "pending_view",
                 "counters", "hists", "wait_token", "clock_offset_ns",
                 "clock_rtt_ns", "postmortems", "qp_reserved", "hb_last",
                 "link_health", "degraded_total")

    def __init__(self, rank: int, incarnation: int, host: str,
                 lease_deadline: float, host_key: Optional[str] = None):
        self.rank = rank
        self.incarnation = incarnation
        self.host = host
        # Topology key (which physical host this member sits on) —
        # reported at join, released to every member in the view so
        # the hierarchical grouping is a coordinator decision, not a
        # per-rank env guess. None when the member reported none — the
        # dial address is deliberately NOT a fallback (locality
        # inferred from connect addresses flips algorithms under
        # NAT/multi-homing); a view with any keyless slot is ignored
        # by the member-side topology resolution.
        self.host_key = None if host_key is None else str(host_key)
        self.lease_deadline = lease_deadline
        self.alive = True
        self.waiting = False
        self.pending_view: Optional[Dict[str, Any]] = None
        self.counters: Dict[str, int] = {}
        self.hists: Dict[str, Dict[int, int]] = {}
        # Park token: a re-issued sync for this member bumps it, so an
        # ORPHANED handler (client gave up and retried; its connection
        # is dead) stops waiting instead of racing the live retry for
        # the released view.
        self.wait_token = 0
        # Heartbeat-pushed observability riders: the member's min-RTT
        # clock-offset estimate vs this coordinator (what fleet trace
        # merges align timestamps with; served as
        # tdr_clock_offset_us{world=,rank=}) and the postmortem
        # bundles it has written (summed into
        # tdr_postmortems_total{world=}).
        self.clock_offset_ns = 0
        self.clock_rtt_ns = 0
        self.postmortems = 0
        # QP appetite this member reserved at bring-up (flat ring +
        # hierarchical tier rings; heartbeat-pushed, served as
        # tdr_ctl_qp_reserved{world=}).
        self.qp_reserved = 0
        # Last accepted heartbeat instant (monotonic) — the per-member
        # state behind the optional heartbeat rate limit.
        self.hb_last = 0.0
        # Degradation-ladder riders: this member's per-link health
        # snapshot ({link: {peer, score, degraded, faults}}) and its
        # rung-engagement tally — the slow-rank quarantine report,
        # served as tdr_link_health{world=,rank=,peer=} and summed
        # into tdr_degraded_total{world=}.
        self.link_health: Dict[str, Dict[str, Any]] = {}
        self.degraded_total = 0


class _World:
    __slots__ = ("name", "size", "base_port", "qp_budget", "generation",
                 "epoch", "members", "ever_ready", "rebuilds",
                 "lease_expiries", "joins", "trace_req", "trace_seq",
                 "resizable", "max_size", "resizes", "weight",
                 "qp_share", "admission_rejects", "hb_throttled",
                 "grow_hold_until")

    def __init__(self, name: str, size: int, base_port: int,
                 qp_budget: int):
        self.name = name
        self.size = size
        self.base_port = base_port
        self.qp_budget = qp_budget
        self.generation = 0
        self.epoch = 0  # view counter: bumps once per barrier release
        self.members: Dict[int, _Member] = {}
        self.ever_ready = False
        self.rebuilds = 0
        self.lease_expiries = 0
        self.joins = 0
        # ---- Elastic membership (RESIZE) ----
        # Sticky opt-in (first join's ``resizable`` field): a lease
        # expiry or leave after first-ready cuts a world_size-1 view
        # to the survivors instead of waiting for a rejoin, and a
        # joiner on a full world parks for a world_size+1 view.
        self.resizable = False
        self.max_size = 0  # grow ceiling (0 = unbounded)
        self.resizes = 0
        # Batch admission: deadline (monotonic) until which a
        # pure-growth RESIZE is held open so near-simultaneous grow
        # joiners coalesce into ONE size+N cut. 0 = no hold pending.
        self.grow_hold_until = 0.0
        # ---- Admission control ----
        self.weight = 1.0   # fair-share weight (first join's ``weight``)
        self.qp_share = qp_budget  # computed fair share (gauge)
        self.admission_rejects = 0
        self.hb_throttled = 0
        # Pending collect_trace pull: {"id", "max_events", "segments":
        # {rank: segment}} — heartbeats see the flag and push; the
        # parked collector wakes when every live rank reported.
        self.trace_req: Optional[Dict[str, Any]] = None
        self.trace_seq = 0

    def alive_members(self) -> List[_Member]:
        return [m for m in self.members.values() if m.alive]


class Coordinator:
    """The rendezvous service. ``start()`` binds and serves from
    daemon threads; ``stop()`` tears down. Thread-per-connection —
    parked rendezvous calls hold their connection, everything else is
    one short request."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 lease_ms: int = 5000, port_base: int = 36000,
                 port_stride: int = 64, qp_budget: int = 0,
                 qp_fair: bool = False, qp_floor: int = 0,
                 snapshot_dir: Optional[str] = None,
                 snapshot_interval_s: float = 2.0,
                 restore: bool = False,
                 hb_min_interval_ms: int = 0,
                 scrape_min_interval_ms: int = 0,
                 max_worlds: int = 0,
                 grow_hold_ms: int = 250):
        self.host = host
        self.lease_ms = int(lease_ms)
        self.port_base = int(port_base)
        self.port_stride = int(port_stride)
        self.qp_budget = int(qp_budget)
        # Admission control: with qp_fair, ``qp_budget`` is the TOTAL
        # engine pool divided across named worlds by weight (floored
        # at qp_floor); without it, every world gets the full budget
        # (the pre-fair-share per-world semantics, default).
        self.qp_fair = bool(qp_fair)
        self.qp_floor = int(qp_floor)
        self.max_worlds = int(max_worlds)
        # Batch admission: how long a pure-growth RESIZE is held open
        # so a burst of grow joiners lands in ONE size+N view change
        # instead of N back-to-back rebuild-equivalent cuts. 0 keeps
        # the immediate-cut behavior.
        self._grow_hold_s = max(0.0, int(grow_hold_ms) / 1000.0)
        self._hb_min_s = max(0.0, int(hb_min_interval_ms) / 1000.0)
        self._scrape_min_s = max(0.0,
                                 int(scrape_min_interval_ms) / 1000.0)
        self._last_scrape = 0.0
        self._scrape_throttled = 0
        # Coordinator redundancy: periodic full-state snapshots to
        # snapshot_dir (TDR_CTL_SNAPSHOT_DIR env fallback); restore=True
        # resumes arbitration from the latest one — members re-attach
        # via heartbeat re-registration, no full re-rendezvous.
        if snapshot_dir is None:
            snapshot_dir = os.environ.get("TDR_CTL_SNAPSHOT_DIR") or None
        self.snapshot_dir = snapshot_dir
        self.snapshot_interval_s = max(0.1, float(snapshot_interval_s))
        self._last_snapshot = 0.0  # wall time of the last dump
        self.failovers = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._worlds: Dict[str, _World] = {}
        self._next_inc = 1
        snap = self._load_snapshot(snapshot_dir) if restore else None
        if snap is not None and port == 0:
            # A restored coordinator must come back at the address the
            # fleet already dials: adopt the snapshot's port unless the
            # caller pinned one explicitly.
            port = int(snap.get("port", 0))
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._threads: List[threading.Thread] = []
        if snap is not None:
            self._restore_state(snap)

    # ------------------------------------------------------- lifecycle

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "Coordinator":
        workers = [(self._serve, "tdr-ctl-accept"),
                   (self._sweep, "tdr-ctl-sweeper")]
        if self.snapshot_dir:
            workers.append((self._snapshots, "tdr-ctl-snapshot"))
        for target, name in workers:
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        trace.event("ctl.coordinator", address=self.address,
                    lease_ms=self.lease_ms, failovers=self.failovers)
        return self

    def stop(self) -> None:
        self._stop.set()
        # A blocked accept() pins the listen socket past close() (the
        # in-flight syscall holds the file open), so the port would
        # stay bound and a restore/standby rebind on the SAME address
        # would EADDRINUSE. Poke the listener with a throwaway
        # connection so the accept thread observes the stop flag.
        try:
            with socket.create_connection((self.host, self.port),
                                          timeout=1):
                pass
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._cv:
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        if self.snapshot_dir:
            # Final dump so a clean shutdown leaves a restorable image
            # (a SIGKILL relies on the last periodic one instead).
            try:
                self.snapshot_now()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------- serving

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="tdr-ctl-conn")
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(300)
            f = conn.makefile("rwb")
            line = f.readline()
            if not line:
                return
            if line.startswith(b"GET "):
                self._handle_http(f, line)
                return
            try:
                req = json.loads(line.decode())
                resp = self._dispatch(req)
            except Exception as e:  # malformed request must not kill us
                resp = {"ok": False, "error": f"bad request: {e}"}
            f.write((json.dumps(resp) + "\n").encode())
            f.flush()
        except (OSError, ValueError):
            pass  # client went away; its member state ages out by lease
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle_http(self, f, request_line: bytes) -> None:
        path = request_line.split()[1].decode() if len(
            request_line.split()) > 1 else "/"
        while True:  # drain headers
            h = f.readline()
            if not h or h in (b"\r\n", b"\n"):
                break
        if path.startswith("/metrics"):
            now = time.monotonic()
            with self._lock:
                throttled = (self._scrape_min_s > 0.0 and
                             now - self._last_scrape < self._scrape_min_s)
                if throttled:
                    self._scrape_throttled += 1
                else:
                    self._last_scrape = now
            if throttled:
                # Admission control on the scrape path: a hot scraper
                # gets a deterministic backoff, not the render cost.
                body = (f"retry after "
                        f"{self._scrape_min_s:.3f}s\n").encode()
                status = "429 Too Many Requests"
            else:
                body = self.render_metrics().encode()
                status = "200 OK"
        elif path.startswith("/healthz"):
            body = b"ok\n"
            status = "200 OK"
        else:
            body = b"not found\n"
            status = "404 Not Found"
        f.write((f"HTTP/1.0 {status}\r\n"
                 "Content-Type: text/plain; version=0.0.4; "
                 "charset=utf-8\r\n"
                 f"Content-Length: {len(body)}\r\n"
                 "Connection: close\r\n\r\n").encode())
        f.write(body)
        f.flush()

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        handler = {
            "join": self._op_join,
            "sync": self._op_sync,
            "report": self._op_report,
            "heartbeat": self._op_heartbeat,
            "leave": self._op_leave,
            "collect_trace": self._op_collect_trace,
            "trace_push": self._op_trace_push,
        }.get(op)
        if handler is None:
            return {"ok": False, "error": f"unknown op: {op}"}
        return handler(req)

    # ----------------------------------------------------- arbitration

    def _alloc_inc(self) -> int:
        """Monotonic incarnation numbers (under the lock). A plain
        counter rather than itertools so snapshots can persist it — a
        restored coordinator must never re-issue a live incarnation."""
        v = self._next_inc
        self._next_inc += 1
        return v

    def _get_world(self, name: str, size: int,
                   req: Optional[Dict[str, Any]] = None) -> _World:
        w = self._worlds.get(name)
        if w is None:
            base = self.port_base + len(self._worlds) * self.port_stride
            w = _World(name, size, base, self.qp_budget)
            if req is not None:
                # Sticky world-scoped knobs, set by the FIRST join:
                # elastic opt-in, grow ceiling, fair-share weight.
                w.resizable = bool(req.get("resizable"))
                try:
                    w.max_size = max(0, int(req.get("max_size") or 0))
                except (TypeError, ValueError):
                    pass
                try:
                    w.weight = max(0.0, float(req.get("weight", 1.0)))
                except (TypeError, ValueError):
                    pass
            self._worlds[name] = w
            self._recompute_shares()
            trace.event("ctl.world", world=name, size=size, base_port=base,
                        resizable=int(w.resizable))
        return w

    def _recompute_shares(self) -> None:
        """Weighted fair-share division of the engine QP pool across
        named worlds, with per-world floors. Without qp_fair every
        world's share IS the per-world budget (stricter-wins at the
        member keeps working unchanged); with it the total divides by
        weight, and a new world's arrival re-divides — existing worlds
        adopt their new share at the next view they park for."""
        if not self.qp_fair or not self.qp_budget or not self._worlds:
            for w in self._worlds.values():
                w.qp_share = w.qp_budget
            return
        total_weight = sum(w.weight for w in self._worlds.values()) or 1.0
        for w in self._worlds.values():
            share = int(self.qp_budget * w.weight / total_weight)
            w.qp_share = max(self.qp_floor, share)

    def _apply_resize(self, w: _World) -> None:
        """Cut the RESIZE: repack the parked survivors (and any parked
        grow joiners) into contiguous ranks 0..n-1 ordered by their old
        rank, drop dead members entirely (their superseded pushes are
        rejected from here on, never re-adopted), and bump the
        generation — the new size is a membership decision like any
        other. Callers release the view immediately after, so the
        resize and its first view are one atomic arbitration step."""
        alive = sorted(w.alive_members(), key=lambda m: m.rank)
        old_size, old_ranks = w.size, [m.rank for m in alive]
        w.members = {}
        for i, m in enumerate(alive):
            m.rank = i
            w.members[i] = m
        w.size = len(alive)
        w.resizes += 1
        w.generation += 1
        trace.add("ctl.resize", 1)
        trace.event("ctl.resize", world=w.name, old_size=old_size,
                    new_size=w.size, old_ranks=old_ranks,
                    generation=w.generation, resizes=w.resizes)

    def _membership_changed(self, w: _World, why: str) -> None:
        """A slot's occupancy changed. Before the world ever became
        ready this is just the initial fill; afterwards it is a
        membership decision and bumps the generation (the ONLY place
        generations move besides failure reports)."""
        if w.ever_ready:
            w.generation += 1
            trace.event("ctl.generation", world=w.name,
                        generation=w.generation, why=why)

    def _maybe_release(self, w: _World) -> None:
        """Release the rendezvous barrier: every slot filled by a live
        member and all of them parked -> build ONE view and hand it to
        every one of them atomically (under the lock), so no two
        members can ever act on different views."""
        alive = w.alive_members()
        if not alive or not all(m.waiting for m in alive):
            return
        if {m.rank for m in alive} != set(range(w.size)):
            # Membership does not match the nominal shape: dead slots
            # (shrink candidates) or parked joiners beyond the size
            # (grow candidates). A resizable, once-ready world cuts a
            # RESIZE view to exactly the parked survivors; any other
            # world keeps waiting for the missing slots to rejoin.
            if not (w.resizable and w.ever_ready and len(alive) >= 2):
                return
            if w.grow_hold_until and \
                    set(range(w.size)) <= {m.rank for m in alive}:
                # Pure growth (every nominal slot alive, the only
                # mismatch is parked grow joiners): hold the RESIZE
                # open for the coalescing window so near-simultaneous
                # joiners land in one size+N cut — the sweeper calls
                # back when the hold expires. A shrink (dead nominal
                # slot) never waits.
                if time.monotonic() < w.grow_hold_until:
                    return
                w.grow_hold_until = 0.0
            self._apply_resize(w)
            alive = w.alive_members()
        w.epoch += 1
        if w.ever_ready:
            # Every re-release after the world first became ready IS a
            # completed rebuild — the SLO counts finished recoveries,
            # whatever initiated them (failure report, lease expiry,
            # supersede). Reports only move the generation.
            w.rebuilds += 1
        w.ever_ready = True
        now = time.monotonic()
        view = {
            "ok": True,
            "generation": w.generation,
            "epoch": w.epoch,
            "base_port": w.base_port,
            "world_size": w.size,
            "resizes": w.resizes,
            "lease_ms": self.lease_ms,
            "qp_budget": w.qp_share if self.qp_fair else w.qp_budget,
            "peers": [w.members[r].host for r in range(w.size)],
            # One topology key per slot (join-reported; None for
            # members that reported none): the member side feeds these
            # to the hierarchical grouping when no explicit
            # topology/TDR_TOPOLOGY overrides — and only when EVERY
            # slot carries a key.
            "host_keys": [w.members[r].host_key for r in range(w.size)],
        }
        for m in alive:
            m.waiting = False
            m.pending_view = dict(view, rank=m.rank,
                                  incarnation=m.incarnation)
            m.lease_deadline = now + self.lease_ms / 1000.0
        trace.event("ctl.release", world=w.name, generation=w.generation,
                    epoch=w.epoch)
        self._cv.notify_all()

    def _await_view(self, w: _World, m: _Member,
                    timeout_s: float) -> Dict[str, Any]:
        token = m.wait_token
        deadline = time.monotonic() + timeout_s
        while m.pending_view is None:
            if not m.alive:
                return {"ok": False, "error": "superseded",
                        "generation": w.generation}
            if m.wait_token != token:
                # A newer sync for this member took over the park;
                # this handler's client is gone. Don't touch
                # waiting/pending_view — they belong to the newcomer.
                return {"ok": False, "error": "superseded wait",
                        "generation": w.generation}
            left = deadline - time.monotonic()
            if left <= 0:
                m.waiting = False
                return {"ok": False, "error": "rendezvous timeout",
                        "generation": w.generation}
            self._cv.wait(min(left, 0.25))
        if m.wait_token != token:
            return {"ok": False, "error": "superseded wait",
                    "generation": w.generation}
        view, m.pending_view = m.pending_view, None
        return view

    def _member(self, req: Dict[str, Any]):
        """Resolve (world, member) for ops that address an existing
        incarnation; returns (None, error_resp) when stale."""
        w = self._worlds.get(req.get("world"))
        if w is None:
            return None, {"ok": False, "error": "unknown world"}
        m = w.members.get(int(req.get("rank", -1)))
        if m is None or not m.alive or \
                m.incarnation != int(req.get("incarnation", -1)):
            return None, {"ok": False, "error": "superseded",
                          "generation": w.generation}
        return (w, m), None

    # -------------------------------------------------------- handlers

    def _op_join(self, req: Dict[str, Any]) -> Dict[str, Any]:
        name = str(req["world"])
        size = int(req["size"])
        rank = int(req.get("rank", -1))
        host = str(req.get("host", "127.0.0.1"))
        timeout_s = min(max(float(req.get("timeout_s", 60.0)), 0.0), 600.0)
        if size < 2:
            return {"ok": False, "error": "world size must be >= 2"}
        with self._cv:
            if (self.max_worlds and req.get("world") not in self._worlds
                    and len(self._worlds) >= self.max_worlds):
                return self._admission_reject(None, "fleet full: world "
                                              "quota exhausted")
            w = self._get_world(name, size, req)
            if size != w.size and not w.resizable:
                return {"ok": False,
                        "error": f"world {name} has size {w.size}, "
                                 f"not {size}"}
            grow = False
            if rank < 0:
                free = [r for r in range(w.size)
                        if r not in w.members or not w.members[r].alive]
                if free:
                    rank = free[0]
                elif w.resizable and w.ever_ready and \
                        (not w.max_size or
                         len(w.alive_members()) < w.max_size):
                    # Grow-on-join: the world is full of live members,
                    # so this joiner parks on the slot past the end —
                    # the RESIZE to world_size+1 cuts at the next
                    # collective boundary, when every current member
                    # has parked too.
                    rank = max(w.members, default=w.size - 1) + 1
                    grow = True
                    if self._grow_hold_s > 0.0 and \
                            w.grow_hold_until < time.monotonic():
                        # First grow joiner of a burst opens the
                        # coalescing window; later ones ride it (never
                        # extend — a steady trickle must not starve
                        # the cut).
                        w.grow_hold_until = \
                            time.monotonic() + self._grow_hold_s
                else:
                    # Admission backpressure: a full fleet is a
                    # RETRYABLE condition with a deterministic
                    # retry-after, not a hard failure.
                    return self._admission_reject(w, "fleet full")
            if rank >= w.size and not grow:
                return {"ok": False,
                        "error": f"rank {rank} out of range for size "
                                 f"{w.size}"}
            prev = w.members.get(rank)
            if prev is not None and prev.alive:
                # A restarted rank racing its own lingering lease: the
                # NEW incarnation supersedes — the old one is dead by
                # definition (one process per slot).
                prev.alive = False
                self._membership_changed(w, "superseded")
            elif w.ever_ready:
                self._membership_changed(w, "grow" if grow else "rejoin")
            m = _Member(rank, self._alloc_inc(), host,
                        time.monotonic() + self.lease_ms / 1000.0,
                        host_key=req.get("host_key"))
            m.waiting = True
            w.members[rank] = m
            w.joins += 1
            trace.event("ctl.join", world=name, rank=rank,
                        incarnation=m.incarnation,
                        generation=w.generation, grow=int(grow))
            self._maybe_release(w)
            return self._await_view(w, m, timeout_s)

    def _admission_reject(self, w: Optional[_World],
                          why: str) -> Dict[str, Any]:
        """The backpressure verdict: retryable, with a retry-after
        that is a deterministic function of the lease and how many
        rejects this world has already absorbed (so a thundering herd
        spreads itself without coordination)."""
        if w is not None:
            w.admission_rejects += 1
            rejects = w.admission_rejects
        else:
            rejects = 1
        retry_after = round(
            (self.lease_ms / 1000.0) * (1 + (rejects - 1) % 3), 3)
        trace.add("ctl.admission_reject", 1)
        trace.event("ctl.admission_reject", world=w.name if w else "",
                    why=why, retry_after_s=retry_after)
        return {"ok": False, "error": why, "retryable": True,
                "retry_after_s": retry_after}

    def _op_sync(self, req: Dict[str, Any]) -> Dict[str, Any]:
        timeout_s = min(max(float(req.get("timeout_s", 60.0)), 0.0), 600.0)
        with self._cv:
            resolved, err = self._member(req)
            if err:
                return err
            w, m = resolved
            m.lease_deadline = time.monotonic() + self.lease_ms / 1000.0
            m.wait_token += 1  # supersede any orphaned park (see above)
            m.waiting = True
            m.pending_view = None
            trace.event("ctl.sync", world=w.name, rank=m.rank,
                        generation=w.generation)
            self._maybe_release(w)
            return self._await_view(w, m, timeout_s)

    def _op_report(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._cv:
            resolved, err = self._member(req)
            if err:
                return err
            w, m = resolved
            # Idempotent per incident: the bump is keyed on the
            # reporter's believed generation — the FIRST report of an
            # incident moves the world forward; later reporters (same
            # incident, same believed generation, now stale) just
            # learn the new generation.
            if int(req.get("generation", -1)) == w.generation:
                w.generation += 1
                trace.event("ctl.report", world=w.name, rank=m.rank,
                            generation=w.generation,
                            error=str(req.get("error", ""))[:120])
                self._cv.notify_all()
            return {"ok": True, "generation": w.generation,
                    "rebuilds": w.rebuilds}

    def _op_heartbeat(self, req: Dict[str, Any]) -> Dict[str, Any]:
        # Clock-sync receive instant, stamped BEFORE the lock: the
        # member's offset math treats t1 as "when the request reached
        # the coordinator", and queueing on _cv is server processing
        # time that belongs between t1 and t2, not before t1.
        t1 = time.monotonic_ns()
        with self._cv:
            resolved, err = self._member(req)
            if err:
                return err
            w, m = resolved
            now = time.monotonic()
            m.lease_deadline = now + self.lease_ms / 1000.0
            if self._hb_min_s > 0.0 and now - m.hb_last < self._hb_min_s:
                # Rate-limited: the lease still renews (dropping THAT
                # would turn a chatty member into a dead one), but the
                # counter/histogram/clock processing is shed.
                w.hb_throttled += 1
                return {"ok": True, "generation": w.generation,
                        "throttled": True}
            m.hb_last = now
            counters = req.get("counters")
            if isinstance(counters, dict):
                m.counters = {str(k): int(v) for k, v in counters.items()}
            hists = req.get("hists")
            if isinstance(hists, dict):
                m.hists = {
                    str(name): {int(b): int(c) for b, c in buckets.items()}
                    for name, buckets in hists.items()
                    if isinstance(buckets, dict)
                }
            # Observability riders: the member's current clock-offset
            # estimate and postmortem tally (gauges on /metrics).
            for attr, key in (("clock_offset_ns", "clock_offset_ns"),
                              ("clock_rtt_ns", "clock_rtt_ns"),
                              ("postmortems", "postmortems"),
                              ("qp_reserved", "qp_reserved")):
                v = req.get(key)
                if v is not None:
                    try:
                        setattr(m, attr, int(v))
                    except (TypeError, ValueError):
                        pass
            # Degradation-ladder riders: the member's per-link health
            # snapshot and rung-engagement tally (the quarantine
            # report behind tdr_link_health / tdr_degraded_total).
            lh = req.get("link_health")
            if isinstance(lh, dict):
                m.link_health = {str(k): dict(st)
                                 for k, st in lh.items()
                                 if isinstance(st, dict)}
            dt = req.get("degraded_total")
            if dt is not None:
                try:
                    m.degraded_total = int(dt)
                except (TypeError, ValueError):
                    pass
            resp = {"ok": True, "generation": w.generation,
                    "stale": int(req.get("generation", -1)) != w.generation}
            # RESIZE hint: membership no longer matches the nominal
            # shape (a grow joiner is parked, or a slot died on a
            # resizable world) — the member should fail its next
            # collective retryably and park, so the coordinator can
            # cut the new-size view at a collective boundary.
            if w.resizable and {mm.rank for mm in w.alive_members()} \
                    != set(range(w.size)):
                resp["resize_pending"] = True
            # Pending trace pull this member has not served yet: flag
            # it so the member's heartbeat thread drains and pushes.
            tr = w.trace_req
            if tr is not None and m.rank not in tr["segments"]:
                resp["collect"] = {"id": tr["id"],
                                   "max_events": tr["max_events"]}
            # Clock-sync echo: t0 back verbatim (the member matches it
            # against the beat it stamped), our receive and send
            # instants alongside.
            t0 = req.get("t0_ns")
            if t0 is not None:
                resp["t0_ns"] = t0
                resp["t1_ns"] = t1
                resp["t2_ns"] = time.monotonic_ns()
            return resp

    def _op_trace_push(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """A member's answer to a collect flag: one bounded event
        segment. Stored under the request id; the parked collector
        wakes when every live rank has pushed."""
        with self._cv:
            resolved, err = self._member(req)
            if err:
                return err
            w, m = resolved
            tr = w.trace_req
            if tr is None or int(req.get("trace_id", -1)) != tr["id"]:
                return {"ok": False, "error": "stale trace id"}
            seg = req.get("segment")
            if not isinstance(seg, dict):
                return {"ok": False, "error": "bad segment"}
            seg = dict(seg)
            seg["rank"] = m.rank
            seg["incarnation"] = m.incarnation
            tr["segments"][m.rank] = seg
            trace.event("ctl.trace_push", world=w.name, rank=m.rank,
                        trace_id=tr["id"],
                        events=len(seg.get("events") or []))
            self._cv.notify_all()
            return {"ok": True}

    def _op_collect_trace(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Operator op: pull one flight-recorder segment from every
        live rank of a world. Parks until all ranks pushed or the
        caller's budget expires; a timeout returns ok=False WITH
        whatever arrived (partial visibility beats none during an
        incident)."""
        name = req.get("world")
        timeout_s = min(max(float(req.get("timeout_s", 30.0)), 0.0), 600.0)
        max_events = max(1, min(int(req.get("max_events", 65536)),
                                1 << 20))
        deadline = time.monotonic() + timeout_s
        with self._cv:
            w = self._worlds.get(name)
            if w is None:
                return {"ok": False, "error": "unknown world"}
            if w.trace_req is not None:
                return {"ok": False,
                        "error": "trace collection already in progress"}
            w.trace_seq += 1
            tr = {"id": w.trace_seq, "max_events": max_events,
                  "segments": {}}
            w.trace_req = tr
            trace.event("ctl.collect_trace", world=w.name,
                        trace_id=tr["id"], max_events=max_events)
            try:
                while True:
                    alive = {m.rank for m in w.alive_members()}
                    if alive and alive <= set(tr["segments"]):
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return {
                            "ok": False, "error": "collect timeout",
                            "generation": w.generation,
                            "world_size": w.size,
                            "segments": {str(r): s for r, s in
                                         sorted(tr["segments"].items())},
                        }
                    self._cv.wait(min(left, 0.25))
            finally:
                w.trace_req = None
            return {
                "ok": True,
                "generation": w.generation,
                "world_size": w.size,
                "segments": {str(r): s for r, s in
                             sorted(tr["segments"].items())},
            }

    def _op_leave(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._cv:
            resolved, err = self._member(req)
            if err:
                return err
            w, m = resolved
            m.alive = False
            trace.event("ctl.leave", world=w.name, rank=m.rank)
            self._membership_changed(w, "leave")
            # Survivors may ALREADY be parked (they saw the leaver's
            # QPs close before the leave arrived): a resizable world
            # must cut its shrink view now, not wait for a rejoin.
            self._maybe_release(w)
            self._cv.notify_all()
            return {"ok": True, "generation": w.generation}

    # ---------------------------------------------------------- leases

    def _sweep(self) -> None:
        interval = max(0.05, self.lease_ms / 4000.0)
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._cv:
                for w in self._worlds.values():
                    for m in w.alive_members():
                        # A parked member IS live: its rendezvous
                        # connection is open, and during initial join
                        # its heartbeat thread has not started yet.
                        if m.waiting or m.lease_deadline > now:
                            continue
                        m.alive = False
                        w.lease_expiries += 1
                        trace.event("ctl.lease_expired", world=w.name,
                                    rank=m.rank,
                                    incarnation=m.incarnation)
                        self._membership_changed(w, "lease")
                        # The expiry may complete a shrink: survivors
                        # parked waiting for this verdict get their
                        # world_size-1 view here instead of timing out.
                        self._maybe_release(w)
                        self._cv.notify_all()
                    if w.grow_hold_until and now >= w.grow_hold_until:
                        # A batch-admission hold ran out with everyone
                        # parked: cut the coalesced grow view now.
                        self._maybe_release(w)
                        self._cv.notify_all()

    # ------------------------------------------------------- snapshots

    SNAPSHOT_FILE = "coordinator.json"

    @classmethod
    def _load_snapshot(cls, snapshot_dir: Optional[str]
                       ) -> Optional[Dict[str, Any]]:
        if not snapshot_dir:
            return None
        path = os.path.join(snapshot_dir, cls.SNAPSHOT_FILE)
        try:
            with open(path) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            return None
        if snap.get("format") != "tdr-ctl-snapshot-v1":
            return None
        return snap

    def _snapshot_state(self) -> Dict[str, Any]:
        """The full arbitration state, JSON-shaped (caller holds the
        lock). Contract: restoring this dict yields a coordinator that
        resumes arbitration — same worlds, generations, incarnations,
        port arena, budgets, counters — with every lease restarted."""
        worlds = {}
        for name, w in self._worlds.items():
            worlds[name] = {
                "size": w.size, "base_port": w.base_port,
                "qp_budget": w.qp_budget, "generation": w.generation,
                "epoch": w.epoch, "ever_ready": w.ever_ready,
                "rebuilds": w.rebuilds,
                "lease_expiries": w.lease_expiries, "joins": w.joins,
                "trace_seq": w.trace_seq, "resizable": w.resizable,
                "max_size": w.max_size, "resizes": w.resizes,
                "weight": w.weight, "qp_share": w.qp_share,
                "admission_rejects": w.admission_rejects,
                "hb_throttled": w.hb_throttled,
                "members": [{
                    "rank": m.rank, "incarnation": m.incarnation,
                    "host": m.host, "host_key": m.host_key,
                    "alive": m.alive, "counters": m.counters,
                    "hists": {h: {str(b): c for b, c in bk.items()}
                              for h, bk in m.hists.items()},
                    "clock_offset_ns": m.clock_offset_ns,
                    "clock_rtt_ns": m.clock_rtt_ns,
                    "postmortems": m.postmortems,
                    "qp_reserved": m.qp_reserved,
                    "link_health": m.link_health,
                    "degraded_total": m.degraded_total,
                } for m in w.members.values()],
            }
        return {
            "format": "tdr-ctl-snapshot-v1",
            "port": self.port, "lease_ms": self.lease_ms,
            "port_base": self.port_base,
            "port_stride": self.port_stride,
            "qp_budget": self.qp_budget, "qp_fair": self.qp_fair,
            "qp_floor": self.qp_floor, "next_inc": self._next_inc,
            "failovers": self.failovers, "wall_time": time.time(),
            "worlds": worlds,
        }

    def snapshot_now(self) -> Optional[str]:
        """Write one snapshot atomically (tmp + rename); returns the
        path, or None without a snapshot_dir."""
        if not self.snapshot_dir:
            return None
        with self._lock:
            snap = self._snapshot_state()
        os.makedirs(self.snapshot_dir, exist_ok=True)
        path = os.path.join(self.snapshot_dir, self.SNAPSHOT_FILE)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
        self._last_snapshot = time.time()
        return path

    def _snapshots(self) -> None:
        while not self._stop.wait(self.snapshot_interval_s):
            try:
                self.snapshot_now()
            except OSError:
                pass  # a full disk must not take arbitration down

    def _restore_state(self, snap: Dict[str, Any]) -> None:
        """Resume arbitration from a snapshot: worlds come back with
        their generations/epochs/counters intact, every member's lease
        restarts at a full TTL (members re-attach by simply continuing
        to heartbeat — the incarnations they hold still resolve), and
        nobody is parked (members mid-rendezvous when the old
        coordinator died will retry their sync/join). A restore IS a
        failover: the counter bumps and is served on /metrics."""
        self.lease_ms = int(snap.get("lease_ms", self.lease_ms))
        self.port_base = int(snap.get("port_base", self.port_base))
        self.port_stride = int(snap.get("port_stride", self.port_stride))
        self.qp_budget = int(snap.get("qp_budget", self.qp_budget))
        self.qp_fair = bool(snap.get("qp_fair", self.qp_fair))
        self.qp_floor = int(snap.get("qp_floor", self.qp_floor))
        self._next_inc = max(self._next_inc,
                             int(snap.get("next_inc", 1)))
        self.failovers = int(snap.get("failovers", 0)) + 1
        now = time.monotonic()
        lease = self.lease_ms / 1000.0
        for name, wd in (snap.get("worlds") or {}).items():
            w = _World(str(name), int(wd["size"]),
                       int(wd["base_port"]), int(wd.get("qp_budget", 0)))
            w.generation = int(wd.get("generation", 0))
            w.epoch = int(wd.get("epoch", 0))
            w.ever_ready = bool(wd.get("ever_ready"))
            w.rebuilds = int(wd.get("rebuilds", 0))
            w.lease_expiries = int(wd.get("lease_expiries", 0))
            w.joins = int(wd.get("joins", 0))
            w.trace_seq = int(wd.get("trace_seq", 0))
            w.resizable = bool(wd.get("resizable"))
            w.max_size = int(wd.get("max_size", 0))
            w.resizes = int(wd.get("resizes", 0))
            w.weight = float(wd.get("weight", 1.0))
            w.qp_share = int(wd.get("qp_share", w.qp_budget))
            w.admission_rejects = int(wd.get("admission_rejects", 0))
            w.hb_throttled = int(wd.get("hb_throttled", 0))
            for md in wd.get("members") or []:
                m = _Member(int(md["rank"]), int(md["incarnation"]),
                            str(md.get("host", "127.0.0.1")),
                            now + lease, host_key=md.get("host_key"))
                m.alive = bool(md.get("alive", True))
                m.counters = {str(k): int(v) for k, v in
                              (md.get("counters") or {}).items()}
                m.hists = {str(h): {int(b): int(c)
                                    for b, c in bk.items()}
                           for h, bk in (md.get("hists") or {}).items()}
                m.clock_offset_ns = int(md.get("clock_offset_ns", 0))
                m.clock_rtt_ns = int(md.get("clock_rtt_ns", 0))
                m.postmortems = int(md.get("postmortems", 0))
                m.qp_reserved = int(md.get("qp_reserved", 0))
                lh = md.get("link_health")
                if isinstance(lh, dict):
                    m.link_health = {str(k): dict(st)
                                     for k, st in lh.items()
                                     if isinstance(st, dict)}
                m.degraded_total = int(md.get("degraded_total", 0))
                w.members[m.rank] = m
            self._worlds[w.name] = w
        trace.add("ctl.failover", 1)
        trace.event("ctl.restore", worlds=len(self._worlds),
                    failovers=self.failovers,
                    next_inc=self._next_inc)

    # --------------------------------------------------------- metrics

    @staticmethod
    def _metric_name(counter: str) -> str:
        safe = "".join(c if c.isalnum() else "_" for c in counter)
        return f"tdr_{safe}_total"

    def render_metrics(self) -> str:
        """The Prometheus-style text exposition. Contract-pinned names
        (tests/test_control.py): ``tdr_ctl_generation``,
        ``tdr_ctl_members``, ``tdr_ctl_rebuilds_total``,
        ``tdr_ctl_lease_expiries_total``, ``tdr_retransmit_rate``, the
        ``tdr_<registry counter>_total`` family (dots -> underscores,
        e.g. ``tdr_integrity_retransmitted_total``) — served both as
        the per-world aggregate (``{world=}``, label shape unchanged)
        and per member (``{world=,rank=}``) — and the histogram
        quantile series ``tdr_<hist>{...,quantile="0.99"}`` (e.g.
        ``tdr_chunk_lat_us``). Fleet-tracing additions (also
        contract-pinned): ``tdr_postmortems_total{world=}`` (black-box
        bundles written across the world) and
        ``tdr_clock_offset_us{world=,rank=}`` /
        ``tdr_clock_rtt_us{world=,rank=}`` (each member's min-RTT
        clock estimate vs this coordinator); note
        ``tdr_telemetry_dropped_total{world=,rank=}`` already rides
        the registry family — a nonzero value taints event-derived
        fractions for that rank's windows."""
        with self._lock:
            lines = [
                f"# tdr coordinator metrics v{PROTOCOL_VERSION}",
                "# TYPE tdr_ctl_worlds gauge",
                f"tdr_ctl_worlds {len(self._worlds)}",
                "# TYPE tdr_ctl_failovers_total counter",
                f"tdr_ctl_failovers_total {self.failovers}",
                "# TYPE tdr_ctl_scrape_throttled_total counter",
                f"tdr_ctl_scrape_throttled_total "
                f"{self._scrape_throttled}",
            ]
            if self.snapshot_dir:
                age = (time.time() - self._last_snapshot
                       if self._last_snapshot else -1.0)
                lines.append("# TYPE tdr_ctl_snapshot_age_s gauge")
                lines.append(f"tdr_ctl_snapshot_age_s {age:.3f}")
            lines.append("# TYPE tdr_ctl_generation gauge")
            lines.append("# TYPE tdr_ctl_members gauge")
            lines.append("# TYPE tdr_ctl_rebuilds_total counter")
            lines.append("# TYPE tdr_ctl_lease_expiries_total counter")
            for name in sorted(self._worlds):
                w = self._worlds[name]
                lab = f'{{world="{name}"}}'
                lines += [
                    f"tdr_ctl_generation{lab} {w.generation}",
                    f"tdr_ctl_epoch{lab} {w.epoch}",
                    f"tdr_ctl_size{lab} {w.size}",
                    f"tdr_ctl_members{lab} {len(w.alive_members())}",
                    f"tdr_ctl_base_port{lab} {w.base_port}",
                    f"tdr_ctl_rebuilds_total{lab} {w.rebuilds}",
                    f"tdr_ctl_lease_expiries_total{lab} "
                    f"{w.lease_expiries}",
                    f"tdr_ctl_joins_total{lab} {w.joins}",
                    f"tdr_ctl_resizes_total{lab} {w.resizes}",
                    f"tdr_ctl_resizable{lab} {int(w.resizable)}",
                    # Fair-share gauges: this world's computed slice
                    # of the engine QP pool vs the appetite its live
                    # members actually reserved at bring-up.
                    f"tdr_ctl_qp_share{lab} {w.qp_share}",
                    f"tdr_ctl_qp_reserved{lab} "
                    f"{sum(m.qp_reserved for m in w.alive_members())}",
                    f"tdr_ctl_admission_rejects_total{lab} "
                    f"{w.admission_rejects}",
                    f"tdr_ctl_hb_throttled_total{lab} {w.hb_throttled}",
                    # Black-box postmortems written across the world's
                    # slots (heartbeat-pushed; slots keep serving their
                    # current occupant's tally like every other series).
                    f"tdr_postmortems_total{lab} "
                    f"{sum(m.postmortems for m in w.members.values())}",
                ]
                # Per-member clock offsets vs this coordinator (µs;
                # min-RTT filtered on the member side) — the numbers a
                # fleet trace merge aligns timestamps with, and the
                # live skew readout tdr_top --connect renders.
                for m in sorted(w.members.values(), key=lambda m: m.rank):
                    rlab = f'{{world="{name}",rank="{m.rank}"}}'
                    lines.append(f"tdr_clock_offset_us{rlab} "
                                 f"{m.clock_offset_ns / 1000.0:.6g}")
                    lines.append(f"tdr_clock_rtt_us{rlab} "
                                 f"{m.clock_rtt_ns / 1000.0:.6g}")
                # Slow-rank quarantine report (heartbeat-pushed ladder
                # scores): WHICH link each member's degradation ladder
                # is acting on, plus the world's rung-engagement tally.
                # Contract-pinned names (tests/test_control.py):
                # tdr_link_health{world=,rank=,peer=} and
                # tdr_degraded_total{world=}.
                for m in sorted(w.members.values(), key=lambda m: m.rank):
                    for link in sorted(m.link_health):
                        st = m.link_health[link]
                        try:
                            score = float(st.get("score", 1.0))
                            peer = int(st.get("peer", -1))
                        except (TypeError, ValueError):
                            continue
                        lines.append(
                            f'tdr_link_health{{world="{name}",'
                            f'rank="{m.rank}",peer="{peer}",'
                            f'link="{link}"}} {score:.6g}')
                lines.append(
                    f"tdr_degraded_total{lab} "
                    f"{sum(m.degraded_total for m in w.members.values())}")
                # Member-pushed counter registry, summed over each
                # slot's CURRENT occupant — dead or departed members
                # keep serving their last snapshot (a scraper must not
                # see the world's history vanish because a rank died;
                # exact when members are one process each).
                agg: Dict[str, int] = {}
                hists: Dict[str, List[int]] = {}
                for m in w.members.values():
                    for k, v in m.counters.items():
                        agg[k] = agg.get(k, 0) + v
                    for hname, buckets in m.hists.items():
                        row = hists.setdefault(hname, [0] * 64)
                        for b, c in buckets.items():
                            # Native rows are 64 octave buckets;
                            # python-tier fine (log2×8) rows carry
                            # indices past 64 (plus a {64: 0} marker
                            # so hist_percentile reads fine edges) —
                            # grow the row to fit, capped well above
                            # any real fine index (2^64 ns ≈ bucket
                            # 488) so a corrupt push can't balloon it.
                            if not 0 <= b < 512:
                                continue
                            if b >= len(row):
                                row.extend([0] * (b + 1 - len(row)))
                            row[b] += c
                for k in sorted(agg):
                    lines.append(f"{self._metric_name(k)}{lab} {agg[k]}")
                # Per-member series: the same registry counters, one
                # series per ring slot with a rank label — a scraper
                # can tell WHICH member's retransmit ladder is moving
                # without losing the aggregate (whose label shape and
                # values above are unchanged, contract-pinned). Slots
                # keep serving their current occupant's last snapshot,
                # exactly like the aggregate.
                for m in sorted(w.members.values(), key=lambda m: m.rank):
                    if not m.counters:
                        continue
                    rlab = f'{{world="{name}",rank="{m.rank}"}}'
                    for k in sorted(m.counters):
                        lines.append(
                            f"{self._metric_name(k)}{rlab} "
                            f"{m.counters[k]}")
                sealed = agg.get("integrity.sealed", 0)
                retx = agg.get("integrity.retransmitted", 0)
                rate = (retx / sealed) if sealed else 0.0
                lines.append(f"tdr_retransmit_rate{lab} {rate:.6g}")
                for hname in sorted(hists):
                    safe = "".join(c if c.isalnum() else "_"
                                   for c in hname)
                    for q in _QUANTILES:
                        v = hist_percentile(hists[hname], q)
                        lines.append(
                            f'tdr_{safe}{{world="{name}",'
                            f'quantile="0.{q}"}} {v}')
                    lines.append(
                        f"tdr_{safe}_count{lab} {sum(hists[hname])}")
            return "\n".join(lines) + "\n"


class Standby:
    """Warm standby for the coordinator: tails the snapshot directory,
    probes the active coordinator's ``/healthz``, and after
    ``fail_threshold`` consecutive probe failures promotes itself —
    restoring the latest snapshot and binding the SAME port the fleet
    already dials (the dead coordinator's socket is gone, so the bind
    succeeds exactly when takeover is legitimate). Members notice
    nothing but a missed heartbeat or two: their incarnations still
    resolve against the restored state.

    ``promoted`` is set once takeover completed; ``coordinator`` then
    holds the live replacement (the caller owns stopping it)."""

    def __init__(self, snapshot_dir: str, address: Optional[str] = None,
                 host: str = "127.0.0.1", probe_interval_s: float = 0.5,
                 fail_threshold: int = 3):
        self.snapshot_dir = snapshot_dir
        self.address = address  # None: probe the snapshot's port
        self.host = host
        self.probe_interval_s = max(0.05, float(probe_interval_s))
        self.fail_threshold = max(1, int(fail_threshold))
        self.coordinator: Optional[Coordinator] = None
        self.promoted = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _probe_target(self) -> Optional[tuple]:
        if self.address:
            host, _, port = self.address.rpartition(":")
            return (host, int(port))
        snap = Coordinator._load_snapshot(self.snapshot_dir)
        if snap is None:
            return None
        return (self.host, int(snap.get("port", 0)))

    def _healthy(self, target: tuple) -> bool:
        try:
            with socket.create_connection(target, timeout=2.0) as s:
                s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
                return b"200" in s.recv(256)
        except OSError:
            return False

    def _watch(self) -> None:
        failures = 0
        while not self._stop.wait(self.probe_interval_s):
            target = self._probe_target()
            if target is None or not target[1]:
                continue  # no snapshot yet: nothing to guard
            if self._healthy(target):
                failures = 0
                continue
            failures += 1
            if failures < self.fail_threshold:
                continue
            try:
                self.coordinator = Coordinator(
                    host=self.host, port=0, restore=True,
                    snapshot_dir=self.snapshot_dir).start()
            except OSError:
                # Port still held (the old coordinator is wedged, not
                # dead, or another standby won the race): keep
                # probing — takeover is only legitimate once the bind
                # succeeds.
                failures = 0
                continue
            trace.add("ctl.failover", 1)
            trace.event("ctl.standby_takeover",
                        address=self.coordinator.address,
                        failovers=self.coordinator.failovers)
            self.promoted.set()
            return

    def start(self) -> "Standby":
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="tdr-ctl-standby")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.coordinator is not None:
            self.coordinator.stop()
