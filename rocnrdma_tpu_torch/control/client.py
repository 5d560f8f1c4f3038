"""Member-side control-plane client (stdlib-only): the port's own copy
of ``rocnrdma_tpu/control/client.py``.

One request per connection (the coordinator closes after answering),
so a parked rendezvous call never blocks heartbeats — the background
``Heartbeat`` thread opens its own connections. All methods return the
coordinator's response dict; ``ok`` is False on arbitration refusals
(stale incarnation, rendezvous timeout) — the member decides whether
that means re-join or give up. Transport-level failures raise
``ControlError``.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional

from rocnrdma_tpu_torch.utils.trace import trace


class ControlError(RuntimeError):
    """The coordinator was unreachable or spoke garbage (distinct from
    an ok=False arbitration answer, which is a protocol-level verdict
    the member must interpret)."""


class ClockSync:
    """NTP-style offset estimate against the coordinator's
    CLOCK_MONOTONIC, min-RTT filtered.

    Each heartbeat is a four-timestamp exchange: the member stamps t0
    at send, the coordinator echoes its receive (t1) and send (t2)
    instants, the member stamps t3 at the reply. Then

        offset = ((t1 - t0) + (t2 - t3)) / 2   (coordinator - member)
        rtt    = (t3 - t0) - (t2 - t1)

    and |true_offset - offset| <= rtt / 2 — the asymmetry bound, so
    the sample taken at the SMALLEST rtt carries the tightest bound.
    The filter keeps exactly that sample (a new sample replaces the
    estimate only when its rtt is <= the kept one's): the estimate's
    error bound is monotonically non-increasing, and congestion
    spikes — which inflate rtt and offset together — can never drag
    the estimate around. Same-host ranks share the kernel clock, so
    the estimate converges toward 0 there; the machinery is what makes
    multi-host merges honest."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.offset_ns: int = 0
        self.rtt_ns: Optional[int] = None  # None until the 1st sample
        self.samples: int = 0

    def sample(self, t0: int, t1: int, t2: int, t3: int) -> bool:
        """Feed one exchange; True when it became the new estimate."""
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:  # clock misbehavior / garbled echo: discard
            return False
        offset = ((t1 - t0) + (t2 - t3)) // 2
        with self._lock:
            self.samples += 1
            if self.rtt_ns is not None and rtt > self.rtt_ns:
                return False
            self.rtt_ns = rtt
            self.offset_ns = offset
            return True

    def state(self) -> Dict[str, int]:
        with self._lock:
            return {
                "clock_offset_ns": int(self.offset_ns),
                "clock_rtt_ns": int(self.rtt_ns or 0),
                "clock_samples": int(self.samples),
            }


class ControlClient:
    def __init__(self, address: str, timeout_s: float = 120.0):
        host, _, port = address.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"control address must be host:port, "
                             f"got {address!r}")
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # ------------------------------------------------------------ wire

    def request(self, op: str, timeout_s: Optional[float] = None,
                **fields: Any) -> Dict[str, Any]:
        budget = self.timeout_s if timeout_s is None else float(timeout_s)
        # The budget rides IN the payload: the coordinator parks
        # join/sync for the CALLER's budget, not its own default —
        # otherwise an aborted-and-retried sync leaves an orphaned
        # handler parked on the same member for the server default,
        # racing the retry for the released view.
        req = dict(fields, op=op, timeout_s=budget)
        try:
            with socket.create_connection(
                    (self.host, self.port), timeout=budget + 10.0) as s:
                f = s.makefile("rwb")
                f.write((json.dumps(req) + "\n").encode())
                f.flush()
                line = f.readline()
            if not line:
                raise ControlError(
                    f"coordinator {self.address} closed the connection")
            return json.loads(line.decode())
        except (OSError, ValueError) as e:
            raise ControlError(
                f"coordinator {self.address} unreachable for "
                f"{op}: {e}") from e

    # ------------------------------------------------------ operations

    def join(self, world: str, size: int, rank: int = -1,
             host: str = "127.0.0.1",
             host_key: Optional[str] = None,
             timeout_s: Optional[float] = None,
             resizable: bool = False, max_size: int = 0,
             weight: float = 1.0) -> Dict[str, Any]:
        """``host_key`` is the member's TOPOLOGY key (which physical
        host it sits on) — distinct from ``host``, the address peers
        dial, and deliberately NOT defaulted from it: inferring
        locality from connect addresses would silently flip collective
        algorithms under NAT or multi-homed hosts (the resolve_topology
        design rule). A member with no explicit key reports none, and
        the coordinator releases a keyless view the member side
        ignores. The coordinator releases every slot's key in the view
        (``host_keys``), which is how arbitrated worlds agree on the
        hierarchical grouping without a per-rank env.

        ``resizable`` opts the world (sticky, first join wins) into
        coordinator-arbitrated RESIZE: shrink-to-survivors on a lease
        expiry/leave, grow-on-join when full (``max_size`` caps the
        growth; 0 = unbounded). ``weight`` is the world's fair-share
        weight when the coordinator divides its engine QP pool."""
        budget = self.timeout_s if timeout_s is None else float(timeout_s)
        return self.request("join", timeout_s=budget, world=world,
                            size=int(size), rank=int(rank), host=host,
                            host_key=host_key,
                            resizable=bool(resizable),
                            max_size=int(max_size),
                            weight=float(weight))

    def sync(self, world: str, rank: int, incarnation: int,
             timeout_s: Optional[float] = None) -> Dict[str, Any]:
        budget = self.timeout_s if timeout_s is None else float(timeout_s)
        return self.request("sync", timeout_s=budget, world=world,
                            rank=int(rank), incarnation=int(incarnation))

    def report(self, world: str, rank: int, incarnation: int,
               generation: int, error: str = "") -> Dict[str, Any]:
        return self.request("report", world=world, rank=int(rank),
                            incarnation=int(incarnation),
                            generation=int(generation),
                            error=str(error)[:400])

    def heartbeat(self, world: str, rank: int, incarnation: int,
                  generation: int,
                  counters: Optional[Dict[str, int]] = None,
                  hists: Optional[Dict[str, Dict[int, int]]] = None,
                  **extra: Any) -> Dict[str, Any]:
        """``extra`` carries the observability riders: ``t0_ns`` (the
        clock-sync exchange), ``clock_offset_ns``/``clock_rtt_ns``
        (the member's current min-RTT estimate, served on /metrics as
        ``tdr_clock_offset_us``), and ``postmortems`` (bundles this
        member has written, summed into
        ``tdr_postmortems_total{world=}``)."""
        return self.request("heartbeat", timeout_s=15.0, world=world,
                            rank=int(rank), incarnation=int(incarnation),
                            generation=int(generation),
                            counters=counters, hists=hists, **extra)

    def collect_trace(self, world: str, timeout_s: float = 30.0,
                      max_events: int = 65536) -> Dict[str, Any]:
        """Pull one bounded flight-recorder segment from EVERY live
        rank of ``world``: the coordinator flags the request, each
        member's next heartbeat drains and pushes its segment, and the
        call parks until all ranks reported (or the timeout). The
        result's ``segments`` map feeds ``telemetry.merge_fleet`` and
        ``rocnrdma_tpu_torch.tools.explain``."""
        return self.request("collect_trace", timeout_s=timeout_s,
                            world=world, max_events=int(max_events))

    def leave(self, world: str, rank: int,
              incarnation: int) -> Dict[str, Any]:
        return self.request("leave", timeout_s=15.0, world=world,
                            rank=int(rank), incarnation=int(incarnation))

    def metrics(self) -> str:
        """Scrape the coordinator's /metrics endpoint (the same HTTP
        text a Prometheus scraper would read)."""
        with socket.create_connection((self.host, self.port),
                                      timeout=15.0) as s:
            s.sendall(b"GET /metrics HTTP/1.0\r\n\r\n")
            chunks = []
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
        blob = b"".join(chunks)
        head, _, body = blob.partition(b"\r\n\r\n")
        if not head.startswith(b"HTTP/1.0 200"):
            raise ControlError(
                f"/metrics scrape failed: {head.splitlines()[:1]}")
        return body.decode()

    # ------------------------------------------------------- heartbeat

    def start_heartbeat(self, world: str, rank: int,
                        state_fn: Callable[[], tuple],
                        interval_s: float,
                        counters_fn: Optional[Callable[[], Dict]] = None,
                        hists_fn: Optional[Callable[[], Dict]] = None,
                        trace_fn: Optional[Callable[[int], Dict]] = None,
                        postmortems_fn: Optional[Callable[[], int]] = None,
                        notify_fn: Optional[Callable[[Dict], None]] = None,
                        extras_fn: Optional[Callable[[], Dict]] = None
                        ) -> "Heartbeat":
        """Renew this member's lease from a daemon thread every
        ``interval_s``, pushing counter/histogram snapshots for the
        coordinator's /metrics aggregation. ``state_fn`` returns the
        member's CURRENT (incarnation, generation) or (incarnation,
        generation, rank) — incarnation AND rank change across
        rejoins/RESIZEs, so the thread reads it per beat (a 2-tuple
        keeps the construction-time rank). ``trace_fn(max_events)``
        serves ``collect_trace`` pulls (returns {"events": wire list,
        "dropped": int}); ``postmortems_fn`` reports bundles written;
        ``notify_fn(resp)`` sees every accepted heartbeat response
        (how a member learns ``resize_pending``); ``extras_fn()``
        returns additional scalar riders merged into every beat (how a
        member pushes its bring-up ``qp_reserved``)."""
        return Heartbeat(self, world, rank, state_fn, interval_s,
                         counters_fn, hists_fn, trace_fn, postmortems_fn,
                         notify_fn, extras_fn)


class Heartbeat:
    def __init__(self, client: ControlClient, world: str, rank: int,
                 state_fn: Callable[[], tuple], interval_s: float,
                 counters_fn: Optional[Callable[[], Dict]] = None,
                 hists_fn: Optional[Callable[[], Dict]] = None,
                 trace_fn: Optional[Callable[[int], Dict]] = None,
                 postmortems_fn: Optional[Callable[[], int]] = None,
                 notify_fn: Optional[Callable[[Dict], None]] = None,
                 extras_fn: Optional[Callable[[], Dict]] = None):
        self._client = client
        self._world = world
        self._rank = rank
        self._state_fn = state_fn
        self._notify_fn = notify_fn
        self._extras_fn = extras_fn
        # (incarnation, rank) the coordinator declared superseded: a
        # member that left, was lease-expired, or was resized out must
        # STOP pushing counters under that identity — the coordinator
        # rejects the pushes, and retrying them forever is the
        # heartbeat-after-leave leak. Beats resume the moment state_fn
        # reports a different identity (a rejoin's new incarnation, or
        # a RESIZE's new rank for the same incarnation).
        self._dead_key: Optional[tuple] = None
        self._interval = max(0.05, float(interval_s))
        self._counters_fn = counters_fn
        self._hists_fn = hists_fn
        self._trace_fn = trace_fn
        self._postmortems_fn = postmortems_fn
        # Clock-offset estimate vs the coordinator, fed by every beat
        # and pushed back so /metrics serves tdr_clock_offset_us.
        self.clock = ClockSync()
        # collect_trace requests already answered (one push per id),
        # and drained-but-unacknowledged payloads awaiting a retry —
        # the ring drain is DESTRUCTIVE, so a failed push must resend
        # the captured window, never re-drain an emptied ring.
        self._pushed_traces: set = set()
        self._trace_payloads: Dict[int, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"tdr-ctl-hb-{world}-{rank}")
        self._thread.start()

    def beat(self) -> bool:
        """One synchronous beat (also used as the final flush before
        leave, so /metrics reflects the member's last snapshots).
        Returns False when ``state_fn`` reports the member object is
        GONE (garbage-collected) — the thread must exit and the lease
        age out at the coordinator."""
        state = self._state_fn()
        if state is None:
            return False
        if len(state) >= 3:
            inc, gen, rank = state[0], state[1], state[2]
        else:
            inc, gen, rank = state[0], state[1], self._rank
        if inc is None:
            return True  # between incarnations: nothing to renew
        if (inc, rank) == self._dead_key:
            return True  # superseded identity: push nothing under it
        counters = self._counters_fn() if self._counters_fn else None
        hists = self._hists_fn() if self._hists_fn else None
        extra: Dict[str, Any] = self.clock.state()
        if self._postmortems_fn is not None:
            try:
                extra["postmortems"] = int(self._postmortems_fn())
            except Exception:
                pass
        if self._extras_fn is not None:
            try:
                extra.update(self._extras_fn() or {})
            except Exception:
                pass  # a rider hook must never cost the lease renewal
        t0 = time.monotonic_ns()
        resp = self._client.heartbeat(self._world, rank, inc, gen,
                                      counters=counters, hists=hists,
                                      t0_ns=t0, **extra)
        t3 = time.monotonic_ns()
        try:
            if int(resp.get("t0_ns", -1)) == t0:
                self.clock.sample(t0, int(resp["t1_ns"]),
                                  int(resp["t2_ns"]), t3)
        except (KeyError, TypeError, ValueError):
            pass  # pre-clock coordinator: estimate just stays at 0
        if not resp.get("ok"):
            if resp.get("error") == "superseded":
                # The coordinator owns membership: this identity is
                # dead there (left / lease-expired / resized out).
                # Stop pushing under it — the next rejoin or RESIZE
                # view changes what state_fn returns and beats resume.
                self._dead_key = (inc, rank)
            trace.event("ctl.heartbeat_refused", world=self._world,
                        rank=rank,
                        error=str(resp.get("error", ""))[:80])
            return True
        if self._notify_fn is not None:
            try:
                self._notify_fn(resp)
            except Exception:
                pass  # a member-side hook must never kill the lease
        collect = resp.get("collect")
        if isinstance(collect, dict) and self._trace_fn is not None:
            self._push_trace(collect, inc, gen, rank)
        return True

    def _push_trace(self, collect: Dict[str, Any], inc: int,
                    gen: int, rank: Optional[int] = None) -> None:
        """Serve one collect_trace pull: drain a bounded local segment
        and push it under the request id. The drain runs ONCE per id
        (it is destructive); the push retries on ANY failure —
        transport loss or a coordinator refusal (e.g. this member was
        superseded mid-push) — resending the CACHED window on the next
        beat, because the flag stays up at the coordinator until this
        rank's segment lands. Only success or a stale-id verdict (a
        newer collect superseded the request) retires the id."""
        try:
            trace_id = int(collect.get("id", 0))
            max_events = int(collect.get("max_events", 65536))
        except (TypeError, ValueError):
            return
        if not trace_id or trace_id in self._pushed_traces:
            return
        payload = self._trace_payloads.get(trace_id)
        if payload is None:
            try:
                seg = self._trace_fn(max_events) or {}
            except Exception:
                seg = {"events": [], "dropped": 0,
                       "error": "trace_fn failed"}
            payload = dict(seg)
            payload.update(self.clock.state())
            # Bound the retry cache: requests the coordinator timed
            # out never re-flag, so their payloads would otherwise
            # pin event windows forever.
            while len(self._trace_payloads) >= 4:
                self._trace_payloads.pop(
                    min(self._trace_payloads), None)
            self._trace_payloads[trace_id] = payload
        if rank is None:
            rank = self._rank
        try:
            resp = self._client.request(
                "trace_push", world=self._world, rank=int(rank),
                incarnation=int(inc), generation=int(gen),
                trace_id=trace_id, segment=payload)
        except ControlError:
            return  # payload stays cached; the next beat retries
        if resp.get("ok") or resp.get("error") == "stale trace id":
            self._pushed_traces.add(trace_id)
            self._trace_payloads.pop(trace_id, None)
            if resp.get("ok"):
                trace.event("ctl.trace_push", world=self._world,
                            rank=int(rank), trace_id=trace_id,
                            events=len(payload.get("events") or []))
        # Any other refusal (superseded member mid-rebuild): keep the
        # cache, retry under the next incarnation's heartbeat.

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                if not self.beat():
                    return  # member collected: stop renewing its lease
            except ControlError:
                # The coordinator being briefly unreachable must never
                # take the member down; the lease ages, and the member
                # rejoins through the normal arbitration path if it
                # expires meanwhile.
                pass
            except Exception:
                pass  # diagnostics must never kill the workload

    def stop(self, flush: bool = False) -> None:
        self._stop.set()
        if flush:
            try:
                self.beat()
            except Exception:
                pass
        self._thread.join(timeout=5)
