"""Generic streaming transfer engine: credit-gated producer/consumer
channels over the zero-copy collective path.

The port's own copy of ``rocnrdma_tpu/serving/stream.py``: the staged-
pipeline + copy-pool machinery of the cross-slice allreduce shim,
extracted into its own subsystem (after "The DMA Streaming Framework"'s
buffer-orchestration model): a transfer is an explicit *produce* step
(fill a registered scratch window), a *launch* step (submit a
nonblocking collective or a worker-pool future), and a *consume* step
(read the landed bytes), with **credit-based depth** bounding how many
transfers are in flight — or pinned in scratch — at once. The trainer's
bucketed overlap sync and the serving weight/KV pager are both clients
of the same engine, so the submission-order contract of the ring's async
collective thread (ops complete in the order submitted; results bitwise
the blocking calls') holds for both.

Depth comes from ``TDR_STREAM_DEPTH`` (default 3 — the historical
staged-pipeline depth). ``depth=0`` means unbounded: credits are still
accounted (``in_flight``/``high_water``) but never block, which is what
the trainer's bucketed launch wants (its natural bound is the bucket
plan; the census still proves no handle leaks).

The engine spawns **no threads**: launches ride the ring's existing
async collective thread or a caller-owned executor, so the flat-thread-
census invariant the smokes pin is free.

Serving collective ids
----------------------

FEAT_COLL_ID carries 8 bytes on the wire. Serving streams stamp a
structured id so ``tdr_explain`` can decompose decode streams per
request: bit 62 set (bit 63 — the ring's auto-assign marker — clear)
marks a serving-stream collective; bits 40..61 hold the request id
(0 = batch-level weight traffic shared by all requests); bits 0..39
a per-stream sequence. Ids are seeded through the same one-shot
``_seed_coll`` hook the hierarchical tiers use, and admission/evict
decisions are deterministic, so the SPMD same-id-same-collective
contract survives.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

from ..utils.trace import trace

__all__ = [
    "stream_depth", "CreditGate", "Inflight", "TransferEngine",
    "STREAM_BIT", "make_stream_coll", "is_stream_coll",
    "stream_coll_request", "stream_coll_seq",
]


def stream_depth(default: int = 3) -> int:
    """Credit depth for streaming transfers (``TDR_STREAM_DEPTH``).

    The default of 3 is the staged pipeline's historical depth: one
    window landing, one on the wire, one being produced. Values < 1
    are clamped to 1 (a depth-0 *engine* is constructed explicitly,
    not through the env knob — an unbounded default would let a
    misconfigured server pin every page in scratch at once)."""
    env = os.environ.get("TDR_STREAM_DEPTH", "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return default


# --------------------------------------------------------------- coll ids

STREAM_BIT = 1 << 62
_REQ_SHIFT = 40
_REQ_MASK = (1 << 22) - 1
_SEQ_MASK = (1 << _REQ_SHIFT) - 1


def make_stream_coll(request_id: int, seq: int) -> int:
    """Serving-stream collective id: bit 62 | request<<40 | seq.

    ``request_id`` 0 is batch-level traffic (weight pages shared by
    every active request); nonzero ids attribute KV/join streams to
    one request. Bit 63 stays clear so the id never collides with the
    ring's auto-assigned namespace."""
    return STREAM_BIT | ((int(request_id) & _REQ_MASK) << _REQ_SHIFT) \
        | (int(seq) & _SEQ_MASK)


def is_stream_coll(coll: int) -> bool:
    return bool(coll & STREAM_BIT) and not bool(coll >> 63)


def stream_coll_request(coll: int) -> int:
    return (coll >> _REQ_SHIFT) & _REQ_MASK


def stream_coll_seq(coll: int) -> int:
    return coll & _SEQ_MASK


# ----------------------------------------------------------------- credits

class CreditGate:
    """Counting gate for in-flight transfer credits.

    ``acquire`` blocks while ``in_flight >= depth`` (depth 0 =
    unbounded, accounting only). ``release`` refunds one credit; the
    refund is what keeps the gate honest across the NAK/retransmit
    ladder — a retransmitted page completes through the same handle,
    so its credit is refunded exactly once, on settlement, never on
    the NAK itself (the wire slot is still occupied while the
    retransmit runs)."""

    def __init__(self, depth: int, name: str = "stream") -> None:
        self.depth = max(0, int(depth))
        self.name = name
        self._cv = threading.Condition()
        self._in_flight = 0
        self._high_water = 0
        self._acquired = 0
        self._released = 0

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._in_flight

    @property
    def high_water(self) -> int:
        with self._cv:
            return self._high_water

    def acquire(self, timeout_s: Optional[float] = None) -> bool:
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._cv:
            while self.depth and self._in_flight >= self.depth:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                trace.add(f"serve.credit_stall.{self.name}", 1)
                self._cv.wait(0.05 if left is None else min(left, 0.05))
            self._in_flight += 1
            self._acquired += 1
            if self._in_flight > self._high_water:
                self._high_water = self._in_flight
            return True

    def release(self) -> None:
        with self._cv:
            if self._in_flight <= 0:
                raise RuntimeError(
                    f"credit underflow on gate {self.name!r}: "
                    "release without matching acquire")
            self._in_flight -= 1
            self._released += 1
            self._cv.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._cv:
            return {"depth": self.depth, "in_flight": self._in_flight,
                    "high_water": self._high_water,
                    "acquired": self._acquired,
                    "released": self._released}


# ---------------------------------------------------------------- inflight

class Inflight:
    """A launched transfer holding one credit.

    Proxies the underlying :class:`CollectiveHandle` (``wait``/``test``/
    ``done``/``coll``) and refunds its credit exactly once when the
    transfer settles — on successful completion OR on the error path
    (a failed transfer must not strand its credit, or a NAK storm
    starves the stream). ``release_on_settle=False`` defers the refund
    to an explicit :meth:`release` — for pagers whose credit maps to a
    scratch *window* that stays pinned after the wire work lands,
    until the consumer is done reading it."""

    def __init__(self, engine: "TransferEngine", handle: Any, tag: Any = None,
                 release_on_settle: bool = True) -> None:
        self._engine = engine
        self._handle = handle
        self.tag = tag
        self._release_on_settle = release_on_settle
        self._released = False
        self._settled = False

    @property
    def coll(self) -> int:
        return int(getattr(self._handle, "coll", 0))

    @property
    def handle(self) -> Any:
        return self._handle

    @property
    def done(self) -> bool:
        return bool(getattr(self._handle, "done", False))

    def _settle(self) -> None:
        if not self._settled:
            self._settled = True
            self._engine._settled(self)
            if self._release_on_settle:
                self.release()

    def release(self) -> None:
        """Refund this transfer's credit (idempotent)."""
        if not self._released:
            self._released = True
            self._engine.gate.release()

    def test(self) -> bool:
        """True once the transfer completed OK; raises on failure.
        Either way the credit is refunded when the transfer settles."""
        try:
            ok = self._handle.test()
        except BaseException:
            self._settle()
            raise
        if ok:
            self._settle()
        return ok

    def wait(self, timeout_ms: int = -1) -> None:
        """Block until completion; raises the transport's classified
        error on failure. A positive expired timeout raises retryable
        and leaves the transfer (and its credit) live — retry wait."""
        try:
            self._handle.wait(timeout_ms)
        except BaseException as e:
            if "still in flight" in str(e):
                raise  # not settled: the transfer is still running
            self._settle()
            raise
        self._settle()


class _LocalDone:
    """Loopback stand-in for a CollectiveHandle: a produce-only
    transfer with no wire leg (world=None pagers, unit tests). Settles
    immediately."""

    coll = 0
    done = True

    def test(self) -> bool:
        return True

    def wait(self, timeout_ms: int = -1) -> None:
        return None


# ------------------------------------------------------------------ engine

class TransferEngine:
    """Credit-gated producer/consumer transfer channels.

    One engine instance per client (the trainer's cross-slice sync,
    a weight pager, a KV stream): each owns a :class:`CreditGate` and
    an in-flight registry, shares the underlying ring's async
    collective thread, and spawns no threads. ``submit`` is the
    async-handle channel;
    ``pipeline`` is the executor-future channel (the staged-pipeline
    loop, verbatim semantics).
    """

    def __init__(self, depth: Optional[int] = None, name: str = "stream",
                 yield_after_launch: bool = False) -> None:
        if depth is None:
            depth = stream_depth()
        self.name = name
        self.gate = CreditGate(depth, name=name)
        self._yield = yield_after_launch
        self._lock = threading.Lock()
        self._live: Dict[int, Inflight] = {}
        self._submitted = 0
        self._closed = False

    # -- accounting ------------------------------------------------

    def _settled(self, inf: Inflight) -> None:
        with self._lock:
            self._live.pop(id(inf), None)

    @property
    def live(self) -> int:
        """Transfers submitted and not yet settled (the engine-level
        leak census; teardown drains this to zero)."""
        with self._lock:
            return len(self._live)

    def stats(self) -> Dict[str, Any]:
        s = self.gate.stats()
        with self._lock:
            s.update(name=self.name, submitted=self._submitted,
                     live=len(self._live))
        return s

    # -- async-handle channel --------------------------------------

    def submit(self, launch: Callable[[], Any],
               produce: Optional[Callable[[], None]] = None,
               tag: Any = None, release_on_settle: bool = True,
               yield_cpu: Optional[bool] = None) -> Inflight:
        """Acquire a credit, run ``produce()`` (fill scratch), then
        ``launch()`` (returns an async CollectiveHandle — or None for
        a produce-only loopback transfer) and track the result.

        ``yield_cpu`` (default: the engine's ``yield_after_launch``)
        re-enacts the bucketed launch's ``time.sleep(0)``: drop the
        GIL right after submission so the collective thread gets on the
        wire before the next produce step competes for cycles."""
        if self._closed:
            raise RuntimeError(f"TransferEngine {self.name!r} is closed")
        self.gate.acquire()
        try:
            if produce is not None:
                produce()
            handle = launch()
        except BaseException:
            self.gate.release()
            raise
        if handle is None:
            handle = _LocalDone()
        inf = Inflight(self, handle, tag=tag,
                       release_on_settle=release_on_settle)
        with self._lock:
            self._submitted += 1
            self._live[id(inf)] = inf
        if isinstance(handle, _LocalDone):
            inf._settle()
        if (self._yield if yield_cpu is None else yield_cpu):
            time.sleep(0)
        return inf

    # -- executor-future channel -----------------------------------

    def pipeline(self, items: Iterable[Any],
                 produce: Callable[[Any, int], None],
                 launch: Callable[[Any, int], Any],
                 consume: Callable[[Any, Any, int], None],
                 depth: Optional[int] = None) -> None:
        """The staged-pipeline deque loop over ``items``: for each item
        run ``produce(item, k)``, submit ``launch(item, k)`` (returns a
        concurrent Future), and ``consume(result, item, k)`` strictly
        in submission order once the future lands — consuming early
        whenever the head is already done, and always when the window
        is full. ``depth`` defaults to the engine's credit depth (the
        gate bounds produce-side scratch occupancy: produce for item
        k+depth never starts before item k was consumed).

        On any failure every launched future is drained before the
        error propagates — no worker is left writing into scratch that
        the caller is about to reuse (the staged pipeline's own error
        contract, kept verbatim)."""
        if depth is None:
            depth = self.gate.depth or stream_depth()
        depth = max(1, int(depth))
        pending: Deque[Tuple[Any, Any, int]] = collections.deque()

        def _consume_head() -> None:
            fut, item, k = pending.popleft()
            try:
                res = fut.result()
                consume(res, item, k)
            finally:
                self.gate.release()

        try:
            for k, item in enumerate(items):
                self.gate.acquire()
                try:
                    produce(item, k)
                    fut = launch(item, k)
                except BaseException:
                    self.gate.release()
                    raise
                with self._lock:
                    self._submitted += 1
                pending.append((fut, item, k))
                while len(pending) >= depth or (pending and pending[0][0].done()):
                    _consume_head()
            while pending:
                _consume_head()
        except BaseException:
            while pending:
                fut = pending.popleft()[0]
                try:
                    fut.result()
                except BaseException:
                    pass
                self.gate.release()
            raise

    # -- teardown --------------------------------------------------

    def drain(self, timeout_ms: int = 30000) -> None:
        """Wait every live transfer to settlement (errors swallowed —
        drain is the teardown path; the caller already has its
        primary error if there is one). Credits end refunded."""
        with self._lock:
            live = list(self._live.values())
        for inf in live:
            try:
                inf.wait(timeout_ms)
            except BaseException:
                pass
            inf.release()

    def close(self) -> None:
        """Drain and refuse further submits. Idempotent; the flat
        thread census is free (the engine never spawned any)."""
        if self._closed:
            return
        self.drain()
        self._closed = True
