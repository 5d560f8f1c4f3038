"""Structured tracing (the port's own copy of
``rocnrdma_tpu/utils/trace.py``).

The reference's only observability is printk macro families with a
module-name prefix (``amdp2p.c:57-64``, ``tests/amdp2ptest.c:68-73``),
toggled via dynamic debug. Here tracing is structured from the start:
named scopes, per-event counters, and an in-memory ring readable by
tests — so pass/fail never depends on a human reading dmesg
(SURVEY.md §4's main criticism of the reference).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, Tuple
from contextlib import contextmanager

_LOG = logging.getLogger("rocnrdma_tpu_torch")
if os.environ.get("TDR_DEBUG"):
    logging.basicConfig(level=logging.DEBUG)
    _LOG.setLevel(logging.DEBUG)

def _ring_cap() -> int:
    """Event-ring bound (TDR_TRACE_RING overrides, min 64): long soak
    runs must not grow memory without limit — counters keep the full
    tally, the ring keeps only the last N events."""
    env = os.environ.get("TDR_TRACE_RING", "")
    if env:
        try:
            v = int(env)
            if v > 0:
                return max(v, 64)  # clamp UP to the documented minimum
        except ValueError:
            pass
    return 4096


_RING_CAP = _ring_cap()


class _Tracer:
    """Process-wide event tracer: counters + bounded event ring.

    Thread-safe by contract, not by accident: events and counters are
    bumped from transport poller/progress threads, the staged-pipeline
    worker, and per-rank test threads concurrently — every access to
    the counter dict and the ring goes through ``_lock``. The ring is
    a fixed-capacity deque (last ``_RING_CAP`` events), so unbounded
    soak runs keep bounded memory; ``integrity.*`` and other
    high-frequency counters use ``add`` (no ring entry) rather than
    per-increment events."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._hists: Dict[str, Dict[int, int]] = {}
        self._ring: Deque[Tuple[float, str, Dict[str, Any]]] = collections.deque(
            maxlen=_RING_CAP
        )

    def event(self, name: str, **fields: Any) -> None:
        now = time.monotonic()
        with self._lock:
            self._counters[name] += 1
            self._ring.append((now, name, fields))
        if _LOG.isEnabledFor(logging.DEBUG):
            _LOG.debug("%s %s", name, fields)

    def add(self, name: str, n: int = 1) -> None:
        """Bump a counter by ``n`` without recording a ring event —
        for bulk/delta accounting (the ``integrity.*`` counters fold
        native seal-counter deltas in through here)."""
        if n <= 0:
            return
        with self._lock:
            self._counters[name] += n

    def hist(self, name: str, value: int) -> None:
        """Record ``value`` into a log2×8 (fine-octave) histogram.

        Bucket math mirrors ``telemetry.recorder.fine_bucket_upper``
        (inlined here — utils must not import telemetry): values < 16
        map 1:1 to buckets 0..15; above that each power-of-two octave
        splits into 8 sub-buckets, so p99 reads stay within ~12.5 % of
        the true value across the whole range. Serving pushes token
        latencies through here; the heartbeat ships the sparse dict to
        the coordinator next to the native octave histograms."""
        v = int(value)
        if v < 0:
            v = 0
        if v < 16:
            b = v
        else:
            oct_ = v.bit_length()
            sub = (v >> (oct_ - 4)) - 8
            b = 8 + 8 * (oct_ - 4) + sub
        with self._lock:
            row = self._hists.setdefault(name, {})
            row[b] = row.get(b, 0) + 1

    def hists(self) -> Dict[str, Dict[int, int]]:
        """Snapshot of all fine histograms as sparse ``{bucket: count}``
        rows (the same shape ``world._hists`` ships natively)."""
        with self._lock:
            return {k: dict(v) for k, v in self._hists.items()}

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def counters_prefixed(self, prefix: str) -> Dict[str, int]:
        """Counters under a dotted namespace (e.g. ``"world."`` →
        ``world.up``/``world.rebuild``/…) — the recovery tests assert
        whole-path observability with one call."""
        with self._lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def events(self, name: str | None = None) -> List[Tuple[float, str, Dict[str, Any]]]:
        with self._lock:
            evs = list(self._ring)
        if name is None:
            return evs
        return [e for e in evs if e[1] == name]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._ring.clear()

    @contextmanager
    def span(self, name: str, **fields: Any) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.event(name, dur_s=time.monotonic() - t0, **fields)


trace = _Tracer()
