"""Structured tracing (the port's own copy of
``rocnrdma_tpu/utils/trace.py``).

The reference's only observability is printk macro families with a
module-name prefix (``amdp2p.c:57-64``, ``tests/amdp2ptest.c:68-73``),
toggled via dynamic debug. Here tracing is structured from the start:
named scopes, per-event counters, and an in-memory ring readable by
tests — so pass/fail never depends on a human reading dmesg
(SURVEY.md §4's main criticism of the reference).

Ring events are stamped with ``time.monotonic()``, the native flight
recorder's CLOCK_MONOTONIC; ``torch.profiler`` stamps wall time. So a
span meets the device trace through the profiler itself: while the
profiler records, ``span`` also opens a ``record_function`` range of the
same name. A span given a CUDA ``device`` times its work on the device
as well, while the profiler records or the telemetry recorder is on
(``telemetry.enable()``): a pair of timing events on that device's
current stream, read back without a host synchronisation into the ring
event's ``dev_s`` (:meth:`_Tracer.span`). Otherwise a span costs one
flag check more than a bare event.

This module never imports torch (the control plane imports it, torch
free): it finds torch, once loaded, in ``sys.modules``.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
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


def _profiling() -> bool:
    """Whether ``torch.profiler`` records (torch's own flag for fast
    checks, False where torch is not loaded)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def _device_event(device):
    """A timing event recorded now on ``device``'s current stream, or
    None where ``device`` is no CUDA device or that stream is being
    captured into a graph (a captured event would be replayed, not
    read)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


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
        # Device-timed spans whose end event may still be on the device:
        # id(fields) -> (fields, start event, end event).
        self._pending: Dict[int, Tuple[Dict[str, Any], Any, Any]] = {}
        # Whether the telemetry recorder is on (TDR_TELEMETRY as the
        # native recorder reads it; telemetry_reset keeps it current).
        env = os.environ.get("TDR_TELEMETRY", "")
        self._telemetry = bool(env) and not env.startswith("0")

    def time_devices(self, on: bool) -> None:
        """Time device spans while ``on`` (the telemetry recorder's
        state, set where the native recorder is reset)."""
        self._telemetry = bool(on)

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
        """The ring's events, oldest first; a device-timed span's
        ``dev_s`` is read back first (waiting for its end event where
        the device has not reached it)."""
        self._settle()
        with self._lock:
            if self._pending:   # closed meanwhile: a copy stays unchanged
                evs = [(t, n, dict(f) if id(f) in self._pending else f)
                       for t, n, f in self._ring]
            else:
                evs = list(self._ring)
        if name is None:
            return evs
        return [e for e in evs if e[1] == name]

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._ring.clear()
            self._pending.clear()

    @contextmanager
    def span(self, name: str, device: Any = None,
             **fields: Any) -> Iterator[None]:
        """An event ``name`` with ``dur_s``, the host seconds the block
        took, and ``fields``. While ``torch.profiler`` records, the
        block is also a ``record_function`` range ``name``. Given a CUDA
        ``device``, while the profiler records or the telemetry recorder
        is on, the event gains ``dev_s``: the seconds between two timing
        events recorded on the device's current stream as the block
        opens and closes. It is read once the device has passed the end
        event (at a later span's close, by ``query()``), or when the
        ring is read (:meth:`events`); never by a synchronisation at the
        close."""
        profiling = _profiling()
        if not (profiling or self._telemetry):
            t0 = time.monotonic()
            try:
                yield
            finally:
                self.event(name, dur_s=time.monotonic() - t0, **fields)
            return
        rf = None
        if profiling:
            rf = sys.modules["torch.autograd.profiler"].record_function(name)
            rf.__enter__()
        start = None if device is None else _device_event(device)
        t0 = time.monotonic()
        try:
            yield
        finally:
            fields = dict(dur_s=time.monotonic() - t0, **fields)
            end = None if start is None else _device_event(device)
            if rf is not None:
                rf.__exit__(None, None, None)
            self._close(name, fields, start, end)

    def _close(self, name: str, fields: Dict[str, Any], start, end) -> None:
        """A device-timed span's event; then ``dev_s`` of every pending
        span whose end event the device has passed."""
        now = time.monotonic()
        with self._lock:
            self._counters[name] += 1
            self._ring.append((now, name, fields))
            if end is not None:
                self._pending[id(fields)] = (fields, start, end)
            for key, (f, s, e) in list(self._pending.items()):
                if e.query():
                    del self._pending[key]
                    f["dev_s"] = s.elapsed_time(e) / 1e3
        if _LOG.isEnabledFor(logging.DEBUG):
            _LOG.debug("%s %s", name, fields)

    def _settle(self) -> None:
        """``dev_s`` of every pending span, waiting for the device where
        it has not reached a span's end event yet."""
        with self._lock:
            todo = list(self._pending.items())
        for key, (f, s, e) in todo:
            e.synchronize()
            dev_s = s.elapsed_time(e) / 1e3
            with self._lock:
                if self._pending.pop(key, None) is not None:
                    f["dev_s"] = dev_s


trace = _Tracer()
