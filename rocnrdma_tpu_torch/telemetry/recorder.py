"""Flight-recorder access: drain, merge, histogram math, snapshots —
the port's own copy of ``rocnrdma_tpu/telemetry/recorder.py``.

Everything here is a thin, dependency-free layer over the native C API
(``transport.engine`` ctypes) plus the Python tracer. The native ring
is DRAINED destructively (flight-recorder semantics — the consumer
owns what it read); callers that need to export the same window twice
drain once into a list and pass it around.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

from rocnrdma_tpu_torch.utils.trace import trace


@dataclass(frozen=True)
class TelEvent:
    """One timeline event, native or Python, in the nanoseconds of
    CLOCK_MONOTONIC, the clock the native recorder and the Python
    tracer share (not ``torch.profiler``'s, which is wall time)."""

    ts_ns: int
    name: str
    engine: int = 0      # native engine track (0 = none / python tier)
    qp: int = 0          # native qp track (0 = none)
    id: int = 0          # wr_id / frame seq / call seq
    arg: int = 0         # bytes / status / attempt (per event type)
    source: str = "native"
    fields: Dict[str, Any] = field(default_factory=dict)
    # Collective trace id (0 = none): stamped by the posting rank,
    # wire-carried to the peer under FEAT_COLL_ID — the join key for
    # cross-rank timeline merges. Bit 63 set = ring auto-assigned.
    coll: int = 0


def enabled() -> bool:
    from rocnrdma_tpu_torch.transport import engine as eng

    return eng.telemetry_enabled()


def enable(ring: Optional[int] = None) -> None:
    """Turn the native flight recorder on (sets TDR_TELEMETRY and
    resets the ring — recording starts empty)."""
    from rocnrdma_tpu_torch.transport import engine as eng

    os.environ["TDR_TELEMETRY"] = "1"
    if ring is not None:
        os.environ["TDR_TELEMETRY_RING"] = str(int(ring))
    eng.telemetry_reset()


def disable() -> None:
    """Turn recording off (event sites drop back to one branch)."""
    from rocnrdma_tpu_torch.transport import engine as eng

    os.environ["TDR_TELEMETRY"] = "0"
    eng.telemetry_reset()


def reset() -> None:
    """Clear the ring/histograms without changing the on/off state."""
    from rocnrdma_tpu_torch.transport import engine as eng

    eng.telemetry_reset()


_event_names: Dict[int, str] = {}


def _event_name(eng, ev_type: int) -> str:
    # Cached: the type table is ~18 constants; one FFI call per
    # drained event would dominate a full-ring drain after a soak.
    name = _event_names.get(ev_type)
    if name is None:
        name = _event_names[ev_type] = eng.telemetry_event_name(ev_type)
    return name


def drain(max_events: int = 1 << 20) -> List[TelEvent]:
    """Remove and return native events, oldest first."""
    from rocnrdma_tpu_torch.transport import engine as eng

    out = []
    for raw in eng.telemetry_drain(max_events):
        out.append(TelEvent(
            ts_ns=int(raw.ts_ns), name=_event_name(eng, raw.type),
            engine=int(raw.engine), qp=int(raw.qp), id=int(raw.id),
            arg=int(raw.arg), source="native", coll=int(raw.coll)))
    return out


def python_events() -> List[TelEvent]:
    """The Python tracer's ring as timeline events. time.monotonic()
    and the native recorder read the same Linux clock, so the float
    seconds convert straight to the shared nanosecond domain. Span
    events (``dur_s`` field) keep it in ``fields`` for exporters to
    render as durations."""
    out = []
    for ts, name, fields in trace.events():
        out.append(TelEvent(ts_ns=int(ts * 1e9), name=name,
                            source="python", fields=dict(fields)))
    return out


def timeline(include_python: bool = True,
             native: Optional[Iterable[TelEvent]] = None) -> List[TelEvent]:
    """One merged timeline: native events (drained now unless passed
    in) and the Python tracer's ring, sorted on the shared clock."""
    events = list(native) if native is not None else drain()
    if include_python:
        events.extend(python_events())
    events.sort(key=lambda e: e.ts_ns)
    return events


def events_to_wire(events: Iterable[TelEvent]) -> List[list]:
    """JSON-safe encoding of a timeline segment for the control-plane
    trace push (one short list per event — native events keep their
    numeric tracks, python events keep their field dicts)."""
    out: List[list] = []
    for e in events:
        if e.source == "native":
            out.append([int(e.ts_ns), e.name, int(e.engine), int(e.qp),
                        int(e.id), int(e.arg), int(e.coll)])
        else:
            out.append([int(e.ts_ns), e.name, dict(e.fields)])
    return out


def events_from_wire(wire: Iterable[list]) -> List[TelEvent]:
    """Inverse of :func:`events_to_wire` (tolerant: malformed entries
    are skipped — a diagnostics channel must not take the reader
    down)."""
    out: List[TelEvent] = []
    for w in wire or ():
        try:
            if len(w) == 3 and isinstance(w[2], dict):
                out.append(TelEvent(ts_ns=int(w[0]), name=str(w[1]),
                                    source="python", fields=dict(w[2])))
            elif len(w) >= 7:
                out.append(TelEvent(
                    ts_ns=int(w[0]), name=str(w[1]), engine=int(w[2]),
                    qp=int(w[3]), id=int(w[4]), arg=int(w[5]),
                    source="native", coll=int(w[6])))
        except (TypeError, ValueError, IndexError):
            continue
    return out


def counters() -> Dict[str, int]:
    """The unified native counter registry (integrity.*, fault.*,
    copy.*, telemetry.*) plus the Python tracer's counters — one
    namespace, native names winning on (non-existent) collisions."""
    from rocnrdma_tpu_torch.transport import engine as eng

    out: Dict[str, int] = dict(trace.counters())
    out.update(eng.native_counters())
    return out


def histograms() -> Dict[str, List[int]]:
    from rocnrdma_tpu_torch.transport import engine as eng

    return eng.telemetry_histograms()


# ------------------------------------------------------------ buckets

def bucket_upper(b: int) -> int:
    """Upper edge of log2 OCTAVE bucket ``b``: bucket 0 holds zeros;
    bucket b (>=1) holds values v with v.bit_length() == b, i.e.
    [2^(b-1), 2^b)."""
    return 0 if b <= 0 else (1 << b) - 1


def fine_bucket_upper(b: int) -> int:
    """Upper edge of FINE (log2 × 8) bucket ``b``: values 0..15 index
    themselves; above that, 8 linear sub-buckets per octave — bucket
    members are [(8+sub) << (oct-4), (8+sub+1) << (oct-4)). Mirrors
    the native fine_upper_of byte-for-byte (pinned against
    tdr_tel_hist_fine_upper in tests), so percentile estimates agree
    across languages."""
    if b < 0:
        return 0
    if b < 16:
        return b
    oct_ = (b - 8) // 8 + 4
    sub = (b - 8) % 8
    return ((8 + sub + 1) << (oct_ - 4)) - 1


def hist_percentile(buckets: Sequence[int], q: float) -> int:
    """Percentile estimate from a histogram row — the UPPER edge of
    the bucket containing the q-quantile (conservative for latencies:
    the true value is <= the estimate). q in [0, 100]. Rows longer
    than 64 are fine (log2 × 8) rows whose sub-octave edges bound the
    quantization error at 12.5% — the BENCH_r06 "saturated
    percentiles" fix: estimates are real numbers, not octave edges."""
    total = sum(buckets)
    if total == 0:
        return 0
    upper = bucket_upper if len(buckets) <= 64 else fine_bucket_upper
    target = total * q / 100.0
    acc = 0
    for b, count in enumerate(buckets):
        acc += count
        if acc >= target and count:
            return upper(b)
    return upper(len(buckets) - 1)


def hist_percentiles(buckets: Sequence[int],
                     qs: Sequence[float] = (50, 90, 99)) -> Dict[str, int]:
    return {f"p{q:g}": hist_percentile(buckets, q) for q in qs}


_warned_tainted = False
# Drop-counter watermark: the cumulative native dropped count last
# observed by a window-delimiting reader (overlap_fraction's own
# drain). Deltas against it scope the taint to the MEASURED window —
# one warmup overflow ages out instead of tainting every later clean
# window for the life of the process.
_drop_mark = 0


def _dropped_delta() -> int:
    global _drop_mark
    from rocnrdma_tpu_torch.transport import engine as eng

    cur = int(eng.telemetry_dropped())
    # A reset shrinks the cumulative counter: re-anchor, report clean.
    delta = cur - _drop_mark if cur >= _drop_mark else 0
    _drop_mark = cur
    return delta


def _warn_tainted_once(what: str, dropped: int) -> None:
    """Warn (once per process) that a derived fraction was computed
    over a ring window that overwrote events — a silently truncated
    ring skews every event-count-derived number."""
    global _warned_tainted
    if _warned_tainted:
        return
    _warned_tainted = True
    import warnings

    warnings.warn(
        f"{what}: the telemetry ring dropped {dropped} events inside "
        "the measured window (overwrite-oldest); event-derived "
        "fractions are skewed. Raise TDR_TELEMETRY_RING or drain more "
        "often.", RuntimeWarning, stacklevel=3)


def _merged_windows(events: Sequence[TelEvent],
                    span: str) -> List[List[int]]:
    """Sorted, overlap-merged [start_ns, end_ns] windows of every
    Python span named ``span`` in the timeline."""
    spans: List[List[int]] = []
    for e in events:
        if e.source == "python" and e.name == span and "dur_s" in e.fields:
            end = int(e.ts_ns)
            spans.append([end - int(float(e.fields["dur_s"]) * 1e9), end])
    spans.sort()
    merged: List[List[int]] = []
    for s in spans:
        if merged and s[0] <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s[1])
        else:
            merged.append(list(s))
    return merged


def _count_inside(wire_ts: Sequence[int],
                  merged: Sequence[Sequence[int]]) -> int:
    inside = 0
    i = 0
    for ts in wire_ts:
        while i < len(merged) and merged[i][1] < ts:
            i += 1
        if i < len(merged) and merged[i][0] <= ts:
            inside += 1
    return inside


def overlap_fraction(events: Optional[Sequence[TelEvent]] = None,
                     span: str = "trainer.grads",
                     wire: Sequence[str] = ("wire_tx", "wire_rx"),
                     dropped: Optional[int] = None,
                     compute_span: str = "trainer.backward"
                     ) -> Dict[str, Any]:
    """Measured backward-overlap of a recorded window: the fraction of
    native WIRE events (frame tx/rx instants) whose timestamps fall
    inside any ``span`` Python span — for the default
    ``trainer.grads``, the share of wire traffic that happened while
    the trainer was still inside its backward/gather phase, i.e. the
    wire time the bucketed overlap actually hid. 0 = fully serial
    (every frame moved after the grads span closed, the fused-blocking
    shape); 1 = every frame moved under the backward pass. Wire events
    are instants of near-uniform chunk size, so the event-count ratio
    is a faithful time-share estimate.

    The estimate is further SPLIT against the nested ``compute_span``
    (``trainer.backward``, the jitted grads dispatch itself):

    - ``compute_overlap_fraction`` — wire events inside the compute
      span: traffic that rode under the backward COMPUTATION (the
      per-layer gradient taps' launches land here). This is the
      number the per-layer overlap gate holds, because only it proves
      the wire hid behind work the step had to do anyway.
    - ``staging_overlap_fraction`` — wire events inside ``span`` but
      OUTSIDE the compute span: traffic overlapped only with the
      post-backward gather/stage loop (the bucketed path's shape).
      Staging overlap still beats fully-serial, but it cannot satisfy
      a compute-overlap gate on its own.

    ``overlap_fraction`` remains their sum (wire inside ``span``), so
    existing consumers read the same number they always did.

    ``events`` is a merged timeline (``telemetry.timeline()``); when
    None the native ring is drained now. Spans overlapping across
    steps are merged before counting.

    ``dropped``: events the native ring overwrote during the measured
    window. When None and this call drains the ring itself, the drop
    count DELTA since the previous window-delimiting drain is used
    (cumulative would taint every later clean window after one warmup
    overflow). Nonzero taints the estimate — wire events silently
    vanished, so the fraction is skewed — and the result carries
    ``tainted=True`` plus a once-per-process RuntimeWarning instead of
    a silently wrong number. The taint covers the split fractions the
    same way (they derive from the same counts)."""
    if events is None:
        if dropped is None:
            dropped = _dropped_delta()
        events = timeline()
    tainted = bool(dropped)
    if tainted:
        _warn_tainted_once("overlap_fraction", int(dropped))
    wire_ts = sorted(int(e.ts_ns) for e in events
                     if e.source == "native" and e.name in wire)
    merged = _merged_windows(events, span)
    compute = _merged_windows(events, compute_span)
    inside = _count_inside(wire_ts, merged)
    in_compute = _count_inside(wire_ts, compute)
    # Clamp: the compute span nests inside ``span`` by construction,
    # but a pathological timeline (clock skew, missing parent span)
    # must not produce a negative staging share.
    in_compute = min(in_compute, inside)
    total = len(wire_ts)

    def frac(n: int) -> float:
        return round(n / total, 4) if total else 0.0

    return {
        "span": span,
        "spans": len(merged),
        "compute_span": compute_span,
        "compute_spans": len(compute),
        "wire_events": total,
        "wire_in_span": inside,
        "wire_in_compute": in_compute,
        "overlap_fraction": frac(inside),
        "compute_overlap_fraction": frac(in_compute),
        "staging_overlap_fraction": frac(inside - in_compute),
        "dropped": int(dropped or 0),
        "tainted": tainted,
    }


# tools/tdr_explain.py's phase of each native event: the interval that
# ends at an event is charged to the event's phase.
_PHASE_OF = {
    "post_send": "post", "post_recv": "post", "post_write": "post",
    "post_read": "post",
    "wire_tx": "wire", "wire_rx": "wire", "wc": "wire",
    "land": "land",
    "verify_ok": "seal", "verify_fail": "seal", "nak": "seal",
    "retx": "seal",
    "fold": "fold", "fold_off": "fold",
}
PHASES = ("post", "wire", "land", "seal", "fold", "stall")


def ring_phase_split(events: Sequence[TelEvent]) -> Dict[str, Any]:
    """Seconds of the recorded collectives by native phase, by the rule
    of ``tools/tdr_explain.py``: the native events of each collective
    (joined by ``coll``) are taken in time order, and each interval
    between two of them is charged to the phase of the event that ends
    it — so ``wire`` is the time from a post to its ``wire_tx`` (and
    to ``wire_rx``, ``wc``), ``land`` the time from ``wire_rx`` to
    ``land``, ``fold`` the time up to each fold. The phases sum to the
    collectives' own spans; ``collectives`` counts them."""
    by_coll: Dict[int, List[TelEvent]] = {}
    for e in events:
        if e.source == "native" and e.coll:
            by_coll.setdefault(e.coll, []).append(e)
    out: Dict[str, Any] = {p: 0.0 for p in PHASES}
    for evs in by_coll.values():
        prev: Optional[int] = None
        for ev in sorted(evs, key=lambda e: e.ts_ns):
            if prev is not None:
                out[_PHASE_OF.get(ev.name, "stall")] += (ev.ts_ns - prev) / 1e9
            prev = ev.ts_ns
    out["collectives"] = len(by_coll)
    return out


def snapshot() -> Dict[str, Any]:
    """Counters + histograms + latency percentiles in one JSONable
    dict — what ``tdr_top`` renders and the bench record embeds.
    Histograms ship in the compact 64-octave view (sparklines);
    percentiles are computed from the FINE rows, so they carry
    sub-octave resolution."""
    from rocnrdma_tpu_torch.transport import engine as eng

    hists = histograms()
    fine = eng.telemetry_histograms_fine()
    return {
        "enabled": enabled(),
        "recorded": eng.telemetry_recorded(),
        "dropped": eng.telemetry_dropped(),
        "counters": counters(),
        "histograms": hists,
        "percentiles": {
            name: hist_percentiles(buckets)
            for name, buckets in fine.items()
        },
    }


def start_snapshot_writer(path: str, interval_s: float = 1.0):
    """Periodically write ``snapshot()`` to ``path`` (atomic rename)
    from a daemon thread — the producer side of ``tdr_top --file``.
    Returns an object with ``stop()``."""

    class _Writer:
        def __init__(self) -> None:
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="tdr-tel-snap")
            self._thread.start()

        def _run(self) -> None:
            while not self._stop.is_set():
                try:
                    tmp = path + ".tmp"
                    with open(tmp, "w") as f:
                        json.dump(snapshot(), f)
                    os.replace(tmp, path)
                except Exception:
                    pass  # diagnostics must never take the workload down
                self._stop.wait(interval_s)

        def stop(self) -> None:
            self._stop.set()
            self._thread.join(timeout=5)

    return _Writer()


def anchor() -> Dict[str, float]:
    """Clock-domain anchor: the native and Python readings of the one
    monotonic clock, taken back to back (tests assert they agree)."""
    from rocnrdma_tpu_torch.transport import engine as eng

    py0 = time.monotonic()
    native = eng.telemetry_now_ns()
    py1 = time.monotonic()
    return {"python_ns_lo": py0 * 1e9, "native_ns": float(native),
            "python_ns_hi": py1 * 1e9}
