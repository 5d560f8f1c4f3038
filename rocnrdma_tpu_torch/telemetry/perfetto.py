"""Chrome/Perfetto trace export — the port's own copy of
``rocnrdma_tpu/telemetry/perfetto.py``.

Emits the Chrome Trace Event JSON format (the ``traceEvents`` array),
which https://ui.perfetto.dev opens directly. Track mapping:

- **pid** = native engine track id (one "process" per rank/engine; the
  ``engine_labels`` argument names them, e.g. ``{1: "rank0/emu"}``).
  Python-tier events ride pid 0, labeled "python".
- **tid** = native QP track id (one "thread" per QP; 0 = engine-level
  events like ring_begin/ring_end, or the python tier).

Native chunk-lifecycle events render as instants carrying
``{"id", "arg"}`` args (id = wr_id/frame seq — follow one chunk's
post → tx → rx → land → verify → nak → retx → wc across the two
ranks' tracks by its id). Python ``trace.span`` events (those with a
``dur_s`` field) render as complete ("X") slices, so a trainer step
or a collective call appears as a bar over the chunk instants it
contains.

The export is DETERMINISTIC for a given event list: events are sorted
by (ts, pid, tid, name, id) and serialized with sorted keys, so the
same recording always produces byte-identical JSON (the
replay-stability contract tests pin).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from rocnrdma_tpu_torch.telemetry.recorder import TelEvent, timeline


def _meta(pid: int, tid: Optional[int], name: str) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ph": "M", "pid": pid, "ts": 0,
        "name": "process_name" if tid is None else "thread_name",
        "args": {"name": name},
    }
    if tid is not None:
        ev["tid"] = tid
    return ev


def _tier_of_world(world_name: str) -> Optional[str]:
    """Tier label for a RingWorld name: the hierarchical tier
    sub-worlds are named ``<parent>.intra`` (co-located CMA group) and
    ``<parent>.x<local_rank>`` (inter-host delegate ring) by
    RingWorld._ensure_tiers — the one naming convention both ends of
    the trace pipeline share."""
    if world_name.endswith(".intra"):
        return "intra"
    tail = world_name.rsplit(".", 1)
    if len(tail) == 2 and tail[1][:1] == "x" and tail[1][1:].isdigit():
        return "inter"
    return None


def qp_lane_labels(events: List[TelEvent]) -> Dict[int, str]:
    """Per-QP-lane labels derived from the python tracer's
    ``world.up`` events (tel_left/tel_right carry the native lane
    ids). Tier rings label as ``tier=intra|inter`` with the tier
    world's name, so a hierarchical trace's delegate-ring lanes are
    readable next to the parent world's instead of rendering as
    anonymous qpN tracks."""
    labels: Dict[int, str] = {}
    for ev in events:
        if ev.source != "python" or ev.name != "world.up":
            continue
        f = ev.fields
        wname = str(f.get("world_name", ""))
        tier = _tier_of_world(wname)
        tag = f"tier={tier} {wname}" if tier else wname
        for side, lanes in (("left", f.get("tel_left")),
                            ("right", f.get("tel_right"))):
            if not isinstance(lanes, (list, tuple)):
                continue
            for c, lane in enumerate(lanes):
                try:
                    lane = int(lane)
                except (TypeError, ValueError):
                    continue
                labels[lane] = f"qp{lane} {tag} {side}[{c}]"
    return labels


def export_trace(path: Optional[str] = None,
                 events: Optional[List[TelEvent]] = None,
                 include_python: bool = True,
                 engine_labels: Optional[Dict[int, str]] = None
                 ) -> Dict[str, Any]:
    """Build (and optionally write) a Perfetto-loadable trace dict.

    ``events``: a merged timeline from ``telemetry.timeline()``; when
    None, the native ring is drained and merged with the Python tracer
    now. ``engine_labels`` names the per-engine process tracks (e.g.
    ``{world.engine.telemetry_id: f"rank{world.rank}"}``)."""
    if events is None:
        events = timeline(include_python=include_python)
    labels = engine_labels or {}

    trace_events: List[Dict[str, Any]] = []
    seen_pids: Dict[int, None] = {}
    seen_tids: Dict[tuple, None] = {}
    lane_names: Dict[tuple, set] = {}  # event names seen per lane

    for ev in sorted(events, key=lambda e: (e.ts_ns, e.engine, e.qp,
                                            e.name, e.id)):
        ts_us = ev.ts_ns / 1000.0
        pid = ev.engine if ev.source == "native" else 0
        if ev.source == "native":
            tid = ev.qp
        else:
            # Python spans may claim their own lane (a ``lane=`` field
            # — the bucketed sync stamps one per bucket), so
            # concurrent bucket gather/scatter bars render as parallel
            # lanes instead of stacking on the tracer lane.
            try:
                tid = int(ev.fields.get("lane", 0) or 0)
            except (TypeError, ValueError):
                tid = 0
        seen_pids.setdefault(pid)
        seen_tids.setdefault((pid, tid))
        if ev.source == "native":
            lane_names.setdefault((pid, tid), set()).add(ev.name)
        if ev.source == "python" and "dur_s" in ev.fields:
            dur_us = float(ev.fields["dur_s"]) * 1e6
            args = {k: v for k, v in ev.fields.items()
                    if k not in ("dur_s", "lane")}
            trace_events.append({
                "name": ev.name, "ph": "X", "pid": pid, "tid": tid,
                "ts": ts_us - dur_us, "dur": dur_us, "args": args,
            })
            continue
        args: Dict[str, Any]
        if ev.source == "native":
            args = {"id": ev.id, "arg": ev.arg}
            if ev.coll:
                # The cross-rank join key: follow one collective's
                # events across every rank's process by this value.
                args["coll"] = ev.coll
        else:
            args = dict(ev.fields)
        trace_events.append({
            "name": ev.name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
            "ts": ts_us, "args": args,
        })

    meta: List[Dict[str, Any]] = []
    qp_labels = qp_lane_labels([e for e in events
                                if e.source == "python"])
    for pid in sorted(seen_pids):
        label = labels.get(pid, "python" if pid == 0 else f"engine{pid}")
        meta.append(_meta(pid, None, label))
    for pid, tid in sorted(seen_tids):
        # Helper-thread lanes (progress shards, fold workers) share
        # the QP track-id space but carry only their own event kinds:
        # name them by what runs on them, so the per-shard and fold
        # lanes read as parallel workers next to the QP lanes instead
        # of masquerading as connections.
        kinds = lane_names.get((pid, tid), set())
        if pid == 0 and tid == 0:
            name = "tracer"
        elif pid == 0:
            name = f"lane{tid}"  # python span lanes (bucket bars)
        elif tid == 0:
            name = "engine"
        elif "shard" in kinds:
            name = f"shard{tid}"
        elif kinds and kinds <= {"fold", "fold_off"}:
            name = f"fold{tid}"
        else:
            # world.up-derived label when available: names the lane's
            # owning world and — for hierarchical tier rings — its
            # tier (intra CMA group vs inter-host delegate ring), so
            # a hier trace reads without guessing which qpN belongs
            # to which ring.
            name = qp_labels.get(tid, f"qp{tid}")
        meta.append(_meta(pid, tid, name))

    doc = {
        "displayTimeUnit": "ms",
        "traceEvents": meta + trace_events,
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return doc


def dumps(doc: Dict[str, Any]) -> str:
    """The canonical (deterministic) serialization of an export."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


# --------------------------------------------------------- fleet merge

def _rank_pid(rank: int, engine: int) -> int:
    """Fleet pid scheme: one numeric block per rank so every rank's
    engine and python tracks render as distinct processes in one
    trace. Engine track ids are process-local bring-up ordinals (tiny
    ints), so a 1000-wide block never collides."""
    return (int(rank) + 1) * 1000 + int(engine)


def merge_fleet(segments: Dict[Any, Dict[str, Any]],
                path: Optional[str] = None) -> Dict[str, Any]:
    """Merge per-rank event segments (a ``collect_trace`` result's
    ``segments`` map) into ONE Perfetto trace: process = rank (labeled
    ``rank<r>/engine`` / ``rank<r>/python``), thread = QP lane as in
    the single-rank export, timestamps shifted into the COORDINATOR's
    clock domain by each rank's NTP-style ``clock_offset_ns`` — the
    first timeline in which two ranks' events for one collective sit
    at comparable instants and join by ``coll``.

    ``segments``: {rank: {"events": wire-encoded list
    (recorder.events_to_wire), "clock_offset_ns": int, "dropped": int,
    ...}}. Deterministic for a given input, like ``export_trace``."""
    from rocnrdma_tpu_torch.telemetry.recorder import events_from_wire

    trace_events: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    tainted: Dict[int, int] = {}
    for rank_key in sorted(segments, key=lambda k: int(k)):
        rank = int(rank_key)
        seg = segments[rank_key]
        offset = int(seg.get("clock_offset_ns", 0) or 0)
        dropped = int(seg.get("dropped", 0) or 0)
        if dropped:
            tainted[rank] = dropped
        events = events_from_wire(seg.get("events"))
        qp_labels = qp_lane_labels([e for e in events
                                    if e.source == "python"])
        seen_pids: Dict[int, str] = {}
        seen_tids: Dict[tuple, set] = {}
        for ev in sorted(events, key=lambda e: (e.ts_ns, e.engine, e.qp,
                                                e.name, e.id)):
            # offset ≈ coordinator_clock - rank_clock (min-RTT
            # filtered), so adding it moves this rank's timestamps
            # into the shared coordinator domain.
            ts_us = (ev.ts_ns + offset) / 1000.0
            if ev.source == "native":
                pid = _rank_pid(rank, ev.engine)
                tid = ev.qp
                seen_pids.setdefault(pid, f"rank{rank}/engine")
                seen_tids.setdefault((pid, tid), set()).add(ev.name)
                args: Dict[str, Any] = {"id": ev.id, "arg": ev.arg,
                                        "rank": rank}
                if ev.coll:
                    args["coll"] = ev.coll
                trace_events.append({
                    "name": ev.name, "ph": "i", "s": "t", "pid": pid,
                    "tid": tid, "ts": ts_us, "args": args,
                })
                continue
            pid = _rank_pid(rank, 0)
            try:
                tid = int(ev.fields.get("lane", 0) or 0)
            except (TypeError, ValueError):
                tid = 0
            seen_pids.setdefault(pid, f"rank{rank}/python")
            seen_tids.setdefault((pid, tid), set())
            if "dur_s" in ev.fields:
                dur_us = float(ev.fields["dur_s"]) * 1e6
                args = {k: v for k, v in ev.fields.items()
                        if k not in ("dur_s", "lane")}
                args["rank"] = rank
                trace_events.append({
                    "name": ev.name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": ts_us - dur_us, "dur": dur_us, "args": args,
                })
            else:
                args = dict(ev.fields)
                args["rank"] = rank
                trace_events.append({
                    "name": ev.name, "ph": "i", "s": "t", "pid": pid,
                    "tid": tid, "ts": ts_us, "args": args,
                })
        for pid in sorted(seen_pids):
            meta.append(_meta(pid, None, seen_pids[pid]))
        for pid, tid in sorted(seen_tids):
            kinds = seen_tids[(pid, tid)]
            if pid % 1000 == 0:
                name = "tracer" if tid == 0 else f"lane{tid}"
            elif tid == 0:
                name = "engine"
            elif "shard" in kinds:
                name = f"shard{tid}"
            elif kinds and kinds <= {"fold", "fold_off"}:
                name = f"fold{tid}"
            else:
                name = qp_labels.get(tid, f"qp{tid}")
            meta.append(_meta(pid, tid, name))
    doc = {
        "displayTimeUnit": "ms",
        "traceEvents": meta + trace_events,
    }
    if tainted:
        # Surfaced, not silent: a rank whose ring overwrote events
        # inside the collected window skews every event-derived
        # readout downstream (the telemetry.dropped satellite rule).
        doc["tdr_tainted_ranks"] = {str(r): n
                                    for r, n in sorted(tainted.items())}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return doc


def collect_and_merge(coordinator: str, world: str,
                      timeout_s: float = 30.0,
                      max_events: int = 65536) -> Dict[str, Any]:
    """One-call fleet collection: ask the coordinator to pull bounded
    per-rank trace segments (served by each member's heartbeat thread)
    and return {"segments": raw per-rank segments, "trace": the merged
    Perfetto doc, ...} — the programmatic form of the CLI below."""
    from rocnrdma_tpu_torch.control.client import ControlClient

    client = ControlClient(coordinator)
    resp = client.collect_trace(world, timeout_s=timeout_s,
                                max_events=max_events)
    segments = resp.get("segments") or {}
    if not segments:
        raise RuntimeError(f"collect_trace failed: {resp.get('error')}")
    # A collect timeout returns ok=False WITH whatever arrived (a dead
    # rank whose lease hasn't expired can never push): merge the
    # partial fleet — during an incident partial visibility beats
    # none — and say so instead of discarding it.
    return {
        "world": world,
        "generation": resp.get("generation"),
        "world_size": resp.get("world_size"),
        "segments": segments,
        "partial": not resp.get("ok"),
        "error": resp.get("error"),
        "trace": merge_fleet(segments),
    }


def _main(argv=None) -> int:
    """CLI: ``python -m rocnrdma_tpu_torch.telemetry.perfetto --collect
    HOST:PORT --world NAME -o trace.json [--raw segments.json]`` —
    one command, one whole-world timeline."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m rocnrdma_tpu_torch.telemetry.perfetto",
        description="Collect per-rank flight-recorder segments from a "
                    "coordinator-arbitrated world and merge them into "
                    "one clock-aligned Perfetto trace.")
    ap.add_argument("--collect", metavar="HOST:PORT", required=True,
                    help="coordinator address")
    ap.add_argument("--world", required=True, help="world name")
    ap.add_argument("-o", "--out", default="fleet_trace.json",
                    help="merged Perfetto trace output path")
    ap.add_argument("--raw", default=None,
                    help="also write the raw per-rank segments (the "
                         "tdr_explain input) to this path")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--max-events", type=int, default=65536,
                    help="per-rank event bound for the pull")
    args = ap.parse_args(argv)
    res = collect_and_merge(args.collect, args.world,
                            timeout_s=args.timeout,
                            max_events=args.max_events)
    with open(args.out, "w") as f:
        json.dump(res["trace"], f, sort_keys=True, separators=(",", ":"))
    if args.raw:
        with open(args.raw, "w") as f:
            json.dump({"world": res["world"],
                       "generation": res["generation"],
                       "world_size": res["world_size"],
                       "segments": res["segments"]}, f)
    ranks = sorted(res["segments"], key=lambda k: int(k))
    n_ev = sum(len(res["segments"][r].get("events") or [])
               for r in ranks)
    print(f"merged {len(ranks)} ranks ({n_ev} events) -> {args.out}")
    if res.get("partial"):
        missing = res.get("world_size", 0) - len(ranks)
        print(f"WARNING: PARTIAL fleet trace ({res.get('error')}); "
              f"{missing} rank(s) never pushed")
    tainted = res["trace"].get("tdr_tainted_ranks")
    if tainted:
        print(f"WARNING: ring drops inside the window on ranks "
              f"{sorted(tainted)} — event-derived numbers are skewed")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised by smokes
    import sys

    sys.exit(_main())
