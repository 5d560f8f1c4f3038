"""Straggler and critical-path attribution for a fleet: the port's own
copy of the analysis in ``tools/tdr_explain.py``.

Consumes the per-rank flight-recorder segments that a ``collect_trace``
pull (or a postmortem incident directory) produces and answers the
cross-rank questions one rank's ring never could:

* **Per-collective decomposition**: every collective's wall time on
  every rank, split into post / wire / land / seal / fold / stall,
  joined across ranks by the wire-carried ``coll`` id, timestamps
  aligned by each rank's min-RTT clock offset.
* **Straggler attribution**: which rank enters each collective last,
  and how often over the window.
* **Per-link bandwidth**: tx→rx pairs matched by (channel lane, frame
  seq) across neighbour ranks give MB/s per directed link, per tier for
  hierarchical worlds.
* **Postmortem merge** (``--postmortem DIR``, ``explain_postmortem``):
  one incident's bundles from every rank merged into a single readout —
  who reported what error, whose integrity ladder was moving, and the
  final seconds of every rank's timeline.

The port's counterpart of ``tools/tdr_explain.py``, command line
included; it reads the port's segments and bundles::

    python3 -m rocnrdma_tpu_torch.tools.explain --postmortem DIR
    python3 -m rocnrdma_tpu_torch.tools.explain --collect HOST:PORT --world W
    python3 -m rocnrdma_tpu_torch.tools.explain --trace RAW.json --json
    python3 tools/torch_explain.py ...     # the same ``main``

Inputs: ``--collect HOST:PORT --world NAME`` (a live pull through the
coordinator), ``--trace RAW.json`` (segments saved by ``python -m
rocnrdma_tpu_torch.telemetry.perfetto --raw``), or ``--postmortem DIR``
(an ``incident-g<N>`` directory of rank bundles). ``--json`` emits the
full machine-readable analysis; ``--out`` also writes the merged
Perfetto trace.

Phase attribution rule: within one (rank, collective) event stream, the
interval ending at each event is charged to that event's phase (post_*
→ post; wire_tx/wire_rx/wc → wire; land → land; verify/nak/retx → seal;
fold/fold_off → fold; everything else → stall). Ranks whose segment
overlapped a nonzero telemetry drop are flagged ``tainted``.

It imports nothing but the standard library and the port's telemetry
and stream-id helpers; ``tools/torch_trace_smoke.py`` imports its
analysis.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from rocnrdma_tpu_torch.serving.stream import (
    is_stream_coll as _is_stream_coll,
    stream_coll_request as _stream_coll_request)
from rocnrdma_tpu_torch.telemetry.perfetto import (_tier_of_world,
                                                   collect_and_merge,
                                                   merge_fleet)
from rocnrdma_tpu_torch.telemetry.recorder import TelEvent, events_from_wire


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


def _lane_maps(events: List[TelEvent]) -> Dict[int, Dict[str, Any]]:
    """lane id -> {world_name, tier, side, chan, rank, size} from the
    python tracer's world.up events (the one place the native lane
    ordinals are tied to ring topology)."""
    lanes: Dict[int, Dict[str, Any]] = {}
    for ev in events:
        if ev.source != "python" or ev.name != "world.up":
            continue
        f = ev.fields
        wname = str(f.get("world_name", ""))
        base = {
            "world": wname, "tier": _tier_of_world(wname) or "flat",
            "rank": int(f.get("rank", -1)),
            "size": int(f.get("world", 0)),
        }
        for side in ("left", "right"):
            for c, lane in enumerate(f.get(f"tel_{side}") or ()):
                try:
                    lanes[int(lane)] = dict(base, side=side, chan=c)
                except (TypeError, ValueError):
                    continue
    return lanes


def _decompose(events: List[TelEvent]) -> Dict[str, float]:
    """Charge each inter-event interval to the ending event's phase
    (module docstring rule). Returns seconds per phase; the sum equals
    the stream's first→last span."""
    out = {p: 0.0 for p in PHASES}
    prev: Optional[int] = None
    for ev in sorted(events, key=lambda e: e.ts_ns):
        if prev is not None:
            out[_PHASE_OF.get(ev.name, "stall")] += (ev.ts_ns - prev) / 1e9
        prev = ev.ts_ns
    return out


def analyze_segments(segments: Dict[Any, Dict[str, Any]],
                     max_colls: int = 64) -> Dict[str, Any]:
    """The core analysis over a {rank: segment} map (each segment:
    wire-encoded ``events``, ``clock_offset_ns``, ``dropped``)."""
    ranks: Dict[int, List[TelEvent]] = {}
    offsets: Dict[int, int] = {}
    tainted: Dict[int, int] = {}
    lanes: Dict[int, Dict[str, Any]] = {}
    lane_rank: Dict[int, int] = {}
    for key in sorted(segments, key=lambda k: int(k)):
        r = int(key)
        seg = segments[key]
        off = int(seg.get("clock_offset_ns", 0) or 0)
        offsets[r] = off
        if int(seg.get("dropped", 0) or 0):
            tainted[r] = int(seg["dropped"])
        evs = events_from_wire(seg.get("events"))
        # Shift into the coordinator clock domain once, up front.
        ranks[r] = [TelEvent(ts_ns=e.ts_ns + off, name=e.name,
                             engine=e.engine, qp=e.qp, id=e.id,
                             arg=e.arg, source=e.source,
                             fields=e.fields, coll=e.coll)
                    for e in evs]
        rl = _lane_maps(ranks[r])
        lanes.update(rl)
        for lane in rl:
            lane_rank[lane] = r

    # ---- degradation-ladder attribution: the python tracer's
    # health.degrade / health.heal events name WHICH link the ladder
    # acted on — a rank straggling behind (or reporting) a degraded
    # link is a link problem, not a compute problem, and the readout
    # should say so. Engaged state is replayed in order (a heal
    # retires its degrade), so the map holds links still degraded at
    # the end of the window.
    degraded: Dict[int, Dict[str, Dict[str, Any]]] = {}
    for r, evs in ranks.items():
        for e in sorted(evs, key=lambda e: e.ts_ns):
            if e.source != "python":
                continue
            if e.name == "health.degrade":
                f = e.fields
                degraded.setdefault(r, {})[str(f.get("link"))] = {
                    "peer": int(f.get("peer", -1)),
                    "rung": str(f.get("rung", "")),
                    "score": f.get("score"),
                }
            elif e.name == "health.heal":
                degraded.get(r, {}).pop(
                    str(e.fields.get("link")), None)

    # ---- group native events by collective id, per rank ----
    by_coll: Dict[int, Dict[int, List[TelEvent]]] = {}
    for r, evs in ranks.items():
        for e in evs:
            if e.source == "native" and e.coll:
                by_coll.setdefault(e.coll, {}).setdefault(r, []).append(e)

    colls: List[Dict[str, Any]] = []
    straggler_votes: Dict[int, int] = {}
    wall_sums: Dict[int, float] = {}
    joinable = 0
    for coll in sorted(by_coll):
        per_rank = by_coll[coll]
        if len(per_rank) > 1:
            joinable += 1
        ranks_out: Dict[str, Any] = {}
        begins: Dict[int, int] = {}
        for r, evs in per_rank.items():
            evs.sort(key=lambda e: e.ts_ns)
            begin = min((e.ts_ns for e in evs if e.name == "ring_begin"),
                        default=evs[0].ts_ns)
            end = max((e.ts_ns for e in evs if e.name == "ring_end"),
                      default=evs[-1].ts_ns)
            begins[r] = begin
            wall = max(end - begin, 0) / 1e9
            wall_sums[r] = wall_sums.get(r, 0.0) + wall
            phases = _decompose([e for e in evs
                                 if begin <= e.ts_ns <= end])
            bytes_tx = sum(e.arg for e in evs if e.name == "wire_tx")
            ranks_out[str(r)] = {
                "wall_s": round(wall, 6),
                "phases_s": {p: round(v, 6)
                             for p, v in phases.items() if v},
                "events": len(evs),
                "tx_bytes": int(bytes_tx),
                "retx": sum(1 for e in evs if e.name == "retx"),
            }
        # Straggler = the rank that ENTERS the collective last: in a
        # blocking SPMD collective every rank's END is synchronized by
        # the data dependency (all wait on the slowest), so "finished
        # last" is clock noise — but the slow rank ARRIVES late while
        # its peers park at their ring_begin waiting for it. Arrival
        # skew is exactly the straggler signal a training fleet shows.
        straggler = max(begins, key=begins.get) if begins else None
        if straggler is not None and len(begins) > 1:
            straggler_votes[straggler] = \
                straggler_votes.get(straggler, 0) + 1
        slowest_phase = None
        if ranks_out:
            agg = {p: sum(d["phases_s"].get(p, 0.0)
                          for d in ranks_out.values())
                   for p in PHASES}
            slowest_phase = max(agg, key=agg.get)
        centry = {
            "coll": coll,
            "auto_id": bool(coll >> 63),
            "ranks": ranks_out,
            "straggler": straggler,
            "slowest_phase": slowest_phase,
        }
        # Serving streams stamp structured ids (bit 62 | request<<40 |
        # seq — serving/stream.py) through the same FEAT_COLL_ID
        # bytes, so a decode stream's transfers decompose per request
        # exactly like collectives decompose per rank.
        if _is_stream_coll(coll):
            centry["request"] = _stream_coll_request(coll)
            centry["stream_seq"] = coll & ((1 << 40) - 1)
        colls.append(centry)

    # ---- per-link bandwidth: tx (src right lane c) -> rx (dst left
    # lane c), matched by frame seq within the lane pair ----
    links: List[Dict[str, Any]] = []
    # Index rx events per (rank, lane): seq -> ts
    rx_index: Dict[Tuple[int, int], Dict[int, TelEvent]] = {}
    for r, evs in ranks.items():
        for e in evs:
            if e.source == "native" and e.name == "wire_rx" and e.qp:
                rx_index.setdefault((r, e.qp), {})[e.id] = e
    # world_name -> rank_in_world -> {side -> [lanes]} (global ranks)
    worlds: Dict[str, Dict[int, Dict[str, List[int]]]] = {}
    for lane, info in lanes.items():
        worlds.setdefault(info["world"], {}).setdefault(
            info["rank"], {}).setdefault(info["side"], []).append(lane)
    for lane, info in sorted(lanes.items()):
        if info["side"] != "right":
            continue
        src = lane_rank.get(lane)
        wname, size = info["world"], info["size"]
        dst_wrank = (info["rank"] + 1) % size if size else 0
        dst_lanes = worlds.get(wname, {}).get(dst_wrank, {}).get("left")
        if src is None or not dst_lanes:
            continue
        # channel identity: right[c] on this rank pairs with left[c]
        # on the neighbor (connection order IS channel identity).
        c = info["chan"]
        peer_map = None
        for dl in sorted(dst_lanes):
            if lanes[dl]["chan"] == c:
                dst = lane_rank.get(dl)
                if dst is not None and (dst, dl) in rx_index:
                    peer_map = rx_index[(dst, dl)]
                    break
        else:
            dst = None
        if peer_map is None:
            continue
        pairs = []
        for e in ranks[src]:
            if e.source == "native" and e.name == "wire_tx" \
                    and e.qp == lane:
                rx = peer_map.get(e.id)
                if rx is not None and rx.arg == e.arg:
                    pairs.append((e, rx))
        if not pairs:
            continue
        nbytes = sum(tx.arg for tx, _ in pairs)
        t0 = min(tx.ts_ns for tx, _ in pairs)
        t1 = max(rx.ts_ns for _, rx in pairs)
        dt = max(t1 - t0, 1) / 1e9
        links.append({
            "world": wname, "tier": info["tier"],
            "src": src, "dst": dst, "channel": c,
            "frames": len(pairs), "bytes": int(nbytes),
            "seconds": round(dt, 6),
            "MBps": round(nbytes / dt / 1e6, 3),
        })

    # ---- per-request serving attribution: aggregate the stream-
    # tagged collectives by request id (0 = batch-level weight
    # traffic shared by every rider). The straggler vote is recounted
    # within the request's own transfers — "which rank delays THIS
    # decode stream" is the serving question, and it can differ from
    # the fleet-wide vote when one request's KV home sits on a slow
    # link.
    serving: Dict[str, Dict[str, Any]] = {}
    for c in colls:
        if "request" not in c:
            continue
        rid = str(c["request"])
        agg_r = serving.setdefault(rid, {
            "transfers": 0, "wall_s": 0.0, "tx_bytes": 0, "retx": 0,
            "straggler_votes": {},
        })
        agg_r["transfers"] += 1
        for d in c["ranks"].values():
            agg_r["wall_s"] = round(agg_r["wall_s"] + d["wall_s"], 6)
            agg_r["tx_bytes"] += d["tx_bytes"]
            agg_r["retx"] += d["retx"]
        if c["straggler"] is not None and len(c["ranks"]) > 1:
            sv = agg_r["straggler_votes"]
            key = str(c["straggler"])
            sv[key] = sv.get(key, 0) + 1

    straggler_rank = (max(straggler_votes, key=straggler_votes.get)
                      if straggler_votes else None)
    result = {
        "ranks": sorted(ranks),
        "clock_offset_ns": offsets,
        "collectives": colls[-max_colls:],
        "n_collectives": len(colls),
        "joinable_collectives": joinable,
        "straggler": {
            "rank": straggler_rank,
            "votes": straggler_votes,
            "wall_s_by_rank": {str(r): round(v, 6)
                               for r, v in sorted(wall_sums.items())},
        },
        "links": links,
        "serving": serving,
        "degraded_links": {str(r): lm
                           for r, lm in sorted(degraded.items()) if lm},
        "tainted_ranks": {str(r): n for r, n in sorted(tainted.items())},
    }
    return result


def _degraded_label(rank: Optional[int],
                    degraded: Dict[str, Dict[str, Dict[str, Any]]]
                    ) -> str:
    """How a straggling rank relates to the degradation ladder:
    either it reported the degraded link itself, or it is the PEER a
    reporter's degraded delegate link points at."""
    if rank is None:
        return ""
    own = degraded.get(str(rank)) or {}
    if own:
        link, info = sorted(own.items())[0]
        return (f" [degraded link {link} -> peer r{info['peer']} "
                f"(rung {info['rung']})]")
    for reporter, lm in sorted(degraded.items()):
        for link, info in sorted(lm.items()):
            if info.get("peer") == rank:
                return (f" [behind degraded link {link} reported by "
                        f"r{reporter} (rung {info['rung']})]")
    return ""


# ------------------------------------------------------- postmortems

def load_postmortem(incident_dir: str) -> Dict[str, Any]:
    """Load one incident's rank bundles (rank*.json written by
    RingWorld._write_postmortem) into the segments shape the analysis
    consumes, plus the bundle-only fields (errors, counters)."""
    bundles: Dict[int, Dict[str, Any]] = {}
    for path in sorted(glob.glob(os.path.join(incident_dir,
                                              "rank*.json"))):
        try:
            with open(path) as f:
                b = json.load(f)
            bundles[int(b.get("rank", -1))] = b
        except (OSError, ValueError):
            continue
    segments = {
        r: {"events": b.get("events") or [],
            "clock_offset_ns": b.get("clock_offset_ns", 0),
            "dropped": b.get("dropped", 0)}
        for r, b in bundles.items()
    }
    return {"bundles": bundles, "segments": segments}


def explain_postmortem(incident_dir: str) -> Dict[str, Any]:
    """Merge one incident's bundles: the shared analysis plus
    per-rank error/counter evidence."""
    pm = load_postmortem(incident_dir)
    bundles = pm["bundles"]
    if not bundles:
        raise SystemExit(f"no rank*.json bundles in {incident_dir}")
    analysis = analyze_segments(pm["segments"])
    analysis["incident"] = {
        "dir": os.path.abspath(incident_dir),
        "world": next(iter(bundles.values())).get("world"),
        "generation": next(iter(bundles.values())).get("generation"),
        "ranks": {
            str(r): {
                "error": b.get("error", ""),
                "incarnation": b.get("incarnation"),
                "digest": (b.get("digest") or "")[:16],
                "integrity": {
                    k.split(".", 1)[1]: v
                    for k, v in (b.get("counters") or {}).items()
                    if k.startswith("integrity.")
                },
                "events": len(b.get("events") or []),
            }
            for r, b in sorted(bundles.items())
        },
    }
    return analysis


# ------------------------------------------------------------ render

def _fmt_phases(phases: Dict[str, float]) -> str:
    return " ".join(f"{p}={phases[p] * 1e3:.1f}ms"
                    for p in PHASES if phases.get(p))


def render_text(a: Dict[str, Any]) -> str:
    lines = []
    inc = a.get("incident")
    if inc:
        lines.append(f"incident: world={inc['world']} "
                     f"generation={inc['generation']} ({inc['dir']})")
        for r, info in inc["ranks"].items():
            lines.append(f"  rank {r}: error={info['error'] or '-'} "
                         f"integrity={info['integrity'] or {}} "
                         f"events={info['events']}")
    lines.append(f"ranks: {a['ranks']}  collectives: "
                 f"{a['n_collectives']} "
                 f"({a['joinable_collectives']} joinable cross-rank)")
    st = a["straggler"]
    deg = a.get("degraded_links") or {}
    if st["rank"] is not None:
        votes = st["votes"].get(st["rank"], 0)
        lines.append(f"straggler: rank {st['rank']} "
                     f"(arrived last in {votes} of "
                     f"{a['joinable_collectives']} joinable "
                     f"collectives)"
                     + _degraded_label(st["rank"], deg))
    if deg:
        for r, lm in deg.items():
            for link, info in sorted(lm.items()):
                lines.append(
                    f"degraded: r{r} link {link} -> peer "
                    f"r{info['peer']} rung={info['rung']} "
                    f"score={info['score']}")
    if st["wall_s_by_rank"]:
        walls = " ".join(f"r{r}={v * 1e3:.1f}ms"
                         for r, v in st["wall_s_by_rank"].items())
        lines.append(f"cumulative collective wall: {walls}")
    for c in a["collectives"][-8:]:
        tag = "auto" if c["auto_id"] else str(c["coll"])
        lines.append(f"  coll {tag}: straggler=r{c['straggler']} "
                     f"slowest_phase={c['slowest_phase']}")
        for r, d in sorted(c["ranks"].items(), key=lambda kv: int(kv[0])):
            retx = f" retx={d['retx']}" if d["retx"] else ""
            lines.append(f"    r{r}: wall={d['wall_s'] * 1e3:.2f}ms "
                         f"{_fmt_phases(d['phases_s'])}{retx}")
    if a.get("serving"):
        lines.append("serving streams (per request; 0 = shared "
                     "weight pages):")
        for rid, d in sorted(a["serving"].items(),
                             key=lambda kv: int(kv[0])):
            sv = d["straggler_votes"]
            worst = max(sv, key=sv.get) if sv else None
            tail = (f" straggler=r{worst} ({sv[worst]} votes)"
                    if worst is not None else "")
            retx = f" retx={d['retx']}" if d["retx"] else ""
            lines.append(
                f"  req {rid}: {d['transfers']} transfers "
                f"{d['tx_bytes']} B wall={d['wall_s'] * 1e3:.1f}ms"
                f"{retx}{tail}")
    if a["links"]:
        lines.append("links (tx->rx matched by lane+seq):")
        for ln in a["links"]:
            lines.append(
                f"  {ln['world']}[{ln['tier']}] r{ln['src']}->"
                f"r{ln['dst']} ch{ln['channel']}: "
                f"{ln['MBps']:.1f} MB/s over {ln['frames']} frames "
                f"({ln['bytes']} B)")
    if a["tainted_ranks"]:
        lines.append(f"WARNING: telemetry drops on ranks "
                     f"{sorted(a['tainted_ranks'])} — attribution on "
                     "those ranks is skewed (raise "
                     "TDR_TELEMETRY_RING)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m rocnrdma_tpu_torch.tools.explain",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--collect", metavar="HOST:PORT",
                     help="pull segments live from a coordinator")
    src.add_argument("--trace", metavar="RAW.json",
                     help="saved raw segments (perfetto CLI --raw)")
    src.add_argument("--postmortem", metavar="DIR",
                     help="an incident-g<N> directory of rank bundles")
    ap.add_argument("--world", default=None,
                    help="world name (required with --collect)")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--max-events", type=int, default=65536)
    ap.add_argument("--json", action="store_true",
                    help="emit the full analysis as JSON")
    ap.add_argument("--out", default=None,
                    help="also write a merged Perfetto trace here")
    args = ap.parse_args(argv)

    if args.postmortem:
        analysis = explain_postmortem(args.postmortem)
        segments = load_postmortem(args.postmortem)["segments"]
    else:
        if args.collect:
            if not args.world:
                ap.error("--collect requires --world")
            res = collect_and_merge(args.collect, args.world,
                                    timeout_s=args.timeout,
                                    max_events=args.max_events)
            segments = res["segments"]
        else:
            with open(args.trace) as f:
                raw = json.load(f)
            segments = raw.get("segments", raw)
        analysis = analyze_segments(segments)

    if args.out:
        merge_fleet(segments, path=args.out)
    if args.json:
        print(json.dumps(analysis, indent=2, sort_keys=True))
    else:
        print(render_text(analysis))
    return 0


if __name__ == "__main__":
    sys.exit(main())
