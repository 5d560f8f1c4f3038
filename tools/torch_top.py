#!/usr/bin/env python3
"""tdr_top for the PyTorch port — live CLI view of the flight recorder.

The port's counterpart of ``tools/tdr_top.py``: the same frames, byte
for byte, over the port's own copies (``rocnrdma_tpu_torch.telemetry``,
``.control.client``, ``.collectives.world``, ``.transport.engine``).

    python3 tools/torch_top.py --demo --once
    python3 tools/torch_top.py --connect 127.0.0.1:PORT
    python3 tools/torch_top.py --file SNAP.json --interval 2

Renders the unified counter registry, the log2 latency/bandwidth
histograms (as sparklines with p50/p90/p99), and event-ring health,
refreshing in place like top(1).

Two ways to attach:

  **--file SNAP.json** — watch a snapshot file a workload writes via
  ``telemetry.start_snapshot_writer(path)`` (the cross-process mode:
  counters live in the workload's process, so they reach this tool as
  periodic snapshots, not shared memory).

  **--demo** — run a world-2 emu allreduce loop IN this process with
  telemetry on and watch it live (the zero-setup showcase). Its
  buffers are numpy float32 on the port's ``libtdr``: the tool touches
  no device.

  **--connect HOST:PORT** — watch a COORDINATOR's /metrics: one
  terminal renders every named world's generation/epoch/membership,
  rebuild and retransmit counters, per-rank clock offsets, telemetry
  drops, and postmortem counts — the whole fleet beside (or instead
  of) the local-ring view.

  ``--once`` prints a single frame and exits (scripting / tests).
"""
import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

_SPARK = " .:-=+*#%@"


def sparkline(buckets, width=32) -> str:
    """Compress 64 log2 buckets into a width-char intensity strip
    (linear in log count — tails stay visible next to huge modes)."""
    import math

    if not any(buckets):
        return "-" * width
    per = max(1, (len(buckets) + width - 1) // width)
    cells = [sum(buckets[i:i + per]) for i in range(0, len(buckets), per)]
    peak = math.log1p(max(cells))
    out = []
    for c in cells[:width]:
        lvl = int(math.log1p(c) / peak * (len(_SPARK) - 1)) if peak else 0
        out.append(_SPARK[lvl])
    return "".join(out)


class ChannelLats:
    """Per-channel (per-QP-lane) chunk latency, from drained events.

    The native chunk_lat_us histogram is process-global; with the ring
    striped over TDR_RING_CHANNELS QPs, fold-vs-wire imbalance hides
    inside that aggregate. This accumulator pairs each post_* event
    with its wc event by (qp, wr_id) and keeps one log2 histogram PER
    QP lane, so a slow channel (one progress thread stuck folding
    while its siblings stream) shows up as a fat-tailed lane live."""

    def __init__(self) -> None:
        self.posts = {}      # (qp, id) -> post ts_ns
        self.hists = {}      # qp -> [64] counts
        self.events = 0

    def feed(self, events) -> None:
        for e in events:
            self.events += 1
            if e.name in ("post_send", "post_recv", "post_write",
                          "post_read") and e.qp:
                self.posts[(e.qp, e.id)] = e.ts_ns
            elif e.name == "wc" and e.qp:
                t0 = self.posts.pop((e.qp, e.id), None)
                if t0 is None or e.ts_ns <= t0:
                    continue
                us = (e.ts_ns - t0) // 1000
                b = us.bit_length() if us else 0
                h = self.hists.setdefault(e.qp, [0] * 64)
                h[min(b, 63)] += 1
        # Unmatched posts (flushed WRs, drained mid-flight): bound the
        # pairing table so a soak cannot grow it without limit.
        if len(self.posts) > 65536:
            for key in list(self.posts)[:32768]:
                self.posts.pop(key, None)

    def render(self) -> list:
        from rocnrdma_tpu_torch.telemetry import hist_percentiles

        lines = []
        if not self.hists:
            return lines
        lines.append("")
        lines.append("chunk_lat_us by channel (qp lane):")
        for qp in sorted(self.hists):
            h = self.hists[qp]
            p = hist_percentiles(h)
            lines.append(f"  qp {qp:<4} {'':<8} |{sparkline(h)}| "
                         f"n={sum(h):<8} p50={p.get('p50', 0):<8} "
                         f"p90={p.get('p90', 0):<8} p99={p.get('p99', 0)}")
        return lines


def render(snap: dict, chan_lats: "ChannelLats" = None) -> str:
    lines = []
    lines.append("tdr_top — flight recorder  "
                 f"[recording={'ON' if snap.get('enabled') else 'off'} "
                 f"recorded={snap.get('recorded', 0)} "
                 f"dropped={snap.get('dropped', 0)}]")
    lines.append("")
    lines.append("histograms (log2 buckets; p50/p90/p99 upper-edge):")
    pct = snap.get("percentiles", {})
    for name, buckets in sorted(snap.get("histograms", {}).items()):
        p = pct.get(name, {})
        lines.append(f"  {name:<14} |{sparkline(buckets)}| "
                     f"n={sum(buckets):<8} p50={p.get('p50', 0):<8} "
                     f"p90={p.get('p90', 0):<8} p99={p.get('p99', 0)}")
    if chan_lats is not None:
        lines.extend(chan_lats.render())
    # Sharded progress engine + fold pool at a glance: shard threads
    # launched / completions they consumed, and the fold pool's
    # executed-vs-queued depth. progress.wc == 0 with traffic means
    # the legacy single-poll loop ran (TDR_PROGRESS_SHARDS=0 or a
    # 1-core host); fold.pending stuck high with idle lanes means the
    # fold pool, not the wire, is the bottleneck.
    c = snap.get("counters", {})
    lines.append("")
    lines.append(f"progress: shards={c.get('progress.shards', 0)} "
                 f"wc={c.get('progress.wc', 0)} "
                 f"wakeups={c.get('progress.wakeups', 0)}  "
                 f"fold: jobs={c.get('fold.jobs', 0)} "
                 f"busy_us={c.get('fold.busy_us', 0)} "
                 f"pending={c.get('fold.pending', 0)}")
    lines.append("")
    lines.append("counters:")
    counters = snap.get("counters", {})
    groups = {}
    for name, val in sorted(counters.items()):
        groups.setdefault(name.split(".")[0], []).append((name, val))
    for _, items in sorted(groups.items()):
        for name, val in items:
            if val:
                lines.append(f"  {name:<28} {val}")
    return "\n".join(lines)


def parse_metrics(text: str) -> dict:
    """Parse a Prometheus text exposition into
    {metric: [(labels-dict, value)]} — just enough structure for the
    fleet frame (no dependency on a client library)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, rest = line.partition("{")
        labels = {}
        if rest:
            lab, _, val = rest.rpartition("} ")
            for part in lab.split(","):
                k, _, v = part.partition("=")
                if k:
                    labels[k] = v.strip('"')
        else:
            name, _, val = line.partition(" ")
        try:
            out.setdefault(name.strip(), []).append(
                (labels, float(val)))
        except ValueError:
            continue
    return out


def _metric(m: dict, name: str, world: str, rank: str = None) -> float:
    for labels, val in m.get(name, ()):
        if labels.get("world") != world:
            continue
        if rank is not None and labels.get("rank") != rank:
            continue
        if rank is None and "rank" in labels:
            continue
        return val
    return 0.0


def render_fleet(metrics_text: str) -> str:
    """The --connect frame: one block per named world."""
    m = parse_metrics(metrics_text)
    lines = ["tdr_top — fleet view (coordinator /metrics)", ""]
    failovers = _metric_global(m, "tdr_ctl_failovers_total")
    snap_age = _metric_global(m, "tdr_ctl_snapshot_age_s", default=None)
    fleet_bits = [f"worlds={int(_metric_global(m, 'tdr_ctl_worlds'))}",
                  f"failovers={int(failovers)}"]
    if snap_age is not None:
        fleet_bits.append("snapshot_age=never" if snap_age < 0
                          else f"snapshot_age={snap_age:.1f}s")
    lines.insert(1, "fleet: " + " ".join(fleet_bits))
    worlds = sorted({labels.get("world")
                     for labels, _ in m.get("tdr_ctl_generation", ())
                     if labels.get("world")})
    if not worlds:
        return "\n".join(lines[:2]) + "\n\n(no worlds registered)"
    for w in worlds:
        size = int(_metric(m, "tdr_ctl_size", w))
        lines.append(
            f"world {w}: gen={int(_metric(m, 'tdr_ctl_generation', w))} "
            f"epoch={int(_metric(m, 'tdr_ctl_epoch', w))} "
            f"members={int(_metric(m, 'tdr_ctl_members', w))}/{size} "
            f"rebuilds={int(_metric(m, 'tdr_ctl_rebuilds_total', w))} "
            f"resizes={int(_metric(m, 'tdr_ctl_resizes_total', w))} "
            f"postmortems={int(_metric(m, 'tdr_postmortems_total', w))}")
        lines.append(
            f"  qp_share={int(_metric(m, 'tdr_ctl_qp_share', w))}"
            f" qp_reserved={int(_metric(m, 'tdr_ctl_qp_reserved', w))}"
            f" admission_rejects="
            f"{int(_metric(m, 'tdr_ctl_admission_rejects_total', w))}"
            f" hb_throttled="
            f"{int(_metric(m, 'tdr_ctl_hb_throttled_total', w))}")
        lines.append(
            f"  retransmit_rate={_metric(m, 'tdr_retransmit_rate', w):.4g}"
            f"  chunk_p99_us="
            f"{int(_metric_q(m, 'tdr_chunk_lat_us', w, '0.99'))}")
        # Per-rank rows: clock offset (the fleet-merge alignment), its
        # RTT bound, and telemetry drops (the taint signal).
        ranks = sorted({labels.get("rank")
                        for labels, _ in m.get("tdr_clock_offset_us", ())
                        if labels.get("world") == w}, key=_rank_key)
        for r in ranks:
            off = _metric(m, "tdr_clock_offset_us", w, r)
            rtt = _metric(m, "tdr_clock_rtt_us", w, r)
            drops = _metric(m, "tdr_telemetry_dropped_total", w, r)
            taint = "  TAINTED" if drops else ""
            lines.append(f"  rank {r}: clock_offset={off:+.1f}us "
                         f"(rtt {rtt:.1f}us) "
                         f"dropped={int(drops)}{taint}")
        lines.append("")
    return "\n".join(lines)


def _rank_key(r):
    try:
        return (0, int(r))
    except (TypeError, ValueError):
        return (1, str(r))


def _metric_global(m: dict, name: str, default: float = 0.0):
    """First sample of a label-less fleet metric (or `default`)."""
    for labels, val in m.get(name, ()):
        if not labels:
            return val
    return default


def _metric_q(m: dict, name: str, world: str, q: str) -> float:
    for labels, val in m.get(name, ()):
        if labels.get("world") == world and labels.get("quantile") == q:
            return val
    return 0.0


def fetch_metrics(address: str) -> str:
    from rocnrdma_tpu_torch.control.client import ControlClient

    return ControlClient(address).metrics()


def demo_traffic(stop: threading.Event) -> None:
    """Background world-2 allreduce loop feeding the live view."""
    import socket

    import numpy as np

    from rocnrdma_tpu_torch.collectives.world import local_worlds

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worlds = local_worlds(2, port)
    bufs = [np.ones(1 << 18, dtype=np.float32) for _ in range(2)]
    try:
        while not stop.is_set():
            ts = [threading.Thread(target=worlds[r].allreduce,
                                   args=(bufs[r],)) for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            stop.wait(0.05)
    finally:
        for w in worlds:
            w.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_top", description=__doc__)
    ap.add_argument("--file", default=None,
                    help="snapshot file written by "
                         "telemetry.start_snapshot_writer()")
    ap.add_argument("--demo", action="store_true",
                    help="drive an in-process world-2 allreduce loop")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="watch a coordinator's /metrics (fleet view: "
                         "per-world generation, retransmit rate, clock "
                         "offsets, postmortems)")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    args = ap.parse_args(argv)

    stop = threading.Event()
    if args.demo:
        from rocnrdma_tpu_torch import telemetry

        telemetry.enable()
        t = threading.Thread(target=demo_traffic, args=(stop,), daemon=True)
        t.start()

    # Per-channel latency lanes need the raw events (the native
    # histograms are process-global): live/in-process modes drain the
    # ring each frame and accumulate per-qp histograms here. The
    # --file mode watches another process's periodic snapshots — its
    # events are not reachable, so that mode renders aggregates only.
    chan_lats = ChannelLats()

    def frame() -> str:
        fleet = ""
        if args.connect:
            try:
                fleet = render_fleet(fetch_metrics(args.connect))
            except Exception as e:
                fleet = (f"tdr_top — fleet view\n\ncoordinator "
                         f"{args.connect} unreachable: {e}")
            # --connect alone renders the fleet only; combined with
            # --file/--demo the local view follows below.
            if not args.file and not args.demo:
                return fleet
            fleet += "\n" + "=" * 64 + "\n"
        if args.file:
            try:
                with open(args.file) as f:
                    return fleet + render(json.load(f))
            except FileNotFoundError:
                return fleet + f"waiting for snapshot file {args.file} ..."
            except json.JSONDecodeError:
                return fleet + f"snapshot {args.file} mid-write, retrying ..."
        from rocnrdma_tpu_torch import telemetry

        if telemetry.enabled():
            chan_lats.feed(telemetry.drain())
        return fleet + render(telemetry.snapshot(), chan_lats)

    try:
        if args.once:
            if args.demo:
                # Wait for the first recorded events, not a blind
                # sleep — the traffic thread imports numpy and
                # bootstraps a world first, which can outlast any
                # fixed delay on a loaded box.
                from rocnrdma_tpu_torch.transport.engine import \
                    telemetry_recorded

                deadline = time.monotonic() + 30
                while (telemetry_recorded() == 0
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
            print(frame())
            return 0
        while True:
            sys.stdout.write("\x1b[2J\x1b[H" + frame() + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        stop.set()


if __name__ == "__main__":
    sys.exit(main())
