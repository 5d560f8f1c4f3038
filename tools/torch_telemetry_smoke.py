#!/usr/bin/env python3
"""Telemetry smoke for the PyTorch port: the port's counterpart of
``tools/telemetry_smoke.py``, the same drive over the port's own
copies (``rocnrdma_tpu_torch.telemetry``, ``.collectives.world``,
``.transport.engine``).

    python3 tools/torch_telemetry_smoke.py

Drives a world-2 emu ring allreduce with the flight recorder on and
asserts its whole contract end to end:

1. the run produces a NON-EMPTY, schema-valid Perfetto export
   (traceEvents array, every event carrying ph/ts/pid/name);
2. the chunk lifecycle is present and ordered (post before wc on
   every track that completed work; wire_tx/wire_rx present; land and
   verify on the sealed path);
3. the SAME drive re-run with recording off records ZERO events and
   drops none — the one-branch-guard contract.

Numpy-only: it touches no device and takes no device argument. The
sanitized sweep (``tests/test_torch_sanitize.py``) runs it against
``libtdr_san.so`` with ASan preloaded, sweeping every event path for
memory errors and UB.

Prints one ``TELEMETRY_SMOKE {json}`` verdict line with the reference's
keys; exits non-zero on any failure.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# The lifecycle every recorded run must hold: the reference's names,
# then the sealed path's land and verify.
LIFECYCLE = ("post_send", "post_recv", "wire_tx", "wire_rx", "wc",
             "ring_begin", "ring_end")
SEALED = ("land", "verify_ok")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def drive_world2(port: int | None = None) -> dict:
    """One world-2 emu allreduce; returns the per-rank engine labels."""
    import numpy as np

    from rocnrdma_tpu_torch.collectives.world import local_worlds

    worlds = local_worlds(2, free_port() if port is None else port)
    labels = {w.engine.telemetry_id: f"rank{w.rank}" for w in worlds}
    sealed = worlds[0].left_qp.has_seal
    bufs = [np.full(1 << 16, float(r + 1), dtype=np.float32)
            for r in range(2)]
    ts = [threading.Thread(target=worlds[r].allreduce, args=(bufs[r],))
          for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for b in bufs:
        np.testing.assert_array_equal(b, np.full(1 << 16, 3.0, np.float32))
    for w in worlds:
        w.close()
    return {"labels": labels, "sealed": sealed}


def recorded_run(port: int | None = None) -> tuple:
    """The drive with recording on: (its merged timeline, the Perfetto
    document written and read back, whether the ring was sealed)."""
    from rocnrdma_tpu_torch import telemetry

    telemetry.enable()
    run = drive_world2(port)
    events = telemetry.timeline()
    with tempfile.TemporaryDirectory(prefix="tdr_tel_smoke_") as d:
        path = os.path.join(d, "trace.json")
        telemetry.export_trace(path, events=events,
                               engine_labels=run["labels"])
        with open(path) as f:
            doc = json.load(f)  # schema-valid JSON or this raises
    return events, doc, run["sealed"]


def check_lifecycle(events, doc, sealed: bool) -> dict:
    """Gates 1 and 2; returns their verdict fields."""
    tev = doc["traceEvents"]
    assert tev, "empty traceEvents"
    for ev in tev:
        for key in ("ph", "ts", "pid", "name"):
            assert key in ev, f"event missing {key}: {ev}"
    names = {ev.name for ev in events}
    for needed in LIFECYCLE + (SEALED if sealed else ()):
        assert needed in names, f"lifecycle event {needed} missing"
    # Per-track ordering: the first post precedes the last wc.
    by_track = {}
    for ev in events:
        if ev.source == "native" and ev.qp:
            by_track.setdefault((ev.engine, ev.qp), []).append(ev)
    for track, evs in by_track.items():
        posts = [e.ts_ns for e in evs if e.name.startswith("post_")]
        wcs = [e.ts_ns for e in evs if e.name == "wc"]
        if posts and wcs:
            assert min(posts) <= max(wcs), f"inverted lifecycle on {track}"
    return {"events_recorded": len(events), "trace_events": len(tev),
            "tracks": len(by_track)}


def telemetry_smoke(ports: tuple = (None, None)) -> dict:
    """The whole drive: the verdict the ``TELEMETRY_SMOKE`` line
    prints (assertions raise on a failed gate)."""
    from rocnrdma_tpu_torch import telemetry
    from rocnrdma_tpu_torch.transport.engine import (telemetry_dropped,
                                                     telemetry_recorded)

    verdict = check_lifecycle(*recorded_run(ports[0]))
    # Recording off: the same drive must record NOTHING (and cost one
    # branch per site doing it).
    telemetry.disable()
    drive_world2(ports[1])
    verdict["events_while_disabled"] = telemetry_recorded()
    verdict["dropped_while_disabled"] = telemetry_dropped()
    assert verdict["events_while_disabled"] == 0, \
        "recording off, yet events were recorded"
    assert verdict["dropped_while_disabled"] == 0
    verdict["ok"] = True
    return verdict


def main() -> int:
    print("TELEMETRY_SMOKE " + json.dumps(telemetry_smoke()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
