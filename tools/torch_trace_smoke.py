#!/usr/bin/env python3
"""Fleet-tracing smoke for the PyTorch port: world-4 subprocess soak,
merged trace gates. The port's counterpart of ``tools/trace_smoke.py``,
the same drive over the port's own copies (``rocnrdma_tpu_torch.control``,
``.collectives.world``, ``.telemetry``) and the port's copy of
``tools/tdr_explain.py``'s analysis (``rocnrdma_tpu_torch.tools.explain``).

    python3 tools/torch_trace_smoke.py
    TDR_TRACE_SMOKE_SAN=1 python3 tools/torch_trace_smoke.py   # shorter

Every rank here is its OWN PROCESS (the tool re-launched with
``--rank-main``) — separate flight-recorder rings, separate clocks as
far as the pipeline is concerned — because that is the shape the fleet
machinery exists for. The ranks inherit the parent's environment
(``TDR_NATIVE_LIB``, ``LD_PRELOAD`` and the sanitizer options
included).

Phase A (straggler): a coordinator-arbitrated world-4 emu soak where
rank STRAGGLER carries a fault-plan ``ring:stall_ms`` clause (it
arrives late to every collective — the compute-straggler shape). Mid-
soak the parent pulls ``collect_trace`` and gates:

  - the merge produced a VALID Perfetto trace (json round-trips, has
    process meta for every rank, events present);
  - collectives are JOINABLE: the same wire-carried ``coll`` id
    appears on >= 2 ranks, with send-side and land-side events;
  - the analysis names rank STRAGGLER as the straggler;
  - clock offsets were estimated (bounded by measured RTT).

Phase B (postmortem): a fresh world-4 soak with TDR_POSTMORTEM_DIR
set and a ``conn:drop_after`` clause on one rank. The drop surfaces
as a retryable TransportError on every rank; each writes a black-box
bundle and rebuilds through the coordinator. Gates: a complete bundle
per rank exists for the incident, and ``explain_postmortem`` merges
them (reporting the incident world/generation and per-rank errors),
and ``tdr_postmortems_total`` is served on /metrics.

Numpy-only: it touches no device. ``TDR_TRACE_SMOKE_SAN=1`` sets the
shorter drive (150 iterations) that the sanitized sweep
(``tests/test_torch_sanitize.py``) runs against ``libtdr_san.so``.
Prints the reference's success line; exits non-zero on any failure.
Never run it concurrently with the tier-1 suite (socket churn causes
connect-timeout flakes).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORLD = 4
STRAGGLER = 2
DROPPER = 1
STALL_MS = 8


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --------------------------------------------------------- rank main

def rank_main() -> int:
    """One rank process: join the named world through the coordinator
    and run the allreduce soak; any TransportError walks the elastic
    ladder (postmortem dump + arbitrated rebuild) and the soak
    continues. numpy-only: no torch operation runs, so the -san flavour
    never makes torch throw a C++ exception."""
    import argparse

    import numpy as np

    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.transport.engine import Engine, TransportError

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--world-name", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--iters", type=int, required=True)
    ap.add_argument("--elems", type=int, default=1 << 15)
    args = ap.parse_args(sys.argv[2:])

    eng = Engine("emu")
    w = RingWorld(eng, args.rank, WORLD, controller=args.coordinator,
                  world_name=args.world_name, timeout_ms=20000)
    buf = np.zeros(args.elems, dtype=np.float32)
    ok = True
    i = 0
    while i < args.iters:
        buf[:] = float(args.rank + 1)
        try:
            w.allreduce(buf)
            expect = sum(range(1, WORLD + 1))
            if not (buf == expect).all():
                print(f"rank {args.rank}: BAD RESULT at iter {i}",
                      flush=True)
                ok = False
                break
            i += 1
            # A short think-time gap per iter keeps heartbeats (and a
            # mid-soak collect_trace) from starving behind back-to-back
            # collectives on a core-starved host — and stretches the
            # soak so the parent's mid-soak pull lands mid-soak.
            time.sleep(0.03)
        except TransportError as e:
            if not e.retryable:
                raise
            w.rebuild(reason=f"trace-smoke transient: {e}")
    w.close()
    eng.close()
    return 0 if ok else 1


# ------------------------------------------------------ orchestration

def spawn_rank(world_name, coordinator, rank, iters, extra_env):
    env = dict(os.environ)
    env["TDR_TELEMETRY"] = "1"
    env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-main",
         "--coordinator", coordinator, "--world-name", world_name,
         "--rank", str(rank), "--iters", str(iters)],
        env=env, cwd=REPO)


def reap(procs, deadline_s):
    deadline = time.monotonic() + deadline_s
    rcs = []
    for p in procs:
        left = max(1.0, deadline - time.monotonic())
        try:
            rcs.append(p.wait(timeout=left))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(-9)
    return rcs


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank-main":
        return rank_main()

    from rocnrdma_tpu_torch.control.client import ControlClient
    from rocnrdma_tpu_torch.control.coordinator import Coordinator
    from rocnrdma_tpu_torch.telemetry.perfetto import merge_fleet
    from rocnrdma_tpu_torch.telemetry.recorder import events_from_wire
    from rocnrdma_tpu_torch.tools.explain import (analyze_segments,
                                                  explain_postmortem)

    san = os.environ.get("TDR_TRACE_SMOKE_SAN", "0") not in ("", "0")
    # Phase A must OUTLIVE the parent's mid-soak pull: ~30 ms/iter of
    # think time keeps the world alive well past warmup + collection
    # (a finished world has no live members left to pull from).
    iters = 500 if not san else 150
    coord = Coordinator(port=0, lease_ms=4000,
                        port_base=free_port()).start()
    client = ControlClient(coord.address)
    failures = []

    # ----------------------------------------------- phase A: straggler
    procs = [
        spawn_rank(
            "tracefleet", coord.address, r, iters,
            {"TDR_FAULT_PLAN": f"ring:stall_ms={STALL_MS}"}
            if r == STRAGGLER else {})
        for r in range(WORLD)
    ]
    segments = {}
    try:
        # Let the soak reach steady state, then pull the fleet trace
        # while collectives are in flight.
        time.sleep(4.0)
        resp = client.collect_trace("tracefleet", timeout_s=30.0,
                                    max_events=65536)
        if not resp.get("ok"):
            failures.append(f"collect_trace failed: {resp.get('error')}"
                            f" (got ranks {sorted(resp.get('segments') or {})})")
        segments = resp.get("segments") or {}
        if sorted(int(r) for r in segments) != list(range(WORLD)):
            failures.append(
                f"segments incomplete: {sorted(segments)}")
    finally:
        rcs = reap(procs, 180)
    if any(rc != 0 for rc in rcs):
        failures.append(f"phase A rank exit codes: {rcs}")

    if segments:
        # Gate 1: merged Perfetto trace is valid and fleet-shaped.
        doc = merge_fleet(segments)
        blob = json.dumps(doc)
        doc2 = json.loads(blob)
        pids = {e["pid"] for e in doc2["traceEvents"]}
        want_pids = {(r + 1) * 1000 for r in range(WORLD)}
        if not all(any(p // 1000 == r + 1 for p in pids)
                   for r in range(WORLD)):
            failures.append(f"merged trace missing rank processes: "
                            f"{sorted(pids)} vs {sorted(want_pids)}")
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            f.write(blob)
            print(f"merged trace: {f.name} "
                  f"({len(doc2['traceEvents'])} events)")

        # Gate 2: cross-rank joinability by wire-carried coll id —
        # the same id must appear with SEND-side events on one rank
        # and LAND-side events on another.
        analysis = analyze_segments(segments)
        if analysis["joinable_collectives"] < 3:
            failures.append(
                f"only {analysis['joinable_collectives']} collectives "
                "joinable across ranks")
        send_colls, land_colls = {}, {}
        for rk, seg in segments.items():
            for e in events_from_wire(seg.get("events")):
                if not e.coll or e.source != "native":
                    continue
                if e.name in ("post_send", "wire_tx"):
                    send_colls.setdefault(e.coll, set()).add(int(rk))
                elif e.name in ("wire_rx", "land"):
                    land_colls.setdefault(e.coll, set()).add(int(rk))
        joined = [c for c, senders in send_colls.items()
                  if c in land_colls
                  and len(senders | land_colls[c]) > 1]
        if not joined:
            failures.append("no coll id joins send events on one rank "
                            "to land events on another")

        # Gate 3: the analysis names the stalled rank as straggler.
        st = analysis["straggler"]
        print(f"straggler analysis: rank={st['rank']} "
              f"votes={st['votes']}")
        if st["rank"] != STRAGGLER:
            failures.append(f"straggler misattributed: got "
                            f"{st['rank']}, want {STRAGGLER} "
                            f"(votes {st['votes']})")

        # Gate 4: clock offsets were estimated and are RTT-bounded.
        for rk, seg in segments.items():
            rtt = int(seg.get("clock_rtt_ns", 0) or 0)
            off = int(seg.get("clock_offset_ns", 0) or 0)
            if rtt <= 0:
                failures.append(f"rank {rk}: no clock estimate")
            elif abs(off) > rtt:
                failures.append(f"rank {rk}: |offset| {off} exceeds "
                                f"rtt {rtt}")

    # ---------------------------------------------- phase B: postmortem
    pm_dir = tempfile.mkdtemp(prefix="tdr_pm_")
    try:
        procs = [
            spawn_rank(
                "traceblack", coord.address, r, iters // 2,
                dict({"TDR_POSTMORTEM_DIR": pm_dir},
                     **({"TDR_FAULT_PLAN": "conn:drop_after=40"}
                        if r == DROPPER else {})))
            for r in range(WORLD)
        ]
        rcs = reap(procs, 240)
        if any(rc != 0 for rc in rcs):
            failures.append(f"phase B rank exit codes: {rcs}")
        world_dir = os.path.join(pm_dir, "traceblack")
        incidents = (sorted(os.listdir(world_dir))
                     if os.path.isdir(world_dir) else [])
        if not incidents:
            failures.append("no postmortem incident directory written")
        else:
            inc_dir = os.path.join(pm_dir, "traceblack", incidents[0])
            bundles = sorted(os.listdir(inc_dir))
            print(f"postmortem incident {incidents[0]}: {bundles}")
            # Every rank of the incident (the dropper AND the
            # survivors all rebuild) must have dumped a bundle.
            want = {f"rank{r}.json" for r in range(WORLD)}
            if not want <= set(bundles):
                failures.append(f"incomplete postmortem bundles: "
                                f"{bundles}")
            else:
                merged = explain_postmortem(inc_dir)
                inc = merged["incident"]
                if inc["world"] != "traceblack" or \
                        len(inc["ranks"]) != WORLD:
                    failures.append(f"postmortem merge wrong: {inc}")
                else:
                    print(f"postmortem merge: generation="
                          f"{inc['generation']} ranks="
                          f"{sorted(inc['ranks'])}")
        # /metrics must have counted the bundles.
        m = client.metrics()
        pm_lines = [ln for ln in m.splitlines()
                    if ln.startswith("tdr_postmortems_total")
                    and 'world="traceblack"' in ln]
        if not pm_lines or all(ln.endswith(" 0") for ln in pm_lines):
            failures.append(
                f"tdr_postmortems_total not served: {pm_lines}")
    finally:
        shutil.rmtree(pm_dir, ignore_errors=True)
        coord.stop()

    if failures:
        print("TRACE SMOKE FAILURES:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print("trace smoke OK: merged fleet trace valid, collectives "
          f"joinable by coll id, straggler=rank{STRAGGLER} attributed, "
          "postmortem bundles complete and merged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
