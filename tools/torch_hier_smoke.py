#!/usr/bin/env python3
"""Hierarchical-allreduce smoke for the PyTorch port: the port's
counterpart of ``tools/hier_smoke.py``, the same drive over the port's
own copies (``rocnrdma_tpu_torch.collectives.world``,
``rocnrdma_tpu_torch.transport.engine``).

    python3 tools/torch_hier_smoke.py
    TDR_HIER_QUICK=1 python3 tools/torch_hier_smoke.py

A world-8 ring emulating TWO HOSTS (host-key override
``TDR_TOPOLOGY=a,a,a,a,b,b,b,b``) drives the two-tier schedule —
intra-host reduce-scatter → inter-host delegate-ring allreduce →
intra-host all-gather — with corrupt riders armed on the sealed wire,
and gates:

- **Per-tier sealing**: the intra-host rings negotiate the CMA tier
  (tag-only seals — ``has_seal_payload`` False), the inter-host
  delegate rings are PINNED to the stream tier (full payload seals —
  True) even though every rank is CMA-reachable on this one machine.
- **Bitwise parity** hierarchical vs flat on exactly-representable
  sums, blocking AND async-chained, WITH the corrupt riders firing:
  the fault-plan hit counters and the integrity ladder counters are
  asserted, so a rider that never fired cannot green the run.
- **hier >= flat at the large-message point**, measured — gated only
  on hosts with >= 2 usable cores; on one core the verdict is recorded
  with the bound note instead (the BENCH_r08 cores-aware convention).

Numpy-only: it touches no device and takes no device argument, so the
sanitized sweep (``tests/test_torch_sanitize.py``) runs it as is under
``libtdr_san.so``. Ports come from a bind-probed band below the
ephemeral range (``port_band``).

Prints one ``HIER {...}`` JSON line with the reference's keys; exit 0
only if every gate held.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Knobs BEFORE the library loads: one channel (the smoke must pass on
# core-starved CI), the two-host key override, and corrupt riders early
# in the run (small nth — send arrivals are plentiful: every digest hop
# and every gradient chunk).
os.environ.setdefault("TDR_RING_CHANNELS", "1")
os.environ["TDR_TOPOLOGY"] = "a,a,a,a,b,b,b,b"
os.environ.setdefault("TDR_FAULT_PLAN",
                      "send:nth=7:corrupt=3,send:nth=29:corrupt=2")

QUICK = os.environ.get("TDR_HIER_QUICK", "0") not in ("", "0")
WORLD = 8


def port_band(span: int, lo: int = 21000, hi: int = 29000) -> int:
    """Bind-probe a CONTIGUOUS free port band below the ephemeral
    range. A hierarchical world listens across base..base+~world*4
    (flat ring + tier arenas, the tier ports binding only at the first
    hier collective) — an ephemeral probe-and-close base invites a
    later kernel-assigned client port to squat the span and wedge a
    digest hop for the full stall deadline."""
    import random

    rng = random.Random()
    for _ in range(128):
        base = rng.randrange(lo, hi - span)
        socks = []
        try:
            for p in range(base, base + span):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no free {span}-port band in [{lo}, {hi})")


def run_all(worlds, fn) -> None:
    errs = [None] * len(worlds)

    def body(r):
        try:
            fn(r)
        except BaseException as e:  # noqa: BLE001 - surfaced after join
            errs[r] = e

    ts = [threading.Thread(target=body, args=(r,))
          for r in range(len(worlds))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for e in errs:
        if e is not None:
            raise e


def timed_allreduce(worlds, bufs, algo: str, iters: int) -> float:
    def one(r):
        worlds[r].allreduce(bufs[r], algo=algo)

    run_all(worlds, one)  # warmup (tier bring-up, MRs)
    t0 = time.perf_counter()
    for _ in range(iters):
        run_all(worlds, one)
    return (time.perf_counter() - t0) / iters


def host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def hier_smoke(base_port: int | None = None) -> dict:
    """The drive: returns the ``HIER`` record, ``ok`` the conjunction of
    every gate (the timing gate only on a host with 2 or more cores)."""
    import numpy as np

    from rocnrdma_tpu_torch.collectives.world import local_worlds
    from rocnrdma_tpu_torch.transport.engine import (fault_plan_clauses,
                                                     fault_plan_hits,
                                                     fault_plan_reset,
                                                     seal_counters)

    fault_plan_reset()
    seal0 = seal_counters()
    world = WORLD
    out = {"world": world, "topology": os.environ["TDR_TOPOLOGY"],
           "quick": QUICK}
    cores = host_cores()
    out["host_cores"] = cores

    base = port_band(world * 4 + 8) if base_port is None else base_port
    worlds = local_worlds(world, base)
    ok = True
    try:
        # ---- parity under corrupt riders (exact-in-f32 sums) ----
        rng = np.random.default_rng(7)
        count = (32 << 10) if QUICK else (256 << 10)
        data = rng.integers(-100, 100, (world, count)).astype(np.float32)
        expect = data.sum(axis=0)

        flat_bufs = [data[r].copy() for r in range(world)]
        run_all(worlds, lambda r: worlds[r].allreduce(flat_bufs[r],
                                                      algo="flat"))
        hier_bufs = [data[r].copy() for r in range(world)]
        run_all(worlds, lambda r: worlds[r].allreduce(hier_bufs[r],
                                                      algo="hier"))
        async_bufs = [data[r].copy() for r in range(world)]

        def hier_async(r):
            worlds[r].allreduce_async(async_bufs[r], algo="hier").wait()

        run_all(worlds, hier_async)
        out["parity_flat_correct"] = all(
            np.array_equal(b, expect) for b in flat_bufs)
        out["parity_hier_bitwise"] = all(
            b.tobytes() == flat_bufs[0].tobytes() for b in hier_bufs)
        out["parity_hier_async_bitwise"] = all(
            b.tobytes() == flat_bufs[0].tobytes() for b in async_bufs)
        out["pending_async"] = sum(w.pending_async for w in worlds)
        ok &= out["parity_flat_correct"] and out["parity_hier_bitwise"] \
            and out["parity_hier_async_bitwise"] \
            and out["pending_async"] == 0

        # ---- per-tier sealing ----
        intra, inter = worlds[0]._tier_intra, worlds[0]._tier_inter
        out["intra_seal_payload"] = bool(intra.left_qp.has_seal_payload)
        out["inter_seal_payload"] = bool(inter.left_qp.has_seal_payload)
        ok &= (not out["intra_seal_payload"]) and out["inter_seal_payload"]

        # ---- the riders actually fired and were healed ----
        hits = sum(fault_plan_hits(i) for i in range(fault_plan_clauses()))
        seal1 = seal_counters()
        out["fault_hits"] = int(hits)
        out["integrity_failed"] = seal1["failed"] - seal0["failed"]
        out["retransmits"] = (seal1["retransmitted"]
                              - seal0["retransmitted"])
        ok &= hits > 0 and out["integrity_failed"] > 0 \
            and out["retransmits"] > 0

        # ---- measured hier vs flat at the large-message point ----
        big = ((1 << 20) if QUICK else (16 << 20)) // 4  # f32 elems
        bw_bufs = [np.ones(big, dtype=np.float32) for _ in range(world)]
        for w, b in zip(worlds, bw_bufs):
            w.ring.register_buffer(b)
        iters = 1 if QUICK else 2
        nbytes = big * 4

        def bus(dt):
            return nbytes * 2 * (world - 1) / world / dt / 1e9

        flat_dt = timed_allreduce(worlds, bw_bufs, "flat", iters)
        hier_dt = timed_allreduce(worlds, bw_bufs, "hier", iters)
        out["large_message_bytes"] = nbytes
        out["flat_GBps"] = round(bus(flat_dt), 3)
        out["hier_GBps"] = round(bus(hier_dt), 3)
        out["hier_vs_flat"] = round(out["hier_GBps"] / out["flat_GBps"], 3)
        out["hier_beats_flat"] = out["hier_GBps"] >= out["flat_GBps"]
        if cores >= 2:
            out["hier_gate"] = "measured (cores >= 2)"
            ok &= out["hier_beats_flat"]
        else:
            # On one core hier pays an extra full-buffer intra pass on
            # the same core every fold shares — flat >= hier by
            # construction; the verdict is recorded, not gated.
            out["hier_gate"] = ("recorded only: 1-core host — hier's "
                                "intra RS+AG pass shares the single "
                                "fold core, flat >= hier by "
                                "construction")
    finally:
        for w in worlds:
            try:
                w.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        fault_plan_reset()

    out["ok"] = bool(ok)
    return out


def main() -> int:
    out = hier_smoke()
    print("HIER " + json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
