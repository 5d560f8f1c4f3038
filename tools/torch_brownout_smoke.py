#!/usr/bin/env python3
"""Brownout smoke for the PyTorch port: the port's counterpart of
``tools/brownout_smoke.py``, the same drive over the port's own copies
(``rocnrdma_tpu_torch.collectives.health``, ``.collectives.world``,
``.transport.engine``).

    python3 tools/torch_brownout_smoke.py

A world-4 ring emulating TWO HOSTS (``TDR_TOPOLOGY=a,a,b,b``) soaks
the DEGRADATION LADDER: the delegate (inter-host, stream-tier) link is
browned out with netem riders — per-frame delay plus a throttle pacer
— and the run gates that the fleet degrades instead of dying:

- **Zero rebuilds**: the link-health EWMA collapses against its own
  baseline, the ladder falls hier→flat (arming the bf16 wire rung and
  then the int8 rung on the way down), and NOT ONE collective
  escalates to the deadline/probe/rebuild machinery.
  ``world.rebuild`` must not move.
- **The full three-rung walk, in order**: the per-iteration rung
  census must show a bf16-only state BEFORE the first int8 state
  BEFORE the first fallback state, and both wire counters
  (``health.wire_bf16`` / ``health.wire_int8``) must move.
- **One measured hier→flat fallback**: ``algo.degraded`` must move.
- **Healed parity**: after the riders clear, probation canaries raise
  the score past the heal hysteresis, the rungs disengage, and the
  schedule returns to hier — with every phase's results bitwise-equal
  to the numpy oracle throughout (the data construction below makes
  every rung lossless).
- **Flat thread census**: after close, no ``tdr-`` thread survives.

Numpy-only: it touches no device. The sanitized sweep
(``tests/test_torch_sanitize.py``) runs the identical drive against
``libtdr_san.so`` with ASan preloaded. Never run it concurrently with
the tier-1 suite.

Prints one ``BROWNOUT {...}`` JSON line with the reference's keys; exit
0 only if every gate held.
"""

import json
import os
import random
import socket
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Knobs BEFORE the library loads: one channel (core-starved CI), the
# two-host key override, health-ladder tuning sized to the smoke (the
# inter shard is 512 KiB — below the default 1 MiB goodput floor; the
# rung thresholds sit well under the 2-4x scheduler jitter of
# in-process phase timings, with a 2-sample streak so the 8-iteration
# brownout engages), an aggressive canary cadence so the heal phase
# converges in a handful of iterations, and a generous hard deadline
# that exists but must never fire (the ladder keeps every collective
# under it).
os.environ.setdefault("TDR_RING_CHANNELS", "1")
os.environ["TDR_TOPOLOGY"] = "a,a,b,b"
os.environ.setdefault("TDR_HEALTH_MIN_BYTES", "262144")
os.environ.setdefault("TDR_HEALTH_PROBE_EVERY", "2")
# Three rungs, spaced so the EWMA decay (score ~ 0.7^n under the
# brownout, alpha=0.3) crosses them on DIFFERENT samples with the
# 2-sample streak: bf16 engages around sample 2-3, int8 around 4-5,
# fallback around 5-7 — the walk is observable per iteration, not a
# single cliff where every rung arms at once.
os.environ.setdefault("TDR_HEALTH_WIRE", "0.72")
os.environ.setdefault("TDR_HEALTH_WIRE_INT8", "0.45")
os.environ.setdefault("TDR_HEALTH_FALLBACK", "0.3")
os.environ.setdefault("TDR_HEALTH_ENGAGE_STREAK", "2")
os.environ.setdefault("TDR_COLL_DEADLINE_MS", "60000")
os.environ.pop("TDR_NO_DEGRADE", None)
os.environ.pop("TDR_NO_WIRE_Q8", None)  # the int8 rung must be armable

# NOT imported from torch_hier_smoke: importing it would run its
# module prelude (an 8-rank TDR_TOPOLOGY and corrupt riders) over this
# smoke's environment.

def port_band(span: int, lo: int = 21000, hi: int = 29000) -> int:
    """Bind-probe a CONTIGUOUS free port band below the ephemeral
    range (the repo's port-band convention — a hierarchical world
    listens across base..base+~world*4 and the tier ports only bind
    at the first hier collective)."""
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


def run_all(worlds, fn):
    errs = [None] * len(worlds)

    def body(r):
        try:
            fn(r)
        except BaseException as e:  # surfaced after join
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


# Brownout riders on the delegate link only: every stream-tier frame
# pays a 2 ms (+-1 ms deterministic jitter) delay and an 8 MB/s pacer.
# The intra rings (CMA tier) and the flat ring stay clean — exactly
# the one-sick-delegate-link scenario the ladder exists for.
BROWNOUT_PLAN = ("send:tier=stream:delay=2000:1000,"
                 "send:tier=stream:throttle=8")


def tdr_thread_census():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("tdr-") and t.is_alive())


def main() -> int:
    import numpy as np

    from rocnrdma_tpu_torch.collectives import health
    from rocnrdma_tpu_torch.collectives.world import local_worlds
    from rocnrdma_tpu_torch.transport.engine import (fault_plan_clauses,
                                                     fault_plan_hits,
                                                     fault_plan_reset)
    from rocnrdma_tpu_torch.utils.trace import trace

    world = 4
    count = (1 << 20) // 4  # 1 MiB f32 per rank; inter shard 512 KiB
    out = {"world": world, "topology": os.environ["TDR_TOPOLOGY"],
           "plan": BROWNOUT_PLAN}
    health.reset()
    fault_plan_reset()
    rebuilds0 = trace.counter("world.rebuild")
    degraded0 = trace.counter("algo.degraded")
    hier0 = trace.counter("algo.hier")
    bf16_0 = trace.counter("health.wire_bf16")
    int8_0 = trace.counter("health.wire_int8")

    # Data construction for bitwise parity on EVERY rung: after the
    # intra reduce-scatter, each host's delegate holds the intra-host
    # sum v over its owned half-slice — the tensor every wire rung
    # quantizes. Choose per-rank data x and v-x (host a), y and v-y
    # (host b) so BOTH hosts' delegate shards equal the same integer
    # vector v in [-127, 127] with absmax EXACTLY 127 planted in each
    # half-slice. Then the bf16 truncation is lossless (|v| <= 127
    # needs <= 7 significant bits), the int8 quantization is exact
    # (scale = absmax/127 = 1.0, q = v), and the native running-scale
    # fold divides evenly (s_n = 2, q_n = rint((v + v)/2) = v, dequant
    # 2v = the true 4-rank sum). One oracle covers every phase.
    rng = np.random.default_rng(23)
    half = count // 2
    v = rng.integers(-126, 127, count).astype(np.float32)
    v[0], v[half] = 127.0, -127.0  # absmax == 127 in BOTH shard halves
    x = rng.integers(-100, 101, count).astype(np.float32)
    y = rng.integers(-100, 101, count).astype(np.float32)
    data = np.stack([x, v - x, y, v - y])
    expect = data.sum(axis=0)  # == 2v, exact in f32

    worlds = local_worlds(world, port_band(world * 4 + 8))
    wname = worlds[0].world_name
    ok = True
    # Per-iteration rung census (bf16, int8, fallback) — the walk
    # assertion scans the brownout segment of this list.
    ladder = []

    def sweep(iters, phase):
        """``iters`` hier-candidate allreduces, every result checked
        bitwise against the numpy oracle (the data construction above
        makes every rung lossless, so ONE predicate covers every rung
        the ladder may be on)."""
        for i in range(iters):
            bufs = [data[r].copy() for r in range(world)]
            run_all(worlds, lambda r: worlds[r].allreduce(bufs[r],
                                                          algo="hier"))
            for r in range(world):
                if bufs[r].tobytes() != expect.tobytes():
                    raise AssertionError(
                        f"parity broke: phase={phase} iter={i} rank={r}")
            ladder.append((health.wire_downgrade(wname),
                           health.wire_int8(wname),
                           health.fallback_active(wname)))

    try:
        # ---- phase 1: clean baseline (peaks establish "healthy") ----
        t0 = time.perf_counter()
        sweep(4, "baseline")
        out["baseline_s"] = round(time.perf_counter() - t0, 3)
        out["baseline_degraded"] = health.fallback_active(wname)
        ok &= not out["baseline_degraded"]

        # ---- phase 2: brownout the delegate link ----
        os.environ["TDR_FAULT_PLAN"] = BROWNOUT_PLAN
        fault_plan_reset()
        walk_from = len(ladder)
        t0 = time.perf_counter()
        sweep(10, "brownout")
        out["brownout_s"] = round(time.perf_counter() - t0, 3)
        out["fault_hits"] = sum(fault_plan_hits(i)
                                for i in range(fault_plan_clauses()))
        out["fallback_engaged"] = health.fallback_active(wname)
        out["degraded_switches"] = (trace.counter("algo.degraded")
                                    - degraded0)
        out["health"] = health.snapshot(wname)
        ok &= out["fault_hits"] > 0          # riders actually fired
        ok &= out["fallback_engaged"]        # the ladder engaged
        ok &= out["degraded_switches"] > 0   # ...and rerouted traffic

        # ---- the three-rung walk, in order (the r11 satellite) ----
        # The census must show bf16-only BEFORE the first int8 state
        # BEFORE the first fallback state, and collectives must have
        # RUN on both wire rungs (the counters move only when a hier
        # collective crosses the delegate link on that rung).
        seg = ladder[walk_from:]
        out["ladder_walk"] = ["".join(("b" if b else "-",
                                       "i" if i8 else "-",
                                       "f" if fb else "-"))
                              for b, i8, fb in seg]

        def first(pred):
            return next((i for i, st in enumerate(seg) if pred(st)),
                        None)

        i_bf16 = first(lambda st: st[0] and not st[1] and not st[2])
        i_int8 = first(lambda st: st[1] and not st[2])
        i_flat = first(lambda st: st[2])
        out["walk_ordered"] = (i_bf16 is not None and i_int8 is not None
                               and i_flat is not None
                               and i_bf16 < i_int8 < i_flat)
        out["wire_bf16_collectives"] = (trace.counter("health.wire_bf16")
                                        - bf16_0)
        out["wire_int8_collectives"] = (trace.counter("health.wire_int8")
                                        - int8_0)
        ok &= out["walk_ordered"]
        ok &= out["wire_bf16_collectives"] > 0
        ok &= out["wire_int8_collectives"] > 0

        # ---- phase 3: clear the riders, heal through canaries ----
        os.environ.pop("TDR_FAULT_PLAN", None)
        fault_plan_reset()
        t0 = time.perf_counter()
        for _ in range(40):
            sweep(1, "heal")
            if not health.fallback_active(wname) and \
                    not health.wire_downgrade(wname) and \
                    not health.wire_int8(wname):
                break
        out["heal_s"] = round(time.perf_counter() - t0, 3)
        out["healed"] = (not health.fallback_active(wname)
                         and not health.wire_downgrade(wname)
                         and not health.wire_int8(wname))
        sweep(2, "healed")  # healed parity, back on the hier schedule
        ok &= out["healed"]

        # ---- the one gate the whole ladder exists for ----
        out["rebuilds"] = trace.counter("world.rebuild") - rebuilds0
        out["hier_collectives"] = trace.counter("algo.hier") - hier0
        ok &= out["rebuilds"] == 0
        ok &= out["hier_collectives"] > 0
    finally:
        for w in worlds:
            try:
                w.close()
            except Exception:
                pass
        os.environ.pop("TDR_FAULT_PLAN", None)
        fault_plan_reset()
        health.reset()

    # ---- flat thread census (progress shards, hb, shims all gone) --
    census = tdr_thread_census()
    for _ in range(50):
        if not census:
            break
        time.sleep(0.1)
        census = tdr_thread_census()
    out["thread_census"] = census
    ok &= not census

    out["ok"] = bool(ok)
    print("BROWNOUT " + json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
