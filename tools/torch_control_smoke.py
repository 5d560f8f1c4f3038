#!/usr/bin/env python3
"""Control-plane smoke for the PyTorch port: coordinator + flapping-rank
soak, bitwise. The port's counterpart of ``tools/control_smoke.py``,
the same drive over the port's own copies (``rocnrdma_tpu_torch.control``,
``.collectives.world``, ``.telemetry``) and ``tools/torch_fault_soak.py``.

    python3 tools/torch_control_smoke.py          # full mode, on the card
    python3 tools/torch_control_smoke.py --cpu    # full mode, on the CPU
    TDR_CONTROL_SMOKE_LITE=1 python3 tools/torch_control_smoke.py

The full mode is a world-4 elastic training soak (llama-tiny, 3 steps,
seed 3) where rank 1 flaps (tears its transport down mid-step and
rejoins), every rebuild is arbitrated by an in-process coordinator, a
second named world shares the training engines for the whole run, and
a scraper thread hits the coordinator's /metrics endpoint throughout.
Its four ranks are threads; on the card they share ``cuda:0`` and
average their gradients with the fused sync, as
``tools/torch_fault_soak.py`` does. Without ``--cpu`` it runs on the
card and exits non-zero, before any verdict, where there is none.
Asserts:

- final params BITWISE equal to the uninterrupted run (the elastic
  contract, unchanged under arbitration);
- at least one arbitrated rebuild happened and every generation bump
  was a coordinator decision (ctl.* counters prove arbitration ran);
- the concurrent world stayed correct (multi-tenant engines under
  chaos);
- /metrics served the contract-pinned SLO names mid-soak (chunk p99,
  retransmit rate, rebuild count);
- the merged Perfetto export contains ctl.* events (a rebuild is
  reconstructable from a trace).

The lite mode (``TDR_CONTROL_SMOKE_LITE=1``) is the TRAINER-FREE drive
that the sanitized sweep runs against ``libtdr_san.so``: the same
coordinator, flap, rebuild, concurrent-world, budget and /metrics
machinery over plain int32 ring allreduces. It touches no device and
runs no torch operation that could throw a C++ exception (under ASan
any C++ exception aborts the process, even a caught one).

Prints the device on a line of its own, then a ``CONTROL_RUN {json}``
line (the whole drive's seconds and, for each soak, its seconds,
resumes, rebuild times and, in full mode, kernel launches), then the
reference's verdict JSON with the reference's keys; exits 0 only if
every gate held.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.dirname(os.path.abspath(__file__))
for _p in (REPO, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

os.environ["TDR_TELEMETRY"] = "1"

LITE = os.environ.get("TDR_CONTROL_SMOKE_LITE", "0") not in ("", "0")

# Contract-pinned metric names (tests/test_control.py pins the same).
PINNED = (
    "tdr_ctl_generation{",
    "tdr_ctl_members{",
    "tdr_ctl_rebuilds_total{",
    "tdr_retransmit_rate{",
)
PINNED_SLO = (
    'tdr_chunk_lat_us{world="train",quantile="0.99"}',
    "tdr_integrity_retransmitted_total{",
)

WORLD, STEPS, SEED = 4, 3, 3


def rebuild_seconds(since: float) -> list:
    """Seconds from each ``world.rebuild`` begin to its ok, per rank in
    the order they ended, for the rebuilds begun after ``since``
    (``time.monotonic()``)."""
    from rocnrdma_tpu_torch.utils.trace import trace

    begun, out = {}, []
    for at, _, f in trace.events("world.rebuild"):
        if at < since:
            continue
        if f.get("phase") == "begin":
            begun[f.get("rank")] = at
        elif f.get("phase") == "ok" and f.get("rank") in begun:
            out.append(round(at - begun.pop(f.get("rank")), 3))
    return out


def lite_soak(coord_address, world, rounds, flap_round):
    """Trainer-free chaos drive (the -san variant): world-N arbitrated
    RingWorlds doing bitwise-checked int32 allreduces; at
    ``flap_round`` one rank tears its transport down BEFORE posting,
    so every rank fails that same round (ring transitivity — no rank
    can complete a collective without every other), rebuilds through
    the coordinator, and retries the round. A corrupt rider keeps the
    NAK/retransmit ladder active under the sanitizer. Returns the
    soak's stats (rebuilds, ctl.* counters, generations, side_ok)."""
    import numpy as np

    import torch_fault_soak as fs
    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.transport.engine import (Engine, TransportError,
                                                     fault_plan_reset)
    from rocnrdma_tpu_torch.utils.trace import trace

    os.environ["TDR_FAULT_PLAN"] = "send:nth=9:corrupt=3"
    fault_plan_reset()
    rng = np.random.default_rng(17)
    data = rng.integers(-999, 999, (rounds, world, 8192)).astype(np.int32)
    expected = data.sum(axis=1, dtype=np.int64).astype(np.int32)
    engines = [Engine("emu") for _ in range(world)]
    worlds = [None] * world
    errs = [None] * world

    def boot(r):
        try:
            worlds[r] = RingWorld(engines[r], r, world, timeout_ms=15000,
                                  controller=coord_address,
                                  world_name="train", channels=2)
        except BaseException as e:
            errs[r] = e

    ts = [threading.Thread(target=boot, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()

    side_errs = [None] * world
    side_threads, side_finish = fs._run_side_world(
        engines, world, rounds, 3, None, coord_address, side_errs)

    def drive(r):
        try:
            w = worlds[r]
            for i in range(rounds):
                for attempt in range(5):
                    if r == 1 and i == flap_round and attempt == 0:
                        w._teardown()  # the flap: die before posting
                    buf = data[i, r].copy()
                    try:
                        w.allreduce(buf)
                    except TransportError as e:
                        if not e.retryable:
                            raise
                        w.rebuild(max_attempts=8, backoff_s=0.05,
                                  backoff_cap_s=0.5, timeout_ms=10000)
                        continue
                    assert buf.tobytes() == expected[i].tobytes(), \
                        f"round {i} rank {r} diverged"
                    break
                else:
                    raise RuntimeError(f"round {i} never converged")
        except BaseException as e:
            errs[r] = e

    ts = [threading.Thread(target=drive, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for t in side_threads:
        t.join(timeout=120)
    side_finish()
    for w in worlds:
        if w is not None:
            w.close()
    for e in engines:
        e.close()
    os.environ.pop("TDR_FAULT_PLAN", None)
    fault_plan_reset()
    for e in errs + side_errs:
        if e is not None:
            raise e
    return {"rebuilds": trace.counter("world.rebuild"),
            "ctl": {k: v for k, v in
                    trace.counters_prefixed("ctl.").items()},
            "generations": sorted({w.generation for w in worlds}),
            "resumes": 0,
            "side_ok": all(e is None for e in side_errs)}


def full_soak(coord_address, device, runs):
    """The reference's full mode: ``run_soak`` at world 4, clean, then
    under a corruption plan with the arbitrated flap of rank 1 and the
    concurrent side world. Fills ``runs`` with each soak's seconds,
    resumes, rebuild times and kernel launches; returns (parity, the
    faulty soak's stats)."""
    import torch_fault_soak as fs
    from rocnrdma_tpu_torch.ops import _native

    # A corruption rider keeps the integrity ladder (and its /metrics
    # series) active; the flap is the headline chaos.
    plan = (f"send:nth=7:corrupt=3,"
            f"send:nth={STEPS * WORLD * 3}:corrupt=2")
    soaks = (("clean", {}),
             ("faulty", dict(fault_plan=plan, coordinator=coord_address,
                             flap=(1, 2), concurrent=True)))
    params = {}
    with tempfile.TemporaryDirectory(prefix="tdr_ctl_smoke_") as d:
        for name, kw in soaks:
            _native.reset_launches()
            since = time.monotonic()
            t0 = time.perf_counter()
            params[name], stats = fs.run_soak(
                steps=STEPS, seed=SEED, world=WORLD,
                ckpt_dir=os.path.join(d, name), device=device, **kw)
            runs[name] = {"seconds": round(time.perf_counter() - t0, 3),
                          "resumes": stats["resumes"],
                          "rebuild_s": rebuild_seconds(since),
                          "launches": _native.launches()}
    return fs.params_equal(params["clean"], params["faulty"]), stats


def control_smoke(lite: bool, device=None, port_base=None):
    """The whole drive. Returns ``(verdict, runs)``: the reference's
    verdict dict (``ok`` last) and the per-soak record the
    ``CONTROL_RUN`` line prints. ``port_base``: the coordinator's first
    ring port (default: a free port)."""
    import torch_fault_soak as fs
    from rocnrdma_tpu_torch.control.client import ControlClient
    from rocnrdma_tpu_torch.control.coordinator import Coordinator
    from rocnrdma_tpu_torch.telemetry.perfetto import export_trace
    from rocnrdma_tpu_torch.transport.engine import telemetry_reset
    from rocnrdma_tpu_torch.utils.trace import trace

    telemetry_reset()
    coord = Coordinator(port=0, lease_ms=3000,
                        port_base=port_base or fs.free_port()).start()
    client = ControlClient(coord.address)
    scrapes = []
    stop = threading.Event()
    runs = {}

    def scraper():
        while not stop.wait(1.0):
            try:
                scrapes.append(client.metrics())
            except Exception:
                pass

    st = threading.Thread(target=scraper, daemon=True)
    st.start()

    try:
        if lite:
            since = time.monotonic()
            t0 = time.perf_counter()
            stats = lite_soak(coord.address, WORLD, rounds=6,
                              flap_round=2)
            runs["lite"] = {"seconds": round(time.perf_counter() - t0, 3),
                            "rebuild_s": rebuild_seconds(since)}
            parity = True  # every round was bitwise-checked in place
        else:
            parity, stats = full_soak(coord.address, device, runs)
        # One last scrape while the coordinator still holds the
        # worlds' final state.
        scrapes.append(client.metrics())
    finally:
        stop.set()
        st.join(timeout=5)
    final = scrapes[-1]
    pinned_ok = all(any(p in s for s in scrapes) for p in PINNED)
    slo_ok = all(p in final for p in PINNED_SLO)
    rebuild_line = [ln for ln in final.splitlines()
                    if ln.startswith('tdr_ctl_rebuilds_total{world="train"')]
    rebuilds_served = int(rebuild_line[0].split()[-1]) if rebuild_line else 0

    doc = export_trace(os.path.join(tempfile.gettempdir(),
                                    "tdr_control_smoke_trace.json"))
    ctl_events = sorted({e["name"] for e in doc["traceEvents"]
                         if str(e.get("name", "")).startswith("ctl.")})

    coord.stop()
    verdict = {
        "parity": parity,
        "lite": lite,
        "world": WORLD,
        "steps": STEPS,
        "arbitrated_rebuilds": stats["ctl"].get("ctl.rebuild", 0),
        "rebuilds_served_on_metrics": rebuilds_served,
        "generations": stats["generations"],
        "side_ok": stats["side_ok"],
        "pinned_names_scraped": pinned_ok,
        "slo_names_on_final_scrape": slo_ok,
        "scrapes": len(scrapes),
        "ctl_events_in_perfetto": ctl_events,
        "trainer_resumes": stats["resumes"],
    }
    ok = (parity and stats["side_ok"] and pinned_ok and slo_ok
          and verdict["arbitrated_rebuilds"] >= 1
          and rebuilds_served >= 1 and len(ctl_events) >= 2
          and trace.counter("ctl.release") >= 1)
    verdict["ok"] = ok
    return verdict, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="full mode: train on the CPU (the kernels' "
                         "plain versions) instead of the card; the lite "
                         "drive touches no device either way")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = None
    if LITE:
        print("device: none (lite drive: numpy int32 allreduces)",
              flush=True)
    else:
        from rocnrdma_tpu_torch import resolve_device

        # Raises here, before any verdict, where CUDA is asked for and
        # there is no card.
        device = resolve_device("cpu" if args.cpu else "cuda")
        if device.type == "cuda":
            import torch

            name = torch.cuda.get_device_name(device)
            print(f"device: {device} ({name})", flush=True)
        else:
            print(f"device: {device}", flush=True)
    verdict, runs = control_smoke(LITE, device)
    print("CONTROL_RUN " + json.dumps(
        {"seconds": round(time.perf_counter() - t0, 3), "soaks": runs}),
        flush=True)
    print(json.dumps(verdict, indent=2), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
