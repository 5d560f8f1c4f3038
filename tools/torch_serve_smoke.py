#!/usr/bin/env python3
"""The PyTorch port's serving data path, end to end: the port's
counterpart of ``tools/serve_smoke.py``.

    python3 tools/torch_serve_smoke.py          # decoders on the card
    python3 tools/torch_serve_smoke.py --cpu    # plain kernels on the CPU

A world-2 continuous-batching decode over streamed weight pages (two
ranks as threads of this process, ``local_worlds``), flight recorder on,
asserting what the reference's tool asserts:

  - **bitwise tokens**: the streamed, prefetched, continuously batched
    world-2 run gives exactly the sequential loopback baseline's tokens,
    including a request that joins mid-stream (prefill on its home rank,
    KV pages streamed to the peer) and one evicted mid-stream;
  - **heal**: a corrupt rider on a streamed page fails its seal, is
    NAKed and retransmitted (the seal counters move), and the tokens are
    still bitwise right;
  - **prefetch overlap**: wire events land inside the ``serve.compute``
    spans (best window of a small saturation sweep) above the gate;
  - **p99 token latency** under the gate, and **no leaked threads,
    credits or handles** across the loop and close.

  - **compiled decode** (``jit_decode``): the same loopback workload
    through ``ContinuousBatcher(jit_decode=True)`` (each decode layer
    step replayed from a CUDA graph over pooled caches; uncaptured on
    ``--cpu``) and through the eager decoder, both warm: tokens equal,
    the two rates and their ratio recorded, not gated.

The weights are llama-tiny's, from the port's ``init_params(seed=0)``,
and the loopback batcher's greedy tokens are first held against the
port's ``generate``. One leg of the reference's tool is left out
because it exists only in the JAX package: the cross-check of its numpy
decoder against the flax model.

Prints one ``SERVE {json}`` line with the reference's keys (with
``device``; ``jit_decode`` names the eager rate ``tokens_s_eager``,
where the reference's eager decoder is numpy). ``TDR_SERVE_QUICK=1``
sweeps two concurrency levels and one window a side;
``TDR_SERVE_GATE`` and ``TDR_SERVE_P99_US`` override the gates, as in
the reference's tool.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Rings big enough that the page-fetch lifecycle and the spans survive
# un-overwritten (read when the tracer module is imported); payload CRC
# on the CMA path, so the corrupt rider's flipped bytes fail the seal.
os.environ.setdefault("TDR_TELEMETRY_RING", str(1 << 20))
os.environ.setdefault("TDR_TRACE_RING", "65536")
os.environ.setdefault("TDR_PROGRESS_SHARDS", "2")
os.environ.setdefault("TDR_RING_CHANNELS", "2")
os.environ.setdefault("TDR_SEAL_CMA", "1")

import torch  # noqa: E402

from rocnrdma_tpu_torch import resolve_device, telemetry  # noqa: E402
from rocnrdma_tpu_torch.collectives.world import local_worlds  # noqa: E402
from rocnrdma_tpu_torch.models import llama  # noqa: E402
from rocnrdma_tpu_torch.serving.batcher import (  # noqa: E402
    ContinuousBatcher, Request)
from rocnrdma_tpu_torch.serving.model import (  # noqa: E402
    ServeConfig, pack_llama_params)
from rocnrdma_tpu_torch.transport.engine import (  # noqa: E402
    fault_plan_reset, seal_counters, seal_counters_reset)
from rocnrdma_tpu_torch.utils.trace import trace  # noqa: E402

QUICK = os.environ.get("TDR_SERVE_QUICK", "0") not in ("", "0")
CORRUPT_RIDER = "send:chunk=0:nth=1:corrupt=3"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def task_count() -> int:
    return len(os.listdir("/proc/self/task"))


def settle_census(baseline: int, deadline_s: float = 5.0) -> int:
    deadline = time.time() + deadline_s
    while task_count() > baseline and time.time() < deadline:
        time.sleep(0.05)
    return task_count()


def build_pages(device):
    """(cfg, pages) of llama-tiny from the port's ``init_params``; the
    loopback batcher's greedy tokens are held against ``generate``."""
    lcfg = llama.LLAMA_TINY
    state = llama.init_params(lcfg, seed=0, device=device)
    model = llama.Llama(lcfg, device=device)
    model.load_state_dict(state)
    cfg = ServeConfig.from_llama(lcfg)
    pages = pack_llama_params(cfg, llama.params_to_flax(state))
    prompt = [5, 9, 42, 7]
    want = llama.generate(model, [prompt], 8,
                          device=device)[0].cpu().tolist()
    b = ContinuousBatcher(None, pages, cfg, max_slots=1, prefetch=False,
                          device=device)
    b.submit(Request(1, prompt, 8))
    b.run()
    b.close()
    got = b.finished[1].tokens
    assert got == want, f"paged decoder diverged from generate: {got} != {want}"
    return cfg, pages


def drive_scenario(batcher):
    """R1 + R2 decode; three boundaries in, R3 queues and R1 is evicted
    mid-stream; the next boundary frees R1's slot and admits R3 (prefill
    on its home rank 1, KV join)."""
    batcher.submit(Request(1, [3, 7, 11], 8))
    batcher.submit(Request(2, [9, 2], 10))
    for _ in range(3):
        batcher.step()
    batcher.submit(Request(3, [5, 1], 6))
    batcher.evict(1)
    batcher.run()
    return {rid: r.tokens for rid, r in sorted(batcher.finished.items())}


def run_world2(pages, cfg, device, fn, max_slots=2, prefetch=True):
    """``fn(batcher)`` lockstep on a world-2 pair of threads: (results,
    batchers, worlds); the caller asserts and closes."""
    worlds = local_worlds(2, free_port())
    batchers = [ContinuousBatcher(w, pages, cfg, max_slots=max_slots,
                                  prefetch=prefetch, device=device)
                for w in worlds]
    results, errs = [None, None], [None, None]

    def drive(i):
        try:
            results[i] = fn(batchers[i])
        except BaseException as e:  # noqa: BLE001 — raised below
            errs[i] = e

    ts = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for e in errs:
        if e is not None:
            for b in batchers:
                try:
                    b.close()
                except Exception:  # noqa: BLE001 — the first error wins
                    pass
            for w in worlds:
                w.close()
            raise e
    return results, batchers, worlds


def close_all(batchers, worlds) -> None:
    """Close the batchers (run-ahead prefetches hold live handles until
    the streamer drains them), then the worlds; no handle, transfer or
    credit may be left."""
    for b in batchers:
        b.close()
    pend = [w.pending_async for w in worlds]
    for w in worlds:
        w.close()
    assert pend == [0, 0], f"leaked async handles: {pend}"
    for b in batchers:
        for eng in (b.streamer.engine, b.kv.engine):
            s = eng.stats()
            assert s["live"] == 0, f"{s['name']}: live transfers leak"
            assert s["acquired"] == s["released"], \
                f"{s['name']}: credit imbalance {s}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the decoders on the CPU (plain kernels)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg, pages = build_pages(device)

    # 1. Sequential loopback baseline: no transport, no prefetch.
    base = ContinuousBatcher(None, pages, cfg, max_slots=2, prefetch=False,
                             device=device)
    want = drive_scenario(base)
    base.close()
    assert base.finished[1].evicted and len(want[1]) < 8, \
        "scenario must evict R1 mid-stream"
    assert base.finished[3].joined_step > base.finished[2].joined_step, \
        "scenario must join R3 mid-stream"

    telemetry.enable()

    # 2. World 2 under a corrupt rider: NAK, clean retransmit, tokens
    # bitwise the baseline's.
    os.environ["TDR_FAULT_PLAN"] = CORRUPT_RIDER
    fault_plan_reset()
    seal_counters_reset()
    try:
        results, batchers, worlds = run_world2(pages, cfg, device,
                                               drive_scenario)
        heal = {k: int(v) for k, v in seal_counters().items()}
        close_all(batchers, worlds)
    finally:
        os.environ.pop("TDR_FAULT_PLAN", None)
        fault_plan_reset()
    assert results[0] == results[1] == want, \
        (f"streamed tokens diverged from the sequential baseline:\n"
         f"  r0={results[0]}\n  r1={results[1]}\n  want={want}")
    assert heal.get("failed", 0) >= 1 and \
        heal.get("retransmitted", 0) >= 1, \
        f"corrupt rider did not walk the NAK/retransmit ladder: {heal}"
    seal_counters_reset()

    # 3. Saturation sweep: requests/s against p99 token latency at
    # rising concurrency, the overlap fraction per level.
    levels = [1, 4] if QUICK else [1, 2, 4, 8]
    gen = 4 if QUICK else 8
    curve, windows = [], []
    census_baseline = None
    for conc in levels:
        def load(b, conc=conc):
            for i in range(conc):
                b.submit(Request(10 + i, [2 + i, 5, 3], gen))
            t0 = time.perf_counter()
            b.run()
            return {"dt": time.perf_counter() - t0,
                    "tokens": sum(len(r.tokens)
                                  for r in b.finished.values()),
                    "lat": list(b.token_lat_us)}

        telemetry.reset()
        results, batchers, worlds = run_world2(
            pages, cfg, device, load, max_slots=max(2, conc))
        if census_baseline is None:
            census_baseline = task_count()
        frac = telemetry.overlap_fraction(telemetry.timeline(),
                                          span="serve.compute")
        steady = settle_census(census_baseline)
        assert steady <= census_baseline, \
            (f"threads grew {census_baseline} -> {steady} at "
             f"concurrency {conc}")
        close_all(batchers, worlds)
        r0 = results[0]
        lat = sorted(r0["lat"])
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else 0.0
        curve.append({
            "concurrency": conc,
            "requests_s": round(conc / r0["dt"], 3),
            "tokens_s": round(r0["tokens"] / r0["dt"], 3),
            "p99_token_us": round(p99, 1),
            "overlap_fraction": frac["overlap_fraction"],
            "wire_events": frac["wire_events"],
        })
        windows.append(frac["overlap_fraction"])

    # 4. Prefetch against on-demand fetches at the top concurrency, the
    # same number of windows a side, best of each.
    conc = levels[-1]
    trials = 1 if QUICK else 3

    def load_np(b):
        for i in range(conc):
            b.submit(Request(10 + i, [2 + i, 5, 3], gen))
        t0 = time.perf_counter()
        b.run()
        return {"dt": time.perf_counter() - t0,
                "tokens": sum(len(r.tokens) for r in b.finished.values())}

    def tokens_s(prefetch):
        results, batchers, worlds = run_world2(pages, cfg, device, load_np,
                                               max_slots=max(2, conc),
                                               prefetch=prefetch)
        close_all(batchers, worlds)
        return round(results[0]["tokens"] / results[0]["dt"], 3)

    pre_windows = [curve[-1]["tokens_s"]]
    pre_windows += [tokens_s(True) for _ in range(trials - 1)]
    np_windows = [tokens_s(False) for _ in range(trials)]
    telemetry.disable()

    # 5. The compiled decode: the same loopback workload through
    # jit_decode=True against the eager decoder, both measured warm (a
    # first batch of four requests fills every slot, so each pooled
    # cache pair's layer step is captured before the clock starts).
    # Tokens must be equal; the rates are recorded, not gated.
    def decode_rate(jit):
        b = ContinuousBatcher(None, pages, cfg, max_slots=4, prefetch=False,
                              jit_decode=jit, device=device)
        for i in range(4):
            b.submit(Request(30 + i, [2, 5, 3 + i], 4))
        b.run()
        for i in range(4):
            b.submit(Request(40 + i, [2 + i, 5, 3], gen))
        t0 = time.perf_counter()
        b.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        toks = {rid: r.tokens for rid, r in sorted(b.finished.items())
                if rid >= 40}
        b.close()
        n = sum(len(t) for t in toks.values())
        return round(n / dt, 3), toks, getattr(b.decoder, "graphs", 0)

    eager_rate, eager_toks, _ = decode_rate(False)
    jit_rate, jit_toks, jit_graphs = decode_rate(True)
    assert jit_toks == eager_toks, \
        (f"compiled paged decode diverged from the eager decoder:\n"
         f"  jit={jit_toks}\n  eager={eager_toks}")
    jit_decode = {"tokens_s_eager": eager_rate, "tokens_s_jit": jit_rate,
                  "speedup": round(jit_rate / eager_rate, 3)
                  if eager_rate else None,
                  "tokens_match": True, "graphs": jit_graphs}

    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    # The reference's cores-aware gate: the 0.3 bar assumes compute runs
    # while the progress threads move frames; on one core the fraction
    # is the scheduler's, and the bar drops to a sanity floor.
    default_gate = "0.3" if cores >= 2 else "0.05"
    gate = float(os.environ.get("TDR_SERVE_GATE", default_gate))
    out = {
        "mode": "full",
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else None),
        "world": 2,
        "host_cores": cores,
        "overlap_gate": gate,
        "pages": len(pages),
        "page_bytes_max": pages.max_elems * 4,
        "depth": batchers[0].streamer.depth,
        "curve": curve,
        "windows": sorted(windows),
        "overlap_fraction": max(windows),
        "prefetch_tokens_s": max(pre_windows),
        "noprefetch_tokens_s": max(np_windows),
        "tokens_s_windows": {"prefetch": sorted(pre_windows),
                             "noprefetch": sorted(np_windows)},
        "jit_decode": jit_decode,
        "heal": {"failed": heal.get("failed", 0),
                 "retransmitted": heal.get("retransmitted", 0)},
        "scenario": {"evicted": 1, "joined_midstream": 1,
                     "bitwise_ok": True,
                     "tokens": {str(k): v for k, v in want.items()}},
        "serve_requests": trace.counter("serve.requests"),
        "serve_tokens": trace.counter("serve.tokens"),
    }
    print("SERVE " + json.dumps(out), flush=True)

    p99_gate = float(os.environ.get("TDR_SERVE_P99_US", "500000"))
    worst_p99 = max(c["p99_token_us"] for c in curve)
    assert all(c["wire_events"] > 0 for c in curve), \
        "no wire events recorded: pages did not ride the wire"
    assert out["overlap_fraction"] > gate, \
        (f"serve overlap_fraction {out['overlap_fraction']} <= {gate}: "
         "page fetches are not hiding behind compute")
    assert worst_p99 < p99_gate, \
        f"p99 token latency {worst_p99}us >= {p99_gate}us"
    print(f"torch-serve-smoke OK: device={device.type} "
          f"overlap_fraction={out['overlap_fraction']} "
          f"tokens_s={out['prefetch_tokens_s']} "
          f"(noprefetch {out['noprefetch_tokens_s']}) p99us={worst_p99}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
