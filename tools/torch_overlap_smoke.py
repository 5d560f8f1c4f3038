#!/usr/bin/env python3
"""overlap_smoke for the PyTorch port: the backward-overlap trainer
path, end to end. The port's counterpart of ``tools/overlap_smoke.py``.

    python3 tools/torch_overlap_smoke.py          # full mode on the card
    python3 tools/torch_overlap_smoke.py --cpu    # full mode on the CPU
    TDR_OVERLAP_SMOKE_LITE=1 python3 tools/torch_overlap_smoke.py

Full mode drives a world-2 PER-LAYER train loop — the port's
``Trainer`` (llama-tiny, 6 layers) whose gradient hooks push each
layer's bucket to ``CrossSliceAllReduce(per_layer=True,
wire_dtype="int8")`` during the backward, where it quantizes to int8
(per-bucket absmax scale, error-feedback residual) and launches on the
async wire — then a fused f32 pair on the same batches. It asserts:

  - ``wire_events > 0``;
  - handle-leak-free shutdown: every world's ``pending_async`` census
    is zero, and the native thread census is flat across the measured
    windows and drops below its baseline once the overlap pair is
    closed (and stays flat across the fused pair);
  - the per-layer int8 losses stay within 5e-3 of the fused f32
    pair's, per rank;
  - on the CPU only, the reference's two timing gates: the coarse
    ``overlap_fraction`` (wire events inside ``trainer.grads``) above
    ``TDR_OVERLAP_GATE`` (0.3) and the cores-aware
    ``compute_overlap_fraction`` (wire events inside the nested
    ``trainer.backward`` span) above ``TDR_OVERLAP_COMPUTE_GATE`` (0.7;
    on a 1-core host a bound note records why it cannot be measured).
    The reference's contract is llama-tiny on the CPU, and ``--cpu`` is
    that run. On the card the fractions are reported, with ``met`` and
    a ``bound_note`` giving the measured grads ms against the ring's ms
    per step, and not gated: a card backward leaves the host wire
    little time to hide in.

On the CPU the two ranks are threads of this process, as in the
reference. On the card they are two processes (the tool re-launches
itself as ``--rank r --port p`` children over the emu ring): autograd
runs a process's CUDA backwards on one device thread, so thread ranks
on one card cannot run the per-layer sync. Each child runs both pairs
for its rank and checks its own censuses and losses; the parent
gathers their ``RANK`` lines, merges their windows and prints
``OVERLAP``.

Lite mode (``TDR_OVERLAP_SMOKE_LITE=1``) is trainer-free and touches no
device: per step, numpy buckets are launched as async allreduce
handles under a synthetic compute span and waited in a sync span, the
result checked bitwise. It is the mode the sanitized sweep runs
(``tests/test_torch_sanitize.py``): under ASan any C++ exception torch
throws aborts the process, even a caught one, so that run keeps torch
off its path.

Prints one ``OVERLAP {json}`` line with the reference's keys (the
``compute_gate`` object included) and a ``device: ...`` line naming
where the ranks ran; exit 0 only if every binding gate held.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Big enough rings that a few steps of chunk lifecycle + spans survive
# un-overwritten; must be set before the tracer module is imported.
os.environ.setdefault("TDR_TELEMETRY_RING", str(1 << 20))
os.environ.setdefault("TDR_TRACE_RING", "65536")
# Force the sharded engine (defaults OFF on 1-core hosts): the smoke's
# job is to drive the machinery the overlap rides on.
os.environ.setdefault("TDR_PROGRESS_SHARDS", "2")
os.environ.setdefault("TDR_RING_CHANNELS", "2")

import numpy as np  # noqa: E402

from rocnrdma_tpu_torch import telemetry  # noqa: E402
from rocnrdma_tpu_torch.collectives.world import (RingWorld,  # noqa: E402
                                                  local_worlds)
from rocnrdma_tpu_torch.transport.engine import Engine  # noqa: E402
from rocnrdma_tpu_torch.utils.trace import trace  # noqa: E402

LITE = os.environ.get("TDR_OVERLAP_SMOKE_LITE", "0") not in ("", "0")
QUICK = os.environ.get("TDR_OVERLAP_QUICK", "0") not in ("", "0")
STEPS = 2 if QUICK else 4
WINDOWS = 2 if QUICK else 3
LOSS_TOL = 5e-3
# The fused pair's worlds listen this far above the per-layer pair's.
PAIR_PORT_GAP = 8


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def task_count() -> int:
    """Native thread census (the test_multichannel leak detector)."""
    return len(os.listdir("/proc/self/task"))


def settle_census(baseline: int, deadline_s: float = 5.0) -> int:
    deadline = time.time() + deadline_s
    while task_count() > baseline and time.time() < deadline:
        time.sleep(0.05)
    return task_count()


def run_threads(fn, n: int) -> None:
    """``fn(i)`` on ``n`` threads; the first error re-raised after the
    join."""
    errs = [None] * n

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 - surfaced after join
            errs[i] = e

    ts = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for e in errs:
        if e is not None:
            raise e


def lite_main(port: int | None = None) -> dict:
    """Trainer-free drive of the async-handle machinery: per 'step',
    launch a pipeline of bucket allreduces inside a trainer.grads span
    with synthetic compute between launches, wait them in a sync span.
    Bitwise-checked against the exact expected sum."""
    count = (8 << 20) // 4
    nbuckets = 8
    seg = count // nbuckets
    telemetry.enable()
    worlds = local_worlds(2, free_port() if port is None else port)
    bufs = [np.empty(count, dtype=np.float32) for _ in range(2)]
    for r in range(2):
        worlds[r].ring.register_buffer(bufs[r])
    base = (np.arange(count, dtype=np.float32) % 977)
    expect = base * 3
    scratch = np.empty(count, dtype=np.float32)
    fracs = []
    try:
        for step in range(STEPS + 1):  # step 0 = warmup
            telemetry.reset()
            for r in range(2):
                bufs[r][:] = base * (r + 1)
            handles = [[], []]

            def grads_and_launch(r):
                with trace.span("trainer.grads", step=step), \
                        trace.span("trainer.backward", step=step):
                    # The nested backward span mirrors the trainer's
                    # shape: the synthetic "compute" (the copyto) and
                    # the launches both live inside it.
                    for k in range(nbuckets):
                        np.copyto(scratch[k * seg:(k + 1) * seg],
                                  bufs[r][k * seg:(k + 1) * seg])
                        handles[r].append(worlds[r].allreduce_async(
                            bufs[r][k * seg:(k + 1) * seg]))
                with trace.span("trainer.sync", step=step):
                    for h in handles[r]:
                        h.wait()

            run_threads(grads_and_launch, 2)
            for r in range(2):
                assert bufs[r].tobytes() == expect.tobytes(), \
                    f"rank {r}: bucketed async result diverged"
                assert worlds[r].pending_async == 0
            if step > 0:  # warmup window discarded
                fracs.append(telemetry.overlap_fraction(
                    telemetry.timeline()))
    finally:
        for w in worlds:
            w.close()
    # Best window of N, every window recorded (the full mode's
    # convention): single windows are scheduler noise on a shared core.
    by_frac = sorted(f["overlap_fraction"] for f in fracs)
    best = max(fracs, key=lambda f: f["overlap_fraction"])
    return {"mode": "lite", "steps": STEPS, "buckets": nbuckets,
            "windows": by_frac, **best}


def _batches() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, (2, 65)).astype(np.int32)
            for _ in range(2)]


def measure_pairs(ranks: list, open_worlds, device: str) -> dict:
    """Both pairs for the ranks this process holds (both as threads, or
    one in a rank process): the per-layer int8 pair over ``WINDOWS``
    windows of ``STEPS`` steps after a warm step, then the fused f32
    pair on the same batches for the loss parity and the step-time
    comparison. ``open_worlds(k)`` gives this process's worlds of pair
    ``k`` (0 per-layer, 1 fused) in the order of ``ranks``. Asserts the
    censuses and each rank's loss parity; returns the windows' overlap
    records, their step walls, the fused step, the losses, the censuses
    and, a step of the per-layer pair, each rank's grads and sync ms and
    a rank's ring ms (its collectives' spans summed, by the recorder's
    ``ring_phase_split``)."""
    from rocnrdma_tpu_torch.collectives.torch_shim import \
        CrossSliceAllReduce
    from rocnrdma_tpu_torch.parallel.trainer import Trainer

    batches = _batches()
    n = len(ranks)

    def make_pair(k, per_layer, wire):
        worlds = open_worlds(k)
        shims = [CrossSliceAllReduce(
            w, mean=True, per_layer=per_layer, wire_dtype=wire)
            if per_layer else
            CrossSliceAllReduce(w, mean=True, wire_dtype=wire)
            for w in worlds]
        trainers = [Trainer("llama-tiny", {"dp": 1, "tp": 1}, seed=3,
                            cross_slice_sync=s, n_layers=6, device=device)
                    for s in shims]
        return worlds, shims, trainers

    def run(trainers, count, losses, split=None):
        def run_slice(i):
            for _ in range(count):
                losses[i].append(trainers[i].step(batches[ranks[i]]))
                if split is not None:
                    for key in ("grads_ms", "sync_ms"):
                        split[i][key] += trainers[i].last_split[key]

        t0 = time.perf_counter()
        run_threads(run_slice, n)
        return (time.perf_counter() - t0) / count

    def close(worlds, shims):
        for s in shims:
            s.close()
        for w in worlds:
            engine = w.engine
            w.close()
            if not engine.world_count:
                engine.close()

    telemetry.enable()
    worlds, shims, trainers = make_pair(0, True, "int8")
    o_losses = [[] for _ in ranks]
    run(trainers, 1, o_losses)  # warm step: first launches, staging
    # Census baseline AFTER the warm step: the process-wide pools, the
    # engines' progress threads and the rings' async drivers all exist
    # now — anything that GROWS the count across the measured windows
    # is a per-step leak.
    baseline = task_count()
    fracs, walls = [], []
    split = [{"grads_ms": 0.0, "sync_ms": 0.0} for _ in ranks]
    ring_s = 0.0
    for _ in range(WINDOWS):
        telemetry.reset()
        walls.append(round(run(trainers, STEPS, o_losses, split), 4))
        events = telemetry.timeline()
        fracs.append(telemetry.overlap_fraction(events))
        phases = telemetry.ring_phase_split(events)
        ring_s += sum(phases[p] for p in telemetry.PHASES)
    steady = settle_census(baseline)
    assert steady <= baseline, \
        (f"native threads grew {baseline} -> {steady} across "
         f"{WINDOWS * STEPS} per-layer steps: per-step thread leak")
    pend = [w.pending_async for w in worlds]
    close(worlds, shims)
    assert pend == [0] * n, f"leaked async handles: {pend}"
    # Closing the overlap pair must tear its threads down — the
    # engines' progress threads AND the rings' async drivers — so the
    # census drops strictly below the live-pair baseline.
    closed = settle_census(baseline - 1)
    assert closed < baseline, \
        (f"native threads {baseline} -> {closed} after closing the "
         "overlap pair: driver/engine threads leaked past close")

    worlds, shims, trainers = make_pair(1, False, None)
    f_losses = [[] for _ in ranks]
    run(trainers, 1, f_losses)
    fused_s = round(run(trainers, STEPS, f_losses), 4)
    close(worlds, shims)
    after = settle_census(closed)
    assert after <= closed, \
        (f"native threads grew {closed} -> {after} across the fused "
         "pair: leaked threads")
    for i, r in enumerate(ranks):
        for a, b in zip(o_losses[i], f_losses[i]):
            assert abs(a - b) < LOSS_TOL, (r, o_losses[i], f_losses[i])
    telemetry.disable()
    measured = WINDOWS * STEPS
    return {"fracs": fracs, "walls": walls, "fused_step_s": fused_s,
            "losses": o_losses, "fused_losses": f_losses,
            "pending_async": pend,
            "census": {"baseline": baseline, "steady": steady,
                       "closed": closed, "after_fused": after},
            "grads_ms_per_step": [s["grads_ms"] / measured for s in split],
            "sync_ms_per_step": [s["sync_ms"] / measured for s in split],
            "ring_ms_per_step": ring_s * 1e3 / (measured * n)}


def full_record(fracs: list, walls: list, fused_s: float) -> dict:
    """The reference's full-mode record from the measured windows:
    best-of-N by the compute fraction, every window alongside."""
    by_frac = sorted(f["overlap_fraction"] for f in fracs)
    by_cfrac = sorted(f["compute_overlap_fraction"] for f in fracs)
    best = max(fracs, key=lambda f: (f["compute_overlap_fraction"],
                                     f["overlap_fraction"]))
    return {"mode": "full", "steps": STEPS, "windows": by_frac,
            "compute_windows": by_cfrac,
            "bucket_bytes": 32 << 10, "wire_dtype": "int8",
            "per_layer": True,
            "bucketed_step_s": sorted(walls)[len(walls) // 2],
            "fused_step_s": fused_s,
            "overlap_fraction": best["overlap_fraction"],
            "overlap_fraction_median": by_frac[len(by_frac) // 2],
            "compute_overlap_fraction":
                best["compute_overlap_fraction"],
            "staging_overlap_fraction":
                best["staging_overlap_fraction"],
            "span": best["span"], "wire_events": best["wire_events"],
            "wire_in_span": best["wire_in_span"],
            "wire_in_compute": best["wire_in_compute"]}


def full_main(port: int | None = None) -> tuple:
    """Full mode on the CPU, both ranks threads of this process (the
    reference's shape): (the OVERLAP record, the ranks' details)."""
    base = free_port() if port is None else port
    m = measure_pairs([0, 1], lambda k: local_worlds(
        2, base + k * PAIR_PORT_GAP), "cpu")
    detail = {"device": "cpu", "ranks": "threads",
              "grads_ms_per_step": m["grads_ms_per_step"],
              "sync_ms_per_step": m["sync_ms_per_step"],
              "ring_ms_per_step": m["ring_ms_per_step"],
              "pending_async": m["pending_async"], "census": m["census"],
              "losses": m["losses"], "fused_losses": m["fused_losses"]}
    return full_record(m["fracs"], m["walls"], m["fused_step_s"]), detail


def rank_main(rank: int, port: int, device: str = "cuda") -> dict:
    """One rank process of the full mode: both pairs for ``rank`` over
    the emu ring at ``port``. Returns the rank's record (its ``RANK``
    line): the measurements, the device it ran on and each kernel's
    launches in its steps."""
    import torch

    from rocnrdma_tpu_torch import resolve_device
    from rocnrdma_tpu_torch.ops import _native

    dev = resolve_device(device)
    _native.reset_launches()

    def open_worlds(k):
        return [RingWorld(Engine("emu"), rank, 2,
                          port + k * PAIR_PORT_GAP)]

    m = measure_pairs([rank], open_worlds, device)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"rank": rank,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "launches": _native.launches(),
            "steps_run": 2 + STEPS * (WINDOWS + 1), **m}


def full_main_procs(port: int | None = None, device: str = "cuda",
                    timeout: float = 600) -> tuple:
    """Full mode as two rank processes of this script (the card's
    shape); their windows merged into the OVERLAP record (best-of-N over
    both ranks' windows; the fused step the slower rank's). Returns (the
    record, the ranks' details)."""
    port = free_port() if port is None else port
    # The children read TDR_OVERLAP_QUICK from the inherited environment.
    cmd = [sys.executable, os.path.abspath(__file__), "--port", str(port)]
    if device == "cpu":
        cmd.append("--cpu")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO)
             for r in range(2)]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}: "
                               f"{err[-3000:]}")
        line = next(ln for ln in out.splitlines() if ln.startswith("RANK "))
        ranks.append(json.loads(line[len("RANK "):]))
    rec = full_record([f for rk in ranks for f in rk["fracs"]],
                      [w for rk in ranks for w in rk["walls"]],
                      max(rk["fused_step_s"] for rk in ranks))
    detail = {"device": ranks[0]["device"], "ranks": "processes",
              "per_rank": [{k: v for k, v in rk.items() if k != "fracs"}
                           for rk in ranks]}
    return rec, detail


def host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def gate(out: dict, lite: bool, on_card: bool,
         detail: dict | None = None) -> tuple:
    """Add the reference's ``compute_gate`` to ``out``; returns (the
    coarse gate, whether the timing gates bind). The gates bind as the
    reference's on the CPU; on the card ``met`` is reported and the
    bound note gives the measured grads ms against the ring's ms a step.
    TDR_OVERLAP_GATE and TDR_OVERLAP_COMPUTE_GATE override the bars (the
    sanitized lite run sets the coarse one low: ASan multiplies the
    native wire's cost while numpy compute runs unsanitized)."""
    g = float(os.environ.get("TDR_OVERLAP_GATE", "0.3"))
    cgate = float(os.environ.get("TDR_OVERLAP_COMPUTE_GATE",
                                 str(g) if lite else "0.7"))
    cores = host_cores()
    cfrac = out["compute_overlap_fraction"]
    met = cfrac > cgate
    bound_note = None
    if not met and cores < 2:
        bound_note = (
            "1-core host: the backward and the wire progress threads "
            "timeshare the single core, so the share of wire events the "
            "scheduler lands inside trainer.backward is scheduler-bound, "
            "not machinery-bound — gate measured only with >= 2 usable "
            "cores (BENCH_r08 cores-aware convention; re-scored "
            "automatically when CI regains cores)")
    elif on_card:
        per_rank = detail["per_rank"]
        grads = max(rk["grads_ms_per_step"][0] for rk in per_rank)
        ring = max(rk["ring_ms_per_step"] for rk in per_rank)
        sync = max(rk["sync_ms_per_step"][0] for rk in per_rank)
        bound_note = (
            f"card: reported, not gated — a step's backward took "
            f"{grads:.2f} ms against {ring:.2f} ms of the ring's "
            f"collectives, {sync:.2f} ms of them waited after the "
            "backward; the host wire hides only in the window a card "
            "backward leaves it (the reference's gates bind on the CPU: "
            "--cpu)")
    out["compute_gate"] = {
        "metric": "train_step_compute_overlap_fraction",
        "threshold": cgate,
        "host_cores": cores,
        "value": cfrac,
        "met": met,
        "bound_note": bound_note,
    }
    return g, not on_card


def check(out: dict, g: float, timing: bool) -> None:
    """The gates: wire events always; the two fractions where the timing
    gates bind."""
    assert out["wire_events"] > 0, "no wire events recorded"
    if not timing:
        return
    assert out["overlap_fraction"] > g, \
        (f"overlap_fraction {out['overlap_fraction']} <= {g}: the "
         "wire is not hiding behind the backward pass")
    cg = out["compute_gate"]
    assert cg["met"] or cg["bound_note"] is not None, \
        (f"compute_overlap_fraction {cg['value']} <= {cg['threshold']} "
         f"on a {cg['host_cores']}-core host: the wire is not hiding "
         "behind the backward COMPUTATION (staging overlap alone cannot "
         "satisfy this gate)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="full mode on the CPU, the ranks as threads "
                         "(the reference's contract)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help="the per-layer pair's ring port (the fused "
                         f"pair's is {PAIR_PORT_GAP} above)")
    args = ap.parse_args(argv)

    if args.rank is not None:
        rec = rank_main(args.rank, args.port, "cpu" if args.cpu else "cuda")
        print("RANK " + json.dumps(rec), flush=True)
        return 0
    if LITE:
        out = lite_main(args.port)
        detail = {"device": "none", "ranks": "threads, numpy buffers"}
    elif args.cpu:
        out, detail = full_main(args.port)
    else:
        from rocnrdma_tpu_torch import resolve_device

        resolve_device("cuda")  # no card: raise before any OVERLAP line
        out, detail = full_main_procs(args.port)
    on_card = detail["device"] not in ("cpu", "none")
    g, timing = gate(out, LITE, on_card, detail)
    print("OVERLAP " + json.dumps(out), flush=True)
    print(f"device: {detail['device']} (ranks: {detail['ranks']})",
          flush=True)
    if not LITE:
        print("OVERLAP_DETAIL " + json.dumps(detail), flush=True)
    check(out, g, timing)
    print(f"overlap-smoke OK: mode={out['mode']} "
          f"overlap_fraction={out['overlap_fraction']} "
          f"compute_overlap_fraction={out['compute_overlap_fraction']} "
          f"wire_events={out['wire_events']} "
          f"timing_gates={'bound' if timing else 'reported'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
