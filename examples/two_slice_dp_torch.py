#!/usr/bin/env python
"""Two-slice data-parallel Llama training over the RDMA transport, in
PyTorch — the counterpart of ``examples/two_slice_dp.py``.

Each process is one "slice": a ``Trainer`` on one device, or with
``--mesh "dp=…,tp=…"`` on an intra-slice dp × tp mesh over ``--devices``
(BASELINE config 4), whose gradients are averaged ACROSS slices by a
ring allreduce over this framework's transport
(``CrossSliceAllReduce(mean=True)`` over a ``RingWorld``). A meshed
slice hands the sync the whole gradient of each leaf, so the wire is
the single-device slice's. CUDA gradients take the shim's staged path:
the ring folds on the host CPU, so they are copied into pinned host
memory, reduced there and copied back.

Hardware-free (two processes on one machine, llama-tiny on the CPU):

    python examples/two_slice_dp_torch.py --cpu --steps 5

Both slices on one card (each process a rank; they time-slice it):

    python examples/two_slice_dp_torch.py --config llama3-1b --remat \\
        --batch 2 --seq 2048 --steps 4 --engine emu --one-batch

Each slice a dp × tp mesh (``--devices`` defaults to every visible card;
a list may name one device more than once, so two tp positions can
share the one card, or the CPU):

    python examples/two_slice_dp_torch.py --cpu --mesh dp=1,tp=2 \\
        --devices cpu,cpu --steps 3

As real multi-host slices (one process per host):

    # host A                                  # host B
    python examples/two_slice_dp_torch.py \\
        --rank 0 --world 2 --peers hostA,hostB ...   ... --rank 1 ...

``--overlap`` and ``--per-layer`` pass straight to the
``CrossSliceAllReduce`` arguments of the same names (the bucketed
start/finish sync; the per-layer sync pushed from the backward); the
wire dtype comes from ``TDR_WIRE_DTYPE``. With ``TDR_TELEMETRY=1`` the
flight recorder is drained after every step, and each step's line (and
the last line, over the steps after the first) also carries the
recorder's overlap fractions, its dropped count and the ring's time
split by native event (``telemetry.ring_phase_split``; ``fold_busy_ms``
from the ``fold.busy_us`` counter).

Under a coordinator and elastic (``--controller`` instead of
``--port``; start the coordinator first with ``python -m
rocnrdma_tpu_torch.tools.rendezvous --port P``):

    python examples/two_slice_dp_torch.py --cpu --steps 4 \
        --controller 127.0.0.1:P --elastic-dir /tmp/ck

``--mesh``, ``--per-layer`` and ``--elastic-dir`` combine: a meshed
slice pushes whole leaves layer by layer and checkpoints whole leaves,
the file a one-device slice writes.

``--controller HOST:PORT`` arbitrates the ranks' rendezvous and every
rebuild there (``RingWorld(controller=...)``: the coordinator hands out
the ports and the generation). ``--elastic-dir DIR`` arms
``ElasticPolicy(DIR/rank<r>, save_every=1)``: every step is
checkpointed, a rank that loses its peer mid-step rebuilds the world,
restores and re-runs the step, and a rank that starts where its
checkpoint exists restores it first (printing ``RESTORED <rank>
<step>``) and trains on from that step, drawing its batches as the
uninterrupted run did. The rebuild budget (30 attempts, each parked up
to 60 s at the rendezvous) covers a restarted llama3-1b rank's start-up
and restore; a rank's first rendezvous under ``--controller`` has the
same budget, so a restarted rank outwaits a survivor whose failed step
raises only at the ring's timeout.

Without ``--rank`` the script starts one subprocess per rank (CUDA
cannot be forked once initialised) and exits non-zero if any fails.
Every rank starts from ``init_params(seed=0)`` and draws its data
shard from ``default_rng(1234 + rank)``: a new batch each step, or with
``--one-batch`` one batch trained on every step, as the single-card
training path does. A batch is (batch, seq + 1) token ids, so the model
runs at ``seq`` positions. Each rank prints one
JSON line per step — loss, step ms, the grads / sync / apply ms, the
staged gather / ring / scatter ms, staged bytes, each kernel's launches
and a sha256 of its parameters' bytes — after a first line with the
digest of the initial parameters, and a last line with the final digest
and peak device memory. With ``--elastic-dir`` a step's line also
carries its checkpoint's bytes and save ms (and the device-to-host copy
and the file write in it), the finite check's ms, the resumes it took
and, for each, the rebuild and restore ms and the ``time.monotonic()``
at which the resume began; the first line carries the restored step,
the restore ms (the file read and the host-to-device copy in it) and
the ``time.monotonic()`` readings at which the world was up and the
rank ready, and the rendezvous attempts the world took; the last line
the world's generation and the trainer's resume and rebuild counts.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def params_digest(trainer) -> str:
    """sha256 over every (whole) parameter's bytes, in state-dict
    order."""
    import torch

    h = hashlib.sha256()
    for p in trainer.state_dict().values():
        h.update(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def step_telemetry(telemetry, eng, mark: dict) -> dict:
    """Drain the recorder after a step: the step's overlap fractions,
    the ring's split by native event, and the deltas of the dropped
    and fold-busy counters since ``mark`` (updated in place)."""
    dropped = int(eng.telemetry_dropped())
    fold_us = int(telemetry.counters().get("fold.busy_us", 0))
    events = telemetry.timeline()
    ov = telemetry.overlap_fraction(events,
                                    dropped=dropped - mark["dropped"])
    split = telemetry.ring_phase_split(events)
    out = {"wire_events": ov["wire_events"],
           "wire_in_span": ov["wire_in_span"],
           "wire_in_compute": ov["wire_in_compute"],
           "overlap_fraction": ov["overlap_fraction"],
           "compute_overlap_fraction": ov["compute_overlap_fraction"],
           "telemetry_dropped": dropped - mark["dropped"],
           "ring_split_ms": {k: split[k] * 1e3
                             for k in telemetry.PHASES},
           "collectives": split["collectives"],
           "fold_busy_ms": (fold_us - mark["fold_us"]) / 1e3}
    mark.update(dropped=dropped, fold_us=fold_us)
    return out


def sum_telemetry(lines) -> dict:
    """The recorder's numbers over several steps' lines."""
    total = {k: sum(ln[k] for ln in lines) for k in (
        "wire_events", "wire_in_span", "wire_in_compute",
        "telemetry_dropped", "collectives", "fold_busy_ms")}
    n = total["wire_events"]
    return {**total,
            "overlap_fraction": total["wire_in_span"] / n if n else 0.0,
            "compute_overlap_fraction": (total["wire_in_compute"] / n
                                         if n else 0.0),
            "ring_split_ms": {k: sum(ln["ring_split_ms"][k] for ln in lines)
                              for k in lines[0]["ring_split_ms"]}}


# The rebuild budget of ``--elastic-dir`` and of a rank's first
# rendezvous under ``--controller``.
REBUILD = dict(max_attempts=30, backoff_s=0.5, backoff_cap_s=4.0,
               timeout_ms=60000)


def join_world(ring_world, engine, rank: int, world: int, peers,
               controller: str):
    """``RingWorld(controller=...)`` within the rebuild budget, and the
    attempts it took. A rank started again after its death joins at
    once, but a survivor parks only once its failed step has raised and
    its world is torn down, which can take longer than one rendezvous
    of ``timeout_ms``: a rank that gave up then would leave the
    survivor parked for a rank that is gone."""
    from rocnrdma_tpu_torch.transport.engine import TransportError

    delay = REBUILD["backoff_s"]
    for attempt in range(1, REBUILD["max_attempts"] + 1):
        try:
            return ring_world(engine, rank, world, peers=peers,
                              controller=controller,
                              world_name="two-slice-dp",
                              timeout_ms=REBUILD["timeout_ms"]), attempt
        except TransportError as e:
            if not e.retryable or attempt == REBUILD["max_attempts"]:
                raise
            print(f"rank {rank}: rendezvous attempt {attempt} failed "
                  f"({e}); retrying", file=sys.stderr, flush=True)
            time.sleep(delay)
            delay = min(2 * delay, REBUILD["backoff_cap_s"])


def run_slice(rank: int, args) -> int:
    import numpy as np
    import torch

    from rocnrdma_tpu_torch import telemetry
    from rocnrdma_tpu_torch.collectives.staging import staging
    from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.hbm.cuda import CUDAExporter
    from rocnrdma_tpu_torch.ops import _native
    from rocnrdma_tpu_torch.parallel.checkpoint import (checkpoint_file,
                                                        restore_checkpoint)
    from rocnrdma_tpu_torch.parallel.mesh import parse_mesh
    from rocnrdma_tpu_torch.parallel.trainer import ElasticPolicy, Trainer
    from rocnrdma_tpu_torch.transport import engine as eng
    from rocnrdma_tpu_torch.utils.trace import trace

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        torch.cuda.set_device(0)
    recording = os.environ.get("TDR_TELEMETRY", "0") not in ("", "0")
    if recording:
        # Before the engine: the collective ids ride the handshake.
        telemetry.reset()
    peers = args.peers.split(",") if args.peers else None
    if args.controller:
        world, attempts = join_world(RingWorld, eng.Engine(args.engine),
                                     rank, args.world, peers,
                                     args.controller)
    else:
        world = RingWorld(eng.Engine(args.engine), rank, args.world,
                          args.port, peers=peers)
        attempts = 1
    world_ready = time.monotonic()
    # CPU gradients are adopted and reduced in place (zero staged
    # bytes); CUDA gradients are staged through pinned host memory.
    sync = CrossSliceAllReduce(world, exporter=CUDAExporter(), mean=True,
                               overlap=args.overlap,
                               per_layer=args.per_layer)
    overrides = {"remat": True} if args.remat else {}
    elastic = None
    if args.elastic_dir:
        os.makedirs(args.elastic_dir, exist_ok=True)
        elastic = ElasticPolicy(
            os.path.join(args.elastic_dir, f"rank{rank}"), save_every=1,
            max_resumes=6, rebuild=dict(REBUILD))
    trainer = Trainer(args.config,
                      parse_mesh(args.mesh) if args.mesh else None,
                      cross_slice_sync=sync, seed=0, device=device,
                      devices=(args.devices.split(",") if args.devices
                               else None),
                      elastic=elastic, **overrides)
    cfg = trainer.cfg
    start, restore_ms = 0, None
    if elastic and os.path.exists(checkpoint_file(elastic.checkpoint_path)):
        t0 = time.perf_counter()
        start = restore_checkpoint(elastic.checkpoint_path, trainer)
        if device == "cuda":
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        print(f"RESTORED {rank} {start}", flush=True)
    rng = np.random.default_rng(1234 + rank)   # per-slice data shard

    def emit(obj):
        # One write per line: the ranks share the launcher's stdout.
        sys.stdout.write(json.dumps({"rank": rank, **obj}) + "\n")
        sys.stdout.flush()

    first = {}
    if restore_ms is not None:
        restored = trace.events("ckpt.restore")[-1][2]
        first = {"restored_step": start, "restore_ms": restore_ms,
                 "restore_read_ms": restored["read_s"] * 1e3,
                 "restore_h2d_ms": restored["h2d_s"] * 1e3}
    emit({"step": start, "digest": params_digest(trainer), **first,
          "world_ready_monotonic": world_ready,
          "rendezvous_attempts": attempts,
          "ready_monotonic": time.monotonic(),
          "config": cfg.name, "dtype": str(cfg.dtype).split(".")[-1],
          "remat": cfg.remat, "device": device, "engine": world.engine.name,
          "link_tier": world.link_tier, "overlap": sync.overlap,
          "per_layer": sync.per_layer, "wire": sync.wire_dtype,
          "mesh": getattr(getattr(trainer, "mesh", None), "shape", None),
          "batch": args.batch, "seq": args.seq})
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tokens = None
    mark = {"dropped": 0, "fold_us": 0}
    if recording:
        step_telemetry(telemetry, eng, mark)  # drop the bring-up window
    recorded = []
    for step in range(1, args.steps + 1):
        if tokens is None or not args.one_batch:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch, args.seq + 1)))
        if step <= start:
            continue  # restored past it; its batch was drawn all the same
        staged0 = staging.bytes
        resumes0 = len(trace.events("trainer.resume"))
        _native.reset_launches()
        t0 = time.perf_counter()
        loss = trainer.step(tokens)
        step_ms = (time.perf_counter() - t0) * 1e3
        line = {"step": step, "loss": loss, "step_ms": step_ms,
                **trainer.last_split,
                **{k.replace("_s", "_ms"): v * 1e3
                   for k, v in sync.last_split.items()},
                "staged_bytes": staging.bytes - staged0,
                "launches": _native.launches(),
                "digest": params_digest(trainer)}
        if elastic:
            resumed = trace.events("trainer.resume")[resumes0:]
            saved = trace.events("ckpt.save")[-1][2]
            line.update(
                resumes=len(resumed),
                resume_monotonic=[t for t, _name, _f in resumed],
                ckpt_bytes=os.path.getsize(
                    checkpoint_file(elastic.checkpoint_path)),
                ckpt_d2h_ms=saved["d2h_s"] * 1e3,
                ckpt_write_ms=saved["write_s"] * 1e3)
            if resumed:
                restored = trace.events("ckpt.restore")[-1][2]
                line.update(restore_read_ms=restored["read_s"] * 1e3,
                            restore_h2d_ms=restored["h2d_s"] * 1e3)
        if recording:
            line.update(step_telemetry(telemetry, eng, mark))
            if step > 1:
                recorded.append(line)
        emit(line)
    last = {"final_digest": params_digest(trainer),
            "generation": world.generation,
            "resume": trace.counter("trainer.resume"),
            "rebuild": trace.counter("world.rebuild"),
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if device == "cuda" else None)}
    if recorded:
        last["telemetry_timed_steps"] = sum_telemetry(recorded)
    emit(last)
    sync.close()
    world.close()
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rank", type=int, default=None,
                    help="slice rank; omit to start every rank locally")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--peers", default=None,
                    help="comma-separated slice hosts (default: localhost)")
    ap.add_argument("--port", type=int, default=28100)
    ap.add_argument("--controller", default=None, metavar="HOST:PORT",
                    help="rendezvous through this coordinator instead of "
                         "on --port")
    ap.add_argument("--elastic-dir", default=None, metavar="DIR",
                    help="ElasticPolicy(DIR/rank<r>, save_every=1): "
                         "checkpoint every step, resume after a peer's "
                         "death, restore at start-up")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--config", default="llama-tiny",
                    help="llama-tiny | llama3-1b | llama3-8b")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--one-batch", action="store_true",
                    help="draw one batch per rank and train on it every "
                         "step, so the loss falls within a few steps "
                         "(chip_smoke.py's path (d) checks that it does)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (plain PyTorch versions)")
    ap.add_argument("--mesh", default=None, metavar="dp=N,tp=M",
                    help="each slice an intra-slice dp x tp mesh")
    ap.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                    help="the mesh's torch devices, one per position "
                         "(default: every visible card)")
    ap.add_argument("--overlap", action="store_true",
                    help="CrossSliceAllReduce(overlap=True): the bucketed "
                         "start/finish sync")
    ap.add_argument("--per-layer", action="store_true",
                    help="CrossSliceAllReduce(per_layer=True): each layer's "
                         "bucket pushed from the backward")
    args = ap.parse_args()

    if args.rank is not None:
        return run_slice(args.rank, args)
    argv = sys.argv[1:]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r)] + argv)
             for r in range(args.world)]
    rc = next((c for c in [p.wait() for p in procs] if c), 0)
    if rc == 0:
        print("two-slice DP demo OK", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
