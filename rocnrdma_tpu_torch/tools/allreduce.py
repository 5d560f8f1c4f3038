"""tdr_allreduce — ring-collective bus bandwidth over the transport,
with CPU torch tensors as buffers: the port's counterpart of
``rocnrdma_tpu/tools/allreduce.py``, with the same flags and the same
``--json`` record.

All ranks in one process (threads):

    python -m rocnrdma_tpu_torch.tools.allreduce --world 2 --bytes 1G

One process per rank (run each, same order of --peers; on one host
leave --peers out):

    python -m rocnrdma_tpu_torch.tools.allreduce --rank 0 --world 2 \\
        --peers hostA,hostB --bytes 1G --iters 5

Each rank also writes its link tier to standard error ("link tier:
cma" on the emu engine's cross-memory-attach tier).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import List

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64,
          "bfloat16": torch.bfloat16}


def parse_sizes(spec: str) -> List[int]:
    """"4:1G" → powers of two from 4 B to 1 GiB inclusive (the port's
    copy of ``rocnrdma_tpu/tools/perf.py``'s)."""
    def one(s: str) -> int:
        s = s.strip().upper()
        mult = 1
        for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
            if s.endswith(suffix):
                mult = m
                s = s[:-1]
        return int(s) * mult

    if ":" in spec:
        lo, hi = (one(p) for p in spec.split(":"))
        sizes = []
        n = lo
        while n <= hi:
            sizes.append(n)
            n *= 2
        return sizes
    return [one(spec)]


def run_rank(world_obj, count: int, dtype, iters: int, barrier=None,
             op: str = "allreduce"):
    buf = torch.ones(count, dtype=dtype)
    world_obj.ring.register_buffer(buf)
    coll = {
        "allreduce": lambda: world_obj.allreduce(buf),
        "reduce_scatter": lambda: world_obj.reduce_scatter(buf),
        "all_gather": lambda: world_obj.all_gather(buf),
        "broadcast": lambda: world_obj.broadcast(buf, root=0),
        "reduce": lambda: world_obj.reduce(buf, root=0),
        "alltoall": lambda: world_obj.all_to_all(buf),
    }[op]
    coll()  # warmup (+ peers' MR setup)
    if barrier is not None:
        barrier.wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        coll()
    dt = (time.perf_counter() - t0) / iters
    world_obj.ring.unregister_buffer(buf)
    return dt


def run_threads(worlds, count: int, dtype, iters: int,
                op: str = "allreduce") -> float:
    """``run_rank`` on one thread per world of this process, the timed
    loops started together: the slowest rank's seconds per op. A rank
    that fails breaks the start barrier for the others, and its error
    is raised here once every thread has ended."""
    barrier = threading.Barrier(len(worlds))
    out = [0.0] * len(worlds)
    errs = []

    def go(r):
        try:
            out[r] = run_rank(worlds[r], count, dtype, iters, barrier, op)
        except BaseException as e:  # raised below
            errs.append(e)
            barrier.abort()

    ts = [threading.Thread(target=go, args=(r,), daemon=True)
          for r in range(len(worlds))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return max(out)


# Useful bytes crossing each rank's link per op, as a fraction of the
# buffer (standard bus-bandwidth conventions).
def bus_fraction(op: str, world: int) -> float:
    if op == "allreduce":
        return 2.0 * (world - 1) / world
    if op in ("reduce_scatter", "all_gather"):
        return float(world - 1) / world
    if op in ("broadcast", "reduce"):
        return 1.0  # the whole buffer crosses each link
    if op == "alltoall":
        # Bundle-shrink ring schedule: w(w-1)/2 segments of size
        # buf/w cross each link -> (w-1)/2 of the buffer.
        return (world - 1) / 2.0
    raise ValueError(f"no bus convention for op {op!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tdr_allreduce", description=__doc__)
    ap.add_argument("--rank", type=int, default=None,
                    help="this host's rank; omit for in-process demo")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--peers", default=None,
                    help="comma-separated rank hosts (default localhost)")
    ap.add_argument("--port", type=int, default=18700)
    ap.add_argument("--bytes", default="1G")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--op", default="allreduce",
                    choices=["allreduce", "alltoall", "reduce_scatter",
                             "all_gather", "broadcast", "reduce"])
    ap.add_argument("--engine", default=None)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from rocnrdma_tpu_torch.collectives.world import RingWorld, local_worlds
    from rocnrdma_tpu_torch.transport.engine import Engine

    dtype = DTYPES[args.dtype]
    itemsize = torch.empty((), dtype=dtype).element_size()
    sizes = parse_sizes(args.bytes)
    if len(sizes) != 1:
        ap.error("--bytes takes a single size here (e.g. 1G)")
    count = max(1, sizes[0] // itemsize)
    spec = args.engine or os.environ.get("TDR_ENGINE", "auto")
    world = args.world
    if args.op == "alltoall":
        # Equal-segment semantics: round down to a world multiple.
        count = max(world, count - count % world)

    if args.rank is None:
        worlds = local_worlds(world, args.port, spec)
        print(f"link tier: {worlds[0].link_tier}", file=sys.stderr)
        try:
            dt = run_threads(worlds, count, dtype, args.iters, args.op)
        finally:
            for w in worlds:
                w.close()
    else:
        peers = args.peers.split(",") if args.peers else None
        w = RingWorld(Engine(spec), args.rank, world, args.port,
                      peers=peers)
        print(f"link tier: {w.link_tier}", file=sys.stderr)
        dt = run_rank(w, count, dtype, args.iters, op=args.op)
        if args.op in ("broadcast", "reduce"):
            # Root-asymmetric ops: time the collective end to end
            # between barriers (per-rank clocks legitimately differ).
            w.barrier()
            t0 = time.perf_counter()
            run_rank(w, count, dtype, args.iters, op=args.op)
            w.barrier()
            dt = (time.perf_counter() - t0) / args.iters
        w.close()

    payload = count * itemsize
    bus = payload * bus_fraction(args.op, world) / dt / 1e9
    result = {"op": args.op, "world": world, "bytes": payload,
              "dtype": args.dtype, "iters": args.iters,
              "sec_per_op": round(dt, 4), "bus_GBps": round(bus, 3)}
    if args.json:
        print(json.dumps(result))
    else:
        print(f"{args.op} {payload} B x{world} ranks: {dt*1e3:.1f} ms/op, "
              f"bus {bus:.2f} GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
