"""tdr_perf — the perftest (`ib_write_bw` / `ib_read_bw`) analogue: the
port's counterpart of ``rocnrdma_tpu/tools/perf.py``, with the same
flags and the same ``--json`` record, over the port's transport and pin
registry. Buffers are CPU torch tensors.

IB Verbs traffic is measured end to end with Mellanox perftest
(SURVEY.md §4 "implied external tests"); BASELINE.json configs 0-2
adopt it. This tool reproduces that workflow over the framework engine,
so the same sweep runs on a NIC-less host (emu backend), over SoftRoCE,
or on real HCAs (verbs backend).

Usage:
  server:  python -m rocnrdma_tpu_torch.tools.perf --listen --port 18515
  client:  python -m rocnrdma_tpu_torch.tools.perf --host 1.2.3.4 \
               --port 18515 --op write --sizes 4:1G --iters 16
  loopback (both ends in one process, the config-0 control):
  python -m rocnrdma_tpu_torch.tools.perf --loopback --op write

Memory source: --hbm fake pins the buffer through the HBM registration
manager (FakeHBMExporter + dma-buf path) instead of plain malloc'd
host memory, exercising the full §3.2 registration stack under the
sweep. There is no device-memory source: the ring and the one-sided
verbs reach HBM only through a dma-buf MR (``hbm.cuda.CUDAExporter``),
which needs a host that exports one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import List

import numpy as np
import torch


def parse_sizes(spec: str) -> List[int]:
    """"4:1G" → powers of two from 4 B to 1 GiB inclusive."""
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


def _mr_for(engine, nbytes: int, hbm: str):
    """Buffer + MR via the requested memory source."""
    if hbm == "fake":
        from rocnrdma_tpu_torch.hbm.registry import (
            FakeHBMExporter, RegistrationManager, as_ndarray)

        exporter = FakeHBMExporter()
        mgr = RegistrationManager(engine, exporter)
        va = exporter.alloc(nbytes)
        reg = mgr.register(va, nbytes)
        as_ndarray(va, (nbytes,), np.uint8)[:] = 0xA5
        return reg.mr, (mgr, reg)
    # Fill with a real pattern (as ib_write_bw does): an all-zeros
    # numpy buffer is COW-backed by the kernel ZERO PAGE — every
    # source page aliases one cached 4 KiB page, reads cost nothing,
    # and the "bandwidth" reported is write-only traffic, ~2x the
    # honest read+write number.
    buf = torch.full((nbytes,), 0xA5, dtype=torch.uint8)
    return engine.reg_mr(buf), buf  # keep buf alive


def run_peer(engine, qp, sizes: List[int], op: str, iters: int,
             is_client: bool, hbm: str, out=None, qd: int = 16,
             lat: bool = False):
    # The per-size lines go to the caller's stdout at call time (a
    # redirected one included), the JSON summary after them.
    out = out or sys.stdout
    max_size = max(sizes)
    mr, keep = _mr_for(engine, max_size, hbm)

    # Exchange MR info over the data QP via SEND/RECV (the role
    # perftest's TCP side-channel plays).
    info = torch.tensor([mr.addr, mr.rkey], dtype=torch.int64)
    inbox = torch.zeros(2, dtype=torch.int64)
    with engine.reg_mr(info) as imr, engine.reg_mr(inbox) as rmr:
        qp.post_recv(rmr, 0, 16, wr_id=1)
        qp.post_send(imr, 0, 16, wr_id=2)
        deadline = time.monotonic() + 60
        got = {}
        while len(got) < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("tdr_perf: MR-info exchange timed out")
            for c in qp.poll(2, timeout_ms=30000):
                if not c.ok:
                    raise RuntimeError(
                        f"tdr_perf: MR-info exchange failed (status {c.status})")
                got[c.wr_id] = c
        raddr, rkey = int(inbox[0]), int(inbox[1])

    results = []
    if is_client:
        post = qp.post_write if op == "write" else qp.post_read
        for size in sizes:
            post(mr, 0, raddr, rkey, size, wr_id=0)  # warmup
            assert qp.wait(0, timeout_ms=120000).ok
            if lat:
                # ib_write_lat analogue: strictly serial post→completion
                # round trips, distribution reported like perftest's
                # t_min / t_typical / t_max (plus p99).
                times = np.empty(iters)
                for i in range(iters):
                    t1 = time.perf_counter()
                    post(mr, 0, raddr, rkey, size, wr_id=i + 1)
                    assert qp.wait(i + 1, timeout_ms=120000).ok
                    times[i] = time.perf_counter() - t1
                times *= 1e6
                rec = {"bytes": size,
                       "lat_us_min": round(float(times.min()), 2),
                       "lat_us_p50": round(float(np.percentile(times, 50)), 2),
                       "lat_us_p99": round(float(np.percentile(times, 99)), 2),
                       "lat_us_max": round(float(times.max()), 2)}
                results.append(rec)
                print(f"{size:>12}  min {rec['lat_us_min']:>9.2f}  "
                      f"p50 {rec['lat_us_p50']:>9.2f}  "
                      f"p99 {rec['lat_us_p99']:>9.2f}  "
                      f"max {rec['lat_us_max']:>9.2f} us",
                      file=out, flush=True)
                continue
            # ib_write_bw analogue: keep up to ``qd`` writes in flight
            # (perftest's tx-depth); a serial post→wait loop measures
            # latency, not bandwidth, for small messages.
            depth = max(1, min(qd, iters))
            inflight = set()
            nexti = 0
            completed = 0
            t0 = time.perf_counter()
            while completed < iters:
                while nexti < iters and len(inflight) < depth:
                    post(mr, 0, raddr, rkey, size, wr_id=nexti + 1)
                    inflight.add(nexti + 1)
                    nexti += 1
                wcs = qp.poll(16, timeout_ms=120000)
                if not wcs:
                    raise RuntimeError(
                        "tdr_perf: completion timeout at "
                        f"{completed}/{iters} (size {size})")
                for c in wcs:
                    assert c.ok, f"wr {c.wr_id} status {c.status}"
                    inflight.discard(c.wr_id)
                    completed += 1
            dt = time.perf_counter() - t0
            bw = size * iters / dt / 1e9
            lat_us = dt / iters * 1e6
            results.append({"bytes": size, "GBps": round(bw, 4),
                            "lat_us": round(lat_us, 2)})
            print(f"{size:>12}  {bw:10.3f} GB/s  {lat_us:10.2f} us",
                  file=out, flush=True)
        # Tell the server we're done.
        done = torch.zeros(1, dtype=torch.uint8)
        with engine.reg_mr(done) as dmr_:
            qp.post_send(dmr_, 0, 1, wr_id=99)
            qp.wait(99, timeout_ms=30000)
    else:
        # Server: passive for one-sided traffic; wait for the client's
        # done marker (zero software on the data path, SURVEY.md §3.3).
        done = torch.zeros(1, dtype=torch.uint8)
        with engine.reg_mr(done) as dmr_:
            qp.post_recv(dmr_, 0, 1, wr_id=99)
            qp.wait(99, timeout_ms=600000)
    if hbm == "fake":
        mgr, reg = keep
        mgr.deregister(reg)
    else:
        mr.deregister()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tdr_perf", description=__doc__)
    ap.add_argument("--listen", action="store_true")
    ap.add_argument("--loopback", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--bind", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=18515)
    ap.add_argument("--op", choices=["write", "read"], default="write")
    ap.add_argument("--sizes", default="4:1G")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--qd", type=int, default=16,
                    help="outstanding writes in bw mode (perftest tx-depth)")
    ap.add_argument("--lat", action="store_true",
                    help="ib_write_lat mode: serial round trips, "
                         "min/p50/p99/max percentiles")
    ap.add_argument("--engine", default=None,
                    help="emu | verbs[:dev] | auto (default: TDR_ENGINE)")
    ap.add_argument("--hbm", choices=["host", "fake"], default="host",
                    help="register plain host memory or fake-HBM pins")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON summary line at the end")
    ap.add_argument("--telemetry", action="store_true",
                    help="record the run in the native flight recorder "
                         "and add log2-histogram latency percentiles "
                         "to the JSON summary")
    args = ap.parse_args(argv)

    from rocnrdma_tpu_torch.transport.engine import Engine

    if args.telemetry:
        from rocnrdma_tpu_torch import telemetry

        telemetry.enable()

    spec = args.engine or os.environ.get("TDR_ENGINE", "auto")
    sizes = parse_sizes(args.sizes)

    if args.loopback:
        e = Engine(spec)
        srv_qp = [None]

        def serve():
            srv_qp[0] = e.listen("127.0.0.1", args.port)

        t = threading.Thread(target=serve)
        t.start()
        cli = e.connect("127.0.0.1", args.port)
        t.join()
        st = threading.Thread(
            target=run_peer,
            args=(e, srv_qp[0], sizes, args.op, args.iters, False,
                  args.hbm),
            kwargs={"qd": args.qd, "lat": args.lat})
        st.start()
        results = run_peer(e, cli, sizes, args.op, args.iters, True,
                           args.hbm, qd=args.qd, lat=args.lat)
        st.join()
        srv_qp[0].close(); cli.close(); e.close()
    elif args.listen:
        e = Engine(spec)
        qp = e.listen(args.bind, args.port)
        results = run_peer(e, qp, sizes, args.op, args.iters, False,
                           args.hbm, qd=args.qd, lat=args.lat)
        qp.close(); e.close()
    else:
        e = Engine(spec)
        qp = e.connect(args.host, args.port, timeout_ms=60000)
        results = run_peer(e, qp, sizes, args.op, args.iters, True,
                           args.hbm, qd=args.qd, lat=args.lat)
        qp.close(); e.close()

    if args.json and results:
        summary = {"op": args.op, "sweep": results}
        if args.lat:
            summary["min_lat_us"] = min(r["lat_us_min"] for r in results)
        else:
            summary["peak_GBps"] = max(r["GBps"] for r in results)
        if args.telemetry:
            from rocnrdma_tpu_torch import telemetry

            snap = telemetry.snapshot()
            summary["telemetry"] = {
                "events_recorded": snap["recorded"],
                "events_dropped": snap["dropped"],
                # Per-op post→completion latency from the native log2
                # histogram (upper-edge estimates) — the engine-side
                # view the wall-clock sweep above cannot see.
                "chunk_lat_us": snap["percentiles"]["chunk_lat_us"],
                "chunk_bytes": snap["percentiles"]["chunk_bytes"],
            }
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
