#!/usr/bin/env python3
"""perf_smoke for the PyTorch port: the sharded-progress + fold-offload
hot path, end to end. The port's counterpart of ``tools/perf_smoke.py``,
the same drive over the port's own copies.

    python3 tools/torch_perf_smoke.py

A world-2 allreduce striped over TDR_RING_CHANNELS=4 QPs per neighbor,
forced onto the windowed-scratch schedule (TDR_NO_RECV_REDUCE=1) with
the SHARDED progress engine (TDR_PROGRESS_SHARDS=2 — forced, because
the 1-core CI class would otherwise auto-degrade to the legacy loop)
and fold workers on (TDR_FOLD_THREADS=2 — same 1-core rationale),
flight recorder on. Asserts:

  - the result is bitwise correct (exact-in-f32 inputs);
  - the generic schedule actually ran (last_schedule == GENERIC) over
    4 channels;
  - the progress shards demonstrably carried the completions
    (per-shard progress.* counters nonzero);
  - the fold pool executed jobs and its occupancy over the timed
    window exceeded 0.5 — folds genuinely overlapped the wire instead
    of serializing behind the poll loop (the BENCH_r06 0.0 defect);
  - recorded telemetry contains per-channel qp lanes for the chunks
    plus shard-thread lanes.

Numpy-only: it touches no device and takes no device argument. Under
the sanitized build (``tests/test_torch_sanitize.py``) the same drive
sweeps the sharded posting paths, the per-channel locks, the fold
workers and the scratch-window recycling for memory errors and UB.

Prints the reference's ``perf-smoke OK: ...`` line; exits non-zero on
any failed gate.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

os.environ.setdefault("TDR_RING_CHANNELS", "4")
# Default (4 MiB) ring chunks: MB-scale fold jobs keep the fold workers
# saturated while the wire lands successors.
os.environ["TDR_NO_RECV_REDUCE"] = "1"  # windowed scratch → fold pool
# Force the sharded engine + fold workers: both default OFF on 1-core
# hosts, but this smoke's job is to drive the machinery.
os.environ.setdefault("TDR_PROGRESS_SHARDS", "2")
os.environ.setdefault("TDR_FOLD_THREADS", "2")

import numpy as np  # noqa: E402

from rocnrdma_tpu_torch import telemetry  # noqa: E402
from rocnrdma_tpu_torch.collectives.world import local_worlds  # noqa: E402
from rocnrdma_tpu_torch.transport.engine import (  # noqa: E402
    SCHED_GENERIC, fold_pool_workers, native_counters)

OCCUPANCY_GATE = 0.5


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def perf_smoke(port: int | None = None) -> dict:
    """The drive, with every gate but the fold occupancy asserted
    (``main`` holds that one: it is a timing gate). Returns the
    counters the record line prints."""
    telemetry.enable()
    # Big enough that the striped steady state dominates bootstrap and
    # scratch warm-up.
    count = (64 << 20) // 4
    worlds = local_worlds(2, free_port() if port is None else port)
    try:
        def inputs():
            return [(np.arange(count, dtype=np.float32) % 977) * (r + 1)
                    for r in range(2)]

        bufs = inputs()
        expect = (np.arange(count, dtype=np.float32) % 977) * 3

        def run_all():
            ts = [threading.Thread(target=worlds[r].allreduce,
                                   args=(bufs[r],)) for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()

        run_all()  # warmup: registers MRs, sizes the scratch window
        bufs = inputs()
        # Occupancy is measured over the steady-state allreduce wall
        # time only — bootstrap must not dilute the busy/wall ratio.
        c_before = native_counters()
        t0 = time.perf_counter()
        run_all()
        wall = time.perf_counter() - t0
        for r in range(2):
            assert bufs[r].tobytes() == expect.tobytes(), \
                f"rank {r}: allreduce result diverged"
        assert worlds[0].ring.last_schedule == SCHED_GENERIC, \
            "windowed (generic) schedule did not run"
        assert worlds[0].ring.channels == 4
    finally:
        for w in worlds:
            w.close()

    workers = fold_pool_workers()
    c_after = native_counters()
    jobs = c_after["fold.jobs"] - c_before["fold.jobs"]
    busy_s = (c_after["fold.busy_us"] - c_before["fold.busy_us"]) / 1e6
    shards = c_after["progress.shards"] - c_before["progress.shards"]
    prog_wc = c_after["progress.wc"] - c_before["progress.wc"]
    assert workers > 0, "fold workers were forced on but the pool is empty"
    assert jobs > 0, "fold pool has workers but executed no jobs"
    assert shards > 0, \
        "sharded progress engine was forced on but launched no shards"
    assert prog_wc > 0, \
        "progress shards launched but consumed no completions"
    events = telemetry.drain()
    chunk_qps = {e.qp for e in events
                 if e.name in ("post_recv", "wc") and e.qp}
    assert len(chunk_qps) >= 4, \
        f"expected chunk events on >=4 qp lanes, saw {len(chunk_qps)}"
    shard_lanes = {e.qp for e in events if e.name == "shard"}
    assert shard_lanes, "no shard-thread lanes in the recording"
    telemetry.disable()
    return {"channels": 4, "shards": shards, "shard_wc": prog_wc,
            "fold_workers": workers, "fold_jobs": jobs,
            "occupancy": busy_s / wall, "qp_lanes": len(chunk_qps),
            "shard_lanes": len(shard_lanes), "busy_s": busy_s,
            "wall_s": wall}


def main() -> int:
    rec = perf_smoke()
    occupancy = rec["occupancy"]
    assert occupancy > OCCUPANCY_GATE, \
        (f"fold-offload occupancy {occupancy:.3f} <= {OCCUPANCY_GATE} — "
         f"folds are serializing behind the wire again (busy "
         f"{rec['busy_s']:.3f}s over {rec['wall_s']:.3f}s)")
    print(f"perf-smoke OK: channels={rec['channels']} windowed allreduce "
          f"bitwise-correct, shards={rec['shards']} "
          f"shard_wc={rec['shard_wc']} fold_workers={rec['fold_workers']} "
          f"fold_jobs={rec['fold_jobs']} occupancy={occupancy:.3f} "
          f"qp_lanes={rec['qp_lanes']} shard_lanes={rec['shard_lanes']}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
