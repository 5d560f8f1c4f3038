"""The port's ``tools/allreduce.py`` against the JAX package's
``rocnrdma_tpu/tools/allreduce.py``: the same ``--json`` record keys at
world 2 in threads, a correct sum through ``run_rank``, the same bus
convention, the port's own ``parse_sizes`` equal to
``rocnrdma_tpu/tools/perf.py``'s, a rank's failure in ``run_threads``
raised instead of left waiting at the start barrier, and the tool as two
rank processes, with the flight recorder off and on.
"""

import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from rocnrdma_tpu.tools import allreduce as ref_tool
from rocnrdma_tpu.tools.perf import parse_sizes as ref_parse_sizes
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.tools import allreduce as tool

from test_hier import port_band

REPO = Path(__file__).resolve().parent.parent


def _record(main, argv, capsys):
    assert main(argv) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_json_record_has_the_reference_keys(dtype, capsys):
    argv = ["--world", "2", "--bytes", "64K", "--iters", "2", "--dtype",
            dtype, "--engine", "emu", "--json"]
    got, err = _record(tool.main, argv + ["--port", str(port_band(8))],
                       capsys)
    want, _ = _record(ref_tool.main, argv + ["--port", str(port_band(8))],
                      capsys)
    assert sorted(got) == sorted(want)
    assert re.search(r"^link tier: (cma|stream)$", err, re.M), err
    for key in ("op", "world", "bytes", "dtype", "iters"):
        assert got[key] == want[key], key
    assert got["bytes"] == 64 << 10 and got["bus_GBps"] > 0


def test_run_rank_sums_and_bus_convention():
    class Spy:
        """Delegates to a world and keeps the buffer it reduced."""

        def __init__(self, world):
            self.world, self.ring = world, world.ring

        def allreduce(self, buf):
            self.buf = buf
            self.world.allreduce(buf)

    worlds = local_worlds(2, port_band(8), "emu")
    spies = [Spy(w) for w in worlds]
    barrier = threading.Barrier(2)
    ts = [threading.Thread(target=tool.run_rank,
                           args=(spies[r], 4099, torch.bfloat16, 3,
                                 barrier)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    for w in worlds:
        w.close()
    # Ones, reduced by 2 ranks 1 + 3 times: 2^4 (exact in bf16).
    for s in spies:
        assert torch.equal(s.buf, torch.full((4099,), 16.0,
                                             dtype=torch.bfloat16))
    for op in ("allreduce", "reduce_scatter", "all_gather", "broadcast",
               "reduce", "alltoall"):
        for world in (2, 3, 8):
            assert tool.bus_fraction(op, world) == \
                ref_tool.bus_fraction(op, world)


def test_parse_sizes_is_the_references():
    for spec in ("4:1G", "1G", "64K", "4M:64M", "3", "512k"):
        assert tool.parse_sizes(spec) == ref_parse_sizes(spec)


def test_run_threads_raises_a_rank_failure():
    """Rank 1 fails once its warmup collective is done, while rank 0
    waits at the start barrier: the barrier breaks and rank 1's error
    comes out of ``run_threads``."""
    class FailAfterWarmup:
        def __init__(self, world):
            self.world, self.ring = world, world.ring

        def allreduce(self, buf):
            self.world.allreduce(buf)
            raise RuntimeError("rank 1 failed")

    worlds = local_worlds(2, port_band(8), "emu")
    outcome = []

    def drive():
        try:
            tool.run_threads([worlds[0], FailAfterWarmup(worlds[1])], 4099,
                             torch.bfloat16, 3)
        except BaseException as e:
            outcome.append(e)

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    t.join(timeout=120)
    hung = t.is_alive()
    for w in worlds:
        w.close()
    assert not hung
    assert len(outcome) == 1 and str(outcome[0]) == "rank 1 failed", outcome


@pytest.mark.parametrize("telemetry", [None, "1"])
def test_two_rank_processes(telemetry):
    """The tool at world 2 as one process per rank, 4 MiB of bf16 over
    the emu engine (the ranks' link negotiates as the two-process
    training paths' does), ``TDR_TELEMETRY`` unset and set: each rank
    exits 0, reports its link tier once and a positive bus rate."""
    env = {k: v for k, v in os.environ.items() if k != "TDR_TELEMETRY"}
    if telemetry is not None:
        env["TDR_TELEMETRY"] = telemetry
    cmd = [sys.executable, "-m", "rocnrdma_tpu_torch.tools.allreduce",
           "--world", "2", "--port", str(port_band(8)), "--engine", "emu",
           "--bytes", "4M", "--dtype", "bfloat16", "--iters", "3", "--json"]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-2000:])
        tiers = [ln for ln in err.splitlines() if ln.startswith("link tier:")]
        assert len(tiers) == 1, (r, err[-2000:])
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["bytes"] == 4 << 20 and rec["bus_GBps"] > 0, (r, rec)
