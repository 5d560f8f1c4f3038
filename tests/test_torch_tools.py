"""The port's ``tools/allreduce.py`` against the JAX package's
``rocnrdma_tpu/tools/allreduce.py``: the same ``--json`` record keys at
world 2 in threads, a correct sum through ``run_rank``, the same bus
convention, the port's own ``parse_sizes`` equal to
``rocnrdma_tpu/tools/perf.py``'s, and a rank's failure in
``run_threads`` raised instead of left waiting at the start barrier.
"""

import json
import re
import threading

import pytest
import torch

from rocnrdma_tpu.tools import allreduce as ref_tool
from rocnrdma_tpu.tools.perf import parse_sizes as ref_parse_sizes
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.tools import allreduce as tool

from test_hier import port_band


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
