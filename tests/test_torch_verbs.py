"""The port's ``verbs`` engine hardware-free, over the in-process mock
libibverbs provider its own native Makefile builds
(``rocnrdma_tpu_torch/native``, target ``mock``), as
``tests/test_verbs_fused.py`` holds the JAX package's: rings of CPU
tensors select the fused schedules the reference selects (FusedTwo with
foldback at world 2, the wavefront at 3), bf16 sums agree bitwise
across ranks, and the port's shim over a verbs world defers the
bucketed path to the fused one (per-step MR teardown cannot outlive an
async handle) with the same result.
"""

import fcntl
import os
import subprocess

import pytest
import torch

from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.transport import engine as eng

from test_hier import port_band
from test_torch_world import run_ranks

_NATIVE = os.path.dirname(eng._LIB_PATH)


@pytest.fixture(scope="module", autouse=True)
def mock_verbs():
    eng._load()   # libtdr first, as every engine use builds it
    with open(eng._BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-s", "-C", _NATIVE, "mock",
                            "TUNE=native"], check=True,
                           capture_output=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    old = os.environ.get("TDR_VERBS_LIB")
    os.environ["TDR_VERBS_LIB"] = os.path.join(_NATIVE,
                                               "libmockibverbs.so")
    yield
    if old is None:
        os.environ.pop("TDR_VERBS_LIB", None)
    else:
        os.environ["TDR_VERBS_LIB"] = old


@pytest.mark.parametrize("world,sched", [(2, "SCHED_FUSED2_FB"),
                                         (3, "SCHED_WAVEFRONT")])
def test_mock_verbs_ring_schedules_and_sums(world, sched):
    worlds = local_worlds(world, port_band(8), spec="verbs:mock0")
    try:
        assert worlds[0].engine.name == "mock0"
        bufs = [torch.full((1 << 16,), float(r + 1)) for r in range(world)]
        run_ranks(worlds, lambda w, r: w.allreduce(bufs[r]))
        want = torch.full((1 << 16,), float(sum(range(1, world + 1))))
        assert all(torch.equal(b, want) for b in bufs)
        assert [w.ring.last_schedule for w in worlds] == \
            [getattr(eng, sched)] * world
    finally:
        for w in worlds:
            w.close()


def test_mock_verbs_bf16_bitwise_across_ranks():
    worlds = local_worlds(2, port_band(8), spec="verbs:mock0")
    g = torch.Generator().manual_seed(7)
    f32 = [torch.randn(4096, generator=g) for _ in range(2)]
    bufs = [x.to(torch.bfloat16) for x in f32]
    want = bufs[0] + bufs[1]
    try:
        run_ranks(worlds, lambda w, r: w.allreduce(bufs[r]))
    finally:
        for w in worlds:
            w.close()
    assert torch.equal(bufs[0], bufs[1])
    assert torch.equal(bufs[0], want)


def test_shim_on_verbs_defers_overlap_to_the_fused_path():
    worlds = local_worlds(2, port_band(8), spec="verbs:mock0")
    out = {}
    try:
        for kw in ({}, {"overlap": True, "bucket_bytes": 4096}):
            shims = [CrossSliceAllReduce(w, mean=True, **kw)
                     for w in worlds]
            trees = [[torch.arange(3000, dtype=torch.float32) * (r + 1),
                      torch.full((77,), 2.0 * (r + 1))] for r in range(2)]
            run_ranks(worlds, lambda w, r: shims[r](trees[r]))
            assert [w.pending_async for w in worlds] == [0, 0]
            for s in shims:
                s.close()
            out[bool(kw)] = trees
    finally:
        for w in worlds:
            w.close()
    for r in range(2):
        for a, b in zip(out[False][r], out[True][r]):
            assert torch.equal(a, b)
    assert torch.equal(out[True][0][0],
                       torch.arange(3000, dtype=torch.float32) * 1.5)
