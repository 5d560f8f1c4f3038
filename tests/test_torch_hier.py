"""The port's two-tier hierarchical world (its copy of
``collectives/world.py`` + ``topology.py``) at world 8, over CPU
tensors, as ``tests/test_hier.py`` holds the JAX package's: eight ranks
emulating two hosts of four (explicit ``topology=``), the flat,
hierarchical and staged allreduces bitwise equal to the sum on
exactly-representable values, chained async hierarchical handles
bitwise the blocking flat result with every handle (the tiers'
included) settled, and the port's bucketed shim over the same world
bitwise its fused path.
"""

import numpy as np
import pytest
import torch

from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.transport.engine import TransportError

from test_hier import KEYS8, port_band
from test_torch_world import run_ranks


@pytest.fixture(scope="module")
def world8():
    last = None
    for _ in range(3):
        try:
            worlds = local_worlds(8, port_band(8 * 4 + 8), channels=1,
                                  topology=list(KEYS8))
            break
        except (TransportError, TimeoutError, OSError) as e:
            last = e
    else:
        raise last
    try:
        yield worlds
    finally:
        for w in worlds:
            w.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
def test_world8_hier_flat_staged_bitwise(world8, dtype):
    assert world8[0].topology is not None
    assert world8[0].topology.n_hosts == 2
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(-100, 100, (8, 4099))).to(dtype)
    expect = data.sum(dim=0).to(dtype)
    results = {}
    for algo in ("flat", "hier", "staged"):
        bufs = [data[r].clone() for r in range(8)]
        run_ranks(world8, lambda w, r: w.allreduce(bufs[r], algo=algo))
        assert all(torch.equal(b, expect) for b in bufs), algo
        results[algo] = bufs[0]
    assert torch.equal(results["hier"], results["flat"])
    assert torch.equal(results["staged"], results["flat"])


def test_world8_hier_async_chain_and_census(world8):
    rng = np.random.default_rng(5)
    data = torch.from_numpy(
        rng.integers(-50, 50, (8, 3, 2048)).astype(np.float32))
    flat = [[data[r, k].clone() for k in range(3)] for r in range(8)]
    for k in range(3):
        run_ranks(world8, lambda w, r: w.allreduce(flat[r][k], algo="flat"))
    hier = [[data[r, k].clone() for k in range(3)] for r in range(8)]

    def launch(w, r):
        for h in [w.allreduce_async(hier[r][k], algo="hier")
                  for k in range(3)]:
            h.wait()

    run_ranks(world8, launch)
    for r in range(8):
        for k in range(3):
            assert torch.equal(hier[r][k], flat[0][k])
    for w in world8:
        assert w.pending_async == 0
        for tier in (w._tier_intra, w._tier_inter):
            assert tier is not None and tier.pending_async == 0


def test_world8_bucketed_shim_bitwise_fused(world8):
    """Staged trees through the port's shim on the hierarchical world:
    the bucketed path (small buckets, async chains) is bitwise the
    fused one, and the mean of the exact sums by 8 is exact."""
    rng = np.random.default_rng(9)
    sizes = (4096, 77, 9000)
    data = [[torch.from_numpy(rng.integers(-64, 64, n).astype(np.float32))
             for n in sizes] for _ in range(8)]
    outs = {}
    for kw in ({}, {"overlap": True, "bucket_bytes": 8192}):
        shims = [CrossSliceAllReduce(w, mean=True, **kw) for w in world8]
        trees = [[t.clone() for t in data[r]] for r in range(8)]
        run_ranks(world8, lambda w, r: shims[r](trees[r]))
        for s in shims:
            s.close()
        outs[bool(kw)] = trees
    for i in range(len(sizes)):
        want = sum(data[r][i] for r in range(8)) / 8
        for r in range(8):
            assert torch.equal(outs[False][r][i], want)
            assert torch.equal(outs[True][r][i], want)
