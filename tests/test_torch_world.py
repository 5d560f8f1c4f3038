"""The PyTorch port's RingWorld over CPU tensors (in-process ranks, one
thread each, emu engine) against the sums, as ``tests/test_collectives.py``
holds the JAX package's.

Tolerances: at world 2 every element is one addition, so the result is
bitwise torch's own ``a + b`` in the dtype (the native bf16 fold widens
to f32, adds and rounds to nearest-even once, as torch's bf16 add does).
At world 3 the ring adds in another order than a plain sum: f32 to
rtol/atol 1e-5 (the JAX package's tolerance), bf16 to two bf16 roundings
of the f32 sum (2^-7 relative, plus 2^-7 absolute for sums near zero).
Every rank ends with bitwise the same buffer.
"""

import threading

import numpy as np
import pytest
import torch

from rocnrdma_tpu_torch.collectives.world import RingWorld, local_worlds
from rocnrdma_tpu_torch.transport.engine import TransportError

from test_hier import port_band
from test_transport import free_port


def run_ranks(worlds, fn):
    """Run fn(world, rank) on each rank in its own thread."""
    errs = [None] * len(worlds)

    def wrap(r):
        try:
            fn(worlds[r], r)
        except BaseException as e:
            errs[r] = e

    ts = [threading.Thread(target=wrap, args=(r,))
          for r in range(len(worlds))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for e in errs:
        if e is not None:
            raise e


def _inputs(world_size, count, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(count, generator=g).to(dtype)
            for _ in range(world_size)]


@pytest.mark.parametrize("world_size", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [1, 7, 4099, 100003])
def test_allreduce_tensors(world_size, dtype, count):
    worlds = local_worlds(world_size, port_band(8))
    ins = _inputs(world_size, count, dtype, seed=count)
    bufs = [x.clone() for x in ins]
    run_ranks(worlds, lambda w, r: w.allreduce(bufs[r]))
    for r in range(1, world_size):
        assert torch.equal(bufs[r], bufs[0])
    if world_size == 2:
        assert torch.equal(bufs[0], ins[0] + ins[1])
    else:
        want = sum(x.float() for x in ins)
        if dtype == torch.float32:
            torch.testing.assert_close(bufs[0], want, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(bufs[0].float(), want,
                                       rtol=2 ** -7, atol=2 ** -7)
    for w in worlds:
        w.close()


@pytest.mark.parametrize("world_size", [2, 3])
def test_reduce_scatter_then_all_gather_equals_allreduce(world_size):
    """reduce_scatter leaves each rank owning a reduced segment (a
    slice of the flat buffer); all_gather completes the allreduce,
    bitwise the allreduce of the same inputs."""
    count = 10007
    worlds = local_worlds(world_size, port_band(8))
    ins = _inputs(world_size, count, torch.float32, seed=5)
    staged = [x.clone() for x in ins]
    fused = [x.clone() for x in ins]
    owned = [None] * world_size

    def two_phase(w, r):
        owned[r] = w.reduce_scatter(staged[r])
        w.all_gather(staged[r])

    run_ranks(worlds, two_phase)
    run_ranks(worlds, lambda w, r: w.allreduce(fused[r]))
    covered = sorted((s.start, s.stop) for s in owned)
    assert covered[0][0] == 0 and covered[-1][1] == count
    for r in range(world_size):
        assert torch.equal(staged[r], fused[r])
    for w in worlds:
        w.close()


@pytest.mark.parametrize("root", [0, 2])
def test_broadcast_tensors(root):
    worlds = local_worlds(3, port_band(8))
    bufs = [torch.full((3001,), float(r), dtype=torch.bfloat16)
            for r in range(3)]
    bufs[root] = torch.linspace(-1, 1, 3001).to(torch.bfloat16)
    want = bufs[root].clone()
    run_ranks(worlds, lambda w, r: w.broadcast(bufs[r], root))
    for r in range(3):
        assert torch.equal(bufs[r], want)
    for w in worlds:
        w.close()


def test_numpy_and_tensor_ranks_agree():
    """One rank reduces a numpy array, the other a CPU tensor: the ring
    only sees addresses, dtypes and sizes."""
    worlds = local_worlds(2, port_band(8))
    a = np.arange(1000, dtype=np.int64)
    b = torch.arange(1000, dtype=torch.int64) * 3
    run_ranks(worlds, lambda w, r: w.allreduce(a if r == 0 else b))
    assert np.array_equal(a, b.numpy())
    assert np.array_equal(a, np.arange(1000) * 4)
    for w in worlds:
        w.close()


def test_unported_coordinator_and_postmortem_raise(monkeypatch, tmp_path):
    """Without a coordinator a world needs its base port (the
    coordinator path is held in ``tests/test_torch_control.py``); the
    postmortem writer: with TDR_POSTMORTEM_DIR set a world builds, and a
    rebuild writes each rank's bundle."""
    with pytest.raises(ValueError, match="without a controller"):
        RingWorld(None, 0, 2)
    monkeypatch.setenv("TDR_POSTMORTEM_DIR", str(tmp_path))
    worlds = local_worlds(2, port_band(8), world_name="pm")
    run_ranks(worlds, lambda w, r: w.rebuild(reason=f"forced {r}"))
    for r, w in enumerate(worlds):
        assert w._postmortems == 1
        assert (tmp_path / "pm" / "incident-g0" / f"rank{r}.json").exists()
        w.close()


def test_torn_down_world_is_retryable():
    worlds = local_worlds(2, port_band(8))
    worlds[0].close()
    with pytest.raises(TransportError) as err:
        worlds[0].allreduce(torch.zeros(4))
    assert err.value.retryable
    worlds[1].close()
