"""The port's ring attention (``rocnrdma_tpu_torch.collectives.
ring_attention``) against the JAX package and the dense math.

Ranks are threads of this process on the emu engine; on the CPU the
port runs its kernels' plain versions. Inputs come from numpy seeds.

1. Against the JAX package: world 2, causal, f32, llama-tiny's heads
   (H 4, KVH 2, D 16): each rank's forward ``out``/``lse`` and backward
   ``dq``/``dk``/``dv`` against the JAX ``RingAttention(interpret=True)``
   on the same shards.
2. Against the dense plain reference (``attention_reference`` under
   autograd on the whole sequence): worlds 2, 3 and 4, causal and full,
   GQA and MQA, and bf16 at world 2.
3. The serial schedule (``TDR_RA_NO_OVERLAP=1``) is bitwise the
   overlapped one.
4. A mixed ring, a JAX rank and a torch rank, in both placements: each
   rank within tolerance of the dense reference.
5. Bookkeeping: returned gradients are copies, not views of the
   rotation buffers; every host bounce is charged to ``staging``;
   ``last_wait_s <= last_total_s``; the buffers are registered once;
   unequal shards raise on both ranks.

Tolerances: attention outputs and gradients 2e-3 (rtol and atol) in f32
(sums of up to S products in another order), 2e-2 in bf16 (one bf16
step of O(1) values); lse 2e-3.
"""

import threading

import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.ring_attention import \
    RingAttention as JaxRingAttention
from rocnrdma_tpu.collectives.world import RingWorld as JaxWorld
from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
from rocnrdma_tpu.transport.engine import Engine as JaxEngine
from rocnrdma_tpu_torch.collectives.ring_attention import (RingAttention,
                                                           ring_attention)
from rocnrdma_tpu_torch.collectives.staging import staging
from rocnrdma_tpu_torch.collectives.world import RingWorld, local_worlds
from rocnrdma_tpu_torch.ops.attention import attention_reference
from rocnrdma_tpu_torch.transport.engine import Engine, TransportError

from test_hier import port_band

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def run_threads(n, fn, timeout=120):
    """fn(rank) on one thread per rank; re-raises the first error."""
    errs = [None] * n
    out = [None] * n

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # surfaced after the join
            errs[r] = e

    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    for e in errs:
        if e is not None:
            raise e
    return out


def torch_worlds(n):
    return local_worlds(n, port_band(4 * n + 8))


def inputs(world, h, kvh, s_local, d, seed, dtype=np.float32):
    """q, k, v, do over the whole sequence, numpy."""
    rng = np.random.default_rng(seed)
    s = world * s_local
    return [rng.standard_normal(shape).astype(dtype) for shape in (
        (1, h, s, d), (1, kvh, s, d), (1, kvh, s, d), (1, h, s, d))]


def as_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def shard(a, r, s_local):
    return a[:, :, r * s_local:(r + 1) * s_local]


def dense(q, k, v, do, causal):
    """Output and (dq, dk, dv) of the whole sequence in f32."""
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = attention_reference(*leaves, causal=causal)
    out.backward(do.float())
    return out.detach(), [t.grad for t in leaves]


def port_ring(worlds, q, k, v, do, causal, s_local):
    """Each rank's (out, lse, dq, dk, dv) through the port's ring."""
    def rank(r):
        ra = RingAttention(worlds[r])
        qs, ks, vs, dos = (shard(t, r, s_local).contiguous()
                           for t in (q, k, v, do))
        out, lse = ra.forward(qs, ks, vs, causal)
        grads = ra.backward(qs, ks, vs, out, lse, dos, causal)
        ra.close()
        return (out, lse) + tuple(grads)
    try:
        return run_threads(len(worlds), rank)
    finally:
        for w in worlds:
            w.close()


def close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32),
                               np.asarray(b, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def test_ring_against_the_jax_package():
    world, h, kvh, s_local, d = 2, 4, 2, 16, 16
    q, k, v, do = inputs(world, h, kvh, s_local, d, seed=11)
    jw = jax_worlds(world, port_band(16))

    def jrank(r):
        ra = JaxRingAttention(jw[r], interpret=True)
        qs, ks, vs, dos = (shard(t, r, s_local) for t in (q, k, v, do))
        out, lse = ra.forward(qs, ks, vs, causal=True)
        grads = ra.backward(qs, ks, vs, out, lse, dos, causal=True)
        ra.close()
        return [np.asarray(x) for x in (out, lse) + tuple(grads)]
    try:
        want = run_threads(world, jrank)
    finally:
        for w in jw:
            w.close()
    got = port_ring(torch_worlds(world), *map(as_torch, (q, k, v, do)),
                    True, s_local)
    for r in range(world):
        for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got[r],
                              want[r]):
            close(g.numpy(), w, 2e-3, f"rank {r} {name}")


@pytest.mark.parametrize("world,causal,h,kvh,dtype", [
    (2, True, 4, 2, torch.float32),
    (2, False, 4, 2, torch.float32),
    (3, True, 4, 2, torch.float32),      # GQA, block-triangular causality
    (3, False, 4, 1, torch.float32),     # MQA
    (4, True, 4, 2, torch.float32),
    (4, False, 4, 1, torch.float32),
    (2, True, 4, 2, torch.bfloat16),
])
def test_ring_against_dense(world, causal, h, kvh, dtype):
    s_local, d = 16, 16
    q, k, v, do = (as_torch(a, dtype) for a in inputs(
        world, h, kvh, s_local, d, seed=world * 10 + causal))
    got = port_ring(torch_worlds(world), q, k, v, do, causal, s_local)
    out, grads = dense(q, k, v, do, causal)
    tol = TOL[dtype]
    for r, res in enumerate(got):
        assert res[0].dtype == dtype and res[1].dtype == torch.float32
        close(res[0].float(), shard(out, r, s_local), tol, f"rank {r} out")
        for name, g, w in zip(("dq", "dk", "dv"), res[2:], grads):
            assert g.dtype == dtype
            close(g.float(), shard(w, r, s_local), tol, f"rank {r} {name}")


def test_serial_schedule_is_bitwise_the_overlapped_one(monkeypatch):
    world, s_local = 3, 16
    q, k, v, do = map(as_torch, inputs(world, 4, 2, s_local, 16, seed=5))
    overlapped = port_ring(torch_worlds(world), q, k, v, do, True, s_local)
    monkeypatch.setenv("TDR_RA_NO_OVERLAP", "1")
    serial = port_ring(torch_worlds(world), q, k, v, do, True, s_local)
    for a, b in zip(overlapped, serial):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def mixed_worlds(jax_rank):
    """A world 2 with rank ``jax_rank`` on the JAX package's library and
    the other on the port's."""
    port = port_band(8)

    def boot(r):
        return (JaxWorld(JaxEngine("emu"), r, 2, port) if r == jax_rank
                else RingWorld(Engine("emu"), r, 2, port))
    return run_threads(2, boot)


@pytest.mark.parametrize("jax_rank", [0, 1])
def test_mixed_ring_jax_rank_and_torch_rank(jax_rank):
    s_local = 16
    q, k, v, do = inputs(2, 4, 2, s_local, 16, seed=21)
    worlds = mixed_worlds(jax_rank)

    def rank(r):
        parts = [shard(t, r, s_local) for t in (q, k, v, do)]
        if r == jax_rank:
            ra = JaxRingAttention(worlds[r], interpret=True)
            out, lse = ra.forward(*parts[:3], causal=True)
            res = (out,) + tuple(ra.backward(*parts[:3], out, lse, parts[3],
                                             causal=True))
        else:
            ra = RingAttention(worlds[r])
            qs, ks, vs, dos = map(as_torch, parts)
            out, lse = ra.forward(qs, ks, vs, True)
            res = (out,) + ra.backward(qs, ks, vs, out, lse, dos, True)
        ra.close()
        return [np.asarray(x) for x in res]
    try:
        got = run_threads(2, rank)
    finally:
        for w in worlds:
            w.close()
    out, grads = dense(*map(as_torch, (q, k, v, do)), True)
    for r in range(2):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got[r],
                              [out] + grads):
            close(g, shard(w, r, s_local).numpy(), 2e-3, f"rank {r} {name}")


def test_bookkeeping():
    """Copies not views; staging charged per bounce; waits inside the
    call; one registration for every call."""
    world, h, kvh, s_local, d = 2, 4, 2, 16, 16
    q, k, v, do = map(as_torch, inputs(world, h, kvh, s_local, d, seed=3))
    worlds = torch_worlds(world)
    ras = [RingAttention(w) for w in worlds]
    kv_bytes = 2 * kvh * s_local * d * 4
    acc_bytes = kv_bytes                      # f32 dK + dV

    def rank(r):
        ra = ras[r]
        qs, ks, vs, dos = (shard(t, r, s_local).contiguous()
                           for t in (q, k, v, do))
        out, lse = ra.forward(qs, ks, vs, False)
        assert 0 <= ra.last_wait_s <= ra.last_total_s
        mrs = ra._mrs
        grads = ra.backward(qs, ks, vs, out, lse, dos, False)
        assert 0 <= ra.last_wait_s <= ra.last_total_s
        assert ra._mrs is mrs                 # registered once
        kept = [g.clone() for g in grads]
        for b in ra._bufs:
            b.zero_()
        for g, c in zip(grads, kept):
            assert torch.equal(g, c) and bool(g.abs().sum() > 0)
        assert ra.totals["calls"] == 2
        # forward: 1 K/V rotation; backward: 1 K/V + 2 accumulator
        assert ra.totals["wire_bytes"] == 2 * kv_bytes + 2 * acc_bytes
        return True
    staging.reset()
    try:
        run_threads(world, rank)
    finally:
        for ra in ras:
            ra.close()
        for w in worlds:
            w.close()
    # Per rank, full attention: forward D2H + 1 H2D; backward D2H + 1 H2D,
    # 2 partial D2Hs and the homecoming.
    assert staging.bytes == world * (4 * kv_bytes + 3 * acc_bytes)


def test_autograd_function_runs_the_ring_backward():
    world, s_local = 2, 16
    q, k, v, do = map(as_torch, inputs(world, 4, 2, s_local, 16, seed=8))
    worlds = torch_worlds(world)

    def rank(r):
        ra = RingAttention(worlds[r])
        leaves = [shard(t, r, s_local).clone().requires_grad_()
                  for t in (q, k, v)]
        ring_attention(ra, *leaves, True).backward(shard(do, r, s_local))
        ra.close()
        return [t.grad for t in leaves]
    try:
        got = run_threads(world, rank)
    finally:
        for w in worlds:
            w.close()
    _, grads = dense(q, k, v, do, True)
    for r in range(world):
        for g, w in zip(got[r], grads):
            close(g, shard(w, r, s_local), 2e-3, f"rank {r}")


def test_unequal_shards_raise_on_both_ranks():
    worlds = torch_worlds(2)

    def rank(r):
        ra = RingAttention(worlds[r], timeout_ms=10000)
        t = torch.zeros(1, 2, 16 if r == 0 else 24, 16)
        try:
            with pytest.raises(TransportError):
                ra.forward(t, t, t, True)
        finally:
            ra.close()
        return True
    try:
        assert all(run_threads(2, rank))
    finally:
        for w in worlds:
            w.close()
