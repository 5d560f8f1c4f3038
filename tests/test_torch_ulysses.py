"""The port's Ulysses attention (``rocnrdma_tpu_torch.collectives.
ulysses``) against the JAX package and the dense math.

Ranks are threads of this process on the emu engine; on the CPU the
port runs its kernels' plain versions. Inputs come from numpy seeds.

1. Against the JAX ``UlyssesAttention(interpret=True)`` at world 2:
   each rank's output and (dq, dk, dv).
2. Against the dense plain reference (``attention_reference`` under
   autograd on the whole sequence): worlds 2 and 4 (H 8, KVH 4), causal
   and full, and bf16 at world 2; the reshard time and the staged and
   wire bytes are accounted.
3. A mixed world 2, a JAX rank and a torch rank, in both placements.
4. Head counts the world does not divide raise on every rank.

Tolerances: 2e-3 (rtol and atol) in f32, 2e-2 in bf16, as for ring
attention.
"""

import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.ulysses import \
    UlyssesAttention as JaxUlyssesAttention
from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
from rocnrdma_tpu_torch.collectives.staging import staging
from rocnrdma_tpu_torch.collectives.ulysses import (UlyssesAttention,
                                                    ulysses_attention)

from test_hier import port_band
from test_torch_ring_attention import (TOL, as_torch, close, dense, inputs,
                                       mixed_worlds, run_threads, shard,
                                       torch_worlds)


def port_ulysses(worlds, q, k, v, do, causal, s_local):
    """Each rank's (out, dq, dk, dv) and its UlyssesAttention."""
    def rank(r):
        ua = UlyssesAttention(worlds[r])
        qs, ks, vs, dos = (shard(t, r, s_local).contiguous()
                           for t in (q, k, v, do))
        out = ua.forward(qs, ks, vs, causal)
        fwd_s = ua.last_reshard_s
        grads = ua.backward(qs, ks, vs, dos, causal)
        assert fwd_s > 0 and ua.last_reshard_s > 0
        ua.close()
        return (out,) + tuple(grads), ua
    try:
        return run_threads(len(worlds), rank)
    finally:
        for w in worlds:
            w.close()


def test_ulysses_against_the_jax_package():
    world, h, kvh, s_local, d = 2, 4, 2, 16, 16
    q, k, v, do = inputs(world, h, kvh, s_local, d, seed=31)
    jw = jax_worlds(world, port_band(16))

    def jrank(r):
        ua = JaxUlyssesAttention(jw[r], interpret=True)
        qs, ks, vs, dos = (shard(t, r, s_local) for t in (q, k, v, do))
        res = (ua.forward(qs, ks, vs, causal=True),) + tuple(
            ua.backward(qs, ks, vs, dos, causal=True))
        ua.close()
        return [np.asarray(x) for x in res]
    try:
        want = run_threads(world, jrank)
    finally:
        for w in jw:
            w.close()
    got = port_ulysses(torch_worlds(world), *map(as_torch, (q, k, v, do)),
                       True, s_local)
    for r in range(world):
        for name, g, w in zip(("out", "dq", "dk", "dv"), got[r][0], want[r]):
            close(g.numpy(), w, 2e-3, f"rank {r} {name}")


@pytest.mark.parametrize("world,causal,dtype", [
    (2, True, torch.float32),
    (2, False, torch.float32),
    (4, True, torch.float32),
    (4, False, torch.float32),
    (2, True, torch.bfloat16),
])
def test_ulysses_against_dense(world, causal, dtype):
    h, kvh, s_local, d = 8, 4, 12, 16
    q, k, v, do = (as_torch(a, dtype) for a in inputs(
        world, h, kvh, s_local, d, seed=world * 100 + causal))
    staging.reset()
    got = port_ulysses(torch_worlds(world), q, k, v, do, causal, s_local)
    out, grads = dense(q, k, v, do, causal)
    tol = TOL[dtype]
    elt = torch.empty((), dtype=dtype).element_size()
    q_bytes, kv_bytes = (n * s_local * d * elt for n in (h, kvh))
    # forward: q, k, v, out; backward: q, k, v, dout, dq, dk, dv
    per_rank = 5 * q_bytes + 6 * kv_bytes
    for r, (res, ua) in enumerate(got):
        for name, g, w in zip(("out", "dq", "dk", "dv"), res, [out] + grads):
            assert g.dtype == dtype
            close(g.float(), shard(w, r, s_local), tol, f"rank {r} {name}")
        assert ua.totals["calls"] == 2
        assert ua.totals["wire_bytes"] == \
            per_rank * (world - 1) // 2
    assert staging.bytes == world * 2 * per_rank   # D2H and H2D


@pytest.mark.parametrize("jax_rank", [0, 1])
def test_mixed_world_jax_rank_and_torch_rank(jax_rank):
    s_local = 16
    q, k, v, do = inputs(2, 4, 2, s_local, 16, seed=41)
    worlds = mixed_worlds(jax_rank)

    def rank(r):
        parts = [shard(t, r, s_local) for t in (q, k, v, do)]
        if r == jax_rank:
            ua = JaxUlyssesAttention(worlds[r], interpret=True)
            res = (ua.forward(*parts[:3], causal=True),) + tuple(
                ua.backward(*parts, causal=True))
        else:
            ua = UlyssesAttention(worlds[r])
            ts = [as_torch(p) for p in parts]
            res = (ua.forward(*ts[:3], True),) + ua.backward(*ts, True)
        ua.close()
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


def test_autograd_function_runs_the_ulysses_backward():
    world, s_local = 2, 16
    q, k, v, do = map(as_torch, inputs(world, 4, 2, s_local, 16, seed=43))
    worlds = torch_worlds(world)

    def rank(r):
        ua = UlyssesAttention(worlds[r])
        leaves = [shard(t, r, s_local).clone().requires_grad_()
                  for t in (q, k, v)]
        ulysses_attention(ua, *leaves, True).backward(shard(do, r, s_local))
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


@pytest.mark.parametrize("h,kvh,label", [(3, 1, "q heads"),
                                         (4, 3, "kv heads")])
def test_indivisible_heads_raise_on_every_rank(h, kvh, label):
    worlds = torch_worlds(2)

    def rank(r):
        ua = UlyssesAttention(worlds[r])
        q, k = torch.zeros(1, h, 8, 16), torch.zeros(1, kvh, 8, 16)
        with pytest.raises(ValueError, match=label):
            ua.forward(q, k, k)
        return True
    try:
        assert all(run_threads(2, rank))
    finally:
        for w in worlds:
            w.close()
