#!/usr/bin/env python
"""Sequence-parallel ring attention over the RDMA transport, in PyTorch
— the counterpart of ``examples/ring_attention_demo.py``.

Each "slice" (a thread-rank here; one process per host in production)
keeps its Q shard resident while K/V shards rotate around the ring on
the transport's QPs. Forward AND backward: gradients for a shard
accumulate inside the rotating buffer and arrive home after a full
cycle. Outputs and gradients are verified against full-sequence
attention computed in one piece (the port's ``attention_reference``
and its autograd gradients), to 2e-3.

Every rank calls ``RingAttention.forward`` and ``.backward`` directly,
not through autograd, so thread-ranks may share one card: on CUDA
tensors the attention runs K3 forward and K5, K4 backward (f32: their
scalar routes).

Hardware-free run (emulated transport, the kernels' plain versions):

    python examples/ring_attention_demo_torch.py --cpu --world 3 --seq-local 64

On the card, at llama3-1b's attention widths and its longest context:

    python examples/ring_attention_demo_torch.py --world 2 --seq-local 4096 \\
        --heads 16 --kv-heads 8 --head-dim 128
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

TOL = 2e-3


def make_inputs(world: int, seq_local: int, heads: int, kv_heads: int,
                head_dim: int) -> tuple:
    """q, k, v and the output cotangent do over the whole sequence, f32
    numpy from ``default_rng(0)``: the reference demo's inputs."""
    import numpy as np

    s = world * seq_local
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, heads, s, head_dim)).astype(np.float32)
    k = rng.standard_normal((1, kv_heads, s, head_dim)).astype(np.float32)
    v = rng.standard_normal((1, kv_heads, s, head_dim)).astype(np.float32)
    do = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def ring_attention_demo(world: int, seq_local: int, heads: int,
                        kv_heads: int, head_dim: int, port: int,
                        device: str = "cuda") -> dict:
    """One causal ring-attention forward and backward over ``world``
    thread-ranks of a ``local_worlds`` ring, each on its contiguous
    shard of :func:`make_inputs`. Returns the inputs (``q``, ``k``,
    ``v``, ``do`` as tensors on ``device``), this ring's ``out`` and
    ``dq``, ``dk``, ``dv`` over the whole sequence (the ranks' shards
    concatenated) and ``wall_s``, the threads' start to their join."""
    import torch

    from rocnrdma_tpu_torch import resolve_device
    from rocnrdma_tpu_torch.collectives.ring_attention import RingAttention
    from rocnrdma_tpu_torch.collectives.world import local_worlds

    dev = resolve_device(device)
    q, k, v, do = (torch.from_numpy(a).to(dev) for a in make_inputs(
        world, seq_local, heads, kv_heads, head_dim))
    worlds = local_worlds(world, port)
    outs, grads = [None] * world, [None] * world
    errs = [None] * world

    def run_rank(r):
        try:
            ra = RingAttention(worlds[r])
            s_ = slice(r * seq_local, (r + 1) * seq_local)
            qs, ks, vs, dos = (t[:, :, s_].contiguous()
                               for t in (q, k, v, do))
            out, lse = ra.forward(qs, ks, vs)
            outs[r] = out
            grads[r] = ra.backward(qs, ks, vs, out, lse, dos)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ra.close()
        except BaseException as e:  # surfaced after join
            errs[r] = e

    t0 = time.perf_counter()
    ts = [threading.Thread(target=run_rank, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    for w in worlds:
        w.close()
    for e in errs:
        if e is not None:
            raise e
    return {"q": q, "k": k, "v": v, "do": do,
            "out": torch.cat(outs, dim=2),
            **{name: torch.cat([g[i] for g in grads], dim=2)
               for i, name in enumerate(("dq", "dk", "dv"))},
            "wall_s": wall}


def full_reference(q, k, v, do) -> tuple:
    """Causal attention over the whole sequence in one piece (the
    port's ``attention_reference``, f32 logits) and its gradients by
    autograd: ``(out, dq, dk, dv)``."""
    import torch

    from rocnrdma_tpu_torch.ops.attention import attention_reference

    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = attention_reference(q, k, v, causal=True)
        out.backward(do)
    return out.detach(), q.grad, k.grad, v.grad


def max_errors(res: dict) -> dict:
    """max |ring - full| of the output and of each gradient."""
    want = full_reference(res["q"], res["k"], res["v"], res["do"])
    return {name: float((res[name] - w).abs().max())
            for name, w in zip(("out", "dq", "dk", "dv"), want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=3)
    ap.add_argument("--seq-local", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=32)
    ap.add_argument("--port", type=int, default=25800)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) "
                         "instead of the card")
    args = ap.parse_args(argv)

    import torch

    # The full-sequence reference in f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    W, sl = args.world, args.seq_local
    res = ring_attention_demo(W, sl, args.heads, args.kv_heads,
                              args.head_dim, args.port,
                              "cpu" if args.cpu else "cuda")
    err = max_errors(res)
    print(f"world={W} seq={W * sl} ({sl}/rank) heads={args.heads} "
          f"kv={args.kv_heads} d={args.head_dim}")
    print(f"fwd+bwd wall {res['wall_s']:.2f}s; {2 * W - 1} rotations/rank "
          "over the transport (W-1 fwd + W bwd)")
    print(f"max |err| vs full-sequence reference: fwd {err['out']:.2e}, "
          f"dq {err['dq']:.2e}, dk {err['dk']:.2e}, dv {err['dv']:.2e}")
    if max(err.values()) >= TOL:
        print(f"ring attention differs from full attention by "
              f"{max(err.values()):.2e} >= {TOL}", file=sys.stderr)
        return 1
    print("ring attention fwd+bwd == full attention OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
