#!/usr/bin/env python
"""Sequence-parallel long-context Llama training over the RDMA transport,
in PyTorch — the counterpart of ``examples/seq_parallel_train.py``.

Each process is one rank of a ``RingWorld`` and holds one contiguous
token shard of every batch row: rank r trains on positions
``[r * seq / world, (r + 1) * seq / world)`` of one global batch.
Attention reaches the other shards over the ring (``--mode ring``: K/V
rotation; ``--mode ulysses``: all-to-all head resharding), and the
parameter gradients are averaged over the same ring after each backward.

Hardware-free (two processes on one machine, llama-tiny on the CPU):

    python examples/seq_parallel_train_torch.py --cpu --steps 3
    python examples/seq_parallel_train_torch.py --cpu --mode ulysses

Both ranks on one card (each process a rank; they time-slice it), at
llama3-1b's longest context:

    python examples/seq_parallel_train_torch.py --config llama3-1b \\
        --remat --batch 1 --seq 8192 --steps 4 --engine emu --one-batch \\
        --mode ring

Without ``--rank`` the script starts one subprocess per rank (CUDA
cannot be forked once initialised) and exits non-zero if any fails.
Every rank starts from ``init_params(seed=0)`` and draws the global
batch, (batch, seq + 1) token ids, from ``default_rng(1234)``: a new
one each step, or with ``--one-batch`` one batch trained on every step.
Each rank prints one JSON line per step: the global loss, step ms, the
grads / sync / apply ms, the sync's staged gather / ring / scatter ms,
the attention's calls, wire bytes sent by the rank and its transport
seconds (the ring's summed waits against its calls' whole time, or
Ulysses' reshard time), staged bytes, each kernel's launches and a
sha256 of the parameters' bytes; a first line with the digest of the
initial parameters, and a last line with the final digest and peak
device memory.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def params_digest(model) -> str:
    """sha256 over every parameter's bytes, in state-dict order."""
    import torch

    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def run_rank(rank: int, args) -> int:
    import numpy as np
    import torch

    from rocnrdma_tpu_torch.collectives.staging import staging
    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.ops import _native
    from rocnrdma_tpu_torch.parallel.trainer import Trainer
    from rocnrdma_tpu_torch.transport import engine as eng

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        torch.cuda.set_device(0)
    if args.seq % args.world:
        raise SystemExit(f"--seq {args.seq} must divide by --world "
                         f"{args.world}")
    world = RingWorld(eng.Engine(args.engine), rank, args.world, args.port)
    overrides = {"remat": True} if args.remat else {}
    # On the card the constructor builds and loads every kernel before
    # the first rotation.
    trainer = Trainer(args.config, seq_parallel=world, sp_mode=args.mode,
                      seed=0, device=device, **overrides)
    cfg = trainer.cfg
    s_local = args.seq // args.world
    shard = slice(rank * s_local, (rank + 1) * s_local)
    rng = np.random.default_rng(1234)   # the global batch, on every rank

    def emit(obj):
        # One write per line: the ranks share the launcher's stdout.
        sys.stdout.write(json.dumps({"rank": rank, **obj}) + "\n")
        sys.stdout.flush()

    emit({"step": 0, "digest": params_digest(trainer.model),
          "config": cfg.name, "dtype": str(cfg.dtype).split(".")[-1],
          "remat": cfg.remat, "device": device, "engine": world.engine.name,
          "link_tier": world.link_tier, "mode": args.mode,
          "world": args.world, "batch": args.batch, "seq": args.seq,
          "seq_local": s_local})
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tokens = None
    for step in range(1, args.steps + 1):
        if tokens is None or not args.one_batch:
            tokens = rng.integers(0, cfg.vocab_size,
                                  (args.batch, args.seq + 1))
        inputs = tokens[:, :-1][:, shard]
        targets = tokens[:, 1:][:, shard]
        staged0 = staging.bytes
        _native.reset_launches()
        t0 = time.perf_counter()
        loss = trainer.step(inputs, targets)
        step_ms = (time.perf_counter() - t0) * 1e3
        attn = trainer.last_attention
        emit({"step": step, "loss": loss, "step_ms": step_ms,
              **trainer.last_split,
              **{k.replace("_s", "_ms"): v * 1e3
                 for k, v in trainer.sync.last_split.items()},
              "attn_calls": attn["calls"],
              "attn_wire_bytes": attn["wire_bytes"],
              **{f"attn_{k[:-2]}_ms": v * 1e3 for k, v in attn.items()
                 if k.endswith("_s")},
              "staged_bytes": staging.bytes - staged0,
              "launches": _native.launches(),
              "digest": params_digest(trainer.model)})
    emit({"final_digest": params_digest(trainer.model),
          "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                          if device == "cuda" else None)})
    trainer.close()
    world.close()
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rank", type=int, default=None,
                    help="ring rank; omit to start every rank locally")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, default=28300)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--config", default="llama-tiny",
                    help="llama-tiny | llama3-1b | llama3-8b")
    ap.add_argument("--mode", choices=["ring", "ulysses"], default="ring",
                    help="attention strategy: K/V rotation (ring) or "
                         "all-to-all head resharding (ulysses)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block's two halves in the backward")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64,
                    help="GLOBAL sequence length, split across the ranks")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--one-batch", action="store_true",
                    help="draw one global batch and train on it every step")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (plain PyTorch versions)")
    args = ap.parse_args()

    if args.rank is not None:
        return run_rank(args.rank, args)
    argv = sys.argv[1:]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r)] + argv)
             for r in range(args.world)]
    rc = next((c for c in [p.wait() for p in procs] if c), 0)
    if rc == 0:
        print("sequence-parallel demo OK", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
