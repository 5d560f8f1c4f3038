#!/usr/bin/env python
"""Two-slice data-parallel Llama training over the RDMA transport, in
PyTorch — the counterpart of ``examples/two_slice_dp.py``.

Each process is one "slice": a ``Trainer`` on one device whose
gradients are averaged ACROSS slices by a ring allreduce over this
framework's transport (``CrossSliceAllReduce(mean=True)`` over a
``RingWorld``). CUDA gradients take the shim's staged path: the ring
folds on the host CPU, so they are copied into pinned host memory,
reduced there and copied back.

Hardware-free (two processes on one machine, llama-tiny on the CPU):

    python examples/two_slice_dp_torch.py --cpu --steps 5

Both slices on one card (each process a rank; they time-slice it):

    python examples/two_slice_dp_torch.py --config llama3-1b --remat \\
        --batch 2 --seq 2048 --steps 4 --engine emu --one-batch

As real multi-host slices (one process per host):

    # host A                                  # host B
    python examples/two_slice_dp_torch.py \\
        --rank 0 --world 2 --peers hostA,hostB ...   ... --rank 1 ...

Without ``--rank`` the script starts one subprocess per rank (CUDA
cannot be forked once initialised) and exits non-zero if any fails.
Every rank starts from ``init_params(seed=0)`` and draws its data
shard from ``default_rng(1234 + rank)``: a new batch each step, or with
``--one-batch`` one batch trained on every step, as the single-card
training path does. A batch is (batch, seq + 1) token ids, so the model
runs at ``seq`` positions. Each rank prints one
JSON line per step — loss, step ms, the grads / sync / apply ms, the
staged gather / ring / scatter ms, staged bytes, each kernel's launches
and a sha256 of its parameters' bytes — after a first line with the
digest of the initial parameters, and a last line with the final digest
and peak device memory.
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


def link_tier(world) -> str:
    """How the emu engine moves payloads to the neighbour: "cma"
    (cross-memory attach) or "stream" (over the socket, where payloads
    are always sealed; on the CMA tier only with TDR_SEAL_CMA=1)."""
    if world.engine.name != "emu":
        return world.engine.name
    return "stream" if world.left_qp.has_seal_payload else "cma"


def run_slice(rank: int, args) -> int:
    import numpy as np
    import torch

    from rocnrdma_tpu_torch.collectives.staging import staging
    from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.hbm.cuda import CUDAExporter
    from rocnrdma_tpu_torch.ops import _native
    from rocnrdma_tpu_torch.parallel.trainer import Trainer
    from rocnrdma_tpu_torch.transport.engine import Engine

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda":
        torch.cuda.set_device(0)
    peers = args.peers.split(",") if args.peers else None
    world = RingWorld(Engine(args.engine), rank, args.world, args.port,
                      peers=peers)
    # CPU gradients are adopted and reduced in place (zero staged
    # bytes); CUDA gradients are staged through pinned host memory.
    sync = CrossSliceAllReduce(world, exporter=CUDAExporter(), mean=True)
    overrides = {"remat": True} if args.remat else {}
    trainer = Trainer(args.config, cross_slice_sync=sync, seed=0,
                      device=device, **overrides)
    cfg = trainer.cfg
    rng = np.random.default_rng(1234 + rank)   # per-slice data shard

    def emit(obj):
        # One write per line: the ranks share the launcher's stdout.
        sys.stdout.write(json.dumps({"rank": rank, **obj}) + "\n")
        sys.stdout.flush()

    emit({"step": 0, "digest": params_digest(trainer.model),
          "config": cfg.name, "dtype": str(cfg.dtype).split(".")[-1],
          "remat": cfg.remat, "device": device, "engine": world.engine.name,
          "link_tier": link_tier(world),
          "batch": args.batch, "seq": args.seq})
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tokens = None
    for step in range(1, args.steps + 1):
        if tokens is None or not args.one_batch:
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (args.batch, args.seq + 1)))
        staged0 = staging.bytes
        _native.reset_launches()
        t0 = time.perf_counter()
        loss = trainer.step(tokens)
        step_ms = (time.perf_counter() - t0) * 1e3
        emit({"step": step, "loss": loss, "step_ms": step_ms,
              **trainer.last_split,
              **{k.replace("_s", "_ms"): v * 1e3
                 for k, v in sync.last_split.items()},
              "staged_bytes": staging.bytes - staged0,
              "launches": _native.launches(),
              "digest": params_digest(trainer.model)})
    emit({"final_digest": params_digest(trainer.model),
          "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                          if device == "cuda" else None)})
    sync.close()
    world.close()
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rank", type=int, default=None,
                    help="slice rank; omit to start every rank locally")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--peers", default=None,
                    help="comma-separated slice hosts (default: localhost)")
    ap.add_argument("--port", type=int, default=28100)
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--config", default="llama-tiny",
                    help="llama-tiny | llama3-1b | llama3-8b")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--one-batch", action="store_true",
                    help="draw one batch per rank and train on it every "
                         "step, so the loss falls within a few steps "
                         "(chip_smoke.py's path (d) checks that it does)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (plain PyTorch versions)")
    args = ap.parse_args()

    if args.rank is not None:
        return run_slice(args.rank, args)
    argv = sys.argv[1:]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r)] + argv)
             for r in range(args.world)]
    rc = next((c for c in [p.wait() for p in procs] if c), 0)
    if rc == 0:
        print("two-slice DP demo OK", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
