#!/usr/bin/env python
"""Single-card Llama training with the PyTorch port on an NVIDIA GPU.

The counterpart of ``examples/train_single_chip.py``, with its flags:
block rematerialization on (``remat=True``), AdamW configured as that
example's ``optax.adamw(lr)`` (weight decay 1e-4, optax's default), and
one fixed batch of random tokens from ``numpy.random.default_rng(0)``.
Every RMSNorm and attention, forward and backward, runs through the
port's hand-written CUDA kernels on the card. The card is the default;
``--cpu`` runs the plain PyTorch versions instead.

CPU smoke run (tiny config):

    python examples/train_single_chip_torch.py --cpu --steps 3

On one H100:

    python examples/train_single_chip_torch.py --config llama3-1b \\
        --batch 2 --seq 2048 --steps 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="llama-tiny",
                    help="llama-tiny | llama3-1b | llama3-8b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU; "
                         "default is the CUDA kernels on the card")
    args = ap.parse_args()

    import numpy as np
    import torch

    from rocnrdma_tpu_torch.parallel.trainer import Trainer

    device = "cpu" if args.cpu else "cuda"
    trainer = Trainer(args.config, learning_rate=args.lr, weight_decay=1e-4,
                      device=device, remat=True)
    cfg = trainer.cfg
    if args.seq > cfg.max_seq_len:
        ap.error(f"--seq {args.seq} exceeds max_seq_len={cfg.max_seq_len}")
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"config={cfg.name} params={cfg.param_count():,} device={kind} "
          f"kernels={'plain (cpu)' if args.cpu else 'cuda'}")

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.seq + 1)))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    loss = trainer.step(tokens)
    sync()
    print(f"step 0 (warm-up): loss={loss:.4f} "
          f"[{time.perf_counter() - t0:.1f}s]")

    if args.steps <= 1:
        return
    t0 = time.perf_counter()
    for _ in range(1, args.steps):
        loss = trainer.step(tokens)
    sync()
    dt = (time.perf_counter() - t0) / (args.steps - 1)
    print(f"step {args.steps - 1}: loss={loss:.4f} "
          f"{args.batch * args.seq / dt:,.0f} tokens/s")


if __name__ == "__main__":
    main()
