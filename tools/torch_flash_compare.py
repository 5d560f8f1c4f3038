#!/usr/bin/env python3
"""The PyTorch port's attention kernels of one tree, measured so that two
trees can be compared on one card in one run.

    python3 tools/torch_flash_compare.py                  # this tree
    python3 tools/torch_flash_compare.py --root OTHER     # another checkout

Loads ``rocnrdma_tpu_torch`` from ``--root`` (default: the tree this
script sits in), builds its kernels and prints one JSON line:

- the sha256 of K5's dQ (``flash_bwd_dq``) and of K4's dK and dV
  (``flash_bwd_dkv``) at the llama3-1b training shape (B 2, H 16, KVH 8,
  S 2048, D 128, bf16, causal; path (c) of ``chip_smoke.py``), with the
  hashes of their inputs lse and delta, so that a difference in an
  output can be told from one in the inputs. q, k, v, dO come from
  ``torch.Generator(device="cuda")`` seeded 21, out and lse from the
  plain forward (``flash_attention_lse_reference``, the same code in
  every tree of the port), delta = rowsum(dO * out);
- the sha256 of K5's dQ in f32 (B 1, H 16, KVH 8, S 1000, D 128,
  causal, seed 24), which takes the scalar route in every tree;
- the instance K5 launches at each of the two cases (``kernel_route``;
  "scalar" in a tree whose K5 had no other);
- the device ms of one call of K3 (``flash_attention_lse``) at path
  (a)'s and path (c)'s shapes, and of K4 (``flash_bwd_dkv``) and K5 at
  path (c)'s, each from CUDA-graph replay of calls cycling through
  copies of their inputs larger than the 50 MB L2 (as ``chip_smoke.py``
  times them);
- the card's name and power limit.

Run it with parent, change, change, parent in one command to compare
two trees on the same card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

L2_BYTES = 50 * 2 ** 20


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8)
                          .cpu().numpy().tobytes()).hexdigest()


def time_ms(fn, args, iters: int = 8) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls over copies of
    ``args`` (together past four times the L2) in one CUDA graph,
    replayed three times between CUDA events."""
    per_call = sum(t.numel() * t.element_size() for t in args)
    n = max(1, min(16, -(-4 * L2_BYTES // per_call)))
    sets = [args] + [tuple(t.clone() for t in args) for _ in range(n - 1)]
    for a in sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*sets[0])
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def inputs(b, h, kvh, s, d, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*shp, generator=g, device="cuda").to(dtype)
            for shp in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d),
                        (b, h, s, d))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose rocnrdma_tpu_torch to load")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from rocnrdma_tpu_torch.ops import _native
    from rocnrdma_tpu_torch.ops.attention import (
        flash_attention_lse, flash_attention_lse_reference, flash_bwd_dkv,
        flash_bwd_dq, kernel_route)

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_compare: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False

    def dq_route(d, dtype):
        if "flash_bwd_dq" not in _native.ROUTES:
            return "scalar"
        return kernel_route("flash_bwd_dq", d, dtype)

    def backward_inputs(b, h, kvh, s, d, seed, dtype):
        q, k, v, do = inputs(b, h, kvh, s, d, seed, dtype)
        out, lse = flash_attention_lse_reference(q, k, v, causal=True)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        return q, k, v, do, lse, delta

    bwd = backward_inputs(2, 16, 8, 2048, 128, 21, torch.bfloat16)
    q, k, v, do, lse, delta = bwd
    dq = flash_bwd_dq(*bwd, causal=True)
    again = flash_bwd_dq(*bwd, causal=True)
    dk, dv = flash_bwd_dkv(*bwd, causal=True)
    bwd32 = backward_inputs(1, 16, 8, 1000, 128, 24, torch.float32)
    dq32 = flash_bwd_dq(*bwd32, causal=True)
    torch.cuda.synchronize()
    qa, ka, va, _ = inputs(4, 32, 8, 512, 128, 1)
    res = {
        "root": str(Path(args.root).resolve()),
        "package": str(Path(_native.__file__).resolve().parents[1]),
        "k5_case": {"shape": [2, 16, 8, 2048, 128], "dtype": "bfloat16",
                    "causal": True,
                    "dq_route": dq_route(128, torch.bfloat16)},
        "dq_sha256": sha(dq), "dq_sum": float(dq.double().sum()),
        "lse_sha256": sha(lse), "delta_sha256": sha(delta),
        "dq_two_calls_equal": bool(torch.equal(dq, again)),
        "dk_sha256": sha(dk), "dv_sha256": sha(dv),
        "k5_f32_case": {"shape": [1, 16, 8, 1000, 128], "dtype": "float32",
                        "causal": True,
                        "dq_route": dq_route(128, torch.float32)},
        "dq_f32_sha256": sha(dq32), "lse_f32_sha256": sha(bwd32[4]),
        "k3_ms_path_a": time_ms(
            lambda *a: flash_attention_lse(*a, causal=True), (qa, ka, va)),
        "k3_ms_path_c": time_ms(
            lambda *a: flash_attention_lse(*a, causal=True), (q, k, v)),
        "k4_ms_path_c": time_ms(
            lambda *a: flash_bwd_dkv(*a, causal=True), bwd, iters=4),
        "k5_ms_path_c": time_ms(
            lambda *a: flash_bwd_dq(*a, causal=True), bwd, iters=4),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
