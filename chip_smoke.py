#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``rocnrdma_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``rocnrdma_tpu_torch/csrc/`` with nvcc,
holds each against its plain PyTorch version at its path's shapes (and
ragged, f32/bf16, causal/full variants), shows each backward kernel, K6
(``decode_attn``, the cached decode step's attention, at (a)'s and the
benchmark cells' decode shapes), K7 (``mla_decode``, the latent-attention
decode step's), G1 (``moe_gemm_up`` and ``moe_gemm_down``, the expert
layer's grouped GEMMs) and K8 (``moe_combine``, the expert layer's sum
of each token's picks and the shared experts' row, bitwise the plain
combine), all at the decode-mla cell's shapes, bitwise
deterministic across two calls, times each at the shapes of the
``kernels`` line, then drives the serving and training paths through the
entry points a user calls. K3 (``flash_fwd``), K4 (``flash_bwd_dkv``)
and K5 (``flash_bwd_dq``) have two instances each, a tensor-core one
(bf16 at D 64 and 128) and a scalar one (f32, bf16 at D 16 and 32):
every case of theirs prints the ``route`` the library chose, both routes
are held against the plain versions, and the cases at the shapes of
paths (a) and (c) must report the tensor-core route. K1 is also
captured in a CUDA graph at (a)'s decode shape and (b) jit's layer
shape, replayed on fresh inputs and held against its plain version, one
launch a replay.

The paths are gates, not measurements: the benchmark (``BENCHMARK.json``,
``benchmark/``) measures the port, and its yardstick
(``benchmark/roofline.py``, ``benchmark/roofline_mla.py``) gives the
kernels' bounds here.

- path (a): ``generate`` at llama3-8b (all 32 layers, bf16, random
  weights from ``init_params(seed=0)``), batch 4, prompt 512, 32 new
  tokens, its prefill eager (K3) and its decode steps replays of one
  captured CUDA graph: launch counts through the replays, peak memory,
  tokens against the uncaptured step (bitwise, else the near-tie rule,
  reported), a second call capturing nothing, and after
  ``load_state_dict(assign=True)`` with other weights a new capture
  whose tokens follow them;
- parity: llama3-1b in f32, full-forward logits of a 128-token prompt
  on the card (kernels) against the same model on the CPU (plain
  versions);
- path (b): the loopback ``ContinuousBatcher`` at llama3-1b f32 over
  streamed weight pages, four requests and a fifth that joins mid-run,
  each request's greedy tokens held against ``generate`` on the same
  weights; then (b)'s script on ``ContinuousBatcher(..., jit_decode=
  True)`` (each decode layer step replayed from a graph over pooled
  caches): tokens (b)'s by the near-tie rule, launches (b)'s, at most 4
  slots x 16 layers graphs, the pool's bytes;
- the HF import: (b)'s weights laid out as an HF ``LlamaForCausalLM``
  checkpoint (HF's names, projections (out, in), a config with HF's
  field names) and brought back by ``config_from_hf`` and
  ``from_hf_state_dict``: every tensor bitwise the original, the
  geometry llama3-1b's, and a tied checkpoint's head the embedding's
  transpose;
- path (h): two rank processes, each rebuilding (b)'s weights, taking
  them through the HF import and serving (b)'s request script on a
  world-2 ``ContinuousBatcher`` over the emu ring (weights sharded and
  gathered a page at a time with prefetch, each joining request's KV
  pages broadcast from its home rank): tokens equal on both ranks and
  to (b)'s, launches and gathered and broadcast bytes per rank as the
  shapes say, the link tier, the prefetch-overlap fraction;
- path (c): ``Trainer("llama3-1b", remat=True)`` in bf16, all 16
  layers, batch 2, seq 2048 (the shape of
  ``examples/train_single_chip.py``), one warm step then 4 on one batch:
  launch counts, finite and falling losses, peak memory; then the same
  under ``remat_policy="dots"`` (the projections' outputs kept, the rest
  recomputed): each step's loss equal to (c)'s, K1-K5 launches per step
  (c)'s, peak memory;
- training parity: llama3-1b in f32, batch 1, seq 200, loss and every
  parameter's gradient on the card (kernels) against the CPU (plain
  versions), then the parameters after one AdamW step; the card step's
  launches as the model says;
- the CUDA exporter: what the card and host offer for RDMA into device
  memory (compute mode, DMA_BUF_SUPPORTED, HCAs), a dma-buf exported
  from a 64 MiB tensor, the emu engine's answer to it, the
  ``direct_registrable`` veto, and — where an HCA exists — a loopback
  RDMA WRITE into the device range and its revocation;
- the cross-slice sync: a world-2 ring of two threads on the card, each
  rank's ~256 MB tree of f32 and bf16 CUDA tensors averaged through the
  staged path — fused, bucketed at the default size and at 4 MiB (all
  bitwise against (a + b) / 2 on the device), and with the bf16 and
  int8 wires on the f32 leaves (within tolerance, the warm call's
  widened by the residuals it carries in; the bf16 wire bitwise the
  mean of what the ranks sent; both ranks bitwise equal) — with each
  mode's staged bytes;
- path (d): ``examples/two_slice_dp_torch.py`` as two rank processes on
  the card, llama3-1b bf16 with remat, batch 2 x seq 2048 per rank, the
  gradients averaged over the emu ring each step: losses, equal
  parameter digests on both ranks after every step, launches per step
  equal to path (c)'s, staged bytes;
- path (e): path (d)'s command with ``--per-layer`` and
  ``TDR_TELEMETRY=1``: each layer's gradients pushed from the backward
  by post-accumulate-grad hooks; path (d)'s gates, parameter digests
  equal to path (d)'s after every step, the overlap fractions and the
  recorder's dropped count;
- path (f): path (d)'s two ranks under the port's coordinator (started
  as a process) with ``--elastic-dir`` (a checkpoint every step); rank 1
  SIGKILLs itself in its 2nd sync call and is started again, restores
  its checkpoint and rejoins while rank 0 resumes: digests equal on
  every rank and to path (d)'s after every step, one recovery and the
  ranks' generation on the coordinator's ``/metrics``, rank 0's
  postmortem bundle and the port's ``tdr_explain --postmortem`` readout
  of its incident directory (the world, the bundle's generation, every
  rank bundle listed), launches per attempt equal to path (c)'s per step,
  and the checkpoint bytes;
- sequence-parallel parity: llama3-1b f32, a global sequence of 1024
  split over two rank processes, one SGD step in each mode (ring
  attention, Ulysses): the global loss and every synced gradient against
  the single-device ``Trainer`` on the whole sequence, parameters equal
  on both ranks, each rank's launches as the model says;
- path (g): ``examples/seq_parallel_train_torch.py`` as two rank
  processes, llama3-1b bf16 with remat at its longest context (batch 1,
  8192 tokens, 4096 a rank), ring then Ulysses, two steps on one batch:
  equal digests on both ranks after every step, the first losses of
  both modes and of the single-device model within 2e-2, launches and
  the attention's wire and staged bytes per rank per step as the model
  and the shapes say, peak memory. The attention kernel phases hold K3,
  K4 and K5 at (g)'s shapes too: the ring's full past shard (K4/K5
  driven by an lse merged with another shard's) and causal diagonal at
  S 4096, Ulysses' causal S 8192.
- path (i): the intra-slice dp x tp mesh, its positions sharing the one
  card (``devices=["cuda:0"] * n``). f32 parity: llama3-1b, batch 2 x
  seq 200, one step of ``Trainer(cfg, {"dp": 2, "tp": 2}, devices=...)``
  against the single-device card ``Trainer`` from the same weights (loss
  1e-4 relative, every gradient 1e-3 of its largest element, the
  parameters after the AdamW step by the training-parity rule), no two
  positions' parameters sharing storage, both steps' launches as the
  model says. bf16: path (c)'s model, batch and weights on dp 2 x tp 2
  with remat, one warm step then 3: the first loss within 2e-2 relative
  of (c)'s, launches per step 4 x (c)'s, K3/K4/K5 on the tensor-core
  route at the positions' local shape (B1 H8 KVH4 S2048 D128), peak
  memory. Two slices: ``examples/two_slice_dp_torch.py --mesh dp=1,tp=2
  --devices cuda:0,cuda:0`` as path (d)'s two rank processes (2
  steps): digests equal on both ranks every step, (d)'s staged bytes,
  launches 2 x (c)'s, first losses within 2e-2 relative of (d)'s. Then
  those two slices with ``--per-layer`` and ``--elastic-dir`` under the
  coordinator, run as path (f) runs, 2 steps, rank 1 SIGKILLed at its
  first bucket push of step 2 and started again: digests after every
  step equal to the fused two slices', one recovery, launches per
  attempt two positions' of (c)'s, the checkpoint file the size of
  (f)'s (the meshed file is the single-device one). The elastic paths
  write every thread's stack every 30 s of a resume into the phase's
  line. The kernel phases hold K3, K4 and K5 at (i)'s local shape, K3's
  scalar f32 route at (b)'s and (h)'s shortest and longest prompts (S
  85 and 225), and K4's and K5's scalar f32 routes at the training
  parity's shape (B1 H16 KVH8 S200, causal), the sequence-parallel
  parity's past shard (S 512, full, merged lse) and S 2048; the build
  fails unless K3, K4 and K5 each have their six scalar instances with
  no spill.
- the elastic soak: ``tools/torch_fault_soak.py``'s ``run_soak`` with
  its two ranks as threads of this process on the card, llama3-1b's
  widths in bf16 cut to 2 layers, a checkpoint every step (K1-K5 on the
  tensor-core route at D128). (a) the reference's tier-1 mixed plan (a
  transient ring fault, a corrupted sealed frame, and a connection
  drop after half the posts the clean run made), 3 steps; (b) the
  arbitrated flap (an in-process coordinator, rank 1 tearing its
  transport down in its 2nd sync), 2 steps; each against its own clean
  run: final parameters bitwise the clean run's on both ranks, the
  counters of a fired plan, launches one train step's per step attempt;
  the checkpoint bytes and directory, any stack a resume of 10 s or
  more left (the ring's stall deadline is 15 s in this phase);
- the ring-attention demo: ``examples/ring_attention_demo_torch.py``
  at llama3-1b's attention widths (H16 KVH8 D128) and path (g)'s
  context, 8192 f32 tokens over two rank threads, forward and backward
  by explicit calls (K3, K5, K4 on their scalar routes): the output
  and gradients against full attention on the card to 2e-3, the
  launches;
- the overlap smoke: ``tools/torch_overlap_smoke.py`` in its quick full
  mode (``TDR_OVERLAP_QUICK=1``) on the card, its two ranks as two
  processes over the emu ring, llama-tiny cut to 6 layers in f32 (K3,
  K4 and K5 on their scalar route at head dim 16): the per-layer int8
  pair, then the fused f32 pair on the same batches. The gates that
  bind everywhere: wire events recorded, every world's
  ``pending_async`` zero, each rank's native thread census flat across
  the measured windows and below its baseline after the close, each
  rank's int8 losses within 5e-3 of its fused pair's, and each rank's
  launches as the model says for the steps it ran; the overlap
  fractions reported with their bound note (the tool's ``OVERLAP``
  line is printed too).

Every phase prints one JSON line with its seconds. Each kernel's launch
counter is set to 0 just before a path runs and read just after; the
path fails unless every kernel ran there as often as the model says.
Then one ``{"kernels": [...]}`` line (each kernel's error, its device
ms, plain and library ms, its bound and launches by path), the card's
name and power limit as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero without that line; it also fails at once where
``torch.cuda.is_available()`` is false.

TF32 is switched off for matmuls and cuDNN (both flags set below), so
f32 products on the card run in full f32.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import faulthandler
import importlib.util
import json
import math
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import roofline as rl
from benchmark import roofline_kimi as rlk
from benchmark import roofline_mla as rlm
from rocnrdma_tpu_torch.collectives.staging import staging
from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.control import ControlClient
from rocnrdma_tpu_torch.hbm import cuda as hcuda
from rocnrdma_tpu_torch.hbm.registry import (HbmError, PeerClient,
                                             RegistrationManager)
from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.models.convert import (config_from_hf,
                                               from_hf_state_dict)
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (
    flash_attention_bwd_reference, flash_attention_lse,
    flash_attention_lse_reference, flash_attention_shard_grads,
    flash_bwd_dkv, flash_bwd_dq, kernel_route)
from rocnrdma_tpu_torch.ops import kda
from rocnrdma_tpu_torch.ops import mla_decode as mld
from rocnrdma_tpu_torch.ops import moe
from rocnrdma_tpu_torch.ops.decode_attention import (
    cached_attention, cached_attention_reference)
from rocnrdma_tpu_torch.ops.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                            rmsnorm_bwd_reference,
                                            rmsnorm_reference)
from rocnrdma_tpu_torch.parallel.trainer import Trainer, loss_fn
from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher, Request
from rocnrdma_tpu_torch.serving.model import ServeConfig, pack_llama_params
from rocnrdma_tpu_torch.tools import explain
from rocnrdma_tpu_torch.transport import engine as eng
from rocnrdma_tpu_torch.utils import graphs
from rocnrdma_tpu_torch.utils.trace import trace

REPO = Path(__file__).resolve().parent

L2_BYTES = 50 * 2 ** 20
# The decode-mla cell's model: K7's and G1's shapes and bounds.
MOONLIGHT = json.loads((REPO / "benchmark" / "configs"
                        / "moonlight-16b-a3b.json").read_text())
# The decode-hybrid cell's model: K9's shapes and bounds, and K7's at 32
# heads.
KIMI = json.loads((REPO / "benchmark" / "configs"
                   / "kimi-linear-48b-a3b.json").read_text())

# Tolerances against the plain versions, with their reasons:
# - f32 outputs: the kernel sums in another order than PyTorch's
#   reductions (1e-5 for a norm row, 2e-4 for attention's long sums);
# - bf16 outputs: both sides round an f32 result to bf16, so they may
#   differ by one bf16 step of the value (2^-7 relative; attention gets
#   2e-2 absolute on O(1) outputs); lse is f32 in both dtypes.
# - backward: dx, dq, dk, dv as the forward outputs of their dtype
#   (attention's gradients are O(1-10) sums of up to S products, 2e-4
#   in f32 leaves 20x margin over the f32 error measured against f64);
#   dw is an f32 sum over all rows taken in another order (kernel: runs
#   of rows, then 256 partials), so rtol 1e-4 and atol 1e-3.
# - the tensor-core route of K3, K4 and K5 (bf16, D 64 and 128)
#   multiplies bf16 operands into f32 sums, as the plain versions do, and
#   rounds P (K3, K4) and dS (K4, K5) to bf16 before their second
#   product, which the plain versions keep in f32. Those roundings (2^-9
#   relative, random in sign) average out over the sums of up to S
#   terms; measured errors stay within the bf16 tolerance above, which
#   is unchanged.
# - K6 (decode attention) rounds each probability to bf16 before
#   normalising where the plain version rounds after: a bf16 step of the
#   output (2^-8 of values up to ~0.3) plus those roundings, so rtol
#   2^-6 and atol 2^-8 in bf16; in f32 the sums' order only.
# - K7 (latent decode) rounds its probabilities as K6 does, and G1 (the
#   grouped GEMMs) sums bf16 products in f32 in another order than the
#   per-expert loop, which rounds where the kernels round: both get K6's
#   rtol 2^-6 and an atol of 2^-8 of the output's largest magnitude
#   (as tests/test_torch_mla_moe.py holds them).
TOL = {("rmsnorm", torch.float32): (1e-5, 1e-5),
       ("rmsnorm", torch.bfloat16): (2 ** -7, 2 ** -7),
       ("flash", torch.float32): (2e-4, 2e-4),
       ("flash", torch.bfloat16): (2e-2, 2e-2),
       ("lse", None): (2e-4, 2e-4),
       ("dw", None): (1e-4, 1e-3),
       ("decode", torch.float32): (1e-4, 1e-5),
       ("decode", torch.bfloat16): (2 ** -6, 2 ** -8)}

# Full-forward logits, card (kernels, cuBLAS f32) against CPU (plain
# versions): sums of 2048- and 5632-long products taken in another order
# through 16 layers.
PARITY_TOL = 1e-3

# Training parity, card against CPU, llama3-1b f32: the loss to 1e-4
# (the logits' 1e-3 averaged over 200 positions); each parameter's
# gradient to 1e-3 of that gradient's largest element (the same f32 sums
# in another order, forward and back through 16 layers). After one
# AdamW step from equal weights each element moved by
# lr * g / (|g| + eps) plus the decay, i.e. lr * sign(g) up to eps / |g|.
# Where the CPU's |g| exceeds 1e-2 of its tensor's largest gradient (so
# the two sides' gradients share a sign and differ by at most 1e-1
# relative) and 1e-6 (so eps moves the update by at most 1e-2 lr), the
# parameters differ by under 4e-7 from the gradients plus a few f32
# rounding steps: TRAIN_DECIDED_TOL. An element whose gradient is near
# zero may land up to 2 lr apart; of those at most one element in 1e4
# may differ by more than 1e-5.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_DECIDED_TOL = 2e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def input_sets(tensors, out_bytes: int = 0) -> list:
    """Copies of one call's inputs, enough that cycling through them
    moves four times the 50 MB L2 (at most 16): a timed call then reads
    its inputs from device memory, as the serving path does."""
    per_call = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    n = max(1, min(16, -(-4 * L2_BYTES // per_call)))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def time_ms(fn, sets, iters: int = 24) -> float:
    """Device time of one call of ``fn``, in ms: ``iters`` calls cycling
    through the argument tuples ``sets`` are captured into one CUDA graph
    and replayed, timed with CUDA events — so the host's launch gaps do
    not count, only the card's time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
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
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def eager_ms(fn, iters: int) -> float:
    """Host wall time of one eager call, in ms, synchronised at the end:
    the wrapper's Python and launch cost included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def max_err(got: torch.Tensor, want: torch.Tensor, rtol: float,
            atol: float, what: str) -> float:
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol}, max abs err {float(err.max())}")
    return float(err.max())


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def bound_by(t_s: float, flops: float, dtype: str) -> str:
    """Which side bounds a yardstick time ``t_s`` of ``flops``
    operations: the operations where it is their time at the peak."""
    return "operations" if t_s == flops / rl.PEAK_FLOPS[dtype] else "bytes"


def rmsnorm_bound(rows: int, d: int, dtype, backward: bool) -> tuple:
    """K1's or K2's bound in ms at ``rows`` x ``d``, and "bytes"."""
    fn = rl.rmsnorm_bwd_bound_s if backward else rl.rmsnorm_fwd_bound_s
    return fn(rows, d, dtype_name(dtype)) * 1e3, "bytes"


# Operations a visible (q, k) pair costs per head: K3 4·D, K4 8·D, K5 6·D.
FLASH_OPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}


def flash_bound(kernel: str, b, h, kvh, s, d, causal, dtype) -> tuple:
    """K3's, K4's or K5's bound in ms and what bounds it."""
    name = dtype_name(dtype)
    if kernel == "flash_fwd":
        t = rl.flash_fwd_bound_s(b, h, kvh, s, d, causal, name)
    else:
        t = rl.flash_bwd_bounds_s(b, h, kvh, s, d, causal, name)[kernel]
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = FLASH_OPS_PER_PAIR[kernel] * d * pairs * b * h
    return t * 1e3, bound_by(t, flops, name)


def decode_attn_bound(b, h, kvh, d, pos, dtype) -> tuple:
    """K6's bound in ms and what bounds it; the benchmark has none. The
    live prefix's K and V and q read once and out written, against 4·D
    operations a live position and head."""
    name, live = dtype_name(dtype), pos + 1
    t, by = rl.bound_s(4.0 * d * live * b * h,
                       (2 * b * kvh * live * d + 2 * b * h * d)
                       * rl.ELT_BYTES[name], name)
    return t * 1e3, by


def mla_decode_bound(b: int, pos: int, cfg: dict = MOONLIGHT) -> tuple:
    """K7's bound in ms over the first ``pos + 1`` positions of b bf16
    latent caches at ``cfg``'s heads (a configuration under
    ``roofline_mla``'s names), and what bounds it."""
    c, live = rlm.dims(cfg), pos + 1
    t = rlm.mla_decode_bound_s(cfg, b, live, "bfloat16")
    flops = 2.0 * c.h * (2 * c.rank + c.rope) * b * live
    return t * 1e3, bound_by(t, flops, "bfloat16")


def kda_bound(b: int, t: int) -> tuple:
    """K9's bound in ms over b sequences of t tokens at Kimi Linear's
    heads (the benchmark's ``roofline_kimi.kda_bound_s``), and what bounds
    it."""
    c = rlk.dims(KIMI)
    s = rlk.kda_bound_s(KIMI, b, t, "bfloat16")
    flops = rlk.KDA_OPS_PER_D2 * c.kd * c.kd * c.kh * b * t
    return s * 1e3, bound_by(s, flops, "bfloat16")


def grouped_swiglu_bound(n: int) -> tuple:
    """G1's whole call over n tokens in ms, and what bounds it: every
    expert's three weights and the picked rows' inputs, products and
    outputs moved once, against the rows' 6·d·f operations. The
    benchmark bounds each GEMM alone (``grouped_gemm_bounds``)."""
    c = rlm.dims(MOONLIGHT)
    rows = n * c.k
    t, by = rl.bound_s(6.0 * rows * c.d * c.f,
                       (3 * c.e * c.d * c.f + 2 * rows * c.d
                        + 2 * rows * c.f) * 2, "bfloat16")
    return t * 1e3, by


def combine_bound(n: int) -> tuple:
    """K8's bound in ms over n tokens at Moonlight's widths, and what
    bounds it; the benchmark has none. Each token's k picked rows of the
    down GEMM's output, its shared row and its k int64 indices read once
    and its row written, against d·k f32 adds on the CUDA cores."""
    c = rlm.dims(MOONLIGHT)
    t, by = rl.bound_s(1.0 * n * c.d * c.k,
                       n * c.k * c.d * 2 + 2 * n * c.d * 2 + n * c.k * 8,
                       "float32")
    return t * 1e3, by


def grouped_gemm_bounds(n: int) -> tuple:
    """The benchmark's bounds of ``moe_gemm_up`` and ``moe_gemm_down``
    over n tokens, in ms."""
    up, down = rlm.moe_gemm_bounds_s(MOONLIGHT, n, "bfloat16")
    return up * 1e3, down * 1e3


# ---------------------------------------------------------------- phases

def phase_device() -> dict:
    require(torch.cuda.is_available(),
            "torch.cuda.is_available() is False: chip_smoke needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([_native.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    return {"gpu": nvidia_smi("name,power.limit"),
            "nvidia_driver": nvidia_smi("driver_version"),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": [ln for ln in nvcc.stdout.splitlines()
                     if "release" in ln][-1].strip(),
            "tf32": "off (matmul and cudnn)"}


def kernel_resources() -> dict:
    """Registers and stack/local (spill) bytes of every kernel in the
    built libraries, as ``cuobjdump --dump-resource-usage`` reports them
    (names demangled by ``cu++filt``; both ship beside nvcc). A kernel
    that raises its count with setmaxnreg reports its count at entry."""
    bin_dir = Path(_native.nvcc()).parent
    out = {}
    for name in _native.KERNELS:
        text = subprocess.run(
            [str(bin_dir / "cuobjdump"), "--dump-resource-usage",
             str(_native.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
        found = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) "
                           r"SHARED:\d+ LOCAL:(\d+)", text)
        names = subprocess.run(
            [str(bin_dir / "cu++filt")], input="\n".join(f[0] for f in found),
            capture_output=True, text=True, timeout=60,
            check=True).stdout.split("\n")
        for (mangled, reg, stack, local), full in zip(found, names):
            # "void <unnamed>::tc::k<(int)128>(args)" -> "tc::k<128>"
            short = re.sub(r"\((?:unsigned )?(?:int|bool)\)", "", full)
            short = re.sub(r"<unnamed>::|\(anonymous namespace\)::", "",
                           short)
            short = short.split("(")[0].removeprefix("void ")
            short = short.replace("__nv_bfloat16", "bf16") or mangled
            require(short not in out, f"two kernels named {short}")
            out[short] = {"regs": int(reg), "stack": int(stack),
                          "local": int(local)}
    return out


def phase_build() -> dict:
    _native.build()
    for name in _native.KERNELS:
        _native.library(name)
    res = kernel_resources()
    # The tensor-core kernels keep their accumulators in registers; a
    # stack frame there means spilled accumulators.
    tc = {k: r for k, r in res.items() if k.startswith("tc::")}
    require(len(tc) == 6 and all(r["stack"] == 0 and r["local"] == 0
                                 for r in tc.values()),
            f"tensor-core kernels missing or spilling: {tc}")
    # K3's scalar route (f32 at D 16-128, bf16 at D 16 and 32) keeps its
    # score and output tiles in registers too.
    # So do K4's and K5's (f32 at D 16-128, bf16 at D 16 and 32): their
    # dK/dV and dQ accumulators.
    for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        inst = {k: r for k, r in res.items()
                if k.startswith(kernel + "_kernel<")}
        require(len(inst) == 6 and all(r["stack"] == 0 and r["local"] == 0
                                       for r in inst.values()),
                f"{kernel} scalar instances missing or spilling: {inst}")
    return {"resources": res}


def rmsnorm_case(rows: int, d: int, dtype, seed: int, timed: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    w = torch.rand(d, generator=g, device="cuda") + 0.5
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    rtol, atol = TOL[("rmsnorm", dtype)]
    res = {"rows": rows, "d": d, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max_err(got, rmsnorm_reference(x, w), rtol, atol,
                                  f"rmsnorm {rows}x{d} {dtype}")}
    if timed:
        sets = input_sets((x, w), out_bytes=x.numel() * x.element_size())
        lib_sets = [(a, b.to(dtype)) for a, b in sets]
        bound, by = rmsnorm_bound(rows, d, dtype, backward=False)
        res.update(
            ms=time_ms(lambda a, b: rmsnorm(a, b), sets),
            plain_ms=time_ms(lambda a, b: rmsnorm_reference(a, b), sets),
            library_ms=time_ms(lambda a, b: F.rms_norm(a, (d,), b, 1e-5),
                               lib_sets),
            bound_ms=bound, bound_by=by)
    return res


def rmsnorm_graph_case(rows: int, d: int, dtype, seed: int,
                       replays: int = 8) -> dict:
    """K1 inside a CUDA graph, as the compiled decode runs it: captured
    with the copy of its output (``graphs.CapturedStep``), then replayed
    on fresh input data each time and held against the plain version to
    K1's tolerance; the launches each replay counts."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    w = torch.rand(d, generator=g, device="cuda") + 0.5
    y = torch.empty_like(x)
    step = graphs.CapturedStep(lambda: y.copy_(rmsnorm(x, w)),
                               torch.device("cuda"))
    step()                                        # warm-up + capture
    rtol, atol = TOL[("rmsnorm", dtype)]
    err = 0.0
    _native.reset_launches()
    for _ in range(replays):
        x.copy_(torch.randn(rows, d, generator=g, device="cuda").to(dtype))
        step()
        torch.cuda.synchronize()
        err = max(err, max_err(y, rmsnorm_reference(x, w), rtol, atol,
                               f"rmsnorm {rows}x{d} {dtype} replayed"))
    per_replay = _native.launches()["rmsnorm_fwd"] / replays
    require(step.launches == {"rmsnorm_fwd": 1} and per_replay == 1,
            f"replayed K1 launches {step.launches}, {per_replay} a replay")
    return {"rows": rows, "d": d, "dtype": str(dtype).split(".")[-1],
            "captured": True, "replays": replays, "max_abs_err": err,
            "launches_per_replay": per_replay}


def phase_rmsnorm() -> dict:
    cases = [rmsnorm_case(2048, 4096, torch.bfloat16, 1, True),   # path (a)
             rmsnorm_case(2048, 4096, torch.float32, 2, False),
             rmsnorm_case(1000, 4096, torch.bfloat16, 3, False),  # ragged
             rmsnorm_case(4, 4096, torch.bfloat16, 4, False),     # decode
             rmsnorm_case(256, 2048, torch.float32, 5, False),    # path (b)
             rmsnorm_case(4096, 2048, torch.bfloat16, 6, False),  # path (c)
             rmsnorm_case(128, 64, torch.float32, 9, False),      # overlap
             rmsnorm_case(32, 64, torch.float32, 10, False)]      # control
    # (a)'s decode step and (b) jit's layer step, inside a graph.
    graphed = [rmsnorm_graph_case(4, 4096, torch.bfloat16, 7),
               rmsnorm_graph_case(1, 2048, torch.float32, 8)]
    return {"cases": cases, "graphed": graphed}


def flash_case(b, h, kvh, s, d, dtype, causal, seed, timed,
               need_route=None, repeat=False) -> dict:
    """``repeat``: a second call on the same inputs must give bitwise the
    same out and lse."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want_o, want_l = flash_attention_lse_reference(q, k, v, causal=causal)
    what = f"flash {(b, h, kvh, s, d)} {dtype} causal={causal}"
    route = kernel_route("flash_fwd", d, dtype)
    require(need_route in (None, route),
            f"{what}: route {route}, expected {need_route}")
    rtol, atol = TOL[("flash", dtype)]
    res = {"shape": [b, h, kvh, s, d], "dtype": str(dtype).split(".")[-1],
           "causal": causal, "route": route,
           "max_abs_err": max_err(out, want_o, rtol, atol, what),
           "lse_max_abs_err": max_err(lse, want_l, *TOL[("lse", None)],
                                      what + " lse")}
    del want_o, want_l
    if repeat:
        again, lse2 = flash_attention_lse(q, k, v, causal=causal)
        require(torch.equal(again, out) and torch.equal(lse2, lse),
                what + ": two calls differ")
        res["deterministic"] = True
    if timed:
        bound, by = flash_bound("flash_fwd", b, h, kvh, s, d, causal, dtype)
        sets = input_sets((q, k, v), out_bytes=q.numel() * q.element_size())
        res.update(
            ms=time_ms(lambda *a: flash_attention_lse(*a, causal=causal),
                       sets, iters=8),
            plain_ms=time_ms(lambda *a: flash_attention_lse_reference(
                *a, causal=causal), sets[:1], iters=3),
            library_ms=time_ms(lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=causal, enable_gqa=True), sets, iters=8),
            bound_ms=bound, bound_by=by)
    return res


TC = "tensor_core"


def phase_flash() -> dict:
    bf, f32 = torch.bfloat16, torch.float32
    cases = [flash_case(4, 32, 8, 512, 128, bf, True, 1, True, TC),  # (a)
             flash_case(1, 32, 8, 2048, 128, bf, True, 2, False),
             flash_case(1, 32, 8, 2048, 128, bf, False, 3, False),
             flash_case(1, 32, 8, 1000, 128, bf, True, 4, False),  # odd S
             flash_case(1, 16, 8, 2048, 128, f32, True, 5, True),
             flash_case(1, 16, 8, 256, 128, f32, True, 6, True),  # path (b)
             flash_case(2, 16, 8, 2048, 128, bf, True, 7, True, TC),  # (c)
             # the tensor-core route at its edges: D 64 and 128, S of one
             # row, one row past a tile, odd and long; groups 1, 2 and 4
             flash_case(1, 8, 8, 1, 64, bf, True, 8, False, TC),
             flash_case(1, 8, 4, 65, 64, bf, False, 9, False, TC),
             flash_case(2, 8, 2, 1000, 64, bf, True, 10, False, TC),
             flash_case(1, 8, 8, 2048, 64, bf, False, 11, False, TC),
             flash_case(1, 4, 4, 65, 128, bf, True, 12, False, TC),
             flash_case(1, 8, 2, 1, 128, bf, False, 13, False, TC),
             # the scalar route in bf16
             flash_case(1, 8, 4, 300, 32, bf, True, 14, False, "scalar"),
             # path (g): the ring's past shard (full) and diagonal shard
             # (causal) at a 4096-token shard, Ulysses' local attention
             # over the whole 8192 tokens for half the heads
             flash_case(1, 16, 8, 4096, 128, bf, False, 15, True, TC),
             flash_case(1, 16, 8, 4096, 128, bf, True, 16, True, TC),
             flash_case(1, 8, 4, 8192, 128, bf, True, 17, True, TC),
             # path (i): a position's local block at dp 2 x tp 2 of (c)
             flash_case(1, 8, 4, 2048, 128, bf, True, 18, True, TC),
             # the scalar f32 route at (b)'s and (h)'s shortest and
             # longest prompts (bitwise repeatable: the backward kernels
             # and the ring rely on the lse), and the f32 SP parity's
             # past shard (full, 512 tokens)
             flash_case(1, 16, 8, 85, 128, f32, True, 19, True, "scalar"),
             flash_case(1, 16, 8, 225, 128, f32, True, 20, True, "scalar",
                        repeat=True),
             flash_case(1, 16, 8, 512, 128, f32, False, 40, True, "scalar"),
             # the overlap smoke's llama-tiny: B2 H4 KVH2 S64, head dim 16
             flash_case(2, 4, 2, 64, 16, f32, True, 41, False, "scalar"),
             # the control smoke's llama-tiny: S16, one partial kv tile
             flash_case(2, 4, 2, 16, 16, f32, True, 43, False, "scalar")]
    return {"cases": cases, "path_g": [14, 15, 16], "path_i": 17,
            "scalar_f32": [18, 19, 5, 20, 4], "overlap_smoke": 21,
            "control_smoke": 22}


def fwd_bwd_ms(fwd, args, grad) -> tuple:
    """Device ms of one call of a differentiable library function: the
    forward alone, and the forward with its backward (torch.autograd.grad
    of the output against ``grad``), each captured into a CUDA graph as
    in :func:`time_ms`. Their difference is the backward's time."""
    def both(*a):
        leaves = [t.detach().requires_grad_() for t in a]
        torch.autograd.grad(fwd(*leaves), leaves, grad)

    sets = input_sets(args)
    return time_ms(fwd, sets, iters=8), time_ms(both, sets, iters=8)


def rmsnorm_bwd_case(rows: int, d: int, dtype, seed: int,
                     timed: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    w = torch.rand(d, generator=g, device="cuda") + 0.5
    dy = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
    dx, dw = rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    want_dx, want_dw = rmsnorm_bwd_reference(x, w, dy)
    what = f"rmsnorm_bwd {rows}x{d} {dtype}"
    res = {"rows": rows, "d": d, "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max_err(dx, want_dx, *TOL[("rmsnorm", dtype)],
                                  what + " dx"),
           "dw_max_abs_err": max_err(dw, want_dw, *TOL[("dw", None)],
                                     what + " dw")}
    again = rmsnorm_bwd(x, w, dy)
    require(torch.equal(again[0], dx) and torch.equal(again[1], dw),
            what + ": two calls differ")
    res["deterministic"] = True
    if timed:
        sets = input_sets((x, w, dy), out_bytes=x.numel() * x.element_size())
        lib_f, lib_fb = fwd_bwd_ms(
            lambda a, b: F.rms_norm(a, (d,), b, 1e-5), (x, w.to(dtype)), dy)
        bound, by = rmsnorm_bound(rows, d, dtype, backward=True)
        res.update(
            ms=time_ms(lambda a, b, c: rmsnorm_bwd(a, b, c), sets),
            plain_ms=time_ms(lambda a, b, c: rmsnorm_bwd_reference(a, b, c),
                             sets),
            library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
            bound_ms=bound, bound_by=by)
    return res


def phase_rmsnorm_bwd() -> dict:
    bf, f32 = torch.bfloat16, torch.float32
    cases = [rmsnorm_bwd_case(4096, 2048, bf, 11, True),   # path (c)
             rmsnorm_bwd_case(4096, 2048, f32, 12, False),
             rmsnorm_bwd_case(1000, 2048, bf, 13, False),  # ragged
             rmsnorm_bwd_case(1000, 2048, f32, 14, False),
             rmsnorm_bwd_case(200, 2048, f32, 15, False),  # train parity
             rmsnorm_bwd_case(128, 64, f32, 16, False),    # overlap smoke
             rmsnorm_bwd_case(32, 64, f32, 17, False)]     # control smoke
    return {"cases": cases}


def merge_lse(out, lse, o2, l2):
    """Two shards' partial outputs merged through their lse in f32, as
    ring attention merges them: the global (out, lse)."""
    m = torch.maximum(lse, l2)
    a, b = torch.exp(lse - m), torch.exp(l2 - m)
    return ((out.float() * a + o2.float() * b) / (a + b)).to(out.dtype), \
        m + torch.log(a + b)


def flash_bwd_case(b, h, kvh, s, d, dtype, causal, seed, timed,
                   need_route=None, merged=False) -> dict:
    """``merged``: out and lse are the global ones over this kv shard and
    a second (diagonal, causal) one, as ring attention hands them to a
    past shard's pair backward."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    if merged:
        k2 = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
        v2 = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
        out, lse = merge_lse(out, lse,
                             *flash_attention_lse(q, k2, v2, causal=True))
        del k2, v2
    got = flash_attention_shard_grads(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    what = f"flash_bwd {(b, h, kvh, s, d)} {dtype} causal={causal}"
    route = kernel_route("flash_bwd_dkv", d, dtype)
    dq_route = kernel_route("flash_bwd_dq", d, dtype)
    require(need_route in (None, route),
            f"{what}: K4 route {route}, expected {need_route}")
    require(need_route in (None, dq_route),
            f"{what}: K5 route {dq_route}, expected {need_route}")
    rtol, atol = TOL[("flash", dtype)]
    res = {"shape": [b, h, kvh, s, d], "dtype": str(dtype).split(".")[-1],
           "causal": causal, "merged_lse": merged, "dkv_route": route,
           "dq_route": dq_route,
           "fwd_route": kernel_route("flash_fwd", d, dtype)}
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        res[name + "_max_abs_err"] = max_err(gt, wt, rtol, atol,
                                             f"{what} {name}")
    del want
    again = flash_attention_shard_grads(q, k, v, out, lse, do, causal)
    require(all(torch.equal(a, c) for a, c in zip(again, got)),
            what + ": two calls differ")
    res["deterministic"] = True
    del again, got
    if timed:
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        sets = input_sets((q, k, v, do, lse, delta),
                          out_bytes=2 * q.numel() * q.element_size())
        lib_f, lib_fb = fwd_bwd_ms(
            lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=causal, enable_gqa=True), (q, k, v), do)
        bounds = {name: flash_bound(name, b, h, kvh, s, d, causal, dtype)
                  for name in ("flash_bwd_dkv", "flash_bwd_dq")}
        res.update(
            dkv_ms=time_ms(lambda *a: flash_bwd_dkv(*a, causal=causal),
                           sets, iters=4),
            dq_ms=time_ms(lambda *a: flash_bwd_dq(*a, causal=causal),
                          sets, iters=4),
            plain_ms=time_ms(lambda *a: flash_attention_bwd_reference(
                *a, causal=causal), [(q, k, v, out, lse, do)], iters=2),
            library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
            dkv_bound_ms=bounds["flash_bwd_dkv"][0],
            dkv_bound_by=bounds["flash_bwd_dkv"][1],
            dq_bound_ms=bounds["flash_bwd_dq"][0],
            dq_bound_by=bounds["flash_bwd_dq"][1])
    return res


def phase_flash_bwd() -> dict:
    bf, f32 = torch.bfloat16, torch.float32
    cases = [flash_bwd_case(2, 16, 8, 2048, 128, bf, True, 21, True, TC),
             flash_bwd_case(2, 16, 8, 2048, 128, bf, False, 22, False, TC),
             flash_bwd_case(1, 32, 8, 2048, 128, bf, True, 23, False, TC),
             flash_bwd_case(1, 16, 8, 2048, 128, f32, True, 24, True),
             flash_bwd_case(1, 16, 8, 1000, 128, bf, True, 25, False),
             flash_bwd_case(1, 16, 8, 1000, 128, f32, False, 26, False),
             flash_bwd_case(1, 16, 8, 200, 128, f32, True, 27, True),
             # K4's and K5's tensor-core routes at their edges (see
             # phase_flash)
             flash_bwd_case(1, 4, 4, 1, 64, bf, True, 28, False, TC),
             flash_bwd_case(1, 8, 4, 65, 64, bf, False, 29, False, TC),
             flash_bwd_case(1, 8, 2, 1000, 64, bf, True, 30, False, TC),
             flash_bwd_case(1, 8, 8, 2048, 64, bf, False, 31, False, TC),
             flash_bwd_case(1, 4, 4, 65, 128, bf, True, 32, False, TC),
             flash_bwd_case(1, 8, 2, 1, 128, bf, False, 33, False, TC),
             # K4's and K5's scalar routes in bf16
             flash_bwd_case(1, 4, 2, 130, 32, bf, True, 34, False,
                            "scalar"),
             # path (g): the ring's past-shard pair (full, driven by the
             # global lse), its diagonal pair, Ulysses' local backward;
             # the ring's f32 parity shape
             flash_bwd_case(1, 16, 8, 4096, 128, bf, False, 35, True, TC,
                            merged=True),
             flash_bwd_case(1, 16, 8, 4096, 128, bf, True, 36, True, TC),
             flash_bwd_case(1, 8, 4, 8192, 128, bf, True, 37, True, TC),
             flash_bwd_case(1, 16, 8, 512, 128, f32, False, 38, True,
                            merged=True),
             # path (i): a position's local block at dp 2 x tp 2 of (c)
             flash_bwd_case(1, 8, 4, 2048, 128, bf, True, 39, True, TC),
             # the overlap smoke's llama-tiny (see phase_flash)
             flash_bwd_case(2, 4, 2, 64, 16, f32, True, 42, False,
                            "scalar"),
             # the control smoke's llama-tiny: S16 (see phase_flash)
             flash_bwd_case(2, 4, 2, 16, 16, f32, True, 44, False,
                            "scalar")]
    return {"cases": cases, "path_g": [14, 15, 16], "path_i": 18,
            "scalar_f32": [6, 17, 3], "overlap_smoke": 19,
            "control_smoke": 20}


def decode_attn_case(b, h, kvh, t, d, pos, dtype, seed, timed) -> dict:
    """K6 against its plain version over a whole cache of ``t``
    positions with the query at ``pos``, as the graphed step calls it:
    error, two calls bitwise equal; timed, its device ms beside the bound
    (the live K/V and q read, out written, once), the plain version's
    and SDPA's over the live prefix."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, 1, d, generator=g, device="cuda").mul(2).to(dtype)
    k = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, t, d, generator=g, device="cuda").to(dtype)
    q_pos = torch.tensor([pos], device="cuda")
    got = cached_attention(q, k, v, q_pos)
    torch.cuda.synchronize()
    what = f"decode attention {(b, h, kvh, t, d)} pos {pos} {dtype}"
    res = {"shape": [b, h, kvh, t, d], "pos": pos,
           "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max_err(got, cached_attention_reference(
               q, k, v, q_pos), *TOL[("decode", dtype)], what)}
    require(torch.equal(cached_attention(q, k, v, q_pos), got),
            what + ": two calls differ")
    if timed:
        live = pos + 1
        bound, by = decode_attn_bound(b, h, kvh, d, pos, dtype)
        sets = input_sets((q, k, v, q_pos),
                          out_bytes=q.numel() * q.element_size())
        res.update(
            ms=time_ms(cached_attention, sets),
            plain_ms=time_ms(cached_attention_reference, sets[:1], iters=3),
            library_ms=time_ms(lambda a, kk, vv, _p: (
                F.scaled_dot_product_attention(
                    a, kk[:, :, :live], vv[:, :, :live], enable_gqa=True)),
                sets),
            bound_ms=bound, bound_by=by)
    return res


def phase_decode_attn() -> dict:
    bf, f32 = torch.bfloat16, torch.float32
    cases = [decode_attn_case(4, 32, 8, 640, 128, 540, bf, 51, True),  # (a)
             # the decode cell's step (B 128, Mistral's heads, 1152
             # positions) at its shortest, mean and longest live prefix
             decode_attn_case(128, 32, 8, 1152, 128, 777, bf, 52, True),
             decode_attn_case(128, 32, 8, 1152, 128, 960, bf, 53, True),
             decode_attn_case(128, 32, 8, 1152, 128, 1144, bf, 54, True),
             # the prefill cell's decode steps (B 16, 8320 positions)
             decode_attn_case(16, 32, 8, 8320, 128, 8250, bf, 55, True),
             # llama-tiny in f32, and llama3-1b's f32 heads
             decode_attn_case(2, 4, 2, 128, 16, 37, f32, 56, False),
             decode_attn_case(1, 16, 8, 640, 128, 600, f32, 57, False)]
    return {"cases": cases}


# The latent-attention, routed-expert and KDA models' kernels and device
# counters (K7, G1, K8, K9), which no Llama path launches.
NOT_ON_LLAMA = {"mla_decode": 0, "moe_gemm_up": 0, "moe_gemm_down": 0,
                "moe_gemm_many": 0, "moe_combine": 0, "kda_recurrent": 0,
                **{name: 0 for name in _native.DEVICE_COUNTERS}}


def mla_decode_case(b, t, pos, seed, timed, heads=mld.HEADS) -> dict:
    """K7 against its plain version over a latent cache of ``t``
    positions (16 or 32 heads of 512 + 64, bf16) with the query at
    ``pos``, as the graphed step calls it: error, two calls bitwise equal;
    timed, its device ms beside its bound (the live cache rows, q and
    out, once: bytes) and the plain version's. No library kernel takes
    16 or 32 heads over one shared 576-wide key."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, heads, mld.LATENT + mld.ROPE, generator=g,
                    device="cuda").bfloat16()
    ckv = torch.randn(b, t, mld.LATENT + mld.ROPE, generator=g,
                      device="cuda").bfloat16()
    q_pos = torch.tensor([pos], device="cuda")
    scale = 1 / math.sqrt(192)

    def k7(a, c, p):
        return mld.mla_decode(a, c, p, scale, mld.LATENT)

    def plain(a, c, p):
        return mld.mla_decode_reference(a, c, p, scale, mld.LATENT)

    got = k7(q, ckv, q_pos)
    torch.cuda.synchronize()
    want = plain(q, ckv, q_pos)
    what = f"latent decode {(b, t)} pos {pos}"
    res = {"shape": [b, heads, t, mld.LATENT + mld.ROPE], "pos": pos,
           "dtype": "bfloat16",
           "max_abs_err": max_err(got, want, TOL[("decode", torch.bfloat16)][0],
                                  2 ** -8 * float(want.float().abs().max()),
                                  what)}
    require(torch.equal(k7(q, ckv, q_pos), got), what + ": two calls differ")
    if timed:
        bound, by = mla_decode_bound(
            b, pos, MOONLIGHT if heads == mld.HEADS else rlk.mla_config(KIMI))
        sets = input_sets((q, ckv, q_pos), out_bytes=got.numel() * 2)
        res.update(ms=time_ms(k7, sets),
                   plain_ms=time_ms(plain, sets[:1], iters=3),
                   library_ms=None, bound_ms=bound, bound_by=by)
    return res


def grouped_gemm_case(n, seed, timed) -> dict:
    """G1 (``moe.grouped_swiglu``: ``align``, the two grouped GEMMs, the
    pick sum) against the per-expert loop at Moonlight's widths (64
    experts of 2048 → 1408, 6 a token) over ``n`` tokens: error, two calls
    bitwise equal, the many-row instance's launches (two a call where
    ``block_rows`` picks it, else none); timed, the call's device ms
    beside its bound (``grouped_swiglu_bound``) and the plain loop's wall
    ms, and where the many-row instance runs each GEMM alone on
    ``align``'s layout beside the benchmark's bound of it."""
    c = rlm.dims(MOONLIGHT)
    e, d, f, k = c.e, c.d, c.f, c.k
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, generator=g, device="cuda").bfloat16()
    router = (torch.randn(d, e, generator=g, device="cuda") / d ** 0.5
              ).bfloat16()
    ids, wts = moe.route(x, router, torch.zeros(e, device="cuda"), k, 2.446)
    ws = [(torch.randn(e, d, f, generator=g, device="cuda") / d ** 0.5
           ).bfloat16(),
          (torch.randn(e, d, f, generator=g, device="cuda") / d ** 0.5
           ).bfloat16(),
          (torch.randn(e, f, d, generator=g, device="cuda") / f ** 0.5
           ).bfloat16()]
    many = _native.launches()["moe_gemm_many"]
    got = moe.grouped_swiglu(x, ids, wts, *ws)
    torch.cuda.synchronize()
    many = _native.launches()["moe_gemm_many"] - many
    bm = moe.block_rows(n * k, e)
    what = f"grouped swiglu {n} tokens"
    require(many == (2 if bm == moe.MANY_ROWS else 0),
            f"{what}: {many} launches of the many-row instance")
    want = moe.grouped_swiglu_reference(x, ids, wts, *ws)
    res = {"shape": [n, k, e, d, f], "dtype": "bfloat16",
           "block_rows": bm,
           "max_abs_err": max_err(got, want, TOL[("decode", torch.bfloat16)][0],
                                  2 ** -8 * float(want.float().abs().max()),
                                  what)}
    del want
    require(torch.equal(moe.grouped_swiglu(x, ids, wts, *ws), got),
            what + ": two calls differ")
    if timed:
        bound, by = grouped_swiglu_bound(n)
        sets = input_sets((x, ids, wts, *ws), out_bytes=x.numel() * 2)
        # The plain loop picks each expert's tokens with a host
        # synchronisation, so it cannot be captured: timed eagerly.
        # A 65,536-token call allocates ~3.5 GB of its own: few in a graph.
        res.update(ms=time_ms(moe.grouped_swiglu, sets,
                              iters=24 if n <= 4096 else 4),
                   plain_ms=eager_ms(lambda: moe.grouped_swiglu_reference(
                       x, ids, wts, *ws), 2),
                   library_ms=None, bound_ms=bound, bound_by=by)
    if timed and bm == moe.MANY_ROWS:
        # Each GEMM alone (a graph of 24 launches; one set of inputs moves
        # more than four times the L2).
        dest, row_slot, block_expert = moe.align(ids, e, bm)
        cap = row_slot.numel()
        row_w = torch.zeros(cap, device="cuda")
        row_w.scatter_(0, dest.reshape(-1), wts.reshape(-1).float())
        h = torch.empty(cap, f, dtype=x.dtype, device="cuda")
        out = torch.empty(cap, d, dtype=x.dtype, device="cuda")
        up_ms = time_ms(lambda: moe.gemm_up(x, row_slot, block_expert, k,
                                            ws[0], ws[1], h), [()])
        down_ms = time_ms(lambda: moe.gemm_down(h, block_expert, row_w,
                                                ws[2], out), [()])
        up_bound, down_bound = grouped_gemm_bounds(n)
        res.update(up_ms=up_ms, up_bound_ms=up_bound, down_ms=down_ms,
                   down_bound_ms=down_bound, gemms_ms=up_ms + down_ms,
                   gemms_bound_ms=up_bound + down_bound,
                   gemms_share_of_bound=(up_bound + down_bound)
                   / (up_ms + down_ms))
    return res


def combine_case(n, seed, timed, one_expert=False) -> dict:
    """K8 (``moe.combine``) against the plain combine
    (``moe.combine_reference``: a gather, an f32 widening and an f32 add
    a pick, then the shared add, in torch) over ``align``'s layout of n
    tokens' seeded picks at Moonlight's widths (6 of 64 experts, d 2048),
    the down GEMM's rows random: bitwise equal, with and without the
    shared row, and two calls bitwise equal; timed, its device ms beside
    its bound (``combine_bound``) and the plain combine's device ms."""
    c = rlm.dims(MOONLIGHT)
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.rand(n, c.e, generator=g, device="cuda").argsort(1)[:, :c.k]
    if one_expert:
        ids[:] = 5
    bm = moe.block_rows(n * c.k, c.e)
    dest, row_slot, _ = moe.align(ids, c.e, bm)
    out = torch.randn(row_slot.numel(), c.d, generator=g,
                      device="cuda").bfloat16()
    add = torch.randn(n, c.d, generator=g, device="cuda").bfloat16()
    got = moe.combine(out, dest, add)
    what = f"moe combine {n} tokens" + (" on one expert" if one_expert
                                        else "")
    require(torch.equal(got, moe.combine_reference(out, dest, add)),
            what + ": not bitwise the plain combine")
    require(torch.equal(moe.combine(out, dest),
                        moe.combine_reference(out, dest)),
            what + ": not bitwise the plain combine without the shared row")
    require(torch.equal(moe.combine(out, dest, add), got),
            what + ": two calls differ")
    res = {"shape": [n, c.k, c.d], "dtype": "bfloat16", "block_rows": bm,
           "one_expert": one_expert, "max_abs_err": 0.0}
    if timed:
        bound, by = combine_bound(n)
        sets = input_sets((out, dest, add), out_bytes=add.numel() * 2)
        # A prefill chunk's call allocates 0.26 GB (the plain one ~1.3
        # GB) of its own: fewer in a graph.
        iters = 24 if n <= 4096 else 8
        res.update(ms=time_ms(moe.combine, sets, iters),
                   plain_ms=time_ms(moe.combine_reference, sets, iters),
                   library_ms=None, bound_ms=bound, bound_by=by)
    return res


def kda_case(b, t, seed, timed) -> dict:
    """K9 (``kda.kda_recurrent``: the short convolution, SiLU, the
    l2norms and the recurrence) against its plain version
    (``kda.kda_reference``) over b sequences of t tokens at Kimi Linear's
    32 heads of 128, from random raw rows and a random f32 state: o's and
    the state's errors, the raw rows left, two launches from the same
    states bitwise equal; timed, its device ms beside its bound
    (``kda_bound``) and the plain version's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = 32 * kda.DIM
    x = torch.randn(b, t, 3 * c, generator=g, device="cuda").bfloat16()
    w = (torch.randn(3 * c, kda.TAPS, generator=g, device="cuda") / 2
         ).bfloat16()
    conv = torch.randn(b, kda.TAPS - 1, 3 * c, generator=g,
                       device="cuda").bfloat16()
    log_a = -0.7 * torch.rand(b, t, 32, kda.DIM, generator=g, device="cuda")
    beta = torch.rand(b, t, 32, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(b, 32, kda.DIM, kda.DIM, generator=g,
                           device="cuda")
    scale = kda.DIM ** -0.5
    st, st2, plain = s0.clone(), s0.clone(), s0.clone()
    c1, c2, cp = conv.clone(), conv.clone(), conv.clone()
    got = kda.kda_recurrent(x, w, c1, log_a, beta, st, scale)
    again = kda.kda_recurrent(x, w, c2, log_a, beta, st2, scale)
    torch.cuda.synchronize()
    what = f"KDA recurrence {(b, t)}"
    require(torch.equal(got, again) and torch.equal(st, st2)
            and torch.equal(c1, c2), what + ": two launches differ")
    want = kda.kda_reference(x, w, cp, log_a, beta, plain, scale)
    require(torch.equal(c1, cp), what + ": the raw rows left differ")
    # o in bf16: a bf16 step of its largest magnitude; the state in f32,
    # summed in another order (tests/test_torch_kimi_linear.py).
    res = {"shape": [b, t, 32, kda.DIM], "dtype": "bfloat16",
           "max_abs_err": max_err(got, want, 2 ** -7,
                                  2 ** -8 * float(want.float().abs().max()),
                                  what),
           "state_max_abs_err": max_err(st, plain, 1e-4, 1e-5,
                                        what + " state")}
    if timed:
        bound, by = kda_bound(b, t)

        def k9(*a):
            return kda.kda_recurrent(*a, scale)

        sets = input_sets((x, w, c1, log_a, beta, st),
                          out_bytes=got.numel() * 2)
        res.update(ms=time_ms(k9, sets, iters=24 if t == 1 else 2),
                   plain_ms=eager_ms(lambda: kda.kda_reference(
                       x, w, cp.clone(), log_a, beta, plain.clone(), scale),
                       1),
                   library_ms=None, bound_ms=bound, bound_by=by)
    return res


def phase_mla_moe_kernels() -> dict:
    """K7, G1 and K8 at the decode-mla cell's shapes: K7 over its
    4224-long cache (B 64) at the mean and last positions, G1 over a
    decode step's 64 tokens (16-row blocks) and a prefill chunk's 65,536
    (128-row blocks, the many-row instance on TMA and wgmma), K8 over a
    decode step's 64 tokens and a 62,400-token chunk's; each also small
    or skewed. Then the decode-hybrid cell's: K7 at 32 heads over its
    2048-long cache (B 128), K9 at a decode step's 128 sequences of one
    token and a prefill chunk's 40 of 1,600. Launches: one K7, one K9 a
    call, one of each GEMM and one K8 a call."""
    _native.reset_launches()
    k7 = [mla_decode_case(64, 4224, 4033, 61, True),
          mla_decode_case(64, 4224, 4223, 62, True),
          mla_decode_case(3, 300, 150, 63, False)]
    g1 = [grouped_gemm_case(64, 64, True),
          grouped_gemm_case(65536, 65, True),
          grouped_gemm_case(5, 66, False)]
    k8 = [combine_case(64, 67, True),
          combine_case(62400, 68, True),
          combine_case(4096, 69, False, one_expert=True)]
    k7_32 = [mla_decode_case(128, 2048, 1800, 70, True, heads=32),
             mla_decode_case(128, 2048, 2047, 71, True, heads=32),
             mla_decode_case(3, 300, 150, 72, False, heads=32)]
    k9 = [kda_case(128, 1, 73, True), kda_case(40, 1600, 74, True),
          kda_case(3, 37, 75, False)]
    torch.cuda.synchronize()
    launches = _native.launches()
    require(launches["kda_recurrent"] >= 2 * len(k9),
            f"K9 launches {launches}")
    require(launches["mla_decode"] >= 2 * (len(k7) + len(k7_32))
            and launches["moe_gemm_up"] == launches["moe_gemm_down"]
            >= 2 * len(g1)
            and launches["moe_combine"] >= 2 * len(g1) + 3 * len(k8),
            f"K7/G1/K8 launches {launches}")
    return {"k7": k7, "g1": g1, "k8": k8, "k7_32": k7_32, "k9": k9}


def expected_launches(cfg, forward_steps: int, prefills: int,
                      decode_steps: int = 0) -> dict:
    """Launches of a serving path: K1 2L + 1 times per forward step, K3
    L times per prefill, K6 L times per cached decode step of
    ``models/llama.py`` (the batcher's paged layers have their own
    product)."""
    return {"rmsnorm_fwd": (2 * cfg.n_layers + 1) * forward_steps,
            "flash_fwd": cfg.n_layers * prefills,
            "rmsnorm_bwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "decode_attn": cfg.n_layers * decode_steps, **NOT_ON_LLAMA}


def expected_train_launches(model, steps: int) -> dict:
    """Launches of each kernel in ``steps`` train steps, read off the
    model: every RMSNorm runs K1 forward and K2 backward, every
    attention K3 forward and K5, K4 backward; with remat the blocks'
    RMSNorms and attentions run their forward a second time."""
    norms = sum(isinstance(m, llama.RMSNorm) for m in model.modules())
    block_norms = sum(isinstance(m, llama.RMSNorm)
                      for m in model.layers.modules())
    attns = sum(isinstance(m, llama.Attention) for m in model.modules())
    again = 1 if model.cfg.remat else 0
    per_step = {"rmsnorm_fwd": norms + again * block_norms,
                "flash_fwd": attns * (1 + again),
                "rmsnorm_bwd": norms, "flash_bwd_dq": attns,
                "flash_bwd_dkv": attns, "decode_attn": 0,
                **NOT_ON_LLAMA}
    return {k: v * steps for k, v in per_step.items()}


def decode_uncaptured(model, prompt, new: int):
    """``generate``'s decode step run uncaptured (``DecodeLoop(capture=
    False)``) on the same prompt: its tokens."""
    b, p = prompt.shape
    cache_len = min(model.cfg.max_seq_len, -(-(p + new) // 128) * 128)
    return llama.DecodeLoop(model, b, cache_len, capture=False).run(prompt,
                                                                    new)


def compare_rows(model, prompt, got, ref, what: str) -> dict:
    """Each row of ``got`` against ``ref`` (B, n), bitwise, else by
    ``_compare_tokens``'s near-tie rule: which of the two held."""
    if torch.equal(got.cpu(), ref.cpu()):
        return {"bitwise": True}
    rows = [_compare_tokens(model, prompt[i].tolist(), got[i].tolist(),
                            ref[i].tolist(), f"{what} row {i}")
            for i in range(got.shape[0])]
    return {"bitwise": False, "near_tie_rule": rows}


def phase_generate_8b() -> dict:
    """Path (a): ``generate``'s prefill eager (K3), its decode steps
    replays of one captured step. Gates: launches exact through the
    replays, determinism, the first token against the no-cache forward,
    teacher-forced agreement; tokens against the same step run
    uncaptured (bitwise, else the near-tie rule, reported); a second
    call captures nothing (the memo); after ``load_state_dict(assign=
    True)`` with other weights a new loop is captured and the tokens
    follow the new weights."""
    cfg = llama.LLAMA3_8B
    b, p, new = 4, 512, 32
    model = llama.Llama(cfg, device="cuda")
    model.load_state_dict(llama.init_params(cfg, seed=0, device="cuda"),
                          assign=True)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p))).cuda()
    captured = graphs.captures()
    llama.generate(model, prompt, 2)            # warm cuBLAS; captures
    require(graphs.captures() == captured + 1,
            f"the first call captured {graphs.captures() - captured} graphs")
    first = llama.generate(model, prompt, 1)

    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    toks = llama.generate(model, prompt, new)
    launches = _native.launches()
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, forward_steps=new, prefills=1,
                             decode_steps=new - 1)
    require(launches == want, f"path (a) launches {launches} != {want}")
    require(graphs.captures() == captured + 1,
            "a call with a memoized loop captured again")

    require(tuple(toks.shape) == (b, new), f"tokens shape {toks.shape}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            "token ids out of range")
    require(bool((toks[:, 0] == first[:, 0]).all()),
            "generate is not deterministic across calls")
    again = llama.generate(model, prompt, new)
    require(torch.equal(again, toks), "two graphed calls differ")
    unc = decode_uncaptured(model, prompt, new)
    vs_uncaptured = compare_rows(model, prompt, toks, unc, "path (a)")
    # The same tokens through the no-cache forward (teacher-forced):
    # the first token comes from the same function as the cached
    # prefill; later ones from the cache path, in bf16.
    with torch.inference_mode():
        seq = torch.cat([prompt, toks[:, :-1]], dim=1)
        logits = model(seq)[:, p - 1:]
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    full = logits.argmax(-1)
    require(bool((full[:, 0] == toks[:, 0]).all()),
            "first token differs from the no-cache forward")
    # Later tokens may flip at bf16 near-ties between the two paths (the
    # cache path casts probs to bf16, K3 keeps them f32); a broken cache
    # path agrees on almost none.
    agree = float((full == toks).float().mean())
    require(agree >= 0.75, f"teacher-forced agreement {agree} < 0.75")
    del logits
    swap = weights_swap(model, prompt, new, toks)
    held = torch.cuda.memory_allocated()
    del model
    require(all(loop.alive for loop in llama._GEN_CACHE.values()),
            "the memo kept a decode loop of the deleted model")
    freed = held - torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    return {"config": cfg.name, "batch": b, "prompt": p, "new_tokens": new,
            "freed_at_del_gb": freed / 1e9,
            "peak_mem_gb": peak / 1e9, "vs_uncaptured": vs_uncaptured,
            "teacher_forced_agreement": agree, "launches": launches,
            "weights_swap": swap}


def weights_swap(model, prompt, new: int, old) -> dict:
    """``load_state_dict(assign=True)`` with other weights moves every
    parameter's storage: the next ``generate`` must capture a new loop
    (a replay of the old graph would read the freed storage) and its
    tokens follow the new weights (the uncaptured step on them)."""
    model.load_state_dict(llama.init_params(model.cfg, seed=1,
                                            device="cuda"), assign=True)
    captured = graphs.captures()
    toks = llama.generate(model, prompt, new)
    require(graphs.captures() == captured + 1,
            "generate after a weights swap did not capture a new loop")
    require(not torch.equal(toks, old), "tokens did not change with the "
                                        "weights")
    unc = decode_uncaptured(model, prompt, new)
    return {"new_capture": True,
            "vs_uncaptured": compare_rows(model, prompt, toks, unc,
                                          "path (a) after the swap")}


def phase_parity(state, cfg) -> dict:
    p = 128
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, p)))
    gpu = llama.Llama(cfg, device="cuda")
    gpu.load_state_dict(state, assign=True)
    with torch.inference_mode():
        lg = gpu(prompt.cuda()).cpu()
    cpu = llama.Llama(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()}, assign=True)
    with torch.inference_mode():
        lc = cpu(prompt)
    del cpu
    err = float((lg - lc).abs().max())
    top1 = float((lg.argmax(-1) == lc.argmax(-1)).float().mean())
    require(err <= PARITY_TOL, f"card vs CPU logits max abs err {err}")
    require(top1 >= 0.99, f"card vs CPU top-1 agreement {top1}")
    return {"config": cfg.name + "/f32", "prompt": p, "max_abs_err": err,
            "tol": PARITY_TOL, "top1_agreement": top1,
            "logit_absmax": float(lc.abs().max())}, gpu


def _compare_tokens(model, prompt: list, got: list, ref: list,
                    what: str) -> dict:
    """``got`` against the reference tokens ``ref`` of one sequence. A
    mismatch is accepted only at a near-tie (top-2 logit gap < 1e-4 at
    that step, from the reference): then compare up to it."""
    if got == ref:
        return {"equal": True}
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    with torch.inference_mode():
        seq = torch.tensor([list(prompt) + ref[:j]]).cuda()
        top2 = model(seq)[0, -1].topk(2).values
    gap = float(top2[0] - top2[1])
    require(gap < 1e-4, f"{what}: token {j} {got[j]} != {ref[j]} "
                        f"with top-2 gap {gap}")
    return {"equal": False, "near_tie_at": j, "gap": gap}


def _compare_to_generate(model, req) -> dict:
    """Tokens of one request against generate() on the same weights."""
    ref = llama.generate(model, torch.from_numpy(req.prompt[None]),
                         req.max_new_tokens).cpu()[0].tolist()
    return {"req": req.id, **_compare_tokens(
        model, req.prompt.tolist(), req.tokens, ref, f"request {req.id}")}


# New tokens a request of paths (b) and (h) decodes (16 before a cut of
# the script's time: it aims at 600-700 s).
SERVE_NEW_TOKENS = 8


def serve_requests(cfg) -> list:
    """The request script of paths (b) and (h): 5 requests, prompts of
    64-256 tokens from ``default_rng(2)``, ``SERVE_NEW_TOKENS`` new
    tokens each."""
    rng = np.random.default_rng(2)
    return [Request(i + 1, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(64, 257))),
                    SERVE_NEW_TOKENS)
            for i in range(5)]


def drive_requests(batcher, reqs) -> None:
    """Four requests, two steps, then the fifth joins mid-run; runs
    until every request finished."""
    for r in reqs[:4]:
        batcher.submit(r)
    batcher.step()
    batcher.step()
    batcher.submit(reqs[4])                           # joins mid-run
    batcher.run()


def phase_batcher(state, cfg, model) -> tuple:
    scfg = ServeConfig.from_llama(cfg)
    pages = pack_llama_params(scfg, llama.params_to_flax(state))
    reqs = serve_requests(cfg)
    batcher = ContinuousBatcher(None, pages, scfg, max_slots=4,
                                device="cuda")
    _native.reset_launches()
    drive_requests(batcher, reqs)
    launches = _native.launches()
    batcher.close()
    want = expected_launches(cfg, forward_steps=sum(
        r.max_new_tokens for r in reqs), prefills=len(reqs))
    require(launches == want, f"path (b) launches {launches} != {want}")
    require(all(len(batcher.finished[r.id].tokens) == SERVE_NEW_TOKENS
                for r in reqs),
            "a request did not finish")
    require(batcher.finished[5].joined_step > 0, "request 5 did not join "
                                                 "mid-run")
    checks = [_compare_to_generate(model, batcher.finished[r.id])
              for r in reqs]
    return {"config": cfg.name + "/f32", "requests": len(reqs),
            "prompts": [int(r.prompt.size) for r in reqs],
            "steps": batcher.step_no,
            "page_bytes_per_step": pages.nbytes(),
            "page_elems": [int(pg.size) for pg in pages.pages],
            "vs_generate": checks, "launches": launches,
            "tokens": {str(r.id): batcher.finished[r.id].tokens
                       for r in reqs}}, pages


def phase_batcher_jit(cfg, model, pages, b: dict) -> dict:
    """(b)'s request script on ``ContinuousBatcher(..., jit_decode=
    True)``: each decode layer step replayed from a graph over pooled
    caches. Gates: every request's tokens (b)'s (the near-tie rule),
    launches as (b)'s, request 5 joining mid-run, at most 4 slots × 16
    layers graphs."""
    scfg = ServeConfig.from_llama(cfg)
    reqs = serve_requests(cfg)
    batcher = ContinuousBatcher(None, pages, scfg, max_slots=4,
                                jit_decode=True, device="cuda")
    _native.reset_launches()
    drive_requests(batcher, reqs)
    launches = _native.launches()
    batcher.close()
    want = expected_launches(cfg, forward_steps=sum(
        r.max_new_tokens for r in reqs), prefills=len(reqs))
    require(launches == want, f"path (b) jit launches {launches} != {want}")
    require(all(len(batcher.finished[r.id].tokens) == SERVE_NEW_TOKENS
                for r in reqs),
            "a request did not finish")
    require(batcher.finished[5].joined_step > 0, "request 5 did not join "
                                                 "mid-run")
    dec = batcher.decoder
    require(0 < dec.graphs <= 4 * cfg.n_layers,
            f"{dec.graphs} graphs for 4 slots x {cfg.n_layers} layers")
    checks = [{"req": r.id, **_compare_tokens(
        model, r.prompt.tolist(), batcher.finished[r.id].tokens,
        b["tokens"][str(r.id)], f"request {r.id} against (b)")}
        for r in reqs]
    return {"config": cfg.name + "/f32", "requests": len(reqs),
            "steps": batcher.step_no, "graphs": dec.graphs,
            "pool_bytes": dec.pool_bytes, "vs_b": checks,
            "launches": launches}


def hf_layout(state: dict, cfg) -> tuple:
    """What an HF checkpoint of the port's state dict ``state`` holds:
    ``LlamaForCausalLM``'s names with every projection and the head as
    (out, in), on the CPU, and a config object with HF's field names."""
    hf_cfg = types.SimpleNamespace(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps, head_dim=cfg.head_dim,
        tie_word_embeddings=False)

    def proj(name):
        return state[name].t().contiguous().cpu()

    sd = {"model.embed_tokens.weight": state["embed"].cpu(),
          "model.norm.weight": state["final_norm.weight"].cpu(),
          "lm_head.weight": proj("lm_head")}
    for i in range(cfg.n_layers):
        hf, ours = f"model.layers.{i}", f"layers.{i}"
        sd.update({
            f"{hf}.input_layernorm.weight":
                state[f"{ours}.attn_norm.weight"].cpu(),
            f"{hf}.self_attn.q_proj.weight": proj(f"{ours}.attn.wq"),
            f"{hf}.self_attn.k_proj.weight": proj(f"{ours}.attn.wk"),
            f"{hf}.self_attn.v_proj.weight": proj(f"{ours}.attn.wv"),
            f"{hf}.self_attn.o_proj.weight": proj(f"{ours}.attn.wo"),
            f"{hf}.post_attention_layernorm.weight":
                state[f"{ours}.mlp_norm.weight"].cpu(),
            f"{hf}.mlp.gate_proj.weight": proj(f"{ours}.mlp.w_gate"),
            f"{hf}.mlp.up_proj.weight": proj(f"{ours}.mlp.w_up"),
            f"{hf}.mlp.down_proj.weight": proj(f"{ours}.mlp.w_down")})
    return sd, hf_cfg


def phase_hf_import(state, cfg) -> dict:
    """(b)'s llama3-1b f32 weights in an HF checkpoint's layout, through
    ``config_from_hf`` and ``from_hf_state_dict``: every tensor bitwise
    the original, the geometry llama3-1b's; then the tied case (no
    ``lm_head.weight``), whose head must be the embedding's transpose."""
    hf_sd, hf_cfg = hf_layout(state, cfg)
    got_cfg = config_from_hf(hf_cfg, name=cfg.name, dtype=cfg.dtype)
    got = from_hf_state_dict(got_cfg, hf_sd)
    require(dataclasses.replace(got_cfg, dtype=llama.LLAMA3_1B.dtype)
            == llama.LLAMA3_1B, f"imported geometry {got_cfg}")
    require(got_cfg == cfg, f"imported config {got_cfg} != {cfg}")
    require(set(got) == set(state), "imported names "
            f"{sorted(set(got) ^ set(state))} differ")
    for name, want in state.items():
        t = got[name]
        require(t.dtype == want.dtype and t.shape == want.shape
                and torch.equal(t, want.cpu()),
                f"imported {name} is not bitwise the original")
    nbytes = sum(t.numel() * t.element_size() for t in got.values())
    del got
    del hf_sd["lm_head.weight"]
    tied = from_hf_state_dict(got_cfg, hf_sd)
    require(torch.equal(tied["lm_head"], tied["embed"].t()),
            "tied checkpoint: lm_head is not embed.T")
    require(torch.equal(tied["embed"], state["embed"].cpu()),
            "tied checkpoint: embed changed")
    return {"config": cfg.name + "/f32", "tensors": len(state),
            "bytes": nbytes, "bitwise_equal": True,
            "geometry": {f.name: getattr(got_cfg, f.name)
                         for f in dataclasses.fields(got_cfg)
                         if f.name != "dtype"}}


# One rank of path (h): (b)'s weights rebuilt, taken through the HF
# import, packed into f32 pages; the kernels loaded and cuBLAS up before
# the world, so no rank compiles while its peer waits in a gather; then
# (b)'s request script on a world-2 ContinuousBatcher over the emu ring.
# The bytes that crossed the ring are read from the engine's flight
# recorder (drained again after close, when every gather has landed):
# wire_tx sums what this rank sent, land what landed in its gather
# windows.
SERVE_RANK = r"""
import dataclasses, json, sys
import torch
import chip_smoke as cs
from rocnrdma_tpu_torch import telemetry
from rocnrdma_tpu_torch.collectives.world import RingWorld
from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.models.convert import (config_from_hf,
                                               from_hf_state_dict)
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher
from rocnrdma_tpu_torch.serving.model import ServeConfig, pack_llama_params
from rocnrdma_tpu_torch.transport.engine import Engine, telemetry_dropped
from rocnrdma_tpu_torch.utils.trace import trace

rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.set_device(0)
cfg1 = dataclasses.replace(llama.LLAMA3_1B, dtype=torch.float32)
hf_sd, hf_cfg = cs.hf_layout(llama.init_params(cfg1, seed=1, device="cuda"),
                             cfg1)
torch.cuda.empty_cache()
cfg = config_from_hf(hf_cfg, name=cfg1.name, dtype=torch.float32)
state = from_hf_state_dict(cfg, hf_sd)
del hf_sd
scfg = ServeConfig.from_llama(cfg)
pages = pack_llama_params(scfg, llama.params_to_flax(state))
del state
for name in ("rmsnorm_fwd", "flash_fwd"):
    _native.library(name)
x = torch.ones(64, 64, device="cuda")
float((x @ x).sum())

world = RingWorld(Engine("emu"), rank, 2, port, timeout_ms=120000)
batcher = ContinuousBatcher(world, pages, scfg, max_slots=4, device="cuda")
reqs = cs.serve_requests(cfg)
telemetry.reset()
trace.reset()
_native.reset_launches()
cs.drive_requests(batcher, reqs)
launches = _native.launches()
events = telemetry.timeline()
frac = telemetry.overlap_fraction(events, span="serve.compute")
st = batcher.streamer.stats()
batcher.close()
events += telemetry.drain()
wire = {name: sum(e.arg for e in events if e.name == name)
        for name in ("wire_tx", "land")}
out = {"rank": rank, "link_tier": world.link_tier,
       "steps": batcher.step_no,
       "tokens": {str(r.id): batcher.finished[r.id].tokens for r in reqs},
       "launches": launches, "depth": batcher.streamer.depth,
       "pages_fetched": st["pages"], "gather_bytes": st["bytes"],
       "wire_tx_bytes": wire["wire_tx"], "landed_bytes": wire["land"],
       "kv_pages": trace.counter("serve.kv_pages"),
       "overlap_fraction": frac["overlap_fraction"],
       "wire_events": frac["wire_events"],
       "telemetry_dropped": telemetry_dropped(),
       "pending_async": world.pending_async}
world.close()
print(json.dumps(out), flush=True)
"""


def expected_serve(cfg, sizes: list, reqs, steps: int, depth: int,
                   rank: int) -> dict:
    """What path (h)'s rank ``rank`` must count, from the shapes. Every
    step gathers every page, and the stream ends ``depth - 1`` pages into
    the next cycle. The ring at world 2 lands the peer's half of each
    page (ceil(n/2) elements on rank 0, floor(n/2) on rank 1) and sends
    this rank's own half. Each join broadcasts one KV page per layer,
    2 x n_kv_heads x prompt x head_dim f32, and one meta element, as a
    world-2 allreduce: each rank sends half on the way out and folds the
    other half back, the whole page. The request's home rank (id % 2)
    runs its prefill (K3 once per layer); every rank runs K1 2L+1 times
    per forward step it computes: 16 for a request at home, 15
    elsewhere."""
    order = sizes * steps + sizes[:depth - 1]
    peer = [(n + 1) // 2 if rank == 0 else n // 2 for n in order]
    home = [r for r in reqs if r.id % 2 == rank]
    fwd = sum(r.max_new_tokens - (0 if r.id % 2 == rank else 1)
              for r in reqs)
    kv = [2 * cfg.n_kv_heads * int(r.prompt.size) * cfg.head_dim
          for r in reqs]
    kv_bytes = 4 * sum(cfg.n_layers * n + 1 for n in kv)
    return {"pages_fetched": len(order), "gather_bytes": 4 * sum(order),
            "landed_bytes": 4 * sum(peer),
            "wire_tx_bytes": 4 * (sum(order) - sum(peer)) + kv_bytes,
            "kv_pages": len(reqs) * (cfg.n_layers + 1),
            "launches": expected_launches(cfg, forward_steps=fwd,
                                          prefills=len(home))}


def phase_serve_two_slice(cfg, b: dict) -> dict:
    """Path (h): two rank processes, each (b)'s weights through the HF
    import, serve (b)'s request script over a world-2 emu ring with
    prefetch. Gates: tokens equal on both ranks and to (b)'s, the same
    number of steps, launches, gathered and broadcast bytes exactly as
    the shapes say, the CMA link, no handle left."""
    port = free_port() + 100
    env = {"TDR_TELEMETRY": "1", "TDR_TELEMETRY_RING": str(1 << 21),
           "TDR_TRACE_RING": str(1 << 18)}
    ranks = run_rank_procs(
        [[sys.executable, "-c", SERVE_RANK, str(r), str(port)]
         for r in range(2)], "path (h)", env=env)
    res = [lines[-1] for lines in ranks]
    reqs = serve_requests(cfg)
    for r, got in enumerate(res):
        require(got["tokens"] == b["tokens"], f"path (h) rank {r} tokens "
                f"{got['tokens']} != path (b)'s {b['tokens']}")
        require(got["steps"] == b["steps"], f"path (h) rank {r} ran "
                f"{got['steps']} steps, path (b) {b['steps']}")
        want = expected_serve(cfg, b["page_elems"], reqs, got["steps"],
                              got["depth"], r)
        for key, val in want.items():
            require(got[key] == val, f"path (h) rank {r} {key} {got[key]} "
                    f"!= {val}")
        require(got["link_tier"] == "cma", f"path (h) rank {r} link tier "
                f"{got['link_tier']}")
        require(got["pending_async"] == 0, f"path (h) rank {r} left "
                f"{got['pending_async']} handles")
        require(got["wire_events"] > 0, f"path (h) rank {r}: no wire "
                "events recorded")
        require(got["telemetry_dropped"] == 0, f"path (h) rank {r}: the "
                f"flight recorder dropped {got['telemetry_dropped']} events")
    keys = ("steps", "pages_fetched", "gather_bytes", "landed_bytes",
            "wire_tx_bytes", "kv_pages", "overlap_fraction", "wire_events",
            "telemetry_dropped", "launches")
    return {"config": cfg.name + "/f32", "world": 2, "engine": "emu",
            "link_tier": res[0]["link_tier"], "depth": res[0]["depth"],
            "requests": len(reqs),
            "page_bytes_per_step": b["page_bytes_per_step"],
            "tokens_equal_path_b": True,
            **{f"{k}_by_rank": [got[k] for got in res] for k in keys},
            "launches": {name: sum(got["launches"][name] for got in res)
                         for name in _native.KERNELS}}


def phase_train_1b(policy: str = "full") -> dict:
    """Path (c) under the remat ``policy``."""
    cfg = llama.LLAMA3_1B
    b, s, steps = 2, 2048, 4
    trainer = Trainer(cfg, remat=True, remat_policy=policy, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.step(tokens)]                   # warm
    _native.reset_launches()
    losses += [trainer.step(tokens) for _ in range(steps)]
    launches = _native.launches()
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(trainer.model, steps)
    require(launches == want, f"path (c) launches {launches} != {want}")
    per_step = {k: v // steps for k, v in launches.items()}
    L = cfg.n_layers
    require(per_step == {"rmsnorm_fwd": 4 * L + 1, "flash_fwd": 2 * L,
                         "rmsnorm_bwd": 2 * L + 1, "flash_bwd_dq": L,
                         "flash_bwd_dkv": L, "decode_attn": 0,
                         **NOT_ON_LLAMA},
            f"path (c) launches per step {per_step}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    del trainer
    torch.cuda.empty_cache()
    return {"config": cfg.name + "/bf16/remat", "remat_policy": policy,
            "batch": b, "seq": s, "lr": 3e-4, "weight_decay": 0.1,
            "peak_mem_gb": peak / 1e9, "losses": losses,
            "launches": launches, "launches_per_step": per_step}


def phase_train_1b_dots(c: dict) -> dict:
    """Path (c) with ``remat_policy="dots"``: its model, weights and
    batch, one warm step then 4. Gates: path (c)'s, and each
    step's loss equal to (c)'s in this run (bitwise where the card
    repeats its GEMMs bit for bit, within 1e-5 relative otherwise; the
    policy moves which products are kept, not what they compute), K1-K5
    launches per step equal to (c)'s."""
    out = phase_train_1b("dots")
    n = len(out["losses"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"],
                                                   c["losses"][:n]))
    require(rel <= 1e-5, f"path (c) dots losses {out['losses']} vs "
            f"(c)'s {c['losses'][:n]}")
    require(out["launches_per_step"] == c["launches_per_step"],
            f"path (c) dots launches {out['launches_per_step']} != (c)'s")
    return {**out, "path_c_losses": c["losses"][:n],
            "losses_equal_path_c_bitwise": out["losses"] == c["losses"][:n],
            "loss_max_rel_diff_vs_c": rel,
            "path_c_peak_mem_gb": c["peak_mem_gb"]}


def step_agreement(what: str, got, want, lr: float) -> dict:
    """One AdamW step of two trainers from the same weights on the same
    batch, by parameter name: ``got`` and ``want`` map each name to its
    (parameter, gradient) after the step, ``want`` the reference. Every
    gradient to TRAIN_GRAD_TOL of the reference's largest element, the
    parameters by the rule above TRAIN_LOSS_TOL."""
    worst_grad, worst_param, worst_decided = 0.0, 0.0, 0.0
    far, decided, total = 0, 0, 0
    for name, (pg, gg) in got.items():
        pw, gw = (t.detach().cuda() for t in want[name])
        gmax = gw.abs().max()
        rel = float((gg - gw).abs().max() / gmax.clamp_min(1e-30))
        require(rel <= TRAIN_GRAD_TOL, f"{what} grad {name}: rel err {rel}")
        worst_grad = max(worst_grad, rel)
        diff = (pg.detach() - pw).abs()
        dmax = float(diff.max())
        require(dmax <= 2 * lr + 1e-6,
                f"{what} param {name}: max diff {dmax}")
        worst_param = max(worst_param, dmax)
        mask = (gw.abs() > 1e-2 * gmax) & (gw.abs() > 1e-6)
        if bool(mask.any()):
            dec = float(diff[mask].max())
            require(dec <= TRAIN_DECIDED_TOL,
                    f"{what} param {name}: decided elements differ by {dec}")
            worst_decided = max(worst_decided, dec)
        decided += int(mask.sum())
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    require(decided > 0,
            f"{what}: no parameter's update was decided by its gradient")
    require(far <= total // 10000,
            f"{what}: {far} of {total} params differ > 1e-5")
    return {"grad_max_rel_err": worst_grad, "grad_tol": TRAIN_GRAD_TOL,
            "param_max_abs_diff_after_step": worst_param,
            "param_tol": 2 * lr + 1e-6,
            "decided_params": decided,
            "decided_max_abs_diff": worst_decided,
            "decided_tol": TRAIN_DECIDED_TOL,
            "params_over_1e-5": far, "params": total}


def named_step(model) -> dict:
    return {n: (p, p.grad) for n, p in model.named_parameters()}


def phase_train_parity(state, cfg) -> dict:
    """llama3-1b f32, one Trainer step on the card and on the CPU from
    the same weights: loss, every gradient, then every parameter."""
    b, s, lr = 1, 200, 3e-4
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s + 1)))
    gpu = Trainer(cfg, device="cuda", params=state, learning_rate=lr)
    _native.reset_launches()
    loss_g = gpu.step(tokens)
    launches = _native.launches()
    require(launches == expected_train_launches(gpu.model, 1),
            f"train parity launches {launches}")
    cpu = Trainer(cfg, device="cpu", learning_rate=lr,
                  params={k: v.cpu() for k, v in state.items()})
    loss_c = cpu.step(tokens)
    require(abs(loss_g - loss_c) <= TRAIN_LOSS_TOL,
            f"train loss card {loss_g} vs CPU {loss_c}")
    agree = step_agreement("card vs CPU", named_step(gpu.model),
                           named_step(cpu.model), lr)
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"config": cfg.name + "/f32", "batch": b, "seq": s,
            "loss_card": loss_g, "loss_cpu": loss_c,
            "loss_tol": TRAIN_LOSS_TOL, "launches": launches, **agree}


def compute_mode() -> str:
    try:
        return nvidia_smi("compute_mode")
    except (OSError, subprocess.SubprocessError) as err:
        return f"unknown ({err})"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cuda_h_enums() -> dict:
    """The enum values hbm/cuda.py passes to libcuda, read from this
    host's cuda.h: the run fails where they differ."""
    text = (Path(_native.nvcc()).parent.parent / "include"
            / "cuda.h").read_text()
    out = {}
    for name in ("CU_DEVICE_ATTRIBUTE_DMA_BUF_SUPPORTED",
                 "CU_POINTER_ATTRIBUTE_MEMORY_TYPE",
                 "CU_POINTER_ATTRIBUTE_RANGE_START_ADDR",
                 "CU_POINTER_ATTRIBUTE_RANGE_SIZE", "CU_MEMORYTYPE_DEVICE",
                 "CU_MEM_RANGE_HANDLE_TYPE_DMA_BUF_FD"):
        m = re.search(rf"\b{name}\s*=\s*(0x[0-9a-fA-F]+|\d+)", text)
        require(m is not None, f"{name} not found in cuda.h")
        out[name] = int(m.group(1), 0)
        require(out[name] == getattr(hcuda, name),
                f"{name} is {out[name]} in cuda.h, "
                f"{getattr(hcuda, name)} in hbm/cuda.py")
    return out


def _write_into_device(e, exporter, t, va, nbytes, checks) -> bool:
    """Verbs: a dma-buf MR over the device range, a loopback RDMA WRITE
    from a host MR into it, read back by torch; then release() with the
    pin live must invalidate the MR. False where the HCA's driver
    refuses the dma-buf (recorded, not counted as passed)."""
    mgr = RegistrationManager(e, exporter)
    try:
        reg = mgr.register(va, nbytes)   # dma-buf, else the veto raises
    except (HbmError, eng.TransportError) as err:
        checks["verbs_write_into_hbm"] = f"not run: registration refused: " \
                                         f"{err}"
        mgr.close()
        return False
    a, b = eng.loopback_pair(e, free_port())
    n = 1 << 20
    src = (torch.arange(n, dtype=torch.int32) * 7 % 251).to(torch.uint8)
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, n, wr_id=1)
        require(a.wait(1).ok, "verbs RDMA WRITE into device memory failed")
        torch.cuda.synchronize()
        require(torch.equal(t[:n].cpu(), src),
                "bytes written over RDMA differ in device memory")
        checks["verbs_write_into_hbm"] = "ran: 1 MiB, bitwise"
        exporter.release(va)
        try:
            a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, n, wr_id=2)
            status = a.wait(2).status
        except eng.TransportError as err:
            status = str(err)
        require(status != eng.WC_SUCCESS,
                "RDMA WRITE after release() succeeded")
        checks["release_invalidates_mr"] = f"ran: write after release -> " \
                                           f"{status}"
    a.close()
    b.close()
    mgr.close()
    return True


def raw_alloc_export_result(nbytes: int) -> int:
    """CUresult of cuMemGetHandleForAddressRange(DMA_BUF_FD, flags 0)
    over a raw cuMemAlloc of ``nbytes``, whole, without CUDAExporter's
    range logic (0: an fd, closed at once)."""
    lib = hcuda._cu()
    lib.cuMemAlloc_v2.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.cuMemFree_v2.argtypes = [ctypes.c_uint64]
    ptr = ctypes.c_uint64()
    rc = lib.cuMemAlloc_v2(ctypes.byref(ptr), nbytes)
    require(rc == 0, f"cuMemAlloc({nbytes}) failed: CUresult {rc}")
    fd = ctypes.c_int(-1)
    try:
        rc = lib.cuMemGetHandleForAddressRange(
            ctypes.byref(fd), ptr.value, nbytes,
            hcuda.CU_MEM_RANGE_HANDLE_TYPE_DMA_BUF_FD, 0)
    finally:
        require(lib.cuMemFree_v2(ptr.value) == 0, "cuMemFree failed")
    if rc == 0:
        os.close(fd.value)
    return int(rc)


def phase_hbm_cuda_exporter() -> dict:
    ib = Path("/sys/class/infiniband")
    hcas = sorted(p.name for p in ib.iterdir()) if ib.is_dir() else []
    u = os.uname()
    res = {"kernel": f"{u.sysname} {u.release} ({u.nodename})",
           "compute_mode": nvidia_smi("compute_mode"),
           "PYTORCH_CUDA_ALLOC_CONF": os.environ.get(
               "PYTORCH_CUDA_ALLOC_CONF"),
           "hcas": hcas, "cuda_h": cuda_h_enums()}
    checks = {}
    supported = hcuda.dmabuf_supported(0)
    res["dma_buf_supported"] = supported
    nbytes = 64 << 20
    t = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
    exporter = hcuda.CUDAExporter()
    va = exporter.adopt(t)
    pinned = exporter.get_pages(va, nbytes)
    res["page_size"] = exporter.get_page_size(va)
    fd = None
    if supported == 1:
        try:
            fd, off = exporter.export_dmabuf(pinned)
        except hcuda.CudaDriverError as err:
            # A refusal is the host's only where the export call itself
            # refused, and refuses a raw allocation just the same.
            require(err.call.startswith("cuMemGetHandleForAddressRange"),
                    f"export_dmabuf failed before the export call: {err}")
            raw = raw_alloc_export_result(nbytes)
            require(raw == err.result,
                    f"export_dmabuf refused ({err}) but the export of a raw "
                    f"cuMemAlloc of {nbytes} bytes returned CUresult {raw}")
            res["export_refused"] = str(err)
            checks["export_dmabuf"] = (
                "not run to an fd: the driver refused the export although "
                f"DMA_BUF_SUPPORTED = 1: {err}; the same export of a raw "
                f"cuMemAlloc, without CUDAExporter, returned CUresult {raw}")
    if fd is not None:
        info = Path(f"/proc/self/fdinfo/{fd}").read_text()
        m = re.search(r"exp_name:\s*(\S+)", info)
        require(m is not None, f"fd {fd} is not a dma-buf: {info!r}")
        res["exp_name"], res["dmabuf_offset"] = m.group(1), off
        checks["export_dmabuf"] = f"ran: fd with exp_name {m.group(1)}"
        emu = eng.Engine("emu")
        try:
            mr = emu.reg_dmabuf_mr(fd, off, nbytes, iova=va)
            res["emu_reg_dmabuf"] = f"registered ({mr.length} bytes)"
            mr.deregister()
        except eng.TransportError as err:
            res["emu_reg_dmabuf"] = f"refused: {err}"
        emu.close()
    elif supported != 1:
        try:
            exporter.export_dmabuf(pinned)
            require(False, "export_dmabuf succeeded with the attribute 0")
        except HbmError as err:
            checks["export_dmabuf"] = f"ran: refused as it must be: {err}"
    # The veto: a device VA never becomes a direct registration.
    emu = eng.Engine("emu")
    mgr = RegistrationManager(emu, exporter)
    try:
        mgr.register(va, nbytes, prefer_dmabuf=False)
        require(False, "a device VA was registered directly")
    except HbmError as err:
        require("dma-buf export is required" in str(err), str(err))
        checks["direct_registrable_veto"] = "ran: " + str(err)
    mgr.close()
    emu.close()
    exporter.put_pages(pinned)
    verbs = None
    if hcas and fd is not None:
        try:
            verbs = eng.Engine("verbs")
        except eng.TransportError as err:
            checks["verbs_write_into_hbm"] = \
                f"not run: Engine('verbs') failed: {err}"
    wrote = False
    if verbs is not None:
        wrote = _write_into_device(verbs, exporter, t, va, nbytes, checks)
        verbs.close()
    if not wrote:
        checks.setdefault("verbs_write_into_hbm",
                          "not run: " + ("no HCA" if not hcas else
                                         "no dma-buf export"))
        # No MR over device memory to revoke: show the revocation chain
        # that would invalidate it — release() with a live pin fires it.
        fired = []
        client = PeerClient(exporter, invalidate_cb=fired.append)
        ctx = client.acquire(va, nbytes)
        client.get_pages(ctx, va, nbytes)
        ctx.core_context = "mr"
        exporter.release(va)
        require(fired == ["mr"] and ctx.revoked,
                "release() with a live pin did not revoke it")
        checks["release_invalidates_mr"] = (
            "not run (no MR over device memory); the revocation chain ran: "
            "release() with a live pin fired its invalidate callback")
    res["checks"] = checks
    del t
    torch.cuda.empty_cache()
    return res


XSLICE_SIZES = {torch.float32: (25_000_003, 7_777_777, 1, 65_537),
                torch.bfloat16: (50_000_017, 12_345_679, 3, 4097)}


# The overlap modes of the sync held against the fused path, each on
# fresh shims: a cold call, then a warm one on new trees.
XSLICE_MODES = {"fused": {}, "overlap": {"overlap": True},
                "bucket_4mib": {"overlap": True, "bucket_bytes": 4 << 20},
                "wire_bf16": {"overlap": True, "wire_dtype": "bf16"},
                "wire_int8": {"overlap": True, "wire_dtype": "int8"}}


def wire_tolerance(wire: str, a, b, want, carried: float = 0.0):
    """Per-element bound on |wire mean - (a + b) / 2| at world 2. On a
    first call (zero residuals) int8 is ``tests/test_overlap.py``'s
    absmax * world / 127 per leaf; bf16 rounds each rank's value and
    the folded sum once each (2^-9 relative), bounded here by
    2^-8 (|a| + |b|) / 2 + 2^-8 |want|. A later call sends each rank's
    value plus the residual it carries in and keeps the new rounding
    error: its mean moves by at most the largest residual carried in
    (``carried``), and the rounding bound grows by at most 2/127 of
    it."""
    extra = carried * (1 + 2 / 127.0)
    if wire == "wire_int8":
        return float(want.abs().max()) * 2 / 127.0 + 1e-6 + extra
    return (a.abs() + b.abs()) * 2.0 ** -9 + want.abs() * 2.0 ** -8 + extra


def wire_bf16_mean(ins, res_in, kept) -> list:
    """The bf16 wire's f32 leaves bit for bit, from each rank's leaves
    ``ins``, the residuals it carried in (``res_in``, None for zeros)
    and those it kept (``kept``, host f32 in leaf order): a rank sends
    bf16(x), x = leaf + residual in, which is exactly x - residual kept;
    the ring adds the two sends in bf16 once and the mean halves it."""
    out, o = [], 0
    for i, leaf in enumerate(ins[0]["float32"]):
        n = leaf.numel()
        sent = []
        for r in range(2):
            x = ins[r]["float32"][i]
            if res_in is not None:
                x = x + res_in[r][o:o + n].to(x.device)
            sent.append((x - kept[r][o:o + n].to(x.device)).bfloat16())
        out.append((sent[0] + sent[1]).float() / 2)
        o += n
    return out


def phase_xslice() -> dict:
    """World-2 ring in-process (one thread per rank), each rank's tree
    of CUDA tensors averaged through the shim's staged path in every
    mode of ``XSLICE_MODES``. The fused path, the overlap path and
    4 MiB buckets are bitwise (a + b) / 2 on the device (at world 2 the
    ring adds once — the native bf16 fold rounds to nearest-even once,
    as torch's bf16 add does — and /2 is exact), so the overlap modes
    are bitwise the fused result; the bf16 and int8 wires compress the
    f32 leaves only, which stay within ``wire_tolerance`` (on the warm
    call, with the residuals the cold one left) and, on the bf16 wire,
    equal ``wire_bf16_mean`` bit for bit; the bf16 leaves stay bitwise,
    and both ranks end bitwise equal."""
    def trees(seed):
        out = []
        for r in range(2):
            g = torch.Generator(device="cuda").manual_seed(seed + r)
            out.append({str(dt).split(".")[-1]: [
                torch.randn(n, generator=g, device="cuda").to(dt)
                for n in ns] for dt, ns in XSLICE_SIZES.items()})
        return out

    tree_bytes = sum(n * torch.empty((), dtype=dt).element_size()
                     for dt, ns in XSLICE_SIZES.items() for n in ns)
    worlds = local_worlds(2, free_port() + 100, spec="emu")
    errs = [None, None]

    def run(shims, tr):
        def rank(r):
            try:
                torch.cuda.set_device(0)
                shims[r](tr[r])
            except BaseException as e:  # surfaced below
                errs[r] = e
        ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        for e in errs:
            if e is not None:
                raise e

    res = {"tree_bytes": tree_bytes, "channels": worlds[0].channels,
           "link_tier": worlds[0].link_tier,
           "leaves": {str(dt).split(".")[-1]: list(ns)
                      for dt, ns in XSLICE_SIZES.items()}}
    for mode, kw in XSLICE_MODES.items():
        shims = [CrossSliceAllReduce(w, mean=True, **kw) for w in worlds]
        calls = {}
        res_in = None  # the residuals a call carries in (None: zeros)
        for name, seed in (("cold", 10), ("warm", 20)):
            carried = 0.0 if res_in is None else max(
                float(r.abs().max()) for r in res_in)
            tr = trees(seed)
            ins = [{k: [t.clone() for t in v] for k, v in tr[r].items()}
                   for r in range(2)] if mode.startswith("wire") else None
            want = {k: [(a + b) / 2 for a, b in zip(tr[0][k], tr[1][k])]
                    for k in tr[0]}
            staged0 = staging.bytes
            run(shims, tr)
            staged = staging.bytes - staged0
            require(staged == 2 * tree_bytes * 2,
                    f"{mode}: staged {staged} bytes, want {4 * tree_bytes}")
            for k in want:
                for i, w in enumerate(want[k]):
                    got0, got1 = tr[0][k][i], tr[1][k][i]
                    require(torch.equal(got0, got1),
                            f"{mode}: ranks differ on {k} leaf {i}")
                    if not mode.startswith("wire") or k == "bfloat16":
                        require(torch.equal(got0, w),
                                f"{mode}: {k} leaf of {w.numel()} differs "
                                "from (a + b) / 2")
                    else:
                        tol = wire_tolerance(mode, ins[0][k][i],
                                             ins[1][k][i], w, carried)
                        err = (got0 - w).abs()
                        require(bool((err <= tol).all()),
                                f"{mode} {name}: {k} leaf {i} off by "
                                f"{float(err.max())}")
                        key = ("max_abs_err" if name == "cold"
                               else "max_abs_err_warm")
                        calls[key] = max(calls.get(key, 0.0),
                                         float(err.max()))
            if mode.startswith("wire"):
                kept = [s._residuals["float32"] for s in shims]
                if mode == "wire_bf16":
                    require(all(torch.equal(got, sent) for got, sent in zip(
                                tr[0]["float32"],
                                wire_bf16_mean(ins, res_in, kept))),
                            f"{mode} {name}: an f32 leaf differs from the "
                            "mean of what the ranks sent")
                if name == "warm":
                    calls["residual_carried_max"] = carried
                res_in = [r.clone() for r in kept]
            calls[name] = {"staged_bytes": staged}
            del tr, want, ins
        for s in shims:
            s.close()
        calls["bitwise_vs_fused"] = not mode.startswith("wire")
        res[mode] = calls
    for w in worlds:
        w.close()
    torch.cuda.empty_cache()
    return res


def grad_bytes(cfg) -> int:
    """Bytes of one rank's gradients: the norm weights in f32, every
    other parameter in the model dtype."""
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    elt = torch.empty((), dtype=cfg.dtype).element_size()
    return (cfg.param_count() - norms) * elt + norms * 4


def two_slice_args(steps: int) -> list:
    """``examples/two_slice_dp_torch.py``'s arguments for the card's
    two-slice paths: llama3-1b bf16 with remat, batch 2 x seq 2048 per
    rank, one batch per rank, the emu engine."""
    cfg, b, s = llama.LLAMA3_1B, 2, 2048
    return [str(REPO / "examples" / "two_slice_dp_torch.py"), "--world",
            "2", "--engine", "emu", "--config", cfg.name, "--remat",
            "--one-batch", "--batch", str(b), "--seq", str(s), "--steps",
            str(steps)]


def rank_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def run_rank_procs(cmds: list, what: str, env=None,
                   timeout: float = 480) -> list:
    """One process per rank, ``cmds[r]`` run from the repo root; each
    rank's JSON lines. Fails unless every rank exits 0 in ``timeout``
    seconds; kills whatever is left."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = [open(os.path.join(tmp, f"r{r}.{k}"), "w+")
                for r in range(len(cmds)) for k in ("out", "err")]
        procs = [subprocess.Popen(cmd, cwd=REPO, stdout=outs[2 * r],
                                  stderr=outs[2 * r + 1],
                                  env={**os.environ, **(env or {})})
                 for r, cmd in enumerate(cmds)]
        deadline = time.monotonic() + timeout
        try:
            rcs = [p.wait(timeout=max(1, deadline - time.monotonic()))
                   for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in outs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    for r in range(len(cmds)):
        require(rcs[r] == 0,
                f"{what} rank {r} exited {rcs[r]} (compute mode "
                f"{compute_mode()}): {texts[2 * r + 1][-2000:]}")
    return [rank_lines(texts[2 * r]) for r in range(len(cmds))]


def run_two_slice(extra: list, steps: int, env=None) -> list:
    """``examples/two_slice_dp_torch.py`` as two rank processes on the
    card (``two_slice_args``); each rank's JSON lines."""
    cmd = [sys.executable] + two_slice_args(steps) + [
        "--port", str(free_port() + 100)] + extra
    return run_rank_procs([cmd + ["--rank", str(r)] for r in range(2)],
                          f"two-slice {extra}", env)


def two_slice_summary(ranks: list, steps: int, c_per_step: dict,
                      what: str) -> dict:
    """The gates every two-slice path holds (each rank reported every
    step, equal digests across ranks after every step, staged bytes 2 x
    the gradient bytes, launches per step equal to path (c)'s, losses
    finite and falling)."""
    cfg, b, s = llama.LLAMA3_1B, 2, 2048
    per = [{ln["step"]: ln for ln in lines if "step" in ln}
           for lines in ranks]
    require(all(sorted(p) == list(range(steps + 1)) for p in per),
            f"{what}: a rank did not report every step")
    for k in range(steps + 1):
        require(per[0][k]["digest"] == per[1][k]["digest"],
                f"{what}: parameter digests differ after step {k}")
    want_bytes = 2 * grad_bytes(cfg)   # CUDA gradients stage both ways
    losses = [[per[r][k]["loss"] for k in range(1, steps + 1)]
              for r in range(2)]
    for r in range(2):
        require(all(np.isfinite(losses[r])), f"rank {r} losses {losses[r]}")
        require(losses[r][-1] < losses[r][0],
                f"{what} rank {r} loss did not fall: {losses[r]}")
        for k in range(1, steps + 1):
            ln = per[r][k]
            require(ln["launches"] == c_per_step,
                    f"{what} rank {r} step {k} launches {ln['launches']} "
                    f"!= {c_per_step}")
            require(ln["staged_bytes"] == want_bytes,
                    f"{what} staged {ln['staged_bytes']} != {want_bytes}")
    launches = {name: sum(per[r][k]["launches"][name] for r in range(2)
                          for k in range(1, steps + 1))
                for name in c_per_step}
    finals = [next(ln for ln in lines if "final_digest" in ln)
              for lines in ranks]
    return {"config": f"{cfg.name}/{str(cfg.dtype).split('.')[-1]}/remat",
            "ranks": 2,
            "batch_per_rank": b, "seq": s, "engine": per[0][0]["engine"],
            "link_tier": per[0][0]["link_tier"],
            "overlap": per[0][0]["overlap"],
            "per_layer": per[0][0]["per_layer"],
            "steps": steps,
            "staged_bytes_per_step": per[0][steps]["staged_bytes"],
            "grad_bytes": grad_bytes(cfg),
            "losses": losses, "digests_equal_every_step": True,
            "digests": [per[0][k]["digest"] for k in range(steps + 1)],
            "peak_mem_gb_by_rank": [f["peak_mem_gb"] for f in finals],
            "launches_per_step_per_rank": c_per_step,
            "launches": launches}, finals


def phase_two_slice_dp(c_per_step: dict) -> dict:
    """Path (d): two rank processes of llama3-1b bf16 with remat, batch
    2 × seq 2048 per rank, the fused sync, 3 steps (path (f) holds its 3
    steps against these)."""
    steps = 3
    res, _ = two_slice_summary(run_two_slice([], steps), steps, c_per_step,
                               "path (d)")
    return res


def against_path_d(digests: list, losses: list, d: dict, c_per_step: dict,
                   what: str, fault: str) -> dict:
    """A two-slice path's digests after every step against path (d)'s.
    Where they differ, path (d) is run again: if (d) repeats its own
    digests, the difference is a fault of ``fault``; if it does not,
    the backward is not bitwise repeatable on this card and the path's
    losses are held to (d)'s within 1e-3 relative instead."""
    out = {"digests_equal_path_d": digests == d["digests"][:len(digests)]}
    if not out["digests_equal_path_d"]:
        again, _ = two_slice_summary(run_two_slice([], 2), 2, c_per_step,
                                     "path (d) repeat")
        repeats = again["digests"] == d["digests"][:3]
        out["path_d_repeats_its_digests"] = repeats
        require(not repeats, f"{what}'s digests differ from path (d)'s, "
                f"and (d) repeats its own: a fault of {fault}")
        rel = max(abs(e - dd) / abs(dd) for le, ld in zip(losses,
                                                          d["losses"])
                  for e, dd in zip(le, ld))
        require(rel <= 1e-3, f"{what} losses off (d)'s by {rel}")
        out["loss_max_rel_diff_vs_d"] = rel
    return out


def phase_two_slice_dp_per_layer(c_per_step: dict, d: dict) -> dict:
    """Path (e): path (d)'s command with ``--per-layer`` and the flight
    recorder on (drained after every step, its ring sized for a step).
    Besides path (d)'s gates, its parameter digests equal path (d)'s
    after every step: at world 2 the ring adds once, so bucketing per
    layer changes no bit. Where they differ, path (d) is run again: if
    (d) repeats its own digests, the difference is a fault; if it does
    not, the backward is not bitwise repeatable on this card and (e)'s
    losses are held to (d)'s within 1e-3 relative instead. 2 steps."""
    steps = 2
    env = {"TDR_TELEMETRY": "1", "TDR_TELEMETRY_RING": str(1 << 21)}
    ranks = run_two_slice(["--per-layer"], steps, env)
    res, finals = two_slice_summary(ranks, steps, c_per_step, "path (e)")
    require(res["per_layer"], "path (e) did not run the per-layer sync")
    res.update(against_path_d(res["digests"], res["losses"], d, c_per_step,
                              "path (e)", "the per-layer sync"))
    tel = [f["telemetry_timed_steps"] for f in finals]
    for key in ("overlap_fraction", "compute_overlap_fraction",
                "telemetry_dropped"):
        res[key] = [t[key] for t in tel]
    return res


# The elastic paths' ranks: the example behind a sync that counts its
# calls, or with the per-layer sync its bucket pushes, SIGKILLs its
# process at the given count (0: never), after writing the moment to its
# standard output. SIGUSR1 dumps every thread's stack to its standard
# error.
# With TDR_RESUME_STACKS set, every thread's stack is appended to
# <TDR_RESUME_STACKS>.<pid> every 30 s while the trainer resumes.
KILL_SWITCH = r"""
import faulthandler, json, os, runpy, signal, sys, time
from rocnrdma_tpu_torch.collectives import torch_shim
from rocnrdma_tpu_torch.parallel import trainer as trainer_mod

faulthandler.register(signal.SIGUSR1, all_threads=True)
STACKS = os.environ.get("TDR_RESUME_STACKS")
if STACKS:
    resume = trainer_mod.Trainer._resume

    def stacked_resume(self, exc, attempt):
        with open(f"{STACKS}.{os.getpid()}", "a") as f:
            f.write(f"resume attempt {attempt} at {time.monotonic()}: "
                    f"{str(exc)[:300]}\n")
            f.flush()
            faulthandler.dump_traceback_later(30, repeat=True, file=f)
            try:
                return resume(self, exc, attempt)
            finally:
                faulthandler.cancel_dump_traceback_later()
                f.write(f"resumed at {time.monotonic()}\n")

    trainer_mod.Trainer._resume = stacked_resume

DIE_AT = int(sys.argv[1])


class KillSwitch(torch_shim.CrossSliceAllReduce):
    ticks = 0

    @staticmethod
    def tick():
        KillSwitch.ticks += 1
        if KillSwitch.ticks == DIE_AT:
            print(json.dumps({"killed_monotonic": time.monotonic()}),
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def __call__(self, tree):
        KillSwitch.tick()
        return super().__call__(tree)

    def start_layered(self, plan):
        pending = super().start_layered(plan)
        push = pending.push

        def counted(idx, leaves):
            KillSwitch.tick()
            push(idx, leaves)

        pending.push = counted
        return pending


torch_shim.CrossSliceAllReduce = KillSwitch
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
ELASTIC_STEPS, ELASTIC_DIE_AT = 3, 2
ELASTIC_RECOVERY_S = 450   # rank 1's restart to both ranks' exit
ELASTIC_WORLD = "two-slice-dp"


def checkpoint_root(need: int) -> tuple:
    """A directory for path (f)'s checkpoints on the file system of the
    temporary directory, and its free bytes; fails with the numbers
    unless ``need`` bytes are free there."""
    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    require(free >= need, f"path (f) needs {need} bytes for its "
            f"checkpoints, {root} has {free} free")
    return tempfile.mkdtemp(prefix="tdr-elastic-", dir=root), free


def start_coordinator() -> tuple:
    """The port's coordinator (``rocnrdma_tpu_torch.tools.rendezvous``)
    as a process on a free port: (process, "host:port")."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "rocnrdma_tpu_torch.tools.rendezvous",
         "--host", "127.0.0.1", "--port", str(port), "--lease-ms", "10000",
         "--port-base", str(free_port() + 200)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    require("listening on" in line, f"coordinator did not start: {line!r} "
            f"{proc.stderr.read() if proc.poll() is not None else ''}")
    return proc, f"127.0.0.1:{port}"


def stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_elastic(addr: str, root: str, env: dict, steps: int, die_at: int,
                extra, what: str) -> list:
    """An elastic path's ranks, ``steps`` steps of the example with
    ``extra`` arguments: rank 0 and rank 1 (behind ``KILL_SWITCH``,
    dying at its ``die_at``-th sync call or bucket push); once rank 1 is
    dead (it must die of SIGKILL), rank 1 again. ``env`` adds to the
    ranks' environment. Each incarnation's standard output."""
    args = two_slice_args(steps) + list(extra) + [
        "--controller", addr, "--elastic-dir", os.path.join(root, "ck")]
    env = {**os.environ, "TDR_RING_TIMEOUT_MS": "120000",
           "TDR_POSTMORTEM_DIR": os.path.join(root, "postmortem"),
           **env}
    files = []

    def spawn(rank: int, die: int):
        out, err = (open(os.path.join(root, f"r{rank}.{len(files)}.{k}"),
                         "w+") for k in ("out", "err"))
        files.append((out, err))
        return subprocess.Popen(
            [sys.executable, "-c", KILL_SWITCH, str(die)] + args
            + ["--rank", str(rank)], cwd=REPO, stdout=out, stderr=err,
            env=env)

    def texts():
        got = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            got.append((out.read(), err.read()))
        return got

    def report(msg: str) -> str:
        # Every incarnation's last lines, each live one's stacks among
        # them: which rank a hang held, and where.
        return msg + "".join(
            f"\n--- {name} stdout ---\n{o[-1500:]}\n--- {name} stderr "
            f"---\n{e[-6000:]}" for name, (o, e) in zip(
                ("rank 0", "rank 1", "restarted rank 1"), texts()))

    procs = [spawn(0, 0), spawn(1, die_at)]
    waited = "300 s for rank 1's kill"
    try:
        procs[1].wait(timeout=300)
        if procs[1].returncode != -signal.SIGKILL:
            raise RuntimeError(report(f"{what} rank 1 exited "
                                      f"{procs[1].returncode}, not by "
                                      f"SIGKILL"))
        procs.append(spawn(1, 0))
        deadline = time.monotonic() + ELASTIC_RECOVERY_S
        waited = f"{ELASTIC_RECOVERY_S} s after rank 1's restart"
        rcs = [p.wait(timeout=max(1, deadline - time.monotonic()))
               for p in (procs[0], procs[2])]
    except subprocess.TimeoutExpired:
        live = [p for p in procs if p.poll() is None]
        for p in live:
            p.send_signal(signal.SIGUSR1)
        time.sleep(2)
        raise RuntimeError(report(
            f"{what}: {len(live)} rank process(es) still running "
            f"{waited} (stacks below)")) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        got = texts()
        for out, err in files:
            out.close()
            err.close()
    for name, rc, (_, err) in (("rank 0", rcs[0], got[0]),
                               ("restarted rank 1", rcs[1], got[2])):
        require(rc == 0, f"{what} {name} exited {rc}: {err[-3000:]}")
    return [t[0] for t in got]


def explain_incident(incident: Path) -> dict:
    """The port's ``tdr_explain --postmortem`` readout of one incident
    directory (``rocnrdma_tpu_torch.tools.explain``): the rank bundles
    the directory holds, the world and generation the analysis names,
    and the first lines of its text."""
    analysis = explain.explain_postmortem(str(incident))
    lines = explain.render_text(analysis).splitlines()
    return {"incident": incident.name,
            "bundles": sorted(p.name for p in incident.glob("rank*.json")),
            "world": analysis["incident"]["world"],
            "generation": analysis["incident"]["generation"],
            "n_collectives": analysis["n_collectives"],
            "lines": len(lines), "head": lines[:8]}


def elastic_path(what: str, steps: int, kill_step: int, die_at: int,
                 per_attempt: dict, extra=()) -> tuple:
    """Run an elastic path (``run_elastic`` under a coordinator started
    as a process, checkpoints under the temporary directory; rank 1
    dies at its ``die_at``-th sync call or bucket push, in step
    ``kill_step``) and hold the gates every elastic path holds: rank 1
    died of SIGKILL and came back from its checkpoint of step
    ``kill_step - 1``; rank 0 resumed once, in step ``kill_step``, and
    rebuilt; every step's digests equal on every
    rank; one recovery on the coordinator and the ranks' generation
    its; each step's launches ``per_attempt`` per attempt. Returns the
    summary (with ``explain_incident`` of rank 0's incident directory,
    read before the directory goes) and rank 0's postmortem bundle."""
    cfg = llama.LLAMA3_1B
    ckpt_bytes = 3 * grad_bytes(cfg)          # params and two moments
    root, free = checkpoint_root(2 * 2 * ckpt_bytes + (1 << 30))
    coord, addr = start_coordinator()
    try:
        outs = run_elastic(
            addr, root, steps=steps, die_at=die_at, extra=extra, what=what,
            env={"TDR_RESUME_STACKS": os.path.join(root, "stacks")})
        metrics = ControlClient(addr).metrics()
        bundles = sorted(Path(root, "postmortem", ELASTIC_WORLD).glob(
            "incident-g*/rank0.json"))
        bundle = json.loads(bundles[0].read_text()) if bundles else None
        explained = explain_incident(bundles[0].parent) if bundles else None
        # The stacks of a resume that took 30 s or more.
        stacks = [t for t in (f.read_text() for f in sorted(
            Path(root).glob("stacks.*"))) if "File " in t]
    finally:
        stop(coord)
        shutil.rmtree(root, ignore_errors=True)
    r0, r1a, r1b = (rank_lines(t) for t in outs)
    killed = [ln["killed_monotonic"] for ln in r1a if "killed_monotonic"
              in ln]
    require(len(killed) == 1, f"{what} rank 1 did not note its kill")
    require(f"RESTORED 1 {kill_step - 1}" in outs[2],
            f"{what} rank 1 did not restore step {kill_step - 1}")
    by_step = {k: [] for k in range(steps + 1)}
    for lines in (r0, r1a, r1b):
        for ln in lines:
            if "digest" in ln:
                by_step[ln["step"]].append(ln)
    for k, lines in by_step.items():
        require({ln["rank"] for ln in lines} == {0, 1},
                f"{what} step {k} reported by ranks "
                f"{[ln['rank'] for ln in lines]}")
        require(len({ln["digest"] for ln in lines}) == 1,
                f"{what} parameter digests differ after step {k}")
    digests = [by_step[k][0]["digest"] for k in range(steps + 1)]
    by_rank = [[ln for ln in r0 if ln.get("step", 0) > 0 and "loss" in ln],
               [ln for ln in r1a + r1b if ln.get("step", 0) > 0
                and "loss" in ln]]
    losses = [[ln["loss"] for ln in lines] for lines in by_rank]
    for r, lines in enumerate(by_rank):
        require([ln["step"] for ln in lines] == list(range(1, steps + 1)),
                f"{what} rank {r} steps {[ln['step'] for ln in lines]}")
        require(all(np.isfinite(losses[r])), f"rank {r} losses {losses[r]}")
        for ln in lines:
            want = {k: v * (1 + ln["resumes"])
                    for k, v in per_attempt.items()}
            require(ln["launches"] == want,
                    f"{what} rank {r} step {ln['step']} launches "
                    f"{ln['launches']} != {want}")
    resumed = [ln for ln in by_rank[0] if ln["resumes"]]
    require(len(resumed) == 1 and resumed[0]["step"] == kill_step,
            f"{what} rank 0 resumed at steps "
            f"{[(ln['step'], ln['resumes']) for ln in resumed]}")
    final0 = next(ln for ln in r0 if "final_digest" in ln)
    final1 = next(ln for ln in r1b if "final_digest" in ln)
    require(final0["resume"] >= 1 and final0["rebuild"] >= 1,
            f"{what} rank 0 counters: resume {final0['resume']}, "
            f"rebuild {final0['rebuild']}")
    series = f'{{world="{ELASTIC_WORLD}"}}'
    served = {name: float(ln.split()[-1]) for ln in metrics.splitlines()
              for name in ("generation", "rebuilds_total")
              if ln.startswith(f"tdr_ctl_{name}{series} ")}
    require(served.get("rebuilds_total") == 1,
            f"{what} coordinator recoveries {served} (one incident)")
    # The ranks' generation moved at rank 0's failure report, at rank
    # 1's rejoin and, where rank 1's lease ran out before it rejoined,
    # at the expiry; the coordinator's moved twice more as both ranks
    # left at the end.
    require(final0["generation"] == final1["generation"] > 0
            and served.get("generation") == final0["generation"] + 2,
            f"{what} coordinator generation {served} against the ranks' "
            f"{final0['generation']} / {final1['generation']}")
    out = {"config": f"{cfg.name}/bf16/remat", "ranks": 2,
           "steps": steps, "killed_at_tick": die_at,
           "checkpoint_dir_free_bytes": free,
           "rank1_exit": "-SIGKILL", "digests": digests,
           "digests_equal_every_step": True, "losses": losses,
           "ckpt_bytes_by_rank": [lines[-1]["ckpt_bytes"]
                                  for lines in by_rank],
           "coordinator": served,
           "rank_generation": final0["generation"],
           "resume_stacks": stacks,
           "postmortem_explain": explained,
           "launches": {name: sum(ln["launches"][name] for lines in by_rank
                                  for ln in lines) for name in per_attempt},
           "launches_per_step_per_rank": per_attempt}
    return out, bundle


def phase_two_slice_elastic(c_per_step: dict, d: dict) -> dict:
    """Path (f): path (d)'s two ranks under the port's coordinator, each
    with ``ElasticPolicy(save_every=1, max_resumes=6)``; rank 1
    SIGKILLs itself in its 2nd sync call and is started again. Gates:
    ``elastic_path``'s, every step's digests equal to path (d)'s, rank
    0's postmortem bundle."""
    out, bundle = elastic_path(
        "path (f)", ELASTIC_STEPS, ELASTIC_DIE_AT, ELASTIC_DIE_AT,
        c_per_step)
    require(bundle is not None and bundle["format"] == "tdr-postmortem-v1"
            and bundle["incarnation"] is not None,
            f"path (f) rank 0 postmortem bundle: {bundle}")
    # The port's explainer reads the incident: its first line names the
    # world and the bundle's generation, and it lists every rank bundle.
    ex = out["postmortem_explain"]
    head = ex["head"]
    require(head and head[0].startswith(
        f"incident: world={ELASTIC_WORLD} "
        f"generation={bundle['generation']} "),
        f"path (f) tdr_explain incident line: {head[:1]}")
    listed = [ln.split(":")[0].split()[1] for ln in head[1:]
              if ln.startswith("  rank ")]
    require(ex["bundles"] and listed == [b[4:-5] for b in ex["bundles"]],
            f"path (f) tdr_explain lists ranks {listed}, bundles "
            f"{ex['bundles']}")
    out["postmortem_error"] = bundle["error"]
    out.update(against_path_d(out["digests"], out["losses"], d, c_per_step,
                              "path (f)", "the elastic resume"))
    return out


# Sequence parallelism at llama3-1b's longest context: the global
# sequence, its shards over world 2, and the rank processes' steps.
SP_WORLD, SP_BATCH, SP_SEQ, SP_STEPS = 2, 1, 8192, 2
SP_MODES = ("ring", "ulysses")
# The parity phase: llama3-1b f32, one SGD step on 1024 tokens.
SP_PARITY_SEQ, SP_PARITY_LR = 1024, 1e-2
SP_LOSS_TOL = 2e-2

# One rank of the seq-parallel parity phase: the single-device Trainer's
# loss and gradients on the whole sequence (before the world, so both
# ranks reach its bootstrap together), then one world and a
# SeqParallelTrainer per mode, one SGD step each from the same weights,
# its synced gradients held against the single-device ones.
SP_PARITY_RANK = r"""
import dataclasses, hashlib, json, sys
import numpy as np, torch
from rocnrdma_tpu_torch.collectives.world import RingWorld
from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.parallel.trainer import Trainer, loss_fn
from rocnrdma_tpu_torch.transport.engine import Engine

rank, port, seq, lr = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                       float(sys.argv[4]))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.set_device(0)
cfg = dataclasses.replace(llama.LLAMA3_1B, dtype=torch.float32)
state = llama.init_params(cfg, seed=1, device="cuda")
tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, seq + 1))
single = Trainer(cfg, device="cuda", params=state)
loss = loss_fn(single.model, torch.from_numpy(tokens).cuda())
loss.backward()
ref_loss = float(loss.detach())
ref = {n: p.grad for n, p in single.model.named_parameters()}
del single, loss
world = RingWorld(Engine("emu"), rank, 2, port, timeout_ms=120000)
s_local = seq // 2
shard = slice(rank * s_local, (rank + 1) * s_local)
out = {"rank": rank}
for mode in ("ring", "ulysses"):
    tr = Trainer(cfg, seq_parallel=world, sp_mode=mode, device="cuda",
                 params=state,
                 optimizer=lambda ps: torch.optim.SGD(ps, lr=lr))
    _native.reset_launches()
    gloss = tr.step(tokens[:, :-1][:, shard], tokens[:, 1:][:, shard])
    launches = _native.launches()
    h = hashlib.sha256()
    for _, p in tr.model.named_parameters():
        h.update(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
    rels = {n: float((p.grad - ref[n]).abs().max()
                     / ref[n].abs().max().clamp_min(1e-30))
            for n, p in tr.model.named_parameters()}
    worst = max(rels, key=rels.get)
    res = {"loss": gloss, "digest": h.hexdigest(), "ref_loss": ref_loss,
           "grad_max_rel_err": rels[worst], "worst_grad": worst,
           "launches": launches}
    out[mode] = res
    tr.close()
    del tr
    torch.cuda.empty_cache()
world.close()
print(json.dumps(out), flush=True)
"""


def phase_sp_parity() -> dict:
    """llama3-1b in f32, batch 1, a global sequence of 1024 split over
    two rank processes, one SGD step in each mode: the global loss and
    every synced gradient against the single-device ``Trainer`` on the
    whole sequence (kernels on both sides) to the training-parity
    tolerances (loss 1e-4 relative, gradients 1e-3 of each tensor's
    largest element), and both ranks' parameters equal after the step.
    The ranks are processes, not threads of this process: autograd runs
    every CUDA backward of a process on one device thread, where one
    rank's ring backward would wait for the other's, queued behind it."""
    port = free_port() + 100
    ranks = run_rank_procs(
        [[sys.executable, "-c", SP_PARITY_RANK, str(r), str(port),
          str(SP_PARITY_SEQ), str(SP_PARITY_LR)] for r in range(2)],
        "seq-parallel parity", timeout=420)
    res = [lines[-1] for lines in ranks]
    out = {"config": "llama3-1b/f32", "batch": 1, "seq": SP_PARITY_SEQ,
           "world": 2, "optimizer": f"SGD lr {SP_PARITY_LR}",
           "loss_rel_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL}
    for mode in SP_MODES:
        a, b = res[0][mode], res[1][mode]
        require(a["digest"] == b["digest"],
                f"sp parity {mode}: ranks' parameters differ after the step")
        require(a["loss"] == b["loss"], f"sp parity {mode}: ranks' losses "
                f"{a['loss']} and {b['loss']} differ")
        rel = abs(a["loss"] - a["ref_loss"]) / abs(a["ref_loss"])
        require(rel <= TRAIN_LOSS_TOL, f"sp parity {mode}: loss {a['loss']} "
                f"vs single-device {a['ref_loss']}")
        for r in range(2):
            got = res[r][mode]
            require(got["grad_max_rel_err"] <= TRAIN_GRAD_TOL,
                    f"sp parity {mode} rank {r}: grad {got['worst_grad']} "
                    f"rel err {got['grad_max_rel_err']}")
            require(got["launches"] == expected_sp_launches(
                llama.LLAMA3_1B, mode, r),
                    f"sp parity {mode} rank {r}: launches "
                    f"{got['launches']}")
        out[mode] = {"loss": a["loss"], "single_device_loss": a["ref_loss"],
                     "loss_rel_err": rel,
                     "grad_max_rel_err_by_rank": [
                         res[r][mode]["grad_max_rel_err"] for r in range(2)],
                     "worst_grad": a["worst_grad"], "digest": a["digest"],
                     "digests_equal": True,
                     "launches_by_rank": [res[r][mode]["launches"]
                                          for r in range(2)]}
    return out


def seq_parallel_args(mode: str) -> list:
    """``examples/seq_parallel_train_torch.py``'s arguments for path (g):
    llama3-1b bf16 with remat, batch 1, a global sequence of 8192, one
    batch, the emu engine."""
    return [str(REPO / "examples" / "seq_parallel_train_torch.py"),
            "--world", str(SP_WORLD), "--engine", "emu", "--config",
            llama.LLAMA3_1B.name, "--remat", "--one-batch", "--batch",
            str(SP_BATCH), "--seq", str(SP_SEQ), "--steps", str(SP_STEPS),
            "--mode", mode]


def expected_sp_launches(cfg, mode: str, rank: int) -> dict:
    """Launches of each kernel per rank per step on path (g): every
    RMSNorm runs K1 forward and K2 backward, and under remat the two
    halves' norms K1 once more (the final norm is not recomputed); the
    ring's rank r attends r + 1 of the contiguous shards causally,
    forward (K3) and backward (K5, K4); Ulysses runs K3 forward and
    again in its backward's recompute, then K5 and K4."""
    L = cfg.n_layers
    norms = 2 * L + 1
    shards = rank + 1 if mode == "ring" else 1
    return {"rmsnorm_fwd": norms + (2 * L if cfg.remat else 0),
            "flash_fwd": L * shards * (1 if mode == "ring" else 2),
            "rmsnorm_bwd": norms, "flash_bwd_dq": L * shards,
            "flash_bwd_dkv": L * shards, "decode_attn": 0,
            **NOT_ON_LLAMA}


def sp_bytes(cfg, mode: str, rank: int, world: int, b: int,
             s_local: int) -> tuple:
    """(bytes this rank sends, bytes it stages) per step on path (g),
    from the shapes. Ring, per layer: one K+V rotation forward, one K+V
    and ``world`` f32 dK+dV rotations backward; staged, the D2H of its
    K+V each pass, the H2D of each visible remote shard, each visible
    pair's f32 partials and the homecoming. Ulysses, per layer: q, k, v,
    out forward and q, k, v, dout, dq, dk, dv backward through the
    all-to-all, (world-1)/2 of each sent, each staged both ways. Plus the
    gradient mean's staging both ways."""
    elt = torch.empty((), dtype=cfg.dtype).element_size()
    q = b * cfg.n_heads * s_local * cfg.head_dim * elt
    kv = 2 * b * cfg.n_kv_heads * s_local * cfg.head_dim * elt
    acc = kv // elt * 4
    if mode == "ring":
        seen = rank + 1
        wire = (world - 1) * 2 * kv + world * acc
        staged = 2 * kv * seen + acc * (seen + 1)
    else:
        bufs = 5 * q + 3 * kv
        wire = bufs * (world - 1) // 2
        staged = 2 * bufs
    L = cfg.n_layers
    return L * wire, L * staged + 2 * grad_bytes(cfg)


def sp_reference_loss(cfg, b: int, s: int) -> float:
    """The single-device bf16 loss of path (g)'s first step: the
    ``Trainer``'s model from ``init_params(seed=0)`` on the example's
    global batch (``default_rng(1234)``), the whole sequence at once."""
    trainer = Trainer(cfg, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1234).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    with torch.no_grad():
        loss = float(loss_fn(trainer.model, tokens))
    del trainer
    torch.cuda.empty_cache()
    return loss


def sp_mode_summary(ranks: list, mode: str, cfg) -> dict:
    """Path (g)'s gates for one mode and its bytes, launches and peak
    memory."""
    what = f"path (g) {mode}"
    s_local = SP_SEQ // SP_WORLD
    per = [{ln["step"]: ln for ln in lines if "step" in ln}
           for lines in ranks]
    require(all(sorted(p) == list(range(SP_STEPS + 1)) for p in per),
            f"{what}: a rank did not report every step")
    for k in range(SP_STEPS + 1):
        require(per[0][k]["digest"] == per[1][k]["digest"],
                f"{what}: parameter digests differ after step {k}")
    losses = [per[0][k]["loss"] for k in range(1, SP_STEPS + 1)]
    require(all(np.isfinite(losses)), f"{what}: losses {losses}")
    require(losses[-1] < losses[0], f"{what}: loss did not fall: {losses}")
    for r in range(SP_WORLD):
        want = expected_sp_launches(cfg, mode, r)
        wire, staged = sp_bytes(cfg, mode, r, SP_WORLD, SP_BATCH, s_local)
        for k in range(1, SP_STEPS + 1):
            ln = per[r][k]
            require(ln["loss"] == losses[k - 1],
                    f"{what}: rank {r} step {k} loss {ln['loss']}")
            require(ln["launches"] == want, f"{what}: rank {r} step {k} "
                    f"launches {ln['launches']} != {want}")
            require(ln["attn_wire_bytes"] == wire, f"{what}: rank {r} sent "
                    f"{ln['attn_wire_bytes']} != {wire}")
            require(ln["staged_bytes"] == staged, f"{what}: rank {r} staged "
                    f"{ln['staged_bytes']} != {staged}")
    finals = [next(ln for ln in lines if "final_digest" in ln)
              for lines in ranks]
    return {"mode": mode, "link_tier": per[0][0]["link_tier"],
            "engine": per[0][0]["engine"],
            "attn_calls_per_step": per[0][1]["attn_calls"],
            "wire_bytes_per_step_by_rank": [per[r][1]["attn_wire_bytes"]
                                            for r in range(SP_WORLD)],
            "staged_bytes_per_step_by_rank": [per[r][1]["staged_bytes"]
                                              for r in range(SP_WORLD)],
            "peak_mem_gb_by_rank": [f["peak_mem_gb"] for f in finals],
            "losses": losses, "digests_equal_every_step": True,
            "launches_per_step_by_rank": [per[r][1]["launches"]
                                          for r in range(SP_WORLD)],
            "launches": {name: sum(per[r][k]["launches"][name]
                                   for r in range(SP_WORLD)
                                   for k in range(1, SP_STEPS + 1))
                         for name in _native.KERNELS}}


def phase_seq_parallel() -> dict:
    """Path (g): ``examples/seq_parallel_train_torch.py`` as two rank
    processes on the card, llama3-1b bf16 with remat at its longest
    context (8192 tokens, a 4096-token shard a rank), ring then Ulysses,
    2 steps each. Gates: equal digests on both ranks after
    every step, each mode's first loss within 2e-2 relative of the other
    mode's and of the single-device model's on the whole sequence,
    launches, wire and staged bytes per rank per step as the model and
    the shapes say, losses falling."""
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True)
    ref = sp_reference_loss(cfg, SP_BATCH, SP_SEQ)
    out = {"config": f"{cfg.name}/bf16/remat", "world": SP_WORLD,
           "batch": SP_BATCH, "seq": SP_SEQ, "seq_local": SP_SEQ // SP_WORLD,
           "steps": SP_STEPS, "single_device_loss": ref, "loss_rel_tol": SP_LOSS_TOL}
    for mode in SP_MODES:
        cmd = [sys.executable] + seq_parallel_args(mode) + [
            "--port", str(free_port() + 100)]
        ranks = run_rank_procs([cmd + ["--rank", str(r)]
                                for r in range(SP_WORLD)],
                               f"path (g) {mode}")
        out[mode] = sp_mode_summary(ranks, mode, cfg)
    first = {mode: out[mode]["losses"][0] for mode in SP_MODES}
    for mode, loss in first.items():
        rel = abs(loss - ref) / abs(ref)
        require(rel <= SP_LOSS_TOL, f"path (g) {mode} first loss {loss} vs "
                f"single-device {ref}")
        out[mode]["first_loss_rel_err_vs_single_device"] = rel
    rel = abs(first["ring"] - first["ulysses"]) / abs(first["ring"])
    require(rel <= SP_LOSS_TOL, f"path (g) first losses {first}")
    out["first_loss_rel_diff_ring_vs_ulysses"] = rel
    return out


# Path (i): the intra-slice dp x tp mesh, its positions sharing the card.
MESH = {"dp": 2, "tp": 2}
MESH_DEVICES = ["cuda:0"] * 4
MESH_LOSS_TOL = 2e-2
MESH_TWO_SLICE = "dp=1,tp=2"


def expected_mesh_launches(cfg, positions: int) -> dict:
    """Launches of each kernel per meshed train step: every position
    runs every RMSNorm (K1 forward, K2 backward) on its own rows and
    every attention (K3 forward, K5 and K4 backward) on its local heads
    (or, where the heads do not divide tp, on all of them); under remat
    the blocks' K1 and K3 once more. Path (c)'s counts times the
    positions."""
    L = cfg.n_layers
    again = 1 if cfg.remat else 0
    per_position = {"rmsnorm_fwd": 2 * L + 1 + again * 2 * L,
                    "flash_fwd": L * (1 + again),
                    "rmsnorm_bwd": 2 * L + 1, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L, "decode_attn": 0,
                    **NOT_ON_LLAMA}
    return {k: v * positions for k, v in per_position.items()}


def mesh_local_shape(trainer, b: int, s: int) -> list:
    """(B, H, KVH, S, D) of the attention each position runs."""
    cfg, mesh = trainer.cfg, trainer.mesh
    tp = mesh.shape["tp"] if trainer.model.attn_split else 1
    return [b // mesh.shape["dp"], cfg.n_heads // tp, cfg.n_kv_heads // tp,
            s, cfg.head_dim]


def phase_mesh_parity(state, cfg) -> dict:
    """Path (i), f32: llama3-1b, batch 2 x seq 200, one step of the
    meshed ``Trainer`` on dp 2 x tp 2 (four positions on the card)
    against the single-device card ``Trainer`` from the same weights:
    the loss to 1e-4 relative, every gradient to 1e-3 of its largest
    element, the parameters after the AdamW step by the training-parity
    rule (decided elements to 2e-6)."""
    b, s, lr = 2, 200, 3e-4
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (b, s + 1)))
    single = Trainer(cfg, device="cuda", params=state, learning_rate=lr)
    _native.reset_launches()
    loss_1 = single.step(tokens)
    launches = {"single_device": _native.launches()}
    want = named_step(single.model)
    meshed = Trainer(cfg, MESH, devices=MESH_DEVICES, params=state,
                     learning_rate=lr)
    _native.reset_launches()
    loss_m = meshed.step(tokens)
    launches["meshed"] = _native.launches()
    require(launches == {
        "single_device": expected_train_launches(single.model, 1),
        "meshed": expected_mesh_launches(cfg, len(MESH_DEVICES))},
        f"path (i) f32 launches {launches}")
    rel = abs(loss_m - loss_1) / abs(loss_1)
    require(rel <= TRAIN_LOSS_TOL,
            f"path (i) f32 loss {loss_m} vs single-device {loss_1}")
    got = {n: (meshed.model.full(n), meshed.model.full(n, grad=True))
           for n in meshed.model.names}
    agree = step_agreement("path (i) f32", got, want, lr)
    ptrs = [t.data_ptr() for t in meshed.model.parameters()]
    require(len(set(ptrs)) == len(ptrs),
            "path (i): two positions' parameters share storage")
    shape = mesh_local_shape(meshed, b, s)
    del single, meshed, want, got
    torch.cuda.empty_cache()
    return {"config": cfg.name + "/f32", "mesh": MESH,
            "devices": MESH_DEVICES, "batch": b, "seq": s,
            "local_attention_shape": shape, "loss_meshed": loss_m,
            "loss_single_device": loss_1, "loss_rel_err": rel,
            "loss_rel_tol": TRAIN_LOSS_TOL, "launches": launches, **agree,
            "parameters_share_no_storage": True}


def phase_mesh_train(c: dict) -> dict:
    """Path (i), bf16: ``Trainer("llama3-1b", {"dp": 2, "tp": 2},
    devices=["cuda:0"] * 4, remat=True)`` at path (c)'s batch (2 x 2048,
    ``default_rng(0)``) and weights (``init_params(seed=0)``), one warm
    step then 3. Gates: the first loss within 2e-2 relative of
    (c)'s, every kernel's launches per step as the shapes give, K3/K4/K5
    on the tensor-core route at the positions' local shape, losses
    falling."""
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True)
    b, s, steps = 2, 2048, 3
    trainer = Trainer(cfg, MESH, devices=MESH_DEVICES, remat=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.step(tokens)]                   # warm
    _native.reset_launches()
    losses += [trainer.step(tokens) for _ in range(steps)]
    launches = _native.launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = expected_mesh_launches(cfg, trainer.mesh.size)
    want = {k: v * steps for k, v in per_step.items()}
    require(launches == want, f"path (i) launches {launches} != {want}")
    require(all(np.isfinite(losses)), f"path (i) losses {losses}")
    require(losses[-1] < losses[0], f"path (i) loss did not fall: {losses}")
    rel = abs(losses[0] - c["losses"][0]) / abs(c["losses"][0])
    require(rel <= MESH_LOSS_TOL, f"path (i) first loss {losses[0]} vs "
            f"path (c)'s {c['losses'][0]}")
    shape = mesh_local_shape(trainer, b, s)
    routes = {name: kernel_route(name, shape[-1], cfg.dtype)
              for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    require(all(r == TC for r in routes.values()),
            f"path (i) routes at {shape}: {routes}")
    del trainer
    torch.cuda.empty_cache()
    return {"config": cfg.name + "/bf16/remat", "mesh": MESH,
            "devices": MESH_DEVICES, "batch": b, "seq": s,
            "local_attention_shape": shape, "routes": routes,
            "peak_mem_gb": peak / 1e9, "losses": losses,
            "path_c_first_loss": c["losses"][0], "first_loss_rel_err": rel,
            "first_loss_rel_tol": MESH_LOSS_TOL,
            "launches": launches, "launches_per_step": {
                k: v // steps for k, v in launches.items()},
            "expected_per_step": per_step,
            "expected_rule": "positions (4) x path (c)'s per step: K1 "
                             "(2L+1)+2L, K3 2L, K2 2L+1, K5 L, K4 L at L 16"}


def phase_mesh_two_slice(d: dict) -> dict:
    """Path (i), two slices: ``examples/two_slice_dp_torch.py --mesh
    dp=1,tp=2 --devices cuda:0,cuda:0`` as two rank processes over the
    emu ring, llama3-1b bf16 with remat, 2 x 2048 a rank, 2 steps.
    Gates: equal digests on both ranks after every step,
    path (d)'s staged bytes per rank per step, launches per rank per
    step as the shapes give (two positions), each rank's first loss
    within 2e-2 relative of (d)'s."""
    steps = 2
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True)
    want = expected_mesh_launches(cfg, 2)
    ranks = run_two_slice(["--mesh", MESH_TWO_SLICE, "--devices",
                           "cuda:0,cuda:0"], steps)
    res, _ = two_slice_summary(ranks, steps, want, "path (i) two slices")
    first = [res["losses"][r][0] for r in range(2)]
    rel = [abs(first[r] - d["losses"][r][0]) / abs(d["losses"][r][0])
           for r in range(2)]
    require(max(rel) <= MESH_LOSS_TOL, f"path (i) two slices first losses "
            f"{first} vs path (d)'s {[x[0] for x in d['losses']]}")
    return {**res, "mesh": MESH_TWO_SLICE, "devices": "cuda:0,cuda:0",
            "first_loss_rel_err_vs_d": rel,
            "expected_rule": "positions (2) x path (c)'s per step"}


def phase_mesh_two_slice_elastic(mesh2: dict, f: dict) -> dict:
    """Path (i), two meshed slices with the per-layer sync and
    ``--elastic-dir`` under the port's coordinator, 2 steps: path (i)'s
    two-slice command with ``--per-layer``, run as path (f) runs; rank 1
    SIGKILLs itself at its first bucket push of step 2 and is started
    again. Gates: ``elastic_path``'s, the parameter digests after every
    step equal to the fused two-slice run's of path (i) (same weights
    and batches: the per-layer sync changes no bit), launches per
    attempt two positions' of (c)'s, and the checkpoint file's bytes
    those of path (f)'s single-device file (the meshed file holds the
    same leaves, whole)."""
    cfg = dataclasses.replace(llama.LLAMA3_1B, remat=True)
    steps, buckets = 2, cfg.n_layers + 3
    out, _ = elastic_path(
        "path (i) per-layer elastic", steps, 2, buckets + 1,
        expected_mesh_launches(cfg, 2),
        extra=["--mesh", MESH_TWO_SLICE, "--devices", "cuda:0,cuda:0",
               "--per-layer"])
    require(out["digests"] == mesh2["digests"][:steps + 1],
            f"path (i) per-layer elastic digests {out['digests']} != the "
            f"fused two slices' {mesh2['digests']}")
    sizes = set(out["ckpt_bytes_by_rank"]) | set(f["ckpt_bytes_by_rank"])
    require(len(sizes) == 1, f"path (i) per-layer elastic checkpoint bytes "
            f"{out['ckpt_bytes_by_rank']} != path (f)'s "
            f"{f['ckpt_bytes_by_rank']}")
    return {**out, "mesh": MESH_TWO_SLICE, "devices": "cuda:0,cuda:0",
            "per_layer": True, "killed_at_bucket_push": buckets + 1,
            "digests_equal_fused_two_slices": True,
            "path_f_ckpt_bytes": f["ckpt_bytes_by_rank"][0]}


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The elastic soak (``tools/torch_fault_soak.py``) at llama3-1b's widths,
# bf16, cut from 16 layers to 2: with a checkpoint every step, 16 layers
# cost 5.34 GB a save (path (f): 7-11 s each), 2 layers 1.37 GB.
SOAK_CFG = dataclasses.replace(llama.LLAMA3_1B, n_layers=2)
SOAK_MIXED = (3, 1)     # (steps, seed) of the reference's tier-1 mixed plan
SOAK_FLAP = (2, 5)      # of its arbitrated flap (rank 1 at its 2nd sync)
# A conn clause that never fires: its arrival count is the posts of the
# mixed plan's clean run, from which the drop's N is chosen.
SOAK_COUNTING_PLAN = "conn:drop_after=1000000000000000"
# A survivor's teardown can wait in the native ring destroy until the
# ring's running op reaches its stall deadline, TDR_RING_TIMEOUT_MS
# (ROADMAP Queue 3: 30 s by default, 120 s in path (f)). The soak's
# deadline, far above a sync or a checkpoint at this size (about 2 s),
# bounds that wait inside the phase's budget; a resume's stacks are
# dumped every 10 s so such a wait still leaves its stack.
SOAK_RING_TIMEOUT_MS = "15000"
SOAK_STACKS_EVERY_S = 10


def load_path(name: str, *parts):
    """A module of the repo that is not in a package (a tool, an
    example), by path."""
    spec = importlib.util.spec_from_file_location(name, REPO.joinpath(*parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def watched_resumes(stacks_path: str, resumes: list, every_s: int):
    """``Trainer._resume`` of every rank thread noted (its attempt and
    error) in ``resumes`` and, while any rank resumes, every thread's
    stack appended to ``stacks_path`` every ``every_s`` seconds: the
    elastic paths' dump, in process."""
    resume = Trainer._resume
    lock = threading.Lock()
    active = [0]
    f = open(stacks_path, "a")

    def watched(self, exc, attempt):
        with lock:
            active[0] += 1
            if active[0] == 1:
                f.write(f"resume at {time.monotonic()}: {str(exc)[:300]}\n")
                f.flush()
                faulthandler.dump_traceback_later(every_s, repeat=True,
                                                  file=f)
        try:
            return resume(self, exc, attempt)
        finally:
            with lock:
                active[0] -= 1
                if active[0] == 0:
                    faulthandler.cancel_dump_traceback_later()
            resumes.append({"attempt": attempt, "error": str(exc)[:160]})

    Trainer._resume = watched
    try:
        yield
    finally:
        Trainer._resume = resume
        faulthandler.cancel_dump_traceback_later()
        f.close()


@contextlib.contextmanager
def counted_posts(seen: list):
    """The soak re-parses the fault plan at its start and after its run
    (``fault_plan_reset``), zeroing the clauses' counts: append the
    first clause's arrivals to ``seen`` just before each."""
    reset = eng.fault_plan_reset

    def read_then_reset():
        if eng.fault_plan_clauses():
            seen.append(eng.fault_plan_seen(0))
        reset()

    eng.fault_plan_reset = read_then_reset
    try:
        yield
    finally:
        eng.fault_plan_reset = reset


def phase_soak_elastic() -> dict:
    """``tools/torch_fault_soak.py``'s ``run_soak`` on the card: two rank
    threads of this process at llama3-1b's widths (bf16, 2 layers), each
    ``Trainer(elastic=ElasticPolicy(save_every=1))`` behind a fused
    ``CrossSliceAllReduce`` over a world-2 emu ring. (a) the reference's
    tier-1 mixed plan, ``make_fault_plan(1, 3)`` and a connection drop
    after N posts, N half the posts of the clean run (so the drop lands
    mid-run at this size); (b) the arbitrated flap, an in-process
    coordinator and rank 1 tearing its transport down in its 2nd sync,
    2 steps. Each against its own clean run. Gates: final parameters
    bitwise the clean run's on both ranks (``run_soak`` holds the ranks
    bitwise equal); (a) every clause fired (3 hits), a resume, 2
    rebuilds and a detected corruption; (b) a resume, a coordinator
    rebuild and one final generation >= 1; each run's launches one
    train step's per step attempt (steps x ranks + resumes)."""
    tfs = load_path("torch_fault_soak", "tools", "torch_fault_soak.py")
    per_attempt = expected_train_launches(llama.Llama(SOAK_CFG, "cuda"), 1)
    # Checkpoints under the temporary directory: 2 ranks x (the file and
    # its .tmp) a run, each run's removed after it.
    ckpt_bytes = 3 * grad_bytes(SOAK_CFG)
    root = tempfile.mkdtemp(prefix="tdr-soak-")
    free = shutil.disk_usage(root).free
    require(free >= 4 * ckpt_bytes + (1 << 30), f"the soak needs "
            f"{4 * ckpt_bytes} bytes for its checkpoints, {root} has "
            f"{free} free")
    runs, resumes, seen = {}, [], []
    prev_timeout = os.environ.get("TDR_RING_TIMEOUT_MS")
    os.environ["TDR_RING_TIMEOUT_MS"] = SOAK_RING_TIMEOUT_MS

    def soak(name, steps, seed, **kw):
        ckpt = os.path.join(root, name)
        _native.reset_launches()
        since = time.monotonic()
        final, stats = tfs.run_soak(steps, seed, ckpt_dir=ckpt,
                                    config=SOAK_CFG, device="cuda", **kw)
        launches = _native.launches()
        saves = [f for at, _, f in trace.events("ckpt.save") if at >= since]
        attempts = steps * 2 + stats["resumes"]
        require(launches == {k: v * attempts
                             for k, v in per_attempt.items()},
                f"soak {name}: launches {launches} != {per_attempt} x "
                f"{attempts} step attempts")
        sizes = [os.path.getsize(os.path.join(ckpt, f"rank{r}.npz"))
                 for r in range(2)]
        shutil.rmtree(ckpt)
        runs[name] = {"ckpt_bytes_by_rank": sizes, "saves": len(saves),
                      "launches": launches, **stats}
        return final

    try:
        with watched_resumes(os.path.join(root, "stacks"), resumes,
                             SOAK_STACKS_EVERY_S):
            steps, seed = SOAK_MIXED
            with counted_posts(seen):
                clean = soak("a_clean", steps, seed,
                             fault_plan=SOAK_COUNTING_PLAN)
            # The last read is the run's end (the first, where the plan
            # was parsed at the run's start, reads 0).
            require(seen and seen[-1] > 0
                    and runs["a_clean"]["fault_hits"] == 0,
                    f"soak (a) clean: posts {seen}, hits "
                    f"{runs['a_clean']['fault_hits']}")
            drop_after = seen[-1] // 2
            plan = (tfs.make_fault_plan(seed, steps)
                    + f",conn:drop_after={drop_after}")
            faulty = soak("a_mixed_plan", steps, seed, fault_plan=plan)
            a = runs["a_mixed_plan"]
            require(tfs.params_equal(clean, faulty),
                    f"soak (a): final params differ from the clean run's "
                    f"({a})")
            require(a["fault_hits"] >= 3 and a["resumes"] >= 1
                    and a["rebuilds"] >= 2 and a["integrity_failed"] >= 1,
                    f"soak (a) counters: {a}")
            del clean, faulty
            steps, seed = SOAK_FLAP
            clean = soak("b_clean", steps, seed)
            faulty = soak("b_arbitrated_flap", steps, seed,
                          coordinator=True, flap=(1, 2))
            b = runs["b_arbitrated_flap"]
            require(tfs.params_equal(clean, faulty),
                    f"soak (b): final params differ from the clean run's "
                    f"({b})")
            require(b["resumes"] >= 1 and b["ctl"].get("ctl.rebuild", 0) >= 1
                    and len(b["generations"]) == 1
                    and b["generations"][0] >= 1, f"soak (b) counters: {b}")
            require(tfs.hb_thread_census() == 0,
                    "soak (b) left coordinator heartbeat threads running")
        text = Path(root, "stacks").read_text()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if prev_timeout is None:
            os.environ.pop("TDR_RING_TIMEOUT_MS", None)
        else:
            os.environ["TDR_RING_TIMEOUT_MS"] = prev_timeout
    routes = {name: kernel_route(name, SOAK_CFG.head_dim, SOAK_CFG.dtype)
              for name in FLASH_KERNELS}
    require(set(routes.values()) == {TC}, f"soak routes {routes}")
    return {"config": f"{SOAK_CFG.name}/bf16/{SOAK_CFG.n_layers} layers",
            "world": 2, "ranks": "threads of this process on cuda:0",
            "routes": routes,
            "checkpoint_dir": os.path.dirname(root),
            "checkpoint_dir_free_bytes": free,
            "ring_timeout_ms": int(SOAK_RING_TIMEOUT_MS),
            "plan_a": plan, "posts_a_clean": seen[-1],
            "drop_after": drop_after, "flap": [1, 2],
            "parity": {"a": True, "b": True}, "runs": runs,
            "resumes": resumes,
            "resume_stacks": [text] if "File " in text else [],
            "launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in per_attempt},
            "launches_per_step_attempt": per_attempt}


# The demo at llama3-1b's attention widths and path (g)'s context.
DEMO_SHAPE = {"world": 2, "seq_local": 4096, "heads": 16, "kv_heads": 8,
              "head_dim": 128}


def phase_ring_attention_demo() -> dict:
    """``examples/ring_attention_demo_torch.py`` on the card: two rank
    threads of a world-2 emu ring each run ``RingAttention.forward`` and
    ``.backward`` (explicit calls, no autograd) on its 4096-token shard
    of one causal f32 sequence of 8192 (H16 KVH8 D128; K3, K5 and K4 on
    their scalar routes); the output and the three gradients held
    against the full-sequence ``attention_reference`` and its autograd
    gradients on the card, in f32 (TF32 off), to the demo's 2e-3. The
    launches: one K3, K5 and K4 per visible (q shard, kv shard) pair,
    world + world (world - 1) / 2 of them."""
    demo = load_path("ring_attention_demo_torch", "examples",
                     "ring_attention_demo_torch.py")
    w = DEMO_SHAPE["world"]
    _native.reset_launches()
    res = demo.ring_attention_demo(port=free_port() + 300, device="cuda",
                                   **DEMO_SHAPE)
    launches = _native.launches()
    pairs = w + w * (w - 1) // 2
    want = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "flash_fwd": pairs,
            "flash_bwd_dq": pairs, "flash_bwd_dkv": pairs, "decode_attn": 0,
            **NOT_ON_LLAMA}
    require(launches == want, f"demo launches {launches} != {want}")
    errs = demo.max_errors(res)
    require(max(errs.values()) < demo.TOL,
            f"demo: ring attention against full attention {errs}")
    routes = {name: kernel_route(name, DEMO_SHAPE["head_dim"],
                                 torch.float32) for name in FLASH_KERNELS}
    require(set(routes.values()) == {"scalar"}, f"demo routes {routes}")
    return {"shape": DEMO_SHAPE, "seq": w * DEMO_SHAPE["seq_local"],
            "dtype": "float32", "causal": True, "routes": routes,
            "max_abs_err": errs, "tol": demo.TOL, "launches": launches}


# The overlap smoke's model: llama-tiny at the tool's 6 layers.
OVERLAP_CFG = dataclasses.replace(llama.LLAMA_TINY, n_layers=6)


def phase_overlap_smoke() -> dict:
    """``tools/torch_overlap_smoke.py`` with ``TDR_OVERLAP_QUICK=1`` and
    no ``--cpu``: two rank processes on the card, each running the
    per-layer int8 pair and the fused f32 pair for its rank and checking
    its own censuses, ``pending_async`` and losses (a failed gate exits
    non-zero). Held here: the exit code, two rank processes, wire events,
    and each rank's launches those of the steps it ran. The censuses,
    losses and fractions are reported, not gated again."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_overlap_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "TDR_OVERLAP_QUICK": "1"})
    require(proc.returncode == 0,
            f"overlap smoke exited {proc.returncode}: "
            f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    lines = {ln.split(" ", 1)[0]: ln for ln in proc.stdout.splitlines()
             if ln.startswith(("OVERLAP ", "OVERLAP_DETAIL "))}
    print(lines["OVERLAP"], flush=True)
    rec = json.loads(lines["OVERLAP"].split(" ", 1)[1])
    detail = json.loads(lines["OVERLAP_DETAIL"].split(" ", 1)[1])
    require(detail["ranks"] == "processes" and len(detail["per_rank"]) == 2,
            f"overlap smoke ranks {detail['ranks']}")
    require(rec["wire_events"] > 0, "overlap smoke: no wire events")
    model = llama.Llama(OVERLAP_CFG, device="cpu")
    launches = {name: 0 for name in _native.launches()}
    for rk in detail["per_rank"]:
        want = expected_train_launches(model, rk["steps_run"])
        require(rk["launches"] == want,
                f"rank {rk['rank']} launches {rk['launches']} != {want}")
        for name, n in rk["launches"].items():
            launches[name] += n
    routes = {name: kernel_route(name, OVERLAP_CFG.head_dim, torch.float32)
              for name in FLASH_KERNELS}
    keep = ("census", "pending_async", "losses", "fused_losses",
            "steps_run")
    return {"config": "llama-tiny", "n_layers": OVERLAP_CFG.n_layers,
            "dtype": "float32", "routes": routes, "launches": launches,
            "device": detail["device"],
            "overlap_fraction": rec["overlap_fraction"],
            "compute_overlap_fraction": rec["compute_overlap_fraction"],
            "windows": rec["windows"],
            "compute_windows": rec["compute_windows"],
            "compute_gate": rec["compute_gate"],
            "wire_events": rec["wire_events"],
            "per_rank": [{k: rk[k] for k in keep}
                         for rk in detail["per_rank"]]}


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    extra = None
    if isinstance(out, tuple):
        out, extra = out
    emit({"phase": name, "seconds": time.perf_counter() - t0, **out})
    return out if extra is None else (out, extra)


def kernel_entry(name, replaces, by_path, case, err, ms, bound, by,
                 **extra) -> dict:
    """One entry of the ``kernels`` line: ``replaces`` is the TPU
    kernel's file:line under ``rocnrdma_tpu/ops/``; ``by_path(name)``
    gives its launches on each path."""
    launches = by_path(name)
    return {"name": name, "route": "cuda",
            "source": f"rocnrdma_tpu_torch/csrc/{name}.cu",
            "replaces": f"rocnrdma_tpu/ops/{replaces}",
            "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": case["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": case["library_ms"],
            "shape": case.get("shape") or [case["rows"], case["d"]],
            "dtype": case["dtype"], "verdict": "within tolerance", **extra}


def main() -> int:
    run_phase("device", phase_device)
    run_phase("build", phase_build)
    rms = run_phase("k1_rmsnorm_vs_plain", phase_rmsnorm)
    fl = run_phase("k3_flash_vs_plain", phase_flash)
    rms_bwd = run_phase("k2_rmsnorm_bwd_vs_plain", phase_rmsnorm_bwd)
    fl_bwd = run_phase("k4_k5_flash_bwd_vs_plain", phase_flash_bwd)
    k6 = run_phase("k6_decode_attn_vs_plain", phase_decode_attn)
    k7g1 = run_phase("k7_g1_mla_moe_vs_plain", phase_mla_moe_kernels)
    gen = run_phase("path_a_generate_llama3_8b", phase_generate_8b)

    cfg1 = dataclasses.replace(llama.LLAMA3_1B, dtype=torch.float32)
    state = llama.init_params(cfg1, seed=1, device="cuda")
    _, model1 = run_phase("path_parity_llama3_1b_f32", phase_parity,
                          state, cfg1)
    bat, pages1 = run_phase("path_b_batcher_llama3_1b_f32", phase_batcher,
                            state, cfg1, model1)
    jit = run_phase("path_b_jit_batcher_llama3_1b_f32", phase_batcher_jit,
                    cfg1, model1, pages1, bat)
    del model1, pages1
    torch.cuda.empty_cache()
    run_phase("hf_import_llama3_1b", phase_hf_import, state, cfg1)
    serve = run_phase("path_h_serve_two_slice_llama3_1b_f32",
                      phase_serve_two_slice, cfg1, bat)
    train = run_phase("path_c_train_llama3_1b_bf16", phase_train_1b)
    dots = run_phase("path_c_train_llama3_1b_bf16_dots", phase_train_1b_dots,
                     train)
    run_phase("train_parity_llama3_1b_f32", phase_train_parity, state, cfg1)
    run_phase("path_i_mesh_parity_llama3_1b_f32", phase_mesh_parity, state,
              cfg1)
    del state
    torch.cuda.empty_cache()
    mesh = run_phase("path_i_mesh_dp2_tp2_llama3_1b_bf16", phase_mesh_train,
                     train)
    run_phase("hbm_cuda_exporter", phase_hbm_cuda_exporter)
    run_phase("xslice_sync_vs_plain", phase_xslice)
    dp = run_phase("path_d_two_slice_dp_llama3_1b_bf16", phase_two_slice_dp,
                   train["launches_per_step"])
    dpl = run_phase("path_e_two_slice_dp_per_layer_llama3_1b_bf16",
                    phase_two_slice_dp_per_layer,
                    train["launches_per_step"], dp)
    ela = run_phase("path_f_two_slice_elastic_llama3_1b_bf16",
                    phase_two_slice_elastic, train["launches_per_step"], dp)
    run_phase("sp_parity_llama3_1b_f32", phase_sp_parity)
    sp = run_phase("path_g_seq_parallel_llama3_1b_bf16", phase_seq_parallel)
    mesh2 = run_phase("path_i_mesh_two_slice_llama3_1b_bf16",
                      phase_mesh_two_slice, dp)
    mesh_ela = run_phase(
        "path_i_mesh_two_slice_per_layer_elastic_llama3_1b_bf16",
        phase_mesh_two_slice_elastic, mesh2, ela)
    soak = run_phase("soak_elastic_llama3_1b_bf16", phase_soak_elastic)
    demo = run_phase("ring_attention_demo_llama3_1b_f32",
                     phase_ring_attention_demo)
    ovl = run_phase("overlap_smoke_llama_tiny", phase_overlap_smoke)

    def by_path(name):
        return {"a_generate": gen["launches"][name],
                "b_batcher": bat["launches"][name],
                "b_jit_batcher": jit["launches"][name],
                "c_train": train["launches"][name],
                "c_train_dots": dots["launches"][name],
                "d_two_slice_dp": dp["launches"][name],
                "e_two_slice_dp_per_layer": dpl["launches"][name],
                "f_two_slice_elastic": ela["launches"][name],
                "g_seq_parallel_ring": sp["ring"]["launches"][name],
                "g_seq_parallel_ulysses": sp["ulysses"]["launches"][name],
                "h_serve_two_slice": serve["launches"][name],
                "i_mesh_dp2_tp2": mesh["launches"][name],
                "i_mesh_two_slice": mesh2["launches"][name],
                "i_mesh_two_slice_per_layer_elastic":
                    mesh_ela["launches"][name],
                "soak_elastic": soak["launches"][name],
                "ring_attention_demo": demo["launches"][name],
                "overlap_smoke": ovl["launches"][name]}

    k1, k3, k3c = rms["cases"][0], fl["cases"][0], fl["cases"][6]
    k2, k45 = rms_bwd["cases"][0], fl_bwd["cases"][0]
    whole = "plain_ms and library_ms are of the whole attention backward"
    keys = ("shape", "causal", "max_abs_err", "ms", "bound_ms", "bound_by",
            "plain_ms", "library_ms")
    def fwd(idx):
        """Timed forward cases by index."""
        return [{key: fl["cases"][i][key] for key in keys + ("route",)}
                for i in idx]

    def bwd(kernel, errs, idx):
        """Timed cases of a backward kernel by index."""
        return [{"shape": c["shape"], "causal": c["causal"],
                 "merged_lse": c["merged_lse"], "route": c[
                     "dq_route" if kernel == "dq" else "dkv_route"],
                 "max_abs_err": max(c[e + "_max_abs_err"] for e in errs),
                 "ms": c[kernel + "_ms"], "bound_ms": c[kernel + "_bound_ms"],
                 "bound_by": c[kernel + "_bound_by"],
                 "plain_ms": c["plain_ms"], "library_ms": c["library_ms"]}
                for c in (fl_bwd["cases"][i] for i in idx)]
    kernels = [
        kernel_entry("rmsnorm_fwd", "rmsnorm.py:48", by_path, k1,
                     k1["max_abs_err"], k1["ms"], k1["bound_ms"],
                     k1["bound_by"], graphed=rms["graphed"]),
        kernel_entry("rmsnorm_bwd", "rmsnorm.py:141", by_path, k2,
                     max(k2["max_abs_err"], k2["dw_max_abs_err"]), k2["ms"],
                     k2["bound_ms"], k2["bound_by"]),
        kernel_entry("flash_fwd", "attention.py:119", by_path, k3,
                     k3["max_abs_err"], k3["ms"], k3["bound_ms"],
                     k3["bound_by"], instance=k3["route"],
                     path_c={key: k3c[key] for key in (
                         "shape", "route", "max_abs_err", "ms", "bound_ms",
                         "bound_by", "library_ms")},
                     path_g=fwd(fl["path_g"]), path_i=fwd([fl["path_i"]]),
                     scalar_f32=fwd(fl["scalar_f32"])),
        kernel_entry("flash_bwd_dkv", "attention.py:275", by_path, k45,
                     max(k45["dk_max_abs_err"], k45["dv_max_abs_err"]),
                     k45["dkv_ms"], k45["dkv_bound_ms"],
                     k45["dkv_bound_by"], note=whole,
                     instance=k45["dkv_route"],
                     path_g=bwd("dkv", ("dk", "dv"), fl_bwd["path_g"]),
                     path_i=bwd("dkv", ("dk", "dv"), [fl_bwd["path_i"]]),
                     scalar_f32=bwd("dkv", ("dk", "dv"),
                                    fl_bwd["scalar_f32"])),
        kernel_entry("flash_bwd_dq", "attention.py:322", by_path, k45,
                     k45["dq_max_abs_err"], k45["dq_ms"], k45["dq_bound_ms"],
                     k45["dq_bound_by"], note=whole,
                     instance=k45["dq_route"],
                     path_g=bwd("dq", ("dq",), fl_bwd["path_g"]),
                     path_i=bwd("dq", ("dq",), [fl_bwd["path_i"]]),
                     scalar_f32=bwd("dq", ("dq",), fl_bwd["scalar_f32"]))]
    k6a = k6["cases"][0]
    kernels.append({
        **kernel_entry("decode_attn", "", by_path, k6a, k6a["max_abs_err"],
                       k6a["ms"], k6a["bound_ms"], k6a["bound_by"]),
        "replaces": "none: the cached einsum pair of "
                    "rocnrdma_tpu/models/llama.py:238-246",
        "cells": [{key: c[key] for key in ("shape", "pos", "dtype",
                                           "max_abs_err", "ms", "bound_ms",
                                           "bound_by", "plain_ms",
                                           "library_ms")}
                  for c in k6["cases"][1:5]]})
    cell_keys = ("shape", "max_abs_err", "ms", "bound_ms", "bound_by",
                 "plain_ms", "library_ms")
    k7a = k7g1["k7"][0]
    kernels.append({
        **kernel_entry("mla_decode", "", by_path, k7a, k7a["max_abs_err"],
                       k7a["ms"], k7a["bound_ms"], k7a["bound_by"]),
        "replaces": "none: the JAX package has no latent attention",
        "cells": [{key: c[key] for key in cell_keys + ("pos",)}
                  for c in k7g1["k7"][:2] + k7g1["k7_32"][:2]]})
    g1a = k7g1["g1"][0]
    for name in ("moe_gemm_up", "moe_gemm_down"):
        kernels.append({
            **kernel_entry(name, "", by_path, g1a, g1a["max_abs_err"],
                           g1a["ms"], g1a["bound_ms"], g1a["bound_by"]),
            "replaces": "none: the JAX package has no experts",
            "note": "G1: ms, plain_ms and bound_ms are of the whole grouped "
                    "SwiGLU (align, both GEMMs, K8's pick sum); many_rows "
                    "times each GEMM alone over a 65,536-token chunk",
            "cells": [{key: c[key] for key in cell_keys + ("block_rows",)}
                      for c in k7g1["g1"][:2]],
            "many_rows": {key: k7g1["g1"][1][key] for key in (
                "up_ms", "up_bound_ms", "down_ms", "down_bound_ms",
                "gemms_ms", "gemms_bound_ms", "gemms_share_of_bound")}})
    k8a = k7g1["k8"][0]
    kernels.append({
        **kernel_entry("moe_combine", "", by_path, k8a, k8a["max_abs_err"],
                       k8a["ms"], k8a["bound_ms"], k8a["bound_by"]),
        "replaces": "none: the JAX package has no experts",
        "note": "K8: plain_ms is the torch combine it replaced (gathers, "
                "f32 widenings and adds, the shared add), bitwise equal",
        "cells": [{key: c[key] for key in cell_keys + ("block_rows",)}
                  for c in k7g1["k8"][:2]]})
    k9a = k7g1["k9"][0]
    kernels.append({
        **kernel_entry("kda_recurrent", "", by_path, k9a, k9a["max_abs_err"],
                       k9a["ms"], k9a["bound_ms"], k9a["bound_by"]),
        "replaces": "none: the JAX package has no linear attention",
        "note": "K9: plain_ms is its plain version in torch (the "
                "convolution, the l2norms and the per-token loop, eager)",
        "cells": [{key: c[key] for key in cell_keys + ("state_max_abs_err",)}
                  for c in k7g1["k9"][:2]]})
    emit({"kernels": kernels})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
