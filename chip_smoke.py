#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``rocnrdma_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the five CUDA kernels from ``rocnrdma_tpu_torch/csrc/`` with
nvcc, holds each against its plain PyTorch version at its path's shapes
(and ragged, f32/bf16, causal/full variants), shows each backward kernel
bitwise deterministic across two calls, times each, then drives the
serving and training paths through the entry points a user calls. K3
(``flash_fwd``), K4 (``flash_bwd_dkv``) and K5 (``flash_bwd_dq``) have
two instances each, a tensor-core one (bf16 at D 64 and 128) and a
scalar one (f32, bf16 at D 16 and 32): every case of theirs prints the
``route`` the library chose, both routes are held against the plain
versions, and the cases at the shapes of paths (a) and (c) must report
the tensor-core route.

- path (a): ``generate`` at llama3-8b (all 32 layers, bf16, random
  weights from ``init_params(seed=0)``), batch 4, prompt 512, 32 new
  tokens — prefill ms, decode tok/s, peak memory, launch counts;
- parity: llama3-1b in f32, full-forward logits of a 128-token prompt
  on the card (kernels) against the same model on the CPU (plain
  versions);
- path (b): the loopback ``ContinuousBatcher`` at llama3-1b f32 over
  streamed weight pages, four requests and a fifth that joins mid-run,
  each request's greedy tokens held against ``generate`` on the same
  weights;
- path (c): ``Trainer("llama3-1b", remat=True)`` in bf16, all 16
  layers, batch 2, seq 2048 (the shape of
  ``examples/train_single_chip.py``), one warm step then 4 timed steps
  on one batch — step ms, tokens/s, model-FLOP share of the bf16 peak,
  device busy vs wall, peak memory, losses, launch counts;
- training parity: llama3-1b in f32, batch 1, seq 200, loss and every
  parameter's gradient on the card (kernels) against the CPU (plain
  versions), then the parameters after one AdamW step;
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
  mode's cold and warm gather / ring / scatter ms;
- the ring by message size: the port's ``tools/allreduce.py`` at world
  2 in bf16, 4 MiB, 64 MiB and 1 GiB, as two rank processes and as two
  threads of one process, each with its link tier, and the 64 MiB case
  across processes once more with the flight recorder on;
- path (d): ``examples/two_slice_dp_torch.py`` as two rank processes on
  the card, llama3-1b bf16 with remat, batch 2 x seq 2048 per rank, the
  gradients averaged over the emu ring each step: losses, equal
  parameter digests on both ranks after every step, launches per step
  equal to path (c)'s, staged bytes, the grads / sync / apply split;
- path (e): path (d)'s command with ``--per-layer`` and
  ``TDR_TELEMETRY=1``: each layer's gradients pushed from the backward
  by post-accumulate-grad hooks; path (d)'s gates, parameter digests
  equal to path (d)'s after every step, the overlap fractions, the
  recorder's dropped count and the ring's time split by native event.

Every phase prints one JSON line with its seconds. Each kernel's launch
counter is set to 0 just before a path runs and read just after; the
path fails unless every kernel ran there as often as the model says.
Then one ``{"kernels": [...]}`` line, the card's name and power limit
as nvidia-smi gives them, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero without that line; it also fails at once where
``torch.cuda.is_available()`` is false.

TF32 is switched off for matmuls and cuDNN (both flags set below), so
f32 products on the card run in full f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rocnrdma_tpu_torch.collectives.staging import staging
from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.hbm import cuda as hcuda
from rocnrdma_tpu_torch.hbm.registry import (HbmError, PeerClient,
                                             RegistrationManager)
from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (
    flash_attention_bwd_reference, flash_attention_lse,
    flash_attention_lse_reference, flash_attention_shard_grads,
    flash_bwd_dkv, flash_bwd_dq, kernel_route)
from rocnrdma_tpu_torch.ops.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                            rmsnorm_bwd_reference,
                                            rmsnorm_reference)
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from rocnrdma_tpu_torch.serving.batcher import ContinuousBatcher, Request
from rocnrdma_tpu_torch.serving.model import ServeConfig, pack_llama_params
from rocnrdma_tpu_torch.transport import engine as eng

REPO = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type

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
TOL = {("rmsnorm", torch.float32): (1e-5, 1e-5),
       ("rmsnorm", torch.bfloat16): (2 ** -7, 2 ** -7),
       ("flash", torch.float32): (2e-4, 2e-4),
       ("flash", torch.bfloat16): (2e-2, 2e-2),
       ("lse", None): (2e-4, 2e-4),
       ("dw", None): (1e-4, 1e-3)}

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
BF16_PEAK = PEAK_OPS[torch.bfloat16]


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


def profile_steps(step, n: int) -> dict:
    """Device time per call of ``step`` from torch.profiler (CUPTI): the
    sum of kernel times, the kernels launched, and the six costliest
    kernels, with the host wall time of the same profiled calls and the
    card's idle share over it (1 - busy / wall). ``None`` where the
    profiler saw no device activity. Ranges that code marks on the
    device timeline (user annotations such as
    ``Optimizer.step#AdamW.step``) span kernels and are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    notes = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in notes]
    busy = sum(e.self_device_time_total for e in kern) / n / 1e3
    if not kern or busy <= 0:
        return {"profiled_wall_ms": wall, "device_ms": None,
                "idle_share": None, "kernels": None, "top": None}
    # One stream runs the kernels one at a time: more busy time than
    # wall time means the profile counted something twice.
    require(busy <= wall, f"profiled device busy {busy} ms exceeds the "
                          f"wall time {wall} ms of the same calls")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    def ms_of(match) -> float:
        return sum(e.self_device_time_total for e in kern
                   if match(e.key)) / n / 1e3

    ours = {name: ms_of(lambda key, nm=name: nm in key)
            for name in _native.KERNELS}
    return {"profiled_wall_ms": wall, "device_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "kernels": sum(e.count for e in kern) / n,
            "annotations_not_counted": sorted(notes),
            "ported_kernel_ms": ours,
            "library_gemm_ms": ms_of(lambda key: any(
                t in key.lower() for t in ("nvjet", "gemm", "cutlass",
                                           "xmma"))),
            "foreach_ms": ms_of(lambda key: "multi_tensor_apply" in key),
            "top": [{"kernel": e.key[:90],
                     "ms": e.self_device_time_total / n / 1e3,
                     "calls": e.count / n} for e in top]}


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
    secs = _native.build()
    for name in _native.KERNELS:
        _native.library(name)
    res = kernel_resources()
    # The tensor-core kernels keep their accumulators in registers; a
    # stack frame there means spilled accumulators.
    tc = {k: r for k, r in res.items() if k.startswith("tc::")}
    require(len(tc) == 6 and all(r["stack"] == 0 and r["local"] == 0
                                 for r in tc.values()),
            f"tensor-core kernels missing or spilling: {tc}")
    return {"compile_s": secs, "resources": res}


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
        elt = x.element_size()
        sets = input_sets((x, w), out_bytes=x.numel() * elt)
        lib_sets = [(a, b.to(dtype)) for a, b in sets]
        res.update(
            ms=time_ms(lambda a, b: rmsnorm(a, b), sets),
            eager_ms=eager_ms(lambda: rmsnorm(x, w), 200),
            plain_ms=time_ms(lambda a, b: rmsnorm_reference(a, b), sets),
            library_ms=time_ms(lambda a, b: F.rms_norm(a, (d,), b, 1e-5),
                               lib_sets),
            bound_ms=(2 * rows * d * elt + 4 * d) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
    return res


def phase_rmsnorm() -> dict:
    cases = [rmsnorm_case(2048, 4096, torch.bfloat16, 1, True),   # path (a)
             rmsnorm_case(2048, 4096, torch.float32, 2, True),
             rmsnorm_case(1000, 4096, torch.bfloat16, 3, False),  # ragged
             rmsnorm_case(4, 4096, torch.bfloat16, 4, True),      # decode
             rmsnorm_case(256, 2048, torch.float32, 5, True),     # path (b)
             rmsnorm_case(4096, 2048, torch.bfloat16, 6, True)]   # path (c)
    return {"cases": cases}


def flash_bound_ms(b, h, kvh, s, d, causal, dtype) -> tuple:
    elt = torch.finfo(dtype).bits // 8
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4.0 * d * pairs * b * h
    nbytes = (2 * b * h * s * d + 2 * b * kvh * s * d) * elt + b * h * s * 4
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_case(b, h, kvh, s, d, dtype, causal, seed, timed,
               need_route=None) -> dict:
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
    if timed:
        bound, by = flash_bound_ms(b, h, kvh, s, d, causal, dtype)
        sets = input_sets((q, k, v), out_bytes=q.numel() * q.element_size())
        res.update(
            ms=time_ms(lambda *a: flash_attention_lse(*a, causal=causal),
                       sets, iters=8),
            eager_ms=eager_ms(lambda: flash_attention_lse(q, k, v,
                                                          causal=causal), 8),
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
             flash_case(1, 32, 8, 2048, 128, bf, True, 2, True),
             flash_case(1, 32, 8, 2048, 128, bf, False, 3, True),
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
             flash_case(1, 8, 4, 300, 32, bf, True, 14, False, "scalar")]
    return {"cases": cases}


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
        elt = x.element_size()
        sets = input_sets((x, w, dy), out_bytes=x.numel() * elt)
        lib_f, lib_fb = fwd_bwd_ms(
            lambda a, b: F.rms_norm(a, (d,), b, 1e-5), (x, w.to(dtype)), dy)
        res.update(
            ms=time_ms(lambda a, b, c: rmsnorm_bwd(a, b, c), sets),
            plain_ms=time_ms(lambda a, b, c: rmsnorm_bwd_reference(a, b, c),
                             sets),
            library_ms=lib_fb - lib_f, library_fwd_bwd_ms=lib_fb,
            bound_ms=(3 * rows * d * elt + 8 * d) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes")
    return res


def phase_rmsnorm_bwd() -> dict:
    bf, f32 = torch.bfloat16, torch.float32
    cases = [rmsnorm_bwd_case(4096, 2048, bf, 11, True),   # path (c)
             rmsnorm_bwd_case(4096, 2048, f32, 12, True),
             rmsnorm_bwd_case(1000, 2048, bf, 13, False),  # ragged
             rmsnorm_bwd_case(1000, 2048, f32, 14, False),
             rmsnorm_bwd_case(200, 2048, f32, 15, False)]  # train parity
    return {"cases": cases}


def flash_bwd_bounds(b, h, kvh, s, d, causal, dtype) -> dict:
    """Bound of each backward kernel: 8·D (K4) and 6·D (K5) operations
    per visible (q, k) pair per (b, h) over the dtype's peak, against
    the bytes of q, dO, k, v, lse, delta in and its outputs out."""
    elt = torch.finfo(dtype).bits // 8
    pairs = s * (s + 1) // 2 if causal else s * s
    q_bytes = b * h * s * d * elt
    kv_bytes = b * kvh * s * d * elt
    in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * b * h * s * 4
    out = {}
    for name, ops_per, out_bytes in (("flash_bwd_dkv", 8, 2 * kv_bytes),
                                     ("flash_bwd_dq", 6, q_bytes)):
        t_ops = ops_per * d * pairs * b * h / PEAK_OPS[dtype] * 1e3
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def flash_bwd_case(b, h, kvh, s, d, dtype, causal, seed, timed,
                   need_route=None) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, kvh, s, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
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
           "causal": causal, "dkv_route": route, "dq_route": dq_route,
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
        bounds = flash_bwd_bounds(b, h, kvh, s, d, causal, dtype)
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
             flash_bwd_case(2, 16, 8, 2048, 128, bf, False, 22, True, TC),
             flash_bwd_case(1, 32, 8, 2048, 128, bf, True, 23, True, TC),
             flash_bwd_case(1, 16, 8, 2048, 128, f32, True, 24, True),
             flash_bwd_case(1, 16, 8, 1000, 128, bf, True, 25, False),
             flash_bwd_case(1, 16, 8, 1000, 128, f32, False, 26, False),
             flash_bwd_case(1, 16, 8, 200, 128, f32, True, 27, False),
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
                            "scalar")]
    return {"cases": cases}


def expected_launches(cfg, forward_steps: int, prefills: int) -> dict:
    return {"rmsnorm_fwd": (2 * cfg.n_layers + 1) * forward_steps,
            "flash_fwd": cfg.n_layers * prefills,
            "rmsnorm_bwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


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
                "flash_bwd_dkv": attns}
    return {k: v * steps for k, v in per_step.items()}


def phase_generate_8b() -> dict:
    cfg = llama.LLAMA3_8B
    b, p, new = 4, 512, 32
    model = llama.Llama(cfg, device="cuda")
    model.load_state_dict(llama.init_params(cfg, seed=0, device="cuda"),
                          assign=True)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p))).cuda()
    llama.generate(model, prompt, 2)                  # warm cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = llama.generate(model, prompt, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _native.reset_launches()
    t0 = time.perf_counter()
    toks = llama.generate(model, prompt, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _native.launches()
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, forward_steps=new, prefills=1)
    require(launches == want, f"path (a) launches {launches} != {want}")

    require(tuple(toks.shape) == (b, new), f"tokens shape {toks.shape}")
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            "token ids out of range")
    require(bool((toks[:, 0] == first[:, 0]).all()),
            "generate is not deterministic across calls")
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
    breakdown = step_breakdown(model, prompt, toks)
    del model
    torch.cuda.empty_cache()
    return {"config": cfg.name, "batch": b, "prompt": p, "new_tokens": new,
            "prefill_ms": prefill_s * 1e3,
            "decode_tok_s": b * (new - 1) / (total_s - prefill_s),
            "generate_s": total_s, "peak_mem_gb": peak / 1e9,
            "teacher_forced_agreement": agree, "launches": launches,
            **breakdown}


def step_breakdown(model, prompt, toks) -> dict:
    """Where a prefill and a decode step of path (a) spend their time:
    host wall per step (eager, synchronised, no profiler), and the
    card's busy time against the wall time of the same profiled steps
    (idle share = 1 - busy / profiled wall)."""
    b, p = prompt.shape
    cfg = model.cfg
    with torch.inference_mode():
        cache = llama.init_cache(cfg, b, 640, "cuda")
        prefill = lambda: model(prompt, cache, 0)        # noqa: E731
        prefill_wall = eager_ms(prefill, 3)
        prefill_prof = profile_steps(prefill, 1)
        pos = [p]

        def decode():
            model(toks[:, :1], cache, pos[0])
            pos[0] += 1

        decode_wall = eager_ms(decode, 10)
        decode_prof = profile_steps(decode, 3)

    return {"prefill_step": {"wall_ms": prefill_wall, **prefill_prof},
            "decode_step": {"wall_ms": decode_wall, **decode_prof}}


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


def _compare_to_generate(model, req) -> dict:
    """Tokens of one request against generate() on the same weights.
    A mismatch is accepted only at a near-tie (top-2 logit gap < 1e-4
    at that step, from the reference): then compare up to it."""
    ref = llama.generate(model, torch.from_numpy(req.prompt[None]),
                         req.max_new_tokens).cpu()[0].tolist()
    got = req.tokens
    if got == ref:
        return {"req": req.id, "equal": True}
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    with torch.inference_mode():
        seq = torch.tensor([req.prompt.tolist() + ref[:j]]).cuda()
        top2 = model(seq)[0, -1].topk(2).values
    gap = float(top2[0] - top2[1])
    require(gap < 1e-4, f"request {req.id}: token {j} {got[j]} != {ref[j]} "
                        f"with top-2 gap {gap}")
    return {"req": req.id, "equal": False, "near_tie_at": j, "gap": gap}


def phase_batcher(state, cfg, model) -> dict:
    scfg = ServeConfig.from_llama(cfg)
    pages = pack_llama_params(scfg, llama.params_to_flax(state))
    rng = np.random.default_rng(2)
    reqs = [Request(i + 1, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(64, 257))), 16)
            for i in range(5)]
    batcher = ContinuousBatcher(None, pages, scfg, max_slots=4,
                                device="cuda")
    _native.reset_launches()
    t0 = time.perf_counter()
    for r in reqs[:4]:
        batcher.submit(r)
    batcher.step()
    batcher.step()
    batcher.submit(reqs[4])                           # joins mid-run
    batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _native.launches()
    batcher.close()
    want = expected_launches(cfg, forward_steps=sum(
        r.max_new_tokens for r in reqs), prefills=len(reqs))
    require(launches == want, f"path (b) launches {launches} != {want}")
    require(all(len(batcher.finished[r.id].tokens) == 16 for r in reqs),
            "a request did not finish")
    require(batcher.finished[5].joined_step > 0, "request 5 did not join "
                                                 "mid-run")
    checks = [_compare_to_generate(model, batcher.finished[r.id])
              for r in reqs]
    lat = np.asarray(batcher.token_lat_us)
    return {"config": cfg.name + "/f32", "requests": len(reqs),
            "prompts": [int(r.prompt.size) for r in reqs],
            "steps": batcher.step_no, "wall_s": wall,
            "token_lat_us_p50": float(np.percentile(lat, 50)),
            "token_lat_us_p99": float(np.percentile(lat, 99)),
            "page_bytes_per_step": pages.nbytes(),
            "vs_generate": checks, "launches": launches}


def model_flops(cfg, b: int, s: int) -> float:
    """Model FLOPs of one train step, remat recompute not counted:
    6 per matmul parameter per token (the layers' projections and the
    LM head; the embedding is a lookup) plus the causal attention
    products, 4·D per visible (q, k) pair per head forward, times 3 for
    forward and backward."""
    hd = cfg.head_dim
    per_layer = cfg.d_model * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 3 * cfg.d_model * cfg.d_ff
    matmul_params = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    pairs = s * (s + 1) // 2
    attn = 3 * 4 * hd * pairs * cfg.n_heads * b * cfg.n_layers
    return 6.0 * matmul_params * b * s + attn


def phase_train_1b() -> dict:
    cfg = llama.LLAMA3_1B
    b, s, steps = 2, 2048, 4
    trainer = Trainer(cfg, remat=True, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [trainer.step(tokens)]                   # warm
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    _native.reset_launches()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.step(tokens))          # float() syncs
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _native.launches()
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(trainer.model, steps)
    require(launches == want, f"path (c) launches {launches} != {want}")
    per_step = {k: v // steps for k, v in launches.items()}
    L = cfg.n_layers
    require(per_step == {"rmsnorm_fwd": 4 * L + 1, "flash_fwd": 2 * L,
                         "rmsnorm_bwd": 2 * L + 1, "flash_bwd_dq": L,
                         "flash_bwd_dkv": L},
            f"path (c) launches per step {per_step}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")

    prof = profile_steps(lambda: trainer.step(tokens), 1)
    mean_ms = float(np.mean(step_ms))
    flops = model_flops(cfg, b, s)
    del trainer
    torch.cuda.empty_cache()
    return {"config": cfg.name + "/bf16/remat", "batch": b, "seq": s,
            "lr": 3e-4, "weight_decay": 0.1, "warm_step_s": warm_s,
            "step_ms": step_ms, "step_ms_mean": mean_ms,
            "tokens_per_s": b * s / (mean_ms / 1e3),
            "model_tflop_per_step": flops / 1e12,
            "mfu_formula": "(6*matmul_params*B*S + 12*D*H*L*B*S(S+1)/2) "
                           "/ (step_s * 989e12), remat not counted",
            "mfu": flops / (mean_ms / 1e3) / BF16_PEAK,
            "peak_mem_gb": peak / 1e9, "losses": losses,
            "launches": launches, "launches_per_step": per_step,
            "profiled_step": prof}


def phase_train_parity(state, cfg) -> dict:
    """llama3-1b f32, one Trainer step on the card and on the CPU from
    the same weights: loss, every gradient, then every parameter."""
    b, s, lr = 1, 200, 3e-4
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s + 1)))
    gpu = Trainer(cfg, device="cuda", params=state, learning_rate=lr)
    loss_g = gpu.step(tokens)
    cpu = Trainer(cfg, device="cpu", learning_rate=lr,
                  params={k: v.cpu() for k, v in state.items()})
    loss_c = cpu.step(tokens)
    require(abs(loss_g - loss_c) <= TRAIN_LOSS_TOL,
            f"train loss card {loss_g} vs CPU {loss_c}")
    worst_grad, worst_param, worst_decided = 0.0, 0.0, 0.0
    far, decided, total = 0, 0, 0
    cpu_params = dict(cpu.model.named_parameters())
    for name, pg in gpu.model.named_parameters():
        pc = cpu_params[name]
        gc = pc.grad.cuda()
        gmax = gc.abs().max()
        rel = float((pg.grad - gc).abs().max() / gmax.clamp_min(1e-30))
        require(rel <= TRAIN_GRAD_TOL, f"grad {name}: rel err {rel}")
        worst_grad = max(worst_grad, rel)
        diff = (pg.detach() - pc.detach().cuda()).abs()
        dmax = float(diff.max())
        require(dmax <= 2 * lr + 1e-6, f"param {name}: max diff {dmax}")
        worst_param = max(worst_param, dmax)
        mask = (gc.abs() > 1e-2 * gmax) & (gc.abs() > 1e-6)
        if bool(mask.any()):
            dec = float(diff[mask].max())
            require(dec <= TRAIN_DECIDED_TOL,
                    f"param {name}: decided elements differ by {dec}")
            worst_decided = max(worst_decided, dec)
        decided += int(mask.sum())
        far += int((diff > 1e-5).sum())
        total += diff.numel()
    require(decided > 0, "no parameter's update was decided by its gradient")
    require(far <= total // 10000, f"{far} of {total} params differ > 1e-5")
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"config": cfg.name + "/f32", "batch": b, "seq": s,
            "loss_card": loss_g, "loss_cpu": loss_c,
            "loss_tol": TRAIN_LOSS_TOL,
            "grad_max_rel_err": worst_grad, "grad_tol": TRAIN_GRAD_TOL,
            "param_max_abs_diff_after_step": worst_param,
            "param_tol": 2 * lr + 1e-6,
            "decided_params": decided,
            "decided_max_abs_diff": worst_decided,
            "decided_tol": TRAIN_DECIDED_TOL,
            "params_over_1e-5": far, "params": total}


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
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        for e in errs:
            if e is not None:
                raise e
        return time.perf_counter() - t0

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
            wall = run(shims, tr)
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
            split = [{k.replace("_s", "_ms"): v * 1e3
                      for k, v in s.last_split.items()} for s in shims]
            calls[name] = {"wall_ms": wall * 1e3, "staged_bytes": staged,
                           "split_ms_by_rank": split}
            if mode == "fused":
                calls[name]["ring_bus_gb_s"] = tree_bytes / min(
                    s.last_split["ring_s"] for s in shims) / 1e9
            del tr, want, ins
        for s in shims:
            s.close()
        calls["bitwise_vs_fused"] = not mode.startswith("wire")
        res[mode] = calls
    res["bus_formula"] = "tree bytes * 2(n-1)/n / ring_s, n = 2"
    res["split_note"] = ("overlap modes: gather = start() (enqueue every "
                         "D2H, wait, compress, launch), ring = finish()'s "
                         "wait on the handles, scatter = write-back")
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


def run_two_slice(extra: list, steps: int, env=None) -> list:
    """``examples/two_slice_dp_torch.py`` as two rank processes on the
    card: llama3-1b bf16 with remat, batch 2 x seq 2048 per rank, one
    batch per rank; each rank's JSON lines."""
    cfg, b, s = llama.LLAMA3_1B, 2, 2048
    port = free_port() + 100
    cmd = [sys.executable, str(REPO / "examples" / "two_slice_dp_torch.py"),
           "--world", "2", "--port", str(port), "--engine", "emu",
           "--config", cfg.name, "--remat", "--one-batch", "--batch",
           str(b), "--seq", str(s), "--steps", str(steps)] + extra
    with tempfile.TemporaryDirectory() as tmp:
        outs = [open(os.path.join(tmp, f"r{r}.{k}"), "w+")
                for r in range(2) for k in ("out", "err")]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                  stdout=outs[2 * r], stderr=outs[2 * r + 1],
                                  env={**os.environ, **(env or {})})
                 for r in range(2)]
        deadline = time.monotonic() + 480
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
    for r in range(2):
        require(rcs[r] == 0,
                f"two-slice {extra} rank {r} exited {rcs[r]} (compute mode "
                f"{compute_mode()}): {texts[2 * r + 1][-2000:]}")
    return [[json.loads(ln) for ln in texts[2 * r].splitlines()
             if ln.startswith("{")] for r in range(2)]


def two_slice_summary(ranks: list, steps: int, c_per_step: dict,
                      what: str) -> dict:
    """The gates every two-slice path holds (each rank reported every
    step, equal digests across ranks after every step, staged bytes 2 x
    the gradient bytes, launches per step equal to path (c)'s, losses
    finite and falling) and its mean split over the timed steps."""
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
                    f"!= path (c)'s {c_per_step}")
            require(ln["staged_bytes"] == want_bytes,
                    f"{what} staged {ln['staged_bytes']} != {want_bytes}")
    timed = [[per[r][k] for k in range(2, steps + 1)] for r in range(2)]

    def mean(key):
        return float(np.mean([ln[key] for lines in timed for ln in lines]))

    step_ms = mean("step_ms")
    launches = {name: sum(per[r][k]["launches"][name] for r in range(2)
                          for k in range(1, steps + 1))
                for name in c_per_step}
    finals = [next(ln for ln in lines if "final_digest" in ln)
              for lines in ranks]
    split_keys = [k for k in ("grads_ms", "sync_ms", "apply_ms",
                              "stage_ms", "gather_ms", "ring_ms",
                              "scatter_ms") if k in timed[0][0]]
    return {"config": f"{cfg.name}/{str(cfg.dtype).split('.')[-1]}/remat",
            "ranks": 2,
            "batch_per_rank": b, "seq": s, "engine": per[0][0]["engine"],
            "link_tier": per[0][0]["link_tier"],
            "overlap": per[0][0]["overlap"],
            "per_layer": per[0][0]["per_layer"],
            "steps": steps, "timed_steps": steps - 1,
            "step_ms_by_rank": [[ln["step_ms"] for ln in lines]
                                for lines in timed],
            "step_ms_mean": step_ms,
            **{f"{k}_mean": mean(k) for k in split_keys},
            "staged_bytes_per_step": per[0][steps]["staged_bytes"],
            "grad_bytes": grad_bytes(cfg),
            "ring_bus_gb_s": (grad_bytes(cfg) / (mean("ring_ms") / 1e3) / 1e9
                              if mean("ring_ms") > 0 else None),
            "tokens_per_s": 2 * b * s / (step_ms / 1e3),
            "losses": losses, "digests_equal_every_step": True,
            "digests": [per[0][k]["digest"] for k in range(steps + 1)],
            "peak_mem_gb_by_rank": [f["peak_mem_gb"] for f in finals],
            "launches_per_step_per_rank": c_per_step,
            "launches": launches,
            "note": "both ranks time-slice one card: grads_ms is not a "
                    "two-card number"}, finals


def phase_two_slice_dp(c_per_step: dict) -> dict:
    """Path (d): two rank processes of llama3-1b bf16 with remat, batch
    2 × seq 2048 per rank, the fused sync. Step 1 warms; steps 2.. are
    timed."""
    steps = 4
    res, _ = two_slice_summary(run_two_slice([], steps), steps, c_per_step,
                               "path (d)")
    return res


def phase_two_slice_dp_per_layer(c_per_step: dict, d: dict) -> dict:
    """Path (e): path (d)'s command with ``--per-layer`` and the flight
    recorder on (drained after every step, its ring sized for a step).
    Besides path (d)'s gates, its parameter digests equal path (d)'s
    after every step: at world 2 the ring adds once, so bucketing per
    layer changes no bit. Where they differ, path (d) is run again: if
    (d) repeats its own digests, the difference is a fault; if it does
    not, the backward is not bitwise repeatable on this card and (e)'s
    losses are held to (d)'s within 1e-3 relative instead."""
    steps = 4
    env = {"TDR_TELEMETRY": "1", "TDR_TELEMETRY_RING": str(1 << 21)}
    ranks = run_two_slice(["--per-layer"], steps, env)
    res, finals = two_slice_summary(ranks, steps, c_per_step, "path (e)")
    require(res["per_layer"], "path (e) did not run the per-layer sync")
    res["digests_equal_path_d"] = res["digests"] == d["digests"]
    if not res["digests_equal_path_d"]:
        again, _ = two_slice_summary(run_two_slice([], 2), 2, c_per_step,
                                     "path (d) repeat")
        repeats = again["digests"] == d["digests"][:3]
        res["path_d_repeats_its_digests"] = repeats
        require(not repeats, "path (e)'s digests differ from path (d)'s, "
                "and (d) repeats its own: a fault of the per-layer sync")
        rel = max(abs(e - dd) / abs(dd) for le, ld in zip(res["losses"],
                                                          d["losses"])
                  for e, dd in zip(le, ld))
        require(rel <= 1e-3, f"path (e) losses off (d)'s by {rel}")
        res["loss_max_rel_diff_vs_d"] = rel
    tel = [f["telemetry_timed_steps"] for f in finals]
    res["telemetry_by_rank"] = tel
    for key in ("overlap_fraction", "compute_overlap_fraction"):
        res[key] = [t[key] for t in tel]
    res["telemetry_dropped"] = [t["telemetry_dropped"] for t in tel]
    res["ring_split_ms_per_step"] = [
        {k: v / (steps - 1) for k, v in t["ring_split_ms"].items()}
        for t in tel]
    res["fold_busy_ms_per_step"] = [t["fold_busy_ms"] / (steps - 1)
                                    for t in tel]
    res["timing_note"] = ("grads_ms ends with torch.cuda.synchronize(), so "
                          "it includes the last bucket's D2H on the copy "
                          "stream")
    return res


RING_SIZES = ("4M", "64M", "1G")


def allreduce_tool(args: list, env=None) -> tuple:
    """The port's ``tools/allreduce.py`` at world 2 as one process per
    rank (the two ranks' links negotiate as path (d)'s do): rank 0's
    record, and each rank's link tier as it reports it."""
    port = free_port() + 100
    cmd = [sys.executable, "-m", "rocnrdma_tpu_torch.tools.allreduce",
           "--world", "2", "--port", str(port), "--engine", "emu",
           "--json"] + args
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ, **(env or {})})
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tiers = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0,
                f"allreduce tool rank {r} exited {p.returncode}: "
                f"{err[-2000:]}")
        tier = [ln.split(":", 1)[1].strip() for ln in err.splitlines()
                if ln.startswith("link tier:")]
        require(len(tier) == 1, f"allreduce tool rank {r} gave no link "
                f"tier: {err[-2000:]}")
        tiers += tier
    return json.loads(outs[0][0].strip().splitlines()[-1]), tiers


def ring_threads(size: str, iters: int) -> tuple:
    """The port's allreduce tool's ``run_threads`` on two threads of
    this process (world 2, bf16): (bus GB/s, link tier)."""
    from rocnrdma_tpu_torch.tools import allreduce as tool

    worlds = local_worlds(2, free_port() + 100, spec="emu")
    try:
        tier = worlds[0].link_tier
        count = tool.parse_sizes(size)[0] // 2
        dt = tool.run_threads(worlds, count, torch.bfloat16, iters)
    finally:
        for w in worlds:
            w.close()
    require(dt > 0, f"ring threads at {size}: {dt} s per op")
    return count * 2 * tool.bus_fraction("allreduce", 2) / dt / 1e9, tier


def phase_ring_bus_by_size() -> dict:
    """The ring alone, by message size: the port's allreduce tool at
    world 2 in bf16, 3 iterations per size, as two rank processes and as
    two threads of one process; the 64 MiB case once more across
    processes with the flight recorder on. Bus GB/s = bytes * 2(n-1)/n
    / s per op."""
    res = {"dtype": "bfloat16", "iters": 3, "world": 2,
           "processes": {}, "processes_link_tier": {}, "threads": {},
           "threads_link_tier": {}}
    for size in RING_SIZES:
        args = ["--bytes", size, "--dtype", "bfloat16", "--iters", "3"]
        rec, res["processes_link_tier"][size] = allreduce_tool(args)
        res["processes"][size] = rec["bus_GBps"]
        res["threads"][size], res["threads_link_tier"][size] = \
            ring_threads(size, 3)
    rec, res["processes_link_tier"]["64M_telemetry"] = allreduce_tool(
        ["--bytes", "64M", "--dtype", "bfloat16", "--iters", "3"],
        env={"TDR_TELEMETRY": "1"})
    res["processes_64M_telemetry"] = rec["bus_GBps"]
    return res


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
    gen = run_phase("path_a_generate_llama3_8b", phase_generate_8b)

    cfg1 = dataclasses.replace(llama.LLAMA3_1B, dtype=torch.float32)
    state = llama.init_params(cfg1, seed=1, device="cuda")
    _, model1 = run_phase("path_parity_llama3_1b_f32", phase_parity,
                          state, cfg1)
    bat = run_phase("path_b_batcher_llama3_1b_f32", phase_batcher,
                    state, cfg1, model1)
    del model1
    torch.cuda.empty_cache()
    train = run_phase("path_c_train_llama3_1b_bf16", phase_train_1b)
    run_phase("train_parity_llama3_1b_f32", phase_train_parity, state, cfg1)
    del state
    torch.cuda.empty_cache()
    run_phase("hbm_cuda_exporter", phase_hbm_cuda_exporter)
    run_phase("xslice_sync_vs_plain", phase_xslice)
    run_phase("ring_bus_by_size", phase_ring_bus_by_size)
    dp = run_phase("path_d_two_slice_dp_llama3_1b_bf16", phase_two_slice_dp,
                   train["launches_per_step"])
    dpl = run_phase("path_e_two_slice_dp_per_layer_llama3_1b_bf16",
                    phase_two_slice_dp_per_layer,
                    train["launches_per_step"], dp)

    def by_path(name):
        return {"a_generate": gen["launches"][name],
                "b_batcher": bat["launches"][name],
                "c_train": train["launches"][name],
                "d_two_slice_dp": dp["launches"][name],
                "e_two_slice_dp_per_layer": dpl["launches"][name]}

    k1, k3, k3c = rms["cases"][0], fl["cases"][0], fl["cases"][6]
    k2, k45 = rms_bwd["cases"][0], fl_bwd["cases"][0]
    whole = "plain_ms and library_ms are of the whole attention backward"
    kernels = [
        kernel_entry("rmsnorm_fwd", "rmsnorm.py:48", by_path, k1,
                     k1["max_abs_err"], k1["ms"], k1["bound_ms"],
                     k1["bound_by"]),
        kernel_entry("rmsnorm_bwd", "rmsnorm.py:141", by_path, k2,
                     max(k2["max_abs_err"], k2["dw_max_abs_err"]), k2["ms"],
                     k2["bound_ms"], k2["bound_by"]),
        kernel_entry("flash_fwd", "attention.py:119", by_path, k3,
                     k3["max_abs_err"], k3["ms"], k3["bound_ms"],
                     k3["bound_by"], instance=k3["route"],
                     path_c={key: k3c[key] for key in (
                         "shape", "route", "max_abs_err", "ms", "bound_ms",
                         "bound_by", "library_ms")}),
        kernel_entry("flash_bwd_dkv", "attention.py:275", by_path, k45,
                     max(k45["dk_max_abs_err"], k45["dv_max_abs_err"]),
                     k45["dkv_ms"], k45["dkv_bound_ms"],
                     k45["dkv_bound_by"], note=whole,
                     instance=k45["dkv_route"]),
        kernel_entry("flash_bwd_dq", "attention.py:322", by_path, k45,
                     k45["dq_max_abs_err"], k45["dq_ms"], k45["dq_bound_ms"],
                     k45["dq_bound_by"], note=whole,
                     instance=k45["dq_route"])]
    emit({"kernels": kernels})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
