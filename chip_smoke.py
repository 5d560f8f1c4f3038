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
  versions), then the parameters after one AdamW step.

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

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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

    def by_path(name):
        return {"a_generate": gen["launches"][name],
                "b_batcher": bat["launches"][name],
                "c_train": train["launches"][name]}

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
