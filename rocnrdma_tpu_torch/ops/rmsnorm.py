"""RMSNorm forward and backward: the hand-written CUDA kernels and their
plain versions.

Counterpart of ``rocnrdma_tpu/ops/rmsnorm.py``. The forward kernel
(``csrc/rmsnorm_fwd.cu``) replaces the Pallas ``_rmsnorm_kernel``; the
backward kernel (``csrc/rmsnorm_bwd.cu``) replaces the Pallas
``_rmsnorm_bwd_kernel``. Each source's note says what bounds it on an
H100 and how.

:func:`rmsnorm` is one ``torch.autograd.Function`` that dispatches on
the device in both directions: CUDA tensors launch the kernels, CPU
tensors run :func:`rmsnorm_reference` forward and
:func:`rmsnorm_bwd_reference` backward, any other device raises. There
is no fallback: a kernel that fails to build or launch raises. The
backward saves x and w, not y. The backward kernel takes widths that
are multiples of its 16-byte vector up to 4096 (f32) or 8192 (bf16);
on CUDA tensors any other width raises ``ValueError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _native

__all__ = ["rmsnorm", "rmsnorm_reference", "rmsnorm_bwd",
           "rmsnorm_bwd_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Upper bound on the backward kernel's f32 partial rows of dw (one per
# thread block of its first pass).
BWD_PARTIAL_BLOCKS = 256
# The backward kernel holds a row in registers as 16-byte vectors, at
# most 4 per each of its 256 threads: d must be a multiple of the vector
# and at most 4 * 256 vectors wide.
_BWD_MAX_VECTORS = 4 * 256


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch RMSNorm over the last axis: f32 math, output in
    x's dtype, w read as f32 (mirrors the JAX ``rmsnorm_reference``)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd_reference(x: torch.Tensor, w: torch.Tensor,
                          g: torch.Tensor, eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of :func:`rmsnorm_reference` (the JAX
    ``_bwd_math`` in f32): dx = rstd·(g·w − x̂·mean(g·w∘x̂)) in x's
    dtype, dw = Σ_rows g∘x̂ in f32."""
    d = x.shape[-1]
    xf, gf, wf = x.float(), g.float(), w.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gw = gf * wf
    dx = rstd * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> int:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"{what} weight shape {tuple(w.shape)} != ({d},)")
    if w.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")
    return d


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    d = _check(x, w, "rmsnorm")
    x2 = x.contiguous().view(-1, d)
    wf = w.float().contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.view(x.shape)
    lib = _native.library("rmsnorm_fwd")
    _native.count("rmsnorm_fwd")
    rc = lib.rmsnorm_fwd(x2.data_ptr(), wf.data_ptr(), y.data_ptr(),
                         x2.shape[0], d, float(eps), _DTYPES[x.dtype],
                         _native.stream_handle(x.device))
    _native.check("rmsnorm_fwd", rc)
    return y.view(x.shape)


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    d = _check(x, w, "rmsnorm backward")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"rmsnorm backward: g {tuple(g.shape)} {g.dtype} "
                         f"on {g.device} does not match x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    per_vec = 16 // x.element_size()
    if d % per_vec or d // per_vec > _BWD_MAX_VECTORS:
        raise ValueError(f"rmsnorm backward kernel takes widths that are "
                         f"multiples of {per_vec} up to "
                         f"{per_vec * _BWD_MAX_VECTORS} for {x.dtype}, "
                         f"got {d}")
    # 16-byte vector loads: a view whose start is not 16-byte aligned is
    # copied (a fresh allocation is).
    x2, g2, wf = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (x.contiguous().view(-1, d),
                            g.contiguous().view(-1, d),
                            w.float().contiguous()))
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    if rows == 0:
        return dx.view(x.shape), torch.zeros_like(wf)
    dw = torch.empty_like(wf)
    blocks = min(rows, BWD_PARTIAL_BLOCKS)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    lib = _native.library("rmsnorm_bwd")
    _native.count("rmsnorm_bwd")
    rc = lib.rmsnorm_bwd(x2.data_ptr(), wf.data_ptr(), g2.data_ptr(),
                         dx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                         rows, d, blocks, float(eps), _DTYPES[x.dtype],
                         _native.stream_handle(x.device))
    _native.check("rmsnorm_bwd", rc)
    return dx.view(x.shape), dw


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of RMSNorm for the upstream gradient ``g``. CUDA
    tensors: the backward kernel. CPU tensors:
    :func:`rmsnorm_bwd_reference`."""
    if _native.device_type(x, "rmsnorm backward") == "cpu":
        return rmsnorm_bwd_reference(x, w, g, eps)
    return _launch_bwd(x, w, g, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        on_cpu = _native.device_type(x, "rmsnorm") == "cpu"
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return rmsnorm_reference(x, w, eps) if on_cpu else _launch(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g, ctx.eps)
        return dx, dw.to(w.dtype), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis, differentiable in x and w. CUDA
    tensors: the hand-written kernels. CPU tensors: the plain
    versions."""
    return _RMSNorm.apply(x, w, eps)
