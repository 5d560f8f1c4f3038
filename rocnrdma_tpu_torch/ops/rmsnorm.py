"""RMSNorm forward: the hand-written CUDA kernel and its plain version.

Counterpart of ``rocnrdma_tpu/ops/rmsnorm.py``. The kernel
(``csrc/rmsnorm_fwd.cu``) replaces the Pallas forward
``_rmsnorm_kernel``; its note says what bounds it on an H100 and how.
The backward (the Pallas ``_rmsnorm_bwd_kernel``) belongs to training
and is not ported yet: differentiating through the kernel raises.

:func:`rmsnorm` launches the kernel for a CUDA tensor and runs
:func:`rmsnorm_reference` only for a CPU tensor. There is no fallback:
a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from . import _native

__all__ = ["rmsnorm", "rmsnorm_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch RMSNorm over the last axis: f32 math, output in
    x's dtype, w read as f32 (mirrors the JAX ``rmsnorm_reference``)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm weight shape {tuple(w.shape)} != ({d},)")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
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


class _RMSNormKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        return _launch(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "rmsnorm backward kernel (the Pallas _rmsnorm_bwd_kernel) is "
            "not ported yet")


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. CUDA tensor: the hand-written kernel.
    CPU tensor: :func:`rmsnorm_reference`."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    return _RMSNormKernel.apply(x, w, eps)
