"""Flash-attention forward: the hand-written CUDA kernel and its plain
versions.

Counterpart of ``rocnrdma_tpu/ops/attention.py``. The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas forward ``_flash_kernel``;
its note says what bounds it on an H100 and how. Layouts are the JAX
package's: q (B, H, S, D), k/v (B, KVH, S, D), out (B, H, S, D) in q's
dtype and lse (B, H, S, 1) in f32; q head h reads kv head
h // (H // KVH). The two backward kernels (dK/dV and dQ) belong to
training and are not ported yet: differentiating through the kernel
raises.

:func:`flash_attention_lse` and :func:`attention` launch the kernel for
CUDA tensors and run :func:`flash_attention_lse_reference` only for CPU
tensors. There is no fallback: a kernel that fails to build or launch
raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _native

__all__ = ["attention", "attention_reference", "flash_attention_lse",
           "flash_attention_lse_reference", "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 q·kᵀ with q head h against kv head h // group: (B, KVH, G,
    S, S). The group is folded into the query rows, so k is never
    repeated (a broadcast matmul would materialise the repeat)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qg = q.float().reshape(b, kvh, (h // kvh) * s, d)
    return (qg @ k.float().transpose(-1, -2)).view(b, kvh, h // kvh, s, s)


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.tril(torch.ones(s, s, dtype=torch.bool, device=device))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Mirror of the JAX ``attention_reference``: f32 logits, −1e30
    mask, softmax, probs cast to v's dtype before the product."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=1)
        v = v.repeat_interleave(h // kvh, dim=1)
    logits = (q.float() @ k.float().transpose(-1, -2)) * _scale(scale, d)
    if causal:
        logits = logits.masked_fill(~_causal_mask(s, q.device), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return probs.to(v.dtype) @ v


def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel: the same function in plain
    PyTorch, f32 throughout. Returns ``(out, lse)``, out in q's dtype
    and lse (B, H, S, 1) f32 = m + log(max(l, 1e-30))."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    sc = _grouped_scores(q, k) * _scale(scale, d)      # (B,KVH,G,S,S)
    if causal:
        sc = sc.masked_fill(~_causal_mask(s, q.device), NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.view(b, kvh, -1, s) @ v.float()).view(p.shape[:-1] + (d,)) / l
    out = o.reshape(b, h, s, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, s, 1)
    return out, lse


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: Optional[float]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes 4-D q, k, v "
                         "(B, H, S, D) / (B, KVH, S, D)")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if k.shape != (b, kvh, s, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if h % kvh != 0:
        raise ValueError(f"H={h} is not a multiple of KVH={kvh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes one dtype of float32/bfloat16 "
                        f"for q, k, v; got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid limit")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    if s == 0 or b == 0:
        return out, lse
    lib = _native.library("flash_fwd")
    _native.count("flash_fwd")
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), b, h, kvh, s, d,
                       float(_scale(scale, d)), int(bool(causal)),
                       _DTYPES[q.dtype], _native.stream_handle(q.device))
    _native.check("flash_fwd", rc)
    return out, lse


class _FlashKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _launch(q, k, v, causal, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(
            "flash attention backward kernels (the Pallas _bwd_dkv_kernel "
            "and _bwd_dq_kernel) are not ported yet")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward returning ``(out, lse)``. CUDA tensors: the hand-written
    kernel. CPU tensors: :func:`flash_attention_lse_reference`."""
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return _FlashKernel.apply(q, k, v, causal, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention output only, through :func:`flash_attention_lse`."""
    return flash_attention_lse(q, k, v, causal, scale)[0]
