"""Flash attention forward and backward: the hand-written CUDA kernels
and their plain versions.

Counterpart of ``rocnrdma_tpu/ops/attention.py``. Three kernels, each
with a note on what bounds it on an H100 and how:

- ``csrc/flash_fwd.cu`` replaces the Pallas forward ``_flash_kernel``;
- ``csrc/flash_bwd_dq.cu`` replaces ``_bwd_dq_kernel`` (dQ);
- ``csrc/flash_bwd_dkv.cu`` replaces ``_bwd_dkv_kernel`` (dK and dV,
  the GQA group summed on chip).

The two backward kernels share their per-element rule
(``csrc/flash_bwd_common.cuh``, the counterpart of ``_bwd_tile``). All
three run on the tensor cores (wgmma on TMA-fed tiles) for bf16 at
D 64 and 128, and as scalar kernels for f32 and bf16 at D 16 and 32;
:func:`kernel_route` names the instance.
Layouts are the JAX package's: q (B, H, S, D), k/v (B, KVH, S, D), out
(B, H, S, D) in q's dtype and lse (B, H, S, 1) in f32; q head h reads kv
head h // (H // KVH). delta = rowsum(dO∘O) is a torch op, as it is plain
``jnp`` in the JAX package.

:func:`flash_attention_lse` is one ``torch.autograd.Function`` that
dispatches on the device in both directions: CUDA tensors launch the
kernels (forward; backward K5 then K4), CPU tensors run
:func:`flash_attention_lse_reference` and
:func:`flash_attention_bwd_reference`, any other device raises. There
is no fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _native

__all__ = ["attention", "attention_reference", "flash_attention_lse",
           "flash_attention_lse_reference", "flash_attention_bwd_reference",
           "flash_attention_shard_grads", "flash_bwd_dq", "flash_bwd_dkv",
           "kernel_route", "NEG_INF", "HEAD_DIMS"]

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


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The plain version of the backward kernels: (dq, dk, dv) in the
    dtypes of q, k, v, from the saved ``out`` and ``lse`` and the
    upstream ``do``, in f32 and without autograd. As ``_bwd_tile`` does,
    it rebuilds p = exp(s − lse) with s masked to −1e30, takes
    delta = rowsum(dO∘O), ds = p·(dO·Vᵀ − delta)·scale, and sums the GQA
    group into dK/dV."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    sc = _scale(scale, d)
    scores = _grouped_scores(q, k) * sc                 # (B,KVH,G,S,S)
    if causal:
        scores = scores.masked_fill(~_causal_mask(s, q.device), NEG_INF)
    p = torch.exp(scores - lse.float().view(b, kvh, g, s, 1))
    dof = do.float().reshape(b, kvh, g * s, d)
    dp = (dof @ v.float().transpose(-1, -2)).view(b, kvh, g, s, s)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta.view(b, kvh, g, s, 1)) * sc
    p2, ds2 = p.view(b, kvh, g * s, s), ds.view(b, kvh, g * s, s)
    dv = p2.transpose(-1, -2) @ dof
    dk = ds2.transpose(-1, -2) @ q.float().reshape(b, kvh, g * s, d)
    dq = (ds2 @ k.float()).reshape(b, h, s, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def kernel_route(kernel: str, d: int, dtype: torch.dtype) -> str:
    """"tensor_core" or "scalar": the instance of ``kernel``
    ("flash_fwd", "flash_bwd_dkv" or "flash_bwd_dq") that launches for
    head dim ``d`` and ``dtype``, as the built library's dispatch decides
    it."""
    return _native.route(kernel, d, _DTYPES[dtype])


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels' TMA loads
    need (a contiguous view may start inside its storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: Optional[float]
            ) -> Tuple[torch.Tensor, torch.Tensor,
                       Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(out, lse, (q, k, v))``: the forward kernel's outputs and the
    contiguous operands it read, which the backward reuses."""
    _check(q, k, v)
    b, h, s, d = q.shape
    kvh = k.shape[1]
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    if s == 0 or b == 0:
        return out, lse, (q, k, v)
    lib = _native.library("flash_fwd")
    _native.count("flash_fwd")
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), b, h, kvh, s, d,
                       float(_scale(scale, d)), int(bool(causal)),
                       _DTYPES[q.dtype], _native.stream_handle(q.device))
    _native.check("flash_fwd", rc)
    return out, lse, (q, k, v)


def _bwd_args(q, k, v, do, lse, delta):
    """Validated, contiguous, aligned operands of the backward
    kernels."""
    _check(q, k, v)
    b, h, s, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, s, 1) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be ({b}, {h}, {s}, 1) float32 on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    return tuple(_operand(t) for t in (q, k, v, do, lse, delta))


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """dQ by the K5 kernel (CUDA tensors only), from lse and
    delta = rowsum(dO∘O)."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dq = torch.empty_like(q)
    if s == 0 or b == 0:
        return dq
    lib = _native.library("flash_bwd_dq")
    _native.count("flash_bwd_dq")
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), b, h, k.shape[1], s, d,
                          float(_scale(scale, d)), int(bool(causal)),
                          _DTYPES[q.dtype], _native.stream_handle(q.device))
    _native.check("flash_bwd_dq", rc)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) by the K4 kernel (CUDA tensors only), the GQA group
    summed inside the kernel."""
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    b, h, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if s == 0 or b == 0:
        return dk, dv
    lib = _native.library("flash_bwd_dkv")
    _native.count("flash_bwd_dkv")
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), b, h, k.shape[1],
                           s, d, float(_scale(scale, d)), int(bool(causal)),
                           _DTYPES[q.dtype], _native.stream_handle(q.device))
    _native.check("flash_bwd_dkv", rc)
    return dk, dv


def flash_attention_shard_grads(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor,
                                causal: bool = True,
                                scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(dq, dk, dv) of one (q shard, kv shard) pair against the GLOBAL
    softmax: ``out``/``lse`` are the merged output and log-sum-exp over
    the full sequence, so p = exp(s − lse) and delta = rowsum(dO∘out)
    give this pair's share of the exact gradient (the identity ring
    attention's backward sums over kv shards). The same backward the
    autograd function runs: CUDA tensors launch K5 then K4, CPU tensors
    run :func:`flash_attention_bwd_reference`."""
    if _native.device_type(q, "flash attention") == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             scale)
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if _native.device_type(q, "flash attention") == "cpu":
            out, lse = flash_attention_lse_reference(q, k, v, causal, scale)
        else:
            # Save the contiguous copies the kernel read (the model passes
            # transposed views), so the backward does not copy them again.
            out, lse, (q, k, v) = _launch(q, k, v, causal, scale)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_shard_grads(q, k, v, out, lse, g_out,
                                                 ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward returning ``(out, lse)``, differentiable in q, k, v
    through out (lse carries no gradient). CUDA tensors: the
    hand-written kernels. CPU tensors: the plain versions."""
    return _FlashAttention.apply(q, k, v, causal, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention output only, through :func:`flash_attention_lse`."""
    return flash_attention_lse(q, k, v, causal, scale)[0]
