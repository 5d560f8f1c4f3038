"""Kimi Delta Attention (KDA): the mixer of Kimi Linear's linear-attention
layers, its short convolution and recurrence as the hand-written CUDA
kernel K9, and their plain version.

No Pallas kernel stands behind it: the JAX package has no linear
attention. The equations are the Kimi Linear paper's (arXiv:2510.26692)
as Kimi-Linear-48B-A3B configures them, per head of ``dim`` channels on
the normed input h:

- ``[q, k, v] = SiLU(ShortConv_K(h·W_qkv))``, a causal depthwise
  convolution of width K over each channel, its K - 1 previous inputs
  carried in the cache; ``q ← l2norm(q)``, ``k ← l2norm(k)``;
- the per-channel decay ``log α = −exp(A_log) · softplus(h·W_fa·W_fb +
  dt_bias)`` and ``β = sigmoid(h·W_b)``, in f32;
- the state ``S_t = Diag(α_t) S_{t−1} + β_t k_t (v_t − k_tᵀ Diag(α_t)
  S_{t−1})ᵀ`` (dim × dim, f32) and ``o_t = S_tᵀ q_t / sqrt(dim)``;
- ``RMSNorm(o) ⊙ sigmoid(h·W_ga·W_gb)`` per head, then ``W_o``.

:func:`kda_recurrent` takes the raw projections ``h·W_qkv`` and runs the
convolution, SiLU, the l2norms and the recurrence: CUDA tensors launch
K9 (``csrc/kda_recurrent.cu``), which runs T tokens of every (sequence,
head) from both states in place; CPU tensors run :func:`kda_reference`,
the plain version (:func:`short_conv`, :func:`l2norm` and the per-token
loop :func:`recurrence_reference`). There is no fallback: a shape,
layout or dtype the kernel does not take raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import _native
from .rmsnorm import rmsnorm
from ..utils.trace import trace

__all__ = ["KdaMixer", "kda_recurrent", "kda_reference",
           "recurrence_reference", "short_conv", "l2norm", "DIM", "TAPS",
           "L2_EPS"]

# The head width and convolution width K9 is built for (Kimi Linear's
# linear_attn_config head_dim, keys and values alike, and
# short_conv_kernel_size).
DIM, TAPS = 128, 4
# l2norm's epsilon under the square root, as the published kernels take.
L2_EPS = 1e-6


def recurrence_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, beta: torch.Tensor,
                         state: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain recurrence, a token at a time in f32: q, k, v (B, T, H,
    D), g (B, T, H, D) the log decay, beta (B, T, H), state (B, H, D, D)
    f32, updated in place. Returns o (B, T, H, D) in f32."""
    s = state.float()
    outs = []
    for t in range(q.shape[1]):
        kt = k[:, t].float()
        s = s * g[:, t].float().exp()[..., None]
        u = torch.einsum("bhk,bhkv->bhv", kt, s)
        delta = beta[:, t].float()[..., None] * (v[:, t].float() - u)
        s = s + kt[..., None] * delta[:, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, t].float() * scale, s))
    state.copy_(s)
    return torch.stack(outs, 1)


def kda_reference(x: torch.Tensor, conv_w: torch.Tensor,
                  conv_state: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor, state: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """K9's plain version: x (B, T, 3·H·D) the raw projections (q's, k's
    and v's channels), conv_w (3·H·D, K), conv_state (B, K - 1, 3·H·D)
    the raw rows before x, g (B, T, H, D), beta (B, T, H), state (B, H, D,
    D) f32. ``SiLU(conv)``, the l2norms of q and k in f32, then
    :func:`recurrence_reference`; both states left updated in place.
    Returns o (B, T, H, D) in x's dtype."""
    b, t, _ = x.shape
    h, d = state.shape[1], state.shape[2]
    c = h * d
    y = short_conv(x, conv_w, conv_state)
    q, k, v = (y[..., i * c:(i + 1) * c].reshape(b, t, h, d)
               for i in range(3))
    kw = conv_w.shape[1]
    conv_state.copy_(torch.cat([conv_state.to(x.dtype), x],
                               dim=1)[:, -(kw - 1):])
    return recurrence_reference(l2norm(q), l2norm(k), v, g, beta, state,
                                scale).to(x.dtype)


def _check(x, conv_w, conv_state, g, beta, state) -> None:
    b, t, h, d = g.shape
    if d != DIM or conv_w.shape != (3 * h * d, TAPS):
        raise ValueError(f"KDA kernel takes heads of {DIM} and a "
                         f"convolution of {TAPS} taps, got g "
                         f"{tuple(g.shape)} and conv_w "
                         f"{tuple(conv_w.shape)}")
    if (x.shape != (b, t, 3 * h * d) or beta.shape != (b, t, h)
            or state.shape != (b, h, d, d)
            or conv_state.shape != (b, TAPS - 1, 3 * h * d)):
        raise ValueError(f"x {tuple(x.shape)}, beta {tuple(beta.shape)}, "
                         f"state {tuple(state.shape)} and conv_state "
                         f"{tuple(conv_state.shape)} do not match g "
                         f"{tuple(g.shape)}")
    if any(z.dtype != torch.bfloat16 for z in (x, conv_w, conv_state)) or any(
            z.dtype != torch.float32 for z in (g, beta, state)):
        raise TypeError("KDA kernel takes x, conv_w and conv_state in "
                        "bfloat16 and g, beta, state in float32")
    if not all(z.is_contiguous()
               for z in (x, conv_w, conv_state, g, beta, state)):
        raise ValueError("KDA kernel takes contiguous tensors")
    if b > 65535 or h > 65535:
        raise ValueError(f"KDA kernel's grid takes at most 65535 sequences "
                         f"and heads, got {b} and {h}")


def kda_recurrent(x: torch.Tensor, conv_w: torch.Tensor,
                  conv_state: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor, state: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """T tokens of the short convolution and the gated delta rule from
    ``conv_state`` and ``state``, which are left holding the raw rows and
    the state after the last token: o (B, T, H, D) in x's dtype (shapes
    as :func:`kda_reference`'s). CUDA tensors: one launch of K9. CPU
    tensors: :func:`kda_reference`."""
    if _native.device_type(x, "KDA recurrence") == "cpu":
        return kda_reference(x, conv_w, conv_state, g, beta, state, scale)
    _check(x, conv_w, conv_state, g, beta, state)
    b, t, h, d = g.shape
    out = torch.empty((b, t, h, d), dtype=x.dtype, device=x.device)
    if b == 0 or t == 0:
        return out
    _native.count("kda_recurrent")
    rc = _native.library("kda_recurrent").kda_recurrent(
        x.data_ptr(), conv_w.data_ptr(), conv_state.data_ptr(), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(), out.data_ptr(), b, t, h, d,
        float(scale), _native.stream_handle(x.device))
    _native.check("kda_recurrent", rc)
    return out


def short_conv(x: torch.Tensor, w: torch.Tensor,
               prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The causal depthwise convolution of width K over x (B, S, C): ``y_t
    = Σ_j w[:, j] · x_{t-K+1+j}``, the positions before x taken from
    ``prev`` (B, K - 1, C), zeros without it. Sums in f32; returns
    ``SiLU(y)`` in f32."""
    kw = w.shape[1]
    b, s, c = x.shape
    if prev is None:
        prev = x.new_zeros(b, kw - 1, c)
    full = torch.cat([prev.to(x.dtype), x], dim=1)
    wf = w.float()
    y = torch.mul(full[:, :s], wf[:, 0])
    for j in range(1, kw):
        y.addcmul_(full[:, j:j + s], wf[:, j])
    return F.silu(y, inplace=True)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(Σ x² + eps) over the last axis, in f32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _f32(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=torch.float32,
                                   device=device))


class KdaMixer(nn.Module):
    """One KDA layer's mixer on the normed input h (B, S, d). Weights in
    the (in, out) layout of the port: ``wqkv`` (d, 3·H·D) and its
    convolution ``conv`` (3·H·D, K) in ``dtype``; the decay's ``wfa`` (d,
    D) and ``wfb`` (D, H·D), the output gate's ``wga`` (d, D) and ``wgb``
    (D, H·D), ``wb`` (d, H) and ``wo`` (H·D, d) in ``dtype``; ``A_log``
    (H,), ``dt_bias`` (H·D,) and the gated norm's ``o_norm.weight`` (D,)
    in f32.

    The cache of a layer (:meth:`init_cache`) holds ``state`` (B, H, D, D)
    f32 and ``conv`` (B, K - 1, 3·H·D) in ``dtype``, the last K - 1 inputs
    of the convolution; a forward with it continues from both and leaves
    them updated in place, whatever the number of new positions. Without
    a cache the sequence starts from zeros."""

    def __init__(self, d_model: int, heads: int, dim: int, conv_size: int,
                 norm_eps: float, dtype: torch.dtype, device) -> None:
        super().__init__()
        self.heads, self.dim, self.conv_size = heads, dim, conv_size
        self.norm_eps, self.dtype = norm_eps, dtype
        c = heads * dim
        self.wqkv = _weight((d_model, 3 * c), dtype, device)
        self.conv = _weight((3 * c, conv_size), dtype, device)
        self.wfa = _weight((d_model, dim), dtype, device)
        self.wfb = _weight((dim, c), dtype, device)
        self.wga = _weight((d_model, dim), dtype, device)
        self.wgb = _weight((dim, c), dtype, device)
        self.wb = _weight((d_model, heads), dtype, device)
        self.wo = _weight((c, d_model), dtype, device)
        self.A_log = _f32((heads,), device)
        self.dt_bias = _f32((c,), device)
        self.o_norm = nn.Module()
        self.o_norm.weight = _f32((dim,), device)

    def init_cache(self, batch: int, device) -> Dict[str, torch.Tensor]:
        c = self.heads * self.dim
        return {"state": torch.zeros(batch, self.heads, self.dim, self.dim,
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros(batch, self.conv_size - 1, 3 * c,
                                    dtype=self.dtype, device=device)}

    def forward(self, h: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        b, s, _ = h.shape
        nh, d, c = self.heads, self.dim, self.heads * self.dim
        with trace.span("kda.mix", h.device, rows=b * s):
            if cache is None:
                cache = self.init_cache(b, h.device)
            x = h @ self.wqkv
            f = ((h @ self.wfa) @ self.wfb).float() + self.dt_bias
            g = (-self.A_log.exp().repeat_interleave(d)) * F.softplus(f)
            beta = torch.sigmoid((h @ self.wb).float())
            o = kda_recurrent(x, self.conv, cache["conv"],
                              g.view(b, s, nh, d), beta, cache["state"],
                              1.0 / math.sqrt(d))
            o = rmsnorm(o, self.o_norm.weight, self.norm_eps)
            gate = torch.sigmoid(((h @ self.wga) @ self.wgb).float())
            o = (o.float() * gate.view(b, s, nh, d)).to(self.dtype)
            return o.reshape(b, s, c) @ self.wo
