"""The plain reference of Kimi Linear's hybrid decoder (Kimi Delta
Attention and latent attention over routed experts, as
Kimi-Linear-48B-A3B configures it), in float32 PyTorch with TF32 off,
written from the Kimi Linear paper's equations (arXiv:2510.26692) and
not from the program.

Each layer on x (1, S, d), with ``h = RMSNorm(x)``; its kind from
``linear_attn_config`` (1-based lists):

- KDA: ``[q, k, v] = SiLU(conv(h·W_qkv))``, a causal depthwise
  convolution of ``short_conv_kernel_size`` taps over each channel, zeros
  before position 0; per head of ``head_dim`` channels ``q ←
  q/‖q‖``, ``k ← k/‖k‖`` (‖·‖ with 1e-6 under the root); ``log α_t =
  −exp(A_log) · softplus(h·W_fa·W_fb + dt_bias)``, ``β_t = sigmoid(h·W_b)``;
  from ``S_{-1} = 0``, ``S_t = Diag(α_t) S_{t−1} + β_t k_t (v_t −
  k_tᵀ Diag(α_t) S_{t−1})ᵀ`` and ``o_t = S_tᵀ q_t / sqrt(head_dim)``,
  token by token; ``y = x + (RMSNorm(o) ⊙ sigmoid(h·W_ga·W_gb))·W_o``,
  the norm per head with one weight of ``head_dim``;
- MLA: as ``mla_moe_ref.attention`` but with no rope where
  ``mla_use_nope``: ``q = h·W_q`` split into ``q_nope`` and ``q_pe``,
  ``[c̃, k_pe] = h·W_kva``, ``c = RMSNorm_kv(c̃)``, ``[k_nope, v] =
  c·W_kvb``, causal softmax of ``(q_nope·k_nope + q_pe·k_pe) / sqrt(nope
  + rope)``, ``y = x + o·W_o``;
- then ``y + SwiGLU(RMSNorm(y))`` for the first ``first_k_dense_replace``
  layers, else on ``g = RMSNorm(y)``: ``s = sigmoid(g·W_r)`` over the
  router's ``router_experts`` outputs, the ``num_experts_per_token`` picks
  ``top_k(s + e_score_correction_bias)``, ``w_i = routed_scaling_factor
  · s_i / Σ_picks s_j``; the picks that land in the experts held here
  (``num_experts`` from ``first_expert`` on), each a loop over the tokens
  that picked it, ``Σ w_i·SwiGLU_i(g)``, plus the shared expert's SwiGLU
  (width ``moe_intermediate_size · num_shared_experts``) once;
- a final RMSNorm and the untied head.

Departures from the checkpoint are the configuration file's ``assumed``.
``prec="fp8"`` is the control: every projection, the router, each
expert's matrices and the head take their operands rounded to float8
e4m3 (one scale per tensor), the rest stays float32.

It imports torch, the benchmark's weight maker and the other references'
helpers, nothing of the program and nothing of JAX;
:func:`benchmark.harness.reference_imports` checks that.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark import weights_kimi
from benchmark.reference.llama_ref import exact, mm, rmsnorm
from benchmark.reference.mla_moe_ref import causal_attention, swiglu


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The gated delta rule, token by token from a zero state: q, k, v
    and log_alpha (N, S, H, D), beta (N, S, H). Returns o (N, S, H, D)."""
    n, s, h, d = q.shape
    state = q.new_zeros(n, h, d, d)
    out = []
    for t in range(s):
        state = log_alpha[:, t].exp()[..., None] * state
        kt = k[:, t]
        err = v[:, t] - torch.einsum("nhk,nhkv->nhv", kt, state)
        state = state + beta[:, t, :, None, None] * kt[..., None] \
            * err[:, :, None, :]
        out.append(torch.einsum("nhk,nhkv->nhv", q[:, t], state)
                   / math.sqrt(d))
    return torch.stack(out, 1)


def kda(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict, prec: str,
        prefix: str) -> torch.Tensor:
    """x + the KDA mixer of one layer, over x (N, S, d): N sequences
    that start at position 0 (the causal recurrence and convolution never
    read a later position, so sequences padded at their end are exact up
    to their lengths)."""
    lin = cfg["linear_attn_config"]
    nh, d, kw = lin["num_heads"], lin["head_dim"], \
        lin["short_conv_kernel_size"]
    n, s, _ = x.shape
    c = nh * d
    eps = cfg["rms_norm_eps"]
    p = prefix + "kda."
    h = rmsnorm(x, w[prefix + "attn_norm.weight"], eps)
    pre = F.pad(mm(h, w[p + "wqkv"], prec), (0, 0, kw - 1, 0))
    conv = w[p + "conv"]
    y = sum(pre[:, j:j + s] * conv[:, j] for j in range(kw))
    q, k, v = (t.reshape(n, s, nh, d) for t in F.silu(y).split(c, dim=-1))
    q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + 1e-6)
    k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + 1e-6)
    f = mm(mm(h, w[p + "wfa"], prec), w[p + "wfb"], prec) + w[p + "dt_bias"]
    log_alpha = -w[p + "A_log"].exp()[:, None] * F.softplus(f).view(
        n, s, nh, d)
    beta = torch.sigmoid(mm(h, w[p + "wb"], prec))
    o = recurrence(q, k, v, log_alpha, beta)
    gate = torch.sigmoid(mm(mm(h, w[p + "wga"], prec), w[p + "wgb"], prec))
    o = rmsnorm(o, w[p + "o_norm.weight"], eps) * gate.view(n, s, nh, d)
    return x + mm(o.reshape(n, s, c), w[p + "wo"], prec)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
              prec: str, prefix: str) -> torch.Tensor:
    """x + the latent attention of one layer, x (1, S, d), with no rope
    (``mla_use_nope``)."""
    if not cfg["mla_use_nope"]:
        raise ValueError("this reference computes mla_use_nope only")
    b, s, _ = x.shape
    h_n, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope_d, rank = cfg["qk_rope_head_dim"], cfg["kv_lora_rank"]
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(x, w[prefix + "attn_norm.weight"], eps)
    q = mm(h, w[prefix + "attn.wq"], prec).view(b, s, h_n, -1).transpose(1, 2)
    c, k_pe = mm(h, w[prefix + "attn.wkva"], prec).split([rank, rope_d], -1)
    c = rmsnorm(c, w[prefix + "attn.kv_norm.weight"], eps)
    kv = mm(c, w[prefix + "attn.wkvb"], prec).view(b, s, h_n, -1)
    k_nope, v = kv.transpose(1, 2).split([nope, cfg["v_head_dim"]], dim=-1)
    k = torch.cat([k_nope, k_pe[:, None].expand(-1, h_n, -1, -1)], dim=-1)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(nope + rope_d))
    return x + mm(o.transpose(1, 2).reshape(b, s, -1), w[prefix + "attn.wo"],
                  prec)


def experts(g: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
            prec: str, prefix: str) -> torch.Tensor:
    """This card's share of the expert layer on g (T, d): the picks of
    the experts held here, weighed, plus the shared expert."""
    p = prefix + "moe."
    first, held = cfg.get("first_expert", 0), cfg["num_experts"]
    s = torch.sigmoid(mm(g, w[p + "router"], prec))
    ids = torch.topk(s + w[p + "router_bias"],
                     cfg["num_experts_per_token"], dim=-1).indices
    picked = s.gather(1, ids)
    wts = picked / picked.sum(-1, keepdim=True) \
        * cfg["routed_scaling_factor"]
    out = torch.zeros_like(g)
    for e in range(held):
        tok, slot = (ids == first + e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(g[tok], w[p + "w_gate"][e], w[p + "w_up"][e],
                       w[p + "w_down"][e], prec)
            out.index_add_(0, tok, y * wts[tok, slot, None])
    return out + swiglu(g, w[p + "shared.w_gate"], w[p + "shared.w_up"],
                        w[p + "shared.w_down"], prec)


def mlp(y: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict, prec: str,
        index: int) -> torch.Tensor:
    """y + the layer's dense SwiGLU or expert layer, over y (T, d)."""
    prefix = f"layers.{index}."
    g = rmsnorm(y, w[prefix + "mlp_norm.weight"], cfg["rms_norm_eps"])
    if index < cfg["first_k_dense_replace"]:
        return y + swiglu(g, w[prefix + "mlp.w_gate"], w[prefix + "mlp.w_up"],
                          w[prefix + "mlp.w_down"], prec)
    return y + experts(g, w, cfg, prec, prefix)


def layer(xs: List[torch.Tensor], w: Dict[str, torch.Tensor], cfg: dict,
          prec: str, index: int) -> List[torch.Tensor]:
    """One layer over each sequence of ``xs`` (each (1, S_i, d)): KDA over
    the sequences padded at their ends to one length, or the attention a
    sequence at a time; the MLP over all their tokens."""
    prefix = f"layers.{index}."
    lens = [x.shape[1] for x in xs]
    if index in weights_kimi.kda_layers(cfg):
        pad = torch.stack([F.pad(x[0], (0, 0, 0, max(lens) - x.shape[1]))
                           for x in xs])
        out = kda(pad, w, cfg, prec, prefix)
        ys = [out[j, :n] for j, n in enumerate(lens)]
    else:
        ys = [attention(x, w, cfg, prec, prefix)[0] for x in xs]
    y = mlp(torch.cat(ys), w, cfg, prec, index)
    return [t[None] for t in y.split(lens)]


def _f32(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in group.items()}


@torch.no_grad()
def forward(cfg: dict, seed: int, seqs: Sequence[torch.Tensor],
            dtype: torch.dtype, device, precs: Sequence[str] = ("f32",),
            first: Sequence[int] = ()) -> List[Dict[str, torch.Tensor]]:
    """For each sequence of token ids (S_i,), the logits (S_i - first_i,
    vocab) at its positions from ``first_i`` on (0 where ``first`` is
    empty), in each precision of ``precs``; each layer's weights drawn
    once from the seed for every sequence."""
    exact()
    first = list(first) or [0] * len(seqs)
    embed = _f32(weights_kimi.draw_group(cfg, seed, 0, device, dtype))["embed"]
    xs = {pr: [F.embedding(s.to(device)[None], embed) for s in seqs]
          for pr in precs}
    del embed
    n = cfg["num_hidden_layers"]
    for i in range(n):
        w = _f32(weights_kimi.draw_group(cfg, seed, 1 + i, device, dtype))
        for pr in precs:
            xs[pr] = layer(xs[pr], w, cfg, pr, i)
        del w
    w = _f32(weights_kimi.draw_group(cfg, seed, 1 + n, device, dtype))
    out = []
    for j, f0 in enumerate(first):
        got = {}
        for pr in precs:
            x = xs[pr][j][0, f0:]
            got[pr] = mm(rmsnorm(x, w["final_norm.weight"],
                                 cfg["rms_norm_eps"]), w["lm_head"], pr)
        out.append(got)
    return out


def served_logits(cfg: dict, seed: int, requests: Sequence, dtype: torch.dtype,
                  device, precs: Sequence[str] = ("f32",)
                  ) -> List[Dict[str, torch.Tensor]]:
    """For each request (prompt ids (P,), served ids (n,)), the logits
    (n, vocab) at the positions that chose its served tokens: the forward
    over the prompt and the served tokens but the last."""
    seqs = [torch.cat([p.to(device), t.to(device)[:-1]]) for p, t in requests]
    return forward(cfg, seed, seqs, dtype, device, precs,
                   [p.numel() - 1 for p, _ in requests])
