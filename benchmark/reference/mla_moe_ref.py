"""The plain reference of the latent-attention, routed-expert decoder
(the DeepSeek-V3 block as Moonlight-16B-A3B configures it), in float32
PyTorch with TF32 off, written from the published equations and not from
the program.

Layer on x (B, S, d), the non-absorbed form at every position:

- ``h = RMSNorm(x)``; ``q = h·W_q`` per head, split into ``q_nope``
  (``qk_nope_head_dim``) and ``q_pe`` (``qk_rope_head_dim``);
  ``[c̃, k_pe] = h·W_kva``; ``c = RMSNorm_kv(c̃)``;
- ``q_pe`` and the one shared ``k_pe`` roped split-half at base
  ``rope_theta``, positions 0..S-1;
- ``[k_nope, v] = c·W_kvb`` per head; softmax of ``(q_nope·k_nope +
  q_pe·k_pe) / sqrt(nope + rope)``, causal; ``o = P·v``;
  ``y = x + o·W_o``;
- the first ``first_k_dense_replace`` layers: ``y + SwiGLU(RMSNorm(y))``
  of width ``intermediate_size``; the others, on ``g = RMSNorm(y)``:
  ``s = sigmoid(g·W_r)``, the ``num_experts_per_tok`` picks
  ``top_k(s + e_score_correction_bias)``, ``w_i = routed_scaling_factor
  · s_i / Σ_picks s_j``, ``y + Σ_i w_i·SwiGLU_i(g) + SwiGLU_shared(g)``
  (the shared experts as one SwiGLU of width ``moe_intermediate_size ·
  n_shared_experts``), each expert a loop over the tokens that picked it;
- a final RMSNorm and the untied head.

Departures from the checkpoint, as the configuration file's ``assumed``
lists: split-half rope where the checkpoint stores the rope columns
interleaved (a fixed permutation of W_q's and W_kva's columns at random
weights), and the correction bias zeros.

``prec="fp8"`` is the control: every projection, the router, each
expert's matrices and the head take their operands rounded to float8 e4m3
(one scale per tensor), the rest stays float32.

It imports torch, the benchmark's weight maker and the Llama reference's
helpers, nothing of the program and nothing of JAX;
:func:`benchmark.harness.reference_imports` checks that.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark import weights_mla
from benchmark.reference.llama_ref import exact, mm, rmsnorm, rope


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, rows: int = 1024) -> torch.Tensor:
    """q, k (B, H, S, dqk) and v (B, H, S, dv): softmax attention where
    query i sees keys 0..i, in blocks of query rows so that the scores of
    a long sequence fit."""
    s = q.shape[2]
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2) * scale
        qi = torch.arange(r0, r1, device=q.device)[:, None]
        ki = torch.arange(r1, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        outs.append(sc.softmax(-1) @ v[:, :, :r1])
    return torch.cat(outs, dim=2)


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
              prec: str, prefix: str) -> torch.Tensor:
    """x + the attention of one layer, x (1, S, d)."""
    b, s, _ = x.shape
    h_n, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope_d, rank = cfg["qk_rope_head_dim"], cfg["kv_lora_rank"]
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    h = rmsnorm(x, w[prefix + "attn_norm.weight"], eps)
    q = mm(h, w[prefix + "attn.wq"], prec).view(b, s, h_n, -1).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope_d], dim=-1)
    c, k_pe = mm(h, w[prefix + "attn.wkva"], prec).split([rank, rope_d], -1)
    c = rmsnorm(c, w[prefix + "attn.kv_norm.weight"], eps)
    kv = mm(c, w[prefix + "attn.wkvb"], prec).view(b, s, h_n, -1)
    k_nope, v = kv.transpose(1, 2).split([nope, cfg["v_head_dim"]], dim=-1)
    k_pe = rope(k_pe[:, None], theta).expand(-1, h_n, -1, -1)
    q = torch.cat([q_nope, rope(q_pe, theta)], dim=-1)
    k = torch.cat([k_nope, k_pe], dim=-1)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(nope + rope_d))
    return x + mm(o.transpose(1, 2).reshape(b, s, -1), w[prefix + "attn.wo"],
                  prec)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wu, prec), wd, prec)


def experts(g: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
            prec: str, prefix: str) -> torch.Tensor:
    """The expert layer's output (routed and shared) on g (T, d)."""
    p = prefix + "moe."
    s = torch.sigmoid(mm(g, w[p + "router"], prec))
    ids = torch.topk(s + w[p + "router_bias"],
                     cfg["num_experts_per_tok"], dim=-1).indices
    picked = s.gather(1, ids)
    wts = picked / picked.sum(-1, keepdim=True) \
        * cfg["routed_scaling_factor"]
    out = torch.zeros_like(g)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(g[tok], w[p + "w_gate"][e], w[p + "w_up"][e],
                       w[p + "w_down"][e], prec)
            out.index_add_(0, tok, y * wts[tok, slot, None])
    return out + swiglu(g, w[p + "shared.w_gate"], w[p + "shared.w_up"],
                        w[p + "shared.w_down"], prec)


def layer(xs: List[torch.Tensor], w: Dict[str, torch.Tensor], cfg: dict,
          prec: str, index: int) -> List[torch.Tensor]:
    """One layer over each sequence of ``xs`` (each (1, S_i, d)): the
    attention a sequence at a time, the MLP over all their tokens."""
    prefix = f"layers.{index}."
    ys = [attention(x, w, cfg, prec, prefix) for x in xs]
    y = torch.cat([t[0] for t in ys])
    g = rmsnorm(y, w[prefix + "mlp_norm.weight"], cfg["rms_norm_eps"])
    if index < cfg["first_k_dense_replace"]:
        y = y + swiglu(g, w[prefix + "mlp.w_gate"], w[prefix + "mlp.w_up"],
                       w[prefix + "mlp.w_down"], prec)
    else:
        y = y + experts(g, w, cfg, prec, prefix)
    return [t[None] for t in y.split([x.shape[1] for x in xs])]


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
    embed = _f32(weights_mla.draw_group(cfg, seed, 0, device, dtype))["embed"]
    xs = {pr: [F.embedding(s.to(device)[None], embed) for s in seqs]
          for pr in precs}
    del embed
    n = cfg["num_hidden_layers"]
    for i in range(n):
        w = _f32(weights_mla.draw_group(cfg, seed, 1 + i, device, dtype))
        for pr in precs:
            xs[pr] = layer(xs[pr], w, cfg, pr, i)
        del w
    w = _f32(weights_mla.draw_group(cfg, seed, 1 + n, device, dtype))
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
