"""The plain reference: the decoder that the configurations describe, in
float32 PyTorch with TF32 off, written from the published equations and
not from the program.

Block: x + Attn(RMSNorm(x)) then + MLP(RMSNorm(·)); RMSNorm(x) =
x · rsqrt(mean(x²) + eps) · w; grouped-query attention with split-half
rotary embeddings at base ``rope_theta``, causal, softmax over q·k /
sqrt(head_dim); SwiGLU MLP (silu(x·W_gate) ∘ x·W_up)·W_down; untied
head. Weights are the benchmark's own, drawn again from the seed one
group at a time (:mod:`benchmark.weights`), in the served dtype and read
as float32.

``prec="fp8"`` is the control: every projection and the head take their
operands rounded to float8 e4m3 (one scale per tensor, as an fp8 GEMM
takes them), the step below the configurations' bfloat16 that would
tempt a later change; the rest stays float32.

It imports torch and the benchmark's weight maker, nothing of the
program and nothing of JAX; :func:`benchmark.harness.reference_imports`
checks that.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark import weights

FP8_MAX = 448.0


def exact() -> None:
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor; the
    gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        x, w = fp8(x), fp8(w)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, heads, S, hd) at positions 0..S-1, split-half rotation."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rows: int = 1024) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, KVH, S, hd): softmax attention where
    query i sees keys 0..i, in blocks of query rows so that the scores
    of a long sequence fit."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    rep = h // kvh
    qg = q.reshape(b, kvh, rep, s, hd)
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = torch.einsum("bgrqd,bgkd->bgrqk", qg[:, :, :, r0:r1],
                          k[:, :, :r1]) / math.sqrt(hd)
        qi = torch.arange(r0, r1, device=q.device)[:, None]
        ki = torch.arange(r1, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        outs.append(torch.einsum("bgrqk,bgkd->bgrqd", sc.softmax(-1),
                                 v[:, :, :r1]))
    return torch.cat(outs, dim=3).reshape(b, h, s, hd)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], shape, prec: str,
          prefix: str) -> torch.Tensor:
    """One decoder block on x (B, S, d) with the weights ``w`` named as
    the state dict names them under ``prefix``."""
    b, s, _ = x.shape
    hd = shape.head_dim

    def heads(t):
        return t.view(b, s, -1, hd).transpose(1, 2)

    h = rmsnorm(x, w[prefix + "attn_norm.weight"], shape.norm_eps)
    q = rope(heads(mm(h, w[prefix + "attn.wq"], prec)), shape.rope_theta)
    k = rope(heads(mm(h, w[prefix + "attn.wk"], prec)), shape.rope_theta)
    v = heads(mm(h, w[prefix + "attn.wv"], prec))
    o = causal_attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
    x = x + mm(o, w[prefix + "attn.wo"], prec)
    h = rmsnorm(x, w[prefix + "mlp_norm.weight"], shape.norm_eps)
    gate = F.silu(mm(h, w[prefix + "mlp.w_gate"], prec))
    return x + mm(gate * mm(h, w[prefix + "mlp.w_up"], prec),
                  w[prefix + "mlp.w_down"], prec)


def _f32(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in group.items()}


# ---------------------------------------------------------------- serving

@torch.no_grad()
def served_logits(shape, seed: int, requests: Sequence, dtype: torch.dtype,
                  device, precs: Sequence[str] = ("f32",)
                  ) -> List[Dict[str, torch.Tensor]]:
    """For each request (prompt ids (P,), served ids (n,)), the logits
    (n, vocab) at the positions that chose its served tokens: the
    forward over the prompt and the served tokens but the last, block by
    block with each block's weights drawn once for every request, in
    each precision of ``precs``."""
    exact()
    seqs = [torch.cat([p.to(device), t.to(device)[:-1]])[None]
            for p, t in requests]
    embed = _f32(weights.draw_group(shape, seed, 0, device, dtype))["embed"]
    xs = {pr: [F.embedding(s, embed) for s in seqs] for pr in precs}
    del embed
    for i in range(shape.n_layers):
        w = _f32(weights.draw_group(shape, seed, 1 + i, device, dtype))
        for pr in precs:
            xs[pr] = [block(x, w, shape, pr, f"layers.{i}.") for x in xs[pr]]
        del w
    w = _f32(weights.draw_group(shape, seed, 1 + shape.n_layers, device,
                                dtype))
    out = []
    for j, (p, t) in enumerate(requests):
        first = p.numel() - 1
        got = {}
        for pr in precs:
            x = xs[pr][j][0, first:]
            got[pr] = mm(rmsnorm(x, w["final_norm.weight"], shape.norm_eps),
                         w["lm_head"], pr)
        out.append(got)
    return out


def served_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each chosen token's reference logit lies below the
    reference's best at its position: (n,), 0 where it is the best."""
    tokens = tokens.to(logits.device)
    return logits.max(-1).values - logits.gather(1, tokens[:, None])[:, 0]


# --------------------------------------------------------------- training

def _loss(params: Dict[str, torch.Tensor], shape, row: torch.Tensor,
          prec: str) -> torch.Tensor:
    """Mean next-token cross entropy of one row (1, S + 1), each block
    recomputed in the backward so that a long row fits."""
    x = F.embedding(row[:, :-1], params["embed"])
    for i in range(shape.n_layers):
        prefix = f"layers.{i}."
        w = {k: v for k, v in params.items() if k.startswith(prefix)}
        x = torch.utils.checkpoint.checkpoint(
            block, x, w, shape, prec, prefix, use_reentrant=False)
    logits = mm(rmsnorm(x, params["final_norm.weight"], shape.norm_eps),
                params["lm_head"], prec)
    return F.cross_entropy(logits[0], row[0, 1:])


def train_steps(shape, seed: int, batches: Sequence[torch.Tensor],
                dtype: torch.dtype, device, lr: float, wd: float,
                prec: str = "f32", rows=None) -> Dict[str, object]:
    """AdamW (betas 0.9 and 0.999, eps 1e-8, decoupled decay on every
    weight) from the seed's weights over ``batches``, each (B, S + 1):
    the loss of each step, each weight's gradient norm at the first
    step, and each weight's change over all the steps. The gradient of
    a batch is the mean over its rows, summed row by row; ``rows``
    keeps only those rows (a fault: part of the batch left out)."""
    exact()
    start = {}
    for group in weights.draw_all(shape, seed, device, dtype):
        start.update(group)
    params = {k: v.to(torch.float32, copy=True).requires_grad_(True)
              for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches, 1):
        keep = range(batch.shape[0]) if rows is None else rows
        total = 0.0
        for r in keep:
            loss = _loss(params, shape, batch[r:r + 1], prec) / len(keep)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            if step == 1:
                grad_norms = {k: float(p.grad.norm())
                              for k, p in params.items()}
            b1, b2, eps = 0.9, 0.999, 1e-8
            for k, p in params.items():
                g = p.grad
                p.mul_(1 - lr * wd)
                m[k].lerp_(g, 1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
                p.grad = None
    with torch.no_grad():
        change = {k: float((p - start[k].float()).norm())
                  for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
