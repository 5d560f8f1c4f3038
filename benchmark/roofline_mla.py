"""The yardstick's arithmetic for a latent-attention, routed-expert
configuration (the DeepSeek-V3 block): the work a forward needs, the
least time of a ``generate`` call, and the least time of a launch of K7
(the latent-attention decode) and of the expert layer's grouped GEMMs.

Frozen here, as ``benchmark/roofline.py`` is, so that a change to the
program cannot move the yardstick; the peaks are that module's. Sizes
come from the configuration file's published keys. Everything is in
seconds, FLOPs and bytes; nothing here imports torch.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

from benchmark.roofline import ELT_BYTES, bound_s

# Substrings of the device symbols of K7 (``mla_decode_split``,
# ``mla_decode_combine``) and of the grouped GEMMs (``moe_gemm_up``,
# ``moe_gemm_down``), none of which holds a K1-K6 name.
MLA_DECODE, MOE_GEMM = "mla_decode", "moe_gemm"


def dims(cfg: dict) -> SimpleNamespace:
    """The published sizes under short names."""
    return SimpleNamespace(
        d=cfg["hidden_size"], h=cfg["num_attention_heads"],
        rank=cfg["kv_lora_rank"], rope=cfg["qk_rope_head_dim"],
        nope=cfg["qk_nope_head_dim"], dv=cfg["v_head_dim"],
        e=cfg["n_routed_experts"], f=cfg["moe_intermediate_size"],
        fs=cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
        ff=cfg["intermediate_size"], k=cfg["num_experts_per_tok"],
        layers=cfg["num_hidden_layers"], dense=cfg["first_k_dense_replace"],
        vocab=cfg["vocab_size"])


def attn_params(c) -> int:
    """One layer's attention weights: q, the latent with k_pe, the
    latent's expansion to keys and values, the output."""
    return (c.d * c.h * (c.nope + c.rope) + c.d * (c.rank + c.rope)
            + c.rank * c.h * (c.nope + c.dv) + c.h * c.dv * c.d)


def weight_bytes(c, dtype: str) -> float:
    """Every weight read once: the layers' projections, every expert's
    and the head in the model dtype, the norms and the correction bias
    f32 (the embedding is counted by the rows looked up)."""
    moe = c.d * c.e + 3 * c.e * c.d * c.f + 3 * c.d * c.fs
    mats = (c.layers * attn_params(c) + c.dense * 3 * c.d * c.ff
            + (c.layers - c.dense) * moe + c.d * c.vocab)
    f32 = ((2 * c.layers + 1) * c.d + c.layers * c.rank
           + (c.layers - c.dense) * c.e)
    return mats * ELT_BYTES[dtype] + 4 * f32


def forward_work(cfg: dict, b: int, s: int, past: int, logit_rows: int,
                 dtype: str) -> Tuple[float, float]:
    """FLOPs and bytes that one cached forward needs: b rows of s new
    positions after ``past`` cached ones, logits at ``logit_rows``
    positions a row. FLOPs: 2 per weight per token for the projections
    and the picked and shared experts (the router too); the attention in
    the plain form where nothing is cached (keys and values expanded
    from the latent at each new position, 2·H·(nope + rope + v) per
    visible pair) and in the absorbed form after a cache (q and o
    through the latent, 2·H·(2·rank + rope) per visible pair); the head
    only where its logits are used. Bytes: every weight once, the
    embedding rows looked up, the latent cache read over the past
    positions and written at the new ones."""
    c, elt = dims(cfg), ELT_BYTES[dtype]
    tok = b * s
    pairs = b * (s * past + s * (s + 1) // 2)
    proj = 2 * (c.d * c.h * (c.nope + c.rope) + c.d * (c.rank + c.rope)
                + c.h * c.dv * c.d)
    if past == 0:
        proj += 2 * c.rank * c.h * (c.nope + c.dv)
        per_pair = 2 * c.h * (c.nope + c.rope + c.dv)
    else:
        proj += 2 * c.h * c.rank * (c.nope + c.dv)
        per_pair = 2 * c.h * (2 * c.rank + c.rope)
    dense = 6 * c.d * c.ff
    moe = 2 * c.d * c.e + 6 * c.k * c.d * c.f + 6 * c.d * c.fs
    flops = (c.layers * (proj * tok + per_pair * pairs)
             + (c.dense * dense + (c.layers - c.dense) * moe) * tok
             + 2.0 * c.d * c.vocab * b * logit_rows)
    row = c.layers * (c.rank + c.rope) * elt           # a position's latent
    nbytes = (weight_bytes(c, dtype) + tok * c.d * elt
              + b * past * row + tok * row)
    return float(flops), float(nbytes)


def generate_call_min_s(cfg: dict, b: int, p: int, new: int,
                        dtype: str) -> float:
    """The least time of one greedy ``generate`` call of b prompts of p
    tokens and ``new`` new tokens: the prefill (logits at its last
    position) and ``new - 1`` one-token decode steps, each forward held
    to the larger of its FLOPs over the peak and its bytes over HBM."""
    total = bound_s(*forward_work(cfg, b, p, 0, 1, dtype), dtype)[0]
    for j in range(1, new):
        total += bound_s(*forward_work(cfg, b, 1, p + j - 1, 1, dtype),
                         dtype)[0]
    return total


def mla_decode_bound_s(cfg: dict, b: int, live: int, dtype: str) -> float:
    """K7 over b sequences of ``live`` cached positions: 2·H·(2·rank +
    rope) operations a position, against the live latent rows read once,
    q read and the output written."""
    c, elt = dims(cfg), ELT_BYTES[dtype]
    flops = 2.0 * c.h * (2 * c.rank + c.rope) * b * live
    nbytes = (b * live * (c.rank + c.rope) + b * c.h * (2 * c.rank + c.rope)
              ) * elt
    return bound_s(flops, nbytes, dtype)[0]


def moe_gemm_bounds_s(cfg: dict, tokens: int,
                      dtype: str) -> Tuple[float, float]:
    """The grouped GEMMs of one expert layer over ``tokens`` tokens, rows
    = tokens × experts a token, exactly: ``moe_gemm_up`` (gate and up:
    2·rows·d·2f operations, every expert's gate and up weights read
    once, the tokens read and the rows' f-wide products written) and
    ``moe_gemm_down`` (2·rows·f·d, every expert's down weights, the
    products read and the rows' outputs written)."""
    c, elt = dims(cfg), ELT_BYTES[dtype]
    rows = tokens * c.k
    up = bound_s(2.0 * rows * c.d * 2 * c.f,
                 (c.e * c.d * 2 * c.f + tokens * c.d + rows * c.f) * elt,
                 dtype)[0]
    down = bound_s(2.0 * rows * c.f * c.d,
                   (c.e * c.f * c.d + rows * c.f + rows * c.d) * elt,
                   dtype)[0]
    return up, down
