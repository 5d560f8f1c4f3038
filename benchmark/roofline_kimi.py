"""The yardstick's arithmetic for a Kimi Linear configuration (KDA and
latent-attention layers over routed experts, of which a card holds a
share): the work a forward needs, the least time of a ``generate`` call,
and the least time of a launch of K9 (KDA's recurrence), K7 (the latent
decode) and the expert layer's grouped GEMMs over the rows and experts
that the program's device counters report.

Frozen here, as ``benchmark/roofline.py`` and ``roofline_mla.py`` are,
so that a change to the program cannot move the yardstick; the peaks are
``roofline.py``'s. Sizes come from the configuration file's keys. An
expert layer computes only the picks that land in the experts held here:
the model step's work counts a share ``num_experts / router_experts`` of
every token's picks, as a balanced router spreads them.
Everything is in seconds, FLOPs and bytes; nothing here imports torch.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

from benchmark import roofline_mla
from benchmark.roofline import ELT_BYTES, bound_s

# Substring of K9's device symbol (``kda_recurrent_kernel``), in no K1-K8
# or G1 name; K7's and G1's are roofline_mla's.
KDA_RECURRENT = "kda_recurrent"
MLA_DECODE, MOE_GEMM = roofline_mla.MLA_DECODE, roofline_mla.MOE_GEMM
# Operations of one token and head of the recurrence (the decay, k·S,
# the rank-1 update, q·S) per D² channels.
KDA_OPS_PER_D2 = 7


def dims(cfg: dict) -> SimpleNamespace:
    """The configuration's sizes under short names."""
    lin = cfg["linear_attn_config"]
    e = cfg["num_experts"]
    return SimpleNamespace(
        d=cfg["hidden_size"], h=cfg["num_attention_heads"],
        rank=cfg["kv_lora_rank"], rope=cfg["qk_rope_head_dim"],
        nope=cfg["qk_nope_head_dim"], dv=cfg["v_head_dim"],
        e=e, routed=cfg.get("router_experts", e),
        f=cfg["moe_intermediate_size"],
        fs=cfg["moe_intermediate_size"] * cfg["num_shared_experts"],
        ff=cfg["intermediate_size"], k=cfg["num_experts_per_token"],
        layers=cfg["num_hidden_layers"], dense=cfg["first_k_dense_replace"],
        vocab=cfg["vocab_size"], kda=len(lin["kda_layers"]),
        kh=lin["num_heads"], kd=lin["head_dim"],
        kw=lin["short_conv_kernel_size"])


def mla_config(cfg: dict) -> dict:
    """The configuration under the DeepSeek-V3 names that
    :mod:`benchmark.roofline_mla` reads (its expert counts this card's)."""
    return {"hidden_size": cfg["hidden_size"],
            "num_attention_heads": cfg["num_attention_heads"],
            "kv_lora_rank": cfg["kv_lora_rank"],
            "qk_rope_head_dim": cfg["qk_rope_head_dim"],
            "qk_nope_head_dim": cfg["qk_nope_head_dim"],
            "v_head_dim": cfg["v_head_dim"],
            "n_routed_experts": cfg["num_experts"],
            "moe_intermediate_size": cfg["moe_intermediate_size"],
            "n_shared_experts": cfg["num_shared_experts"],
            "intermediate_size": cfg["intermediate_size"],
            "num_experts_per_tok": cfg["num_experts_per_token"],
            "num_hidden_layers": cfg["num_hidden_layers"],
            "first_k_dense_replace": cfg["first_k_dense_replace"],
            "vocab_size": cfg["vocab_size"]}


def kda_params(c) -> int:
    """One KDA mixer's weights: W_qkv, the convolution, the decay's and
    the output gate's two factors, W_b, W_o."""
    ch = c.kh * c.kd
    return (c.d * 3 * ch + 3 * ch * c.kw + 2 * (c.d * c.kd + c.kd * ch)
            + c.d * c.kh + ch * c.d)


def weight_bytes(c, dtype: str) -> float:
    """Every weight held here read once: the mixers', the dense layer's,
    the held experts', the shared experts', the routers' and the head in
    the model dtype; the norms, the correction biases, A_log and dt_bias
    f32 (the embedding is counted by the rows looked up)."""
    moe = c.d * c.routed + 3 * c.e * c.d * c.f + 3 * c.d * c.fs
    mla = c.layers - c.kda
    mats = (c.kda * kda_params(c) + mla * roofline_mla.attn_params(c)
            + c.dense * 3 * c.d * c.ff + (c.layers - c.dense) * moe
            + c.d * c.vocab)
    f32 = ((2 * c.layers + 1) * c.d + mla * c.rank
           + c.kda * (c.kh + c.kh * c.kd + c.kd)
           + (c.layers - c.dense) * c.routed)
    return mats * ELT_BYTES[dtype] + 4 * f32


def forward_work(cfg: dict, b: int, s: int, past: int, logit_rows: int,
                 dtype: str) -> Tuple[float, float]:
    """FLOPs and bytes that one cached forward needs: b rows of s new
    positions after ``past`` cached ones, logits at ``logit_rows``
    positions a row. FLOPs: 2 per weight per token for the projections,
    the router, the held share of the picked experts and the shared
    expert; KDA's convolution (2 per tap) and recurrence (7·D² a token and
    head); MLA's attention as :func:`roofline_mla.forward_work` counts it;
    the head only where its logits are used. Bytes: every weight held
    once, the embedding rows looked up, the latent cache read over the
    past positions and written at the new ones, and each KDA state
    written once (and read first where the sequence has a past)."""
    c, elt = dims(cfg), ELT_BYTES[dtype]
    tok = b * s
    mla = c.layers - c.kda
    ch = c.kh * c.kd
    pairs = b * (s * past + s * (s + 1) // 2)
    proj = 2 * (c.d * c.h * (c.nope + c.rope) + c.d * (c.rank + c.rope)
                + c.h * c.dv * c.d)
    if past == 0:
        proj += 2 * c.rank * c.h * (c.nope + c.dv)
        per_pair = 2 * c.h * (c.nope + c.rope + c.dv)
    else:
        proj += 2 * c.h * c.rank * (c.nope + c.dv)
        per_pair = 2 * c.h * (2 * c.rank + c.rope)
    kda = 2 * kda_params(c) + KDA_OPS_PER_D2 * c.kd * c.kd * c.kh
    dense = 6 * c.d * c.ff
    moe = (2 * c.d * c.routed + 6 * c.k * c.e / c.routed * c.d * c.f
           + 6 * c.d * c.fs)
    flops = (mla * (proj * tok + per_pair * pairs) + c.kda * kda * tok
             + (c.dense * dense + (c.layers - c.dense) * moe) * tok
             + 2.0 * c.d * c.vocab * b * logit_rows)
    row = mla * (c.rank + c.rope) * elt              # a position's latent
    state = c.kda * b * (4 * c.kh * c.kd * c.kd
                         + (c.kw - 1) * 3 * ch * elt)
    nbytes = (weight_bytes(c, dtype) + tok * c.d * elt + b * past * row
              + tok * row + state * (2 if past else 1))
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


def kda_bound_s(cfg: dict, b: int, t: int, dtype: str) -> float:
    """K9 over b sequences of t tokens: 7·D² operations a token and head,
    against the state read and written once in f32 and each token's q,
    k, v and o (the model dtype), its decay (f32, D a head) and beta
    (f32) once."""
    c, elt = dims(cfg), ELT_BYTES[dtype]
    flops = float(KDA_OPS_PER_D2 * c.kd * c.kd * c.kh * b * t)
    nbytes = (2 * 4 * b * c.kh * c.kd * c.kd
              + b * t * c.kh * (4 * c.kd * elt + 4 * c.kd + 4))
    return bound_s(flops, nbytes, dtype)[0]


def mla_decode_bound_s(cfg: dict, b: int, live: int, dtype: str) -> float:
    """K7 over b sequences of ``live`` cached positions
    (:func:`roofline_mla.mla_decode_bound_s` at this configuration's
    heads: each live latent row read once a sequence)."""
    return roofline_mla.mla_decode_bound_s(mla_config(cfg), b, live, dtype)


def moe_gemm_bounds_s(cfg: dict, tokens: int, rows: int, experts: int,
                      dtype: str) -> Tuple[float, float]:
    """Least times of the grouped GEMMs over launches that together take
    ``tokens`` tokens, lay out ``rows`` picks of the held experts and
    touch ``experts`` of them (each counted once a launch; the program's
    device counters give both): ``moe_gemm_up`` (gate and up: 2·rows·d·2f
    operations, each touched expert's gate and up weights read once, the
    tokens read and the rows' f-wide products written) and
    ``moe_gemm_down`` (2·rows·f·d, each touched expert's down weights,
    the products read and the rows' outputs written). Summed over the
    launches before the larger side is taken, which is at most the sum of
    each launch's larger side."""
    c, elt = dims(cfg), ELT_BYTES[dtype]
    up = bound_s(2.0 * rows * c.d * 2 * c.f,
                 (experts * c.d * 2 * c.f + tokens * c.d + rows * c.f) * elt,
                 dtype)[0]
    down = bound_s(2.0 * rows * c.f * c.d,
                   (experts * c.f * c.d + rows * c.f + rows * c.d) * elt,
                   dtype)[0]
    return up, down
