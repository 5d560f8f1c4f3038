"""The yardstick's arithmetic: the chip's published peaks, the work a
model step needs, and the least time each of the port's kernels could
take for a launch at given shapes.

Frozen copies of ``chip_smoke.py``'s ``model_flops``, ``flash_bound_ms``
and ``flash_bwd_bounds``, of the K1/K2 byte bounds of its kernel cases,
and of ``rocnrdma_tpu_torch.ops._native.KERNELS`` (the kernel symbols),
kept here so that a change to the program cannot move the yardstick.
Everything is in seconds, FLOPs and bytes; nothing here imports torch.

A "shape" is any object with the attributes ``d_model``, ``n_layers``,
``n_heads``, ``n_kv_heads``, ``d_ff``, ``vocab_size`` and ``head_dim``.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA's H100 SXM data sheet, dense rates without sparsity.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}

# The port's hand-written kernels, by the name that every device symbol
# of theirs contains (K1 forward norm, K3 attention forward, K2 norm
# backward, K5 and K4 attention backward).
KERNELS = ("rmsnorm_fwd", "flash_fwd", "rmsnorm_bwd", "flash_bwd_dq",
           "flash_bwd_dkv")


def kernel_of(symbol: str):
    """The port kernel a device symbol belongs to, or None."""
    for name in KERNELS:
        if name in symbol:
            return name
    return None


def bound_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time for ``flops`` and ``nbytes`` on one chip, and which
    of the two bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------- kernels

def rmsnorm_fwd_bound_s(rows: int, d: int, dtype: str) -> float:
    """K1: x read and y written once in the model dtype, the f32 weight
    read once."""
    return (2 * rows * d * ELT_BYTES[dtype] + 4 * d) / HBM_BYTES_PER_S


def rmsnorm_bwd_bound_s(rows: int, d: int, dtype: str) -> float:
    """K2: x and dy read, dx written in the model dtype; the f32 weight
    read and its f32 gradient written."""
    return (3 * rows * d * ELT_BYTES[dtype] + 8 * d) / HBM_BYTES_PER_S


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def flash_fwd_bound_s(b: int, h: int, kvh: int, s: int, d: int,
                      causal: bool, dtype: str) -> float:
    """K3: 4·D operations per visible (q, k) pair per head, against q,
    out, k and v once each and the f32 lse written."""
    elt = ELT_BYTES[dtype]
    flops = 4.0 * d * _pairs(s, causal) * b * h
    nbytes = (2 * b * h * s * d + 2 * b * kvh * s * d) * elt + b * h * s * 4
    return bound_s(flops, nbytes, dtype)[0]


def flash_bwd_bounds_s(b: int, h: int, kvh: int, s: int, d: int,
                       causal: bool, dtype: str) -> Dict[str, float]:
    """K4 (``flash_bwd_dkv``, 8·D operations a pair) and K5
    (``flash_bwd_dq``, 6·D), each against q, dO, k, v, lse and delta
    read and its own outputs written."""
    elt = ELT_BYTES[dtype]
    pairs = _pairs(s, causal)
    q_bytes = b * h * s * d * elt
    kv_bytes = b * kvh * s * d * elt
    in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * b * h * s * 4
    out = {}
    for name, ops_per, out_bytes in (("flash_bwd_dkv", 8, 2 * kv_bytes),
                                     ("flash_bwd_dq", 6, q_bytes)):
        out[name] = bound_s(ops_per * d * pairs * b * h,
                            in_bytes + out_bytes, dtype)[0]
    return out


# ------------------------------------------------------------- models

def layer_matmul_params(shape) -> int:
    """Weights of one block's projections: q, k, v, o and the three of
    the SwiGLU MLP."""
    hd = shape.head_dim
    return shape.d_model * hd * (2 * shape.n_heads + 2 * shape.n_kv_heads) \
        + 3 * shape.d_model * shape.d_ff


def matmul_params(shape) -> int:
    """The layers' projections and the LM head (the embedding is a
    lookup)."""
    return shape.n_layers * layer_matmul_params(shape) \
        + shape.d_model * shape.vocab_size


def train_step_flops(shape, b: int, s: int) -> float:
    """Model FLOPs of one train step on b rows of s positions, remat
    recompute not counted: 6 per matmul parameter per token, plus the
    causal attention products, 4·D per visible (q, k) pair per head
    forward, times 3 for forward and backward."""
    pairs = s * (s + 1) // 2
    attn = 3 * 4 * shape.head_dim * pairs * shape.n_heads * b * shape.n_layers
    return 6.0 * matmul_params(shape) * b * s + attn


def forward_work(shape, b: int, s: int, past: int, logit_rows: int,
                 dtype: str) -> Tuple[float, float]:
    """FLOPs and bytes that one cached forward needs: b rows of s new
    positions after ``past`` cached ones, logits at ``logit_rows``
    positions a row. FLOPs: 2 per matmul weight per token, the causal
    products against the past and the new positions, the head only
    where its logits are used. Bytes: every weight read once (the
    layers' and the head's in the model dtype, the norms' f32, the
    embedding rows looked up), the cache read over the past positions
    and written at the new ones."""
    elt = ELT_BYTES[dtype]
    hd, L = shape.head_dim, shape.n_layers
    pairs = s * past + s * (s + 1) // 2
    flops = (2.0 * layer_matmul_params(shape) * L * b * s
             + 4.0 * hd * pairs * shape.n_heads * L * b
             + 2.0 * shape.d_model * shape.vocab_size * b * logit_rows)
    kv_row = 2 * shape.n_kv_heads * hd * elt * L          # K and V, a position
    nbytes = (layer_matmul_params(shape) * L * elt
              + shape.d_model * shape.vocab_size * elt
              + (2 * L + 1) * shape.d_model * 4
              + b * s * shape.d_model * elt
              + b * past * kv_row + b * s * kv_row)
    return flops, nbytes


def generate_call_min_s(shape, b: int, p: int, new: int, dtype: str) -> float:
    """The least time of one greedy ``generate`` call of b prompts of p
    tokens and ``new`` new tokens: the prefill (logits at its last
    position) and ``new - 1`` one-token decode steps, each forward held
    to the larger of its FLOPs over the peak and its bytes over HBM."""
    total = bound_s(*forward_work(shape, b, p, 0, 1, dtype), dtype)[0]
    for j in range(1, new):
        total += bound_s(*forward_work(shape, b, 1, p + j - 1, 1, dtype),
                         dtype)[0]
    return total
