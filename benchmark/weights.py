"""Weights and token streams made from the run's seed, on the device.

The weights follow the scheme of the port's ``init_params`` (frozen
here): every projection normal with std 1/sqrt(fan_in), the embedding
std 1/sqrt(d_model), the norm weights ones in f32, drawn in f32 and
cast to the served dtype. They are drawn in groups, one ``torch.randn``
over a whole group from a generator on the device seeded from (seed,
group): the embedding, each block, and the final norm with the head. A
group can be drawn again alone, so the reference rebuilds one block at a
time from the seed, and never reads the program's weights.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

_MASK = (1 << 63) - 1


def mix(seed: int, *keys: int) -> int:
    """A 63-bit generator seed from the run's seed and stream keys."""
    x = int(seed) & _MASK
    for k in keys:
        x = (x * 0x9E3779B97F4A7C15 + int(k) + 0x632BE59BD9B4E019) & _MASK
        x ^= x >> 29
    return x


def generator(device, seed: int, *keys: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, *keys))
    return g


# Stream keys: the weights, each step's batch, each call's prompts, the
# requests the check samples, the order of each cycle of prompt lengths.
WEIGHTS, BATCH, PROMPT, SAMPLE, ORDER = 1, 2, 3, 4, 5


def groups(shape) -> List[Tuple[str, List[Tuple[str, tuple, float]]]]:
    """(group, [(state-dict name, shape, std)]) in draw order; std 0
    marks a norm weight (ones in f32)."""
    d, hd = shape.d_model, shape.head_dim
    q, kv, f = shape.n_heads * hd, shape.n_kv_heads * hd, shape.d_ff
    out = [("embed", [("embed", (shape.vocab_size, d), 1 / math.sqrt(d))])]
    for i in range(shape.n_layers):
        p = f"layers.{i}."
        out.append((f"layers.{i}", [
            (p + "attn_norm.weight", (d,), 0.0),
            (p + "attn.wq", (d, q), 1 / math.sqrt(d)),
            (p + "attn.wk", (d, kv), 1 / math.sqrt(d)),
            (p + "attn.wv", (d, kv), 1 / math.sqrt(d)),
            (p + "attn.wo", (q, d), 1 / math.sqrt(q)),
            (p + "mlp_norm.weight", (d,), 0.0),
            (p + "mlp.w_gate", (d, f), 1 / math.sqrt(d)),
            (p + "mlp.w_up", (d, f), 1 / math.sqrt(d)),
            (p + "mlp.w_down", (f, d), 1 / math.sqrt(f)),
        ]))
    out.append(("head", [("final_norm.weight", (d,), 0.0),
                         ("lm_head", (d, shape.vocab_size),
                          1 / math.sqrt(d))]))
    return out


def draw_group(shape, seed: int, index: int, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Group ``index`` of :func:`groups` as tensors on ``device``: the
    projections in ``dtype``, the norm weights ones in f32."""
    _, leaves = groups(shape)[index]
    n = sum(math.prod(s) for _, s, std in leaves if std)
    flat = torch.randn(n, generator=generator(device, seed, WEIGHTS, index),
                       dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, s, std in leaves:
        if not std:
            out[name] = torch.ones(s, dtype=torch.float32, device=device)
            continue
        k = math.prod(s)
        out[name] = flat[at:at + k].view(s).mul(std).to(dtype)
        at += k
    return out


def draw_all(shape, seed: int, device,
             dtype: torch.dtype) -> Iterator[Dict[str, torch.Tensor]]:
    """Every group in order, one at a time."""
    for index in range(len(groups(shape))):
        yield draw_group(shape, seed, index, device, dtype)


def tokens(device, vocab: int, rows: int, cols: int, seed: int,
           *keys: int) -> torch.Tensor:
    """(rows, cols) int64 token ids, uniform over the vocabulary, from
    the stream (seed, keys)."""
    return torch.randint(0, vocab, (rows, cols),
                         generator=generator(device, seed, *keys),
                         device=device)
