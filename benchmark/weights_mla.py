"""Weights of a latent-attention, routed-expert configuration (the
DeepSeek-V3 block), made from the run's seed on the device.

The scheme is :mod:`benchmark.weights`'s, frozen here for this layout:
every projection normal with std 1/sqrt(fan_in) (a stacked expert
weight's fan-in is its middle dimension), the embedding std
1/sqrt(hidden_size), the norm weights ones and the router's correction
bias zeros, both f32; drawn in f32 and cast to the served dtype, one
``torch.randn`` over a whole group from a generator on the device seeded
from (seed, group). The groups are the embedding, each layer, and the
final norm with the head, so the reference rebuilds one layer at a time
from the seed and never reads the program's weights.

Shapes come from the configuration file's published keys alone
(``benchmark/configs/<name>.json``), under the state-dict names the
program's model takes; nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark import weights

ONES, ZEROS = "ones", "zeros"


def groups(cfg: dict) -> List[Tuple[str, List[Tuple[str, tuple, object]]]]:
    """(group, [(state-dict name, shape, std or ONES or ZEROS)]) in draw
    order."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    rank, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    nope, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs, ff = f * cfg["n_shared_experts"], cfg["intermediate_size"]

    def w(name, shape):
        return (name, shape, 1 / math.sqrt(shape[-2]))

    out = [("embed", [("embed", (cfg["vocab_size"], d), 1 / math.sqrt(d))])]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        leaves = [(p + "attn_norm.weight", (d,), ONES),
                  w(p + "attn.wq", (d, h * (nope + rope))),
                  w(p + "attn.wkva", (d, rank + rope)),
                  (p + "attn.kv_norm.weight", (rank,), ONES),
                  w(p + "attn.wkvb", (rank, h * (nope + dv))),
                  w(p + "attn.wo", (h * dv, d)),
                  (p + "mlp_norm.weight", (d,), ONES)]
        if i < cfg["first_k_dense_replace"]:
            leaves += [w(p + "mlp.w_gate", (d, ff)), w(p + "mlp.w_up", (d, ff)),
                       w(p + "mlp.w_down", (ff, d))]
        else:
            leaves += [w(p + "moe.router", (d, e)),
                       (p + "moe.router_bias", (e,), ZEROS),
                       w(p + "moe.w_gate", (e, d, f)),
                       w(p + "moe.w_up", (e, d, f)),
                       w(p + "moe.w_down", (e, f, d)),
                       w(p + "moe.shared.w_gate", (d, fs)),
                       w(p + "moe.shared.w_up", (d, fs)),
                       w(p + "moe.shared.w_down", (fs, d))]
        out.append((f"layers.{i}", leaves))
    out.append(("head", [("final_norm.weight", (d,), ONES),
                         w("lm_head", (d, cfg["vocab_size"]))]))
    return out


def draw_group(cfg: dict, seed: int, index: int, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Group ``index`` of :func:`groups` as tensors on ``device``: the
    projections in ``dtype``, the norm weights and the bias in f32."""
    _, leaves = groups(cfg)[index]
    n = sum(math.prod(s) for _, s, std in leaves if not isinstance(std, str))
    flat = torch.randn(n, generator=weights.generator(
        device, seed, weights.WEIGHTS, index), dtype=torch.float32,
        device=device)
    out, at = {}, 0
    for name, s, std in leaves:
        if std == ONES:
            out[name] = torch.ones(s, dtype=torch.float32, device=device)
        elif std == ZEROS:
            out[name] = torch.zeros(s, dtype=torch.float32, device=device)
        else:
            k = math.prod(s)
            out[name] = flat[at:at + k].view(s).mul(std).to(dtype)
            at += k
    return out


def draw_all(cfg: dict, seed: int, device,
             dtype: torch.dtype) -> Iterator[Dict[str, torch.Tensor]]:
    """Every group in order, one at a time."""
    for index in range(len(groups(cfg))):
        yield draw_group(cfg, seed, index, device, dtype)
