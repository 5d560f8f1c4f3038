"""Weights of a Kimi Linear configuration (KDA and latent-attention layers
over routed experts), made from the run's seed on the device.

The scheme is :mod:`benchmark.weights_mla`'s: every projection normal
with std 1/sqrt(fan_in) (a stacked expert weight's fan-in is its middle
dimension), the embedding std 1/sqrt(hidden_size), the norm weights ones
and the router's correction bias zeros, drawn in f32 from one
``torch.randn`` over a whole group and cast to the served dtype. The KDA
layers add, from the same draw: the short convolution's taps std
1/sqrt(width) (a depthwise kernel's fan-in); ``A_log = log A`` with A
uniform on [1, 16] and ``dt_bias`` the inverse softplus of a dt
log-uniform on [1e-3, 1e-1] (floored at 1e-4), both f32 and both from a
normal draw through its distribution function. The groups are the
embedding, each layer, and the final norm with the head, so the
reference rebuilds one layer at a time from the seed.

An expert layer holds ``num_experts`` experts (this card's share) under
a router of ``router_experts`` outputs. Shapes come from the
configuration file's keys alone (``benchmark/configs/<name>.json``),
under the state-dict names the program's model takes; nothing here
imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from benchmark import weights

ONES, ZEROS, A_LOG, DT_BIAS = "ones", "zeros", "a_log", "dt_bias"
# dt's log-uniform range and floor, and A's uniform range, of the usual
# Mamba-style initialisation that KDA's gate takes.
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 1e-1, 1e-4
A_MIN, A_MAX = 1.0, 16.0


def kda_layers(cfg: dict) -> List[int]:
    """0-based indices of the KDA layers."""
    return sorted(i - 1 for i in cfg["linear_attn_config"]["kda_layers"])


def groups(cfg: dict) -> List[Tuple[str, List[Tuple[str, tuple, object]]]]:
    """(group, [(state-dict name, shape, std or a kind)]) in draw order."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    rank, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    nope, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    r = cfg.get("router_experts", e)
    fs, ff = f * cfg["num_shared_experts"], cfg["intermediate_size"]
    lin = cfg["linear_attn_config"]
    kh, kd, kw = lin["num_heads"], lin["head_dim"], \
        lin["short_conv_kernel_size"]
    c = kh * kd
    kda = set(kda_layers(cfg))

    def w(name, shape):
        return (name, shape, 1 / math.sqrt(shape[-2]))

    out = [("embed", [("embed", (cfg["vocab_size"], d), 1 / math.sqrt(d))])]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        leaves = [(p + "attn_norm.weight", (d,), ONES)]
        if i in kda:
            k = p + "kda."
            leaves += [w(k + "wqkv", (d, 3 * c)),
                       (k + "conv", (3 * c, kw), 1 / math.sqrt(kw)),
                       w(k + "wfa", (d, kd)), w(k + "wfb", (kd, c)),
                       w(k + "wga", (d, kd)), w(k + "wgb", (kd, c)),
                       w(k + "wb", (d, kh)), w(k + "wo", (c, d)),
                       (k + "A_log", (kh,), A_LOG),
                       (k + "dt_bias", (c,), DT_BIAS),
                       (k + "o_norm.weight", (kd,), ONES)]
        else:
            leaves += [w(p + "attn.wq", (d, h * (nope + rope))),
                       w(p + "attn.wkva", (d, rank + rope)),
                       (p + "attn.kv_norm.weight", (rank,), ONES),
                       w(p + "attn.wkvb", (rank, h * (nope + dv))),
                       w(p + "attn.wo", (h * dv, d))]
        leaves.append((p + "mlp_norm.weight", (d,), ONES))
        if i < cfg["first_k_dense_replace"]:
            leaves += [w(p + "mlp.w_gate", (d, ff)), w(p + "mlp.w_up", (d, ff)),
                       w(p + "mlp.w_down", (ff, d))]
        else:
            leaves += [w(p + "moe.router", (d, r)),
                       (p + "moe.router_bias", (r,), ZEROS),
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


def _uniform(z: torch.Tensor) -> torch.Tensor:
    """A standard normal draw through its distribution function: uniform
    on (0, 1)."""
    return 0.5 * (1 + torch.erf(z / math.sqrt(2)))


def draw_group(cfg: dict, seed: int, index: int, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Group ``index`` of :func:`groups` as tensors on ``device``: the
    projections in ``dtype``; the norm weights, the bias, ``A_log`` and
    ``dt_bias`` in f32."""
    _, leaves = groups(cfg)[index]
    n = sum(math.prod(s) for _, s, std in leaves
            if std not in (ONES, ZEROS))
    flat = torch.randn(n, generator=weights.generator(
        device, seed, weights.WEIGHTS, index), dtype=torch.float32,
        device=device)
    out, at = {}, 0
    for name, s, std in leaves:
        if std == ONES:
            out[name] = torch.ones(s, dtype=torch.float32, device=device)
            continue
        if std == ZEROS:
            out[name] = torch.zeros(s, dtype=torch.float32, device=device)
            continue
        k = math.prod(s)
        z = flat[at:at + k].view(s)
        at += k
        if std == A_LOG:
            out[name] = torch.log(A_MIN + (A_MAX - A_MIN) * _uniform(z))
        elif std == DT_BIAS:
            dt = torch.exp(math.log(DT_MIN) + _uniform(z)
                           * (math.log(DT_MAX) - math.log(DT_MIN)))
            dt = dt.clamp(min=DT_FLOOR)
            out[name] = dt + torch.log(-torch.expm1(-dt))
        else:
            out[name] = z.mul(std).to(dtype)
    return out


def draw_all(cfg: dict, seed: int, device,
             dtype: torch.dtype) -> Iterator[Dict[str, torch.Tensor]]:
    """Every group in order, one at a time."""
    for index in range(len(groups(cfg))):
        yield draw_group(cfg, seed, index, device, dtype)
