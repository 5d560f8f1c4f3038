"""Kimi Linear's hybrid block for inference: Kimi Delta Attention (KDA)
layers beside latent-attention (MLA) layers, over routed experts, served
through :func:`~rocnrdma_tpu_torch.models.llama.generate`.

The JAX package has no such model; the equations are the Kimi Linear
paper's (arXiv:2510.26692) as Kimi-Linear-48B-A3B's ``config.json``
configures it, and ``benchmark/reference/kimi_linear_ref.py`` is their
plain float32 version that the tests hold this module to.

Layer ℓ on x (B, S, d), its kind from ``linear_attn_config``:

- a KDA layer: ``y = x + KDA(RMSNorm(x))``
  (:class:`~rocnrdma_tpu_torch.ops.kda.KdaMixer`: a recurrent state per
  head, K9 on the card);
- an MLA layer: ``y = x + MLA(RMSNorm(x))``, :class:`~rocnrdma_tpu_torch.
  models.mla_moe.MlaAttention` with no rope where ``mla_use_nope``;
- then, as in :mod:`~rocnrdma_tpu_torch.models.mla_moe`, the first
  ``first_k_dense_replace`` layers add a dense SwiGLU, the others the
  expert layer :class:`~rocnrdma_tpu_torch.models.mla_moe.MoE` (sigmoid
  routing with a correction bias, renormalised and scaled, one shared
  expert). The expert layer may hold part of the experts: the router
  keeps its published width and the layer computes the picks that land in
  the experts it holds, an expert-parallel card's share.

Head: a final RMSNorm and the untied head, f32 logits.

The cache (:meth:`KimiLinear.init_cache`) mixes two kinds of state, one
dict a layer: ``{"ckv": (B, T, rank + rope)}`` in the model dtype for an
MLA layer (rows per position), and ``{"state": (B, H, D, D)}`` f32 with
``{"conv": (B, K - 1, 3·H·D)}`` in the model dtype for a KDA layer (a
fixed size per sequence, whatever its length). ``DecodeLoop`` zeroes them
all at each prompt, the chunked prefill slices them by rows, and the
graphed decode step updates them all in place. The forward, its chunking
and its ``pos`` are :class:`~rocnrdma_tpu_torch.models.mla_moe.MlaMoe`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .. import DeviceLike, resolve_device
from ..ops.kda import KdaMixer
from ..ops.rmsnorm import rmsnorm
from .mla_moe import MLP, MlaAttention, MlaMoe, MlaMoeConfig, MoE, _norm

__all__ = ["KimiLinearConfig", "KimiLinear"]


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig(MlaMoeConfig):
    # 0-based indices of the KDA layers; the others are MLA layers.
    kda_layers: Tuple[int, ...] = ()
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4

    @classmethod
    def from_hf(cls, cfg: dict, **overrides) -> "KimiLinearConfig":
        """The config from a Kimi Linear ``config.json``'s keys (1-based
        layer lists in ``linear_attn_config``). ``num_experts`` is the
        experts this card holds, from ``first_expert`` (default 0) on, of
        ``router_experts`` (default: all of them) that the router scores.
        Raises on a setting this module does not compute."""
        want = {"q_lora_rank": None, "moe_router_activation_func": "sigmoid",
                "num_expert_group": 1, "topk_group": 1,
                "moe_renormalize": True, "moe_layer_freq": 1,
                "hidden_act": "silu", "rope_scaling": None,
                "tie_word_embeddings": False, "num_nextn_predict_layers": 0}
        for key, value in want.items():
            if cfg.get(key, value) != value:
                raise ValueError(f"{cfg.get('name', 'config')}: {key}="
                                 f"{cfg[key]!r}, only {value!r} is supported")
        if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
            raise ValueError("latent attention gives every head its own "
                             "key and value: num_key_value_heads must "
                             "equal num_attention_heads")
        lin = cfg["linear_attn_config"]
        n = cfg["num_hidden_layers"]
        kda = sorted(i - 1 for i in lin["kda_layers"])
        full = sorted(i - 1 for i in lin["full_attn_layers"])
        if sorted(kda + full) != list(range(n)):
            raise ValueError("linear_attn_config's kda_layers and "
                             "full_attn_layers must name every layer once")
        fields = dict(
            name=cfg.get("name", "kimi_linear"),
            vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
            n_layers=n, n_heads=cfg["num_attention_heads"],
            kv_lora_rank=cfg["kv_lora_rank"],
            qk_nope_dim=cfg["qk_nope_head_dim"],
            qk_rope_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"], d_ff=cfg["intermediate_size"],
            moe_d_ff=cfg["moe_intermediate_size"],
            n_experts=cfg["num_experts"],
            n_shared=cfg["num_shared_experts"],
            top_k=cfg["num_experts_per_token"],
            first_dense=cfg["first_k_dense_replace"],
            routed_scale=float(cfg["routed_scaling_factor"]),
            max_seq_len=cfg.get("max_position_embeddings",
                                cfg.get("model_max_length")),
            rope_theta=float(cfg["rope_theta"]),
            norm_eps=float(cfg["rms_norm_eps"]),
            dtype=getattr(torch, cfg.get("torch_dtype", "bfloat16")),
            mla_use_nope=bool(cfg["mla_use_nope"]),
            first_expert=cfg.get("first_expert", 0),
            router_experts=cfg.get("router_experts", cfg["num_experts"]),
            kda_layers=tuple(kda), kda_heads=lin["num_heads"],
            kda_head_dim=lin["head_dim"],
            conv_size=lin["short_conv_kernel_size"])
        fields.update(overrides)
        if fields["first_expert"] + fields["n_experts"] > \
                fields["router_experts"]:
            raise ValueError("the experts held lie past the router's width")
        return cls(**fields)


class Block(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, index: int, device) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.attn_norm = nn.Module()
        self.attn_norm.weight = _norm(cfg.d_model, device)
        if index in cfg.kda_layers:
            self.kda = KdaMixer(cfg.d_model, cfg.kda_heads, cfg.kda_head_dim,
                                cfg.conv_size, cfg.norm_eps, cfg.dtype,
                                device)
        else:
            self.attn = MlaAttention(cfg, device)
        self.mlp_norm = nn.Module()
        self.mlp_norm.weight = _norm(cfg.d_model, device)
        if index < cfg.first_dense:
            self.mlp = MLP(cfg, cfg.d_ff, device)
        else:
            self.moe = MoE(cfg, device)

    def forward(self, x, freqs, cache=None, pos=0):
        h = rmsnorm(x, self.attn_norm.weight, self.eps)
        y = x + (self.kda(h, cache) if hasattr(self, "kda")
                 else self.attn(h, freqs, cache, pos))
        g = rmsnorm(y, self.mlp_norm.weight, self.eps)
        return y + (self.mlp(g) if hasattr(self, "mlp") else self.moe(g))


class KimiLinear(MlaMoe):
    """The model: :class:`MlaMoe`'s embedding, head and forward over this
    module's blocks. Parameters are allocated uninitialised on ``device``
    (default: the card); fill them with ``load_state_dict`` from the
    benchmark's weights. State-dict names are :class:`MlaMoe`'s, with a
    KDA layer's mixer under ``layers.<i>.kda.``."""

    block = Block

    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
        """Zeroed per-layer cache: ``{"ckv"}`` (B, max_seq, rank + rope)
        for an MLA layer, ``{"state", "conv"}`` for a KDA layer, on the
        model's device by default."""
        dev = self.device if device is None else resolve_device(device)
        cfg = self.cfg
        t = max_seq or cfg.max_seq_len
        return [layer.kda.init_cache(batch, dev) if hasattr(layer, "kda")
                else {"ckv": torch.zeros((batch, t, cfg.cache_width),
                                         dtype=cfg.dtype, device=dev)}
                for layer in self.layers]

    def cache_nbytes(self, batch: int, max_seq: int) -> int:
        cfg = self.cfg
        c, elt = cfg.kda_heads * cfg.kda_head_dim, cfg.dtype.itemsize
        kda = batch * (4 * c * cfg.kda_head_dim
                       + (cfg.conv_size - 1) * 3 * c * elt)
        mla = batch * max_seq * cfg.cache_width * elt
        return (len(cfg.kda_layers) * kda
                + (cfg.n_layers - len(cfg.kda_layers)) * mla)
