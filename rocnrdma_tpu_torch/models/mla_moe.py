"""The DeepSeek-V3 block (latent attention and routed experts) for
inference: prefill, latent-cache decode and ``generate``, as served
through :func:`~rocnrdma_tpu_torch.models.llama.generate`.

The JAX package has no such model; the equations are the published
ones (DeepSeek-V3's ``modeling_deepseek.py``, as Moonlight-16B-A3B
configures it), and ``benchmark/reference/mla_moe_ref.py`` is their
plain float32 version that the tests hold this module to.

Layer ℓ on x (B, S, d):

- attention input ``h = RMSNorm(x)``; ``q = h·W_q`` (S, H, nope + rope)
  split into ``q_nope`` and ``q_pe``; ``[c̃, k_pe] = h·W_kva`` and
  ``c = RMSNorm_kv(c̃)`` (the latent, ``kv_lora_rank`` wide);
- ``q_pe`` and ``k_pe`` roped split-half at absolute positions (not
  roped where ``mla_use_nope``, as Kimi Linear sets it), ``k_pe`` one key
  that every head shares;
- ``[k_nope, v] = c·W_kvb`` per head; ``score = (q_nope·k_nope +
  q_pe·k_pe) / sqrt(nope + rope)``, causal softmax, ``o = P·v``,
  ``y = x + o·W_o``;
- the first ``first_dense`` layers add ``SwiGLU_d_ff(RMSNorm(y))``, the
  others the expert layer :class:`MoE` on ``g = RMSNorm(y)``, which routes
  over ``n_routed`` experts and computes the picks of the ``n_experts`` it
  holds from ``first_expert`` on (all of them unless an expert-parallel
  deployment divides them between cards).

Head: a final RMSNorm and the untied head, f32 logits.

Where the kernels run:

- every RMSNorm, the latent's too, goes through K1
  (:func:`~rocnrdma_tpu_torch.ops.rmsnorm.rmsnorm`);
- the no-cache forward and the cached prefill (``pos == 0``) take the
  plain form: ``k_nope`` and ``v`` made from the latent at every
  position, attention by :func:`_causal_attention` (on the card torch's
  ``scaled_dot_product_attention``, pinned to its flash backend, v
  zero-padded to the qk width);
- the decode step (one new position) takes the absorbed form:
  ``W_kvb`` split per head into ``W_UK`` and ``W_UV``, ``q_lat =
  W_UK·q_nope``, and K7 (:func:`~rocnrdma_tpu_torch.ops.mla_decode.
  mla_decode`) reads the latent cache once for every head, up to
  ``pos``; ``o = W_UVᵀ·(Σ_t p_t·c_t)``;
- the experts go through :func:`~rocnrdma_tpu_torch.ops.moe.
  grouped_swiglu` (dropless, the grouped GEMMs on the card).

The cache (:meth:`MlaMoe.init_cache`) holds per layer one tensor
``ckv`` (B, T, kv_lora_rank + rope): the latent ``c`` in its first
``kv_lora_rank`` columns and the roped ``k_pe`` in the rest, in the
model dtype (1,152 bytes a position a layer at Moonlight's widths). With
a cache, ``forward`` returns the last position's logits only (B, 1,
vocab), which is all ``generate`` reads, and the prefill runs the batch
in chunks of rows of at most ``PREFILL_TOKENS`` positions, each chunk
through every layer, so its transient tensors stay bounded.

With a cache ``pos`` is the int 0 (a prompt) or a 0-d int64 tensor on
the model's device with one new position a row (a decode step), as
``generate`` calls :class:`~rocnrdma_tpu_torch.models.llama.Llama`: with
a tensor no shape depends on ``pos``, so the decode step captures as a
CUDA graph. Several new positions after cached ones (an int pos > 0)
raise: no path of the port runs them.
Weights keep the (in, out) layout, applied as ``x @ W``; the experts'
are stacked (n_experts, in, out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import DeviceLike, resolve_device
from ..ops.mla_decode import mla_decode
from ..ops.moe import count_held, grouped_swiglu, route
from ..ops.rmsnorm import rmsnorm
from ..utils.trace import trace
from .llama import apply_rope, rope_freqs, swiglu

__all__ = ["MlaMoeConfig", "MOONLIGHT_16B", "MlaMoe", "init_params",
           "param_shapes", "PREFILL_TOKENS"]

# Positions a chunk of the cached prefill holds at most: the transient
# tensors of a chunk (the dense layer's 3 × 11264-wide activations, the
# experts' picks) stay near 6 GB at Moonlight's widths.
PREFILL_TOKENS = 65536


@dataclasses.dataclass(frozen=True)
class MlaMoeConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    # Width of the dense layers' SwiGLU, of one routed expert's.
    d_ff: int
    moe_d_ff: int
    n_experts: int
    n_shared: int
    top_k: int
    first_dense: int
    routed_scale: float
    max_seq_len: int = 8192
    rope_theta: float = 50000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # No rope on q_pe and k_pe (Kimi Linear's ``mla_use_nope``).
    mla_use_nope: bool = False
    # The experts held here, n_experts from first_expert on, of the
    # router's router_experts (0: the router's width is n_experts).
    first_expert: int = 0
    router_experts: int = 0

    @property
    def n_routed(self) -> int:
        """The router's width: the experts a token picks among."""
        return self.router_experts or self.n_experts

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def cache_width(self) -> int:
        return self.kv_lora_rank + self.qk_rope_dim

    @classmethod
    def from_hf(cls, cfg: dict, **overrides) -> "MlaMoeConfig":
        """The config from a DeepSeek-V3 ``config.json``'s keys. Raises on
        a setting this module does not compute (a compressed q, softmax
        routing, grouped selection, rope scaling, other activations)."""
        want = {"q_lora_rank": None, "scoring_func": "sigmoid",
                "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
                "norm_topk_prob": True, "moe_layer_freq": 1,
                "hidden_act": "silu", "rope_scaling": None,
                "attention_bias": False, "tie_word_embeddings": False}
        for key, value in want.items():
            if cfg.get(key, value) != value:
                raise ValueError(f"{cfg.get('name', 'config')}: {key}="
                                 f"{cfg[key]!r}, only {value!r} is supported")
        if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
            raise ValueError("latent attention gives every head its own "
                             "key and value: num_key_value_heads must "
                             "equal num_attention_heads")
        fields = dict(
            name=cfg.get("name", "deepseek_v3"),
            vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            kv_lora_rank=cfg["kv_lora_rank"],
            qk_nope_dim=cfg["qk_nope_head_dim"],
            qk_rope_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"], d_ff=cfg["intermediate_size"],
            moe_d_ff=cfg["moe_intermediate_size"],
            n_experts=cfg["n_routed_experts"],
            n_shared=cfg["n_shared_experts"],
            top_k=cfg["num_experts_per_tok"],
            first_dense=cfg["first_k_dense_replace"],
            routed_scale=float(cfg["routed_scaling_factor"]),
            max_seq_len=cfg["max_position_embeddings"],
            rope_theta=float(cfg["rope_theta"]),
            norm_eps=float(cfg["rms_norm_eps"]),
            dtype=getattr(torch, cfg.get("torch_dtype", "bfloat16")))
        fields.update(overrides)
        return cls(**fields)

    def param_count(self) -> int:
        return sum(math.prod(s) for s in param_shapes(self).values())


# Moonlight-16B-A3B's published config.json.
MOONLIGHT_16B = MlaMoeConfig(
    name="moonlight-16b-a3b", vocab_size=163840, d_model=2048, n_layers=27,
    n_heads=16, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, d_ff=11264, moe_d_ff=1408, n_experts=64, n_shared=2,
    top_k=6, first_dense=1, routed_scale=2.446, max_seq_len=8192,
    rope_theta=50000.0)


def param_shapes(cfg: MlaMoeConfig) -> Dict[str, tuple]:
    """Every state-dict entry and its shape, in parameter order; the
    norm weights and the router's correction bias are f32, the rest in
    the model dtype."""
    d, h, e = cfg.d_model, cfg.n_heads, cfg.n_experts
    out = {"embed": (cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        out.update({
            p + "attn_norm.weight": (d,),
            p + "attn.wq": (d, h * cfg.qk_head_dim),
            p + "attn.wkva": (d, cfg.cache_width),
            p + "attn.kv_norm.weight": (cfg.kv_lora_rank,),
            p + "attn.wkvb": (cfg.kv_lora_rank,
                              h * (cfg.qk_nope_dim + cfg.v_head_dim)),
            p + "attn.wo": (h * cfg.v_head_dim, d),
            p + "mlp_norm.weight": (d,)})
        if i < cfg.first_dense:
            out.update({p + "mlp.w_gate": (d, cfg.d_ff),
                        p + "mlp.w_up": (d, cfg.d_ff),
                        p + "mlp.w_down": (cfg.d_ff, d)})
        else:
            f, fs = cfg.moe_d_ff, cfg.moe_d_ff * cfg.n_shared
            out.update({p + "moe.router": (d, cfg.n_routed),
                        p + "moe.router_bias": (cfg.n_routed,),
                        p + "moe.w_gate": (e, d, f),
                        p + "moe.w_up": (e, d, f),
                        p + "moe.w_down": (e, f, d),
                        p + "moe.shared.w_gate": (d, fs),
                        p + "moe.shared.w_up": (d, fs),
                        p + "moe.shared.w_down": (fs, d)})
    out.update({"final_norm.weight": (d,), "lm_head": (d, cfg.vocab_size)})
    return out


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _norm(width: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(width, dtype=torch.float32,
                                   device=device))


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """q, k (B, H, S, dqk) and v (B, H, S, dv), query i sees keys 0..i.
    On the card: ``scaled_dot_product_attention`` held to its flash
    backend (it raises rather than fall back to the math backend, whose
    scores at a long prompt would not fit), v zero-padded to dqk, which
    flash asks for. On the CPU: f32 scores, softmax, probabilities cast
    to the model dtype before the value product."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if q.device.type == "cuda":
        from torch.nn.attention import SDPBackend, sdpa_kernel

        v_pad = F.pad(v, (0, dqk - dv))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            o = F.scaled_dot_product_attention(q, k, v_pad, is_causal=True,
                                               scale=scale)
        return o[..., :dv]
    s = q.shape[2]
    sc = (q.float() @ k.float().transpose(-1, -2)) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = sc.masked_fill(mask, float("-inf")).softmax(-1).to(q.dtype)
    return (p.float() @ v.float()).to(q.dtype)


class MlaAttention(nn.Module):
    def __init__(self, cfg: MlaMoeConfig, device) -> None:
        super().__init__()
        self.cfg = cfg
        shapes = param_shapes(cfg)
        dt = cfg.dtype
        for name in ("wq", "wkva", "wkvb", "wo"):
            setattr(self, name, _weight(shapes[f"layers.0.attn.{name}"], dt,
                                        device))
        self.kv_norm = nn.Module()
        self.kv_norm.weight = _norm(cfg.kv_lora_rank, device)

    def _project(self, h: torch.Tensor, freqs: Optional[torch.Tensor]):
        """(B, S, d) normed input → q_nope (B, H, S, nope), roped q_pe
        (B, H, S, rope), the latent c (B, S, rank) and the roped k_pe
        (B, S, rope); ``freqs`` at h's positions, None where
        ``mla_use_nope`` (q_pe and k_pe as projected)."""
        cfg = self.cfg
        b, s, _ = h.shape
        q = (h @ self.wq).view(b, s, cfg.n_heads, cfg.qk_head_dim)
        q = q.transpose(1, 2)
        q_nope, q_pe = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
        c, k_pe = (h @ self.wkva).split([cfg.kv_lora_rank, cfg.qk_rope_dim],
                                        dim=-1)
        c = rmsnorm(c, self.kv_norm.weight, cfg.norm_eps)
        if cfg.mla_use_nope:
            return q_nope, q_pe, c, k_pe
        return (q_nope, apply_rope(q_pe, freqs), c,
                apply_rope(k_pe[:, None], freqs)[:, 0])

    def _plain(self, q_nope, q_pe, c, k_pe) -> torch.Tensor:
        """The non-absorbed form over positions 0..S-1, causal: keys and
        values made from the latent at every position. Returns (B, S,
        H · v)."""
        cfg = self.cfg
        b, t, _ = c.shape
        kv = (c @ self.wkvb).view(b, t, cfg.n_heads, -1).transpose(1, 2)
        k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe[:, None].expand(-1, cfg.n_heads, -1, -1)],
                      dim=-1)
        o = _causal_attention(q, k, v, 1.0 / math.sqrt(cfg.qk_head_dim))
        return o.transpose(1, 2).reshape(b, t, -1)

    def _absorbed(self, q_nope, q_pe, ckv, q_pos) -> torch.Tensor:
        """The absorbed form for one new position a row (s = 1) against
        the latent cache ``ckv`` (B, T, rank + rope) up to ``q_pos``.
        Returns (B, 1, H · v)."""
        cfg = self.cfg
        b, h = q_nope.shape[0], cfg.n_heads
        w = self.wkvb.view(cfg.kv_lora_rank, h, -1)
        w_uk, w_uv = w.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
        # q_lat[b, h] = W_UK[:, h] · q_nope[b, h], as a product per head.
        q_lat = torch.bmm(q_nope[:, :, 0].transpose(0, 1),
                          w_uk.permute(1, 2, 0)).transpose(0, 1)
        q = torch.cat([q_lat, q_pe[:, :, 0]], dim=-1)
        o_lat = mla_decode(q, ckv, q_pos, 1.0 / math.sqrt(cfg.qk_head_dim),
                           cfg.kv_lora_rank)
        o = torch.bmm(o_lat.transpose(0, 1), w_uv.transpose(0, 1))
        return o.transpose(0, 1).reshape(b, 1, h * cfg.v_head_dim)

    def forward(self, h: torch.Tensor, freqs: Optional[torch.Tensor],
                cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """(B, S, d) normed input → the attention's contribution (B, S,
        d), writing the latent and k_pe into ``cache`` in place; ``freqs``
        None where ``mla_use_nope``."""
        s = h.shape[1]
        nope = self.cfg.mla_use_nope
        if cache is None:
            q_nope, q_pe, c, k_pe = self._project(
                h, None if nope else freqs[:s])
            return self._plain(q_nope, q_pe, c, k_pe) @ self.wo
        dev = h.device
        if isinstance(pos, torch.Tensor):
            if s != 1:
                raise ValueError("a tensor pos takes one new position a "
                                 f"row, got {s}")
            q_pos = pos + torch.arange(s, device=dev)
        elif pos == 0:
            q_pos = torch.arange(s, device=dev)
        else:
            raise ValueError("with a cache the model runs a prompt from "
                             "position 0 or one new position at a tensor "
                             f"pos, got {s} at int pos {pos}")
        q_nope, q_pe, c, k_pe = self._project(
            h, None if nope else freqs.index_select(0, q_pos))
        ckv = cache["ckv"]
        ckv.index_copy_(1, q_pos, torch.cat([c, k_pe], dim=-1).to(ckv.dtype))
        if isinstance(pos, torch.Tensor):
            return self._absorbed(q_nope, q_pe, ckv, q_pos) @ self.wo
        return self._plain(q_nope, q_pe, c, k_pe) @ self.wo


class MLP(nn.Module):
    def __init__(self, cfg: MlaMoeConfig, width: int, device) -> None:
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.w_gate = _weight((d, width), dt, device)
        self.w_up = _weight((d, width), dt, device)
        self.w_down = _weight((width, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


class MoE(nn.Module):
    """The expert layer on g (B, S, d): sigmoid scores over the router's
    ``n_routed`` experts in f32, the ``top_k`` of score + correction bias
    picked, their scores normalised to sum 1 and scaled by
    ``routed_scale``; the picked experts' SwiGLUs weighed by them, summed
    in f32, plus the shared experts' SwiGLU (one of width ``moe_d_ff ·
    n_shared``). Every pick of an expert held here is computed: no token
    is dropped. Where the layer holds part of the experts (``n_experts``
    from ``first_expert`` on, an expert-parallel card's share), a pick of
    another card's expert is computed nowhere here and adds nothing: the
    result is this card's share of the layer, the shared experts
    included."""

    def __init__(self, cfg: MlaMoeConfig, device) -> None:
        super().__init__()
        self.cfg = cfg
        d, e, f, dt = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.dtype
        self.router = _weight((d, cfg.n_routed), dt, device)
        self.register_buffer("router_bias", torch.zeros(
            cfg.n_routed, dtype=torch.float32, device=device))
        self.w_gate = _weight((e, d, f), dt, device)
        self.w_up = _weight((e, d, f), dt, device)
        self.w_down = _weight((e, f, d), dt, device)
        self.shared = MLP(cfg, f * cfg.n_shared, device)

    def forward(self, g: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with trace.span("moe.experts", g.device, rows=g.numel() // g.shape[-1]):
            x = g.reshape(-1, cfg.d_model)
            ids, wts = route(x, self.router, self.router_bias, cfg.top_k,
                             cfg.routed_scale)
            if cfg.n_experts != cfg.n_routed:
                ids = ids - cfg.first_expert
                ids = ids.masked_fill((ids < 0) | (ids >= cfg.n_experts), -1)
                count_held(ids, cfg.n_experts)
            return grouped_swiglu(x, ids, wts, self.w_gate, self.w_up,
                                  self.w_down, add=self.shared(x)
                                  ).view(g.shape)


class Block(nn.Module):
    def __init__(self, cfg: MlaMoeConfig, index: int, device) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.attn_norm = nn.Module()
        self.attn_norm.weight = _norm(cfg.d_model, device)
        self.attn = MlaAttention(cfg, device)
        self.mlp_norm = nn.Module()
        self.mlp_norm.weight = _norm(cfg.d_model, device)
        if index < cfg.first_dense:
            self.mlp = MLP(cfg, cfg.d_ff, device)
        else:
            self.moe = MoE(cfg, device)

    def forward(self, x, freqs, cache=None, pos=0):
        y = x + self.attn(rmsnorm(x, self.attn_norm.weight, self.eps), freqs,
                          cache, pos)
        g = rmsnorm(y, self.mlp_norm.weight, self.eps)
        return y + (self.mlp(g) if hasattr(self, "mlp") else self.moe(g))


class MlaMoe(nn.Module):
    """The model. Parameters are allocated uninitialised on ``device``
    (default: the card); fill them with ``load_state_dict`` from
    :func:`init_params` or the benchmark's weights. A model of other
    layers over the same embedding, head and forward gives its own
    ``block`` class."""

    block = Block

    def __init__(self, cfg: MlaMoeConfig,
                 device: DeviceLike = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.d_model), cfg.dtype, dev)
        self.layers = nn.ModuleList(self.block(cfg, i, dev)
                                    for i in range(cfg.n_layers))
        self.final_norm = nn.Module()
        self.final_norm.weight = _norm(cfg.d_model, dev)
        self.lm_head = _weight((cfg.d_model, cfg.vocab_size), cfg.dtype, dev)
        self.register_buffer(
            "freqs", None if cfg.mla_use_nope else rope_freqs(
                cfg.qk_rope_dim, cfg.max_seq_len, cfg.rope_theta, dev),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
        """Zeroed per-layer latent cache ``{"ckv": (B, max_seq, rank +
        rope)}`` in the model dtype, on the model's device by default."""
        dev = self.device if device is None else resolve_device(device)
        shape = (batch, max_seq or self.cfg.max_seq_len, self.cfg.cache_width)
        return [{"ckv": torch.zeros(shape, dtype=self.cfg.dtype, device=dev)}
                for _ in range(self.cfg.n_layers)]

    def cache_nbytes(self, batch: int, max_seq: int) -> int:
        cfg = self.cfg
        return (cfg.n_layers * batch * max_seq * cfg.cache_width
                * cfg.dtype.itemsize)

    def _layers(self, x, cache, pos):
        for i, layer in enumerate(self.layers):
            x = layer(x, self.freqs, None if cache is None else cache[i], pos)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        w = self.final_norm.weight
        return (rmsnorm(x, w, self.cfg.norm_eps) @ self.lm_head).float()

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[Dict[str, torch.Tensor]]] = None,
                pos: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """tokens (B, S) → f32 logits: (B, S, vocab) without a cache;
        with one (from :meth:`init_cache`), at absolute position ``pos``,
        the latent written into it in place, (B, 1, vocab) at the last
        position."""
        cfg = self.cfg
        b, s = tokens.shape
        if s > cfg.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds {cfg.name}'s "
                             f"max_seq_len={cfg.max_seq_len}")
        if cache is None:
            return self._head(self._layers(F.embedding(tokens, self.embed),
                                           None, 0))
        rows = b if isinstance(pos, torch.Tensor) else \
            max(1, PREFILL_TOKENS // s)
        out = []
        for r0 in range(0, b, rows):
            part = [{k: t[r0:r0 + rows] for k, t in c.items()} for c in cache]
            x = self._layers(F.embedding(tokens[r0:r0 + rows], self.embed),
                             part, pos)
            out.append(self._head(x[:, -1:]))
        return out[0] if len(out) == 1 else torch.cat(out)


def init_params(cfg: MlaMoeConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Random parameters as a state dict on ``device``, by the port's
    scheme (:func:`~rocnrdma_tpu_torch.models.llama.init_params`): every
    projection normal with std 1/sqrt(fan_in), a stacked expert weight's
    fan-in its middle dimension, the embedding std 1/sqrt(d_model), the
    norm weights ones and the correction bias zeros, both f32."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("norm.weight"):
            out[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        elif name.endswith("router_bias"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            fan_in = cfg.d_model if name == "embed" else shape[-2]
            out[name] = (torch.randn(shape, generator=gen, device=dev)
                         / math.sqrt(fan_in)).to(cfg.dtype)
    return out
