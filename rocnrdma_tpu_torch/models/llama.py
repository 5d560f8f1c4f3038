"""Llama in PyTorch: prefill, KV-cache decode, generate, and the loss
and block remat of training.

Counterpart of ``rocnrdma_tpu/models/llama.py``; the train step lives
in :mod:`rocnrdma_tpu_torch.parallel.trainer`. The math mirrors the flax
modules: split-half RoPE computed in f32 and cast back, GQA, SwiGLU,
RMSNorm with an f32 weight, bf16 parameters and activations by default
and f32 logits. Parameters are trainable; serving runs under
``torch.inference_mode()``.

Where the kernels run:

- every RMSNorm (two per block and the final one) goes through
  :func:`~rocnrdma_tpu_torch.ops.rmsnorm.rmsnorm`, the K1 kernel
  forward and the K2 kernel backward;
- the no-cache forward and the cached prefill (``pos == 0``) go through
  :func:`~rocnrdma_tpu_torch.ops.attention.attention`, the K3 kernel
  forward and the K5 then K4 kernels backward — the cached prefill at
  position 0 is the same function as the full causal forward, which the
  JAX package's tests pin;
- with ``LlamaConfig.remat``, the no-cache forward recomputes each block
  in the backward (``torch.utils.checkpoint``, non-reentrant), the
  counterpart of flax's ``nn.remat(Block)`` with the "full" policy: K1
  and K3 then run a second time per block;
- cached decode (``pos > 0``) keeps the plain grouped-query product
  against the cache, as the JAX package computes it outside any kernel:
  f32 scores, softmax, probs cast to the model dtype before the value
  product.

Weight layout: every projection keeps flax's ``Dense`` layout
``(in, out)`` and is applied as ``x @ W`` — no transpose anywhere, so
:func:`params_from_flax` and the serving pages share one layout. The KV
cache is updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import DeviceLike, resolve_device
from ..ops.attention import attention
from ..ops.rmsnorm import rmsnorm

__all__ = [
    "LlamaConfig", "LLAMA3_8B", "LLAMA3_1B", "LLAMA_TINY", "CONFIGS",
    "rope_freqs", "apply_rope", "RMSNorm", "Attention", "MLP", "Block",
    "Llama", "init_cache", "init_params", "generate", "params_from_flax",
    "params_to_flax", "cross_entropy_loss",
]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Recompute each block in the backward instead of keeping its
    # activations (no-cache forward only; decode has no backward). The
    # JAX package's "full" remat policy; its "dots" policy is not ported.
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        emb = self.vocab_size * self.d_model
        attn = self.d_model * self.head_dim * (
            self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * self.head_dim * self.d_model
        mlp = 3 * self.d_model * self.d_ff
        per_layer = attn + mlp + 2 * self.d_model
        return 2 * emb + self.n_layers * per_layer + self.d_model


# Same geometries as the JAX package's configs.
LLAMA3_8B = LlamaConfig(
    name="llama3-8b", vocab_size=128256, d_model=4096, n_layers=32,
    n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=500000.0)
LLAMA3_1B = LlamaConfig(
    name="llama3-1b", vocab_size=32768, d_model=2048, n_layers=16,
    n_heads=16, n_kv_heads=8, d_ff=5632)
LLAMA_TINY = LlamaConfig(
    name="llama-tiny", vocab_size=256, d_model=64, n_layers=2,
    n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=128,
    dtype=torch.float32)

CONFIGS = {c.name: c for c in (LLAMA3_8B, LLAMA3_1B, LLAMA_TINY)}


def rope_freqs(head_dim: int, max_seq: int, theta: float,
               device: DeviceLike = "cpu") -> torch.Tensor:
    """(max_seq, head_dim/2) rotation angles in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); freqs: (S, D/2). Split-half rotation in f32,
    cast back to x's dtype."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.weight = nn.Parameter(
            torch.ones(cfg.d_model, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.dtype
        self.wq = _weight((d, cfg.n_heads * hd), dt, device)
        self.wk = _weight((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = _weight((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = _weight((cfg.n_heads * hd, d), dt, device)

    def qkv(self, x: torch.Tensor, freqs: torch.Tensor):
        """(B, S, D) normed input → roped q (B, H, S, hd) and k, v
        (B, KVH, S, hd); ``freqs`` already sliced to x's positions."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = (x @ self.wq).view(b, s, cfg.n_heads, hd).transpose(1, 2)
        k = (x @ self.wk).view(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        v = (x @ self.wv).view(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        return apply_rope(q, freqs), apply_rope(k, freqs), v

    def out_proj(self, o: torch.Tensor) -> torch.Tensor:
        b, _, s, _ = o.shape
        return o.transpose(1, 2).reshape(b, s, -1) @ self.wo

    def forward(self, x: torch.Tensor, freqs: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: int = 0) -> torch.Tensor:
        s = x.shape[1]
        if cache is None:
            q, k, v = self.qkv(x, freqs[:s])
            return self.out_proj(attention(q, k, v, causal=True))
        q, k, v = self.qkv(x, freqs[pos:pos + s])
        cache["k"][:, :, pos:pos + s] = k.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + s] = v.to(cache["v"].dtype)
        if pos == 0:
            o = attention(q, k, v, causal=True)
        else:
            o = cached_attention(q, cache["k"][:, :, :pos + s],
                                 cache["v"][:, :, :pos + s], pos)
        return self.out_proj(o)


def cached_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, pos: int) -> torch.Tensor:
    """Plain grouped-query attention of q (B, H, s, hd) at absolute
    position ``pos`` against the cache prefix k_all/v_all
    (B, KVH, pos + s, hd). Keys past the prefix are exactly the masked
    (zero-weight) keys of the JAX package's full-cache product, so
    cutting them changes nothing."""
    b, h, s, hd = q.shape
    kvh, t = k_all.shape[1], k_all.shape[2]
    # The group is folded into the query rows (b, kvh, rep * s, hd), so
    # the cache is never repeated per query head.
    qg = q.float().reshape(b, kvh, (h // kvh) * s, hd)
    scores = (qg @ k_all.float().transpose(-1, -2)) / math.sqrt(hd)
    if s > 1:
        q_pos = pos + torch.arange(s, device=q.device).repeat(h // kvh)
        visible = torch.arange(t, device=q.device)[None, :] <= q_pos[:, None]
        scores = scores.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = probs.float() @ v_all.float()
    return o.to(q.dtype).reshape(b, h, s, hd)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
        self.w_gate = _weight((d, f), dt, device)
        self.w_up = _weight((d, f), dt, device)
        self.w_down = _weight((f, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, freqs, cache=None, pos: int = 0):
        x = x + self.attn(self.attn_norm(x), freqs, cache, pos)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """The model. Parameters are allocated uninitialised on ``device``
    (default: the card); fill them with ``load_state_dict`` from
    :func:`init_params` or :func:`params_from_flax`."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = "cuda") -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.d_model), cfg.dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, dev)
        self.lm_head = _weight((cfg.d_model, cfg.vocab_size), cfg.dtype, dev)
        self.register_buffer(
            "freqs", rope_freqs(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, dev), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[Dict[str, torch.Tensor]]] = None,
                pos: int = 0) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, vocab) f32. With ``cache``
        (from :func:`init_cache`), runs incrementally at absolute
        position ``pos`` and writes K/V into the cache in place."""
        cfg = self.cfg
        if tokens.shape[-1] > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds "
                f"{cfg.name}'s max_seq_len={cfg.max_seq_len}")
        x = F.embedding(tokens, self.embed)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, self.freqs, use_reentrant=False)
            else:
                x = layer(x, self.freqs, None if cache is None else cache[i],
                          pos)
        return (self.final_norm(x) @ self.lm_head).float()


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` (B, S) under f32
    ``logits`` (B, S, vocab)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def init_cache(cfg: LlamaConfig, batch: int, max_seq: Optional[int] = None,
               device: DeviceLike = "cuda") -> List[Dict[str, torch.Tensor]]:
    """Zeroed per-layer K/V of shape (B, KVH, max_seq, hd) in the model
    dtype."""
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_seq or cfg.max_seq_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def init_params(cfg: LlamaConfig, seed: int = 0,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Random parameters as a state dict on ``device``, drawn from a
    ``torch.Generator`` seeded with ``seed``, at flax's init scales:
    projections normal with std 1/sqrt(fan_in) (lecun), the embedding
    std 1/sqrt(d_model), norm weights ones in f32. The scales keep bf16
    activations in range at 8B width. (The draws differ from the JAX
    package's; use :func:`params_from_flax` to share weights.)"""
    dev = resolve_device(device)
    model = Llama(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.weight"):
                continue                      # ones, from RMSNorm
            std = 1.0 / math.sqrt(cfg.d_model if name == "embed"
                                  else p.shape[0])
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32,
                                device=dev).mul_(std))
    return model.state_dict()


def generate(model: Llama, prompt, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Autoregressive generation with an incremental KV cache.

    prompt: (B, P) token ids. Returns (B, max_new_tokens) int64 on
    ``device``, which must be where ``model`` lives. Greedy at
    temperature 0, else categorical sampling with ``generator``. The
    cache is sized like the JAX package's: the smallest multiple of 128
    covering prompt + new tokens."""
    dev = resolve_device(device)
    mdev = model.device
    if mdev.type != dev.type or (dev.index is not None
                                 and mdev.index != dev.index):
        raise ValueError(f"generate(device={dev}) but the model lives on "
                         f"{mdev}")
    cfg = model.cfg
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=mdev)
    b, p = prompt.shape
    total = p + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt+new = {total} exceeds "
                         f"max_seq_len={cfg.max_seq_len}")
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.long, device=mdev)

    def pick(logits_last: torch.Tensor) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits_last, dim=-1)
        probs = torch.softmax(logits_last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    with torch.inference_mode():
        cache_len = min(cfg.max_seq_len, ((total + 127) // 128) * 128)
        cache = init_cache(cfg, b, cache_len, mdev)
        tok = pick(model(prompt, cache, 0)[:, -1])
        out = [tok]
        for i in range(1, max_new_tokens):
            tok = pick(model(tok[:, None], cache, p + i - 1)[:, -1])
            out.append(tok)
        return torch.stack(out, dim=1)


# ------------------------------------------------------------ weight bridge

def _flax_path(name: str):
    """State-dict name → key path in the flax ``init_params`` tree."""
    if name == "embed":
        return ("embed", "embedding")
    if name == "lm_head":
        return ("lm_head", "kernel")
    if name == "final_norm.weight":
        return ("final_norm", "weight")
    _, i, rest = name.split(".", 2)
    sub, leaf = rest.split(".")
    layer = f"layer_{i}"
    if leaf == "weight":                      # attn_norm / mlp_norm
        return (layer, sub, "weight")
    return (layer, sub, leaf, "kernel")       # attn.wq ... mlp.w_down


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                           # owned, writable copy
    if a.dtype.name == "bfloat16":            # ml_dtypes bf16 leaves
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_params`` tree (``{"params": {...}}``
    with numpy leaves) → this port's state dict, on the CPU and in the
    leaves' dtypes. Kernels stay (in, out): no transpose."""
    p = tree["params"] if "params" in tree else tree
    n_layers = sum(1 for k in p if k.startswith("layer_"))
    names = ["embed", "final_norm.weight", "lm_head"]
    for i in range(n_layers):
        names += [f"layers.{i}.{n}" for n in (
            "attn_norm.weight", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
            "mlp_norm.weight", "mlp.w_gate", "mlp.w_up", "mlp.w_down")]
    out = {}
    for name in names:
        node = p
        for key in _flax_path(name):
            node = node[key]
        out[name] = _to_tensor(node)
    return out


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: a state dict → the flax
    tree with float32 numpy leaves (bf16 widens losslessly) — the tree
    the serving pager's ``pack_llama_params`` takes."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        path = _flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().float().cpu().numpy()
    return {"params": tree}
