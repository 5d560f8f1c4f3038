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
  counterpart of flax's ``nn.remat(Block)``: K1 and K3 then run a
  second time per block. ``remat_policy`` "full" recomputes everything;
  "dots" (:func:`checkpoint_block`) keeps the outputs of the block's
  projections and recomputes the rest, K1 and K3 included;
- cached decode (``pos > 0``) goes through
  :func:`~rocnrdma_tpu_torch.ops.decode_attention.cached_attention`, the
  K6 kernel, which reads the cache in place up to the last query's
  position with f32 sums (the JAX package's two einsums with
  ``preferred_element_type=f32``): f32 scores, softmax, probs cast to
  the model dtype before the value product.

``pos`` is a Python int or a 0-d int64 tensor on the model's device
(the JAX package's traced ``pos``). Either way the RoPE angles come by
``index_select`` and K/V are written by ``index_copy_`` at ``pos +
arange(s)``, and the product runs under the mask ``arange(T) <= q_pos``
(:func:`cached_attention`); an int position 0 goes through K3 instead,
and an int ``pos`` cuts the keys to the prefix. With a tensor the
product takes the whole cache, so no shape depends on ``pos``:
``generate`` captures one decode step as a CUDA graph and replays it
(:class:`DecodeLoop`), and K6 reads ``pos`` on the device at each replay
and stops at the live prefix.

Weight layout: every projection keeps flax's ``Dense`` layout
``(in, out)`` and is applied as ``x @ W`` — no transpose anywhere, so
:func:`params_from_flax` and the serving pages share one layout. The KV
cache is updated in place.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import weakref
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import DeviceLike, resolve_device
from ..ops.attention import attention
from ..ops.decode_attention import cached_attention
from ..ops.rmsnorm import rmsnorm
from ..utils.graphs import CapturedStep
from ..utils.trace import trace

__all__ = [
    "LlamaConfig", "LLAMA3_8B", "LLAMA3_1B", "LLAMA_TINY", "CONFIGS",
    "rope_freqs", "apply_rope", "project_qkv", "out_proj", "swiglu",
    "checkpoint_block",
    "RMSNorm", "Attention", "MLP", "Block",
    "Llama", "init_cache", "init_params", "generate", "DecodeLoop",
    "param_names",
    "flax_tree", "params_from_flax", "params_to_flax", "cross_entropy_loss",
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
    # activations (no-cache forward only; decode has no backward).
    remat: bool = False
    # The JAX package's remat policies: "full" recomputes everything;
    # "dots" keeps the outputs of the projections (the matmuls with no
    # batch dimension) and recomputes the rest (checkpoint_block).
    remat_policy: str = "full"

    def __post_init__(self) -> None:
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy={self.remat_policy!r}: must be "
                             "'full' or 'dots'")

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


def project_qkv(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                wv: torch.Tensor, head_dim: int, freqs: torch.Tensor):
    """(B, S, D) normed input → roped q (B, H, S, hd) and k, v
    (B, KVH, S, hd), the head counts read off the weights' widths (a
    tensor-parallel shard holds fewer heads)."""
    b, s, _ = x.shape

    def heads(w):
        return (x @ w).view(b, s, -1, head_dim).transpose(1, 2)

    return apply_rope(heads(wq), freqs), apply_rope(heads(wk), freqs), \
        heads(wv)


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) attention output → (B, S, D) through ``wo``."""
    b, _, s, _ = o.shape
    return o.transpose(1, 2).reshape(b, s, -1) @ wo


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """The MLP: (silu(x·W_gate) ∘ x·W_up)·W_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _dots_policy(_ctx, op, *_args, **_kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` in
    torch's selective checkpoint: keep a product with no batch dimension
    (``h @ w`` of a 3-D ``h`` and a weight reaches ``aten.mm``),
    recompute everything else (the plain attention's ``aten.bmm``, the
    kernels, the elementwise work)."""
    if op.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_block(fn, *args, policy: str):
    """``fn(*args)`` recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``) under the remat ``policy``: "full"
    keeps nothing of ``fn``'s inside, "dots" keeps its projections'
    outputs."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             **kw)


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
        return project_qkv(x, self.wq, self.wk, self.wv, self.cfg.head_dim,
                           freqs)

    def out_proj(self, o: torch.Tensor) -> torch.Tensor:
        return out_proj(o, self.wo)

    def attend(self, x: torch.Tensor, freqs: torch.Tensor,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """(B, S, D) normed input → the attention output (B, H, S, hd)
        before ``out_proj``; with ``cache``, at absolute position
        ``pos`` (an int, or a 0-d int64 tensor on x's device), writing
        K/V into the cache in place."""
        s = x.shape[1]
        if cache is None:
            q, k, v = self.qkv(x, freqs[:s])
            return attention(q, k, v, causal=True)
        dev = x.device
        if isinstance(pos, torch.Tensor):
            q_pos, t = pos + torch.arange(s, device=dev), cache["k"].shape[2]
        else:
            q_pos, t = torch.arange(pos, pos + s, device=dev), pos + s
        q, k, v = self.qkv(x, freqs.index_select(0, q_pos))
        cache["k"].index_copy_(2, q_pos, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, q_pos, v.to(cache["v"].dtype))
        if not isinstance(pos, torch.Tensor) and pos == 0:
            return attention(q, k, v, causal=True)
        return cached_attention(q, cache["k"][:, :, :t], cache["v"][:, :, :t],
                                q_pos)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
        self.w_gate = _weight((d, f), dt, device)
        self.w_up = _weight((d, f), dt, device)
        self.w_down = _weight((f, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


class Block(nn.Module):
    """Transformer block. Besides the fused ``forward`` it exposes the
    attention-split halves the sequence-parallel trainer drives, as the
    JAX ``Block`` does: :meth:`qkv` (norm, projections, rope: everything
    before the attention contraction) and :meth:`post` (output
    projection, residuals, MLP: everything after). ``forward`` calls
    :meth:`post` too, so the fused and split paths share every op."""

    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, device)
        self.mlp = MLP(cfg, device)

    def qkv(self, x: torch.Tensor, freqs: torch.Tensor):
        """Pre-attention half: roped q (B, H, S, hd) and k, v
        (B, KVH, S, hd); ``freqs`` sliced to x's absolute positions."""
        return self.attn.qkv(self.attn_norm(x), freqs)

    def post(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Post-attention half: ``o`` is the (B, H, S, hd) attention
        output for x's positions."""
        y = x + self.attn.out_proj(o)
        return y + self.mlp(self.mlp_norm(y))

    def forward(self, x, freqs, cache=None, pos: Union[int, torch.Tensor] = 0):
        return self.post(x, self.attn.attend(self.attn_norm(x), freqs,
                                             cache, pos))


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

    def init_cache(self, batch: int, max_seq: Optional[int] = None,
                   device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
        """:func:`init_cache` for this model, on its device by default."""
        return init_cache(self.cfg, batch, max_seq,
                          self.device if device is None else device)

    def cache_nbytes(self, batch: int, max_seq: int) -> int:
        """Bytes of :meth:`init_cache`'s K/V for ``batch`` rows of
        ``max_seq`` positions."""
        cfg = self.cfg
        return (2 * cfg.n_layers * batch * cfg.n_kv_heads * max_seq
                * cfg.head_dim * cfg.dtype.itemsize)

    def forward(self, tokens: torch.Tensor,
                cache: Optional[List[Dict[str, torch.Tensor]]] = None,
                pos: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, vocab) f32. With ``cache``
        (from :func:`init_cache`), runs incrementally at absolute
        position ``pos`` and writes K/V into the cache in place; a 0-d
        int64 ``pos`` tensor on the model's device gives the
        static-shape step (module docstring)."""
        cfg = self.cfg
        if tokens.shape[-1] > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {tokens.shape[-1]} exceeds "
                f"{cfg.name}'s max_seq_len={cfg.max_seq_len}")
        x = F.embedding(tokens, self.embed)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint_block(layer, x, self.freqs,
                                     policy=cfg.remat_policy)
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


def _cache_len(cfg: LlamaConfig, total: int) -> int:
    """The JAX package's cache size: the smallest multiple of 128
    covering prompt + new tokens, at most ``max_seq_len``."""
    return min(cfg.max_seq_len, ((total + 127) // 128) * 128)


def _pick(logits_last: torch.Tensor, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """The next token from the last position's logits (B, vocab): argmax
    at temperature 0, else a categorical draw from ``generator`` by the
    exponential race that ``torch.multinomial`` takes for one sample,
    ``argmax(p / E)`` with ``E ~ Exp(1)``, with no host-side check."""
    if temperature <= 0.0:
        return torch.argmax(logits_last, dim=-1)
    probs = torch.softmax(logits_last / temperature, dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / race, dim=-1)


def _default_generator(dev: torch.device) -> torch.Generator:
    if dev.type == "cuda":
        return torch.cuda.default_generators[dev.index]
    return torch.default_generator


class DecodeLoop:
    """The compiled decode of :func:`generate`: static cache, token and
    position buffers for ``b`` sequences of up to ``cache_len`` positions,
    and one decode step over them, captured as a CUDA graph at its first
    call and replayed after (:class:`~rocnrdma_tpu_torch.utils.graphs.
    CapturedStep`; on the CPU the step runs uncaptured).

    The step reads the token buffer and the position ``pos`` (a 0-d
    tensor on the device), runs the tensor-``pos`` forward, picks the
    next token (:func:`_pick`), writes it into the token buffer and into
    the output at ``pos - p + 1``, and advances ``pos``, all on the
    device: the host only replays. ``capture=False`` runs the same step
    uncaptured on the card (to hold the graph against it).

    Sampling draws from the loop's own generator, registered with the
    graph; :meth:`run` copies the caller's generator state into it and
    writes the advanced state back, so the caller's generator moves as
    if the draws had been its own and one loop serves every generator.

    The model is held weakly, and the step holds no reference to the
    loop, so dropping the loop frees its buffers and its graph at once.
    Buffers are inference tensors, made and updated under
    ``torch.inference_mode()``."""

    def __init__(self, model: Llama, b: int, cache_len: int,
                 temperature: float = 0.0, capture: bool = True) -> None:
        dev = model.device
        self.model = weakref.ref(model, _drop_dead_loops)
        self.temperature = float(temperature)
        self.generator = torch.Generator(device=dev)
        with torch.inference_mode():
            self.cache = model.init_cache(b, cache_len, dev)
            self.tok = torch.zeros(b, dtype=torch.long, device=dev)
            self.pos = torch.zeros((), dtype=torch.long, device=dev)
            self.start = torch.zeros((), dtype=torch.long, device=dev)
            # Column j holds new token j; pos - start + 1 < cache_len.
            self.out = torch.zeros((b, cache_len), dtype=torch.long,
                                   device=dev)
        step = functools.partial(
            _decode_step, self.model, self.cache, self.tok, self.pos,
            self.start, self.out, self.temperature, self.generator)
        gens = ([self.generator] if dev.type == "cuda"
                and self.temperature > 0.0 else [])
        self.step = (CapturedStep(step, dev, generators=gens)
                     if capture else step)

    @property
    def alive(self) -> bool:
        return self.model() is not None

    @property
    def nbytes(self) -> int:
        """Device bytes of the static buffers (the cache dominates)."""
        return sum(t.nbytes for t in itertools.chain(
            (t for c in self.cache for t in c.values()),
            (self.tok, self.pos, self.start, self.out)))

    def start_sequence(self, prompt: torch.Tensor) -> None:
        """Zero the cache, prefill ``prompt`` (B, P) eagerly (position
        0: K3 on the card) and pick the first token; the decode steps
        then continue from position P."""
        p = prompt.shape[1]
        with torch.inference_mode():
            for c in self.cache:
                for t in c.values():
                    t.zero_()
            first = _pick(self.model()(prompt, self.cache, 0)[:, -1],
                          self.temperature, self.generator)
            self.tok.copy_(first)
            self.out[:, 0].copy_(first)
            self.pos.fill_(p)
            self.start.fill_(p)

    def tokens(self, n: int) -> torch.Tensor:
        """The first ``n`` tokens of the sequence, (B, n) int64."""
        with torch.inference_mode():
            return self.out[:, :n].clone()

    def run(self, prompt: torch.Tensor, max_new_tokens: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prefill ``prompt``, then ``max_new_tokens - 1`` decode steps:
        the new tokens (B, max_new_tokens). At temperature > 0 the draws
        come from ``generator`` (default: the device's default
        generator), through the loop's own one."""
        source = None
        if self.temperature > 0.0:
            source = generator or _default_generator(self.tok.device)
            self.generator.set_state(source.get_state())
        dev = self.tok.device
        with trace.span("generate.prefill", dev, b=prompt.shape[0],
                        p=prompt.shape[1]):
            self.start_sequence(prompt)
        with trace.span("generate.decode", dev, steps=max_new_tokens - 1):
            for _ in range(max_new_tokens - 1):
                self.step()
        if source is not None:
            source.set_state(self.generator.get_state())
        return self.tokens(max_new_tokens)


def _decode_step(model_ref, cache, tok, pos, start, out, temperature,
                 generator) -> None:
    """One step of :class:`DecodeLoop` over its static buffers."""
    with torch.inference_mode():
        logits = model_ref()(tok[:, None], cache, pos)
        nxt = _pick(logits[:, -1], temperature, generator)
        tok.copy_(nxt)
        out.index_copy_(1, (pos - start + 1).view(1), nxt[:, None])
        pos.add_(1)


# Bounded FIFO of decode loops, as the JAX package's memo of jitted
# loops: one entry per key, the oldest evicted first. Unlike a jitted
# executable an entry holds device memory (its cache and its graph), so
# the memo is bounded by the bytes of its static buffers too, and an
# entry goes as soon as its model does.
_GEN_CACHE: Dict[tuple, DecodeLoop] = {}
_GEN_CACHE_MAX = 32
_GEN_CACHE_MAX_BYTES = 8 << 30


def _gen_key(model: Llama, b: int, cache_len: int,
             temperature: float) -> tuple:
    """Everything a captured step bakes in: the model and the storage of
    its parameters and buffers (a ``load_state_dict(assign=True)``
    moves it, and a graph would read the freed storage), the shapes and
    the temperature. Not the generator: :meth:`DecodeLoop.run` copies
    its state in and out."""
    storage = tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                    for t in itertools.chain(model.parameters(),
                                             model.buffers()))
    return (id(model), model.cfg, storage, b, cache_len, float(temperature))


def _drop_dead_loops(_ref=None) -> None:
    """Drop the memo's loops whose model is gone (the callback of every
    loop's weakref to its model)."""
    for key, loop in list(_GEN_CACHE.items()):
        if not loop.alive:
            _GEN_CACHE.pop(key, None)


def _decode_loop(model: Llama, b: int, cache_len: int,
                 temperature: float) -> DecodeLoop:
    key = _gen_key(model, b, cache_len, temperature)
    loop = _GEN_CACHE.get(key)
    # An id may be reused once its object is gone: a hit counts only if
    # it is the same model.
    if loop is not None and loop.model() is model:
        return loop
    _GEN_CACHE.pop(key, None)
    need = model.cache_nbytes(b, cache_len)
    while _GEN_CACHE and (
            len(_GEN_CACHE) >= _GEN_CACHE_MAX
            or need + sum(v.nbytes for v in _GEN_CACHE.values())
            > _GEN_CACHE_MAX_BYTES):
        gone = _GEN_CACHE.pop(next(iter(_GEN_CACHE)))
        trace.event("generate.loop_evict", bytes=gone.nbytes)
    loop = DecodeLoop(model, b, cache_len, temperature)
    _GEN_CACHE[key] = loop
    return loop


def generate(model: Llama, prompt, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """Autoregressive generation with an incremental KV cache.

    prompt: (B, P) token ids. Returns (B, max_new_tokens) int64 on
    ``device``, which must be where ``model`` lives. Greedy at
    temperature 0, else categorical sampling with ``generator`` (default:
    the device's default generator). The cache is sized like the JAX
    package's: the smallest multiple of 128 covering prompt + new tokens.

    The prefill runs eagerly (K3 on the card); the decode steps are
    replays of one captured step (:class:`DecodeLoop`), the counterpart
    of the JAX package's jitted ``lax.scan``. Loops are memoized in a
    bounded FIFO of 32 entries, and of at most ``_GEN_CACHE_MAX_BYTES``
    of static buffers, keyed on what the graph bakes in (the model and
    its parameters' storage, B, the cache length, the temperature), so
    repeated calls reuse the captured step; the generator is an argument
    of the call, as the JAX loop's rng key is. The JAX memo also keys on
    P and ``max_new_tokens``; the port's step depends on neither, so one
    entry serves every prompt length whose prompt + new tokens round to
    the same cache length. The cache is zeroed at each call, and an
    entry is dropped as soon as its model is."""
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
    loop = _decode_loop(model, b, _cache_len(cfg, total), temperature)
    return loop.run(prompt, max_new_tokens, generator)


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


_LAYER_PARAMS = ("attn_norm.weight", "attn.wq", "attn.wk", "attn.wv",
                 "attn.wo", "mlp_norm.weight", "mlp.w_gate", "mlp.w_up",
                 "mlp.w_down")


def param_names(n_layers: int) -> List[str]:
    """The state-dict names of a :class:`Llama` of ``n_layers`` layers,
    in its parameter order."""
    return (["embed"]
            + [f"layers.{i}.{n}" for i in range(n_layers)
               for n in _LAYER_PARAMS]
            + ["final_norm.weight", "lm_head"])


def flax_tree(items) -> Dict[str, Any]:
    """``(state-dict name, value)`` pairs → the flax-shaped tree
    ``{"params": {"embed": {"embedding": v}, "layer_0": {...}, ...}}``."""
    tree: Dict[str, Any] = {}
    for name, value in items:
        path = _flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return {"params": tree}


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_params`` tree (``{"params": {...}}``
    with numpy leaves) → this port's state dict, on the CPU and in the
    leaves' dtypes. Kernels stay (in, out): no transpose."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for name in param_names(sum(1 for k in p if k.startswith("layer_"))):
        node = p
        for key in _flax_path(name):
            node = node[key]
        out[name] = _to_tensor(node)
    return out


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: a state dict → the flax
    tree with float32 numpy leaves (bf16 widens losslessly) — the tree
    the serving pager's ``pack_llama_params`` takes."""
    return flax_tree((name, t.detach().float().cpu().numpy())
                     for name, t in state.items())
