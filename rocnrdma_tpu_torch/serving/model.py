"""Paged Llama decode on the card — the serving-side model consumer.

Counterpart of ``rocnrdma_tpu/serving/model.py``. The weights travel as
flat f32 *pages* — one per transformer layer plus an embedding page and
a head page — because pages are what the streaming pager delivers. The
page layout, :func:`pack_pages`, :func:`pack_llama_params` and
:func:`toy_param_tree` are the JAX package's, copied as they are
(numpy), so both packages pack identical bytes.

:class:`PagedDecoder` takes the place of the JAX package's numpy
decoder. Each step the batcher hands it each acquired page once
(:meth:`PagedDecoder.upload` copies it to the device and returns when
the copy is done, so the host window may be reused at once); per-request
KV caches live on the device. Its norms run through the K1 kernel and
its position-0 prefill through the K3 kernel; decode keeps the plain
grouped-query product against the cache, in f32 like the numpy decoder.
:class:`JitPagedDecoder` is the counterpart of the JAX package's jitted
decoder (``ContinuousBatcher(jit_decode=True)``): the same math, its
decode layer steps replayed as CUDA graphs over static buffers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..ops.attention import attention
from ..ops.rmsnorm import rmsnorm
from ..utils.graphs import CapturedStep
from ..utils.trace import trace
from .pager import PageSet

__all__ = [
    "ServeConfig", "page_names", "pack_pages", "pack_llama_params",
    "toy_param_tree", "unpack_embed", "unpack_layer", "unpack_head",
    "PagedDecoder", "JitPagedDecoder",
]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The architecture facts decode needs — a mirror of
    ``LlamaConfig`` (constructible from one via :meth:`from_llama`)."""

    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq_len: int = 128
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def from_llama(cls, cfg: Any) -> "ServeConfig":
        return cls(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                   n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                   max_seq_len=cfg.max_seq_len,
                   rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps)


# ------------------------------------------------------------- page layout
#
# Page k of a ServeConfig model:
#   page 0                 : embedding        [vocab, d_model]
#   page 1 .. n_layers     : one layer each   [attn_norm | wq | wk | wv |
#                                              wo | mlp_norm | w_gate |
#                                              w_up | w_down], flat f32
#   page n_layers + 1      : head             [final_norm | lm_head]
#
# The layout is a pure function of the config — every rank derives the
# identical page sizes (the pager's SPMD schedule needs nothing else).

def _layer_fields(cfg: ServeConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    d, hd = cfg.d_model, cfg.head_dim
    return [
        ("attn_norm", (d,)),
        ("wq", (d, cfg.n_heads * hd)),
        ("wk", (d, cfg.n_kv_heads * hd)),
        ("wv", (d, cfg.n_kv_heads * hd)),
        ("wo", (cfg.n_heads * hd, d)),
        ("mlp_norm", (d,)),
        ("w_gate", (d, cfg.d_ff)),
        ("w_up", (d, cfg.d_ff)),
        ("w_down", (cfg.d_ff, d)),
    ]


def page_names(cfg: ServeConfig) -> List[str]:
    return (["embed"] + [f"layer_{i}" for i in range(cfg.n_layers)]
            + ["head"])


def _pack(fields: Sequence[Tuple[str, Tuple[int, ...]]],
          tensors: Dict[str, np.ndarray]) -> np.ndarray:
    parts = []
    for name, shape in fields:
        t = np.ascontiguousarray(tensors[name], dtype=np.float32)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {t.shape} != {shape}")
        parts.append(t.reshape(-1))
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def _unpack(fields: Sequence[Tuple[str, Tuple[int, ...]]],
            page: np.ndarray) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    off = 0
    for name, shape in fields:
        n = int(np.prod(shape))
        out[name] = page[off:off + n].reshape(shape)
        off += n
    return out


def pack_pages(cfg: ServeConfig, tree: Dict[str, Any]) -> PageSet:
    """``tree`` is the nested numpy param dict (flax naming, see
    :func:`pack_llama_params` / :func:`toy_param_tree`)."""
    pages = [_pack([("embed", (cfg.vocab_size, cfg.d_model))],
                   {"embed": tree["embed"]})]
    for i in range(cfg.n_layers):
        pages.append(_pack(_layer_fields(cfg), tree[f"layer_{i}"]))
    pages.append(_pack(
        [("final_norm", (cfg.d_model,)),
         ("lm_head", (cfg.d_model, cfg.vocab_size))],
        {"final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}))
    return PageSet(pages, page_names(cfg))


def unpack_embed(cfg: ServeConfig, page: np.ndarray) -> np.ndarray:
    return page[:cfg.vocab_size * cfg.d_model].reshape(
        cfg.vocab_size, cfg.d_model)


def unpack_layer(cfg: ServeConfig, page: np.ndarray) -> Dict[str, np.ndarray]:
    return _unpack(_layer_fields(cfg), page)


def unpack_head(cfg: ServeConfig, page: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    d = cfg.d_model
    return (page[:d],
            page[d:d + d * cfg.vocab_size].reshape(d, cfg.vocab_size))


def pack_llama_params(cfg: ServeConfig, params: Dict[str, Any]) -> PageSet:
    """Flatten a flax-layout ``init_params`` tree into pages.
    ``params`` is the ``{"params": {...}}`` tree with numpy (or
    numpy-convertible) leaves: the JAX package's tree, or
    :func:`~rocnrdma_tpu_torch.models.llama.params_to_flax` of a port
    state dict."""
    p = params["params"] if "params" in params else params
    tree: Dict[str, Any] = {
        "embed": np.asarray(p["embed"]["embedding"]),
        "final_norm": np.asarray(p["final_norm"]["weight"]),
        "lm_head": np.asarray(p["lm_head"]["kernel"]),
    }
    for i in range(cfg.n_layers):
        lp = p[f"layer_{i}"]
        tree[f"layer_{i}"] = {
            "attn_norm": np.asarray(lp["attn_norm"]["weight"]),
            "wq": np.asarray(lp["attn"]["wq"]["kernel"]),
            "wk": np.asarray(lp["attn"]["wk"]["kernel"]),
            "wv": np.asarray(lp["attn"]["wv"]["kernel"]),
            "wo": np.asarray(lp["attn"]["wo"]["kernel"]),
            "mlp_norm": np.asarray(lp["mlp_norm"]["weight"]),
            "w_gate": np.asarray(lp["mlp"]["w_gate"]["kernel"]),
            "w_up": np.asarray(lp["mlp"]["w_up"]["kernel"]),
            "w_down": np.asarray(lp["mlp"]["w_down"]["kernel"]),
        }
    return pack_pages(cfg, tree)


def toy_param_tree(cfg: ServeConfig, seed: int = 7) -> Dict[str, Any]:
    """Deterministic small random params (numpy RNG — identical on
    every rank for a given seed) for the unit tests."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        scale = 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    tree: Dict[str, Any] = {
        "embed": w(cfg.vocab_size, cfg.d_model),
        "final_norm": np.ones(cfg.d_model, np.float32),
        "lm_head": w(cfg.d_model, cfg.vocab_size),
    }
    for i in range(cfg.n_layers):
        tree[f"layer_{i}"] = {
            "attn_norm": np.ones(cfg.d_model, np.float32),
            "wq": w(cfg.d_model, cfg.n_heads * cfg.head_dim),
            "wk": w(cfg.d_model, cfg.n_kv_heads * cfg.head_dim),
            "wv": w(cfg.d_model, cfg.n_kv_heads * cfg.head_dim),
            "wo": w(cfg.n_heads * cfg.head_dim, cfg.d_model),
            "mlp_norm": np.ones(cfg.d_model, np.float32),
            "w_gate": w(cfg.d_model, cfg.d_ff),
            "w_up": w(cfg.d_model, cfg.d_ff),
            "w_down": w(cfg.d_ff, cfg.d_model),
        }
    return tree


# ---------------------------------------------------------------- decoder

class PagedDecoder:
    """Per-page math on the device; the batcher owns page acquisition
    and per-request KV caches, this class owns the numbers.

    KV caches are per-request tensors of shape
    ``(n_kv_heads, max_seq_len, head_dim)`` f32 on the device
    (:meth:`new_cache`), updated in place."""

    def __init__(self, cfg: ServeConfig, device: DeviceLike = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        hd = cfg.head_dim
        # Angles in numpy f32, as the numpy decoder computes them.
        inv = 1.0 / (cfg.rope_theta ** (
            np.arange(0, hd, 2, dtype=np.float32) / hd))
        freqs = np.outer(np.arange(cfg.max_seq_len, dtype=np.float32), inv)
        self._cos = torch.from_numpy(np.cos(freqs)).to(self.device)
        self._sin = torch.from_numpy(np.sin(freqs)).to(self.device)

    def upload(self, page: np.ndarray) -> torch.Tensor:
        """Copy one landed host page to the device. Returns after the
        copy has read the whole page, so the caller may release the
        window right away."""
        with trace.span("serve.upload", bytes=page.nbytes):
            return torch.from_numpy(page).to(self.device, copy=True)

    def new_cache(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.n_kv_heads, cfg.max_seq_len, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.float32,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=torch.float32,
                                 device=self.device)}

    def release_cache(self, cache: Dict[str, torch.Tensor]) -> None:
        """Hand back a finished request's cache: nothing to do here,
        the cache is garbage once the batcher drops it
        (:class:`JitPagedDecoder` pools its caches)."""

    def _rope(self, x: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
        # x: (H, s, hd) at the positions q_pos (s,) — split-half
        # rotation, f32 throughout.
        cos = self._cos.index_select(0, q_pos)[None]
        sin = self._sin.index_select(0, q_pos)[None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def embed(self, embed_page: torch.Tensor, tokens) -> torch.Tensor:
        emb = unpack_embed(self.cfg, embed_page)
        idx = torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                              device=self.device)
        return emb[idx]                                   # (s, D)

    def layer(self, layer_page: torch.Tensor, x: torch.Tensor,
              cache: Dict[str, torch.Tensor],
              pos: Union[int, torch.Tensor]) -> torch.Tensor:
        """One transformer block over ``x`` (s, D) at absolute position
        ``pos``, writing K/V into ``cache``. An int ``pos`` attends over
        the cache prefix (K3 at position 0); a 0-d int64 tensor on the
        device gives the static-shape step of the JAX package's jitted
        decoder: K/V written by ``index_copy_``, the product over the
        whole cache under its mask."""
        cfg = self.cfg
        w = unpack_layer(cfg, layer_page)
        s = x.shape[0]
        hd = cfg.head_dim

        h = rmsnorm(x, w["attn_norm"], cfg.norm_eps)
        q = (h @ w["wq"]).view(s, cfg.n_heads, hd).transpose(0, 1)
        k = (h @ w["wk"]).view(s, cfg.n_kv_heads, hd).transpose(0, 1)
        v = (h @ w["wv"]).view(s, cfg.n_kv_heads, hd).transpose(0, 1)
        if isinstance(pos, torch.Tensor):
            q_pos = pos + torch.arange(s, device=x.device)
            t = cfg.max_seq_len
        else:
            q_pos = torch.arange(pos, pos + s, device=x.device)
            t = pos + s
        q = self._rope(q, q_pos)
        k = self._rope(k, q_pos)
        cache["k"].index_copy_(1, q_pos, k)
        cache["v"].index_copy_(1, q_pos, v)
        if not isinstance(pos, torch.Tensor) and pos == 0:
            o = attention(q[None], k[None], v[None], causal=True)[0]
        else:
            o = self._cached_attention(q, cache["k"][:, :t],
                                       cache["v"][:, :t], q_pos)
        x = x + o.transpose(0, 1).reshape(s, cfg.n_heads * hd) @ w["wo"]
        h = rmsnorm(x, w["mlp_norm"], cfg.norm_eps)
        g = h @ w["w_gate"]
        return x + ((g * (1.0 / (1.0 + torch.exp(-g))))
                    * (h @ w["w_up"])) @ w["w_down"]

    def _cached_attention(self, q: torch.Tensor, k_all: torch.Tensor,
                          v_all: torch.Tensor,
                          q_pos: torch.Tensor) -> torch.Tensor:
        """q (H, s, hd) at the positions ``q_pos`` against the cache
        (KVH, T, hd), each query's later keys masked: the numpy
        decoder's product. T is the whole cache (the static-shape step)
        or the prefix up to the last query (an int ``pos``; the keys
        past it are masked keys, which weigh exactly zero)."""
        cfg = self.cfg
        s, hd = q.shape[1], q.shape[2]
        rep = cfg.n_heads // cfg.n_kv_heads
        # Group folded into the query rows: the cache is never repeated.
        qg = q.reshape(cfg.n_kv_heads, rep * s, hd)
        scores = (qg @ k_all.transpose(-1, -2)) / float(
            np.sqrt(np.float32(hd)))
        visible = (torch.arange(k_all.shape[1], device=q.device)[None, :]
                   <= q_pos.repeat(rep)[:, None])
        scores = scores.masked_fill(~visible, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return (probs @ v_all).reshape(cfg.n_heads, s, hd)

    def head(self, head_page: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Final norm + lm_head → f32 logits (s, vocab)."""
        fn, lm = unpack_head(self.cfg, head_page)
        return rmsnorm(x, fn, self.cfg.norm_eps) @ lm

    # KV seam: the batcher's join streaming reads/writes per-request
    # caches through these two methods only.

    def dump_kv(self, cache: Dict[str, torch.Tensor], p: int) -> np.ndarray:
        """Flatten the first ``p`` positions of K then V into host numpy
        (the KV-join wire payload)."""
        return np.concatenate([cache["k"][:, :p].cpu().numpy().ravel(),
                               cache["v"][:, :p].cpu().numpy().ravel()])

    def load_kv(self, cache: Dict[str, torch.Tensor], k: np.ndarray,
                v: np.ndarray, p: int) -> None:
        """Write received prefill K/V into the first ``p`` positions."""
        cache["k"][:, :p] = torch.from_numpy(np.asarray(k)).to(self.device)
        cache["v"][:, :p] = torch.from_numpy(np.asarray(v)).to(self.device)


class JitPagedDecoder(PagedDecoder):
    """The paged decoder with its decode layer steps replayed as CUDA
    graphs: the counterpart of the JAX package's ``JitPagedDecoder``
    (``ContinuousBatcher(jit_decode=True)``). Same page layout, same
    math, same cache-dict contract as :class:`PagedDecoder`.

    - **Decode (``s == 1``)**: one layer step over static device
      buffers: a page buffer per page size (:meth:`upload` copies each
      landed page into the buffer of its kind — embed, layer, head —
      and still returns after the window has been read), the activation
      and a device ``pos``, attending over the whole ``max_seq_len``
      cache under the numpy decoder's mask. The step is captured at its
      first call for a cache and replayed after
      (:class:`~rocnrdma_tpu_torch.utils.graphs.CapturedStep`; on the
      CPU it runs uncaptured). The capture's ``"thread_local"`` mode
      lets the world's progress threads and the other ranks' threads of
      wire mode keep running.
    - **Prefill (``s > 1``)** runs :meth:`PagedDecoder.layer` eagerly
      (K3 at position 0). JAX compiles one executable per prompt length;
      a request's prompt length comes once, so a capture per length
      would cost more than the one replay it buys.
    - **Cache identity.** JAX donates the caches, so any buffer can be
      passed in; a CUDA graph bakes the caches' addresses in. So
      :meth:`new_cache` hands out buffer pairs from a pool the decoder
      owns, at most ``max_caches`` of them (the batcher passes
      ``max_slots × n_layers``), with one graph per pair, and
      :meth:`release_cache` takes a finished request's pairs back: the
      pool and the number of graphs stay bounded. A reused pair is
      zeroed. :meth:`load_kv` and :meth:`dump_kv` work in place on
      pooled buffers.

    Greedy tokens match :class:`PagedDecoder`'s; logits may differ in
    the last ulp (the masked product sums over the whole cache, the
    eager one over its prefix), which greedy argmax sees only at a
    near-tie."""

    def __init__(self, cfg: ServeConfig, device: DeviceLike = "cuda",
                 max_caches: Optional[int] = None) -> None:
        super().__init__(cfg, device)
        self.max_caches = max_caches
        f32 = dict(dtype=torch.float32, device=self.device)
        self._pages: Dict[int, torch.Tensor] = {}
        self._caches: Dict[int, Dict[str, torch.Tensor]] = {}
        self._free: List[Dict[str, torch.Tensor]] = []
        self._steps: Dict[int, CapturedStep] = {}
        self._x = torch.zeros((1, cfg.d_model), **f32)
        self._y = torch.zeros((1, cfg.d_model), **f32)
        self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        # Every step writes its result into _y, so the graphs' own
        # allocations are all freed inside their capture: one pool.
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)

    @property
    def graphs(self) -> int:
        """Layer steps captured so far (one per pooled cache pair)."""
        return sum(st.graph is not None for st in self._steps.values())

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the pooled K/V caches."""
        return sum(c["k"].nbytes + c["v"].nbytes
                   for c in self._caches.values())

    def _page_buffer(self, n: int) -> torch.Tensor:
        buf = self._pages.get(n)
        if buf is None:
            buf = self._pages[n] = torch.empty(n, dtype=torch.float32,
                                               device=self.device)
        return buf

    def upload(self, page: np.ndarray) -> torch.Tensor:
        """Copy one landed host page into the static buffer of its size
        (its kind). Returns after the copy has read the whole page."""
        buf = self._page_buffer(page.size)
        with trace.span("serve.upload", bytes=page.nbytes):
            buf.copy_(torch.from_numpy(page))
        return buf

    def new_cache(self) -> Dict[str, torch.Tensor]:
        if self._free:
            cache = self._free.pop()
            cache["k"].zero_()
            cache["v"].zero_()
            return cache
        if self.max_caches is not None and \
                len(self._caches) >= self.max_caches:
            raise RuntimeError(f"JitPagedDecoder: all {self.max_caches} "
                               "pooled caches are in use")
        cache = super().new_cache()
        self._caches[cache["k"].data_ptr()] = cache
        return cache

    def _pooled(self, cache: Dict[str, torch.Tensor]) -> int:
        key = cache["k"].data_ptr()
        if self._caches.get(key) is not cache:
            raise ValueError("JitPagedDecoder: the cache is not one of "
                             "this decoder's new_cache() pairs")
        return key

    def release_cache(self, cache: Dict[str, torch.Tensor]) -> None:
        """Take a finished request's cache back into the pool."""
        self._pooled(cache)
        if any(c is cache for c in self._free):
            raise ValueError("JitPagedDecoder: cache released twice")
        self._free.append(cache)

    def layer(self, layer_page: torch.Tensor, x: torch.Tensor,
              cache: Dict[str, torch.Tensor], pos: int) -> torch.Tensor:
        if x.shape[0] != 1:
            return super().layer(layer_page, x, cache, pos)
        key = self._pooled(cache)
        page = self._page_buffer(layer_page.numel())
        if page.data_ptr() != layer_page.data_ptr():
            page.copy_(layer_page)
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = CapturedStep(
                functools.partial(self._decode, page, cache), self.device,
                pool=self._pool)
        self._x.copy_(x)
        self._pos.fill_(pos)
        step()
        return self._y.clone()

    def _decode(self, page: torch.Tensor,
                cache: Dict[str, torch.Tensor]) -> None:
        self._y.copy_(PagedDecoder.layer(self, page, self._x, cache,
                                         self._pos))
