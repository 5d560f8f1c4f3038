"""Cached grouped-query attention of the decode step: the hand-written
CUDA kernel K6 and its plain version.

Counterpart of the cached branch of ``rocnrdma_tpu/models/llama.py``'s
``Attention`` (its two einsums with ``preferred_element_type=f32``); no
Pallas kernel stands behind it. ``csrc/decode_attn.cu`` (K6) reads the
bf16 or f32 cache in place, once, up to the last live query position,
with f32 products and sums; its note says what bounds it on an H100 and
how.

:func:`cached_attention` dispatches on the device: CUDA tensors launch
K6, CPU tensors run :func:`cached_attention_reference`, any other device
raises. There is no fallback: a shape, stride or dtype the kernel does
not take raises, and the cache is never copied, widened or repeated on
the CUDA path. The kernel rounds each probability to q's dtype before
normalising (online softmax), the plain version after; both sum in f32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _native

__all__ = ["cached_attention", "cached_attention_reference",
           "decode_splits", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows one block of the kernel holds (kRows in the source).
BLOCK_ROWS = 4
# Blocks an SM runs at once (kMinBlocks in the source, which holds the
# kernel to the registers and shared memory that allow it).
BLOCKS_PER_SM = 4
# No split takes fewer keys than this.
MIN_KEYS_PER_SPLIT = 128


def cached_attention_reference(q: torch.Tensor, k_all: torch.Tensor,
                               v_all: torch.Tensor,
                               q_pos: torch.Tensor) -> torch.Tensor:
    """Plain grouped-query attention of q (B, H, s, hd) at the absolute
    positions ``q_pos`` (s,) against the cache k_all/v_all (B, KVH, T,
    hd), keys past each query masked: the JAX package's decode product
    (``arange(T) <= q_pos``). T is the whole cache (the static-shape
    step) or the prefix up to the last query (an int ``pos``): the keys
    past the prefix are masked keys, which weigh exactly zero. f32
    scores, probs cast to q's dtype before the value product."""
    b, h, s, hd = q.shape
    kvh, t = k_all.shape[1], k_all.shape[2]
    rep = h // kvh
    # The group is folded into the query rows (b, kvh, rep * s, hd), so
    # the cache is never repeated per query head.
    qg = q.float().reshape(b, kvh, rep * s, hd)
    scores = (qg @ k_all.float().transpose(-1, -2)) / math.sqrt(hd)
    visible = (torch.arange(t, device=q.device)[None, :]
               <= q_pos.repeat(rep)[:, None])
    scores = scores.masked_fill(~visible, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = probs.float() @ v_all.float()
    return o.to(q.dtype).reshape(b, h, s, hd)


def decode_splits(groups: int, t: int, n_sm: int) -> int:
    """How many key ranges K6 cuts a cache of ``t`` positions into, for
    ``groups`` blocks a split (B · KVH · row groups) on a card of
    ``n_sm`` SMs: as many as the card runs at once
    (``BLOCKS_PER_SM · n_sm`` blocks) without starting a second, partial
    wave, no split under ``MIN_KEYS_PER_SPLIT`` keys, and at least one.
    A call with ``groups`` above the card's resident blocks takes one
    split: splitting it further adds partials and a combine pass and
    leaves the last wave as ragged (measured on the H100 at the decode
    cell's shape)."""
    fill = BLOCKS_PER_SM * n_sm // max(groups, 1)
    most = -(-t // MIN_KEYS_PER_SPLIT)
    return max(1, min(fill, most))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scale2(hd: int) -> float:
    """log2(e) / sqrt(hd) in f32: the kernel keeps its scores in log2
    units and takes exp as a power of 2."""
    return float(np.float32(math.log2(math.e) / math.sqrt(hd)))


def _strides(x: torch.Tensor):
    """The strides of x's first three dims, 0 where a dim has one entry
    (the kernel never steps along it, and torch leaves its stride
    arbitrary)."""
    return tuple(x.stride(i) if x.shape[i] > 1 else 0 for i in range(3))


def _check(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
           q_pos: torch.Tensor) -> None:
    if q.dim() != 4 or k_all.dim() != 4 or v_all.dim() != 4:
        raise ValueError("decode attention takes 4-D q (B, H, s, hd) and "
                         "k/v (B, KVH, T, hd)")
    b, h, s, hd = q.shape
    kvh, t = k_all.shape[1], k_all.shape[2]
    if k_all.shape != (b, kvh, t, hd) or v_all.shape != k_all.shape:
        raise ValueError(f"k/v shapes {tuple(k_all.shape)}/"
                         f"{tuple(v_all.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kvh == 0 or h % kvh != 0:
        raise ValueError(f"H={h} is not a multiple of KVH={kvh}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode kernel head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_all.dtype != q.dtype \
            or v_all.dtype != q.dtype:
        raise TypeError(f"decode kernel takes one dtype of float32/bfloat16 "
                        f"for q, k, v; got {q.dtype}/{k_all.dtype}/"
                        f"{v_all.dtype}")
    if q_pos.shape != (s,) or q_pos.dtype != torch.int64 \
            or not q_pos.is_contiguous():
        raise ValueError(f"q_pos must be a contiguous ({s},) int64 tensor, "
                         f"got {tuple(q_pos.shape)} {q_pos.dtype}")
    if not (q.device == k_all.device == v_all.device == q_pos.device):
        raise ValueError("q, k, v and q_pos must lie on one device")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k_all), ("v", v_all)):
        if (x.stride(3) != 1 or any(st % vec for st in _strides(x))
                or x.data_ptr() % 16):
            raise ValueError(f"decode kernel reads {name} in 16-byte vectors: "
                             f"its rows must be unit-stride, 16-byte "
                             f"aligned and 16-byte apart; got strides "
                             f"{x.stride()}")
    if b * kvh > 2 ** 31 - 1 or t >= 2 ** 31:
        raise ValueError(f"B*KVH={b * kvh}, T={t} exceed the kernel's "
                         "grid and index range")


def _launch(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
            q_pos: torch.Tensor, splits: int) -> torch.Tensor:
    """K6 with ``splits`` key ranges (the partials merged by its combine
    pass when more than one)."""
    b, h, s, hd = q.shape
    kvh, t = k_all.shape[1], k_all.shape[2]
    rows = (h // kvh) * s
    out = torch.empty((b, h, s, hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b * kvh * rows, splits, hd),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * kvh * rows, splits, 2),
                              dtype=torch.float32, device=q.device)
    lib = _native.library("decode_attn")
    _native.count("decode_attn")
    rc = lib.decode_attn(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        b, kvh, h // kvh, s, t, hd, splits,
        *_strides(q), *_strides(k_all), *_strides(v_all),
        _scale2(hd), _DTYPES[q.dtype], _native.stream_handle(q.device))
    _native.check("decode_attn", rc)
    return out


def cached_attention(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor,
                     q_pos: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention of q (B, H, s, hd) at the absolute
    positions ``q_pos`` (s,) against the cache k_all/v_all (B, KVH, T,
    hd), the whole cache or a ``[:, :, :t]`` view of it; keys past each
    query's position weigh zero. Returns (B, H, s, hd) in q's dtype.

    CUDA tensors: K6, which reads the cache through its strides and only
    up to max(q_pos), split over the keys by :func:`decode_splits`. CPU
    tensors: :func:`cached_attention_reference`."""
    if _native.device_type(q, "decode attention") == "cpu":
        return cached_attention_reference(q, k_all, v_all, q_pos)
    _check(q, k_all, v_all, q_pos)
    b, h, s, _ = q.shape
    kvh, t = k_all.shape[1], k_all.shape[2]
    row_groups = -(-(h // kvh) * s // BLOCK_ROWS)
    index = q.device.index
    n_sm = _sm_count(torch.cuda.current_device() if index is None else index)
    return _launch(q, k_all, v_all, q_pos,
                   decode_splits(b * kvh * row_groups, t, n_sm))
