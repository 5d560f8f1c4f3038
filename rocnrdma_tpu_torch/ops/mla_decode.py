"""Absorbed latent attention of the decode step: the hand-written CUDA
kernel K7 and its plain version.

No Pallas kernel stands behind it: the JAX package has no latent
attention. ``csrc/mla_decode.cu`` (K7) reads the bf16 latent cache in
place, up to the query's position, a block for each 16 heads of a
sequence (16 or 32 heads: at 32 the two blocks of a sequence read its
rows together, the second through the L2), with the products on the
tensor cores and f32 sums; its note says what bounds it on an H100 and
how.

:func:`mla_decode` dispatches on the device: CUDA tensors launch K7, CPU
tensors run :func:`mla_decode_reference`, any other device raises. There
is no fallback: a shape, stride or dtype the kernel does not take raises,
and the cache is never copied or widened on the CUDA path. The kernel
rounds each probability to bf16 before normalising (online softmax), the
plain version after; both sum in f32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _native

__all__ = ["mla_decode", "mla_decode_reference", "mla_decode_splits",
           "HEADS", "HEAD_COUNTS", "LATENT", "ROPE"]

# The widths the kernel is built for: one mma tile's 16 rows of heads (a
# block's), the DeepSeek-V3 latent and its roped key; the query heads a
# sequence it takes (Moonlight's 16, Kimi Linear's 32).
HEADS, LATENT, ROPE = 16, 512, 64
HEAD_COUNTS = (16, 32)
# Blocks an SM runs at once (kMinBlocks in the source).
BLOCKS_PER_SM = 2
# Keys a tile; no split takes fewer than MIN_KEYS_PER_SPLIT.
KEYS_PER_TILE = 32
MIN_KEYS_PER_SPLIT = 256


def mla_decode_reference(q: torch.Tensor, ckv: torch.Tensor,
                         q_pos: torch.Tensor, scale: float,
                         latent: int) -> torch.Tensor:
    """Plain absorbed attention: q (B, H, latent + rope), one query a
    row at position ``q_pos`` (1,), against the cache ckv (B, T, latent
    + rope), keys past the position masked; the value is a row's first
    ``latent`` columns. f32 scores times ``scale``, softmax, probs cast
    to q's dtype before the value product. Returns (B, H, latent)."""
    t = ckv.shape[1]
    scores = torch.einsum("bhd,btd->bht", q.float(), ckv.float()) * scale
    hidden = torch.arange(t, device=q.device) > q_pos[0]
    probs = scores.masked_fill(hidden, float("-inf")).softmax(-1)
    o = torch.einsum("bht,btd->bhd", probs.to(q.dtype).float(),
                     ckv[..., :latent].float())
    return o.to(q.dtype)


def mla_decode_splits(b: int, t: int, n_sm: int) -> int:
    """How many key ranges K7 cuts a cache of ``t`` positions into for
    ``b`` blocks of 16 heads (sequences × head groups) on a card of
    ``n_sm`` SMs: as many as fill the
    card's resident blocks (``BLOCKS_PER_SM · n_sm``) in one wave, no
    split under ``MIN_KEYS_PER_SPLIT`` keys, and at least one."""
    fill = BLOCKS_PER_SM * n_sm // max(b, 1)
    most = -(-t // MIN_KEYS_PER_SPLIT)
    return max(1, min(fill, most))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q: torch.Tensor, ckv: torch.Tensor, q_pos: torch.Tensor,
           latent: int) -> None:
    if q.dim() != 3 or ckv.dim() != 3:
        raise ValueError("latent decode takes q (B, H, latent + rope) and "
                         "ckv (B, T, latent + rope)")
    b, h, w = q.shape
    if h not in HEAD_COUNTS or (w, latent) != (LATENT + ROPE, LATENT):
        raise ValueError(f"latent decode kernel takes {HEAD_COUNTS} heads "
                         f"of {LATENT} + {ROPE}, got {h} of {w} (latent "
                         f"{latent})")
    if ckv.shape[0] != b or ckv.shape[2] != w:
        raise ValueError(f"ckv {tuple(ckv.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if q.dtype != torch.bfloat16 or ckv.dtype != torch.bfloat16:
        raise TypeError(f"latent decode kernel takes bfloat16, got "
                        f"{q.dtype}/{ckv.dtype}")
    if q_pos.shape != (1,) or q_pos.dtype != torch.int64:
        raise ValueError(f"q_pos must be a (1,) int64 tensor, got "
                         f"{tuple(q_pos.shape)} {q_pos.dtype}")
    if not (q.device == ckv.device == q_pos.device):
        raise ValueError("q, ckv and q_pos must lie on one device")
    for name, x in (("q", q), ("ckv", ckv)):
        if (x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8
                or x.data_ptr() % 16):
            raise ValueError(f"latent decode kernel reads {name} in 16-byte "
                             f"vectors: its rows must be unit-stride, "
                             f"16-byte aligned and 16-byte apart; got "
                             f"strides {x.stride()}")
    if ckv.shape[1] >= 2 ** 31:
        raise ValueError(f"T={ckv.shape[1]} exceeds the kernel's index range")


def _launch(q: torch.Tensor, ckv: torch.Tensor, q_pos: torch.Tensor,
            scale: float, splits: int) -> torch.Tensor:
    """K7 with ``splits`` key ranges (merged by its combine pass when
    more than one)."""
    b, h, t = q.shape[0], q.shape[1], ckv.shape[1]
    out = torch.empty((b, h, LATENT), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b * h, splits, LATENT),
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * h, splits, 2), dtype=torch.float32,
                              device=q.device)
    lib = _native.library("mla_decode")
    _native.count("mla_decode")
    rc = lib.mla_decode(
        q.data_ptr(), ckv.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        b, h, t, splits, q.stride(0), q.stride(1), ckv.stride(0), ckv.stride(1),
        float(np.float32(math.log2(math.e) * scale)),
        _native.stream_handle(q.device))
    _native.check("mla_decode", rc)
    return out


def mla_decode(q: torch.Tensor, ckv: torch.Tensor, q_pos: torch.Tensor,
               scale: float, latent: int) -> torch.Tensor:
    """Absorbed attention of q (B, H, latent + rope) at position
    ``q_pos`` (1,) against the latent cache ckv (B, T, latent + rope);
    keys past the position weigh zero. Returns (B, H, latent) in q's
    dtype.

    CUDA tensors: K7, which reads the cache through its strides and only
    up to ``q_pos``, split over the keys by :func:`mla_decode_splits`.
    CPU tensors: :func:`mla_decode_reference`."""
    if _native.device_type(q, "latent decode") == "cpu":
        return mla_decode_reference(q, ckv, q_pos, scale, latent)
    _check(q, ckv, q_pos, latent)
    index = q.device.index
    n_sm = _sm_count(torch.cuda.current_device() if index is None else index)
    blocks = q.shape[0] * (q.shape[1] // HEADS)
    return _launch(q, ckv, q_pos, scale,
                   mla_decode_splits(blocks, ckv.shape[1], n_sm))
