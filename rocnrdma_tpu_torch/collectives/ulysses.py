"""Ulysses sequence parallelism: all-to-all head↔sequence resharding
over the transport.

Counterpart of ``rocnrdma_tpu/collectives/ulysses.py``, the second
long-context strategy beside
:class:`~rocnrdma_tpu_torch.collectives.ring_attention.RingAttention`.
Instead of rotating K/V shards while queries stay put, q, k and v each
reshard once: an all-to-all turns the sequence-sharded layout (every
rank: all heads, S_local contiguous positions) into a head-sharded one
(every rank: H/W heads, the whole sequence), flash attention runs on
the whole sequence for that head subset (K3 on CUDA tensors), and a
second all-to-all brings the output home. The backward reshards q, k,
v and dO again, recomputes the head-sharded forward (K3), takes its
gradients from the recomputed ``out`` and ``lse`` (K5 then K4, as the
kernels' autograd backward does) and reshards dq, dk, dv home.

The resharding rides ``RingWorld.all_to_all`` (the native ring's
bundle-shrink schedule, which stages its wire traffic through the
ring's own scratch MR), with one reused host buffer per distinct tensor
size here; every host bounce is charged to ``collectives.staging``.

Layout contract (the ring's): rank r holds the r-th contiguous
sequence block. Segment j of a sequence→head buffer carries head block
j of the local shard; after the exchange it holds this rank's head
block of sequence block j. Both head counts must divide the world.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from ..ops.attention import flash_attention_lse, flash_attention_shard_grads
from ..utils.trace import trace
from .staging import staging

__all__ = ["UlyssesAttention", "ulysses_attention"]


class UlyssesAttention:
    """All-to-all sequence-parallel attention over a
    :class:`~rocnrdma_tpu_torch.collectives.world.RingWorld`.

    ``forward(q, k, v)`` takes this rank's sequence shard with all heads
    (q (B, H, S_local, D), k/v (B, KVH, S_local, D)) and returns its
    output (B, H, S_local, D). All ranks call collectively."""

    def __init__(self, world):
        self.world = world
        # nbytes -> reused uint8 host buffer; safe because each call
        # consumes its buffer before the next reshard begins.
        self._bufs: Dict[int, torch.Tensor] = {}
        # Seconds the LAST forward()/backward() spent resharding (D2H,
        # pack, all-to-all, unpack, H2D): the strategy's transport cost.
        self.last_reshard_s = 0.0
        # The same summed over calls since reset_totals(), with the calls
        # and the bytes this rank sent (a trainer's per-step account).
        self.reset_totals()

    def reset_totals(self) -> None:
        self.totals = {"calls": 0, "reshard_s": 0.0, "wire_bytes": 0}

    def _tally(self) -> None:
        self.totals["calls"] += 1
        self.totals["reshard_s"] += self.last_reshard_s

    # ------------------------------------------------------- resharding

    @staticmethod
    def _fence(t: torch.Tensor) -> None:
        """Wait for ``t``'s producer, so the kernel's time does not leak
        into ``last_reshard_s``."""
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    def _staging(self, nbytes: int, pinned: bool) -> torch.Tensor:
        buf = self._bufs.get(nbytes)
        if buf is None or buf.is_pinned() != pinned:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
            self._bufs[nbytes] = buf
        return buf

    def _check(self, h: int, label: str) -> int:
        w = self.world.world
        if h % w != 0:
            raise ValueError(
                f"ulysses: {label}={h} must divide by world={w}")
        return h // w

    def _exchange(self, x: torch.Tensor, axis: int,
                  cat_axis: int) -> torch.Tensor:
        """Split ``x`` into ``world`` blocks along ``axis``, send block j
        to rank j, and concatenate what arrives along ``cat_axis`` in
        rank order, back on x's device."""
        self._fence(x)
        t0 = time.perf_counter()
        w = self.world.world
        nbytes = x.numel() * x.element_size()
        buf = self._staging(nbytes, x.is_cuda)
        segb = nbytes // w
        for j, block in enumerate(x.chunk(w, dim=axis)):
            # D2H of each block straight into its segment.
            buf[j * segb:(j + 1) * segb].view(x.dtype).view(
                block.shape).copy_(block)
        staging.add(2 * nbytes)  # D2H above + H2D below
        self.world.all_to_all(buf)
        # Bundle-shrink ring: segment j travels (j - rank) mod w hops, so
        # a rank sends w(w-1)/2 segments.
        self.totals["wire_bytes"] += segb * w * (w - 1) // 2
        shape = list(x.shape)
        shape[axis] //= w
        # H2D of the whole buffer, then the blocks join on the device
        # (on the CPU the join is the copy out of the buffer).
        blocks = buf.view(x.dtype).view([w] + shape).to(x.device)
        out = torch.cat([blocks[j] for j in range(w)], dim=cat_axis)
        self._fence(out)
        self.last_reshard_s += time.perf_counter() - t0
        return out

    def _seq_to_head(self, x: torch.Tensor,
                     label: str = "heads") -> torch.Tensor:
        """(B, h, S_local, D) sequence-sharded → (B, h/W, W*S_local, D)
        head-sharded. ``label`` names the head axis in the
        indivisibility error ('q heads' or 'kv heads')."""
        self._check(x.shape[1], label)
        return self._exchange(x, axis=1, cat_axis=2)

    def _head_to_seq(self, y: torch.Tensor) -> torch.Tensor:
        """(B, h/W, W*S_local, D) head-sharded → (B, h, S_local, D)
        sequence-sharded, the exact inverse: segment j carries sequence
        block j of the local head subset."""
        w = self.world.world
        if y.shape[2] % w != 0:
            raise ValueError(f"ulysses: global sequence {y.shape[2]} must "
                             f"divide by world={w}")
        return self._exchange(y, axis=2, cat_axis=1)

    # ------------------------------------------------------- attention

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
        """Sequence-parallel attention output for this rank's shard."""
        self.last_reshard_s = 0.0
        qf = self._seq_to_head(q, "q heads")
        kf = self._seq_to_head(k, "kv heads")
        vf = self._seq_to_head(v, "kv heads")
        out = self._head_to_seq(flash_attention_lse(qf, kf, vf, causal)[0])
        self._tally()
        trace.event("ulysses.forward", rank=self.world.rank,
                    world=self.world.world, heads_local=qf.shape[1],
                    seq_global=qf.shape[2])
        return out

    def backward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, causal: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Exact (dq, dk, dv) for this rank's shard: the head-sharded
        forward is recomputed and differentiated, and the gradients
        reshard home through the same all-to-alls."""
        self.last_reshard_s = 0.0
        qf = self._seq_to_head(q, "q heads")
        kf = self._seq_to_head(k, "kv heads")
        vf = self._seq_to_head(v, "kv heads")
        df = self._seq_to_head(dout, "q heads")
        out, lse = flash_attention_lse(qf, kf, vf, causal)
        dqf, dkf, dvf = flash_attention_shard_grads(qf, kf, vf, out, lse,
                                                    df, causal)
        dq = self._head_to_seq(dqf)
        dk = self._head_to_seq(dkf)
        dv = self._head_to_seq(dvf)
        self._tally()
        trace.event("ulysses.backward", rank=self.world.rank,
                    world=self.world.world)
        return dq, dk, dv

    def close(self) -> None:
        self._bufs.clear()


class _UlyssesFn(torch.autograd.Function):
    """Autograd over one Ulysses call: the forward saves ``(q, k, v)``,
    the backward runs :meth:`UlyssesAttention.backward`."""

    @staticmethod
    def forward(ctx, ua, q, k, v, causal):
        ctx.ua, ctx.causal = ua, causal
        ctx.save_for_backward(q, k, v)
        return ua.forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ctx.ua.backward(q, k, v, do.contiguous(), ctx.causal)
        return None, dq, dk, dv, None


def ulysses_attention(ua: UlyssesAttention, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """This rank's attention output through ``ua``, differentiable in
    q, k and v (the backward is two more rounds of all-to-alls)."""
    return _UlyssesFn.apply(ua, q, k, v, causal)
