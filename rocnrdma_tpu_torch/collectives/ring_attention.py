"""Ring attention: sequence-parallel attention over the RDMA transport.

Counterpart of ``rocnrdma_tpu/collectives/ring_attention.py``, with the
same schedule, wire tags and buffer layout, so a JAX rank and a torch
rank can share one ring.

The sequence is sharded contiguously across ranks: rank r holds
positions ``[r * S_local, (r + 1) * S_local)``. Each rank keeps its Q
shard and the K/V shards rotate rightward around the ring over the
world's ``left_qp``/``right_qp``, through two registered host buffers
used in turn. After ``world - 1`` rotations every rank has attended its
queries against the whole sequence.

Partial results over disjoint kv shards merge exactly through their
log-sum-exps, in f32 with the running max subtracted:

    out = (out_a·e^{lse_a} + out_b·e^{lse_b}) / (e^{lse_a} + e^{lse_b})
    lse = logaddexp(lse_a, lse_b)

Causality with contiguous shards is block-triangular: a past shard
(j < r) is attended in full, the rank's own shard causally, a future
shard (j > r) not at all (its rotation still happens, so the ring stays
in lockstep).

The rotation for shard j+1 is posted before the compute on shard j, so
the wire hides behind the kernel; ``TDR_RA_NO_OVERLAP=1`` gives the
serial schedule (rotate, then compute). The backward has two channels:
the K/V shard, prefetched as in the forward, and the f32 dK/dV
accumulator, which the compute produces, so its rotation trails by one
step; its region sits after the K/V bytes in the same registration, and
its last rotation brings each shard's summed gradient home.

Where the kernels run: every attention goes through
:func:`~rocnrdma_tpu_torch.ops.attention.flash_attention_lse` (K3 on CUDA
tensors) and every pair gradient through
:func:`~rocnrdma_tpu_torch.ops.attention.flash_attention_shard_grads`
(K5 then K4), driven by the merged global ``out`` and ``lse``; CPU
tensors take their plain versions. The lse merge, the f32 dq sum and
the accumulator's f32 add are plain torch, as they are plain ``jnp`` and
numpy in the JAX package.

Host bounces: on the card the rotation buffers are pinned CPU tensors.
Every copy into or out of them is synchronous, so a D2H has landed
before its bytes are posted, and a received shard has been copied out
before a later rotation receives into the same buffer. Each bounce is
charged to ``collectives.staging``.

Concurrency contract: ONE collective at a time per world; ring
attention posts directly on the world's QPs. A per-call nonce in the
wr_id tag bits keeps sequential calls (a forward and a later backward,
or two instances alternating on one world) from matching each other's
completions.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import List, Optional, Tuple

import torch

from ..ops.attention import flash_attention_lse, flash_attention_shard_grads
from ..transport.engine import TransportError
from ..utils.trace import trace
from .staging import staging

__all__ = ["RingAttention", "ring_attention"]

# wr_id tag space for the rotation ('RA'), the JAX package's: distinct
# from the ring allreduce's and the schedule digest's ids. Below the
# 16-bit marker: [12-bit nonce @ bit 36][2-bit channel @ bit 34]
# [34-bit step @ bit 0].
_WR_RA_RECV = 0x5241 << 48
_WR_RA_SEND = 0x5253 << 48
_CH_KV = 0
_CH_ACC = 1

# Per-process nonce source shared by all instances.
_NONCE = itertools.count(1)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RingAttention:
    """Sequence-parallel flash attention over a
    :class:`~rocnrdma_tpu_torch.collectives.world.RingWorld`.

    The two rotation buffers are registered once (sized to the first
    call's shard, K/V bytes plus the f32 dK/dV accumulators) and reused
    by both passes; each rotation posts one receive and one send."""

    def __init__(self, world, timeout_ms: int = 30000):
        self.world = world
        self.timeout_ms = timeout_ms
        self._bufs: Optional[List[torch.Tensor]] = None
        self._mrs: Optional[list] = None
        self._nbytes = 0
        self._pinned = False
        # Pinned landing for a pair's f32 dK/dV partials on the card.
        self._partials: Optional[torch.Tensor] = None
        self._tag = 0
        # Seconds the LAST call blocked in transport waits, and its whole
        # time.
        self.last_wait_s = 0.0
        self.last_total_s = 0.0
        # The same summed over calls since reset_totals(), with the calls
        # and the bytes this rank sent (a trainer's per-step account).
        self.reset_totals()

    def reset_totals(self) -> None:
        self.totals = {"calls": 0, "wait_s": 0.0, "total_s": 0.0,
                       "wire_bytes": 0}

    def _tally(self) -> None:
        t = self.totals
        t["calls"] += 1
        t["wait_s"] += self.last_wait_s
        t["total_s"] += self.last_total_s

    # ------------------------------------------------------- plumbing

    def _ensure_buffers(self, nbytes: int, pinned: bool) -> None:
        if (self._bufs is not None and nbytes == self._nbytes
                and pinned == self._pinned):
            return
        self.close()
        self._bufs = [torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=pinned) for _ in range(2)]
        self._mrs = [self.world.engine.reg_mr(b) for b in self._bufs]
        self._nbytes = nbytes
        self._pinned = pinned

    def close(self) -> None:
        if self._mrs is not None:
            for mr in self._mrs:
                mr.deregister()
        self._bufs = None
        self._mrs = None
        self._partials = None
        self._nbytes = 0

    def _new_call(self) -> None:
        self._tag = (next(_NONCE) & 0xFFF) << 36
        self.last_wait_s = 0.0

    def _wrid(self, base: int, ch: int, step: int) -> int:
        return base | self._tag | (ch << 34) | step

    def _post_rot(self, ch: int, step: int, cur: int, off: int,
                  nbytes: int) -> None:
        """Send ``nbytes`` at ``off`` of buffer ``cur`` rightward and
        receive the left neighbour's into the same region of the other
        buffer; :meth:`_wait_rot` collects the completions."""
        w = self.world
        w.left_qp.post_recv(self._mrs[1 - cur], off, nbytes,
                            wr_id=self._wrid(_WR_RA_RECV, ch, step))
        w.right_qp.post_send(self._mrs[cur], off, nbytes,
                             wr_id=self._wrid(_WR_RA_SEND, ch, step))
        self.totals["wire_bytes"] += nbytes

    def _wait_rot(self, ch: int, step: int, nbytes: int) -> None:
        t0 = time.perf_counter()
        w = self.world
        if not w.right_qp.wait(self._wrid(_WR_RA_SEND, ch, step),
                               timeout_ms=self.timeout_ms).ok:
            raise TransportError(
                f"ring-attention send failed @ch{ch} step {step}")
        wc = w.left_qp.wait(self._wrid(_WR_RA_RECV, ch, step),
                            timeout_ms=self.timeout_ms)
        if not wc.ok:
            raise TransportError(
                f"ring-attention recv failed @ch{ch} step {step}")
        if wc.length != nbytes:
            raise TransportError(
                f"ring-attention shard mismatch @ch{ch} step {step}: "
                f"received {wc.length} bytes, expected {nbytes} — all "
                "ranks must hold equally-sized contiguous shards")
        self.last_wait_s += time.perf_counter() - t0

    @staticmethod
    def _overlap_enabled() -> bool:
        return os.environ.get("TDR_RA_NO_OVERLAP", "0") in ("", "0")

    # ---------------------------------------------------- buffer layout

    @staticmethod
    def _acc_bytes(k: torch.Tensor, v: torch.Tensor) -> int:
        """The f32 dK + dV accumulator region, sized from k and v each."""
        return 4 * (k.numel() + v.numel())

    def _pack_kv(self, k: torch.Tensor, v: torch.Tensor) -> int:
        """This rank's K then V bytes into buffer 0 (a synchronous D2H on
        the card); returns their byte count."""
        kb, vb = _nbytes(k), _nbytes(v)
        self._ensure_buffers(kb + vb + self._acc_bytes(k, v), k.is_cuda)
        ks, vs = self._kv_views(0, k, v)
        ks.copy_(k)
        vs.copy_(v)
        staging.add(kb + vb)
        return kb + vb

    def _kv_views(self, idx: int, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K/V views of buffer ``idx``, shaped and typed as k and v: the
        one definition of the packing layout."""
        raw = self._bufs[idx]
        kb, vb = _nbytes(k), _nbytes(v)
        return (raw[:kb].view(k.dtype).view(k.shape),
                raw[kb:kb + vb].view(v.dtype).view(v.shape))

    def _acc_views(self, idx: int, kv_bytes: int, k: torch.Tensor,
                   v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dK, dV) f32 views of buffer ``idx``'s accumulator region."""
        f32 = self._bufs[idx][kv_bytes:kv_bytes + self._acc_bytes(k, v)] \
            .view(torch.float32)
        return (f32[:k.numel()].view(k.shape),
                f32[k.numel():].view(v.shape))

    def _shard_kv(self, idx: int, k: torch.Tensor, v: torch.Tensor):
        """A received K/V shard copied out of buffer ``idx`` onto k's
        device (a synchronous H2D on the card, a copy on the CPU), so
        the next rotation may land in that buffer."""
        ks, vs = self._kv_views(idx, k, v)
        staging.add(_nbytes(k) + _nbytes(v))
        return (ks.to(k.device, copy=True), vs.to(v.device, copy=True))

    # ------------------------------------------------------------ fwd

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """q (B, H, S_local, D), k/v (B, KVH, S_local, D): this rank's
        contiguous shards. Returns ``(out, lse)``: this rank's output
        attending the whole global sequence, in q's dtype, and the
        merged f32 log-sum-exp (B, H, S_local, 1), the residuals
        :meth:`backward` takes."""
        t_start = time.perf_counter()
        self._new_call()
        rank, world = self.world.rank, self.world.world
        k, v = k.contiguous(), v.contiguous()
        kv_bytes = self._pack_kv(k, v)
        overlap = self._overlap_enabled()
        cur = 0
        # Rotation 1 rides the wire while the local shard's kernel runs.
        if world > 1 and overlap:
            self._post_rot(_CH_KV, 1, cur, 0, kv_bytes)

        out, lse = flash_attention_lse(q, k, v, causal)
        out = out.float()
        used = 1
        for step in range(1, world):
            if not overlap:
                self._post_rot(_CH_KV, step, cur, 0, kv_bytes)
            self._wait_rot(_CH_KV, step, kv_bytes)
            cur = 1 - cur
            j = (rank - step) % world
            skip = causal and j > rank
            if not skip:
                ks, vs = self._shard_kv(cur, k, v)
            # The received shard is copied out (or skipped): rotation
            # step+1 posts now and rides the wire under this shard's
            # kernel.
            if overlap and step + 1 < world:
                self._post_rot(_CH_KV, step + 1, cur, 0, kv_bytes)
            if skip:
                continue
            # A remote past shard is attended in full: the causal
            # boundary cuts only the diagonal shard.
            o_i, l_i = flash_attention_lse(q, ks, vs, False)
            m = torch.maximum(lse, l_i)
            a = torch.exp(lse - m)
            b = torch.exp(l_i - m)
            out = (out * a + o_i.float() * b) / (a + b)
            lse = m + torch.log(a + b)
            used += 1
        self.last_total_s = time.perf_counter() - t_start
        self._tally()
        trace.event("ring_attention", rank=rank, world=world,
                    shards_attended=used, rotations=world - 1,
                    overlap=int(overlap),
                    wait_s=round(self.last_wait_s, 6),
                    total_s=round(self.last_total_s, 6))
        return out.to(q.dtype), lse

    # ------------------------------------------------------------ bwd

    def _add_partials(self, acc_cur: int, kv_bytes: int, k, v, dk_c,
                      dv_c) -> None:
        """acc += this pair's dK/dV partials, in f32 on the host (a
        synchronous D2H into a pinned landing on the card)."""
        dk_acc, dv_acc = self._acc_views(acc_cur, kv_bytes, k, v)
        staging.add(self._acc_bytes(k, v))
        if dk_c.is_cuda:
            if self._partials is None:
                self._partials = torch.empty(k.numel() + v.numel(),
                                             dtype=torch.float32,
                                             pin_memory=True)
            pk = self._partials[:k.numel()].view(k.shape)
            pv = self._partials[k.numel():].view(v.shape)
            pk.copy_(dk_c.float())
            pv.copy_(dv_c.float())
            dk_c, dv_c = pk, pv
        dk_acc.add_(dk_c.float())
        dv_acc.add_(dv_c.float())

    def backward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(dq, dk, dv) for this rank's shards from the forward's
        ``(out, lse)`` and the local output cotangent ``do``.

        With the GLOBAL lse (and delta = rowsum(dO∘out), inside the
        pair backward) each (q shard, kv shard) pair's flash backward
        is that pair's exact share of the full-attention gradient: dq
        sums here in f32, dK/dV partials accumulate in the rotating
        accumulator and arrive home after ``world`` rotations."""
        t_start = time.perf_counter()
        self._new_call()
        rank, world = self.world.rank, self.world.world
        k, v = k.contiguous(), v.contiguous()
        kv_bytes = self._pack_kv(k, v)
        acc_bytes = self._acc_bytes(k, v)
        overlap = self._overlap_enabled()
        # Both accumulator regions start zeroed: buffer 0's carries the
        # shard-``rank`` accumulator out first, buffer 1's receives and
        # must hold no bytes of an earlier call.
        for b in self._bufs:
            b[kv_bytes:kv_bytes + acc_bytes].zero_()
        kv_cur = 0
        acc_cur = 0
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

        ks, vs = k, v
        if world > 1 and overlap:
            self._post_rot(_CH_KV, 1, kv_cur, 0, kv_bytes)

        for step in range(world):
            j = (rank - step) % world
            visible = not (causal and j > rank)
            if visible:
                dq_c, dk_c, dv_c = flash_attention_shard_grads(
                    q, ks, vs, out, lse, do, causal=causal and j == rank)
                dq = dq + dq_c.float()
            # Collect the trailing acc rotation (step-1), the partials of
            # shard j from the ranks that held it before, BEFORE adding
            # this rank's. In the overlap schedule this wait follows the
            # pair's kernels, which is what hides it.
            if overlap and step > 0:
                self._wait_rot(_CH_ACC, step - 1, acc_bytes)
                acc_cur = 1 - acc_cur
            if visible:
                self._add_partials(acc_cur, kv_bytes, k, v, dk_c, dv_c)
            # Send the accumulator on: rank r+1 holds shard j next step.
            self._post_rot(_CH_ACC, step, acc_cur, kv_bytes, acc_bytes)
            if not overlap:
                self._wait_rot(_CH_ACC, step, acc_bytes)
                acc_cur = 1 - acc_cur
            if step + 1 < world:
                if not overlap:
                    self._post_rot(_CH_KV, step + 1, kv_cur, 0, kv_bytes)
                self._wait_rot(_CH_KV, step + 1, kv_bytes)
                kv_cur = 1 - kv_cur
                nj = (rank - (step + 1)) % world
                if not (causal and nj > rank):
                    ks, vs = self._shard_kv(kv_cur, k, v)
                if overlap and step + 2 < world:
                    self._post_rot(_CH_KV, step + 2, kv_cur, 0, kv_bytes)
        if overlap:
            # The homecoming acc rotation is the one still outstanding.
            self._wait_rot(_CH_ACC, world - 1, acc_bytes)
            acc_cur = 1 - acc_cur

        home_dk, home_dv = self._acc_views(acc_cur, kv_bytes, k, v)
        staging.add(acc_bytes)
        self.last_total_s = time.perf_counter() - t_start
        self._tally()
        trace.event("ring_attention.bwd", rank=rank, world=world,
                    overlap=int(overlap),
                    wait_s=round(self.last_wait_s, 6),
                    total_s=round(self.last_total_s, 6))
        # Copies, never views: the next call zeroes and rotates these
        # very bytes.
        return (dq.to(q.dtype),
                home_dk.to(k.device, k.dtype, copy=True),
                home_dv.to(v.device, v.dtype, copy=True))


class _RingAttentionFn(torch.autograd.Function):
    """Autograd over one ring call: the forward saves ``(q, k, v, out,
    lse)``, the backward runs :meth:`RingAttention.backward`."""

    @staticmethod
    def forward(ctx, ra, q, k, v, causal):
        out, lse = ra.forward(q, k, v, causal)
        ctx.ra, ctx.causal = ra, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.ra.backward(q, k, v, out, lse, do.contiguous(),
                                     ctx.causal)
        return None, dq, dk, dv, None


def ring_attention(ra: RingAttention, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """This rank's attention output through ``ra``, differentiable in q,
    k and v: the backward is one more collective, so every rank must
    run its backward too, layer for layer in the same order."""
    return _RingAttentionFn.apply(ra, q, k, v, causal)
