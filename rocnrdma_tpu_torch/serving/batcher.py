"""Continuous batching over the paged decode path (the port's copy of
``rocnrdma_tpu/serving/batcher.py``; the decoder runs on the card).

The serving loop: a request queue with **join/evict at token
boundaries**. Every decode step is one page cycle — embed page, layer
pages, head page — streamed by the :class:`~.pager.WeightStreamer`
continuously across steps (the fetch pointer runs ahead of the compute
pointer by the credit depth, so layer k+1 is on the wire while layer
k's matmuls run, including across the step boundary). Joining requests
prefill on their **home rank** only (``id % world``) during the same
page cycle the active slots decode under — weight traffic is batch
traffic, paid once per step however many requests ride it — and the
prefill KV pages then stream to the other ranks over the sealed path
(:class:`~.pager.KVStream`), tagged with the request's collective id
so ``tdr_explain`` can attribute decode-stream stragglers per request.

SPMD contract: every rank runs the same batcher against the same
submit/evict sequence; admissions and evictions happen at deterministic
boundaries, so the collective schedule (weight gathers + KV broadcasts)
is identical fleet-wide — the same contract the trainer's bucket plan
carries, inherited rather than re-invented.

SLO accounting: ``serve.requests`` / ``serve.tokens`` counters and the
``token_lat_us`` fine histogram (rendered by the coordinator as
``tdr_serve_requests_total`` / ``tdr_serve_tokens_total`` /
``tdr_token_lat_us{quantile=}``) ride the ordinary heartbeat — no new
wire protocol.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from .. import DeviceLike
from ..utils.trace import trace
from .model import PagedDecoder, ServeConfig
from .pager import KVStream, PageSet, WeightStreamer
from .stream import make_stream_coll

__all__ = ["Request", "ContinuousBatcher"]


class Request:
    """One decode request. ``id`` must be unique and identical on all
    ranks (it keys the home-rank assignment and the wire-carried
    attribution id — 22 bits, so < 4M live ids)."""

    def __init__(self, req_id: int, prompt, max_new_tokens: int) -> None:
        self.id = int(req_id)
        self.prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.joined_step = -1
        self.done = False
        self.evicted = False
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None


class _Slot:
    def __init__(self, req: Request, cache: Dict[str, Dict[str, Any]],
                 pos: int) -> None:
        self.req = req
        self.cache = cache          # {"layer_i": {"k","v"}}
        self.pos = pos              # next cache write position
        self.x: Any = None          # per-cycle activation (device)
        self.kv_seq = 0             # per-request stream sequence


class ContinuousBatcher:
    """Continuous-batching decode over streamed weight pages.

    ``world=None`` runs loopback (single process, no transport): the
    sequential baseline and the unit tests. ``prefetch=False`` fetches
    each page on demand and waits it immediately — the non-overlapped
    baseline the bench compares against; tokens are bitwise identical
    either way (the page bytes are, and the math doesn't move).

    ``device`` is where the decoder computes: the card unless the
    caller asks for the CPU.
    """

    def __init__(self, world: Any, pages: PageSet, cfg: ServeConfig,
                 max_slots: int = 4, depth: Optional[int] = None,
                 prefetch: bool = True,
                 device: DeviceLike = "cuda") -> None:
        self.world = world
        self.cfg = cfg
        self.decoder = PagedDecoder(cfg, device)
        self.prefetch = bool(prefetch)
        self.streamer = WeightStreamer(world, pages, depth=depth,
                                       name="weights")
        kv_elems = (2 * cfg.n_kv_heads * cfg.max_seq_len * cfg.head_dim)
        self.kv = KVStream(world, max_elems=max(kv_elems, 8), name="kv")
        self.max_slots = int(max_slots)
        self.slots: List[Optional[_Slot]] = [None] * self.max_slots
        self.queue: Deque[Request] = collections.deque()
        self.finished: Dict[int, Request] = {}
        self._evict_asap: set = set()
        self.step_no = 0
        # Weight-page stream pointers: the page ORDER repeats every
        # step, so the fetch stream is just the cycled sequence.
        self._order = list(range(len(pages)))
        self._fetch_ptr = 0
        self._acq_ptr = 0
        # Wall-clock per produced token (µs), for the local p99 gate;
        # the histogram twin rides the heartbeat.
        self.token_lat_us: List[float] = []

    # ------------------------------------------------------ admission

    def submit(self, req: Request) -> None:
        """Enqueue (all ranks, identically — the SPMD contract)."""
        self.queue.append(req)
        trace.event("serve.submit", req=req.id,
                    prompt=int(req.prompt.size))

    def evict(self, req_id: int) -> None:
        """Mark a request for eviction at the next token boundary
        (all ranks, identically)."""
        self._evict_asap.add(int(req_id))

    def home_rank(self, req: Request) -> int:
        if self.world is None:
            return 0
        return req.id % self.world.world

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # ----------------------------------------------------- page stream

    def _prefetch_one(self) -> None:
        idx = self._order[self._fetch_ptr % len(self._order)]
        self._fetch_ptr += 1
        self.streamer.prefetch(idx, coll=make_stream_coll(0, self._fetch_ptr))

    def _top_up(self) -> None:
        """Fill the window budget with fetches ahead of compute —
        never blocking: only submit while a credit is demonstrably
        free (single-threaded, so the check is race-free)."""
        if not self.prefetch:
            return
        while (self.streamer.engine.gate.in_flight < self.streamer.depth
               and self._fetch_ptr - self._acq_ptr < 2 * len(self._order)):
            self._prefetch_one()

    def _acquire_next(self, expect: int):
        if not self.prefetch:
            # On-demand baseline: fetch exactly the needed page, wait.
            self._prefetch_one()
        else:
            self._top_up()
        idx = self._order[self._acq_ptr % len(self._order)]
        assert idx == expect, f"page stream out of order: {idx} != {expect}"
        self._acq_ptr += 1
        view = self.streamer.acquire(idx)
        # The page goes to the device once per step; the copy has read
        # the window when upload returns, so the window and its credit
        # go back before the compute, not after.
        page = self.decoder.upload(view)
        self.streamer.release(view)
        # Re-arm the stream while this page computes: the next fetch
        # rides the wire underneath the matmuls below.
        self._top_up()
        return page

    # ------------------------------------------------------------ step

    def step(self) -> bool:
        """One token boundary + page cycle. Returns False when there
        was nothing to do (empty queue, empty slots)."""
        # Boundary: evictions first (freeing slots), then admissions.
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            r = slot.req
            if r.id in self._evict_asap or len(r.tokens) >= r.max_new_tokens:
                r.done = True
                r.evicted = r.id in self._evict_asap and \
                    len(r.tokens) < r.max_new_tokens
                r.t_done = time.monotonic()
                self._evict_asap.discard(r.id)
                self.finished[r.id] = r
                self.slots[i] = None
                trace.event("serve.evict", req=r.id,
                            tokens=len(r.tokens),
                            evicted=bool(r.evicted))
        newly: List[_Slot] = []
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                if req.id in self._evict_asap:
                    self._evict_asap.discard(req.id)
                    req.done = req.evicted = True
                    self.finished[req.id] = req
                    continue
                cache = {f"layer_{j}": self.decoder.new_cache()
                         for j in range(self.cfg.n_layers)}
                slot = _Slot(req, cache, pos=0)
                req.joined_step = self.step_no
                self.slots[i] = slot
                newly.append(slot)
                trace.add("serve.requests", 1)
                trace.event("serve.join", req=req.id, slot=i,
                            home=self.home_rank(req),
                            prompt=int(req.prompt.size))
        live = [s for s in self.slots if s is not None]
        if not live:
            return False

        self.step_no += 1
        if self.world is not None:
            self.world.set_seal_step(self.step_no)
        rank = 0 if self.world is None else self.world.rank
        t0 = time.monotonic()

        # ---- page cycle: embed → layers → head -------------------
        # Joining slots prefill under the same pages the active slots
        # decode under (home rank computes; the other ranks hold the
        # pages for their own active-slot decode only).
        cfg, dec = self.cfg, self.decoder
        page = self._acquire_next(0)
        with trace.span("serve.compute", phase="embed", rank=rank):
            for s in live:
                if s in newly:
                    if self.home_rank(s.req) == rank:
                        s.x = dec.embed(page, s.req.prompt)
                else:
                    s.x = dec.embed(page, np.array([s.req.tokens[-1]]))

        for li in range(cfg.n_layers):
            page = self._acquire_next(1 + li)
            with trace.span("serve.compute", phase="layer", layer=li,
                            rank=rank):
                for s in live:
                    if s.x is None:
                        continue  # joining slot on a non-home rank
                    s.x = dec.layer(page, s.x, s.cache[f"layer_{li}"],
                                    s.pos)

        page = self._acquire_next(len(self._order) - 1)
        with trace.span("serve.compute", phase="head", rank=rank):
            for s in live:
                if s.x is None:
                    continue
                logits = dec.head(page, s.x)
                tok = int(torch.argmax(logits[-1]))
                s.req.tokens.append(tok)
                if s.req.t_first is None:
                    s.req.t_first = time.monotonic()
                s.x = None

        # ---- KV join streaming (boundary events, request-tagged) --
        for s in newly:
            self._stream_join(s, rank)

        # Advance positions; account the step's tokens.
        produced = 0
        for s in live:
            s.pos += s.req.prompt.size if s in newly else 1
            produced += 1
        dt_us = (time.monotonic() - t0) * 1e6 / max(1, produced)
        for _ in range(produced):
            self.token_lat_us.append(dt_us)
            trace.hist("token_lat_us", int(dt_us))
        trace.add("serve.tokens", produced)
        return True

    def _stream_join(self, slot: _Slot, rank: int) -> None:
        """Ship the joining request's prefill KV (and its first token)
        from its home rank to every rank, one sealed page per layer
        plus a meta page — every page carries the request-tagged
        collective id (bit 62 | req<<40 | seq)."""
        req, cfg = slot.req, self.cfg
        home = self.home_rank(req)
        p = int(req.prompt.size)
        kvn = cfg.n_kv_heads * p * cfg.head_dim
        with trace.span("serve.request_join", req=req.id, home=home,
                        rank=rank):
            for li in range(cfg.n_layers):
                c = slot.cache[f"layer_{li}"]
                payload = None
                if rank == home:
                    payload = self.decoder.dump_kv(c, p)
                slot.kv_seq += 1
                got = self.kv.broadcast(payload, home, req.id,
                                        slot.kv_seq, n=2 * kvn)
                if rank != home:
                    self.decoder.load_kv(
                        c,
                        got[:kvn].reshape(cfg.n_kv_heads, p,
                                          cfg.head_dim),
                        got[kvn:].reshape(cfg.n_kv_heads, p,
                                          cfg.head_dim), p)
            meta = None
            if rank == home:
                meta = np.array([float(req.tokens[-1])], np.float32)
            slot.kv_seq += 1
            got = self.kv.broadcast(meta, home, req.id, slot.kv_seq, n=1)
            if rank != home:
                tok = int(got[0])
                req.tokens.append(tok)
                if req.t_first is None:
                    req.t_first = time.monotonic()

    # ------------------------------------------------------------- run

    def run(self, max_steps: int = 10000) -> int:
        """Drive steps until idle; returns steps executed."""
        n = 0
        while n < max_steps and (self.queue or self.active):
            if not self.step():
                break
            n += 1
        return n

    def close(self) -> None:
        """Drain the streams and free the windows (flat thread
        census; every credit refunded)."""
        self.streamer.close()
        self.kv.close()

    def stats(self) -> Dict[str, Any]:
        return {
            "steps": self.step_no,
            "active": self.active,
            "queued": len(self.queue),
            "finished": len(self.finished),
            "weights": self.streamer.stats(),
            "kv": self.kv.engine.stats(),
        }
