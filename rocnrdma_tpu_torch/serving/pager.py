"""Weight/KV page streaming over the sealed zero-copy path (the port's
own copy of ``rocnrdma_tpu/serving/pager.py``).

The serving memory model: model weights are flat f32 **pages** (one page
per transformer layer, plus the embedding and head pages — see
:mod:`.model`), sharded across ranks by ``RingWorld.owned_slice``. Each
rank keeps only its own shard resident; a page needed for compute is
streamed just-in-time into a registered scratch *window* with
``all_gather_async`` — the ring's async collective thread, so fetch k+1
rides the wire while layer k's matmuls run. Pages arrive sealed like any
other collective frame (CRC32C + generation/step/chunk-seq); a corrupt
rider on a streamed page walks the NAK/retransmit ladder and the
consumer never sees the bad bytes.

Credits ARE windows here: the :class:`~.stream.TransferEngine` gate is
sized to the scratch window count (``TDR_STREAM_DEPTH``), a fetch holds
its credit from submission until the consumer calls :meth:`release`
(the page may be pinned in scratch well after the wire work landed),
and the high-water mark proves the engine never exceeded depth.

KV-cache pages use the same engine with the zero-fill broadcast trick:
the home rank fills the window with the page payload, every other rank
zeroes it, and the ring ``allreduce_async`` sum reconstructs the home
rank's bytes on every rank — async, sealed, credit-gated, and
request-taggable, without needing a broadcast on the async collective thread.
(IEEE caveat: ``x + 0.0`` is value- but not sign-of-zero-preserving
for ``-0.0``; KV payloads only feed dot products and softmax, where
the two zeros are indistinguishable.)
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..utils.trace import trace
from .stream import TransferEngine, make_stream_coll, stream_depth

__all__ = ["PageSet", "WeightStreamer", "KVStream"]


class PageSet:
    """Named flat-f32 pages (the streamable unit).

    ``pages`` is a list of 1-D ``float32`` arrays; ``names`` labels
    them for telemetry. The set is immutable after construction — the
    streamer registers windows sized to the largest page once."""

    def __init__(self, pages: List[np.ndarray],
                 names: Optional[List[str]] = None) -> None:
        self.pages = [np.ascontiguousarray(p, dtype=np.float32).reshape(-1)
                      for p in pages]
        self.names = list(names) if names is not None else \
            [f"page{i}" for i in range(len(self.pages))]
        if len(self.names) != len(self.pages):
            raise ValueError("names/pages length mismatch")
        self.max_elems = max((int(p.size) for p in self.pages), default=0)

    def __len__(self) -> int:
        return len(self.pages)

    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.pages)


class WeightStreamer:
    """Streams weight pages ahead of compute, double(+)-buffered.

    Strict-FIFO contract: :meth:`prefetch` order must equal
    :meth:`acquire` order (the page schedule is deterministic on every
    rank — the SPMD contract the async collective thread already
    imposes). A page is valid from ``acquire`` until :meth:`release`;
    releasing returns the scratch window AND the transfer credit.

    ``world=None`` is loopback mode: pages are served from the local
    copy with no wire leg — the sequential baseline and unit tests run
    the identical consumer code with zero transport.
    """

    def __init__(self, world: Any, pages: PageSet,
                 depth: Optional[int] = None, name: str = "weights",
                 seal_step: Optional[Callable[[], int]] = None) -> None:
        self.world = world
        self.pages = pages
        self.depth = stream_depth() if depth is None else max(1, int(depth))
        self.name = name
        self.engine = TransferEngine(depth=self.depth, name=name,
                                     yield_after_launch=True)
        # Scratch windows, ring-registered ONCE (front-loaded
        # registration — steady-state fetches post work requests only).
        self._windows: List[np.ndarray] = [
            np.zeros(max(1, pages.max_elems), dtype=np.float32)
            for _ in range(self.depth)]
        self._free: Deque[int] = collections.deque(range(self.depth))
        # (page_idx, Inflight, window_idx) in flight, FIFO.
        self._inflight: Deque[Tuple[int, Any, int]] = collections.deque()
        # Acquired-and-not-yet-released pages: (window_idx, Inflight).
        self._held: List[Tuple[int, Any]] = []
        self._registered = False
        # Local shards: in wire mode each rank persists only its owned
        # slice of every page (plus the slice bounds); loopback keeps
        # whole pages.
        self._shards: List[Tuple[slice, np.ndarray]] = []
        if world is not None:
            # Front-load the window MRs once (best-effort — an
            # unregistered buffer still works, registered per call).
            ring = getattr(world, "ring", None)
            if ring is not None:
                try:
                    for w in self._windows:
                        ring.register_buffer(w)
                    self._registered = True
                except Exception:
                    pass
            for p in pages.pages:
                sl = world.owned_slice(p)
                self._shards.append((sl, p[sl].copy()))
        else:
            for p in pages.pages:
                self._shards.append((slice(0, p.size), p))
        self.fetched_pages = 0
        self.fetched_bytes = 0

    # -- fetch ------------------------------------------------------

    def prefetch(self, page_idx: int, coll: int = 0) -> None:
        """Start streaming page ``page_idx`` into the next free
        window. Blocks while all windows are pinned (credit gate) —
        which only happens when the consumer is ``depth`` pages
        behind, i.e. the stream is already fully ahead."""
        pg = self.pages.pages[page_idx]
        n = int(pg.size)

        state = {}

        def produce() -> None:
            # Pick the window under the credit we now hold. The gate
            # guarantees a free one exists: credits == windows.
            wi = self._free.popleft()
            state["wi"] = wi
            win = self._windows[wi]
            sl, shard = self._shards[page_idx]
            if self.world is None:
                win[:n] = pg
                return
            win[:n] = 0.0
            win[sl] = shard

        def launch():
            if self.world is None:
                return None
            if coll:
                self.world._seed_coll(coll)
            return self.world.all_gather_async(self._windows[state["wi"]][:n])

        # Host time of the window fill from the shard and the gather's
        # post (after any wait for a credit).
        try:
            with trace.span("serve.prefetch", page=page_idx, bytes=n * 4):
                inf = self.engine.submit(launch, produce=produce,
                                         tag=("page", page_idx),
                                         release_on_settle=False)
        except BaseException:
            if "wi" in state:
                self._free.append(state["wi"])
            raise
        self._inflight.append((page_idx, inf, state["wi"]))
        self.fetched_pages += 1
        self.fetched_bytes += n * 4
        trace.add(f"serve.pages.{self.name}", 1)

    def acquire(self, page_idx: int) -> np.ndarray:
        """Wait the oldest in-flight fetch (must be ``page_idx`` — the
        FIFO contract) and return the landed page view. The window
        stays pinned until :meth:`release`."""
        if not self._inflight:
            raise RuntimeError(f"acquire({page_idx}) with empty stream "
                               f"on {self.name!r} — prefetch first")
        idx, inf, wi = self._inflight[0]
        if idx != page_idx:
            raise RuntimeError(
                f"stream {self.name!r} is FIFO: acquire({page_idx}) but "
                f"head of stream is page {idx}")
        self._inflight.popleft()
        try:
            with trace.span("serve.page_wait", page=page_idx,
                            page_name=self.pages.names[page_idx]):
                inf.wait()
        except BaseException:
            # Failed fetch: the window is garbage — recycle it and
            # refund the credit so the NAK/heal retry can restream.
            self._free.append(wi)
            inf.release()
            raise
        n = int(self.pages.pages[page_idx].size)
        self._held.append((wi, inf))
        return self._windows[wi][:n]

    def release(self, view: np.ndarray) -> None:
        """Return an acquired page's window and credit (matched to
        the held window the view aliases)."""
        for j, (wi, inf) in enumerate(self._held):
            if np.shares_memory(self._windows[wi], view):
                self._held.pop(j)
                self._free.append(wi)
                inf.release()
                return
        raise RuntimeError(
            f"release on {self.name!r}: view aliases no held window")

    # -- teardown ---------------------------------------------------

    def close(self) -> None:
        """Drain in-flight fetches, drop held windows, refund every
        credit, release the ring registrations. Flat thread census —
        the streamer never spawned a thread."""
        while self._inflight:
            _, inf, wi = self._inflight.popleft()
            try:
                inf.wait()
            except BaseException:
                pass
            inf.release()
            self._free.append(wi)
        while self._held:
            wi, inf = self._held.pop()
            self._free.append(wi)
            inf.release()
        self.engine.close()
        if self._registered and self.world is not None:
            ring = getattr(self.world, "ring", None)
            if ring is not None:
                for w in self._windows:
                    try:
                        ring.unregister_buffer(w)
                    except Exception:
                        pass
            self._registered = False

    def stats(self) -> Dict[str, Any]:
        s = self.engine.stats()
        s.update(pages=self.fetched_pages, bytes=self.fetched_bytes,
                 windows=self.depth)
        return s


class KVStream:
    """Streams KV-cache pages between ranks on request join.

    One instance per batcher; uses its own credit-gated engine and a
    single registered window (KV joins are boundary events, not a
    steady stream — depth 1 keeps the scratch footprint at one page).

    ``broadcast(payload, home, request_id, seq)``: home rank supplies
    ``payload`` (flat f32); every rank returns a copy of home's bytes.
    Rides allreduce-of-(payload | zeros) — see the module docstring —
    so the page is sealed, NAK/retransmit-healable, and carries the
    request-tagged collective id for tdr_explain attribution."""

    def __init__(self, world: Any, max_elems: int,
                 name: str = "kv") -> None:
        self.world = world
        self.name = name
        self.engine = TransferEngine(depth=1, name=name)
        self._win = np.zeros(max(1, int(max_elems)), dtype=np.float32)
        self._registered = False
        if world is not None:
            ring = getattr(world, "ring", None)
            if ring is not None:
                try:
                    ring.register_buffer(self._win)
                    self._registered = True
                except Exception:
                    pass

    def broadcast(self, payload: Optional[np.ndarray], home: int,
                  request_id: int, seq: int, n: Optional[int] = None) -> np.ndarray:
        """All ranks call collectively. ``payload`` is required on the
        home rank (ignored elsewhere); non-home callers pass ``n`` =
        page elements (home's payload length is part of the
        deterministic schedule)."""
        if self.world is None:
            assert payload is not None
            return np.array(payload, dtype=np.float32).reshape(-1).copy()
        rank = self.world.rank
        if rank == home:
            assert payload is not None
            flat = np.asarray(payload, dtype=np.float32).reshape(-1)
            n = int(flat.size)
        else:
            if n is None:
                raise ValueError("non-home broadcast needs n")
            n = int(n)
        if n > self._win.size:
            raise ValueError(f"KV page {n} elems exceeds window "
                             f"{self._win.size}")

        def produce() -> None:
            if rank == home:
                self._win[:n] = flat
            else:
                self._win[:n] = 0.0

        coll = make_stream_coll(request_id, seq)

        def launch():
            self.world._seed_coll(coll)
            return self.world.allreduce_async(self._win[:n])

        with trace.span("serve.kv_stream", req=request_id,
                        bytes=n * 4, coll=coll):
            inf = self.engine.submit(launch, produce=produce,
                                     tag=("kv", request_id, seq))
            inf.wait()
        trace.add("serve.kv_pages", 1)
        return self._win[:n].copy()

    def close(self) -> None:
        self.engine.close()
        if self._registered and self.world is not None:
            ring = getattr(self.world, "ring", None)
            if ring is not None:
                try:
                    ring.unregister_buffer(self._win)
                except Exception:
                    pass
            self._registered = False
