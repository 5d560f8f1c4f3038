"""Accelerator-memory pin lifecycle — the peer-memory state machine.

The port's own copy of ``rocnrdma_tpu/hbm/registry.py``; its
counterpart of ``TPUExporter`` is ``hbm.cuda.CUDAExporter``.

This layer re-creates, TPU-side and in a testable form, the contract
stack of the reference:

- ``MemoryExporter`` plays the role of the AMD KFD RDMA interface
  (``struct amd_rdma_interface``: is_gpu_address / get_pages /
  put_pages / get_page_size, SURVEY.md §2 component 7), extended with
  the modern ``export_dmabuf`` the build plan prescribes (SURVEY.md §7).
- ``PeerClient`` plays the role of the amdp2p bridge itself
  (``amdp2p.c``): the acquire → get_pages → dma_map → put_pages →
  release state machine, including the asynchronous revocation
  handshake (free-while-registered, ``amdp2p.c:88-109``) guarded by a
  ``revoked`` flag so a later put_pages never double-frees
  (``amdp2p.c:299-302``).
- ``RegistrationManager`` glues pins to transport MRs and owns
  cleanup-on-close, mirroring the test module's per-fd pinned-range
  list and release path (``tests/amdp2ptest.c:55-65, 115-139``).

Unlike the reference, all of this is exercised hardware-free through
``FakeHBMExporter`` (host memory masquerading as HBM — the "fake L2
backend" SURVEY.md §4 calls for), while ``TPUExporter`` binds the same
contract to real JAX arrays on TPU.
"""

from __future__ import annotations

import mmap
import os
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from rocnrdma_tpu_torch.utils.trace import trace

DEFAULT_PAGE_SIZE = 4096  # the reference's fallback, amdp2p.c:339


class HbmError(RuntimeError):
    pass


@dataclass
class PinnedPages:
    """A pinned range — the analogue of ``struct amd_p2p_info``
    (va / size / sg_table of bus addresses, read at amdp2p.c:258-261
    and tests/amdp2ptest.c:362-368)."""

    va: int
    size: int
    # (bus_address, length) pairs — the prebuilt "sg table".
    pages: List[Tuple[int, int]]
    exporter: "MemoryExporter"
    dmabuf_fd: Optional[int] = None  # modern export path
    dmabuf_offset: int = 0
    _released: bool = False


class MemoryExporter:
    """The L2 contract (what ``drm/amd_rdma.h`` declared for KFD)."""

    def __init__(self) -> None:
        # Dead-gap registry: start -> end for ranges proved to hold no
        # live data (alignment padding a DeviceArena skipped). Consulted
        # by the zero-copy collective before coalescing across a gap.
        self._dead: Dict[int, int] = {}
        self._dead_lock = threading.Lock()

    def mark_gap_dead(self, start: int, end: int) -> None:
        """Record [start, end) as dead padding inside an allocation —
        bytes no live data will ever occupy. The zero-copy collective
        only coalesces adjacent leaves across gaps proved dead here:
        reducing a gap holding live data (e.g. optimizer state carved
        between two gradient leaves) would silently overwrite it with
        the cross-rank sum."""
        if end <= start:
            return
        with self._dead_lock:
            self._dead[start] = max(end, self._dead.get(start, end))

    def is_gap_dead(self, start: int, end: int) -> bool:
        """True when [start, end) is fully covered by dead padding."""
        if end <= start:
            return True
        with self._dead_lock:
            pos = start
            # Linear scan: padding counts are tiny (one per arena leaf).
            while pos < end:
                nxt = None
                for s, e in self._dead.items():
                    if s <= pos < e:
                        nxt = e
                        break
                if nxt is None:
                    return False
                pos = nxt
            return True

    def _drop_dead_gaps_in(self, start: int, end: int) -> None:
        """Forget dead ranges inside a freed allocation — its VA range
        may be recycled by the allocator for live data."""
        with self._dead_lock:
            for s in [s for s in self._dead if start <= s < end]:
                del self._dead[s]

    def is_device_address(self, va: int, size: int = 1) -> bool:
        raise NotImplementedError

    def get_pages(
        self,
        va: int,
        size: int,
        free_callback: Optional[Callable[[object], None]] = None,
        client_priv: object = None,
    ) -> PinnedPages:
        """Pin [va, va+size); optional free_callback fires if the
        owner frees the memory while pinned (amd_rdma get_pages's
        free_callback argument, used at amdp2p.c:200-205)."""
        raise NotImplementedError

    def put_pages(self, pinned: PinnedPages) -> None:
        raise NotImplementedError

    def get_page_size(self, va: int) -> int:
        raise NotImplementedError

    def export_dmabuf(self, pinned: PinnedPages) -> Tuple[int, int]:
        """Return (fd, offset) exposing the pinned range as dma-buf.
        Raises HbmError where unsupported (legacy sg-list path only)."""
        raise HbmError("dma-buf export not supported by this exporter")


class FakeHBMExporter(MemoryExporter):
    """Host memory standing in for TPU HBM.

    Allocations are memfd-backed so the dma-buf export path is real
    (an fd another subsystem can map), and "bus addresses" are the CPU
    addresses — the same simplification the reference relies on when it
    skips IOMMU mapping and trusts KFD's prebuilt sg entries
    (amdp2p.c:222-240).
    """

    def __init__(self, page_size: int = DEFAULT_PAGE_SIZE):
        super().__init__()
        self.page_size = page_size
        self._lock = threading.Lock()
        # va -> (fd, mmap object, size)
        self._allocs: Dict[int, Tuple[int, mmap.mmap, int]] = {}
        # pin bookkeeping: id(pinned) -> (pinned, free_cb, priv)
        self._pins: Dict[int, Tuple[PinnedPages, Optional[Callable], object]] = {}

    def alloc(self, size: int) -> int:
        size = max(size, 1)
        fd = os.memfd_create("fake-hbm", 0)
        os.ftruncate(fd, size)
        m = mmap.mmap(fd, size)
        import ctypes

        va = ctypes.addressof(ctypes.c_char.from_buffer(m))
        with self._lock:
            self._allocs[va] = (fd, m, size)
        trace.event("hbm.alloc", va=va, bytes=size)
        return va

    def free(self, va: int) -> None:
        """Free an allocation. Any pins covering it get their
        free_callback fired first — the KFD-initiated teardown that
        drives amdp2p's revocation flow (SURVEY.md §3.4)."""
        with self._lock:
            if va not in self._allocs:
                raise HbmError(f"free of unknown va {va:#x}")
            fd, m, size = self._allocs[va]
            doomed = [
                (p, cb, priv)
                for (p, cb, priv) in self._pins.values()
                if p.va >= va and p.va < va + size and not p._released
            ]
        for pinned, cb, priv in doomed:
            if cb is not None:
                # Callback runs outside the lock, in "arbitrary context"
                # exactly like the reference's free_callback.
                cb(priv)
            with self._lock:
                pinned._released = True
                self._pins.pop(id(pinned), None)
        with self._lock:
            del self._allocs[va]
        self._drop_dead_gaps_in(va, va + size)
        try:
            m.close()
        except BufferError:
            # Still-exported buffers (e.g. a live ctypes view) keep the
            # mapping alive; the fd close below drops our reference.
            pass
        os.close(fd)
        trace.event("hbm.free", va=va, revoked=len(doomed))

    def _containing(self, va: int) -> Optional[Tuple[int, int, mmap.mmap, int]]:
        for base, (fd, m, size) in self._allocs.items():
            if base <= va < base + size:
                return base, fd, m, size
        return None

    def is_device_address(self, va: int, size: int = 1) -> bool:
        with self._lock:
            hit = self._containing(va)
            if hit is None:
                return False
            base, _, _, alloc_size = hit
            return va + size <= base + alloc_size

    def get_pages(self, va, size, free_callback=None, client_priv=None):
        with self._lock:
            hit = self._containing(va)
            if hit is None or va + size > hit[0] + hit[3]:
                raise HbmError(f"get_pages: [{va:#x},+{size}) not device memory")
            base, fd, m, _ = hit
            pages = []
            off = va
            end = va + size
            while off < end:
                page_end = (off // self.page_size + 1) * self.page_size
                chunk = min(end, page_end) - off
                pages.append((off, chunk))
                off += chunk
            pinned = PinnedPages(va=va, size=size, pages=pages, exporter=self,
                                 dmabuf_fd=fd, dmabuf_offset=va - base)
            self._pins[id(pinned)] = (pinned, free_callback, client_priv)
        trace.event("hbm.get_pages", va=va, bytes=size, nents=len(pages))
        return pinned

    def put_pages(self, pinned: PinnedPages) -> None:
        with self._lock:
            if pinned._released:
                # Double unpin after revocation must be harmless —
                # exactly the amdp2p.c:299-302 guard's contract.
                return
            pinned._released = True
            self._pins.pop(id(pinned), None)
        trace.event("hbm.put_pages", va=pinned.va)

    def get_page_size(self, va: int) -> int:
        return self.page_size

    def export_dmabuf(self, pinned: PinnedPages) -> Tuple[int, int]:
        if pinned.dmabuf_fd is None:
            raise HbmError("no dma-buf behind this pin")
        return pinned.dmabuf_fd, pinned.dmabuf_offset

    def live_pins(self) -> int:
        with self._lock:
            return len(self._pins)


def as_ndarray(va: int, shape, dtype):
    """View exporter ("HBM") memory at ``va`` as a numpy array.

    The array is a raw view: the exporter owns the memory's lifetime,
    and the view dangles after ``exporter.free(va)`` — exactly the
    use-after-free the revocation flow (SURVEY.md §3.4) exists to make
    safe on the transport side. Callers must not touch the view after
    freeing.
    """
    import ctypes

    import numpy as np

    shape = tuple(int(s) for s in shape)
    count = int(np.prod(shape, dtype=np.int64))
    nbytes = count * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * max(nbytes, 1)).from_address(va)
    return np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)


def device_ndarray(exporter: MemoryExporter, shape, dtype):
    """Allocate device memory from ``exporter`` and wrap it as a numpy
    array — the hardware-free analogue of a JAX array living in HBM
    (the fake exporter's memory IS what its dma-buf export exposes, so
    collectives on such arrays can run zero-copy)."""
    import numpy as np

    shape = tuple(int(s) for s in shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    va = exporter.alloc(max(nbytes, 1))
    return as_ndarray(va, shape, dtype)


class DeviceArena:
    """Bump allocator over ONE device allocation.

    Allocating a whole gradient/parameter pytree from one arena makes
    its leaves adjacent in device memory, so the zero-copy collective
    coalesces the entire tree into a single ring op (one registration,
    one allreduce at full message size) instead of one op per leaf.
    All ranks must allocate the same leaves in the same order so the
    coalesced layout — and therefore the collective schedule — matches
    across the ring (the usual SPMD contract).
    """

    def __init__(self, exporter: MemoryExporter, nbytes: int,
                 align: int = 64):
        self.exporter = exporter
        self.base = exporter.alloc(max(int(nbytes), 1))
        self.size = int(nbytes)
        self.align = int(align)
        self._off = 0

    def take(self, shape, dtype):
        """Carve the next leaf out of the arena (64B-aligned)."""
        import numpy as np

        shape = tuple(int(s) for s in shape)
        nbytes = (int(np.prod(shape, dtype=np.int64))
                  * np.dtype(dtype).itemsize)
        off = -(-self._off // self.align) * self.align
        if off + nbytes > self.size:
            raise HbmError(
                f"arena exhausted: need {nbytes} at {off}, size {self.size}")
        if off > self._off:
            # Alignment padding: provably dead bytes, safe for the
            # zero-copy collective to coalesce across (and reduce as
            # garbage-in/garbage-out).
            self.exporter.mark_gap_dead(self.base + self._off,
                                        self.base + off)
        self._off = off + nbytes
        return as_ndarray(self.base + off, shape, dtype)

    def free(self) -> None:
        self.exporter.free(self.base)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()


class ClientContext:
    """Per-registration context — ``struct amd_mem_context``
    (amdp2p.c:73-85): va, size, the pin, and the revocation flag."""

    __slots__ = ("va", "size", "pinned", "revoked", "core_context", "_lock")

    def __init__(self, va: int, size: int):
        self.va = va
        self.size = size
        self.pinned: Optional[PinnedPages] = None
        # free_callback_called, amdp2p.c:84 — consulted by put_pages.
        self.revoked = False
        # Opaque cookie of the layer above (IB core's handle for the
        # registration, amdp2p.c:81-82).
        self.core_context: object = None
        self._lock = threading.Lock()


class PeerClient:
    """The bridge state machine (amdp2p.c's peer_memory_client ops,
    amdp2p.c:363-371), with the IB stack's invalidate callback replaced
    by any callable — typically ``MemoryRegion.invalidate``."""

    def __init__(self, exporter: MemoryExporter,
                 invalidate_cb: Optional[Callable[[object], None]] = None):
        self.exporter = exporter
        # ib_register_peer_memory_client returns the invalidate hook
        # (amdp2p.c:69-70, 390); ours is injected directly.
        self.invalidate_cb = invalidate_cb

    def acquire(self, va: int, size: int) -> Optional[ClientContext]:
        """Ownership claim: 1/0 in the reference (amdp2p.c:112-167);
        here a context or None."""
        if not self.exporter.is_device_address(va, size):
            return None
        trace.event("peer.acquire", va=va, bytes=size)
        return ClientContext(va, size)

    def get_pages(self, ctx: ClientContext, va: int, size: int) -> None:
        # The reference validates addr/size against the acquire-time
        # context (amdp2p.c:188-198).
        if va != ctx.va or size != ctx.size:
            raise HbmError("get_pages: addr/size mismatch with acquire")
        ctx.pinned = self.exporter.get_pages(
            va, size, free_callback=self._on_free, client_priv=ctx)
        trace.event("peer.get_pages", va=va, bytes=size)

    def dma_map(self, ctx: ClientContext) -> List[Tuple[int, int]]:
        """Hand back the prebuilt address list (the reference copies
        KFD's sg_table wholesale and does no IOMMU work,
        amdp2p.c:219-264; dma-buf's map_attachment does it properly on
        the real path)."""
        if ctx.pinned is None:
            raise HbmError("dma_map before get_pages")
        return list(ctx.pinned.pages)

    def dma_unmap(self, ctx: ClientContext) -> None:
        # No-op, as in the reference (amdp2p.c:266-282).
        return None

    def put_pages(self, ctx: ClientContext) -> None:
        with ctx._lock:
            if ctx.revoked:
                # The exporter already reclaimed the pages on the free
                # callback's return (amdp2p.c:299-302 + :105-107).
                return
            pinned, ctx.pinned = ctx.pinned, None
        if pinned is not None:
            self.exporter.put_pages(pinned)
        trace.event("peer.put_pages", va=ctx.va)

    def get_page_size(self, ctx: ClientContext) -> int:
        try:
            return self.exporter.get_page_size(ctx.va)
        except Exception:
            return DEFAULT_PAGE_SIZE  # amdp2p.c:339's fallback

    def release(self, ctx: ClientContext) -> None:
        trace.event("peer.release", va=ctx.va)

    def _on_free(self, ctx: ClientContext) -> None:
        """Exporter-initiated revocation (free/exit while registered) —
        free_callback, amdp2p.c:88-109: invalidate upward, then the
        exporter reclaims pages on return.

        core_context is read and the revoked flag set under ctx._lock
        as ONE atomic step: if registration is still in flight (no
        core_context yet), the registering thread is guaranteed to
        observe ``revoked`` at its post-assembly check and unwind —
        without this, a free landing in that window would leave a
        valid MR over reclaimed pages (the crash the reference's
        free_callback/put_pages handshake exists to prevent)."""
        with ctx._lock:
            cc = ctx.core_context
            ctx.revoked = True
            ctx.pinned = None
        if self.invalidate_cb is not None and cc is not None:
            self.invalidate_cb(cc)
        trace.event("peer.revoked", va=ctx.va)


@dataclass
class Registration:
    ctx: ClientContext
    mr: object  # transport MemoryRegion
    page_size: int
    sg: List[Tuple[int, int]] = field(default_factory=list)


class RegistrationManager:
    """Registration façade: pin device memory and register it with a
    transport engine, with correct teardown in every order.

    Owns the full §3.2 call stack of the reference (acquire →
    get_pages → get_page_size → dma_map → NIC MR) and the §3.6 harness
    duties: a live-registration list with cleanup-on-close
    (tests/amdp2ptest.c:115-139) so leaked registrations from a crashed
    consumer are reclaimed.
    """

    def __init__(self, engine, exporter: MemoryExporter):
        self.engine = engine
        self.exporter = exporter
        self.client = PeerClient(exporter, invalidate_cb=self._invalidate)
        self._live: Dict[int, Registration] = {}
        self._lock = threading.Lock()

    def _invalidate(self, core_context) -> None:
        reg: Registration = core_context
        reg.mr.invalidate()
        trace.event("regmgr.invalidate", va=reg.ctx.va)

    def register(self, va: int, size: int, prefer_dmabuf: bool = True):
        ctx = self.client.acquire(va, size)
        if ctx is None:
            raise HbmError(f"[{va:#x},+{size}) is not exporter memory")
        self.client.get_pages(ctx, va, size)

        def _check_not_revoked():
            # The owner may free the memory at ANY point during
            # registration (the §3.4 race). Once revoked, continuing —
            # in particular falling back to a plain reg_mr on the VA —
            # would create a live MR over reclaimed pages.
            with ctx._lock:
                revoked = ctx.revoked
            if revoked:
                raise HbmError(
                    f"[{va:#x},+{size}) freed by owner during registration")

        try:
            page_size = self.client.get_page_size(ctx)
            sg = self.client.dma_map(ctx)
            mr = None
            if prefer_dmabuf:
                # Failures along the dma-buf path (no export support,
                # or the engine rejecting the fd) fall back to the
                # legacy direct registration below — unless the real
                # cause is that the memory was just freed.
                try:
                    fd, off = self.exporter.export_dmabuf(ctx.pinned)
                    mr = self.engine.reg_dmabuf_mr(fd, off, size, iova=va)
                except Exception:
                    _check_not_revoked()
                    mr = None
            if mr is None:
                _check_not_revoked()
                # Legacy path: register the bus-address range directly
                # (the sg entries are flat in the fake exporter, as in
                # the IOMMU-off world the reference assumes,
                # amdp2p.c:222-240). Exporters whose VAs are
                # bookkeeping-only (synthetic ranges when PJRT hides
                # pointers) veto this — a garbage address must never
                # become a live MR the ring would DMA against.
                registrable = getattr(self.exporter, "direct_registrable",
                                      None)
                if registrable is not None and not registrable(va, size):
                    raise HbmError(
                        f"[{va:#x},+{size}) has no host-visible memory "
                        "(synthetic VA): dma-buf export is required for "
                        "a data-path registration")
                mr = self.engine.reg_mr((va, size))
        except BaseException:
            # Unwind the pin — a failed registration must not leak
            # pinned pages (the reference unwinds similarly on its
            # error paths, amdp2p.c:206-215).
            self.client.put_pages(ctx)
            self.client.release(ctx)
            raise
        reg = Registration(ctx=ctx, mr=mr, page_size=page_size, sg=sg)
        # Publish core_context and re-check revocation as one atomic
        # step against _on_free (which reads core_context and sets
        # revoked under the same lock): either the callback saw the
        # registration and invalidated the MR, or we see the flag here
        # and unwind — no window where a free leaves the MR live.
        with ctx._lock:
            ctx.core_context = reg
            revoked = ctx.revoked
        if revoked:
            reg.mr.invalidate()
            reg.mr.deregister()
            self.client.release(ctx)
            raise HbmError(
                f"[{va:#x},+{size}) freed by owner during registration")
        with self._lock:
            self._live[id(reg)] = reg
        trace.event("regmgr.register", va=va, bytes=size)
        return reg

    def deregister(self, reg: Registration) -> None:
        with self._lock:
            self._live.pop(id(reg), None)
        # ibv_dereg_mr path: dma_unmap (no-op) → put_pages → release
        # (SURVEY.md §3.5).
        self.client.dma_unmap(reg.ctx)
        reg.mr.deregister()
        self.client.put_pages(reg.ctx)
        self.client.release(reg.ctx)
        trace.event("regmgr.deregister", va=reg.ctx.va)

    def close(self) -> None:
        """Release every live registration (the per-fd cleanup of
        tests/amdp2ptest.c:115-139)."""
        with self._lock:
            leaked = list(self._live.values())
            self._live.clear()
        for reg in leaked:
            self.client.dma_unmap(reg.ctx)
            reg.mr.deregister()
            self.client.put_pages(reg.ctx)
            self.client.release(reg.ctx)
        if leaked:
            trace.event("regmgr.close_reclaimed", count=len(leaked))

    def live_count(self) -> int:
        with self._lock:
            return len(self._live)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
