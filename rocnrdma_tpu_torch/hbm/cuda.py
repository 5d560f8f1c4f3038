"""CUDA exporter — the MemoryExporter contract over torch tensors.

Counterpart of ``rocnrdma_tpu/hbm/tpu.py`` (``TPUExporter``,
``shard_regions``) for an NVIDIA card:

- **CPU tensors.** The VA is ``data_ptr()`` and pages are 4 KiB. Such
  a range is host memory the transport can register directly, so the
  cross-slice shim reduces it in place with zero staged bytes — the
  counterpart of a CPU-addressable ``jax.Array``.
- **CUDA tensors.** The VA is ``data_ptr()`` and pages are 64 KiB, the
  GPU page that GPUDirect RDMA pins. ``direct_registrable`` is False:
  a device VA must never reach ``reg_mr`` (the host cannot touch it),
  so ``RegistrationManager.register`` fails loudly unless the dma-buf
  path succeeds. ``export_dmabuf`` asks libcuda for a dma-buf over the
  caching allocator's segment that holds the tensor
  (``cuMemGetHandleForAddressRange``), which a verbs engine registers
  with ``reg_dmabuf_mr`` for one-sided RDMA into and out of HBM. The
  native ring still cannot allreduce over such an MR: it folds on the
  host CPU (``ring_allreduce.cc`` refuses a data MR that is not
  CPU-foldable), so CUDA gradients take the shim's staged path.
- **Pinning is reference-holding**, as in ``TPUExporter``: an adopted
  range holds its tensor, so the caching allocator cannot hand the
  memory to another tensor while a registration covers it.
  ``release`` drops the adoption and fires revocation on live pins.

libcuda is loaded through ctypes (``libcuda.so.1``) on the first
export, never at import, and its calls need the device's primary
context current on the calling thread: the exporter calls
``torch.cuda.set_device`` first.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from rocnrdma_tpu_torch.hbm.registry import (DEFAULT_PAGE_SIZE, HbmError,
                                             MemoryExporter, PinnedPages)
from rocnrdma_tpu_torch.transport.engine import _NUMPY_DTYPE_MAP, dtype_name
from rocnrdma_tpu_torch.utils.trace import trace

HOST_PAGE_SIZE = DEFAULT_PAGE_SIZE
# The GPU page GPUDirect RDMA pins (nvidia-peermem's granularity).
GPU_PAGE_SIZE = 64 << 10

# Enum values from cuda.h (CUDA 12).
CU_DEVICE_ATTRIBUTE_DMA_BUF_SUPPORTED = 124
CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2
CU_POINTER_ATTRIBUTE_RANGE_START_ADDR = 11
CU_POINTER_ATTRIBUTE_RANGE_SIZE = 12
CU_MEMORYTYPE_DEVICE = 2
CU_MEM_RANGE_HANDLE_TYPE_DMA_BUF_FD = 1

_cuda_lock = threading.Lock()
_libcuda: Optional[ctypes.CDLL] = None


def _cu() -> ctypes.CDLL:
    global _libcuda
    with _cuda_lock:
        if _libcuda is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise HbmError(f"libcuda.so.1 not loadable: {e}") from e
            P, U64 = ctypes.c_void_p, ctypes.c_uint64
            lib.cuGetErrorString.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_char_p)]
            lib.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_int]
            lib.cuDeviceGetAttribute.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
            lib.cuPointerGetAttribute.argtypes = [P, ctypes.c_int, U64]
            lib.cuMemGetHandleForAddressRange.argtypes = [
                P, U64, ctypes.c_size_t, ctypes.c_int, ctypes.c_ulonglong]
            _libcuda = lib
        return _libcuda


class CudaDriverError(HbmError):
    """A libcuda call refused: ``call`` names it, ``result`` is its
    CUresult."""

    def __init__(self, call: str, result: int, text: str) -> None:
        super().__init__(f"{call} failed: CUresult {result} ({text})")
        self.call, self.result = call, result


def _cu_check(rc: int, what: str) -> None:
    if rc != 0:
        msg = ctypes.c_char_p()
        _cu().cuGetErrorString(rc, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else "unknown error"
        raise CudaDriverError(what, rc, text)


def dmabuf_supported(device: int = 0) -> int:
    """``CU_DEVICE_ATTRIBUTE_DMA_BUF_SUPPORTED`` of a card (1 or 0)."""
    torch.cuda.set_device(device)
    lib = _cu()
    dev = ctypes.c_int()
    _cu_check(lib.cuDeviceGet(ctypes.byref(dev), int(device)), "cuDeviceGet")
    val = ctypes.c_int()
    _cu_check(lib.cuDeviceGetAttribute(
        ctypes.byref(val), CU_DEVICE_ATTRIBUTE_DMA_BUF_SUPPORTED, dev.value),
        "cuDeviceGetAttribute(DMA_BUF_SUPPORTED)")
    return int(val.value)


def allocation_range(va: int, device: int) -> Tuple[int, int]:
    """(start, size) of the device allocation that holds ``va`` — for a
    tensor, the caching allocator's segment."""
    torch.cuda.set_device(device)
    lib = _cu()
    mtype = ctypes.c_uint()
    _cu_check(lib.cuPointerGetAttribute(
        ctypes.byref(mtype), CU_POINTER_ATTRIBUTE_MEMORY_TYPE, va),
        "cuPointerGetAttribute(MEMORY_TYPE)")
    if mtype.value != CU_MEMORYTYPE_DEVICE:
        raise HbmError(f"{va:#x} is not device memory (CUmemorytype "
                       f"{mtype.value})")
    start = ctypes.c_uint64()
    size = ctypes.c_size_t()
    _cu_check(lib.cuPointerGetAttribute(
        ctypes.byref(start), CU_POINTER_ATTRIBUTE_RANGE_START_ADDR, va),
        "cuPointerGetAttribute(RANGE_START_ADDR)")
    _cu_check(lib.cuPointerGetAttribute(
        ctypes.byref(size), CU_POINTER_ATTRIBUTE_RANGE_SIZE, va),
        "cuPointerGetAttribute(RANGE_SIZE)")
    return int(start.value), int(size.value)


def tensor_regions(t) -> Optional[List[Tuple[int, int, torch.Tensor]]]:
    """[(va, nbytes, tensor)] for a tensor the transport can reduce in
    place, or None (→ the shim's staged path). The counterpart of
    ``shard_regions``: only contiguous, non-empty CPU tensors of a ring
    dtype qualify. CUDA tensors return None — the ring folds on the
    host, so device memory is staged, as ``shard_regions`` refuses
    non-CPU platforms."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
        return None
    if (not t.is_contiguous() or t.numel() == 0
            or dtype_name(t) not in _NUMPY_DTYPE_MAP):
        return None
    return [(t.data_ptr(), t.numel() * t.element_size(), t)]


@dataclass
class _Region:
    owner: object
    nbytes: int
    device: Optional[int]  # CUDA ordinal, None for host memory


class CUDAExporter(MemoryExporter):
    """Pin-lifecycle provider for torch tensors on the CPU and the card.

    Tensors are adopted (``adopt`` / ``adopt_region``), which makes
    their range classifiable and pinnable; ``release`` drops the
    adoption and fires revocation on any live pins."""

    def __init__(self) -> None:
        super().__init__()
        self._lock = threading.Lock()
        self._adopted: Dict[int, _Region] = {}
        # id(pinned) -> (pinned, free_cb, priv)
        self._pins: Dict[int, Tuple[PinnedPages, Optional[Callable],
                                    object]] = {}

    @staticmethod
    def _device_of(owner) -> Optional[int]:
        if isinstance(owner, torch.Tensor) and owner.device.type == "cuda":
            return (owner.device.index if owner.device.index is not None
                    else torch.cuda.current_device())
        return None

    def adopt(self, t: torch.Tensor) -> int:
        """Adopt a contiguous tensor's range (holding the tensor)."""
        if not t.is_contiguous():
            raise HbmError("adopt needs a contiguous tensor")
        va, nbytes = t.data_ptr(), t.numel() * t.element_size()
        with self._lock:
            self._adopted[va] = _Region(t, nbytes, self._device_of(t))
        trace.event("cuda.adopt", va=va, bytes=nbytes,
                    device=str(t.device))
        return va

    def adopt_region(self, va: int, nbytes: int, owner=None,
                     device: Optional[int] = None) -> None:
        """Adopt (or refresh) an explicit VA range; ``owner`` is held
        until ``unhold``. Adoptions from dead layouts that overlap the
        new range are pruned, as ``TPUExporter.adopt_region`` does,
        unless live pins still cover them."""
        if device is None:
            device = self._device_of(owner)
        with self._lock:
            end = va + nbytes
            for base in [b for b, r in self._adopted.items()
                         if b != va and b < end and va < b + r.nbytes]:
                if not any(base <= p.va < base + self._adopted[base].nbytes
                           and not p._released
                           for (p, _, _) in self._pins.values()):
                    del self._adopted[base]
            self._adopted[va] = _Region(owner, nbytes, device)
        trace.event("cuda.adopt_region", va=va, bytes=nbytes)

    def unhold(self, va: int) -> None:
        """Drop the owner ref but keep the range adopted (and any
        registration over it warm) — the steady-state contract of
        per-step gradient buffers on non-pinning engines, as in
        ``TPUExporter.unhold``."""
        with self._lock:
            r = self._adopted.get(va)
            if r is not None:
                r.owner = None

    def forget(self, va: int) -> None:
        """Remove an adopted range with no revocation; only legal with
        no live pins over it."""
        with self._lock:
            r = self._adopted.get(va)
            n = r.nbytes if r is not None else 0
            if any(va <= p.va < va + n and not p._released
                   for (p, _, _) in self._pins.values()):
                raise HbmError(f"forget of {va:#x} with live pins")
            self._adopted.pop(va, None)

    def release(self, va: int) -> None:
        """Drop an adoption, revoking every live pin over it first."""
        with self._lock:
            if va not in self._adopted:
                raise HbmError(f"release of unadopted va {va:#x}")
            nbytes = self._adopted[va].nbytes
            doomed = [(p, cb, priv) for (p, cb, priv) in self._pins.values()
                      if va <= p.va < va + nbytes and not p._released]
        for pinned, cb, priv in doomed:
            if cb is not None:
                cb(priv)
            with self._lock:
                pinned._released = True
                self._pins.pop(id(pinned), None)
            self._close_fd(pinned)
        with self._lock:
            del self._adopted[va]
        self._drop_dead_gaps_in(va, va + nbytes)
        trace.event("cuda.release", va=va, revoked=len(doomed))

    def _containing(self, va: int, size: int = 1
                    ) -> Optional[Tuple[int, _Region]]:
        """First adoption fully covering [va, va+size)."""
        for base, r in self._adopted.items():
            if base <= va and va + size <= base + r.nbytes:
                return base, r
        return None

    def _region(self, va: int, size: int = 1) -> _Region:
        with self._lock:
            hit = self._containing(va, size)
        if hit is None:
            raise HbmError(f"[{va:#x},+{size}) not adopted")
        return hit[1]

    def is_device_address(self, va: int, size: int = 1) -> bool:
        with self._lock:
            return self._containing(va, size) is not None

    def get_page_size(self, va: int) -> int:
        return (GPU_PAGE_SIZE if self._region(va).device is not None
                else HOST_PAGE_SIZE)

    def get_pages(self, va, size, free_callback=None, client_priv=None):
        with self._lock:
            hit = self._containing(va, size)
            if hit is None:
                raise HbmError(f"get_pages: [{va:#x},+{size}) not adopted")
            page = (GPU_PAGE_SIZE if hit[1].device is not None
                    else HOST_PAGE_SIZE)
            pages = []
            off, end = va, va + size
            while off < end:
                chunk = min(end, (off // page + 1) * page) - off
                pages.append((off, chunk))
                off += chunk
            pinned = PinnedPages(va=va, size=size, pages=pages,
                                 exporter=self)
            self._pins[id(pinned)] = (pinned, free_callback, client_priv)
        trace.event("cuda.get_pages", va=va, bytes=size)
        return pinned

    @staticmethod
    def _close_fd(pinned: PinnedPages) -> None:
        fd, pinned.dmabuf_fd = pinned.dmabuf_fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass

    def put_pages(self, pinned: PinnedPages) -> None:
        with self._lock:
            if pinned._released:
                return
            pinned._released = True
            self._pins.pop(id(pinned), None)
        self._close_fd(pinned)
        trace.event("cuda.put_pages", va=pinned.va)

    def export_dmabuf(self, pinned: PinnedPages) -> Tuple[int, int]:
        """(fd, offset) of a dma-buf over the pinned device range. The
        fd belongs to the pin and closes with it. Host ranges and every
        refusal by the driver raise :class:`HbmError` with the driver's
        own error string; nothing falls back silently."""
        if pinned.dmabuf_fd is not None:
            return pinned.dmabuf_fd, pinned.dmabuf_offset
        dev = self._region(pinned.va, pinned.size).device
        if dev is None:
            raise HbmError(
                f"[{pinned.va:#x},+{pinned.size}) is host memory: it has no "
                "dma-buf export; register it directly")
        if not dmabuf_supported(dev):
            raise HbmError(f"cuda:{dev} reports DMA_BUF_SUPPORTED = 0")
        seg_start, seg_size = allocation_range(pinned.va, dev)
        page = HOST_PAGE_SIZE
        start = max(seg_start, pinned.va // page * page)
        end = min(seg_start + seg_size,
                  -(-(pinned.va + pinned.size) // page) * page)
        fd = ctypes.c_int(-1)
        _cu_check(_cu().cuMemGetHandleForAddressRange(
            ctypes.byref(fd), start, end - start,
            CU_MEM_RANGE_HANDLE_TYPE_DMA_BUF_FD, 0),
            "cuMemGetHandleForAddressRange(DMA_BUF_FD)")
        pinned.dmabuf_fd = int(fd.value)
        pinned.dmabuf_offset = pinned.va - start
        trace.event("cuda.export_dmabuf", va=pinned.va, bytes=pinned.size,
                    fd=pinned.dmabuf_fd, offset=pinned.dmabuf_offset)
        return pinned.dmabuf_fd, pinned.dmabuf_offset

    def direct_registrable(self, va: int, size: int) -> bool:
        """Host ranges may be registered directly; device ranges never
        (the host cannot touch a device VA)."""
        return self._region(va, size).device is None

    def live_pins(self) -> int:
        with self._lock:
            return len(self._pins)
