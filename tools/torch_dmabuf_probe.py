#!/usr/bin/env python3
"""Can this card export device memory as a dma-buf?

    python3 tools/torch_dmabuf_probe.py

Asks libcuda for a dma-buf (``cuMemGetHandleForAddressRange`` with
``CU_MEM_RANGE_HANDLE_TYPE_DMA_BUF_FD``) over 64 MiB of device memory
from three allocators — PyTorch's caching allocator (the segment that
holds a tensor, as ``hbm/cuda.py`` exports it), a raw ``cuMemAlloc``,
and ``cuMemCreate`` with ``gpuDirectRDMACapable`` mapped by
``cuMemMap`` — each with flags 0 and 1
(``CU_MEM_RANGE_FLAG_DMA_BUF_MAPPING_TYPE_PCIE``). Prints one JSON line:
the card, the kernel, ``DMA_BUF_SUPPORTED``, and per attempt the
CUresult with the driver's string, or the fd's ``exp_name`` from
``/proc/self/fdinfo``. Needs a CUDA card.
"""

import ctypes
import json
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import torch  # noqa: E402

from rocnrdma_tpu_torch.hbm import cuda as hcuda  # noqa: E402

SIZE = 64 << 20


class _Loc(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort), ("reserved", ctypes.c_ubyte * 4)]


class _Prop(ctypes.Structure):   # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Loc), ("win32HandleMetaData", ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _Access(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("location", _Loc), ("flags", ctypes.c_int)]


def _rc(lib, rc: int) -> str:
    msg = ctypes.c_char_p()
    lib.cuGetErrorString(rc, ctypes.byref(msg))
    return f"CUresult {rc} ({msg.value.decode() if msg.value else '?'})"


def _attempt(lib, ptr: int, flags: int) -> str:
    fd = ctypes.c_int(-1)
    rc = lib.cuMemGetHandleForAddressRange(
        ctypes.byref(fd), ptr, SIZE, hcuda.CU_MEM_RANGE_HANDLE_TYPE_DMA_BUF_FD,
        flags)
    if rc != 0:
        return "refused: " + _rc(lib, rc)
    info = open(f"/proc/self/fdinfo/{fd.value}").read()
    os.close(fd.value)
    m = re.search(r"exp_name:\s*(\S+)", info)
    return f"fd, exp_name {m.group(1) if m else '(none: not a dma-buf)'}"


def _vmm_alloc(lib) -> int:
    """SIZE bytes from cuMemCreate (gpuDirectRDMACapable) mapped and
    made read-write on device 0."""
    P, U64, SZ = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_size_t
    prop = _Prop(type=1, requestedHandleTypes=1, location=_Loc(1, 0))
    prop.allocFlags.gpuDirectRDMACapable = 1
    handle, va = U64(), U64()
    lib.cuMemCreate.argtypes = [P, SZ, P, ctypes.c_ulonglong]
    lib.cuMemAddressReserve.argtypes = [P, SZ, SZ, U64, ctypes.c_ulonglong]
    lib.cuMemMap.argtypes = [U64, SZ, SZ, U64, ctypes.c_ulonglong]
    lib.cuMemSetAccess.argtypes = [U64, SZ, P, SZ]
    for what, rc in (
            ("cuMemCreate", lambda: lib.cuMemCreate(
                ctypes.byref(handle), SIZE, ctypes.byref(prop), 0)),
            ("cuMemAddressReserve", lambda: lib.cuMemAddressReserve(
                ctypes.byref(va), SIZE, 0, 0, 0)),
            ("cuMemMap", lambda: lib.cuMemMap(va.value, SIZE, 0,
                                              handle.value, 0)),
            ("cuMemSetAccess", lambda: lib.cuMemSetAccess(
                va.value, SIZE, ctypes.byref(_Access(_Loc(1, 0), 3)), 1))):
        code = rc()
        if code != 0:
            raise RuntimeError(f"{what}: {_rc(lib, code)}")
    return va.value


def main() -> int:
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: needs a card",
              file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    held = torch.empty(SIZE, dtype=torch.uint8, device="cuda")
    lib = hcuda._cu()
    start, size = hcuda.allocation_range(held.data_ptr(), 0)
    raw = ctypes.c_uint64()
    lib.cuMemAlloc_v2.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    rc = lib.cuMemAlloc_v2(ctypes.byref(raw), SIZE)
    if rc != 0:
        raise RuntimeError("cuMemAlloc: " + _rc(lib, rc))
    sources = {"torch caching allocator segment": start,
               "cuMemAlloc": raw.value,
               "cuMemCreate gpuDirectRDMACapable": _vmm_alloc(lib)}
    u = os.uname()
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "kernel": f"{u.sysname} {u.release} ({u.nodename})",
        "dma_buf_supported": hcuda.dmabuf_supported(0),
        "segment_bytes": size,
        "attempts": {f"{name}, flags {flags}": _attempt(lib, ptr, flags)
                     for name, ptr in sources.items() for flags in (0, 1)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
