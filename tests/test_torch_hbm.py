"""Pin-lifecycle tests on the PyTorch port's copy of the registry
(``rocnrdma_tpu_torch.hbm``) and its ``CUDAExporter`` — the cases of
``tests/test_hbm_lifecycle.py``, hardware-free, over the port's own
transport engine.

Mirrors what the reference's kernel test module exercised on real
hardware via ioctls + dmesg (SURVEY.md §4): address classification,
pin/unpin, page-size query, repeat-pin on one range, revocation on
free-while-pinned, and cleanup-on-close — with asserts instead of a
human reading printk.
"""

import numpy as np
import pytest

import torch

from rocnrdma_tpu_torch.hbm.cuda import (GPU_PAGE_SIZE, HOST_PAGE_SIZE,
                                         CUDAExporter, tensor_regions)
from rocnrdma_tpu_torch.hbm.registry import (
    FakeHBMExporter,
    HbmError,
    PeerClient,
    RegistrationManager,
)
from rocnrdma_tpu_torch.transport import engine as eng
from rocnrdma_tpu_torch.utils.trace import trace

from test_transport import free_port


@pytest.fixture()
def exporter():
    return FakeHBMExporter()


def test_is_device_address(exporter):
    """ioctl_is_gpu_address equivalent (tests/amdp2ptest.c:141-165)."""
    va = exporter.alloc(8192)
    assert exporter.is_device_address(va)
    assert exporter.is_device_address(va + 8191)
    assert not exporter.is_device_address(va + 8192)
    assert not exporter.is_device_address(0x1234)
    # range check: must fit inside the allocation
    assert exporter.is_device_address(va, 8192)
    assert not exporter.is_device_address(va + 1, 8192)
    exporter.free(va)


def test_get_put_pages(exporter):
    """ioctl_get_pages / ioctl_put_pages (tests/amdp2ptest.c:207-304)."""
    va = exporter.alloc(3 * 4096)
    pinned = exporter.get_pages(va + 100, 5000)
    assert pinned.size == 5000
    # sg entries cover the range exactly, split at page boundaries
    assert sum(l for (_, l) in pinned.pages) == 5000
    assert pinned.pages[0][0] == va + 100
    assert exporter.live_pins() == 1
    exporter.put_pages(pinned)
    assert exporter.live_pins() == 0
    exporter.free(va)


def test_get_page_size(exporter):
    """ioctl_get_page_size (tests/amdp2ptest.c:168-205) incl. the 4096
    fallback behavior (amdp2p.c:339)."""
    va = exporter.alloc(4096)
    assert exporter.get_page_size(va) == 4096

    class BrokenExporter(FakeHBMExporter):
        def get_page_size(self, va):
            raise RuntimeError("query failed")

    broken = BrokenExporter()
    bva = broken.alloc(4096)
    client = PeerClient(broken)
    ctx = client.acquire(bva, 4096)
    assert client.get_page_size(ctx) == 4096
    exporter.free(va)


def test_double_pin_same_range(exporter):
    """The reference deliberately supports get_pages twice on the same
    range (tests/amdp2ptest.c:296-299)."""
    va = exporter.alloc(4096)
    p1 = exporter.get_pages(va, 4096)
    p2 = exporter.get_pages(va, 4096)
    assert exporter.live_pins() == 2
    exporter.put_pages(p1)
    exporter.put_pages(p2)
    assert exporter.live_pins() == 0
    exporter.free(va)


def test_peer_client_state_machine(exporter):
    """acquire → get_pages → dma_map → put_pages → release
    (SURVEY.md §3.2/§3.5 call stacks)."""
    va = exporter.alloc(8192)
    client = PeerClient(exporter)
    # acquire refuses non-device addresses (amd_acquire returns 0)
    assert client.acquire(0xdeadbeef, 64) is None
    ctx = client.acquire(va, 8192)
    assert ctx is not None
    # get_pages validates against acquire-time addr/size
    # (amdp2p.c:188-198)
    with pytest.raises(HbmError):
        client.get_pages(ctx, va + 4096, 4096)
    client.get_pages(ctx, va, 8192)
    sg = client.dma_map(ctx)
    assert sum(l for (_, l) in sg) == 8192
    client.dma_unmap(ctx)
    client.put_pages(ctx)
    client.release(ctx)
    assert exporter.live_pins() == 0
    exporter.free(va)


def test_revocation_free_while_pinned(exporter):
    """§3.4: freeing pinned memory fires the free callback, which must
    invalidate upward BEFORE pages are reclaimed, and a later
    put_pages must be a no-op (amdp2p.c:88-109, 299-302)."""
    events = []
    client = PeerClient(exporter, invalidate_cb=lambda cc: events.append(cc))
    va = exporter.alloc(4096)
    ctx = client.acquire(va, 4096)
    client.get_pages(ctx, va, 4096)
    ctx.core_context = "ib-handle-cookie"

    exporter.free(va)  # owner frees while registered

    assert events == ["ib-handle-cookie"]
    assert ctx.revoked
    assert exporter.live_pins() == 0
    # put_pages after revocation: must not double-free
    client.put_pages(ctx)
    client.release(ctx)


def test_registration_manager_end_to_end(exporter):
    """Full §3.2 stack against the transport: pin fake HBM, register
    with the engine via the dma-buf path, RDMA-write into it remotely,
    verify visibility, then deregister."""
    e = eng.Engine("emu")
    a, b = eng.loopback_pair(e, free_port())
    mgr = RegistrationManager(e, exporter)

    va = exporter.alloc(65536)
    reg = mgr.register(va, 65536)
    assert reg.page_size == 4096
    assert mgr.live_count() == 1

    src = np.arange(65536, dtype=np.uint8) % 199
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, 65536, wr_id=1)
        assert a.wait(1).ok

    # Visibility through the CPU side of the fake HBM (the amdp2ptest
    # mmap check, tests/amdp2ptest.c:336-395).
    import ctypes

    got = np.frombuffer(
        (ctypes.c_char * 65536).from_address(va), dtype=np.uint8).copy()
    np.testing.assert_array_equal(got, src)

    mgr.deregister(reg)
    assert mgr.live_count() == 0
    assert exporter.live_pins() == 0
    mgr.close()
    a.close(); b.close(); e.close()


def test_registration_manager_revocation_invalidates_mr(exporter):
    """Free-while-registered propagates all the way to the NIC layer:
    the MR is invalidated so remote access fails — the full §3.4 chain
    KFD → free_callback → invalidate_peer_memory → MR teardown."""
    e = eng.Engine("emu")
    a, b = eng.loopback_pair(e, free_port())
    mgr = RegistrationManager(e, exporter)

    va = exporter.alloc(4096)
    reg = mgr.register(va, 4096)
    src = np.ones(4096, dtype=np.uint8)
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, 4096, wr_id=1)
        assert a.wait(1).ok

        exporter.free(va)  # revoke

        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, 4096, wr_id=2)
        assert a.wait(2).status == eng.WC_REM_ACCESS_ERR

    # Deregistration after revocation is safe in any order.
    mgr.deregister(reg)
    mgr.close()
    a.close(); b.close(); e.close()


def test_free_racing_inflight_post_errors_fatally(exporter):
    """Exporter free (→ free_callback → MR invalidate) racing an
    in-flight post against the registered region: the WR completes
    with SUCCESS or REM_ACCESS_ERR — never a crash or a write through
    reclaimed pages — and the access error is non-retryable (the
    elastic layer must re-raise lifetime bugs, not rebuild around
    them)."""
    e = eng.Engine("emu")
    a, b = eng.loopback_pair(e, free_port())
    mgr = RegistrationManager(e, exporter)
    n = 4 << 20
    va = exporter.alloc(n)
    reg = mgr.register(va, n)
    src = np.ones(n, dtype=np.uint8)
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, n, wr_id=1)
        exporter.free(va)  # owner frees while the write is in flight
        wc = a.wait(1, timeout_ms=30000)
        assert wc.status in (eng.WC_SUCCESS, eng.WC_REM_ACCESS_ERR)
        # After the revocation settles, access fails deterministically
        # and fatally.
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, n, wr_id=2)
        wc = a.wait(2, timeout_ms=30000)
        assert wc.status == eng.WC_REM_ACCESS_ERR
        assert not eng.TransportError(
            f"completion error status {wc.status} (rem_access_err)"
        ).retryable
    mgr.deregister(reg)  # safe after revocation, any order
    mgr.close()
    a.close(); b.close(); e.close()


def test_mark_gap_dead_does_not_disturb_inflight_post(exporter):
    """mark_gap_dead is coalescing METADATA: marking a neighboring gap
    dead while a post is outstanding must not perturb the transfer or
    the pin — only is_gap_dead's answer."""
    e = eng.Engine("emu")
    a, b = eng.loopback_pair(e, free_port())
    mgr = RegistrationManager(e, exporter)
    va = exporter.alloc(8192)
    reg = mgr.register(va, 4096)
    src = np.full(4096, 9, dtype=np.uint8)
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, 4096, wr_id=1)
        exporter.mark_gap_dead(va + 4096, va + 8192)
        assert a.wait(1, timeout_ms=30000).ok
    assert exporter.is_gap_dead(va + 4096, va + 8192)
    assert exporter.live_pins() == 1  # the pin is untouched
    mgr.deregister(reg)
    mgr.close()
    a.close(); b.close(); e.close()


def test_cleanup_on_close_reclaims_leaks(exporter):
    """Leaked registrations are reclaimed on close — the per-fd cleanup
    path for crashed tests (tests/amdp2ptest.c:115-139)."""
    e = eng.Engine("emu")
    mgr = RegistrationManager(e, exporter)
    vas = [exporter.alloc(4096) for _ in range(3)]
    for va in vas:
        mgr.register(va, 4096)
    assert mgr.live_count() == 3
    mgr.close()  # consumer "crashed" without deregistering
    assert mgr.live_count() == 0
    assert exporter.live_pins() == 0
    assert trace.counter("regmgr.close_reclaimed") == 1
    e.close()


def test_cuda_exporter_contract_on_cpu_tensors():
    """The CUDAExporter implements the same contract over torch tensors
    (CPU tensors here: host memory, 4 KiB pages, directly
    registrable)."""
    exporter = CUDAExporter()
    t = torch.arange(1024, dtype=torch.float32)
    nbytes = t.numel() * t.element_size()
    va = exporter.adopt(t)
    assert va == t.data_ptr()
    assert exporter.is_device_address(va, nbytes)
    assert not exporter.is_device_address(va + nbytes)
    assert exporter.get_page_size(va) == HOST_PAGE_SIZE
    assert exporter.direct_registrable(va, nbytes)

    events = []
    client = PeerClient(exporter, invalidate_cb=events.append)
    ctx = client.acquire(va, nbytes)
    client.get_pages(ctx, va, nbytes)
    ctx.core_context = "cookie"
    assert exporter.live_pins() == 1
    assert sum(n for _, n in ctx.pinned.pages) == nbytes

    # Releasing the adoption while pinned = free-while-registered.
    exporter.release(va)
    assert events == ["cookie"]
    assert ctx.revoked and exporter.live_pins() == 0
    client.put_pages(ctx)  # safe no-op


def test_cuda_exporter_dmabuf_of_cpu_tensor_raises():
    """A CPU tensor is host memory: it has no dma-buf export, and the
    exporter says so instead of handing back a descriptor."""
    exporter = CUDAExporter()
    t = torch.zeros(4096, dtype=torch.uint8)
    va = exporter.adopt(t)
    pinned = exporter.get_pages(va, 4096)
    with pytest.raises(HbmError, match="host memory"):
        exporter.export_dmabuf(pinned)
    exporter.put_pages(pinned)
    exporter.release(va)


def test_cuda_exporter_registers_cpu_tensor_and_revokes():
    """RegistrationManager over an adopted CPU tensor: the dma-buf
    attempt fails, the direct registration stands (host memory), a peer
    writes into the tensor through the MR, and release() while
    registered invalidates the MR."""
    e = eng.Engine("emu")
    a, b = eng.loopback_pair(e, free_port())
    exporter = CUDAExporter()
    mgr = RegistrationManager(e, exporter)
    dst = torch.zeros(256, dtype=torch.uint8)
    va = exporter.adopt(dst)
    reg = mgr.register(va, 256)
    src = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, 256, wr_id=1)
        assert a.wait(1).ok
        assert torch.equal(dst, src)
        exporter.release(va)
        a.post_write(smr, 0, reg.mr.addr, reg.mr.rkey, 256, wr_id=2)
        assert a.wait(2).status == eng.WC_REM_ACCESS_ERR
    mgr.close()
    a.close(); b.close(); e.close()


def test_device_va_never_reaches_reg_mr():
    """A range the exporter marks as device memory is never registered
    directly: without a dma-buf the registration fails with the
    direct_registrable veto, and reg_mr is never called."""
    e = eng.Engine("emu")
    exporter = CUDAExporter()
    mgr = RegistrationManager(e, exporter)
    t = torch.zeros(1 << 16, dtype=torch.uint8)
    exporter.adopt_region(t.data_ptr(), 1 << 16, owner=t, device=0)
    assert exporter.get_page_size(t.data_ptr()) == GPU_PAGE_SIZE
    assert not exporter.direct_registrable(t.data_ptr(), 1 << 16)
    calls = []
    e.reg_mr = lambda *a, **k: calls.append(a)
    with pytest.raises(HbmError, match="dma-buf export is required"):
        mgr.register(t.data_ptr(), 1 << 16, prefer_dmabuf=False)
    assert calls == [] and exporter.live_pins() == 0
    e.close()


def test_tensor_regions_take_only_contiguous_cpu_tensors():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert tensor_regions(t) == [(t.data_ptr(), 48, t)]
    assert tensor_regions(t.t()) is None                 # not contiguous
    assert tensor_regions(torch.empty(0)) is None
    assert tensor_regions(torch.zeros(4, dtype=torch.float16)) is None
    assert tensor_regions(torch.zeros(4, device="meta")) is None
    assert tensor_regions(np.zeros(4, np.float32)) is None


@pytest.mark.gpu
def test_cuda_tensor_takes_the_staged_path():
    """On the card: a CUDA tensor has no in-place region (the ring
    folds on the host), pages are 64 KiB, and its dma-buf export either
    returns an fd or raises with the driver's reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = torch.zeros(1 << 20, device="cuda")
    assert tensor_regions(t) is None
    exporter = CUDAExporter()
    va = exporter.adopt(t)
    assert exporter.get_page_size(va) == GPU_PAGE_SIZE
    assert not exporter.direct_registrable(va, 4 << 20)
    pinned = exporter.get_pages(va, 4 << 20)
    try:
        fd, off = exporter.export_dmabuf(pinned)
        assert fd >= 0 and off >= 0
    except HbmError as err:
        assert "DMA_BUF" in str(err) or "CUresult" in str(err)
    exporter.release(va)


def test_register_falls_back_when_dmabuf_reg_fails(exporter):
    """If the engine rejects the dma-buf fd (TransportError, not
    HbmError), register() must fall back to the legacy direct
    registration instead of failing."""
    e = eng.Engine("emu")
    mgr = RegistrationManager(e, exporter)
    orig = e.reg_dmabuf_mr
    e.reg_dmabuf_mr = lambda *a, **k: (_ for _ in ()).throw(
        eng.TransportError("engine rejects fd"))
    va = exporter.alloc(4096)
    reg = mgr.register(va, 4096)  # must not raise
    assert reg.mr.length == 4096
    mgr.deregister(reg)
    e.reg_dmabuf_mr = orig
    assert exporter.live_pins() == 0
    mgr.close(); e.close()


def test_register_failure_unwinds_pin(exporter):
    """A registration that fails entirely must not leak the pin."""
    e = eng.Engine("emu")
    mgr = RegistrationManager(e, exporter)
    e.reg_dmabuf_mr = lambda *a, **k: (_ for _ in ()).throw(
        eng.TransportError("boom"))
    e.reg_mr = lambda *a, **k: (_ for _ in ()).throw(
        eng.TransportError("boom2"))
    va = exporter.alloc(4096)
    with pytest.raises(eng.TransportError):
        mgr.register(va, 4096)
    assert exporter.live_pins() == 0
    assert mgr.live_count() == 0
    e.close()
