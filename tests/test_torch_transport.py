"""The PyTorch port's transport: its own copy of the native sources and
its ctypes bindings over CPU tensors (emulated backend, no hardware).

- every native source of ``rocnrdma_tpu_torch/native`` is
  byte-identical to its counterpart in ``rocnrdma_tpu/native`` (one wire
  format for torch and JAX ranks), and the port loads the library built
  from its own copy;
- the registration → one-sided transfer → revocation lifecycle of
  ``tests/test_transport.py`` over CPU tensors;
- a tensor that is not on the CPU is refused: the ring folds on the
  host, so device memory never reaches the engine directly.
"""

import glob
import hashlib
import os

import numpy as np
import pytest
import torch

from rocnrdma_tpu_torch.transport import engine as eng

from test_transport import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "rocnrdma_tpu", "native")
PORT_NATIVE = os.path.join(REPO, "rocnrdma_tpu_torch", "native")
SOURCE_GLOBS = ("Makefile", "include/tdr/*.h", "src/*.cc", "src/*.h")


def _sources(root):
    return sorted(os.path.relpath(p, root) for g in SOURCE_GLOBS
                  for p in glob.glob(os.path.join(root, g)))


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_native_copy_has_the_same_files():
    assert _sources(PORT_NATIVE) == _sources(JAX_NATIVE)
    assert len(_sources(JAX_NATIVE)) == 13


@pytest.mark.parametrize("rel", _sources(JAX_NATIVE))
def test_native_copy_is_byte_identical(rel):
    assert _sha256(os.path.join(PORT_NATIVE, rel)) == \
        _sha256(os.path.join(JAX_NATIVE, rel)), rel


def test_port_loads_its_own_library():
    eng.ring_chunk_bytes()  # builds (if needed) and loads
    assert os.path.realpath(eng._LIB_PATH) == os.path.realpath(
        os.path.join(PORT_NATIVE, "libtdr.so"))
    assert os.path.exists(eng._LIB_PATH)


@pytest.fixture()
def loop():
    """An emu engine with a connected loopback QP pair."""
    e = eng.Engine("emu")
    a, b = eng.loopback_pair(e, free_port())
    yield e, a, b
    a.close()
    b.close()
    e.close()


def _bytes(n, start=0):
    return (torch.arange(start, start + n, dtype=torch.int32) % 256).to(
        torch.uint8)


def test_engine_open_emu():
    with eng.Engine("emu") as e:
        assert e.kind == eng.ENGINE_EMU
        assert e.name == "emu"


def test_write_roundtrip(loop):
    e, a, b = loop
    src = _bytes(1024)
    dst = torch.zeros(1024, dtype=torch.uint8)
    with e.reg_mr(src) as smr, e.reg_mr(dst) as dmr:
        a.post_write(smr, 0, dmr.addr, dmr.rkey, 1024, wr_id=7)
        wc = a.wait(7)
        assert wc.ok and wc.opcode == eng.OP_WRITE
        assert torch.equal(src, dst)


def test_write_partial_with_offsets(loop):
    e, a, b = loop
    src = _bytes(256)
    dst = torch.zeros(256, dtype=torch.uint8)
    with e.reg_mr(src) as smr, e.reg_mr(dst) as dmr:
        a.post_write(smr, 16, dmr.addr + 100, dmr.rkey, 32, wr_id=1)
        assert a.wait(1).ok
        assert torch.equal(dst[100:132], src[16:48])
        assert int(dst[:100].sum()) == 0 and int(dst[132:].sum()) == 0


def test_read_roundtrip_bf16(loop):
    e, a, b = loop
    remote = torch.linspace(-3, 3, 2048).to(torch.bfloat16)
    local = torch.zeros(2048, dtype=torch.bfloat16)
    with e.reg_mr(remote) as rmr, e.reg_mr(local) as lmr:
        assert rmr.length == 4096
        a.post_read(lmr, 0, rmr.addr, rmr.rkey, 4096, wr_id=3)
        wc = a.wait(3)
        assert wc.ok and wc.opcode == eng.OP_READ
        assert torch.equal(local, remote)


def test_bad_rkey_fails_remotely(loop):
    e, a, b = loop
    src = torch.ones(64, dtype=torch.uint8)
    with e.reg_mr(src) as smr:
        a.post_write(smr, 0, 0xdead0000, 0xbad, 64, wr_id=9)
        assert a.wait(9).status == eng.WC_REM_ACCESS_ERR


def test_out_of_range_write_fails(loop):
    e, a, b = loop
    src = torch.ones(64, dtype=torch.uint8)
    dst = torch.zeros(64, dtype=torch.uint8)
    with e.reg_mr(src) as smr, e.reg_mr(dst) as dmr:
        a.post_write(smr, 0, dmr.addr + 32, dmr.rkey, 64, wr_id=2)
        assert a.wait(2).status == eng.WC_REM_ACCESS_ERR


def test_access_flags_enforced(loop):
    e, a, b = loop
    src = torch.ones(64, dtype=torch.uint8)
    dst = torch.zeros(64, dtype=torch.uint8)
    with e.reg_mr(src) as smr, \
            e.reg_mr(dst, access=eng.ACCESS_REMOTE_READ) as dmr:
        a.post_write(smr, 0, dmr.addr, dmr.rkey, 64, wr_id=4)
        assert a.wait(4).status == eng.WC_REM_ACCESS_ERR


def test_invalidate_revokes_remote_access(loop):
    """Free-while-registered: once the MR is invalidated, remote access
    fails, local posts on it fail, and deregistration stays safe."""
    e, a, b = loop
    src = torch.ones(64, dtype=torch.uint8)
    dst = torch.zeros(64, dtype=torch.uint8)
    smr = e.reg_mr(src)
    dmr = e.reg_mr(dst)
    a.post_write(smr, 0, dmr.addr, dmr.rkey, 64, wr_id=1)
    assert a.wait(1).ok and int(dst.sum()) == 64
    dmr.invalidate()
    a.post_write(smr, 0, dmr.addr, dmr.rkey, 64, wr_id=2)
    assert a.wait(2).status == eng.WC_REM_ACCESS_ERR
    with pytest.raises(eng.TransportError):
        a.post_write(dmr, 0, dmr.addr, dmr.rkey, 64, wr_id=3)
    dmr.deregister()
    smr.deregister()


def test_numpy_and_tensor_buffers_interoperate(loop):
    e, a, b = loop
    src = np.arange(512, dtype=np.float32)
    dst = torch.zeros(512, dtype=torch.float32)
    with e.reg_mr(src) as smr, e.reg_mr(dst) as dmr:
        a.post_write(smr, 0, dmr.addr, dmr.rkey, 2048, wr_id=5)
        assert a.wait(5).ok
        assert np.array_equal(dst.numpy(), src)


def test_buffer_args_of_tensors():
    t = torch.zeros(10, dtype=torch.bfloat16)
    assert eng.buffer_args(t, "x") == (t.data_ptr(), 10, 20)
    assert eng.dtype_name(t) == "bfloat16"
    assert eng.dtype_name(np.zeros(1, np.int8)) == "int8"
    with pytest.raises(eng.TransportError, match="contiguous"):
        eng.buffer_args(torch.zeros(4, 4).t(), "x")
    with pytest.raises(eng.TransportError, match="numpy array or"):
        eng.buffer_args([1, 2], "x")


@pytest.mark.parametrize("what", ["reg_mr", "ring"])
def test_device_tensor_refused(what):
    """A tensor off the CPU never reaches the engine: the message names
    why (the ring folds on the host). ``meta`` stands in for ``cuda``
    here; the gpu-marked case below uses a real CUDA tensor."""
    t = torch.zeros(64, device="meta")
    with eng.Engine("emu") as e:
        if what == "reg_mr":
            with pytest.raises(eng.TransportError, match="folds on the host"):
                e.reg_mr(t)
        else:
            a, b = eng.loopback_pair(e, free_port())
            ring = eng.Ring(e, a, b, 0, 2)
            with pytest.raises(eng.TransportError, match="folds on the host"):
                ring.allreduce(t)
            ring.destroy()
            a.close()
            b.close()


@pytest.mark.gpu
def test_cuda_tensor_refused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = torch.zeros(64, device="cuda")
    with eng.Engine("emu") as e:
        with pytest.raises(eng.TransportError, match="cuda tensor"):
            e.reg_mr(t)
