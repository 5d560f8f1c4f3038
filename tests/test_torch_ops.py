"""The port's ops (rocnrdma_tpu_torch.ops) against the JAX package.

On the CPU the port's wrappers run their kernels' plain versions; those
are held here against the JAX package on the same numpy inputs, with
the JAX side going through its Pallas kernels in interpret mode as
tests/test_ops.py runs them. The CUDA kernels themselves run only on a
card: tests/test_torch_kernels.py holds each against its plain version
there.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.ops.attention import (
    attention_reference as jax_attention_reference,
    flash_attention_lse as jax_flash_attention_lse)
from rocnrdma_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (
    attention, attention_reference, flash_attention_lse,
    flash_attention_lse_reference)
from rocnrdma_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _rmsnorm_module():
    # ``rocnrdma_tpu_torch.ops.rmsnorm`` names the function once the
    # package is imported; the module is reached through sys.modules.
    return importlib.import_module("rocnrdma_tpu_torch.ops.rmsnorm")


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------------------- RMSNorm


@pytest.mark.parametrize("shape", [(4, 32, 128), (10, 64), (3, 7, 48)])
def test_rmsnorm_matches_jax_pallas(shape):
    """Port's rmsnorm (plain, CPU) vs JAX rmsnorm through its Pallas
    kernel in interpret mode; f32 at test_ops' own 1e-5."""
    x = _normal(0, shape)
    w = _normal(1, shape[-1:]) + 1.0
    want = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                  use_pallas=True, interpret=True))
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rmsnorm_bf16_keeps_dtype_and_matches_jax():
    """bf16 in, bf16 out, f32 weight: the two packages round the same
    f32 result, so they differ by at most one bf16 step (2^-7 relative)."""
    x = _normal(2, (6, 64))
    w = _normal(3, (64,)) + 1.0
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    want = np.asarray(jax_rmsnorm(xb, jnp.asarray(w), use_pallas=False),
                      dtype=np.float32)
    xt = torch.from_numpy(np.asarray(xb, dtype=np.float32)).bfloat16()
    got = rmsnorm(xt, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_bf16_np(got), want, rtol=2 ** -7, atol=1e-6)


# ----------------------------------------------------------- attention


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s", [(4, 2, 37), (4, 4, 16), (2, 1, 24)])
def test_flash_lse_matches_jax_pallas(causal, h, kvh, s):
    """Port's flash_attention_lse (plain, CPU) vs JAX
    flash_attention_lse through its Pallas kernel in interpret mode:
    out and lse to 2e-4, GQA (KVH < H) and an odd S included."""
    b, d = 1, 16
    q, k, v = (_normal(i, shp) for i, shp in
               enumerate([(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d)]))
    jo, jl = jax_flash_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     interpret=True)
    to, tl = flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal)
    assert tuple(tl.shape) == (b, h, s, 1) and tl.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_jax(causal):
    q, k, v = (_normal(10 + i, shp) for i, shp in
               enumerate([(2, 4, 19, 8), (2, 2, 19, 8), (2, 2, 19, 8)]))
    want = np.asarray(jax_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # The kernel's plain version computes the same function.
    out = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-4)


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the wrappers take the plain versions, forward and
    backward, and count no launch; the counters are plain integers that
    reset to zero, one per kernel of the five."""
    _native.reset_launches()
    x, w = torch.randn(3, 16), torch.rand(16)
    assert torch.equal(rmsnorm(x, w), rmsnorm_reference(x, w))
    q, k = torch.randn(1, 2, 5, 16), torch.randn(1, 1, 5, 16)
    for got, want in zip(flash_attention_lse(q, k, k),
                         flash_attention_lse_reference(q, k, k)):
        assert torch.equal(got, want)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    rmsnorm(xg, wg).sum().backward()
    qg, kg = q.clone().requires_grad_(), k.clone().requires_grad_()
    attention(qg, kg, kg).sum().backward()
    assert xg.grad is not None and kg.grad is not None
    assert _native.launches() == {"rmsnorm_fwd": 0, "flash_fwd": 0,
                                  "rmsnorm_bwd": 0, "flash_bwd_dq": 0,
                                  "flash_bwd_dkv": 0}


@pytest.mark.parametrize("dtype,d", [(torch.float32, 102),
                                     (torch.bfloat16, 100),
                                     (torch.bfloat16, 36),
                                     (torch.float32, 8192),
                                     (torch.bfloat16, 8200)])
def test_rmsnorm_bwd_kernel_refuses_widths_it_cannot_take(monkeypatch, dtype,
                                                         d):
    """The backward kernel holds a row as 16-byte vectors, at most 4 per
    thread of 256: the wrapper refuses any other width before it builds
    or launches anything."""
    monkeypatch.setattr(_native, "library", None)
    _native.reset_launches()
    x = torch.randn(3, d).to(dtype)
    with pytest.raises(ValueError, match="widths that are multiples"):
        _rmsnorm_module()._launch_bwd(x, torch.rand(d), x, 1e-5)
    assert _native.launches()["rmsnorm_bwd"] == 0


# ------------------------------------------------------- build plumbing


def test_build_is_lazy_and_raises_without_nvcc(monkeypatch, tmp_path):
    """Importing the ops compiled nothing; asking for a library on a
    host without nvcc raises a clear error instead of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_native.shutil, "which", lambda _: None)
    real_isfile = os.path.isfile
    monkeypatch.setattr(_native.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc")
                        else real_isfile(p))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_native, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.library("flash_fwd")


def test_library_path_keys_source_and_flags():
    for name in _native.KERNELS:
        p = _native.library_path(name)
        assert p.parent == _native.BUILD_DIR
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
        assert (_native.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "rocnrdma_tpu_torch/_build/" in f.read().split()


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq"])
def test_attention_kernels_export_their_route(name):
    """Each attention library exports ``<entry>_route(D, dtype)`` from the
    one dispatch rule its entry switches on (``hopper_tc::route``), and
    ``_native.ROUTES`` binds it: read from the sources, nothing built."""
    assert _native.ROUTES[name] == f"{name}_route"
    src = (_native.CSRC / f"{name}.cu").read_text()
    assert '#include "hopper_tc.cuh"' in src
    assert (f'extern "C" int {name}_route(int D, int dtype) {{\n'
            f'  return hopper_tc::route(D, dtype);\n}}') in src
    assert "switch (hopper_tc::route(D, dtype))" in src


def test_library_path_keys_the_shared_header(monkeypatch, tmp_path):
    """The backward kernels include csrc/flash_bwd_common.cuh: an edited
    header must key a new library, or a stale one would load."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _native.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_native, "CSRC", csrc)
    before = {n: _native.library_path(n) for n in _native.KERNELS}
    header = csrc / "flash_bwd_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in _native.KERNELS:
        assert _native.library_path(name) != before[name], name
    assert '#include "flash_bwd_common.cuh"' in (
        csrc / "flash_bwd_dq.cu").read_text()
