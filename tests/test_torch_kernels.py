"""The port's CUDA kernels against their plain PyTorch versions.

These run only on an NVIDIA card (a CUDA kernel has no CPU mode): each
test is marked ``gpu`` and skips, with its reason, where
``torch.cuda.is_available()`` is false. The file imports nothing of JAX,
so it runs on the card's host as it is:

    python -m pytest tests/test_torch_kernels.py -m gpu

Tolerances: f32 outputs to 1e-5 (rmsnorm) and 2e-4 (attention, whose
sums run in another order); bf16 outputs to one bf16 step (2^-7
relative) for rmsnorm and 2e-2 for attention, whose bf16 output rounds
an f32 result computed in another order; lse is f32 in both dtypes.
"""

import pytest
import torch

from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (flash_attention_lse,
                                              flash_attention_lse_reference)
from rocnrdma_tpu_torch.ops.rmsnorm import rmsnorm, rmsnorm_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(2048, 4096), (37, 2048), (5, 64),
                                    (3, 100)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    w = torch.rand(d, generator=g, device=cuda) + 0.5
    _native.reset_launches()
    got = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert _native.launches()["rmsnorm_fwd"] == 1
    want = rmsnorm_reference(x, w)
    assert got.dtype == dtype and got.shape == x.shape
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 8, 2, 300, 128),
                                         (2, 4, 2, 37, 16),
                                         (1, 4, 4, 64, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, b, h, kvh, s, d):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, kvh, s, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, kvh, s, d, generator=g, device=cuda).to(dtype)
    _native.reset_launches()
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _native.launches()["flash_fwd"] == 1
    want_o, want_l = flash_attention_lse_reference(q, k, v, causal=causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want_o.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_l, rtol=2e-4, atol=2e-4)
