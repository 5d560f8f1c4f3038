"""The port's CUDA kernels against their plain PyTorch versions.

These run only on an NVIDIA card (a CUDA kernel has no CPU mode): each
test is marked ``gpu`` and skips, with its reason, where
``torch.cuda.is_available()`` is false. The file imports nothing of JAX,
so it runs on the card's host as it is:

    python -m pytest tests/test_torch_kernels.py -m gpu

Tolerances: f32 outputs to 1e-5 (rmsnorm forward and dx) and 2e-4
(attention forward and backward, whose sums run in another order); bf16
outputs to one bf16 step (2^-7 relative) for rmsnorm and 2e-2 for
attention, whose bf16 outputs round an f32 result computed in another
order; lse is f32 in both dtypes; dw is an f32 sum over all rows, taken
in another order, to rtol 1e-4 and atol 1e-3. Each backward kernel is
also bitwise deterministic: two calls on the same inputs give equal
outputs. The attention forward (K3), dK/dV (K4) and dQ (K5) kernels
have a tensor-core route for bf16 at D 64 and 128 (wgmma on 64-row TMA
tiles); its cases sit at the tile edges (S of 1, 63, 64, 65, 127, 129),
at groups 1, 2 and 4, and on the transposed views the model passes,
within the same bf16 tolerance: the route rounds P and dS to bf16 before
their second product, which the plain versions keep in f32, and these
roundings stay inside it. f32, and bf16 at D 16 and 32, take the scalar
route.
"""

import pytest
import torch

from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (
    attention, flash_attention_bwd_reference, flash_attention_lse,
    flash_attention_lse_reference, flash_attention_shard_grads,
    kernel_route)
from rocnrdma_tpu_torch.ops.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                            rmsnorm_bwd_reference,
                                            rmsnorm_reference)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4096, 2048), (1000, 2048), (37, 4096),
                                    (5, 64), (3, 136), (300, 1032)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, d, offset):
    """Widths of 1, 2 and 4 vectors per thread (and a partial last one);
    ``offset`` 1 hands in x and dy as views that start one element into
    their storage, which the wrapper must copy to align its vector
    loads."""
    g = torch.Generator(device=cuda).manual_seed(rows * 7 + d)
    x, dy = (torch.randn(rows * d + offset, generator=g, device=cuda)
             .to(dtype)[offset:].view(rows, d) for _ in range(2))
    w = torch.rand(d, generator=g, device=cuda) + 0.5
    _native.reset_launches()
    dx, dw = rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert _native.launches()["rmsnorm_bwd"] == 1
    want_dx, want_dw = rmsnorm_bwd_reference(x, w, dy)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-3)
    again = rmsnorm_bwd(x, w, dy)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,s,d", [(1, 8, 2, 300, 128),
                                         (2, 4, 2, 37, 16),
                                         (1, 4, 4, 64, 64),
                                         (1, 2, 1, 130, 32)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, causal, b, h, kvh, s,
                                       d):
    g = torch.Generator(device=cuda).manual_seed(s * 3 + d)
    q = torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, kvh, s, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, kvh, s, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
    out, lse = flash_attention_lse_reference(q, k, v, causal=causal)
    _native.reset_launches()
    got = flash_attention_shard_grads(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    counts = _native.launches()
    assert counts["flash_bwd_dq"] == 1 and counts["flash_bwd_dkv"] == 1
    route = ("tensor_core" if dtype == torch.bfloat16 and d in (64, 128)
             else "scalar")
    assert kernel_route("flash_bwd_dq", d, dtype) == route
    assert kernel_route("flash_bwd_dkv", d, dtype) == route
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape, name
        assert torch.isfinite(gt.float()).all(), name
        torch.testing.assert_close(gt.float(), wt.float(), rtol=tol,
                                   atol=tol, msg=name)
    again = flash_attention_shard_grads(q, k, v, out, lse, do, causal)
    for a, b_ in zip(again, got):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_autograd_on_the_card_launches_every_backward_kernel(cuda):
    x = torch.randn(2, 64, 128, device=cuda, requires_grad=True)
    w = torch.ones(128, device=cuda, requires_grad=True)
    _native.reset_launches()
    y = rmsnorm(x, w)
    b, s = 2, 64
    q = y.view(b, s, 4, 32).transpose(1, 2)
    kv = y[..., :64].reshape(b, s, 2, 32).transpose(1, 2)
    flash_attention_lse(q, kv, kv)[0].float().sum().backward()
    torch.cuda.synchronize()
    assert _native.launches() == {"rmsnorm_fwd": 1, "flash_fwd": 1,
                                  "rmsnorm_bwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def _assert_bf16_close(got, want, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got.float()).all(), name
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 129])
def test_flash_tensor_core_route_at_tile_edges(cuda, s, d, group, causal):
    bf = torch.bfloat16
    assert kernel_route("flash_fwd", d, bf) == "tensor_core"
    assert kernel_route("flash_bwd_dkv", d, bf) == "tensor_core"
    assert kernel_route("flash_bwd_dq", d, bf) == "tensor_core"
    b, kvh = 2, 2
    h = kvh * group
    g = torch.Generator(device=cuda).manual_seed(s * 31 + d + group)
    q, do = (torch.randn(b, h, s, d, generator=g, device=cuda).to(bf)
             for _ in range(2))
    k, v = (torch.randn(b, kvh, s, d, generator=g, device=cuda).to(bf)
            for _ in range(2))
    _native.reset_launches()
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want_o, want_l = flash_attention_lse_reference(q, k, v, causal=causal)
    _assert_bf16_close(out, want_o, "out")
    torch.testing.assert_close(lse, want_l, rtol=2e-4, atol=2e-4)
    got = flash_attention_shard_grads(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert _native.launches()["flash_fwd"] == 1
    assert _native.launches()["flash_bwd_dkv"] == 1
    assert _native.launches()["flash_bwd_dq"] == 1
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        _assert_bf16_close(gt, wt, name)
    again = flash_attention_shard_grads(q, k, v, out, lse, do, causal)
    for name, a, g in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, g), name


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_route_takes_transposed_views(cuda, causal):
    """q, k, v as the model makes them: projections (B, S, heads, D)
    viewed as (B, heads, S, D), the three of them slices of one buffer;
    forward and autograd backward against the plain versions on
    contiguous copies."""
    bf = torch.bfloat16
    b, s, h, kvh, d = 2, 129, 8, 2, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(b, s, h + 2 * kvh, d, generator=g, device=cuda).to(bf)
    x.requires_grad_()
    q = x[:, :, :h].transpose(1, 2)
    k = x[:, :, h:h + kvh].transpose(1, 2)
    v = x[:, :, h + kvh:].transpose(1, 2)
    assert not q.is_contiguous()
    grad = torch.randn(b, h, s, d, generator=g, device=cuda).to(bf)
    out = attention(q, k, v, causal=causal)
    out.backward(grad)
    torch.cuda.synchronize()
    qc, kc, vc = (t.detach().contiguous() for t in (q, k, v))
    want_o, want_l = flash_attention_lse_reference(qc, kc, vc, causal=causal)
    _assert_bf16_close(out.detach(), want_o, "out")
    dq, dk, dv = flash_attention_bwd_reference(qc, kc, vc, out.detach(),
                                               want_l, grad, causal)
    _assert_bf16_close(x.grad[:, :, :h].transpose(1, 2), dq, "dq")
    _assert_bf16_close(x.grad[:, :, h:h + kvh].transpose(1, 2), dk, "dk")
    _assert_bf16_close(x.grad[:, :, h + kvh:].transpose(1, 2), dv, "dv")
