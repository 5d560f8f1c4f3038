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
route; the scalar routes of K3, K4 and K5 are checked at the edges of
their 8-row warps and 32-row tiles, twice for bitwise repeatability, and
a batch row of a larger call (another block size) against the call on
that row alone, bitwise. K1 also runs inside a CUDA graph (the compiled
decode): replayed, it is held against its plain version to the same
tolerance, a graphed ``generate`` gives the uncaptured step's tokens
bitwise with exact launch counts through replays, and a capture that
fails raises.
"""

import os
import subprocess
import sys

import pytest
import torch

from rocnrdma_tpu_torch.models import llama
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (
    attention, flash_attention_bwd_reference, flash_attention_lse,
    flash_attention_lse_reference, flash_attention_shard_grads,
    kernel_route)
from rocnrdma_tpu_torch.ops.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                            rmsnorm_bwd_reference,
                                            rmsnorm_reference)
from rocnrdma_tpu_torch.utils import graphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
                                  "flash_bwd_dkv": 1, "decode_attn": 0,
                                  "mla_decode": 0, "moe_gemm_up": 0,
                                  "moe_gemm_down": 0, "moe_gemm_many": 0,
                                  "moe_combine": 0, "kda_recurrent": 0,
                                  "moe_rows_few": 0, "moe_experts_few": 0,
                                  "moe_rows_many": 0, "moe_experts_many": 0}
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
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d,dtype", [(16, torch.float32), (32, torch.float32),
                                     (64, torch.float32),
                                     (128, torch.float32),
                                     (16, torch.bfloat16),
                                     (32, torch.bfloat16)])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 31, 33, 63, 64, 65, 85, 225])
def test_flash_scalar_route_at_tile_edges(cuda, s, d, dtype, group, causal):
    """K3's scalar route (f32 at every D, bf16 at D 16 and 32) at the
    edges of its 8-row warps and 32-key tiles, at the serving prompts'
    lengths 85 and 225, at groups 1, 2 and 4: one launch, out and lse
    against the plain version, and a second call bitwise equal."""
    assert kernel_route("flash_fwd", d, dtype) == "scalar"
    b, kvh = 2, 2
    h = kvh * group
    g = torch.Generator(device=cuda).manual_seed(s * 31 + d + group)
    q = torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, kvh, s, d, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    _native.reset_launches()
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _native.launches()["flash_fwd"] == 1
    want_o, want_l = flash_attention_lse_reference(q, k, v, causal=causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want_o.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, want_l, rtol=2e-4, atol=2e-4)
    again, lse2 = flash_attention_lse(q, k, v, causal=causal)
    assert torch.equal(again, out) and torch.equal(lse2, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 32)])
@pytest.mark.parametrize("s", [85, 225, 512])
def test_flash_scalar_route_rows_independent_of_the_grid(cuda, dtype, d, s):
    """The scalar route picks its block size (8 to 64 rows) and how many
    heads of a group share a block from B, H and S; each row's sums run
    in the same order whatever it picks, so a batch row of a B 4 call is
    bitwise the B 1 call on that row alone."""
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn(4, 16, s, d, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(4, 8, s, d, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    for causal in (True, False):
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        one, lse1 = flash_attention_lse(q[2:3], k[2:3], v[2:3],
                                        causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(out[2:3], one) and torch.equal(lse[2:3], lse1)


def _bwd_inputs(cuda, b, h, kvh, s, d, dtype, seed, causal):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, kvh, s, d, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    out, lse = flash_attention_lse_reference(q, k, v, causal=causal)
    return q, k, v, out, lse, do


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("d,dtype", [(16, torch.float32), (32, torch.float32),
                                     (64, torch.float32),
                                     (128, torch.float32),
                                     (16, torch.bfloat16),
                                     (32, torch.bfloat16)])
@pytest.mark.parametrize("s", [1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 200])
def test_flash_bwd_scalar_route_at_tile_edges(cuda, s, d, dtype, group,
                                              causal):
    """K4's and K5's scalar routes (f32 at every D, bf16 at D 16 and 32)
    at the edges of their 8-row warps and 32-row tiles and at the
    training parity's S 200, at groups 1, 2 and 4: one launch of each,
    dQ, dK and dV against the plain version, and a second call bitwise
    equal."""
    assert kernel_route("flash_bwd_dkv", d, dtype) == "scalar"
    assert kernel_route("flash_bwd_dq", d, dtype) == "scalar"
    kvh = 2
    args = _bwd_inputs(cuda, 2, kvh * group, kvh, s, d, dtype,
                       s * 37 + d + group, causal)
    _native.reset_launches()
    got = flash_attention_shard_grads(*args, causal)
    torch.cuda.synchronize()
    assert _native.launches()["flash_bwd_dq"] == 1
    assert _native.launches()["flash_bwd_dkv"] == 1
    want = flash_attention_bwd_reference(*args, causal)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape, name
        assert torch.isfinite(gt.float()).all(), name
        torch.testing.assert_close(gt.float(), wt.float(), rtol=tol,
                                   atol=tol, msg=name)
    again = flash_attention_shard_grads(*args, causal)
    for name, a, g in zip(("dq", "dk", "dv"), again, got):
        assert torch.equal(a, g), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 32)])
@pytest.mark.parametrize("s", [200, 512, 2048])
def test_flash_bwd_scalar_route_rows_independent_of_the_grid(cuda, dtype, d,
                                                             s):
    """K4 and K5 pick their block size (8 to 64 rows) and, in K5, how
    many heads of a group share a block from B, H and S; each row's sums
    run in the same order whatever they pick, so batch row 2 of a B 4
    call is bitwise the B 1 call on that row alone."""
    for causal in (True, False):
        args = _bwd_inputs(cuda, 4, 16, 8, s, d, dtype, s + d, causal)
        got = flash_attention_shard_grads(*args, causal)
        one = flash_attention_shard_grads(*(t[2:3] for t in args), causal)
        torch.cuda.synchronize()
        for name, a, g in zip(("dq", "dk", "dv"), got, one):
            assert torch.equal(a[2:3], g), (name, causal)


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


# ----------------------------------------- kernels inside a CUDA graph


def _tiny_model(cuda):
    model = llama.Llama(llama.LLAMA_TINY, device=cuda)
    model.load_state_dict(llama.init_params(llama.LLAMA_TINY, seed=0,
                                            device=cuda), assign=True)
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_replayed_in_a_graph(cuda, dtype):
    """K1 at path (a)'s decode shape (4, 4096), captured with the copy
    of its output: the first call runs it and captures it, a replay on
    new input data matches the plain version; one launch a replay."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(4, 4096, generator=g, device=cuda).to(dtype)
    w = torch.rand(4096, generator=g, device=cuda) + 0.5
    y = torch.empty_like(x)
    step = graphs.CapturedStep(lambda: y.copy_(rmsnorm(x, w)), cuda)
    _native.reset_launches()
    step()
    x.copy_(torch.randn(4, 4096, generator=g, device=cuda).to(dtype))
    step()
    torch.cuda.synchronize()
    assert step.launches == {"rmsnorm_fwd": 1}
    assert _native.launches()["rmsnorm_fwd"] == 2
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(y, rmsnorm_reference(x, w), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_graphed_generate_equals_uncaptured_step(cuda, temperature):
    """llama-tiny: ``generate``'s replayed decode step against the same
    step run uncaptured (``DecodeLoop(capture=False)``), greedy and
    sampled from one seed: bitwise equal tokens."""
    model = _tiny_model(cuda)
    prompt = torch.randint(0, 256, (2, 9), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))

    def seeded():
        return torch.Generator(device=cuda).manual_seed(5)

    got = llama.generate(model, prompt, 12, temperature=temperature,
                         generator=seeded())
    loop = llama.DecodeLoop(model, 2, 128, temperature, capture=False)
    assert torch.equal(got, loop.run(prompt, 12, seeded()))


@pytest.mark.gpu
def test_graphed_generate_launch_counts_exact(cuda):
    """Launches through replays: each call counts K1 (2L + 1) times per
    token, K3 L times (the prefill) and K6 L times per decode step,
    whether its decode step was captured in the call (the first) or only
    replayed (the second, which captures nothing)."""
    model = _tiny_model(cuda)
    prompt = torch.randint(0, 256, (3, 5), device=cuda)
    n_layers, new = model.cfg.n_layers, 9
    before = graphs.captures()
    for _ in range(2):
        _native.reset_launches()
        llama.generate(model, prompt, new)
        torch.cuda.synchronize()
        assert _native.launches() == {
            "rmsnorm_fwd": (2 * n_layers + 1) * new,
            "flash_fwd": n_layers, "rmsnorm_bwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "decode_attn": n_layers * (new - 1),
            "mla_decode": 0, "moe_gemm_up": 0, "moe_gemm_down": 0,
            "moe_gemm_many": 0, "moe_combine": 0, "kda_recurrent": 0,
            "moe_rows_few": 0, "moe_experts_few": 0, "moe_rows_many": 0,
            "moe_experts_many": 0}
    assert graphs.captures() == before + 1


@pytest.mark.gpu
def test_graphed_generate_memo_holds_no_more_memory(cuda):
    """40 sampled calls, each with a fresh generator, share one captured
    loop: one capture, and the card's allocated bytes stay where the
    first call left them; deleting the model frees the loop's cache and
    graph at once."""
    model = _tiny_model(cuda)
    prompt = torch.randint(0, 256, (2, 9), device=cuda)
    llama._GEN_CACHE.clear()
    before, base = graphs.captures(), torch.cuda.memory_allocated(cuda)
    held = []
    for i in range(40):
        gen = torch.Generator(device=cuda).manual_seed(i)
        llama.generate(model, prompt, 6, temperature=0.8, generator=gen)
        held.append(torch.cuda.memory_allocated(cuda))
    assert graphs.captures() == before + 1 and len(llama._GEN_CACHE) == 1
    assert held[1:] == [held[0]] * 39 and held[0] > base
    del model
    assert not llama._GEN_CACHE
    assert torch.cuda.memory_allocated(cuda) < held[0]


CAPTURE_FAILS = """
import torch
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.rmsnorm import rmsnorm
from rocnrdma_tpu_torch.utils.graphs import CapturedStep
x = torch.randn(4, 64, device="cuda")
w = torch.ones(64, device="cuda")
step = CapturedStep(lambda: float(rmsnorm(x, w).sum()), x.device)
try:
    step()
except RuntimeError as exc:
    print("RAISED", _native.launches()["rmsnorm_fwd"], step.graph is None)
"""


@pytest.mark.gpu
def test_capture_failure_raises(cuda):
    """A step that syncs the host (``.item()``) cannot be captured: the
    call raises, no graph is kept, and only the warm-up's launch is
    counted. In a child process, so the failed capture leaves this one's
    context alone."""
    proc = subprocess.run([sys.executable, "-c", CAPTURE_FAILS],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["RAISED", "1", "True"], proc.stdout
