"""The port's backward ops against the JAX package's Pallas backward.

On the CPU the port's autograd functions run their kernels' plain
backward versions (:func:`rmsnorm_bwd_reference`,
:func:`flash_attention_bwd_reference`); those are held here against the
JAX package's Pallas backward kernels run in interpret mode, on the same
numpy inputs, at the tolerances of tests/test_ops.py (rmsnorm dx 1e-5
and dw 1e-4; attention 2e-3). The CUDA kernels themselves run only on a
card: tests/test_torch_kernels.py holds each against its plain version
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.ops.attention import (
    flash_attention_lse as jax_flash_attention_lse,
    flash_attention_shard_grads as jax_shard_grads)
from rocnrdma_tpu.ops.rmsnorm import _rmsnorm_bwd_pallas
from rocnrdma_tpu_torch.ops import _native
from rocnrdma_tpu_torch.ops.attention import (
    attention, flash_attention_bwd_reference, flash_attention_lse,
    flash_attention_shard_grads)
from rocnrdma_tpu_torch.ops.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                            rmsnorm_bwd_reference)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- RMSNorm


@pytest.mark.parametrize("shape", [(4, 160, 128), (300, 64), (3, 7, 48)])
def test_rmsnorm_bwd_matches_jax_pallas(shape):
    """Multi-block rows (640 and 300 > the Pallas kernel's 256-row
    block, so its sequential dw accumulation and the masked tail run),
    and 3-D input through the port's reshape."""
    x, g = _normal(0, shape), _normal(1, shape)
    w = _normal(2, shape[-1:]) + 1.0
    d = shape[-1]
    jdx, jdw = _rmsnorm_bwd_pallas(jnp.asarray(x.reshape(-1, d)),
                                   jnp.asarray(w),
                                   jnp.asarray(g.reshape(-1, d)), 1e-5,
                                   interpret=True)
    dx, dw = rmsnorm_bwd_reference(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(g))
    assert dx.shape == shape and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy().reshape(-1, d), np.asarray(jdx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-4)


def test_rmsnorm_autograd_is_the_plain_backward():
    """loss.backward() through the port's rmsnorm on CPU tensors runs
    rmsnorm_bwd_reference: the gradients are bitwise its outputs."""
    x = torch.from_numpy(_normal(3, (5, 9, 32))).requires_grad_()
    w = torch.from_numpy(_normal(4, (32,)) + 1.0).requires_grad_()
    g = torch.from_numpy(_normal(5, (5, 9, 32)))
    (rmsnorm(x, w) * g).sum().backward()
    dx, dw = rmsnorm_bwd_reference(x.detach(), w.detach(), g)
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    got = rmsnorm_bwd(x.detach(), w.detach(), g)
    assert torch.equal(got[0], dx) and torch.equal(got[1], dw)


def test_rmsnorm_bwd_keeps_bf16_dx_and_f32_dw():
    x = torch.from_numpy(_normal(6, (7, 64))).bfloat16().requires_grad_()
    w = torch.from_numpy(_normal(7, (64,)) + 1.0).requires_grad_()
    rmsnorm(x, w).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    assert torch.isfinite(x.grad.float()).all()


# ----------------------------------------------------------- attention


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,s,d", [(2, 4, 2, 96, 32),
                                         (1, 4, 4, 37, 16),
                                         (1, 2, 1, 37, 64)])
def test_flash_bwd_matches_jax_pallas(causal, b, h, kvh, s, d):
    """The port's plain backward and shard_grads against the JAX
    ``flash_attention_shard_grads`` through its Pallas dK/dV and dQ
    kernels in interpret mode (blocks of 64: S = 96 pads to 128 and 37
    is one short block), on the same out/lse from the JAX forward; GQA
    group sums included."""
    q, k, v, do = (_normal(10 + i, shp) for i, shp in enumerate(
        [(b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d)]))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = (np.array(a) for a in jax_flash_attention_lse(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True))
    want = jax_shard_grads(jq, jk, jv, jnp.asarray(out), jnp.asarray(lse),
                           jdo, causal=causal, block_q=64, block_k=64,
                           interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, out, lse, do)]
    for fn in (flash_attention_bwd_reference, flash_attention_shard_grads):
        got = fn(*args, causal=causal)
        for name, gt, wt, like in zip(("dq", "dk", "dv"), got, want,
                                      (q, k, v)):
            assert gt.shape == like.shape, name
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=2e-3, atol=2e-3, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_is_the_plain_backward(causal):
    """loss.backward() through the port's attention on CPU tensors runs
    flash_attention_bwd_reference on the saved out and lse: the
    gradients are bitwise its outputs."""
    q = torch.from_numpy(_normal(20, (2, 4, 19, 16))).requires_grad_()
    k = torch.from_numpy(_normal(21, (2, 2, 19, 16))).requires_grad_()
    v = torch.from_numpy(_normal(22, (2, 2, 19, 16))).requires_grad_()
    g = torch.from_numpy(_normal(23, (2, 4, 19, 16)))
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    (out * g).sum().backward()
    want = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                         out.detach(), lse, g, causal)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)


def test_backward_dispatch_counts_no_launch_and_refuses_other_devices():
    """CPU tensors take the plain versions in both directions and count
    no launch; a tensor on any other device raises in the forward and in
    the direct backward entry points."""
    _native.reset_launches()
    x = torch.randn(3, 16, requires_grad=True)
    w = torch.rand(16, requires_grad=True)
    rmsnorm(x, w).sum().backward()
    q = torch.randn(1, 2, 5, 16, requires_grad=True)
    kv = torch.randn(1, 1, 5, 16, requires_grad=True)
    attention(q, kv, kv).sum().backward()
    assert set(_native.launches().values()) == {0}
    meta = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm(meta, torch.empty(16, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rmsnorm_bwd(meta, torch.empty(16, device="meta"), meta)
    mq = torch.empty(1, 2, 5, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention(mq, mq, mq)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_shard_grads(mq, mq, mq, mq,
                                    torch.empty(1, 2, 5, 1, device="meta"),
                                    mq)
