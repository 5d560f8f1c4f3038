"""The rounding points of the tensor-core route of K3, K4 and K5,
emulated in plain PyTorch on the CPU, against the JAX package and the
port's plain versions.

On the card, the bf16 instances at D 64 and 128 of ``csrc/flash_fwd.cu``
(K3), ``csrc/flash_bwd_dkv.cu`` (K4) and ``csrc/flash_bwd_dq.cu`` (K5)
multiply bf16 operands into f32 sums on the tensor cores, and round to
bf16 where the plain versions keep f32:

- K3 walks key tiles of 64 with an online softmax in log2 units and
  rounds P (relative to the running max) to bf16 before P·V;
- K4 rebuilds Pᵀ and dSᵀ in f32 by the shared rule and rounds both to
  bf16 before dV += Pᵀ·dO and dK += dSᵀ·Q;
- K5 rebuilds dS in f32 by the same rule and rounds it to bf16 before
  dQ += dS·K.

This file repeats those steps in PyTorch (``tc_forward``,
``tc_backward``) and holds them, at small bf16 shapes (B 1, H 4, KVH 2,
S 100, D 64; and GQA groups 1, 2 and 4 at S 100 and 129, made with numpy
from a seed), to ``chip_smoke.py``'s bf16 tolerance (2e-2 relative and
absolute; lse 2e-4) against two references: the JAX package's
``flash_attention_lse`` and ``flash_attention_shard_grads`` (Pallas
kernels in interpret mode) and the port's plain versions. So the bf16
roundings the route adds are shown to fit the tolerance the card's
checks use, without a card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.ops.attention import (
    flash_attention_lse as jax_flash_attention_lse,
    flash_attention_shard_grads as jax_shard_grads)
from rocnrdma_tpu_torch.ops.attention import (
    flash_attention_bwd_reference, flash_attention_lse_reference)

B, H, KVH, S, D = 1, 4, 2, 100, 64
TILE = 64
RTOL = ATOL = 2e-2      # chip_smoke.py TOL[("flash", torch.bfloat16)]
LSE_TOL = 2e-4          # chip_smoke.py TOL[("lse", None)]


def _bf16_inputs(seed, h=H, kvh=KVH, s=S):
    rng = np.random.default_rng(seed)
    shapes = [(B, h, s, D), (B, kvh, s, D), (B, kvh, s, D), (B, h, s, D)]
    return [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
            .to(torch.bfloat16) for shp in shapes]


def _to_jax(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _visible(s, causal):
    qi = torch.arange(s).view(s, 1)
    kj = torch.arange(s).view(1, s)
    return (kj <= qi) if causal else torch.ones(s, s, dtype=torch.bool)


def tc_forward(q, k, v, causal):
    """K3's tensor-core route: f32 sums of bf16 products, online
    softmax over key tiles of 64 in log2 units, P rounded to bf16
    before P·V; out in bf16, lse = m·ln 2 + log(max(l, 1e-30))."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    sl2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    vis = _visible(s, causal)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    for k0 in range(0, s, TILE):
        k1 = min(k0 + TILE, s)
        sc = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * sl2
        sc = sc.masked_fill(~vis[:, k0:k1], -math.inf)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(sc - mx)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k1]
        m = mx
    lc = l.clamp_min(1e-30)
    return (o / lc).to(torch.bfloat16), m * math.log(2.0) + torch.log(lc)


def tc_backward(q, k, v, out, lse, do, causal, round_products=True):
    """K4's and K5's tensor-core routes (dK, dV; dQ): p and ds by the
    shared rule in f32, then P and dS rounded to bf16 before their
    products dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K
    (``round_products=False`` keeps them f32, which is the plain
    versions' arithmetic)."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    sc = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = qf @ kf.transpose(-1, -2)
    p = torch.where(_visible(s, causal), torch.exp(scores * sc - lse), 0.0)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * sc
    if round_products:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    dq = ds @ kf
    dv = (p.transpose(-1, -2) @ dof).view(b, kvh, g, s, d).sum(2)
    dk = (ds.transpose(-1, -2) @ qf).view(b, kvh, g, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward_reference(which, q, k, v, causal):
    if which == "jax":
        out, lse = jax_flash_attention_lse(
            _to_jax(q), _to_jax(k), _to_jax(v), causal=causal, block_q=64,
            block_k=64, interpret=True)
        return (torch.from_numpy(np.array(out, dtype=np.float32)),
                torch.from_numpy(np.array(lse, dtype=np.float32)))
    return flash_attention_lse_reference(q, k, v, causal=causal)


def _backward_reference(which, q, k, v, out, lse, do, causal):
    if which == "jax":
        got = jax_shard_grads(_to_jax(q), _to_jax(k), _to_jax(v),
                              _to_jax(out), jnp.asarray(lse.numpy()),
                              _to_jax(do), causal=causal, block_q=64,
                              block_k=64, interpret=True)
        return [torch.from_numpy(np.array(a, dtype=np.float32))
                for a in got]
    return flash_attention_bwd_reference(q, k, v, out, lse, do, causal)


@pytest.mark.parametrize("which", ["jax", "plain"])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_forward_rounding_within_bf16_tolerance(which, causal):
    q, k, v, _ = _bf16_inputs(0)
    out, lse = tc_forward(q, k, v, causal)
    want_o, want_l = _forward_reference(which, q, k, v, causal)
    assert out.shape == (B, H, S, D) and lse.shape == (B, H, S, 1)
    np.testing.assert_allclose(out.float().numpy(), want_o.float().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_l.numpy(), rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.parametrize("which", ["jax", "plain"])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_backward_rounding_within_bf16_tolerance(which, causal):
    q, k, v, do = _bf16_inputs(1)
    out, lse = flash_attention_lse_reference(q, k, v, causal=causal)
    got = tc_backward(q, k, v, out, lse, do, causal)
    want = _backward_reference(which, q, k, v, out, lse, do, causal)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.shape == wt.shape, name
        np.testing.assert_allclose(gt.float().numpy(), wt.float().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("which", ["jax", "plain"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [100, 129])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_tc_backward_rounding_across_gqa_groups(group, s, causal, which):
    """K4's and K5's rounding at GQA groups 1, 2 and 4 and ragged S (one
    and two kv tiles past a tile edge): dK and dV sum the group, dQ reads
    its kv head in place."""
    q, k, v, do = _bf16_inputs(10 * group + s, h=KVH * group, s=s)
    out, lse = flash_attention_lse_reference(q, k, v, causal=causal)
    got = tc_backward(q, k, v, out, lse, do, causal)
    want = _backward_reference(which, q, k, v, out, lse, do, causal)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.shape == wt.shape, name
        np.testing.assert_allclose(gt.float().numpy(), wt.float().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_tc_emulation_rounds_where_the_plain_version_does_not(causal):
    """The emulation is not the plain arithmetic under another name:
    its bf16 P and dS move the outputs, by less than the tolerance."""
    q, k, v, do = _bf16_inputs(2)
    out, lse = tc_forward(q, k, v, causal)
    plain_o, _ = flash_attention_lse_reference(q, k, v, causal=causal)
    assert not torch.equal(out, plain_o)
    torch.testing.assert_close(out.float(), plain_o.float(), rtol=RTOL,
                               atol=ATOL)
    rounded = tc_backward(q, k, v, out, lse, do, causal)
    exact = tc_backward(q, k, v, out, lse, do, causal, round_products=False)
    for name, r, e in zip(("dq", "dk", "dv"), rounded, exact):
        assert not torch.equal(r, e), name
        torch.testing.assert_close(r.float(), e.float(), rtol=RTOL,
                                   atol=ATOL, msg=name)
