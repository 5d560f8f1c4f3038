"""The port's training half (loss, gradients, remat, Trainer) against
the JAX package.

llama-tiny in f32 starts from the JAX package's own weights
(``init_params(PRNGKey(0))`` for the gradients, the JAX ``Trainer``'s
``params`` for the steps), carried over by ``params_from_flax``. On the
CPU the port runs its kernels' plain versions, forward and backward.

Tolerances, with their reasons:
- loss to 2e-4 (the JAX package's own tolerance for llama-tiny logits);
- gradients to rtol 1e-4 plus atol 1e-4 times the largest element of
  that parameter's JAX gradient: both sides sum in f32 in another order
  through two layers, and an element's error follows the size of the
  tensor's gradient, not of the element;
- parameters after the first AdamW step, where the step is decided: an
  element moves by lr * g / (|g| + eps) plus the decay, which is
  lr * sign(g) up to eps / |g|. Where the port's |g| exceeds 1e-2 of
  its tensor's largest gradient (so both sides' gradients, which agree
  to 1e-4 of that largest, share a sign and differ by at most 1e-2
  relative) and 1e-6 (so eps shifts the update by at most 1e-2 lr), the
  two sides differ by under 4e-8 from the gradients plus a few f32
  rounding steps of a parameter of size ~1: 2e-6, 150x under lr;
- parameters after three steps: at most one element in a thousand may
  differ by more than 1e-5 (on this data one of 106,816 does, by
  1.7e-5; the rest agree to ~4e-6). This count is the gate for the
  elements whose gradient is near zero: Adam turns any difference in
  such a gradient into up to ±lr per step, so their own bound,
  3 * 2 * lr, is checked too but can catch only a gross fault.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu.parallel.trainer import ElasticPolicy as JaxElasticPolicy
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu.parallel.trainer import loss_fn as jax_loss_fn
from rocnrdma_tpu_torch import trace
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import (ElasticPolicy, Trainer,
                                                   loss_fn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-4


@pytest.fixture(scope="module")
def tiny():
    params = jllama.init_params(jllama.make_model("llama-tiny"),
                                jax.random.PRNGKey(0))
    return params, tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _port_grads(state, tokens, **overrides):
    cfg = dataclasses.replace(tllama.LLAMA_TINY, **overrides)
    model = tllama.Llama(cfg, device="cpu")
    model.load_state_dict(state)
    loss = loss_fn(model, torch.from_numpy(tokens).long())
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def _assert_grads_close(got, jgrads):
    want = tllama.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("pallas", [False, True])
def test_loss_and_grads_match_jax(tiny, pallas):
    """Loss and every parameter's gradient against
    ``jax.value_and_grad(loss_fn)``; the JAX side once through its XLA
    reference and once through its Pallas kernels (forward and
    backward) in interpret mode."""
    params, state = tiny
    over = (dict(use_pallas_attention=True, use_pallas_rmsnorm=True,
                 pallas_interpret=True) if pallas else {})
    model = jllama.make_model("llama-tiny", **over)
    tok = _tokens(0, (2, 21))                 # S = 20, not a block multiple
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(model, p, jnp.asarray(tok)))(params)
    loss, grads = _port_grads(state, tok)
    assert abs(loss - float(jloss)) <= LOSS_TOL
    _assert_grads_close(grads, jgrads)


def test_remat_gives_the_same_gradients(tiny):
    """remat=True recomputes each block in the backward; the gradients
    are those of remat=False (the recompute is the same plain math on the
    same inputs, so they agree bitwise)."""
    _, state = tiny
    tok = _tokens(1, (2, 17))
    loss_a, ga = _port_grads(state, tok, remat=False)
    loss_b, gb = _port_grads(state, tok, remat=True)
    assert loss_a == loss_b
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def _assert_decided_elements_agree(trainer, jparams):
    """After one step from equal weights: every element whose gradient
    decides its update agrees to 2e-6 (module docstring)."""
    want = tllama.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
    decided = 0
    for name, p in trainer.model.named_parameters():
        g = p.grad.abs()
        mask = (g > 1e-2 * g.max()) & (g > 1e-6)
        diff = (p.detach() - want[name]).abs()[mask]
        assert diff.numel() == 0 or float(diff.max()) <= 2e-6, name
        decided += diff.numel()
    assert decided > 0


def _three_steps_against_jax(**overrides):
    """Three ``Trainer.step``s on the same tokens as the JAX
    ``Trainer("llama-tiny", {"dp": 1, "tp": 1}, **overrides)`` from its
    own initial params: losses to 2e-4 at each step, the decided
    elements after the first step to 2e-6, and the params after the
    third step by the count in the module docstring."""
    jt = JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, **overrides)
    state0 = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))
    pt = Trainer("llama-tiny", {"dp": 1, "tp": 1}, device="cpu",
                 params=state0, **overrides)
    tok = _tokens(2, (2, 33))
    for step in range(3):
        jl = jt.step(jnp.asarray(tok))
        tl = pt.step(torch.from_numpy(tok))
        assert abs(tl - jl) <= LOSS_TOL, (step, tl, jl)
        if step == 0:
            _assert_decided_elements_agree(pt, jt.params)
    assert pt.global_step == jt.global_step == 3
    lr = 3e-4
    want = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))
    got = pt.model.state_dict()
    moved, far, total = 0.0, 0, 0
    for name, w in want.items():
        diff = np.abs(got[name].numpy() - w.numpy())
        assert float(diff.max()) <= 3 * 2 * lr + 1e-6, name
        far += int((diff > 1e-5).sum())
        total += diff.size
        moved = max(moved, float(np.abs(w.numpy()
                                        - state0[name].numpy()).max()))
    assert far <= total // 1000, (far, total)
    assert moved > lr                         # the params did move


def test_three_steps_match_the_jax_trainer():
    _three_steps_against_jax()


def test_dots_three_steps_match_the_jax_dots_trainer():
    """The same against the JAX trainer under ``remat_policy="dots"``
    (``nn.remat`` with ``dots_with_no_batch_dims_saveable``)."""
    _three_steps_against_jax(remat=True, remat_policy="dots")


@pytest.mark.parametrize("mesh", [None, {"dp": 2, "tp": 2}],
                         ids=["single", "dp2tp2"])
def test_dots_gives_the_gradients_of_full(tiny, mesh):
    """``remat_policy="dots"`` keeps the projections' outputs instead of
    recomputing them: the same values, so the gradients are bitwise
    those of "full", on one device and on a mesh; and the step runs
    fewer ``aten.mm`` (the kept products are not recomputed) and as many
    ``aten.bmm`` (the attention, recomputed) as under "full"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            key = str(func.overloadpacket)
            self.ops[key] = self.ops.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    _, state = tiny
    tok = torch.from_numpy(_tokens(12, (4, 17))).long()
    grads, ops = {}, {}
    for policy in ("full", "dots"):
        tr = Trainer("llama-tiny", mesh, device="cpu", params=state,
                     devices=["cpu"] * 4 if mesh else None, remat=True,
                     remat_policy=policy)
        tr._zero_grad()
        with Count() as count:
            tr._backward(tok)        # on a mesh also the copies' sums
        ops[policy] = count.ops
        grads[policy] = tr.grads_tree()
    pairs = zip(jax.tree_util.tree_leaves(grads["full"]),
                jax.tree_util.tree_leaves(grads["dots"]))
    assert all(torch.equal(a, b) for a, b in pairs)
    assert ops["dots"]["aten.mm"] < ops["full"]["aten.mm"]
    assert ops["dots"]["aten.bmm"] == ops["full"]["aten.bmm"] > 0


def test_bogus_remat_policy_raises_as_jax():
    with pytest.raises(ValueError) as jax_err:
        jllama.make_model("llama-tiny", remat_policy="bogus")
    with pytest.raises(ValueError) as torch_err:
        Trainer("llama-tiny", device="cpu", remat=True,
                remat_policy="bogus")
    assert str(torch_err.value) == str(jax_err.value) == (
        "remat_policy='bogus': must be 'full' or 'dots'")


def test_step_runs_in_the_fused_step_span_and_loss_falls():
    trace.reset()
    tr = Trainer("llama-tiny", device="cpu", seed=3, learning_rate=1e-2)
    tok = torch.from_numpy(_tokens(3, (2, 17)))
    losses = [tr.step(tok) for _ in range(4)]
    assert losses[-1] < losses[0]
    spans = trace.events("trainer.fused_step")
    assert [e[2]["step"] for e in spans] == [1, 2, 3, 4]
    assert trace.counter("trainer.step") == 4


def test_trainer_copies_the_given_weights():
    """The weights handed in stay untouched by training, even when that
    state dict was loaded elsewhere with ``assign=True`` (which leaves
    an "assign" flag in its metadata)."""
    state = tllama.init_params(tllama.LLAMA_TINY, seed=1, device="cpu")
    tllama.Llama(tllama.LLAMA_TINY, device="cpu").load_state_dict(
        state, assign=True)
    before = {k: v.clone() for k, v in state.items()}
    tr = Trainer("llama-tiny", device="cpu", params=state)
    tr.step(torch.from_numpy(_tokens(6, (1, 9))))
    for name, t in state.items():
        assert torch.equal(t, before[name]), name
        assert tr.model.state_dict()[name].data_ptr() != t.data_ptr()


@pytest.mark.parametrize("mesh_shape,devices", [
    (None, None),
    ({"dp": 2, "tp": 1}, ["cpu"] * 2),
], ids=["single", "dp2"])
def test_elastic_without_sync_refused_as_jax(mesh_shape, devices):
    """``elastic=`` without ``cross_slice_sync`` has no transport world
    to recover: the port refuses it as the JAX trainer does, with the same
    type and message, on one device and on a mesh."""
    with pytest.raises(ValueError) as jax_err:
        JaxTrainer("llama-tiny", mesh_shape or {"dp": 1, "tp": 1},
                   elastic=JaxElasticPolicy("unused"))
    with pytest.raises(ValueError) as torch_err:
        Trainer("llama-tiny", mesh_shape, devices=devices, device="cpu",
                elastic=ElasticPolicy("unused"))
    assert type(torch_err.value) is type(jax_err.value)
    assert str(torch_err.value) == str(jax_err.value) == (
        "elastic= recovers the cross-slice transport world and requires "
        "cross_slice_sync")


def test_plain_sync_gets_the_flax_shaped_tree():
    """A plain callable ``cross_slice_sync`` is called once per step, in
    the ``trainer.sync`` span, with the gradients as a tree shaped like
    ``params_to_flax``'s (``{"params": {"embed": {"embedding": g},
    "layer_0": {"attn": {"wq": {"kernel": g}}, ...}}}``) holding the
    parameters' own ``.grad`` tensors; what it returns becomes the
    gradients AdamW applies, and the first call comes after
    ``set_step_token(0)``."""
    calls, tokens_seen = [], []

    class Halve:
        def set_step_token(self, step):
            tokens_seen.append(step)

        def __call__(self, tree):
            calls.append(tree)
            return jax.tree_util.tree_map(lambda g: g * 0.5, tree)

    trace.reset()
    tr = Trainer("llama-tiny", device="cpu", seed=2,
                 cross_slice_sync=Halve())
    ref = Trainer("llama-tiny", device="cpu", seed=2)
    tok = torch.from_numpy(_tokens(7, (2, 9)))
    assert tr.step(tok) == ref.step(tok)
    params = dict(tr.model.named_parameters())
    # The synced gradients are what AdamW applied: exactly half the
    # plain trainer's.
    for name, p in ref.model.named_parameters():
        assert torch.equal(p.grad * 0.5, params[name].grad), name
    tr.step(tok)
    assert tokens_seen == [0] and len(calls) == 2
    tree = calls[0]["params"]
    want = tllama.params_to_flax(dict(tr.model.named_parameters()))
    assert jax.tree_util.tree_structure(calls[0]) == \
        jax.tree_util.tree_structure(want)
    assert tree["layer_1"]["attn"]["wq"]["kernel"].shape == (64, 64)
    # The tree holds the parameters' own .grad tensors (which the
    # returned halves then overwrote in place).
    got = calls[1]["params"]["layer_0"]["mlp"]["w_up"]["kernel"]
    assert got is params["layers.0.mlp.w_up"].grad
    assert [e[2]["step"] for e in trace.events("trainer.sync")] == [1, 2]
    # Only the plain trainer's step ran in the fused-step span.
    assert len(trace.events("trainer.fused_step")) == 1


def test_cross_entropy_is_the_mean_nll():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, 11)).astype(np.float32))
    targets = torch.from_numpy(_tokens(5, (2, 5)) % 11).long()
    want = np.asarray(jllama.cross_entropy_loss(
        jnp.asarray(logits.numpy()), jnp.asarray(targets.numpy())))
    got = tllama.cross_entropy_loss(logits, targets)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_example_trains_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "examples/train_single_chip_torch.py", "--cpu",
         "--steps", "2", "--seq", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "step 1: loss=" in proc.stdout and "tokens/s" in proc.stdout
