"""The port's sequence-parallel trainer (``rocnrdma_tpu_torch.parallel.
seq_parallel``) against the JAX package and the port's own single-device
``Trainer``.

Ranks are threads of this process on the emu engine (the example runs
as rank processes); on the CPU the port runs its kernels' plain
versions. llama-tiny in f32; tokens from numpy seeds; each rank takes
its contiguous shard of one global batch.

1. Logits: each rank's ``SeqParallelTrainer.forward`` against the JAX
   ``SeqParallelTrainer.forward`` at world 2 on the same weights
   (``params_from_flax``), 2e-4.
2. Training: 3 SGD steps at world 2, ring and Ulysses, against the JAX
   single-host reference (``jax.value_and_grad`` on the flax model over
   the whole sequence): global losses 2e-4, parameters rtol 1e-3 /
   atol 1e-4; worlds 3 and 4 (ring) against the port's single-device
   ``Trainer`` on the same weights; ranks hold bitwise-equal parameters.
3. Remat checkpoints the two halves only: the same gradients, bitwise,
   and the same rotations as without remat.
4. A global length over ``max_seq_len`` raises on every rank; the
   checkpoint round-trip; the ``Trainer(seq_parallel=)`` front door and
   its refusals; ``examples/seq_parallel_train_torch.py --cpu`` as two
   rank processes prints equal digests in both modes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu.parallel.seq_parallel import \
    SeqParallelTrainer as JaxSeqParallelTrainer
from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
from rocnrdma_tpu_torch.collectives.ring_attention import RingAttention
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
from rocnrdma_tpu_torch.parallel.seq_parallel import SeqParallelTrainer
from rocnrdma_tpu_torch.parallel.trainer import ElasticPolicy, Trainer

from test_hier import port_band
from test_torch_ring_attention import run_threads, torch_worlds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-4


def sgd(lr):
    return lambda ps: torch.optim.SGD(ps, lr=lr)


def on_ranks(n, fn):
    """fn(rank, world) on a torch world of n threads."""
    worlds = torch_worlds(n)
    try:
        return run_threads(n, lambda r: fn(r, worlds[r]))
    finally:
        for w in worlds:
            w.close()


def split(tok, r, s_local):
    sl = slice(r * s_local, (r + 1) * s_local)
    return tok[:, :-1][:, sl], tok[:, 1:][:, sl]


def test_logits_against_the_jax_package():
    world, s_local = 2, 16
    inputs = np.random.default_rng(0).integers(
        0, 256, (2, world * s_local)).astype(np.int32)
    jw = jax_worlds(world, port_band(16))

    def jrank(r):
        tr = JaxSeqParallelTrainer("llama-tiny", jw[r], seed=0,
                                   interpret=True)
        sl = slice(r * s_local, (r + 1) * s_local)
        out = np.asarray(tr.forward(tr.params, inputs[:, sl]))
        params = jax.tree_util.tree_map(np.asarray, tr.params)
        tr.close()
        return out, params
    try:
        want = run_threads(world, jrank)
    finally:
        for w in jw:
            w.close()
    state = tllama.params_from_flax(want[0][1])

    def rank(r, w):
        tr = SeqParallelTrainer("llama-tiny", w, device="cpu", params=state)
        sl = slice(r * s_local, (r + 1) * s_local)
        out = tr.forward(inputs[:, sl])
        tr.close()
        return out
    got = on_ranks(world, rank)
    for r in range(world):
        np.testing.assert_allclose(got[r].numpy(), want[r][0], rtol=2e-4,
                                   atol=2e-4, err_msg=f"rank {r}")


def train_ranks(world, mode, data, s_local, lr, state, **over):
    """Each rank's global losses and final state dict."""
    def rank(r, w):
        tr = SeqParallelTrainer("llama-tiny", w, device="cpu", params=state,
                                optimizer=sgd(lr), sp_mode=mode, **over)
        losses = [tr.step(*split(tok, r, s_local)) for tok in data]
        assert tr.global_step == len(data)
        sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
        tr.close()
        return losses, sd
    res = on_ranks(world, rank)
    for losses, sd in res[1:]:
        assert losses == res[0][0]
        for name, t in sd.items():
            assert torch.equal(t, res[0][1][name]), name
    return res[0]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_training_against_the_jax_single_host_reference(mode):
    world, s_local, lr, steps = 2, 16, 5e-2, 3
    rng = np.random.default_rng(world)
    data = [rng.integers(0, 256, (2, world * s_local + 1)).astype(np.int32)
            for _ in range(steps)]
    model = jllama.make_model("llama-tiny")
    params = jllama.init_params(model, jax.random.PRNGKey(0))
    state = tllama.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))
    losses, sd = train_ranks(world, mode, data, s_local, lr, state)

    tx = optax.sgd(lr)
    opt = tx.init(params)

    @jax.jit
    def ref_step(p, o, tok):
        loss, g = jax.value_and_grad(
            lambda p_: jllama.cross_entropy_loss(model.apply(p_, tok[:, :-1]),
                                                 tok[:, 1:]))(p)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), o, loss

    want = []
    for tok in data:
        params, opt, loss = ref_step(params, opt, jnp.asarray(tok))
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    ref = tllama.params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, w in ref.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("world", [3, 4])
def test_wider_rings_against_the_single_device_trainer(world):
    s_local, lr, steps = 8, 5e-2, 3
    rng = np.random.default_rng(world)
    data = [rng.integers(0, 256, (2, world * s_local + 1))
            for _ in range(steps)]
    state = tllama.init_params(tllama.LLAMA_TINY, seed=4, device="cpu")
    losses, sd = train_ranks(world, "ring", data, s_local, lr, state)
    ref = Trainer("llama-tiny", device="cpu", params=state)
    ref.opt = sgd(lr)(ref.model.parameters())
    want = [ref.step(torch.from_numpy(tok)) for tok in data]
    np.testing.assert_allclose(losses, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    for name, w in ref.model.state_dict().items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_remat_changes_no_gradient_and_no_rotation(monkeypatch):
    world, s_local = 2, 16
    tok = np.random.default_rng(11).integers(0, 256, (1, world * s_local + 1))
    state = tllama.init_params(tllama.LLAMA_TINY, seed=2, device="cpu")
    posted = {}
    real = RingAttention._post_rot

    def counting(self, *args):
        posted[id(self)] = posted.get(id(self), 0) + 1
        return real(self, *args)
    monkeypatch.setattr(RingAttention, "_post_rot", counting)

    def run(remat):
        def rank(r, w):
            tr = SeqParallelTrainer("llama-tiny", w, device="cpu",
                                    params=state, remat=remat)
            posted[id(tr.attn)] = 0
            loss = tr.forward_backward(*split(tok, r, s_local))
            grads = {n: p.grad.clone()
                     for n, p in tr.model.named_parameters()}
            tr.close()
            return loss, grads, posted.pop(id(tr.attn))
        return on_ranks(world, rank)

    plain, remat = run(False), run(True)
    for (l0, g0, n0), (l1, g1, n1) in zip(plain, remat):
        assert l0 == l1
        # 2 layers: a forward (1 rotation) and a backward (1 + 2) each
        assert n0 == n1 == 2 * 4
        for name in g0:
            assert torch.equal(g0[name], g1[name]), name


def test_global_length_over_max_seq_len_raises_on_every_rank():
    s_local = tllama.LLAMA_TINY.max_seq_len // 2 + 1

    def rank(r, w):
        tr = SeqParallelTrainer("llama-tiny", w, device="cpu")
        with pytest.raises(ValueError, match="max_seq_len"):
            tr.step(np.zeros((1, s_local), np.int64),
                    np.zeros((1, s_local), np.int64))
        tr.close()
        return True
    assert all(on_ranks(2, rank))


def test_checkpoint_round_trip(tmp_path):
    world, s_local = 2, 16
    tok = np.random.default_rng(5).integers(0, 256, (1, world * s_local + 1))

    def rank(r, w):
        tr = SeqParallelTrainer("llama-tiny", w, device="cpu", seed=1)
        batch = split(tok, r, s_local)
        tr.step(*batch)
        snap = {k: v.clone() for k, v in tr.model.state_dict().items()}
        path = str(tmp_path / f"rank{r}")
        save_checkpoint(path, tr, 1)
        tr.step(*batch)                            # diverge
        assert restore_checkpoint(path, tr) == 1 == tr.global_step
        for name, t in tr.model.state_dict().items():
            assert torch.equal(t, snap[name]), name
        loss = tr.step(*batch)                     # trains on, in step
        tr.close()
        return loss
    losses = on_ranks(world, rank)
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_front_door_dispatches_and_refuses():
    def rank(r, w):
        tr = Trainer("llama-tiny", seq_parallel=w, device="cpu",
                     sp_mode="ulysses")
        assert isinstance(tr, SeqParallelTrainer) and tr.sp_mode == "ulysses"
        tr.close()
        for kw in (dict(mesh_shape={"dp": 1, "tp": 1}),
                   dict(cross_slice_sync=lambda g: g),
                   dict(elastic=ElasticPolicy("unused"))):
            with pytest.raises(ValueError, match="does not apply"):
                Trainer("llama-tiny", seq_parallel=w, device="cpu", **kw)
        with pytest.raises(ValueError, match="mesh_shape"):
            Trainer("llama-tiny", {"dp": 1}, seq_parallel=w, device="cpu")
        return True
    assert all(on_ranks(2, rank))
    with pytest.raises(ValueError, match="requires seq_parallel"):
        Trainer("llama-tiny", device="cpu", sp_mode="ring")
    with pytest.raises(ValueError, match="sp_mode"):
        SeqParallelTrainer("llama-tiny", None, device="cpu", sp_mode="zig")


def test_ulysses_indivisible_heads_raise_on_every_rank():
    def rank(r, w):
        # llama-tiny's 2 kv heads do not divide 3
        with pytest.raises(ValueError, match="divide"):
            SeqParallelTrainer("llama-tiny", w, device="cpu",
                               sp_mode="ulysses")
        return True
    assert all(on_ranks(3, rank))


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_example_ranks_print_equal_digests(mode):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "seq_parallel_train_torch.py"),
         "--cpu", "--steps", "2", "--mode", mode, "--engine", "emu",
         "--port", str(port_band(16))],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    by_rank = [{ln["step"]: ln for ln in lines
                if ln["rank"] == r and "step" in ln} for r in range(2)]
    assert sorted(by_rank[0]) == sorted(by_rank[1]) == [0, 1, 2]
    for step in range(3):
        assert by_rank[0][step]["digest"] == by_rank[1][step]["digest"]
    for step in (1, 2):
        a, b = by_rank[0][step], by_rank[1][step]
        assert a["loss"] == b["loss"] and np.isfinite(a["loss"])
        assert a["attn_calls"] == 4 and a["attn_wire_bytes"] > 0
    assert "sequence-parallel demo OK" in proc.stdout
