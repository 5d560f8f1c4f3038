"""The port's checkpoint (``rocnrdma_tpu_torch/parallel/checkpoint.py``)
against its own round trip and against the JAX package's format.

- a llama-tiny ``Trainer`` after two AdamW steps, saved and restored
  into a trainer built from other weights (fresh, or after a step of
  its own, so the optimizer state is created or overwritten in place),
  has bitwise the same params, optimizer state and step, in bf16 and in
  f32, and the next step of both is bitwise equal;
- a checkpoint of another config is refused;
- the file is published whole or not at all (a save that fails half way
  leaves the previous checkpoint as it was);
- for the same llama-tiny weights (the JAX ``Trainer``'s, carried over
  by ``params_from_flax``) the ``params/`` keys, the bf16 leaves'
  ``uint16`` bits and their ``__dtype__`` tags equal those of the JAX
  package's ``save_checkpoint``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.parallel import checkpoint as jckpt
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel import checkpoint as ckpt
from rocnrdma_tpu_torch.parallel.trainer import Trainer


def _tokens(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (2, 17)))


def _opt_state(tr):
    return [{k: v.clone() for k, v in tr.opt.state[p].items()}
            for p in tr.model.parameters()]


@pytest.mark.parametrize("stepped", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_is_bitwise(tmp_path, dtype, stepped):
    tr = Trainer("llama-tiny", device="cpu", seed=1, learning_rate=1e-2,
                 dtype=dtype)
    for s in range(2):
        tr.step(_tokens(s))
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, tr, tr.global_step)
    assert ckpt.checkpoint_file(path) == path + ".npz"

    other = Trainer("llama-tiny", device="cpu", seed=2, learning_rate=1e-2,
                    dtype=dtype)
    if stepped:
        other.step(_tokens(5))
    params = [p for p in other.model.parameters()]
    states = [other.opt.state.get(p, {}).get("exp_avg_sq")
              for p in params]
    assert ckpt.restore_checkpoint(path, other) == 2
    assert other.global_step == 2
    # In place: the trainer's parameter tensors are the same objects.
    assert all(a is b for a, b in zip(params, other.model.parameters()))
    if stepped:
        assert all(other.opt.state[p]["exp_avg_sq"] is t
                   for p, t in zip(params, states))
    for (name, a), b in zip(tr.model.named_parameters(),
                            other.model.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for sa, sb in zip(_opt_state(tr), _opt_state(other)):
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, k
            assert sa[k].device == sb[k].device, k
            assert torch.equal(sa[k], sb[k]), k
    la, lb = tr.step(_tokens(9)), other.step(_tokens(9))
    assert la == lb
    for a, b in zip(tr.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


def test_restore_refuses_another_config(tmp_path):
    tr = Trainer("llama-tiny", device="cpu", seed=1)
    tr.step(_tokens(0))
    ckpt.save_checkpoint(str(tmp_path / "ck"), tr, 1)
    cfg = dataclasses.replace(tllama.LLAMA_TINY, name="llama-tiny-b")
    with pytest.raises(ValueError, match="checkpoint is for config"):
        ckpt.restore_checkpoint(str(tmp_path / "ck"), Trainer(cfg,
                                                              device="cpu"))


def test_publish_is_atomic(tmp_path, monkeypatch):
    tr = Trainer("llama-tiny", device="cpu", seed=1)
    tr.step(_tokens(0))
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, tr, 1)
    before = open(path + ".npz", "rb").read()
    tr.step(_tokens(1))

    written = []
    real_write = ckpt._write

    def failing_write(zf, key, arr):
        if len(written) == 7:
            raise OSError("disk full")
        written.append(key)
        real_write(zf, key, arr)

    monkeypatch.setattr(ckpt, "_write", failing_write)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(path, tr, 2)
    monkeypatch.undo()
    assert open(path + ".npz", "rb").read() == before
    fresh = Trainer("llama-tiny", device="cpu", seed=3)
    assert ckpt.restore_checkpoint(path, fresh) == 1

    replaced = []
    real_replace = ckpt.os.replace
    monkeypatch.setattr(ckpt.os, "replace",
                        lambda a, b: (replaced.append((a, b)),
                                      real_replace(a, b)))
    ckpt.save_checkpoint(path, tr, 2)
    assert replaced == [(path + ".npz.tmp.npz", path + ".npz")]
    assert ckpt.restore_checkpoint(path, fresh) == 2


def test_params_keys_and_bf16_encoding_equal_the_jax_checkpoint(tmp_path):
    jt = JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=0,
                    dtype=jnp.bfloat16)
    state = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))
    tr = Trainer("llama-tiny", device="cpu", dtype=torch.bfloat16,
                 params=state)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jt, 0)
    ckpt.save_checkpoint(str(tmp_path / "torch"), tr, 0)

    def params_part(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files
                    if k.startswith(("params/", "__dtype__/params/"))}

    want = params_part(tmp_path / "jax.npz")
    got = params_part(tmp_path / "torch.npz")
    assert sorted(got) == sorted(want)
    tags = [k for k in want if k.startswith("__dtype__/")]
    assert tags and all(bytes(want[k]) == b"bfloat16" for k in tags)
    assert len(tags) == sum(1 for p in tr.model.parameters()
                            if p.dtype == torch.bfloat16)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        assert got[key].shape == w.shape, key
        assert got[key].tobytes() == w.tobytes(), key
    assert want["params/params/embed/embedding"].dtype == np.uint16
