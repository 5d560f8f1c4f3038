"""Data-parallel training across slices in the PyTorch port, against
the JAX package (in-process ranks, one thread each, emu engine).

1. A mixed ring: rank 0 is the JAX package's ``CrossSliceAllReduce``
   over its own ``RingWorld`` and library, rank 1 the port's shim over
   the port's. Their schedule digests agree, and both ranks end with
   bitwise the sum (or the mean) — at world 2 each element is one
   addition, so the sum is bitwise ``a + b`` and the mean ``(a + b)/2``.
   The tree holds equally sized leaves in nested dicts: summing them
   against each other in the wrong order would pass the digest (which
   holds sizes only) and fail here.
2. Two torch slices, each a llama-tiny ``Trainer`` whose gradients are
   averaged by ``CrossSliceAllReduce(mean=True)``, against one
   ``Trainer`` on the combined batch: the mean of the slices' losses
   agrees with the combined loss within 5e-3 (the JAX package's own
   bound for the same test), and the slices' parameters are bitwise
   equal to each other.
3. Two torch slices against two JAX slices from the same weights
   (``params_from_flax``) on the same batches, for 2 steps: each slice's
   loss to ``LOSS_TOL`` (2e-4), the decided elements after the first
   step to 2e-6 and the parameters after the second by the count rule
   of ``tests/test_torch_trainer.py``.
4. A JAX ``Trainer`` and a torch ``Trainer`` on one ring for one step:
   the all-reduced gradients are bitwise equal by name on both ranks,
   and bitwise the mean of the two ranks' gradients.
5. ``examples/two_slice_dp_torch.py --cpu --steps 2`` exits with 0 and
   its two ranks print equal parameter digests after every step.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.jax_shim import \
    CrossSliceAllReduce as JaxShim
from rocnrdma_tpu.collectives.world import RingWorld as JaxWorld
from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu.transport.engine import Engine as JaxEngine
from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import RingWorld, local_worlds
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from rocnrdma_tpu_torch.transport.engine import Engine

from test_torch_world import run_ranks
from test_hier import port_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 2e-4


def mixed_worlds():
    """Rank 0 on the JAX package's library, rank 1 on the port's."""
    port = port_band(8)
    out = [None, None]

    def boot(r):
        out[r] = (JaxWorld(JaxEngine("emu"), 0, 2, port) if r == 0
                  else RingWorld(Engine("emu"), 1, 2, port))

    ts = [threading.Thread(target=boot, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(w is not None for w in out)
    return out


def _paths(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("mean", [False, True])
def test_mixed_ring_jax_rank_and_torch_rank(mean):
    worlds = mixed_worlds()
    rng = np.random.default_rng(9)
    spec = {"layer_0": {"attn": {"wq": ((32, 32), np.float32),
                                 "wo": ((32, 32), np.float32)},
                        "norm": ((32,), np.float32)},
            "embed": {"e": ((97, 5), ml_dtypes.bfloat16),
                      "f": ((97, 5), ml_dtypes.bfloat16)}}
    jtree, tnp = [_tree_map(lambda sd: rng.standard_normal(sd[0]).astype(
        sd[1]), spec) for _ in range(2)]
    ttree = _tree_map(_as_tensor, tnp)
    shims = [JaxShim(worlds[0], mean=mean),
             CrossSliceAllReduce(worlds[1], mean=mean)]
    ins = [_paths(_tree_map(np.copy, jtree)), _paths(tnp)]
    out = [None, None]
    run_ranks(worlds, lambda w, r: out.__setitem__(
        r, shims[r](jtree if r == 0 else ttree)))
    got0, got1 = _paths(out[0]), _paths(out[1])
    assert sorted(got0) == sorted(got1) == sorted(ins[0])
    for path in got0:
        a, b = ins[0][path], ins[1][path]
        want = (a.astype(np.float32) + b.astype(np.float32)).astype(a.dtype)
        if mean:
            want = (want.astype(np.float32) / 2).astype(a.dtype)
        assert _bits(got0[path]) == _bits(got1[path]), path
        assert _bits(got0[path]) == want.tobytes(), path
    for s in shims:
        s.close()
    for w in worlds:
        w.close()


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_two_torch_slices_match_the_combined_batch():
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(worlds[r], mean=True) for r in range(2)]
    trainers = [Trainer("llama-tiny", device="cpu", seed=5,
                        cross_slice_sync=shims[r]) for r in range(2)]
    combined = Trainer("llama-tiny", device="cpu", seed=5)
    batches = [_tokens(4 + r, (2, 17)) for r in range(2)]
    losses = [[], []]

    def run(w, r):
        for _ in range(2):
            losses[r].append(trainers[r].step(torch.from_numpy(batches[r])))

    run_ranks(worlds, run)
    ref = [combined.step(torch.from_numpy(np.concatenate(batches)))
           for _ in range(2)]
    for i in range(2):
        assert abs((losses[0][i] + losses[1][i]) / 2 - ref[i]) < 5e-3
    p1 = dict(trainers[1].model.named_parameters())
    for name, p in trainers[0].model.named_parameters():
        assert torch.equal(p, p1[name]), name
    for s in shims:
        s.close()
    for w in worlds:
        w.close()


def test_two_torch_slices_track_two_jax_slices():
    lr = 3e-4
    base = port_band(16)
    jw = jax_worlds(2, base)
    tw = local_worlds(2, base + 8)
    jshims = [JaxShim(jw[r], mean=True) for r in range(2)]
    tshims = [CrossSliceAllReduce(tw[r], mean=True) for r in range(2)]
    jts = [JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=0,
                      cross_slice_sync=jshims[r]) for r in range(2)]
    state0 = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jts[0].params))
    tts = [Trainer("llama-tiny", device="cpu", params=state0,
                   cross_slice_sync=tshims[r]) for r in range(2)]
    batches = [[_tokens(20 + 2 * s + r, (2, 33)) for r in range(2)]
               for s in range(2)]
    jl, tl = np.zeros((2, 2)), np.zeros((2, 2))
    for s in range(2):
        run_ranks(jw, lambda w, r: jl.__setitem__(
            (s, r), jts[r].step(jnp.asarray(batches[s][r]))))
        run_ranks(tw, lambda w, r: tl.__setitem__(
            (s, r), tts[r].step(torch.from_numpy(batches[s][r]))))
        assert np.abs(tl[s] - jl[s]).max() <= LOSS_TOL, (s, tl, jl)
        want = tllama.params_from_flax(
            jax.tree_util.tree_map(np.asarray, jts[0].params))
        far, total, decided = 0, 0, 0
        for name, p in tts[0].model.named_parameters():
            diff = (p.detach() - want[name]).abs()
            if s == 0:
                g = p.grad.abs()
                mask = (g > 1e-2 * g.max()) & (g > 1e-6)
                assert diff[mask].numel() == 0 or \
                    float(diff[mask].max()) <= 2e-6, name
                decided += int(mask.sum())
            assert float(diff.max()) <= 2 * (s + 1) * lr + 1e-6, name
            far += int((diff > 1e-5).sum())
            total += diff.numel()
        assert s > 0 or decided > 0
        assert far <= total // 1000, (s, far, total)
    for name, p in tts[1].model.named_parameters():
        assert torch.equal(p, dict(tts[0].model.named_parameters())[name])
    for sh in jshims + tshims:
        sh.close()
    for w in jw + tw:
        w.close()


def test_jax_trainer_and_torch_trainer_share_one_ring():
    """One DP step with a JAX rank and a torch rank: each wraps its shim
    to keep the gradients it gave and got. The reduced gradients are
    bitwise equal by name on the two ranks and bitwise the mean of the
    two ranks' gradients — a leaf-order error between the two trees'
    flattenings (wq and wo are both 64 x 64) would sum different
    parameters' gradients against each other and fail here."""
    worlds = mixed_worlds()
    seen = [{}, {}]

    def keep(r, shim, copy):
        def sync(tree):
            seen[r]["in"] = {p: copy(v) for p, v in _paths(tree).items()}
            out = shim(tree)
            seen[r]["out"] = {p: copy(v) for p, v in _paths(out).items()}
            return out
        return sync

    jshim = JaxShim(worlds[0], mean=True)
    tshim = CrossSliceAllReduce(worlds[1], mean=True)
    jt = JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=0,
                    cross_slice_sync=keep(0, jshim, lambda v: np.array(v)))
    state0 = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))
    tt = Trainer("llama-tiny", device="cpu", params=state0,
                 cross_slice_sync=keep(1, tshim,
                                       lambda v: v.detach().clone().numpy()))
    batches = [_tokens(30 + r, (2, 17)) for r in range(2)]
    run_ranks(worlds, lambda w, r: jt.step(jnp.asarray(batches[0]))
              if r == 0 else tt.step(torch.from_numpy(batches[1])))
    assert sorted(seen[0]["out"]) == sorted(seen[1]["out"])
    assert len(seen[0]["out"]) == 2 + 1 + 2 * 9
    for path, got in seen[0]["out"].items():
        other = seen[1]["out"][path]
        assert got.tobytes() == other.tobytes(), path
        want = (seen[0]["in"][path] + seen[1]["in"][path]) / np.float32(2)
        assert got.tobytes() == want.astype(np.float32).tobytes(), path
    # The two ranks' own gradients differ (different batches), so the
    # equalities above are not trivially true.
    wq = "params/layer_0/attn/wq/kernel"
    assert not np.array_equal(seen[0]["in"][wq], seen[1]["in"][wq])
    jshim.close()
    tshim.close()
    for w in worlds:
        w.close()


def test_two_slice_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "examples/two_slice_dp_torch.py", "--cpu",
         "--steps", "2", "--batch", "2", "--seq", "16",
         "--port", str(port_band(8)), "--engine", "emu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    by_step = {}
    for ln in lines:
        if "digest" in ln:
            by_step.setdefault(ln["step"], set()).add(ln["digest"])
    assert sorted(by_step) == [0, 1, 2]
    assert all(len(d) == 1 for d in by_step.values()), by_step
    steps = [ln for ln in lines if ln.get("step", 0) > 0]
    assert all(np.isfinite(ln["loss"]) and ln["staged_bytes"] == 0
               for ln in steps)
    assert "two-slice DP demo OK" in proc.stdout
