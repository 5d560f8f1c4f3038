"""Two-slice data parallelism over meshed slices (BASELINE config 4:
each slice a dp × tp mesh, the gradients averaged across slices over
the RDMA ring), against the single-device trainer and the JAX package.
In-process ranks, one thread each, emu engine, the port's meshes on
the CPU (``devices=["cpu"] * n``).

1. Two torch slices, each ``{"dp": 1, "tp": 2}``, against one
   single-device ``Trainer`` on the combined batch, fused and overlapped
   sync: the mean of the slices' losses and every parameter after two
   steps within 1e-5 (the same f32 sums in another order: the slices'
   mean of two row-parallel sums against one whole product), both
   slices' parameters bitwise equal, and the overlapped sync bitwise
   the fused one.
2. A JAX rank with ``{"dp": 1, "tp": 2}`` and a torch rank with the
   same mesh on one world-2 ring: the schedule descriptions the two
   ranks exchange are equal, and the reduced gradients bitwise equal by
   name on both ranks and bitwise the mean of what the two ranks gave
   (at world 2 each element is one addition).
3. ``examples/two_slice_dp_torch.py --cpu --mesh dp=1,tp=2 --devices
   cpu,cpu`` exits with 0 and its ranks print equal digests every step.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.jax_shim import \
    CrossSliceAllReduce as JaxShim
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import MeshTrainer, Trainer

from test_hier import port_band
from test_torch_dp import _paths, mixed_worlds
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP2 = {"dp": 1, "tp": 2}


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _meshed_slices(overlap: bool, state, batches, steps: int = 2):
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(worlds[r], mean=True, overlap=overlap)
             for r in range(2)]
    trainers = [Trainer("llama-tiny", TP2, cross_slice_sync=shims[r],
                        devices=["cpu"] * 2, device="cpu", params=state)
                for r in range(2)]
    losses = [[], []]

    def run(w, r):
        for _ in range(steps):
            losses[r].append(trainers[r].step(torch.from_numpy(batches[r])))

    try:
        run_ranks(worlds, run)
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    return trainers, losses


def test_two_meshed_slices_match_the_combined_batch():
    state = tllama.init_params(tllama.LLAMA_TINY, seed=5, device="cpu")
    batches = [_tokens(40 + r, (2, 17)) for r in range(2)]
    fused, losses = _meshed_slices(False, state, batches)
    assert all(isinstance(t, MeshTrainer) for t in fused)
    combined = Trainer("llama-tiny", device="cpu", params=state)
    ref = [combined.step(torch.from_numpy(np.concatenate(batches)))
           for _ in range(2)]
    for i in range(2):
        assert abs((losses[0][i] + losses[1][i]) / 2 - ref[i]) <= 1e-5
    want = combined.state_dict()
    got = [t.state_dict() for t in fused]
    for name, w in want.items():
        assert torch.equal(got[0][name], got[1][name]), name
        assert float((got[0][name] - w).abs().max()) <= 1e-5, name
    overlapped, _ = _meshed_slices(True, state, batches)
    for name, t in overlapped[0].state_dict().items():
        assert torch.equal(t, got[0][name]), name


def test_jax_meshed_rank_and_torch_meshed_rank_share_one_ring():
    """Each rank wraps its shim to keep the gradient tree it gave and
    got, and its world's ``check_schedule`` to keep the schedule
    description it exchanged."""
    worlds = mixed_worlds()
    seen = [{}, {}]

    def keep(r, shim, copy):
        world = shim.world
        check = world.check_schedule

        def spy(digest, describe=""):
            seen[r].setdefault("describe", []).append(describe)
            return check(digest, describe)

        world.check_schedule = spy

        def sync(tree):
            seen[r]["in"] = {p: copy(v) for p, v in _paths(tree).items()}
            out = shim(tree)
            seen[r]["out"] = {p: copy(v) for p, v in _paths(out).items()}
            return out
        return sync

    jshim = JaxShim(worlds[0], mean=True)
    tshim = CrossSliceAllReduce(worlds[1], mean=True)
    try:
        jt = JaxTrainer("llama-tiny", TP2, seed=0,
                        cross_slice_sync=keep(0, jshim,
                                              lambda v: np.array(v)))
        wq = jt.params["params"]["layer_0"]["attn"]["wq"]["kernel"]
        assert not wq.sharding.is_fully_replicated
        state0 = tllama.params_from_flax(
            jax.tree_util.tree_map(np.asarray, jt.params))
        tt = Trainer("llama-tiny", TP2, devices=["cpu"] * 2, device="cpu",
                     params=state0,
                     cross_slice_sync=keep(
                         1, tshim, lambda v: v.detach().clone().numpy()))
        batches = [_tokens(50 + r, (2, 17)) for r in range(2)]
        run_ranks(worlds, lambda w, r: jt.step(jnp.asarray(batches[0]))
                  if r == 0 else tt.step(torch.from_numpy(batches[1])))
    finally:
        jshim.close()
        tshim.close()
        for w in worlds:
            w.close()
    assert seen[0]["describe"] == seen[1]["describe"]
    assert len(seen[0]["describe"]) >= 1
    assert sorted(seen[0]["out"]) == sorted(seen[1]["out"])
    assert len(seen[0]["out"]) == 2 + 1 + 2 * 9
    for path, got in seen[0]["out"].items():
        assert got.tobytes() == seen[1]["out"][path].tobytes(), path
        want = (seen[0]["in"][path] + seen[1]["in"][path]) / np.float32(2)
        assert got.tobytes() == want.astype(np.float32).tobytes(), path
        assert got.shape == seen[1]["in"][path].shape   # whole leaves
    wq = "params/layer_0/attn/wq/kernel"
    assert not np.array_equal(seen[0]["in"][wq], seen[1]["in"][wq])


@pytest.mark.parametrize("overlap", [False, True], ids=["fused", "overlap"])
def test_meshed_sync_hands_whole_leaves_and_splits_the_result(overlap):
    """The tree a meshed slice hands its sync holds every leaf whole
    (the gradient summed over the mesh's copies); what the sync returns
    lands in the masters' gradients block by block, so AdamW applies
    exactly the returned tree."""
    calls = []

    class Halve:
        def __init__(self):
            self.overlap = overlap

        def __call__(self, tree):
            calls.append(tree)
            return jax.tree_util.tree_map(lambda g: g * 0.5, tree)

        def start(self, tree):
            calls.append(tree)
            return type("P", (), {"finish": lambda _s: jax.tree_util.tree_map(
                lambda g: g * 0.5, tree)})()

    state = tllama.init_params(tllama.LLAMA_TINY, seed=6, device="cpu")
    tok = torch.from_numpy(_tokens(60, (4, 9)))
    tr = Trainer("llama-tiny", {"dp": 2, "tp": 2}, devices=["cpu"] * 4,
                 device="cpu", params=state, cross_slice_sync=Halve())
    ref = Trainer("llama-tiny", {"dp": 2, "tp": 2}, devices=["cpu"] * 4,
                  device="cpu", params=state)
    assert tr.step(tok) == ref.step(tok)
    whole = ref.grads_tree()
    assert jax.tree_util.tree_structure(calls[0]) == \
        jax.tree_util.tree_structure(whole)
    for a, b in zip(jax.tree_util.tree_leaves(calls[0]),
                    jax.tree_util.tree_leaves(whole)):
        assert a.shape == b.shape
    got = jax.tree_util.tree_leaves(tr.grads_tree())
    for g, w in zip(got, jax.tree_util.tree_leaves(whole)):
        assert torch.equal(g, w * 0.5)


def test_meshed_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "examples/two_slice_dp_torch.py", "--cpu",
         "--mesh", "dp=1,tp=2", "--devices", "cpu,cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--port", str(port_band(8)),
         "--engine", "emu"],
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
    first = [ln for ln in lines if ln.get("step") == 0]
    assert all(ln["mesh"] == TP2 for ln in first)
    assert "two-slice DP demo OK" in proc.stdout
