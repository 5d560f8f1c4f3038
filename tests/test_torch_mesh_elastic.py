"""The meshed trainer's per-layer sync, elastic resume and checkpoint
(``MeshTrainer``: a slice that is an intra-slice dp × tp mesh, its
positions all on the CPU here), against the meshed fused sync, the
single-device trainer and the JAX package.

1. Two torch meshed slices with the per-layer sync end bitwise equal to
   two with the fused sync after two steps, on ``{"dp": 1, "tp": 2}``,
   ``{"dp": 2, "tp": 1}`` and the odd geometry on ``{"dp": 1, "tp": 3}``
   (three heads split, the vocab and the MLP replicated: the head's
   other tp copies take no gradient, so its bucket goes once the
   backward is done).
2. A meshed JAX per-layer rank and a meshed torch per-layer rank on one
   world-2 ring: equal schedule descriptions, the reduced gradients
   bitwise equal by name on both ranks and bitwise the mean of what the
   two ranks gave.
3. A spy sync: each pushed bucket is bitwise the whole gradients the
   fused path sums (``reduce_names`` of every name, then ``full``), and
   when a bucket is pushed every copy of its leaves holds its gradient.
4. A meshed per-layer rank SIGKILLed at its first push of step 2 and
   restarted rejoins, and the run ends bitwise equal to the
   uninterrupted meshed per-layer run.
5. Checkpoints: a meshed trainer's file holds every ``opt/...`` key; it
   restores into a single-device ``Trainer`` and the reverse, bitwise on
   params and AdamW state, with no two positions sharing storage after
   the restore, and the restored trainer's own file is byte for byte the
   one it restored; its ``params/`` part equals, key by key and byte by
   byte, the JAX meshed trainer's checkpoint of the same weights.
6. ``examples/two_slice_dp_torch.py --cpu --mesh dp=1,tp=2 --per-layer
   --elastic-dir`` under the port's coordinator: equal digests on both
   ranks every step, each step's line with its checkpoint fields, and a
   second run over the same directory restores and trains on.
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
from rocnrdma_tpu.parallel import checkpoint as jckpt
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.control.coordinator import Coordinator
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel import checkpoint as ckpt
from rocnrdma_tpu_torch.parallel.trainer import MeshTrainer, Trainer

from test_hier import port_band
from test_torch_dp import mixed_worlds
from test_torch_elastic import _assert_recovered, _run
from test_torch_overlap import _keep
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP2 = {"dp": 1, "tp": 2}
ODD = tllama.LlamaConfig(name="odd", vocab_size=64, d_model=48, n_layers=1,
                         n_heads=3, n_kv_heads=3, d_ff=64, max_seq_len=32,
                         dtype=torch.float32)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _positions(mesh):
    return mesh["dp"] * mesh["tp"]


def _slices(cfg, mesh, per_layer, state, batches, steps=2):
    """Two meshed slices over one world-2 ring, ``steps`` steps each;
    their trainers."""
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(w, mean=True, per_layer=per_layer)
             for w in worlds]
    trainers = [Trainer(cfg, mesh, cross_slice_sync=shims[r],
                        devices=["cpu"] * _positions(mesh), device="cpu",
                        params=state) for r in range(2)]

    def run(w, r):
        for _ in range(steps):
            trainers[r].step(torch.from_numpy(batches[r]))

    try:
        run_ranks(worlds, run)
        assert [w.pending_async for w in worlds] == [0, 0]
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    return trainers


@pytest.mark.parametrize("config,mesh", [
    ("llama-tiny", TP2), ("llama-tiny", {"dp": 2, "tp": 1}),
    (ODD, {"dp": 1, "tp": 3})], ids=["dp1tp2", "dp2tp1", "odd_dp1tp3"])
def test_meshed_per_layer_slices_equal_fused(config, mesh):
    cfg = tllama.CONFIGS[config] if isinstance(config, str) else config
    state = tllama.init_params(cfg, seed=7, device="cpu")
    batches = [_tokens(70 + r, (2, 17), cfg.vocab_size) for r in range(2)]
    layered = _slices(cfg, mesh, True, state, batches)
    fused = _slices(cfg, mesh, False, state, batches)
    assert all(isinstance(t, MeshTrainer) and t._per_layer
               for t in layered)
    single = Trainer(cfg, device="cpu", cross_slice_sync=_Spy())
    assert layered[0].layer_plan == single.layer_plan
    want = fused[0].state_dict()
    for t in layered + fused[1:]:
        for name, p in t.state_dict().items():
            assert torch.equal(p, want[name]), name
    moved = max(float((want[n] - state[n]).abs().max()) for n in want)
    assert moved > 0


def test_jax_meshed_per_layer_rank_and_torch_meshed_per_layer_rank():
    worlds = mixed_worlds()
    jshim = JaxShim(worlds[0], mean=True, per_layer=True)
    tshim = CrossSliceAllReduce(worlds[1], mean=True, per_layer=True)
    described = [[], []]
    for r, w in enumerate(worlds):
        check = w.check_schedule

        def spy(digest, describe="", _r=r, _check=check):
            described[_r].append(describe)
            return _check(digest, describe)

        w.check_schedule = spy
    jkeep = _keep(jshim, lambda v: np.array(v))
    tkeep = _keep(tshim, lambda v: v.detach().clone().numpy())
    try:
        jt = JaxTrainer("llama-tiny", TP2, seed=0, cross_slice_sync=jkeep)
        wq = jt.params["params"]["layer_0"]["attn"]["wq"]["kernel"]
        assert not wq.sharding.is_fully_replicated
        state0 = tllama.params_from_flax(
            jax.tree_util.tree_map(np.asarray, jt.params))
        tt = Trainer("llama-tiny", TP2, devices=["cpu"] * 2, device="cpu",
                     params=state0, cross_slice_sync=tkeep)
        assert tt.layer_plan == jt.layer_plan
        batches = [_tokens(80 + r, (2, 17)) for r in range(2)]
        run_ranks(worlds, lambda w, r: jt.step(jnp.asarray(batches[0]))
                  if r == 0 else tt.step(torch.from_numpy(batches[1])))
        assert [w.pending_async for w in worlds] == [0, 0]
    finally:
        jshim.close()
        tshim.close()
        for w in worlds:
            w.close()
    assert described[0] == described[1] and len(described[0]) >= 1
    assert "lplan=embed:1,final_norm:1,layer_0:9" in described[1][0]
    jk, tk = jkeep.kept, tkeep.kept
    assert sorted(jk["out"]) == sorted(tk["out"])
    assert len(jk["out"]) == 2 + 1 + 2 * 9
    for path, got in jk["out"].items():
        assert got.tobytes() == tk["out"][path].tobytes(), path
        want = (jk["in"][path] + tk["in"][path]) / np.float32(2)
        assert got.tobytes() == want.astype(np.float32).tobytes(), path
        assert got.shape == tk["in"][path].shape          # whole leaves
    wq = "params/layer_0/attn/wq/kernel"
    assert not np.array_equal(jk["in"][wq], tk["in"][wq])


class _Spy:
    """A per-layer sync that keeps what each push delivered, and the
    state of every copy's gradient when the bucket was summed."""

    per_layer = True

    def __init__(self):
        self.pushed = {}
        self.order = []

    def start_layered(self, plan):
        return self

    def push(self, idx, leaves):
        self.order.append(idx)
        self.pushed[idx] = [t.clone() for t in leaves]

    def wait_posted(self):
        pass

    def finish(self, tree):
        return tree


@pytest.mark.parametrize("config,mesh", [
    ("llama-tiny", {"dp": 2, "tp": 2}), (ODD, {"dp": 1, "tp": 3})],
    ids=["dp2tp2", "odd_dp1tp3"])
def test_each_push_is_the_fused_sum_after_every_copy(config, mesh):
    cfg = tllama.CONFIGS[config] if isinstance(config, str) else config
    state = tllama.init_params(cfg, seed=8, device="cpu")
    tok = torch.from_numpy(_tokens(90, (2, 17), cfg.vocab_size))
    spy = _Spy()
    kw = dict(devices=["cpu"] * _positions(mesh), device="cpu",
              params=state)
    tr = Trainer(cfg, mesh, cross_slice_sync=spy, **kw)
    model = tr.model
    held = {}
    reduce = model.reduce_names

    def spied(names):
        for n in names:
            if n not in model._summed:
                held[n] = [t.grad is not None for t in model.copies_of(n)]
        return reduce(names)

    model.reduce_names = spied
    ref = Trainer(cfg, mesh, **kw)
    ref._zero_grad()
    ref._backward(tok.long())        # the fused path's sums
    want = {n: ref.model.full(n, grad=True) for n in ref.model.names}
    tr.step(tok)
    keys = [k for k, _ in tr.layer_plan]
    assert sorted(spy.order) == list(range(len(keys)))
    for idx, names in enumerate(tr._buckets):
        for n, got in zip(names, spy.pushed[idx]):
            assert got.shape == want[n].shape, n
            assert torch.equal(got, want[n]), n
    if config == "llama-tiny":
        # Every copy took a gradient, and each bucket was summed (and
        # pushed) only once all of them had; pushes in backward order.
        assert set(held) == set(model.names)
        assert all(all(h) for h in held.values()), held
        assert [keys[i] for i in spy.order] == [
            "lm_head", "final_norm", "layer_1", "layer_0", "embed"]
    else:
        # The head, the final norm and the replicated MLP of the other
        # tp positions feed logits that go unused: those copies take no
        # gradient, and their buckets go after the backward, in plan
        # order, once the embedding's has gone from inside it.
        for name in ("lm_head", "final_norm.weight",
                     "layers.0.mlp.w_up"):
            assert held[name] == [True, False, False], name
        assert all(held["layers.0.attn.wq"])
        assert [keys[i] for i in spy.order] == [
            "embed", "final_norm", "layer_0", "lm_head"]


def test_a_failed_bucket_gather_surfaces_after_finish():
    """A hook whose bucket cannot be gathered does not raise inside the
    backward: it pushes nothing, the backward completes, and the step
    raises the gather's error once the sync has finished."""

    class Sync(_Spy):
        finished = 0

        def push(self, idx, leaves):
            self.order.append(idx if leaves is not None else None)

        def finish(self, tree):
            Sync.finished += 1
            return tree

    sync = Sync()
    tr = Trainer("llama-tiny", TP2, devices=["cpu"] * 2, device="cpu",
                 cross_slice_sync=sync)
    reduce = tr.model.reduce_names
    failed = []

    def failing(names):        # the layer_1 bucket's hook, once
        if "layers.1.attn.wq" in names and not failed:
            failed.append(names)
            raise RuntimeError("gather failed")
        return reduce(names)

    tr.model.reduce_names = failing
    with pytest.raises(RuntimeError, match="gather failed"):
        tr.step(torch.from_numpy(_tokens(91, (2, 17))))
    keys = [k for k, _ in tr.layer_plan]
    assert sorted(sync.order, key=str) == sorted(
        [i for i, k in enumerate(keys) if k != "layer_1"] + [None], key=str)
    assert Sync.finished == 1 and tr.global_step == 0


def test_meshed_per_layer_sigkill_rejoins_bitwise(tmp_path):
    """World 2 of ``{"dp": 1, "tp": 2}`` slices with the per-layer sync:
    rank 1 dies at its 6th bucket push (the first of step 2, inside the
    backward), is restarted, restores its meshed checkpoint and
    rejoins; rank 0 rebuilds, restores and re-runs the step. The run
    ends bitwise equal to the uninterrupted meshed per-layer run."""
    _run(str(tmp_path / "clean"), 2, (), mode="layered", mesh="dp=1,tp=2")
    outs = _run(str(tmp_path / "faulty"), 2, (1,), mode="layered",
                die_at=6, mesh="dp=1,tp=2")
    _assert_recovered(outs, str(tmp_path / "clean"),
                      str(tmp_path / "faulty"), 2, (1,))


def _file(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_file(a, b):
    fa, fb = _file(a), _file(b)
    assert list(fa) == list(fb)
    for key, v in fa.items():
        assert v.dtype == fb[key].dtype and v.shape == fb[key].shape, key
        assert v.tobytes() == fb[key].tobytes(), key


def _assert_no_shared_storage(tr):
    ptrs = [t.untyped_storage().data_ptr() for t in tr.model.parameters()]
    ptrs += [v.untyped_storage().data_ptr() for st in tr.opt.state.values()
             for k, v in st.items() if k != "step"]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("mesh,dtype", [
    ({"dp": 2, "tp": 2}, torch.float32), (TP2, torch.bfloat16)],
    ids=["dp2tp2_f32", "dp1tp2_bf16"])
def test_meshed_checkpoint_is_the_single_device_file(tmp_path, mesh, dtype):
    kw = dict(device="cpu", learning_rate=1e-2, dtype=dtype)
    devices = ["cpu"] * _positions(mesh)
    meshed = Trainer("llama-tiny", mesh, devices=devices, seed=1, **kw)
    for s in range(2):
        meshed.step(torch.from_numpy(_tokens(s, (4, 17))))
    path_m = str(tmp_path / "meshed")
    ckpt.save_checkpoint(path_m, meshed, meshed.global_step)
    keys = set(_file(path_m + ".npz"))
    params = [k for k in keys if k.startswith("params/")]
    assert len(params) == 2 + 1 + 2 * 9
    for what in ("exp_avg", "exp_avg_sq", "step"):
        assert {k.replace("params/", f"opt/{what}/", 1)
                for k in params} <= keys, what

    # Meshed -> single device, bitwise; its own file is the same file.
    single = Trainer("llama-tiny", seed=2, **kw)
    assert ckpt.restore_checkpoint(path_m, single) == 2
    want = meshed.state_dict()
    for name, p in single.model.named_parameters():
        assert torch.equal(p, want[name]), name
        for what in ("exp_avg", "exp_avg_sq"):
            got = single.opt.state[p][what]
            assert torch.equal(got, meshed._ckpt_leaf(name, what)), name
    path_s = str(tmp_path / "single")
    ckpt.save_checkpoint(path_s, single, single.global_step)
    _assert_same_file(path_m + ".npz", path_s + ".npz")

    # Single device -> a fresh mesh (the optimizer state made in
    # AdamW's layout), and into a mesh that stepped (overwritten in
    # place): both bitwise, every copy its master's, no storage shared
    # across positions, and their next steps bitwise equal.
    others = []
    for stepped in (False, True):
        other = Trainer("llama-tiny", mesh, devices=devices, seed=3, **kw)
        if stepped:
            other.step(torch.from_numpy(_tokens(9, (4, 17))))
        blocks = list(other.model.parameters())
        assert ckpt.restore_checkpoint(path_s, other) == 2
        assert all(a is b for a, b in zip(blocks, other.model.parameters()))
        _assert_no_shared_storage(other)
        for name, t in other.state_dict().items():
            assert torch.equal(t, want[name]), name
        for name in other.model.names:
            for group in other.model.copies[name]:
                master = other.model.local[group[0]][name]
                assert torch.equal(master, meshed.model.local[group[0]][name])
                for pos in group[1:]:
                    assert torch.equal(other.model.local[pos][name], master)
        path_o = str(tmp_path / f"other{int(stepped)}")
        ckpt.save_checkpoint(path_o, other, other.global_step)
        _assert_same_file(path_s + ".npz", path_o + ".npz")
        others.append(other)
    tok = torch.from_numpy(_tokens(11, (4, 17)))
    assert others[0].step(tok) == others[1].step(tok)
    after = others[1].state_dict()
    for name, t in others[0].state_dict().items():
        assert torch.equal(t, after[name]), name


def test_meshed_params_part_equals_the_jax_meshed_checkpoint(tmp_path):
    jt = JaxTrainer("llama-tiny", TP2, seed=0, dtype=jnp.bfloat16)
    wq = jt.params["params"]["layer_0"]["attn"]["wq"]["kernel"]
    assert not wq.sharding.is_fully_replicated
    state = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))
    tr = Trainer("llama-tiny", TP2, devices=["cpu"] * 2, device="cpu",
                 dtype=torch.bfloat16, params=state)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jt, 0)
    ckpt.save_checkpoint(str(tmp_path / "torch"), tr, 0)

    def params_part(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files
                    if k.startswith(("params/", "__dtype__/params/"))}

    want = params_part(tmp_path / "jax.npz")
    got = params_part(tmp_path / "torch.npz")
    assert sorted(got) == sorted(want)
    assert any(bytes(want[k]) == b"bfloat16" for k in want
               if k.startswith("__dtype__/"))
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert got[key].tobytes() == w.tobytes(), key


def test_meshed_per_layer_elastic_example_restores(tmp_path):
    coord = Coordinator(port=0, lease_ms=8000,
                        port_base=port_band(64)).start()
    cmd = [sys.executable, "examples/two_slice_dp_torch.py", "--cpu",
           "--mesh", "dp=1,tp=2", "--devices", "cpu,cpu", "--per-layer",
           "--batch", "2", "--seq", "16", "--engine", "emu",
           "--controller", coord.address,
           "--elastic-dir", str(tmp_path / "ck")]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    try:
        runs = [subprocess.run(cmd + ["--steps", str(n)], cwd=REPO,
                               capture_output=True, text=True, timeout=300,
                               env=env) for n in (2, 3)]
    finally:
        coord.stop()
    by_step = {}
    for n, proc in zip((2, 3), runs):
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        for ln in lines:
            if "loss" in ln:
                by_step.setdefault(ln["step"], set()).add(ln["digest"])
                assert {"ckpt_bytes", "ckpt_save_ms", "finite_ms",
                        "resumes", "grads_ms", "sync_ms",
                        "apply_ms"} <= set(ln), ln
        first = [ln for ln in lines if "ready_monotonic" in ln]
        assert all(ln["mesh"] == TP2 and ln["per_layer"] for ln in first)
        if n == 3:
            assert all(ln["restored_step"] == 2 for ln in first)
            assert "RESTORED 0 2" in proc.stdout
    assert sorted(by_step) == [1, 2, 3]
    assert all(len(d) == 1 for d in by_step.values()), by_step
