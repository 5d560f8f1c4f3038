"""The PyTorch port's overlapped cross-slice sync against the JAX
package's (in-process ranks, one thread each, emu engine), as
``tests/test_overlap.py`` holds the JAX shim:

- the bucketed ``start``/``finish`` path is bitwise the fused path at
  world 2 and 4, at the default bucket size and at smaller ones
  (integer-valued f32, so every partial sum is exact and parity is
  about routing, not rounding);
- the schedule description is byte-equal to the JAX shim's for the
  overlap path, the bf16 and int8 wires and a llama-tiny layered plan,
  and equal to the fused path's at the default bucket size;
- a wire dtype without overlap is a ``ValueError``;
- the bf16 and int8 wires stay within the reference's tolerances, and
  error feedback bounds the drift over 20 steps (the reference's
  bounds);
- the int8 quantization (scale, payload, residual) and the bf16
  rounding are bitwise the JAX shim's numpy formulas;
- a mixed JAX/torch world-2 ring, bucketed, in f32 and with the int8
  and bf16 wires: both ranks end bitwise equal;
- a torch per-layer trainer pair trains bitwise in lockstep with a
  fused pair, and a torch per-layer rank and a JAX per-layer rank on
  one ring reduce to bitwise-equal gradients;
- the posting order of the per-layer buckets is the JAX rank's
  delivery order, whatever order torch's hooks push them in (with and
  without remat).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.jax_shim import \
    CrossSliceAllReduce as JaxShim
from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.collectives.torch_shim import (CrossSliceAllReduce,
                                                       tree_flatten)
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import port_band
from test_torch_dp import _paths, mixed_worlds
from test_torch_world import run_ranks

_LEAF_SIZES = (4096, 1000, 33000, 77, 8192)


def _exact_tree(rank, seed=11):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        rng.integers(-64, 64, size=n).astype(np.float32) * (rank + 1))
        for n in _LEAF_SIZES]


def _sync(world_n, shim_kw, trees, mean=True):
    worlds = local_worlds(world_n, port_band(8))
    shims = [CrossSliceAllReduce(w, mean=mean, **shim_kw) for w in worlds]
    outs = [None] * world_n
    try:
        run_ranks(worlds, lambda w, r: outs.__setitem__(r, shims[r](trees[r])))
        assert [w.pending_async for w in worlds] == [0] * world_n
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    return outs


def _sync_exact(world_n, shim_kw):
    return _sync(world_n, shim_kw,
                 [_exact_tree(r) for r in range(world_n)])


# ------------------------------------------------- bucketed vs fused

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bucket_bytes", [None, 48 << 10, 130172])
def test_bucketed_parity_bitwise_vs_fused(world, bucket_bytes):
    sizes = list(_LEAF_SIZES)
    plan = CrossSliceAllReduce._segment_plan(
        list(range(len(sizes))), sizes,
        max(1, (bucket_bytes or 16 << 20) // 4))
    assert (len(plan) == 1) == (bucket_bytes is None), plan
    fused = _sync_exact(world, {})
    bucketed = _sync_exact(world, {"overlap": True,
                                   "bucket_bytes": bucket_bytes})
    want = [sum(_exact_tree(r)[i] for r in range(world)) / world
            for i in range(len(sizes))]
    for r in range(world):
        for a, b, w in zip(fused[r], bucketed[r], want):
            assert torch.equal(a, b) and torch.equal(b, w), (world, r)


def test_bucketed_growth_reregisters_and_numpy_leaves_come_back_fresh():
    """A larger tree after a smaller one grows the staging tensor (its
    slice MRs dropped first); numpy leaves come back as fresh arrays,
    tensors are written in place."""
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(w, overlap=True, bucket_bytes=4096)
             for w in worlds]
    try:
        for n in (3000, 9000):
            trees = [[torch.full((n,), float(r + 1)),
                      np.full(n // 3, 10.0 * (r + 1), np.float32)]
                     for r in range(2)]
            outs = [None, None]
            run_ranks(worlds, lambda w, r: outs.__setitem__(
                r, shims[r](trees[r])))
            for r in range(2):
                assert outs[r][0] is trees[r][0]
                assert torch.equal(outs[r][0], torch.full((n,), 3.0))
                assert outs[r][1] is not trees[r][1]
                np.testing.assert_array_equal(outs[r][1],
                                              np.full(n // 3, 30.0))
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()


# --------------------------------------------------- schedule digest

def _torch_tree(np_tree):
    return jax.tree_util.tree_map(lambda a: torch.zeros(
        a.shape, dtype=getattr(torch, a.dtype.name)), np_tree)


def _describe(shim, leaves):
    _, coalesced, ops, groups, _ = shim._classify(leaves)
    return shim._sched_describe(leaves, coalesced, ops, groups,
                                shim._bucket_chunk(), wire=shim.wire_dtype)


@pytest.mark.parametrize("kw", [
    dict(overlap=True), dict(overlap=True, bucket_bytes=32 << 10),
    dict(overlap=True, wire_dtype="bf16"),
    dict(overlap=True, wire_dtype="int8", bucket_bytes=4096)],
    ids=["overlap", "bucketed", "bf16", "int8"])
def test_sched_describe_matches_the_jax_shim(kw):
    np_tree = {"b": {"wq": np.zeros((16, 16), np.float32),
                     "n": np.zeros(16, np.float32)},
               "a": {"emb": np.zeros((33, 7), ml_dtypes.bfloat16),
                     "i": np.zeros(5, np.int32)}}
    base = port_band(16)
    jw = jax_worlds(2, base)
    tw = local_worlds(2, base + 8)
    js = JaxShim(jw[0], mean=True, **kw)
    ts = CrossSliceAllReduce(tw[0], mean=True, **kw)
    fused = CrossSliceAllReduce(tw[0], mean=True)
    try:
        got = _describe(ts, tree_flatten(_torch_tree(np_tree))[0])
        assert got == _describe(js, jax.tree_util.tree_leaves(np_tree))
        if kw == dict(overlap=True):
            assert got == _describe(fused,
                                    tree_flatten(_torch_tree(np_tree))[0])
        if "wire_dtype" in kw:
            assert f"wire={kw['wire_dtype']}" in got
        if "bucket_bytes" in kw:
            assert f"schunk={kw['bucket_bytes']}" in got
    finally:
        for s in (js, ts, fused):
            s.close()
        for w in jw + tw:
            w.close()


class _Recorder:
    """A per-layer sync that records the plan and the push order."""

    per_layer = True
    overlap = True

    def __init__(self):
        self.order = []

    def start_layered(self, plan):
        self.plan = plan
        return self

    def push(self, idx, leaves):
        self.order.append(idx)

    def wait_posted(self):
        pass

    def finish(self, tree):
        return tree

    def __call__(self, tree):
        return tree


def _jax_recorded():
    rec = _Recorder()
    jt = JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=0,
                    cross_slice_sync=rec)
    jt.step(jnp.asarray(_tokens(1, (2, 17))))
    return jt, rec


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.mark.parametrize("wire", [None, "int8"])
def test_layered_plan_and_describe_match_the_jax_trainer(wire):
    jt, _ = _jax_recorded()
    tt = Trainer("llama-tiny", device="cpu", cross_slice_sync=_Recorder())
    assert tt.layer_plan == jt.layer_plan
    assert [k for k, _ in tt.layer_plan] == [
        "embed", "final_norm", "layer_0", "layer_1", "lm_head"]
    base = port_band(16)
    jw = jax_worlds(2, base)
    tw = local_worlds(2, base + 8)
    js = JaxShim(jw[0], mean=True, per_layer=True, wire_dtype=wire)
    ts = CrossSliceAllReduce(tw[0], mean=True, per_layer=True,
                             wire_dtype=wire)
    try:
        got = ts._layered_describe(tt.layer_plan)
        assert got == js._layered_describe(jt.layer_plan)
        assert "lplan=embed:1,final_norm:1,layer_0:9" in got
    finally:
        for s in (js, ts):
            s.close()
        for w in jw + tw:
            w.close()


@pytest.mark.parametrize("remat", [False, True])
def test_layered_posting_order_is_the_jax_rank_order(remat):
    """torch's hooks push in backward order (lm_head, final_norm,
    layer_1, layer_0, embed, with or without non-reentrant
    checkpointing); a JAX rank's ordered taps deliver in the reverse of
    the plan. The torch shim posts in the latter order whatever the
    push order, so a mixed ring agrees."""
    _, jrec = _jax_recorded()
    rec = _Recorder()
    tt = Trainer("llama-tiny", device="cpu", cross_slice_sync=rec,
                 remat=remat)
    tt.step(torch.from_numpy(_tokens(1, (2, 17))))
    keys = [k for k, _ in tt.layer_plan]
    assert [keys[i] for i in rec.order] == [
        "lm_head", "final_norm", "layer_1", "layer_0", "embed"]
    assert jrec.order == list(reversed(range(len(keys))))

    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(w, per_layer=True) for w in worlds]
    posted = [None, None]

    def run(w, r):
        pend = shims[r].start_layered(tt.layer_plan)
        grads = [[torch.full((n,), float(r + 1)) for n, _ in leaves]
                 for _, leaves in tt.layer_plan]
        for idx in rec.order:
            pend.push(idx, grads[idx])
        tree = {k: g for (k, _), g in zip(tt.layer_plan, grads)}
        pend.finish(tree)
        posted[r] = [next(i for i, segs in enumerate(pend._segs)
                          if seg in segs) for seg, _h in pend._handles]
        for g in grads:
            for t in g:
                assert torch.equal(t, torch.full_like(t, 3.0))

    try:
        run_ranks(worlds, run)
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    assert posted[0] == posted[1] == jrec.order


# ---------------------------------------------------------- the wires

def test_wire_requires_overlap_and_validates(monkeypatch):
    worlds = local_worlds(2, port_band(8))
    try:
        with pytest.raises(ValueError, match="overlap"):
            CrossSliceAllReduce(worlds[0], wire_dtype="bf16")
        with pytest.raises(ValueError, match="bf16"):
            CrossSliceAllReduce(worlds[0], overlap=True, wire_dtype="fp8")
        monkeypatch.setenv("TDR_WIRE_DTYPE", "int8")
        with pytest.raises(ValueError, match="overlap"):
            CrossSliceAllReduce(worlds[0])
        assert CrossSliceAllReduce(worlds[0],
                                   per_layer=True).wire_dtype == "int8"
    finally:
        for w in worlds:
            w.close()


def test_int8_and_bf16_rounding_bitwise_against_the_numpy_formula():
    """The shim's compression against the JAX shim's numpy lines on the
    same f32 bucket and residual: int8 scale, payload and residual, and
    the bf16 payload (round to nearest even) and residual, bit for
    bit — including a bucket whose values sit on .5 quanta and an
    all-zero bucket."""
    worlds = local_worlds(2, port_band(8))
    rng = np.random.default_rng(3)
    cases = [rng.standard_normal(10007).astype(np.float32) * 3,
             (np.arange(-300, 301, dtype=np.float32) + 0.5) / 7,
             np.zeros(64, np.float32)]
    try:
        for wire in ("int8", "bf16"):
            shim = CrossSliceAllReduce(worlds[0], overlap=True,
                                       wire_dtype=wire)
            for seg0 in cases:
                res0 = (rng.standard_normal(seg0.size).astype(np.float32)
                        * 1e-3)
                seg, res = seg0.copy(), res0.copy()
                # The JAX shim's lines (jax_shim.py bucket_produce).
                seg += res
                if wire == "int8":
                    wbuf = np.empty(seg.size, np.int8)
                    absmax = float(np.max(np.abs(seg))) if seg.size else 0.0
                    scale = absmax / 127.0
                    if scale > 0.0:
                        np.rint(seg / scale, casting="unsafe", out=wbuf)
                    else:
                        wbuf[:] = 0
                    np.subtract(seg, wbuf.astype(np.float32) * scale,
                                out=res)
                    wt = torch.empty(seg.size, dtype=torch.int8)
                else:
                    wbuf = seg.astype(ml_dtypes.bfloat16)
                    np.subtract(seg, wbuf.astype(np.float32), out=res)
                    scale = 0.0
                    wt = torch.empty(seg.size, dtype=torch.bfloat16)
                st, rt = torch.from_numpy(seg0.copy()), \
                    torch.from_numpy(res0.copy())
                got_scale = shim._compress(st, wt, rt)
                assert got_scale == scale
                assert st.numpy().tobytes() == seg.tobytes()
                assert rt.numpy().tobytes() == res.tobytes()
                assert wt.view(torch.uint8).numpy().tobytes() == \
                    wbuf.tobytes()
            shim.close()
    finally:
        for w in worlds:
            w.close()


@pytest.mark.parametrize("world", [2, 4])
def test_wire_int8_cross_rank_bitwise_and_near_fused(world):
    fused = _sync_exact(world, {})
    q8 = _sync_exact(world, {"overlap": True, "bucket_bytes": 130172,
                             "wire_dtype": "int8"})
    for r in range(1, world):
        for a, b in zip(q8[0], q8[r]):
            assert torch.equal(a, b), r
    for f, q in zip(fused[0], q8[0]):
        assert float(q.abs().max()) > 0.0, "q8 result collapsed"
        # The reference's bound: each rank's symmetric quantization
        # error is at most scale / 2 with scale = absmax / 127.
        atol = float(f.abs().max()) * world / 127.0 + 1e-6
        np.testing.assert_allclose(q.numpy(), f.numpy(), rtol=0.0,
                                   atol=atol)


def _train_synthetic(grad, steps, wire, keep_ef, bucket):
    """``steps`` SGD steps of lr 0.5 on a world-2 ring from zeros, the
    gradient ``grad()`` on both ranks; rank 0's parameters."""
    worlds = local_worlds(2, port_band(8))
    kw = ({"overlap": True, "bucket_bytes": bucket, "wire_dtype": wire}
          if wire else {})
    shims = [CrossSliceAllReduce(w, mean=True, **kw) for w in worlds]
    n = grad().numel()
    params = [torch.zeros(n) for _ in range(2)]
    try:
        for _ in range(steps):
            def step(w, r):
                (mean_g,) = shims[r]([grad()])
                params[r] -= 0.5 * mean_g
            run_ranks(worlds, step)
            if not keep_ef:
                for s in shims:
                    for res in s._residuals.values():
                        res.zero_()
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    return params[0]


def test_wire_bf16_tolerance_and_error_feedback_bounds_drift():
    """(1 + 2^-12) rounds down to 1.0 in bf16 every step: without
    error feedback the drift grows linearly; with it the residual
    crosses a bf16 ulp and corrects (the reference's bounds)."""
    def grad():
        return torch.full((2048,), 1.0 + 2.0 ** -12)

    exact = _train_synthetic(grad, 20, None, True, 4096)
    ef = _train_synthetic(grad, 20, "bf16", True, 4096)
    no_ef = _train_synthetic(grad, 20, "bf16", False, 4096)
    drift_ef = float((ef - exact).abs().max())
    drift_no = float((no_ef - exact).abs().max())
    assert drift_no > 1e-3, drift_no
    assert drift_ef < drift_no, (drift_ef, drift_no)
    assert drift_ef < 1e-3, drift_ef


def test_wire_int8_tolerance_and_error_feedback_bounds_drift():
    """0.25 everywhere beside a 127 anchor per bucket: the wire value
    rint(0.25) = 0 loses the whole gradient without error feedback (the
    reference's bounds)."""
    def grad():
        g = torch.full((2048,), 0.25)
        g[0] = g[1024] = 127.0
        return g

    exact = _train_synthetic(grad, 20, None, True, 4096)
    ef = _train_synthetic(grad, 20, "int8", True, 4096)
    no_ef = _train_synthetic(grad, 20, "int8", False, 4096)
    drift_ef = float((ef - exact).abs().max())
    drift_no = float((no_ef - exact).abs().max())
    assert drift_no > 2.0, drift_no
    assert drift_ef < drift_no, (drift_ef, drift_no)
    assert drift_ef < 1.0, drift_ef


# ------------------------------------------------------ mixed rings

@pytest.mark.parametrize("wire", [None, "int8", "bf16"])
def test_mixed_ring_bucketed_bitwise_on_both_ranks(wire):
    """A JAX rank and a torch rank, both bucketed (odd bucket size),
    over f32 leaves: both ranks end bitwise equal, in f32 bitwise the
    mean, and both carry the same residuals."""
    worlds = mixed_worlds()
    kw = dict(overlap=True, bucket_bytes=130172, wire_dtype=wire)
    shims = [JaxShim(worlds[0], mean=True, **kw),
             CrossSliceAllReduce(worlds[1], mean=True, **kw)]
    rng = np.random.default_rng(5)
    ins = [{f"l{i}": rng.standard_normal(n).astype(np.float32) * (r + 1)
            for i, n in enumerate(_LEAF_SIZES)} for r in range(2)]
    trees = [{k: v.copy() for k, v in ins[0].items()},
             {k: torch.from_numpy(v.copy()) for k, v in ins[1].items()}]
    out = [None, None]
    try:
        for _ in range(2):   # the second call carries residuals
            run_ranks(worlds, lambda w, r: out.__setitem__(
                r, shims[r](trees[r])))
            trees = [{k: v.copy() for k, v in ins[0].items()},
                     {k: torch.from_numpy(v.copy())
                      for k, v in ins[1].items()}]
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()
    for k in ins[0]:
        a, b = np.asarray(out[0][k]), out[1][k].numpy()
        assert a.tobytes() == b.tobytes(), k
        if wire is None:
            want = (ins[0][k] + ins[1][k]) / np.float32(2)
            assert a.tobytes() == want.tobytes(), k
    if wire is not None:
        jres = shims[0]._residuals["float32"]
        tres = shims[1]._residuals["float32"].numpy()
        assert jres.shape == tres.shape


def _keep(shim, copy):
    """Wrap a per-layer shim so the step's reduced gradients are kept."""

    class Keep:
        kept = {}

        def __getattr__(self, name):
            return getattr(shim, name)

        def start_layered(self, plan):
            pend = shim.start_layered(plan)

            class Pending:
                def push(self, idx, leaves):
                    pend.push(idx, leaves)

                def wait_posted(self):
                    pend.wait_posted()

                def finish(self, tree):
                    Keep.kept["in"] = {p: copy(v)
                                       for p, v in _paths(tree).items()}
                    out = pend.finish(tree)
                    Keep.kept["out"] = {p: copy(v)
                                        for p, v in _paths(out).items()}
                    return out

            return Pending()

    return Keep()


def test_jax_per_layer_rank_and_torch_per_layer_rank_share_one_ring():
    worlds = mixed_worlds()
    jshim = JaxShim(worlds[0], mean=True, per_layer=True)
    tshim = CrossSliceAllReduce(worlds[1], mean=True, per_layer=True)
    jkeep = _keep(jshim, lambda v: np.array(v))
    tkeep = _keep(tshim, lambda v: v.detach().clone().numpy())
    jt = JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=0,
                    cross_slice_sync=jkeep)
    state0 = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))
    tt = Trainer("llama-tiny", device="cpu", params=state0,
                 cross_slice_sync=tkeep)
    assert tt.layer_plan == jt.layer_plan
    batches = [_tokens(40 + r, (2, 17)) for r in range(2)]
    try:
        run_ranks(worlds, lambda w, r: jt.step(jnp.asarray(batches[0]))
                  if r == 0 else tt.step(torch.from_numpy(batches[1])))
        assert [w.pending_async for w in worlds] == [0, 0]
    finally:
        jshim.close()
        tshim.close()
        for w in worlds:
            w.close()
    jk, tk = jkeep.kept, tkeep.kept
    assert sorted(jk["out"]) == sorted(tk["out"])
    assert len(jk["out"]) == 2 + 1 + 2 * 9
    for path, got in jk["out"].items():
        assert got.tobytes() == tk["out"][path].tobytes(), path
        want = (jk["in"][path] + tk["in"][path]) / np.float32(2)
        assert got.tobytes() == want.astype(np.float32).tobytes(), path
    wq = "params/layer_0/attn/wq/kernel"
    assert not np.array_equal(jk["in"][wq], tk["in"][wq])


@pytest.mark.parametrize("remat", [False, True])
def test_torch_per_layer_trainers_in_lockstep_with_fused(remat):
    """Two torch per-layer trainers and two fused trainers on the same
    batches: at world 2 every element is one addition, so the
    parameters stay bitwise equal across the pairs and across the
    ranks, and the per-layer pair's buckets went through async
    handles, all settled."""
    batches = [_tokens(4 + r, (2, 17)) for r in range(2)]

    def run_pair(**kw):
        worlds = local_worlds(2, port_band(8))
        shims = [CrossSliceAllReduce(w, mean=True, **kw) for w in worlds]
        trainers = [Trainer("llama-tiny", device="cpu", seed=5,
                            cross_slice_sync=shims[r], remat=remat)
                    for r in range(2)]
        losses = [[], []]

        def run(w, r):
            for _ in range(2):
                losses[r].append(trainers[r].step(
                    torch.from_numpy(batches[r])))

        try:
            run_ranks(worlds, run)
            assert [w.pending_async for w in worlds] == [0, 0]
        finally:
            for s in shims:
                s.close()
            for w in worlds:
                w.close()
        return losses, [dict(t.model.named_parameters()) for t in trainers]

    before = trace.counter("world.allreduce_async")
    p_losses, p_params = run_pair(per_layer=True)
    assert trace.counter("world.allreduce_async") - before >= 2 * 2 * 5
    f_losses, f_params = run_pair()
    assert p_losses == f_losses
    for name, p in f_params[0].items():
        assert torch.equal(p, f_params[1][name]), name
        assert torch.equal(p, p_params[0][name]), name
        assert torch.equal(p, p_params[1][name]), name


def test_torch_overlap_trainer_in_lockstep_with_fused():
    batches = [_tokens(8 + r, (2, 17)) for r in range(2)]
    params = []
    for kw in ({}, {"overlap": True, "bucket_bytes": 64 << 10}):
        worlds = local_worlds(2, port_band(8))
        shims = [CrossSliceAllReduce(w, mean=True, **kw) for w in worlds]
        trainers = [Trainer("llama-tiny", device="cpu", seed=5,
                            cross_slice_sync=shims[r]) for r in range(2)]
        try:
            run_ranks(worlds, lambda w, r: [trainers[r].step(
                torch.from_numpy(batches[r])) for _ in range(2)])
        finally:
            for s in shims:
                s.close()
            for w in worlds:
                w.close()
        assert set(trainers[0].last_split) == {"grads_ms", "sync_ms",
                                               "apply_ms"}
        params.append(dict(trainers[0].model.named_parameters()))
    for name, p in params[0].items():
        assert torch.equal(p, params[1][name]), name


def test_layered_push_failure_surfaces_at_finish():
    """A push that fails (a leaf of the wrong size) never raises in the
    hook; finish re-raises it after draining the other handles."""
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(w, per_layer=True) for w in worlds]
    plan = [("a", [(100, "float32")]), ("b", [(50, "float32")])]
    errs = [None, None]

    def run(w, r):
        pend = shims[r].start_layered(plan)
        pend.push(1, [torch.ones(50)])
        pend.push(0, [torch.ones(7)])      # wrong size
        try:
            pend.finish({"a": [torch.ones(100)], "b": [torch.ones(50)]})
        except RuntimeError as e:
            errs[r] = e

    try:
        run_ranks(worlds, run)
        assert all(e is not None for e in errs), errs
        assert [w.pending_async for w in worlds] == [0, 0]
    finally:
        for s in shims:
            s.close()
        for w in worlds:
            w.close()

