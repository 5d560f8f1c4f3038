"""The PyTorch port's cross-slice allreduce shim
(``rocnrdma_tpu_torch.collectives.torch_shim``) over in-process ranks
(one thread each, emu engine), on its three data paths:

1. exporter-owned host memory (``FakeHBMExporter``; numpy arrays and
   CPU tensors viewing it), reduced in place and coalesced, with zero
   staged bytes (``staging.expect_zero``), as ``tests/test_zero_copy.py``
   holds the JAX shim;
2. CPU tensors adopted by a ``CUDAExporter``, reduced in place with zero
   staged bytes;
3. staged groups per dtype for every other leaf, each staged byte
   counted.

Also: the mean over f32 and bf16 (world 2 divides by 2, exact, so the
results are bitwise (a + b) / 2), the digest exchange failing fast on a
schedule mismatch, and the schedule description byte-equal to the JAX
shim's for the same tree.
"""

import ctypes

import numpy as np
import pytest
import torch

from rocnrdma_tpu_torch.collectives.staging import staging
from rocnrdma_tpu_torch.collectives.torch_shim import (CrossSliceAllReduce,
                                                       tree_flatten)
from rocnrdma_tpu_torch.collectives.world import local_worlds
from rocnrdma_tpu_torch.hbm.cuda import CUDAExporter
from rocnrdma_tpu_torch.hbm.registry import (DeviceArena, FakeHBMExporter,
                                             as_ndarray, device_ndarray)
from rocnrdma_tpu_torch.transport.engine import TransportError
from rocnrdma_tpu_torch.utils.trace import trace

from test_torch_world import run_ranks
from test_hier import port_band


def make_world2(exporters=None, mean=False):
    worlds = local_worlds(2, port_band(8))
    shims = [CrossSliceAllReduce(worlds[r], exporter=(
        exporters[r] if exporters else None), mean=mean) for r in range(2)]
    return worlds, shims


def close_all(worlds, shims):
    for s in shims:
        s.close()
    for w in worlds:
        w.close()


def _tensor_at(va, count, dtype):
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * nbytes).from_address(va),
                            dtype=dtype, count=count)


def test_tree_flatten_is_jax_order():
    tree = {"params": {"layer_1": {"w": 3}, "embed": {"e": 1},
                       "layer_0": {"b": 2, "a": [4, (5, 6)]}},
            "skip": None}
    leaves, unflatten = tree_flatten(tree)
    assert leaves == [1, 4, 5, 6, 2, 3]
    again = unflatten([x * 10 for x in leaves])
    assert again == {"params": {"layer_1": {"w": 30}, "embed": {"e": 10},
                                "layer_0": {"b": 20, "a": [40, (50, 60)]}},
                     "skip": None}


# ------------------------------------------------------------- path 1

def test_path1_exporter_memory_expect_zero():
    """numpy and tensor leaves in FakeHBMExporter memory reduce in place
    with zero staged bytes."""
    exporters = [FakeHBMExporter(), FakeHBMExporter()]
    worlds, shims = make_world2(exporters)
    rng = np.random.default_rng(7)
    trees = []
    for r in range(2):
        w = device_ndarray(exporters[r], (128, 33), np.float32)
        n = device_ndarray(exporters[r], (50,), np.int32)
        w[:] = rng.standard_normal((128, 33)).astype(np.float32)
        n[:] = rng.integers(-100, 100, 50).astype(np.int32)
        t = _tensor_at(exporters[r].alloc(2 * 300), 300, torch.bfloat16)
        t.copy_(torch.linspace(-2, 2, 300) * (r + 1))
        trees.append({"w": w, "n": n, "t": t})
    want = {"w": trees[0]["w"] + trees[1]["w"],
            "n": trees[0]["n"] + trees[1]["n"],
            "t": trees[0]["t"] + trees[1]["t"]}
    with staging.expect_zero():
        run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    for r in range(2):
        np.testing.assert_array_equal(trees[r]["w"], want["w"])
        np.testing.assert_array_equal(trees[r]["n"], want["n"])
        assert torch.equal(trees[r]["t"], want["t"])
    close_all(worlds, shims)


def test_path1_arena_coalesces_and_tied_leaf_reduces_once():
    exporters = [FakeHBMExporter(), FakeHBMExporter()]
    worlds, shims = make_world2(exporters)
    arenas = [DeviceArena(exporters[r], 1 << 16) for r in range(2)]
    trees = []
    for r in range(2):
        a = arenas[r].take((37, 11), np.float32)
        b = arenas[r].take((203,), np.float32)
        a[:] = r + 1
        b[:] = 10.0 * (r + 1)
        trees.append({"a": a, "b": b, "a_tied": a})
    with staging.expect_zero():
        run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    for r in range(2):
        assert len(shims[r]._regs) == 1, "leaves did not coalesce"
        np.testing.assert_array_equal(trees[r]["a"], np.full((37, 11), 3.0))
        np.testing.assert_array_equal(trees[r]["b"], np.full(203, 30.0))
    close_all(worlds, shims)
    for a in arenas:
        a.free()


def test_path1_live_gap_not_coalesced():
    exporters = [FakeHBMExporter(), FakeHBMExporter()]
    worlds, shims = make_world2(exporters)
    vas = [exporters[r].alloc(4096) for r in range(2)]
    trees, guards = [], []
    for r in range(2):
        a = as_ndarray(vas[r], (25,), np.float32)
        g = as_ndarray(vas[r] + 100, (28,), np.uint8)
        b = as_ndarray(vas[r] + 128, (25,), np.float32)
        a[:], b[:], g[:] = r + 1, 10.0 * (r + 1), 77
        trees.append([a, b])
        guards.append(g)
    with staging.expect_zero():
        run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    for r in range(2):
        np.testing.assert_array_equal(trees[r][0], np.full(25, 3.0))
        np.testing.assert_array_equal(trees[r][1], np.full(25, 30.0))
        assert (guards[r] == 77).all(), "live gap bytes were corrupted"
        assert len(shims[r]._regs) == 2
    close_all(worlds, shims)
    for r in range(2):
        exporters[r].free(vas[r])


# ------------------------------------------------------------- path 2

def test_path2_adopted_tensors_in_place_expect_zero():
    """CPU tensors adopted by a CUDAExporter reduce in place (the input
    tensors are consumed), zero staged bytes; the second call hits the
    registration cache."""
    worlds, shims = make_world2([CUDAExporter(), CUDAExporter()])
    g = torch.Generator().manual_seed(3)
    trees = [{"w": torch.randn(64, 33, generator=g),
              "n": torch.arange(50, dtype=torch.int32) * (r + 1),
              "h": torch.randn(300, generator=g).to(torch.bfloat16)}
             for r in range(2)]
    ins = [{k: v.clone() for k, v in t.items()} for t in trees]
    out = [None, None]
    with staging.expect_zero():
        run_ranks(worlds, lambda w, r: out.__setitem__(r, shims[r](trees[r])))
    for r in range(2):
        for k in trees[r]:
            assert out[r][k] is trees[r][k]
            assert torch.equal(trees[r][k], ins[0][k] + ins[1][k]), k
    regs = [dict(s._regs) for s in shims]
    with staging.expect_zero():
        run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    for r in range(2):
        assert shims[r]._regs == regs[r], "re-registered"
        assert torch.equal(trees[r]["n"], torch.arange(50,
                                                       dtype=torch.int32) * 6)
    close_all(worlds, shims)


def test_path2_mean_float_and_int():
    worlds, shims = make_world2([CUDAExporter(), CUDAExporter()], mean=True)
    trees = [{"f": torch.full((1000,), 1.0 + 2 * r),
              "b": torch.full((70,), 1.0 + 2 * r, dtype=torch.bfloat16),
              "i": torch.full((9,), 3 + 4 * r, dtype=torch.int64)}
             for r in range(2)]
    with staging.expect_zero():
        run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    for r in range(2):
        assert torch.equal(trees[r]["f"], torch.full((1000,), 2.0))
        assert torch.equal(trees[r]["b"],
                           torch.full((70,), 2.0, dtype=torch.bfloat16))
        assert torch.equal(trees[r]["i"],
                           torch.full((9,), 5, dtype=torch.int64))
    close_all(worlds, shims)


# ------------------------------------------------------------- path 3

def test_path3_staged_counts_bytes_and_writes_back():
    """Without an exporter every leaf stages: CPU tensors are written
    back in place, numpy leaves come back as fresh arrays, and every
    staged byte (D2H + H2D) is counted."""
    worlds, shims = make_world2()
    trees = [{"t": torch.full((100,), float(r + 1)),
              "h": torch.full((33,), float(r + 1), dtype=torch.bfloat16),
              "a": np.full(17, r + 1, np.int32)} for r in range(2)]
    out = [None, None]
    staging.reset()
    run_ranks(worlds, lambda w, r: out.__setitem__(r, shims[r](trees[r])))
    assert staging.bytes == 2 * 2 * (100 * 4 + 33 * 2 + 17 * 4)
    for r in range(2):
        assert out[r]["t"] is trees[r]["t"]
        assert torch.equal(out[r]["t"], torch.full((100,), 3.0))
        assert torch.equal(out[r]["h"],
                           torch.full((33,), 3.0, dtype=torch.bfloat16))
        assert out[r]["a"] is not trees[r]["a"]
        np.testing.assert_array_equal(out[r]["a"], np.full(17, 3))
    split = shims[0].last_split
    assert set(split) == {"gather_s", "ring_s", "scatter_s"}
    assert split["ring_s"] > 0
    close_all(worlds, shims)


def test_mixed_tree_stages_only_unowned_leaves():
    """Adopted CPU tensors ride path 2; a numpy leaf in the same tree
    (which a CUDAExporter does not own) stages, and only its bytes are
    charged."""
    worlds, shims = make_world2([CUDAExporter(), CUDAExporter()])
    trees = [{"dev": torch.full((512,), float(r + 1)),
              "host": np.full(100, float(r + 1), np.float32)}
             for r in range(2)]
    out = [None, None]
    staging.reset()
    run_ranks(worlds, lambda w, r: out.__setitem__(r, shims[r](trees[r])))
    assert staging.bytes == 2 * (100 * 4 * 2)
    for r in range(2):
        assert out[r]["dev"] is trees[r]["dev"]
        assert torch.equal(out[r]["dev"], torch.full((512,), 3.0))
        np.testing.assert_array_equal(out[r]["host"], np.full(100, 3.0))
    close_all(worlds, shims)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("staged", [False, True])
def test_mean_is_bitwise_half_the_sum(dtype, staged, monkeypatch):
    """mean=True at world 2: the sum rounds once and /2 is exact, so
    every element is bitwise (a + b) / 2 in the leaf's dtype, on the
    in-place and on the staged path, at uneven sizes across segments
    (TDR_STAGE_CHUNK at its 4 KiB floor)."""
    monkeypatch.setenv("TDR_STAGE_CHUNK", "4096")
    exporters = None if staged else [CUDAExporter(), CUDAExporter()]
    worlds, shims = make_world2(exporters, mean=True)
    g = torch.Generator().manual_seed(11)
    sizes = (1, 2047, 5000, 13)
    trees = [[torch.randn(n, generator=g).to(dtype) for n in sizes]
             for _ in range(2)]
    want = [(a + b) / 2 for a, b in zip(*trees)]
    staging.reset()
    run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert staging.bytes == (2 * 2 * sum(sizes) * itemsize if staged else 0)
    for r in range(2):
        for got, w in zip(trees[r], want):
            assert torch.equal(got, w)
    close_all(worlds, shims)


def test_pipelined_staging_matches_serial(monkeypatch):
    monkeypatch.setenv("TDR_STAGE_CHUNK", "4096")
    monkeypatch.setenv("TDR_STAGE_PIPELINE", "1")
    worlds, shims = make_world2()
    trees = [[torch.arange(3000, dtype=torch.float32) * (r + 1)
              for _ in range(3)] for r in range(2)]
    run_ranks(worlds, lambda w, r: shims[r](trees[r]))
    for r in range(2):
        for t in trees[r]:
            assert torch.equal(t, torch.arange(3000,
                                               dtype=torch.float32) * 3)
    close_all(worlds, shims)


def test_schedule_mismatch_fails_fast():
    """Ranks with different trees fail in the digest exchange, before
    any ring op, with a schedule-mismatch error on every rank."""
    worlds, shims = make_world2()
    trees = [torch.ones(32), torch.ones(48)]
    errs = [None, None]

    def step(w, r):
        try:
            shims[r](trees[r])
        except TransportError as e:
            errs[r] = e

    run_ranks(worlds, step)
    for e in errs:
        assert e is not None and "schedule mismatch" in str(e)
        assert not e.retryable
    close_all(worlds, shims)


def test_step_token_is_in_the_digest():
    worlds, shims = make_world2()
    trace.reset()
    for r, s in enumerate(shims):
        s.set_step_token(5 if r == 0 else 6)
    errs = [None, None]

    def step(w, r):
        try:
            shims[r](torch.ones(8))
        except TransportError as e:
            errs[r] = e

    run_ranks(worlds, step)
    assert all(e is not None and "step:" in str(e) for e in errs)
    close_all(worlds, shims)


def test_unported_options_raise(monkeypatch):
    """The overlap options are ported: each builds a shim, and a wire
    dtype without overlap (argument or TDR_WIRE_DTYPE) is the JAX
    shim's ValueError, not a NotImplementedError."""
    worlds = local_worlds(2, port_band(8))
    for kw in (dict(overlap=True), dict(bucket_bytes=1 << 20),
               dict(overlap=True, wire_dtype="bf16"), dict(per_layer=True)):
        CrossSliceAllReduce(worlds[0], **kw).close()
    with pytest.raises(ValueError, match="overlap"):
        CrossSliceAllReduce(worlds[0], wire_dtype="bf16")
    monkeypatch.setenv("TDR_WIRE_DTYPE", "int8")
    with pytest.raises(ValueError, match="overlap"):
        CrossSliceAllReduce(worlds[0])
    for w in worlds:
        w.close()


# ------------------------------------------------------- tied leaves

@pytest.mark.parametrize("mode", ["serial", "pipelined", "bucketed",
                                  "bucketed_small"])
def test_tied_leaf_across_segments_sums_once(mode, monkeypatch):
    """A tensor that occurs twice in the tree, its occurrences in
    different staged segments (TDR_STAGE_CHUNK at its 4 KiB floor), is
    gathered twice before either write-back: both occurrences come
    back as the sum of the ranks' local values, as the JAX shim returns
    for the same tree of numpy arrays (a = c = 3.0, b = 30.0)."""
    monkeypatch.setenv("TDR_STAGE_CHUNK", "4096")
    if mode == "pipelined":
        monkeypatch.setenv("TDR_STAGE_PIPELINE", "1")
    kw = {"bucketed": dict(overlap=True),
          "bucketed_small": dict(overlap=True, bucket_bytes=4096)}.get(
              mode, {})

    def trees(make):
        out = []
        for r in range(2):
            t = make(3000, r + 1.0)
            out.append({"a": t, "b": make(5000, 10.0 * (r + 1)), "c": t})
        return out

    from rocnrdma_tpu.collectives.jax_shim import \
        CrossSliceAllReduce as JaxShim
    from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds

    base = port_band(16)
    jw = jax_worlds(2, base)
    tw = local_worlds(2, base + 8)
    js = [JaxShim(w, **kw) for w in jw]
    ts = [CrossSliceAllReduce(w, **kw) for w in tw]
    jt = trees(lambda n, v: np.full(n, v, np.float32))
    tt = trees(lambda n, v: torch.full((n,), v))
    jout, tout = [None, None], [None, None]
    run_ranks(jw, lambda w, r: jout.__setitem__(r, js[r](jt[r])))
    run_ranks(tw, lambda w, r: tout.__setitem__(r, ts[r](tt[r])))
    for r in range(2):
        for k, v in (("a", 3.0), ("b", 30.0), ("c", 3.0)):
            np.testing.assert_array_equal(np.asarray(jout[r][k]),
                                          tout[r][k].numpy())
            assert torch.equal(tout[r][k], torch.full_like(tout[r][k], v))
        assert tout[r]["a"] is tout[r]["c"] is tt[r]["a"]
    for s in js + ts:
        s.close()
    for w in jw + tw:
        w.close()


# ------------------------------------------- digest against the JAX shim

def _describe(shim, leaves):
    staged, coalesced, ops, groups, _ = shim._classify(leaves)
    text = shim._sched_describe(leaves, coalesced, ops, groups,
                                shim._stage_chunk(), wire=None)
    unhold = getattr(shim.exporter, "unhold", None)
    for va, _, _ in ops:
        unhold(va)
    return text


@pytest.mark.parametrize("path", ["staged", "adopted", "exporter"])
def test_sched_describe_matches_the_jax_shim(path):
    """For the same tree — nested dicts, f32 + bf16 + int32 leaves of
    uneven and of equal sizes — the torch shim's schedule description
    (the text the digest hashes) is byte-for-byte the JAX shim's, on
    each data path, with a step token and mean."""
    import jax
    import ml_dtypes

    from rocnrdma_tpu.collectives.jax_shim import \
        CrossSliceAllReduce as JaxShim
    from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
    from rocnrdma_tpu.hbm.registry import FakeHBMExporter as JaxFake
    from rocnrdma_tpu.hbm.registry import device_ndarray as jax_dev
    from rocnrdma_tpu.hbm.tpu import TPUExporter

    shapes = {"b": {"wq": ((16, 16), "float32"), "wo": ((16, 16), "float32"),
                    "n": ((16,), "float32")},
              "a": {"emb": ((33, 7), "bfloat16"), "i": ((5,), "int32")}}
    np_dt = {"float32": np.float32, "int32": np.int32,
             "bfloat16": ml_dtypes.bfloat16}

    def np_tree(make):
        return {k: {n: make(s, np_dt[d]) for n, (s, d) in v.items()}
                for k, v in shapes.items()}

    base = port_band(16)
    jw = jax_worlds(2, base)
    tw = local_worlds(2, base + 8)
    if path == "staged":
        jtree = np_tree(np.zeros)
        ttree = jax.tree_util.tree_map(
            lambda a: torch.zeros(a.shape, dtype=getattr(
                torch, a.dtype.name)), jtree)
        jexp = texp = None
    elif path == "adopted":
        jtree = jax.tree_util.tree_map(
            lambda a: jax.device_put(a), np_tree(np.zeros))
        ttree = jax.tree_util.tree_map(
            lambda a: torch.zeros(a.shape, dtype=getattr(
                torch, a.dtype.name)), np_tree(np.zeros))
        jexp, texp = TPUExporter(), CUDAExporter()
    else:
        jexp, texp = JaxFake(), FakeHBMExporter()
        jtree = np_tree(lambda s, d: jax_dev(jexp, s, d))
        ttree = np_tree(lambda s, d: device_ndarray(texp, s, d))
    js = JaxShim(jw[0], exporter=jexp, mean=True)
    ts = CrossSliceAllReduce(tw[0], exporter=texp, mean=True)
    js.set_step_token(3)
    ts.set_step_token(3)
    want = _describe(js, jax.tree_util.tree_leaves(jtree))
    got = _describe(ts, tree_flatten(ttree)[0])
    assert got == want
    marker = {"staged": "s:bfloat16:231", "adopted": "j:462:bfloat16",
              "exporter": "z:"}[path]
    assert marker in got and "step:3" in got and "mean=1" in got
    for s in (js, ts):
        s.close()
    for w in jw + tw:
        w.close()
