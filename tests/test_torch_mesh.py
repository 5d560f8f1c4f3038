"""The port's intra-slice dp × tp mesh (``parallel/mesh.py``,
``ops/sharding.py``, ``models/llama_mesh.py``, ``Trainer(mesh_shape,
devices)``) against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's meshes name the CPU once per position
(``devices=["cpu"] * n``), its counterpart. Inputs come from numpy
seeds; the port starts from the JAX trainer's own initial parameters
(``params_from_flax``).

Tolerances, with their reasons:
- specs exactly equal (a spec is a tuple of axis names either way);
- losses to 2e-4 against the JAX trainer (its own llama-tiny bound, as
  ``tests/test_torch_trainer.py``), parameters after three AdamW steps
  to rtol 1e-3 / atol 1e-4 (an element whose gradient is near zero
  may move by a few lr·1e-2 when the two sides' f32 sums, taken in
  another order over a sharded product, differ in its last bits);
- against the port's own single-position trainer on the same weights:
  losses and parameters after three steps to 1e-5 (the meshed step
  sums row-parallel partials and dp copies in another order than one
  whole product, all in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.models import llama as jllama
from rocnrdma_tpu.parallel import mesh as jmesh
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.models import llama_mesh
from rocnrdma_tpu_torch.ops import sharding
from rocnrdma_tpu_torch.parallel import mesh as tmesh
from rocnrdma_tpu_torch.parallel.trainer import MeshTrainer, Trainer

LOSS_TOL = 2e-4

# The JAX package's odd geometry (tests/test_model_trainer.py): three
# heads, which no tp of 2 or 4 divides.
ODD = dict(name="odd", vocab_size=64, d_model=48, n_layers=1, n_heads=3,
           n_kv_heads=3, d_ff=64, max_seq_len=32)
JAX_CFG = {"llama-tiny": "llama-tiny",
           "llama3-1b": "llama3-1b", "llama3-8b": "llama3-8b",
           "odd": jllama.LlamaConfig(**ODD, dtype=jnp.float32)}
TORCH_CFG = {"llama-tiny": "llama-tiny",
             "odd": tllama.LlamaConfig(**ODD, dtype=torch.float32)}


def _n(shape):
    return int(np.prod(list(shape.values())))


def _cpu_mesh(shape):
    return tmesh.make_mesh(shape, ["cpu"] * _n(shape))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _state(jt):
    return tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.params))


def _to_dict(tree):
    return {k: _to_dict(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


# ----------------------------------------------------------------- specs

@pytest.mark.parametrize("shape", [
    {"dp": 2, "tp": 2}, {"dp": 2, "tp": 4}, {"dp": 1, "tp": 8},
    {"tp": 3}, {"dp": 8}], ids=["dp2tp2", "dp2tp4", "tp8", "tp3", "dp8"])
@pytest.mark.parametrize("config", ["llama-tiny", "llama3-1b", "llama3-8b",
                                    "odd"])
def test_param_specs_equal_the_jax_specs(config, shape):
    """Every leaf's spec equals the JAX ``param_shardings``' spec,
    the replication fallback included (tp 3 divides no vocab here, tp 8
    not llama-tiny's kv width, a mesh without tp shards nothing)."""
    model = jllama.make_model(JAX_CFG[config])
    abstract = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((1, 8), dtype=jnp.int32)), jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(
        lambda s: tuple(s.spec),
        jmesh.param_shardings(jmesh.make_mesh(shape), abstract))
    tree = _to_dict(jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, device="meta"), abstract))
    got = tmesh.param_shardings(_cpu_mesh(shape), tree)
    assert got == _to_dict(want)
    specs = jax.tree_util.tree_leaves(got, is_leaf=lambda x:
                                      isinstance(x, tuple))
    if config != "odd" and shape.get("tp", 1) == 2:
        assert ("tp", None) in specs and (None, "tp") in specs


def test_batch_spec_and_replicated():
    assert tmesh.batch_spec() == tuple(jmesh.batch_spec())
    mesh = _cpu_mesh({"dp": 2, "tp": 2})
    assert tmesh.replicated(mesh) == tuple(
        jmesh.replicated(jmesh.make_mesh({"dp": 2, "tp": 2})).spec)


def test_make_mesh_needs_enough_devices():
    """Short of devices, ``make_mesh`` raises as the JAX one does; the
    default devices are the visible cards, so a mesh of more than the
    card count without ``devices`` raises, in the trainer too."""
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh({"dp": 2, "tp": 8})
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh({"dp": 2, "tp": 8}, ["cpu"] * 8)
    assert str(terr.value) == str(jerr.value)
    cards = torch.cuda.device_count()
    if cards < 4:
        with pytest.raises(ValueError,
                           match=f"needs 4 devices, have {cards}"):
            tmesh.make_mesh({"dp": 2, "tp": 2})
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        Trainer("llama-tiny", {"dp": 2, "tp": 2}, device="cpu")
    mesh = _cpu_mesh({"dp": 2, "tp": 3})
    assert mesh.shape == {"dp": 2, "tp": 3} and mesh.size == 6
    assert mesh.groups("tp") == [[0, 1, 2], [3, 4, 5]]
    assert mesh.groups("dp") == [[0, 3], [1, 4], [2, 5]]
    assert mesh.coords(4) == {"dp": 1, "tp": 1}


# ----------------------------------------------- cross-position operations

def _terms(n, shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).requires_grad_()
            for _ in range(n)]


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def test_psum_sums_in_position_order_forward_and_back():
    mesh = _cpu_mesh({"dp": 2, "tp": 2})
    xs = _terms(4, (3, 5), torch.bfloat16)
    ys = tmesh.psum(xs, mesh, "tp")
    for group in mesh.groups("tp"):
        want = (xs[group[0]].float() + xs[group[1]].float()).to(
            torch.bfloat16)
        for p in group:
            assert torch.equal(ys[p], want)
    assert len(set(_ptrs(ys) + _ptrs(xs))) == 8      # no shared storage
    gs = _terms(4, (3, 5), torch.bfloat16, seed=1)
    grads = torch.autograd.grad(ys, xs, [g.detach() for g in gs])
    for group in mesh.groups("tp"):
        want = (gs[group[0]].float() + gs[group[1]].float()).to(
            torch.bfloat16)
        for p in group:
            assert torch.equal(grads[p], want)
    dp = tmesh.psum(xs, mesh, "dp")
    assert torch.equal(dp[1], (xs[1].float() + xs[3].float()).to(
        torch.bfloat16))


def test_all_gather_and_gather_forward_and_back():
    mesh = _cpu_mesh({"dp": 1, "tp": 3})
    xs = _terms(3, (4, 2))
    ys = tmesh.all_gather(xs, mesh, "tp", 1)
    full = torch.cat([x.detach() for x in xs], 1)
    assert all(torch.equal(y, full) for y in ys)
    assert len(set(_ptrs(ys))) == 3
    gs = _terms(3, (4, 6), seed=2)
    grads = torch.autograd.grad(ys, xs, [g.detach() for g in gs])
    total = gs[0].detach() + gs[1].detach() + gs[2].detach()
    for i, g in enumerate(grads):
        assert torch.equal(g, total[:, 2 * i:2 * i + 2])
    out = tmesh.gather(xs, 0, "cpu")
    assert torch.equal(out, torch.cat([x.detach() for x in xs], 0))
    g = torch.randn(out.shape)
    grads = torch.autograd.grad(out, xs, g)
    for i, gi in enumerate(grads):
        assert torch.equal(gi, g[4 * i:4 * i + 4])


@pytest.mark.parametrize("spec", [("tp", None), (None, "tp"), (),
                                  ("dp", "tp")])
def test_shard_and_assemble_round_trip(spec):
    mesh = _cpu_mesh({"dp": 2, "tp": 2})
    full = torch.arange(48.0).reshape(8, 6)
    blocks = tmesh.shard(full, spec, mesh)
    for p, b in enumerate(blocks):
        c = mesh.coords(p)
        want = full
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = full.shape[dim] // 2
                want = want.narrow(dim, c[axis] * n, n)
        assert torch.equal(b, want) and b.is_contiguous()
    assert len(set(_ptrs(blocks) + [full.data_ptr()])) == 5
    assert torch.equal(tmesh.assemble(blocks, spec, mesh, "cpu"), full)


def test_run_sharded_cases():
    mesh = _cpu_mesh({"dp": 2, "tp": 2})
    one = _cpu_mesh({"dp": 1, "tp": 1})
    args = [(i,) for i in range(4)]
    assert sharding.run_sharded(one, lambda i: i * 10, args, True) == [0]
    assert sharding.run_sharded(None, lambda i: i * 10, args, False) == [0]
    assert sharding.run_sharded(mesh, lambda i: i * 10, args, True) == \
        [0, 10, 20, 30]
    assert sharding.run_sharded(mesh, None, args, False,
                                lambda a: [len(a)] * 4) == [4] * 4
    assert sharding.rms_ok(mesh) and not sharding.rms_ok(
        _cpu_mesh({"tp": 2}))
    assert sharding.attn_ok(mesh, 4, 2)
    assert not sharding.attn_ok(_cpu_mesh({"dp": 2, "tp": 4}), 4, 2)
    assert not sharding.attn_ok(mesh, 3, 3)


# ------------------------------------------------------- the meshed step

CASES = {"dp2tp2": ("llama-tiny", {"dp": 2, "tp": 2}),
         "dp2tp1": ("llama-tiny", {"dp": 2, "tp": 1}),
         "dp1tp2": ("llama-tiny", {"dp": 1, "tp": 2}),
         "dp2tp4_gathered": ("llama-tiny", {"dp": 2, "tp": 4}),
         "odd_dp2tp2_gathered": ("odd", {"dp": 2, "tp": 2})}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_the_jax_meshed_trainer(case):
    """The port's meshed ``Trainer`` against the JAX ``Trainer`` with the
    same mesh, initial parameters and tokens, three AdamW steps."""
    config, shape = CASES[case]
    jt = JaxTrainer(JAX_CFG[config], shape)
    pt = Trainer(TORCH_CFG[config], shape, devices=["cpu"] * _n(shape),
                 device="cpu", params=_state(jt))
    assert isinstance(pt, MeshTrainer)
    assert pt.model.attn_split == ("gathered" not in case)
    tok = _tokens(3, (4, 17), pt.cfg.vocab_size)
    for step in range(3):
        jl = jt.step(tok)
        tl = pt.step(torch.from_numpy(tok))
        assert abs(tl - jl) <= LOSS_TOL, (step, tl, jl)
    want = _state(jt)
    got = pt.state_dict()
    assert list(got) == tllama.param_names(pt.cfg.n_layers)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape", [{"dp": 2, "tp": 2}, {"dp": 2, "tp": 1},
                                   {"dp": 1, "tp": 2}, {"dp": 2, "tp": 4}],
                         ids=["dp2tp2", "dp2tp1", "dp1tp2", "dp2tp4"])
def test_meshed_steps_match_the_single_position_trainer(shape):
    state = tllama.init_params(tllama.LLAMA_TINY, seed=4, device="cpu")
    one = Trainer("llama-tiny", device="cpu", params=state)
    meshed = Trainer("llama-tiny", shape, devices=["cpu"] * _n(shape),
                     device="cpu", params=state)
    tok = torch.from_numpy(_tokens(5, (4, 21)))
    for step in range(3):
        a, b = one.step(tok), meshed.step(tok)
        assert abs(a - b) <= 1e-5, (step, a, b)
        if step == 0:
            grads = meshed.grads_tree()["params"]
            for name, p in one.model.named_parameters():
                node = grads
                for key in tllama._flax_path(name):
                    node = node[key]
                tol = 1e-5 * float(p.grad.abs().max())
                assert float((node - p.grad).abs().max()) <= tol, name
    want, got = one.state_dict(), meshed.state_dict()
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 1e-5, name


def test_parameters_are_stored_by_spec_without_shared_storage():
    state = tllama.init_params(tllama.LLAMA_TINY, seed=2, device="cpu")
    tr = Trainer("llama-tiny", {"dp": 2, "tp": 2}, devices=["cpu"] * 4,
                 device="cpu", params=state)
    m = tr.model

    def check():
        ptrs = [t.data_ptr() for t in m.parameters()]
        assert len(ptrs) == len(set(ptrs)) == 4 * len(state)
        for name, full in state.items():
            spec = m.spec[name]
            for p in range(4):
                blk = tmesh.block(full, spec, m.mesh, p)
                assert m.local[p][name].shape == blk.shape, name
        assert m.spec["layers.0.attn.wq"] == (None, "tp")
        assert m.spec["layers.0.attn.wo"] == ("tp", None)
        assert m.spec["embed"] == ("tp", None)
        assert m.spec["final_norm.weight"] == ()
        # The masters: one per logical block, the first copy of each.
        assert len(tr.opt.param_groups[0]["params"]) == sum(
            len(m.copies[n]) for n in m.names)

    check()
    assert all(torch.equal(m.state_dict()[n], state[n]) for n in state)
    got, want = tr.param_tree(), tllama.params_to_flax(state)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    tr.step(torch.from_numpy(_tokens(6, (2, 9))))
    check()
    for name in m.names:                      # copies equal after a step
        for group in m.copies[name]:
            for p in group[1:]:
                assert torch.equal(m.local[p][name],
                                   m.local[group[0]][name]), name
    assert all(not torch.equal(m.state_dict()[n], state[n]) for n in state)


def test_every_position_runs_the_kernel_ops_on_its_block(monkeypatch):
    """The meshed step calls the attention op (K3, with K5/K4 in its
    backward) and the RMSNorm op (K1, K2 backward) once per position on
    that position's local block; under remat each layer's calls again in
    the backward."""
    calls = {"attention": [], "rmsnorm": []}
    real_attn, real_rms = llama_mesh.attention, llama_mesh.rmsnorm

    def attn(q, k, v, causal=True):
        calls["attention"].append((tuple(q.shape), tuple(k.shape)))
        return real_attn(q, k, v, causal=causal)

    def rms(x, w, eps):
        calls["rmsnorm"].append(tuple(x.shape))
        return real_rms(x, w, eps)

    monkeypatch.setattr(llama_mesh, "attention", attn)
    monkeypatch.setattr(llama_mesh, "rmsnorm", rms)
    cfg = tllama.LLAMA_TINY
    L, hd = cfg.n_layers, cfg.head_dim
    for shape, remat, q_heads, kv_heads in (
            ({"dp": 2, "tp": 2}, False, 2, 1),
            ({"dp": 2, "tp": 2}, True, 2, 1),
            ({"dp": 2, "tp": 4}, False, 4, 2)):      # gathered weights
        calls = {"attention": [], "rmsnorm": []}
        n = _n(shape)
        tr = Trainer("llama-tiny", shape, devices=["cpu"] * n,
                     device="cpu", seed=1, remat=remat)
        tr.step(torch.from_numpy(_tokens(7, (4, 11))))
        again = 2 if remat else 1
        assert calls["attention"] == [((2, q_heads, 10, hd),
                                       (2, kv_heads, 10, hd))] * (
            n * L * again)
        assert calls["rmsnorm"] == [(2, 10, cfg.d_model)] * (
            n * (2 * L * again + 1))


def test_remat_gives_the_same_gradients():
    state = tllama.init_params(tllama.LLAMA_TINY, seed=3, device="cpu")
    tok = torch.from_numpy(_tokens(8, (4, 13)))
    trees = []
    for remat in (False, True):
        tr = Trainer("llama-tiny", {"dp": 2, "tp": 2}, devices=["cpu"] * 4,
                     device="cpu", params=state, remat=remat)
        tr.step(tok)
        trees.append(jax.tree_util.tree_leaves(tr.grads_tree()))
    assert all(torch.equal(a, b) for a, b in zip(*trees))


def test_batch_must_divide_dp():
    tr = Trainer("llama-tiny", {"dp": 2, "tp": 1}, devices=["cpu"] * 2,
                 device="cpu")
    with pytest.raises(ValueError, match="does not divide over dp=2"):
        tr.step(torch.from_numpy(_tokens(9, (3, 9))))


def test_a_subclass_does_not_drop_the_mesh():
    class Sub(Trainer):
        pass

    with pytest.raises(ValueError, match="more than one position"):
        Sub("llama-tiny", {"dp": 2, "tp": 1}, devices=["cpu"] * 2,
            device="cpu")
    assert isinstance(Sub("llama-tiny", {"dp": 1, "tp": 1}, device="cpu"),
                      Sub)


def test_mesh_axes_other_than_dp_and_tp_raise():
    with pytest.raises(ValueError, match="not dp or tp"):
        Trainer("llama-tiny", {"dp": 2, "sp": 2}, devices=["cpu"] * 4,
                device="cpu")


def test_single_axis_meshes_take_the_other_axis_as_one():
    state = tllama.init_params(tllama.LLAMA_TINY, seed=5, device="cpu")
    tok = torch.from_numpy(_tokens(10, (2, 9)))
    a = Trainer("llama-tiny", {"tp": 2}, devices=["cpu"] * 2, device="cpu",
                params=state)
    b = Trainer("llama-tiny", {"dp": 1, "tp": 2}, devices=["cpu"] * 2,
                device="cpu", params=state)
    assert a.mesh.shape == {"tp": 2, "dp": 1}
    assert a.step(tok) == b.step(tok)
