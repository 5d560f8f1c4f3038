"""The port's fault soak (``tools/torch_fault_soak.py``) and ring-attention
demo (``examples/ring_attention_demo_torch.py``) against the reference's
(``tools/fault_soak.py``, ``tests/test_fault_soak.py``, and the JAX
package's ``attention_reference``).

On the CPU, llama-tiny in f32, the ranks threads of this process:

- the seeded plans are the reference's strings, and the CLI hands the
  soak the reference's plan for the same flags;
- the mixed-plan soak (a transient ring fault, a corrupted sealed frame,
  a connection drop) ends bitwise equal to its clean run with the
  reference's counters; the world-4 arbitrated flap, the world-8
  concurrent case and the topology delegate flap likewise (``slow``, as
  the reference marks them);
- the port's clean soak against the JAX package's clean soak from the
  same initial weights (the JAX ``Trainer(seed=11)``'s, carried over by
  ``params_from_flax``: the two packages' inits differ), by
  ``tests/test_torch_trainer.py``'s three-step rule scaled to the
  soak's learning rate of 1e-2. Every element lies within steps * 2 *
  lr (Adam moves an element by at most ~lr a step, so this catches only
  a gross fault). At most one element in a thousand lies beyond lr / 30:
  the rule's 1e-5 at lr 3e-4, scaled with lr, because from the second
  step on Adam turns a difference of the two sides' f32 sums in an
  element whose gradients nearly cancel into a difference of its update
  in proportion to lr. Unscaled, 1e-5 is exceeded by 1.6% of the
  elements between the two packages' plain trainers on the soak's
  batches (no ring at all) and by 1.1% between the soaks; beyond lr / 30
  by 3 elements of 106,816 either way. The soak's own DP path is held
  to the unscaled rule: against the port's single ``Trainer`` on both
  ranks' batches concatenated (the mean of the two ranks' mean-loss
  gradients is the combined batch's, up to the order of the sums), at
  most one element in a thousand beyond 1e-5 (measured: none);
- the demo as a subprocess prints its OK line, and its forward and
  gradients equal the JAX package's ``attention_reference`` and its
  ``jax.vjp`` on the same numpy inputs to the demo's 2e-3.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.ops.attention import attention_reference as jax_attention
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import Trainer
from test_hier import port_band

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-2          # the soak's learning rate (both tools)
DEMO_TOL = 2e-3    # the demo's own tolerance


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fs = _load("fault_soak", "tools", "fault_soak.py")
tfs = _load("torch_fault_soak", "tools", "torch_fault_soak.py")
demo = _load("ring_attention_demo_torch", "examples",
             "ring_attention_demo_torch.py")


@pytest.mark.parametrize("world", (2, 4, 8))
@pytest.mark.parametrize("seed", range(16))
def test_make_fault_plan_is_the_reference_string(seed, world):
    for steps in range(1, 7):
        got = tfs.make_fault_plan(seed, steps, world)
        assert got == fs.make_fault_plan(seed, steps, world), (steps, got)
        assert got.startswith("ring:nth=") and ":corrupt=" in got


@pytest.mark.parametrize("flags", (
    [], ["--concurrent"], ["--netem", "delay=50"],
    ["--plan", "send:nth=3:corrupt=2", "--netem", "dup=1"]),
    ids=("seeded", "concurrent", "netem", "plan+netem"))
def test_cli_hands_the_soak_the_reference_plan(monkeypatch, capsys, flags):
    """Both CLIs, their soaks stubbed: the faulty run gets the same plan
    for the same flags, and the verdict line has the same keys."""
    seen = {}
    stats = {k: 0 for k in (
        "fault_hits", "resumes", "rebuilds", "integrity_failed",
        "retransmits", "ctl", "generations", "flapped", "side_ok",
        "hier_collectives", "topology")}

    def stub(which):
        def run_soak(*args, fault_plan=None, **kw):
            seen.setdefault(which, []).append(fault_plan)
            return {}, dict(stats)
        return run_soak

    argv = ["--steps", "3", "--seed", "5", "--world", "4"] + flags
    lines = {}
    for which, mod, extra in (("jax", fs, []), ("torch", tfs, ["--cpu"])):
        monkeypatch.setattr(mod, "run_soak", stub(which))
        assert mod.main(argv + extra) == 0
        lines[which] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert seen["torch"] == seen["jax"] and seen["jax"][1]
    assert lines["torch"] == lines["jax"]


def test_soak_short_seeded_parity_mixed_plan(tmp_path):
    """Clean vs injected-fault elastic training under a MIXED plan —
    transient collective fault + sealed-payload corruption + a
    connection drop (the 13th post, as in the reference's test): equal
    final params bit for bit, every clause fired, and the corruption
    was detected (not silently averaged)."""
    steps, seed = 3, 1
    plan = tfs.make_fault_plan(seed, steps) + ",conn:drop_after=12"
    clean, _ = tfs.run_soak(steps=steps, seed=seed, device="cpu",
                            base_port=port_band(32),
                            ckpt_dir=str(tmp_path / "clean"))
    faulty, stats = tfs.run_soak(steps=steps, seed=seed, device="cpu",
                                 base_port=port_band(32),
                                 ckpt_dir=str(tmp_path / "faulty"),
                                 fault_plan=plan)
    assert stats["fault_hits"] >= 2, stats
    assert stats["resumes"] >= 1, stats
    assert stats["rebuilds"] >= 2, stats  # begin/ok traced per rank
    assert stats["integrity_failed"] >= 1, stats
    assert tfs.params_equal(clean, faulty)
    assert tfs.hb_thread_census() == 0


@pytest.mark.slow
def test_soak_world4_arbitrated_flap_parity(tmp_path):
    """Rank 1 flaps at world 4, every rebuild arbitrated by an
    in-process coordinator (its port range from ``port_band``): bitwise
    the clean run, every generation bump a coordinator decision."""
    steps, seed = 2, 5
    clean, _ = tfs.run_soak(steps=steps, seed=seed, world=4, device="cpu",
                            base_port=port_band(32),
                            ckpt_dir=str(tmp_path / "clean"))
    faulty, stats = tfs.run_soak(steps=steps, seed=seed, world=4,
                                 device="cpu", base_port=port_band(160),
                                 ckpt_dir=str(tmp_path / "faulty"),
                                 coordinator=True, flap=(1, 2))
    assert tfs.params_equal(clean, faulty)
    assert stats["resumes"] >= 1, stats
    assert stats["ctl"].get("ctl.report", 0) >= 1, stats
    assert stats["ctl"].get("ctl.rebuild", 0) >= 1, stats
    assert stats["ctl"].get("ctl.release", 0) >= 2, stats
    assert len(stats["generations"]) == 1, stats
    assert stats["generations"][0] >= 1, stats
    assert tfs.hb_thread_census() == 0


@pytest.mark.slow
def test_soak_world8_flap_two_faults_concurrent_parity(tmp_path):
    """World 8: a flapping rank, two sealed-payload corruptions, the
    "side" world sharing the engines, every rebuild arbitrated —
    bitwise the clean run (the reference's plan)."""
    steps, seed = 3, 8
    plan = "send:nth=6:corrupt=3,send:nth=55:corrupt=2"
    clean, _ = tfs.run_soak(steps=steps, seed=seed, world=8, device="cpu",
                            base_port=port_band(64),
                            ckpt_dir=str(tmp_path / "clean"))
    faulty, stats = tfs.run_soak(steps=steps, seed=seed, world=8,
                                 device="cpu", base_port=port_band(320),
                                 ckpt_dir=str(tmp_path / "faulty"),
                                 fault_plan=plan, coordinator=True,
                                 flap=(3, 2), concurrent=True)
    assert tfs.params_equal(clean, faulty)
    assert stats["fault_hits"] >= 2, stats
    assert stats["resumes"] >= 1, stats
    assert stats["integrity_failed"] >= 1, stats
    assert stats["side_ok"], stats
    assert stats["ctl"].get("ctl.rebuild", 0) >= 1, stats
    assert len(stats["generations"]) == 1, stats
    assert stats["generations"][0] >= 1, stats


@pytest.mark.slow
def test_soak_topology_delegate_flap_parity(tmp_path):
    """World 4 over two emulated hosts (``a,a,b,b``), rank 2 — host b's
    delegate — flaps: the flat ring and both tier rings rebuild, and
    the run ends bitwise the clean (also hierarchical) run."""
    steps, seed = 2, 21
    clean, cstats = tfs.run_soak(steps=steps, seed=seed, world=4,
                                 device="cpu", base_port=port_band(64),
                                 ckpt_dir=str(tmp_path / "clean"),
                                 topology="a,a,b,b")
    assert cstats["hier_collectives"] >= 1, cstats
    faulty, stats = tfs.run_soak(steps=steps, seed=seed, world=4,
                                 device="cpu", base_port=port_band(64),
                                 ckpt_dir=str(tmp_path / "faulty"),
                                 flap=(2, 2), topology="a,a,b,b")
    assert tfs.params_equal(clean, faulty)
    assert stats["resumes"] >= 1, stats
    assert stats["rebuilds"] >= 1, stats
    assert stats["hier_collectives"] >= 1, stats
    assert stats["flapped"] and stats["topology"] == "a,a,b,b"


def test_clean_soak_matches_the_jax_clean_soak(tmp_path):
    """The two packages' clean soaks from the same weights: the bound of
    the module docstring."""
    steps, seed = 3, 1
    jax_final, jstats = fs.run_soak(steps=steps, seed=seed,
                                    base_port=port_band(32),
                                    ckpt_dir=str(tmp_path / "jax"))
    init = JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=11,
                      learning_rate=LR).params
    state0 = tllama.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            init))
    got, tstats = tfs.run_soak(steps=steps, seed=seed, device="cpu",
                               base_port=port_band(32),
                               ckpt_dir=str(tmp_path / "torch"),
                               params=state0)
    assert jstats["resumes"] == tstats["resumes"] == 0
    _assert_within_rule(got, tllama.params_from_flax(jax_final), state0,
                        steps, LR / 30)
    single = Trainer("llama-tiny", {"dp": 1, "tp": 1}, seed=11,
                     learning_rate=LR, device="cpu", params=state0)
    data_rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = data_rng.integers(0, 255, (2, 2, 17)).astype(np.int32)
        single.step(torch.from_numpy(batch.reshape(4, 17)))
    _assert_within_rule(got, single.state_dict(), state0, steps, 1e-5)


def _assert_within_rule(got, want, state0, steps, far_above):
    """Every element within steps * 2 * lr, at most one in a thousand
    beyond ``far_above``, and the params did move."""
    assert got.keys() == want.keys()
    far, total, moved = 0, 0, 0.0
    for name, w in want.items():
        diff = np.abs(got[name].numpy() - w.numpy())
        assert float(diff.max()) <= steps * 2 * LR, name
        far += int((diff > far_above).sum())
        total += diff.size
        moved = max(moved, float(np.abs(w.numpy()
                                        - state0[name].numpy()).max()))
    assert far <= total // 1000, (far, total)
    assert moved > LR


def test_demo_prints_its_ok_line():
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "examples", "ring_attention_demo_torch.py"),
         "--cpu", "--world", "3", "--seq-local", "64",
         "--port", str(port_band(16))],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "world=3 seq=192 (64/rank) heads=4 kv=2 d=32"
    assert "5 rotations/rank" in lines[1]
    assert lines[-1] == "ring attention fwd+bwd == full attention OK"


def test_demo_matches_the_jax_reference_and_its_vjp():
    world, sl, h, kvh, d = 3, 64, 4, 2, 32
    res = demo.ring_attention_demo(world, sl, h, kvh, d, port_band(16),
                                   device="cpu")
    q, k, v, do = demo.make_inputs(world, sl, h, kvh, d)
    for name, a in zip("q k v do".split(), (q, k, v, do)):
        assert np.array_equal(res[name].numpy(), a), name
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_attention(q_, k_, v_, causal=True),
        jq, jk, jv)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        err = float(np.abs(res[name].numpy() - w).max())
        assert err < DEMO_TOL, (name, err)
