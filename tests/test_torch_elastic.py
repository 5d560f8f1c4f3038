"""Elastic training in the PyTorch port: the counterparts of
``tests/test_elastic.py`` and of the quarantine cases of
``tests/test_integrity.py``.

Each rank is a PROCESS (a llama-tiny ``Trainer`` on the CPU whose
gradients are averaged over the emu ring); a rank SIGKILLs itself
inside a gradient sync, is restarted as a supervisor would restart it,
restores its own checkpoint and rejoins. The survivors' elastic policy
rebuilds the world, restores and re-runs the step. Final params must be
BITWISE equal to the uninterrupted run: recovery is exact.

- world 2 on the legacy pairwise rendezvous, the fused sync; its
  uninterrupted run is also held against the JAX ``Trainer``'s world-2
  run from the same weights (carried by ``params_from_flax``) and
  batches, to ``tests/test_torch_trainer.py``'s tolerances: each
  step's loss to 2e-4; every parameter within 2 · lr per step, and at
  most one element in a thousand off by more than 1e-5;
- world 4 under the port's coordinator, two ranks killed in the same
  step;
- world 2 with the per-layer sync (post-accumulate-grad hooks), rank 1
  killed inside a backward, against the uninterrupted per-layer run;
- world 4 shrinking to 3 by RESIZE (threads, no restart), bitwise;
- the quarantine rung: non-finite synced gradients retried once in
  place (bitwise the never-poisoned run), and escalating to a
  retryable ``TransportError`` once ``max_resumes`` is spent.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.collectives.jax_shim import \
    CrossSliceAllReduce as JaxShim
from rocnrdma_tpu.collectives.world import local_worlds as jax_worlds
from rocnrdma_tpu.parallel.trainer import Trainer as JaxTrainer
from rocnrdma_tpu_torch.collectives.world import RingWorld
from rocnrdma_tpu_torch.control.coordinator import Coordinator
from rocnrdma_tpu_torch.models import llama as tllama
from rocnrdma_tpu_torch.parallel.trainer import ElasticPolicy, Trainer
from rocnrdma_tpu_torch.transport.engine import Engine, TransportError
from rocnrdma_tpu_torch.utils.trace import trace

from test_hier import port_band
from test_torch_world import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEPS = 4
LR = 3e-4
LOSS_TOL = 2e-4
SEED = 5

# One rank of the elastic job. argv: rank base_port steps ckpt_dir
# die_at (0 = never) world_size coordinator_address ("" = legacy
# pairwise rendezvous) mode ("fused" | "layered") init_weights (".npz"
# of a state dict, "" = init_params(seed)) mesh ("dp=N,tp=M", its
# positions all on the CPU; "" = one device). The kill switch counts
# sync calls (fused) or bucket pushes (layered).
RANK_SCRIPT = r"""
import json, os, signal, sys
import numpy as np
import torch

rank = int(sys.argv[1]); base = int(sys.argv[2]); steps = int(sys.argv[3])
ckdir = sys.argv[4]; die_at = int(sys.argv[5]); world_sz = int(sys.argv[6])
ctl = sys.argv[7]; mode = sys.argv[8]; init = sys.argv[9]
mesh = sys.argv[10]
torch.set_num_threads(1)

from rocnrdma_tpu_torch.collectives.torch_shim import CrossSliceAllReduce
from rocnrdma_tpu_torch.collectives.world import RingWorld
from rocnrdma_tpu_torch.parallel.checkpoint import (checkpoint_file,
                                                    restore_checkpoint,
                                                    save_checkpoint)
from rocnrdma_tpu_torch.parallel.mesh import parse_mesh
from rocnrdma_tpu_torch.parallel.trainer import ElasticPolicy, Trainer
from rocnrdma_tpu_torch.transport.engine import Engine
from rocnrdma_tpu_torch.utils.trace import trace

world = RingWorld(Engine("emu"), rank, world_sz, None if ctl else base,
                  timeout_ms=60000, controller=(ctl or None),
                  world_name="elastic")
sync = CrossSliceAllReduce(world, mean=True, per_layer=(mode == "layered"))


class KillSwitch:
    '''SIGKILL this process at its Nth sync call (fused) or bucket push
    (per layer): "a rank dies mid-step", deterministically.'''

    def __init__(self, inner, at):
        self.inner = inner
        self.at = at
        self.n = 0

    def tick(self):
        self.n += 1
        if self.at > 0 and self.n == self.at:
            os.kill(os.getpid(), signal.SIGKILL)

    def __call__(self, tree):
        self.tick()
        return self.inner(tree)

    def start_layered(self, plan):
        return Pushes(self, self.inner.start_layered(plan))

    def __getattr__(self, name):  # .world / .per_layer / ...
        return getattr(self.inner, name)


class Pushes:
    def __init__(self, switch, pending):
        self.switch = switch
        self.pending = pending

    def push(self, idx, leaves):
        self.switch.tick()
        self.pending.push(idx, leaves)

    def __getattr__(self, name):  # .finish
        return getattr(self.pending, name)


ck = os.path.join(ckdir, f"rank{rank}")
params = None
if init:
    with np.load(init) as z:
        params = {k: torch.from_numpy(z[k].copy()) for k in z.files}
shape = parse_mesh(mesh) if mesh else None
positions = shape["dp"] * shape["tp"] if shape else 1
tr = Trainer("llama-tiny", shape, devices=["cpu"] * positions,
             device="cpu", seed=5, params=params,
             cross_slice_sync=KillSwitch(sync, die_at),
             elastic=ElasticPolicy(ck, save_every=1, max_resumes=6,
                                   rebuild=dict(max_attempts=20,
                                                backoff_s=0.2,
                                                backoff_cap_s=2.0,
                                                timeout_ms=20000)))
start = 0
if os.path.exists(checkpoint_file(ck)):
    start = restore_checkpoint(ck, tr)
    print("RESTORED", rank, start, flush=True)

rng = np.random.default_rng(17)
batches = [rng.integers(0, 255, (world_sz, 2, 17)) for _ in range(steps)]
for i in range(start, steps):
    loss = tr.step(torch.from_numpy(batches[i][rank]))
    print(json.dumps({"step": i + 1, "loss": loss}), flush=True)

save_checkpoint(os.path.join(ckdir, f"final{rank}"), tr, steps)
print("DONE", rank, "resume=%d" % trace.counter("trainer.resume"),
      "rebuild=%d" % trace.counter("world.rebuild"),
      "restore=%d" % trace.counter("ckpt.restore"), flush=True)
sync.close()
world.close()
"""


def _spawn(rank, base, ckdir, die_at, world=2, ctl="", mode="fused",
           init="", mesh=""):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    # Dead-peer detection rides the TCP close (fast); the deadline is
    # only the wedge backstop and stays inside the harness timeout.
    env["TDR_RING_TIMEOUT_MS"] = "30000"
    return subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(rank), str(base),
         str(STEPS), ckdir, str(die_at), str(world), ctl, mode, init,
         mesh],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=240):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"rank timed out\nstdout:\n{out}\n"
                             f"stderr:\n{err[-3000:]}")
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\nstdout:\n{out}\nstderr:\n{err[-3000:]}")
    return out


def _run(ckdir, world, die, ctl="", mode="fused", init="", die_at=2,
         mesh=""):
    """One job: ranks in ``die`` kill themselves at their ``die_at``-th
    kill-switch tick and are restarted once they have died."""
    os.makedirs(ckdir)
    base = 0 if ctl else port_band(2 * world)
    procs = {r: _spawn(r, base, ckdir, die_at if r in die else 0, world,
                       ctl, mode, init, mesh) for r in range(world)}
    try:
        for r in die:
            procs[r].wait(timeout=240)
            assert procs[r].returncode == -signal.SIGKILL, \
                (procs[r].returncode, procs[r].stderr.read()[-3000:])
            procs[r] = _spawn(r, base, ckdir, 0, world, ctl, mode, init,
                              mesh)
        return {r: _finish(procs[r]) for r in range(world)}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _final_params(ckdir, rank):
    with np.load(os.path.join(ckdir, f"final{rank}.npz")) as z:
        return {k: z[k].copy() for k in z.files
                if k.startswith(("params/", "__dtype__/params/"))}


def _losses(out):
    import json

    return [json.loads(ln)["loss"] for ln in out.splitlines()
            if ln.startswith("{")]


def _assert_recovered(outs, clean_dir, faulty_dir, world, restarted,
                      survivor=0):
    for r in restarted:
        assert f"RESTORED {r}" in outs[r], outs[r]
    done = [ln for ln in outs[survivor].splitlines()
            if ln.startswith(f"DONE {survivor}")]
    assert done, outs[survivor]
    for counter in ("resume", "rebuild", "restore"):
        assert f"{counter}=0" not in done[0], done[0]
    clean = _final_params(clean_dir, 0)
    faulty = _final_params(faulty_dir, 0)
    assert set(clean) == set(faulty)
    for key in clean:
        assert clean[key].tobytes() == faulty[key].tobytes(), key
    for r in range(1, world):
        other = _final_params(faulty_dir, r)
        for key in faulty:
            assert faulty[key].tobytes() == other[key].tobytes(), (r, key)


def _jax_world2_run(jts, batches):
    """The JAX ``Trainer``s of a world-2 run over the JAX package's own
    ring, stepped on ``batches``; each step's losses."""
    worlds = [t.cross_slice_sync.world for t in jts]
    losses = np.zeros((len(batches), 2))
    for s, batch in enumerate(batches):
        run_ranks(worlds, lambda w, r: losses.__setitem__(
            (s, r), jts[r].step(jnp.asarray(batch[r].astype(np.int32)))))
    return losses


def test_sigkill_restart_resumes_bitwise_equal(tmp_path):
    """World 2, legacy rendezvous, rank 1 killed inside step 2's sync;
    the uninterrupted run is also the JAX world-2 run's counterpart."""
    base = port_band(8)
    jw = jax_worlds(2, base)
    jts = [JaxTrainer("llama-tiny", {"dp": 1, "tp": 1}, seed=SEED,
                      cross_slice_sync=JaxShim(jw[r], mean=True))
           for r in range(2)]
    state0 = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jts[0].params))
    init = str(tmp_path / "init.npz")
    np.savez(init, **{k: v.numpy() for k, v in state0.items()})

    clean = _run(str(tmp_path / "clean"), 2, (), init=init)
    faulty = _run(str(tmp_path / "faulty"), 2, (1,), init=init)
    _assert_recovered(faulty, str(tmp_path / "clean"),
                      str(tmp_path / "faulty"), 2, (1,))

    rng = np.random.default_rng(17)
    batches = [rng.integers(0, 255, (2, 2, 17)) for _ in range(STEPS)]
    jl = _jax_world2_run(jts, batches)
    tl = np.array([_losses(clean[r]) for r in range(2)]).T
    assert np.abs(tl - jl).max() <= LOSS_TOL, (tl, jl)
    want = tllama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jts[0].params))
    got = _final_params(str(tmp_path / "clean"), 0)
    far, total = 0, 0
    for name, w in want.items():
        path = "params/params/" + "/".join(tllama._flax_path(name))
        diff = np.abs(got[path] - w.numpy())
        assert float(diff.max()) <= 2 * STEPS * LR + 1e-6, name
        far += int((diff > 1e-5).sum())
        total += diff.size
    assert far <= total // 1000, (far, total)
    for t in jts:
        t.cross_slice_sync.close()
    for w in jw:
        w.close()


def _coordinator():
    return Coordinator(port=0, lease_ms=8000,
                       port_base=port_band(64)).start()


def test_world4_two_simultaneous_kills_rejoin_bitwise(tmp_path):
    """World 4 under the port's coordinator, ranks 1 and 3 killed in
    step 2's sync and restarted: the coordinator re-admits them under a
    bumped generation and the run ends bitwise equal to the
    uninterrupted world-4 run."""
    coord = _coordinator()
    try:
        _run(str(tmp_path / "clean"), 4, (), ctl=coord.address)
        outs = _run(str(tmp_path / "faulty"), 4, (1, 3), ctl=coord.address)
    finally:
        coord.stop()
    _assert_recovered(outs, str(tmp_path / "clean"),
                      str(tmp_path / "faulty"), 4, (1, 3))


def test_per_layer_resume_bitwise_equal(tmp_path):
    """World 2 with the per-layer sync: rank 1 dies at its 6th bucket
    push (the first of step 2, inside the backward, before it posted any
    of step 2's buckets). Rank 0's per-layer sync fails retryable, its
    resume rebuilds, and the run ends bitwise equal to the uninterrupted
    per-layer run. (A rank that dies while its peer reads one of its
    posted buckets across processes (the emu engine's CMA tier) fails
    that read as a local access error, which both packages classify as
    fatal: ROADMAP Queue 3.)"""
    _run(str(tmp_path / "clean"), 2, (), mode="layered")
    outs = _run(str(tmp_path / "faulty"), 2, (1,), mode="layered",
                die_at=6)
    _assert_recovered(outs, str(tmp_path / "clean"),
                      str(tmp_path / "faulty"), 2, (1,))


def test_world4_shrink_to_3_resize_bitwise_parity():
    """A resizable world of 4 loses rank 3 to a clean leave; the
    survivors' next collective fails retryable, ``rebuild()`` re-
    arbitrates the same incarnations as a world of 3, and the allreduce
    after the shrink is bitwise exact at the new size."""
    coord = Coordinator(port=0, lease_ms=2000,
                        port_base=port_band(64)).start()
    engines = [Engine("emu") for _ in range(4)]
    worlds = [None] * 4
    try:
        def boot(w, r):
            worlds[r] = RingWorld(engines[r], r, 4, None,
                                  controller=coord.address,
                                  world_name="shrink", timeout_ms=20000,
                                  resizable=True)

        run_ranks([None] * 4, boot)
        r1 = [None] * 4

        def ar4(w, r):
            buf = torch.full((512,), 3 * (r + 1), dtype=torch.int32)
            worlds[r].allreduce(buf)
            r1[r] = buf

        run_ranks(worlds, ar4)
        for r in range(4):
            assert torch.equal(r1[r], torch.full((512,), 30,
                                                 dtype=torch.int32)), r

        worlds[3].close()
        worlds[3] = None
        # The next heartbeat carries the resize hint to every survivor.
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if all(worlds[r]._resize_pending for r in range(3)):
                break
            time.sleep(0.05)
        assert all(worlds[r]._resize_pending for r in range(3))

        r2 = [None] * 3

        def recover(w, r):
            for _ in range(8):
                buf = torch.full((512,), 7 * (w.rank + 1),
                                 dtype=torch.int32)
                try:
                    w.allreduce(buf)
                    r2[r] = buf
                    return
                except TransportError as e:
                    if not e.retryable:
                        raise
                    w.rebuild(max_attempts=10, backoff_s=0.2,
                              timeout_ms=10000,
                              reason="rank 3 left (shrink)")
            raise AssertionError("no successful post-shrink round")

        run_ranks(worlds[:3], recover)
        for r in range(3):
            w = worlds[r]
            assert w.world == 3 and w.rank == r, (r, w.world, w.rank)
            assert w._ctl_resizes == 1
            assert ":r1" in w.control_stamp, w.control_stamp
            assert torch.equal(r2[r], torch.full((512,), 42,
                                                 dtype=torch.int32)), r
    finally:
        for w in worlds:
            if w is not None:
                w.close()
        coord.stop()
        for eng in engines:
            eng.close()


class _NaNOnceSync:
    """cross_slice_sync stand-in: poisons the gradients with NaN on
    selected calls — the "verified but non-finite" condition the
    quarantine rung exists for."""

    def __init__(self, poison_calls):
        self.calls = 0
        self.poison_calls = set(poison_calls)

    def __call__(self, grads):
        self.calls += 1
        if self.calls in self.poison_calls:
            leaf = grads["params"]["embed"]["embedding"].clone()
            leaf.view(-1)[0] = float("nan")
            grads["params"]["embed"]["embedding"] = leaf
        return grads


def _batch():
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (2, 17)))


def test_trainer_quarantines_nonfinite_grads_once(tmp_path):
    """A step whose synced gradients come back non-finite is retried
    once from the pre-step state; the retry (clean sync) succeeds and
    the run equals a never-poisoned run bitwise."""

    def run(poison):
        trace.reset()
        tr = Trainer("llama-tiny", device="cpu", seed=11,
                     learning_rate=1e-2, cross_slice_sync=_NaNOnceSync(poison),
                     elastic=ElasticPolicy(str(tmp_path / "ck"),
                                           save_every=1))
        tr.step(_batch())
        return tr.model.state_dict(), trace.counter("trainer.quarantine")

    clean, q0 = run(poison=())
    healed, q1 = run(poison={1})  # first sync poisoned, retry clean
    assert q0 == 0 and q1 == 1
    assert list(clean) == list(healed)
    for name, t in clean.items():
        assert torch.equal(t, healed[name]), name
        assert t.isfinite().all(), name


def test_trainer_escalates_when_quarantine_retry_also_nonfinite(tmp_path):
    """Persistently non-finite gradients exhaust the quarantine, then
    the resume budget, and surface as a retryable TransportError."""
    trace.reset()
    tr = Trainer("llama-tiny", device="cpu", seed=11, learning_rate=1e-2,
                 cross_slice_sync=_NaNOnceSync(range(1, 100)),
                 elastic=ElasticPolicy(str(tmp_path / "ck"), save_every=1,
                                       max_resumes=1))
    with pytest.raises(TransportError) as ei:
        tr.step(_batch())
    assert ei.value.retryable
    assert "non-finite" in str(ei.value)
    assert trace.counter("trainer.quarantine") >= 1
    assert trace.counter("trainer.resume") == 1
    assert tr.global_step == 0

