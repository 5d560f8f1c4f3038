#!/usr/bin/env python3
"""Fault-plan soak runner for the PyTorch port: elastic training under
injected faults. The port's counterpart of ``tools/fault_soak.py``.

    python3 tools/torch_fault_soak.py            # the trainers on the card
    python3 tools/torch_fault_soak.py --cpu      # plain kernels on the CPU

Runs the same N-step, world-N in-process DP training twice — once
clean, once under chaos — with the trainer's elastic policy armed, and
asserts the final parameters of the chaotic run are BITWISE identical
to the clean run's. That is the whole detect→recover contract in one
predicate: every injected fault fired (hit counters say so), the ranks
rebuilt the world under a new generation, restored their checkpoints,
re-ran the failed step, and the trajectory converged to exactly what
an uninterrupted run produces.

Each rank is a thread with its own ``Engine("emu")``, a
``RingWorld(..., world_name="train")``, a fused
``CrossSliceAllReduce(mean=True)`` and a
``Trainer(elastic=ElasticPolicy(save_every=1))``. The fused sync runs
after ``backward()`` has returned, so thread ranks may share one card:
no rank ever blocks inside autograd's device thread.

Chaos riders beyond the classic ``TDR_FAULT_PLAN``:

- ``--coordinator``: run an in-process rendezvous coordinator and
  arbitrate every rebuild through it (``rocnrdma_tpu_torch.control``) —
  no rank-local generation guesses; every bump is a coordinator
  decision observable as ``ctl.*`` events.
- ``--flap R@N``: a flapping rank — rank R tears its transport down on
  its Nth gradient sync (connections die mid-step on every peer, the
  in-process stand-in for a SIGKILL) and rejoins through the elastic
  ladder; the multi-process SIGKILL variant lives in
  tests/test_torch_elastic.py.
- ``--concurrent``: a second named world ("side") SHARING the training
  ranks' engines runs integer allreduces the whole time, each checked
  bitwise — multi-tenant engines under chaos.

CLI: ``python3 tools/torch_fault_soak.py [--steps N] [--seed S] [--plan
SPEC] [--world W] [--coordinator] [--flap R@N] [--concurrent]
[--topology KEYS] [--netem RIDERS] [--perfetto PATH] [--cpu]`` prints
the reference's JSON verdict line (``parity``, ``fault_hits``,
``resumes``, ``rebuilds``, ``integrity_failed``, ``retransmits``,
``ctl``, ``generations``, ``flapped``, ``side_ok``,
``hier_collectives``, ``topology``) and exits 0 when ``parity`` holds.
Without ``--cpu`` it runs on the card and raises where there is none.
The test suite wires short seeded configurations in
(tests/test_torch_fault_soak.py).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import sys
import tempfile
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def hb_thread_census() -> int:
    """Count live coordinator heartbeat threads (tdr-ctl-hb-*). The
    leak gate for the elastic soaks: every closed, departed, or
    resized-out world must have stopped renewing its lease — a thread
    still beating under a superseded identity is the
    heartbeat-after-leave bug."""
    return sum(1 for t in threading.enumerate()
               if t.name.startswith("tdr-ctl-hb-") and t.is_alive())


def make_fault_plan(seed: int, steps: int, world: int = 2) -> str:
    """A seeded-random transient collective fault somewhere in the run,
    plus a seeded payload corruption on the sealed zero-copy path: the
    reference's plan, the same string for the same arguments.

    ``ring:nth`` counts tdr_ring_allreduce calls process-wide, so the
    same seed always faults the same call ordinal; which rank's thread
    lands on it may vary, but the parity predicate is rank-independent.
    The ``send:...:corrupt=`` rider flips bytes on one sealed frame's
    WIRE copy: the seal detects it at land time and the chunk
    retransmits from the intact source."""
    rng = random.Random(seed)
    nth = rng.randrange(1, max(2, steps * world))
    plan = f"ring:nth={nth}:once=general_err"
    cnth = rng.randrange(1, max(2, steps * world))
    plan += f",send:nth={cnth}:corrupt={rng.randrange(1, 5)}"
    return plan


class FlapRider:
    """Tear this rank's transport down on its Nth gradient sync — a
    rank "flaps" mid-step, deterministically, without leaving the
    process: the torn QPs surface as connection drops on every peer,
    the local collective raises a retryable torn-down error, and the
    whole world walks the elastic ladder (report → arbitrated rejoin
    when a coordinator is armed)."""

    def __init__(self, inner, world, at: int):
        self.inner = inner
        self.flap_world = world
        self.at = at
        self.n = 0
        self.fired = False

    def __call__(self, tree):
        self.n += 1
        if not self.fired and self.at > 0 and self.n == self.at:
            self.fired = True
            self.flap_world._teardown()
        return self.inner(tree)

    def __getattr__(self, name):
        # The trainer reads .world, .per_layer, .overlap,
        # .set_step_token and .reset_transport_cache off its sync.
        return getattr(self.inner, name)


def _run_side_world(engines, world, steps, seed, base_port, controller,
                    errs):
    """The concurrent-tenant workload: a second named world over the
    SAME engines as the training world, doing int32 allreduces (sum is
    associative, so the expected result is exact) checked bitwise on
    every iteration.

    The side world carries NO elastic machinery, deliberately — it
    proves that a co-tenant world stays correct while the training
    world flaps and rebuilds around it. Injected faults at process-wide
    sites (``ring:``, ``conn:``) can land on it and kill the soak, so
    ``--concurrent`` restricts the plan to self-healing riders plus the
    flap, which targets the training world alone.

    Returns ``(threads, finish)``: call ``finish()`` after joining the
    threads — ranks that SUCCEEDED keep their world open until every
    side rank is done, while failed ranks close immediately inside the
    thread to unblock their peers."""
    import numpy as np

    from rocnrdma_tpu_torch.collectives.world import RingWorld

    iters = max(2, steps * 2)
    rng = np.random.default_rng(900 + seed)
    data = rng.integers(-1000, 1000,
                        (iters, world, 4096)).astype(np.int32)
    expected = data.sum(axis=1, dtype=np.int64).astype(np.int32)
    worlds = [None] * world

    def side_rank(r):
        try:
            # topology="flat": a --topology soak must not have the side
            # world carve tier port arenas overlapping the training
            # world's.
            w = RingWorld(engines[r], r, world, base_port,
                          timeout_ms=20000, channels=1,
                          controller=controller, world_name="side",
                          topology="flat")
            worlds[r] = w
            for i in range(iters):
                buf = data[i, r].copy()
                w.allreduce(buf)
                if buf.tobytes() != expected[i].tobytes():
                    raise AssertionError(
                        f"side world diverged at iter {i} rank {r}")
        except BaseException as e:  # surfaced after join
            errs[r] = e
            if worlds[r] is not None:
                try:
                    worlds[r].close()
                except Exception:
                    pass
                worlds[r] = None

    def finish():
        for w in worlds:
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass

    threads = [threading.Thread(target=side_rank, args=(r,),
                                name=f"side-{r}") for r in range(world)]
    for t in threads:
        t.start()
    return threads, finish


def run_soak(steps: int = 4, seed: int = 0, base_port=None, ckpt_dir=None,
             fault_plan=None, config="llama-tiny", world: int = 2,
             coordinator=None, flap=None, concurrent: bool = False,
             channels=None, topology=None, device="cuda", params=None):
    """Train ``steps`` steps of world-N DP (in-process ring) with the
    elastic policy armed, optionally under ``fault_plan`` and the chaos
    riders. Returns ``(params, stats)``: rank 0's final parameters as
    CPU tensors by state-dict name (all ranks are asserted bitwise
    identical first) and the observability counters (fault hits,
    resumes, rebuilds, ctl.* arbitration activity, final generation).

    ``config``: a config name or a ``LlamaConfig``; ``device``: where
    every rank trains (``"cuda"`` by default; raises without a card);
    ``params``: the starting weights (a state dict), else the trainer's
    ``init_params(seed=11)``. ``base_port``: the training world's ports,
    or with a coordinator the coordinator's ``port_base``.
    ``coordinator``: None (legacy pairwise path), True (spawn an
    in-process Coordinator), or a "host:port" address. ``flap``: a
    (rank, nth_sync) tuple arming a FlapRider. ``concurrent``: run the
    "side" world over the same engines for the whole soak.
    ``topology``: a host-key string ("a,a,b,b") arming the
    HIERARCHICAL schedule for every gradient sync (TDR_TOPOLOGY +
    TDR_ALGO=hier for the run) — pair it with ``flap`` on a delegate
    rank to prove the per-tier elastic ladder."""
    import numpy as np

    from rocnrdma_tpu_torch import resolve_device
    from rocnrdma_tpu_torch.collectives.torch_shim import \
        CrossSliceAllReduce
    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.parallel.trainer import ElasticPolicy, Trainer
    from rocnrdma_tpu_torch.transport.engine import (Engine,
                                                     fault_plan_clauses,
                                                     fault_plan_hits,
                                                     fault_plan_reset,
                                                     seal_counters)
    from rocnrdma_tpu_torch.utils.trace import trace

    device = resolve_device(device)
    if base_port is None:
        base_port = free_port()
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="tdr_soak_")
    os.makedirs(ckpt_dir, exist_ok=True)
    data_rng = np.random.default_rng(seed)
    batches = [data_rng.integers(0, 255, (world, 2, 17)).astype(np.int32)
               for _ in range(steps)]

    coord = None
    ctl_address = None
    if coordinator is True:
        from rocnrdma_tpu_torch.control.coordinator import Coordinator

        coord = Coordinator(port=0, lease_ms=3000,
                            port_base=base_port).start()
        ctl_address = coord.address
    elif coordinator:
        ctl_address = str(coordinator)

    prev_plan = os.environ.get("TDR_FAULT_PLAN")
    if fault_plan is not None:
        os.environ["TDR_FAULT_PLAN"] = fault_plan
    else:
        os.environ.pop("TDR_FAULT_PLAN", None)
    prev_topo = {k: os.environ.get(k)
                 for k in ("TDR_TOPOLOGY", "TDR_ALGO")}
    if topology:
        os.environ["TDR_TOPOLOGY"] = str(topology)
        # Force the two-tier schedule regardless of gradient size —
        # the soak's buffers are far below the auto threshold.
        os.environ["TDR_ALGO"] = "hier"
    fault_plan_reset()
    resumes0 = trace.counter("trainer.resume")
    rebuilds0 = trace.counter("world.rebuild")
    hier0 = trace.counter("algo.hier")
    ctl0 = trace.counters_prefixed("ctl.")
    seal0 = seal_counters()

    engines = [Engine("emu") for _ in range(world)]
    results = [None] * world
    finals = [None] * world  # final (generation, epoch) per rank
    errs = [None] * world
    side_errs = [None] * world
    side_threads = []
    side_finish = None

    def run_rank(r: int):
        w = sync = None
        try:
            w = RingWorld(engines[r], r, world,
                          None if ctl_address else base_port,
                          timeout_ms=20000, channels=channels,
                          controller=ctl_address, world_name="train")
            sync = CrossSliceAllReduce(w, mean=True)
            hooked = sync
            if flap is not None and flap[0] == r:
                hooked = FlapRider(sync, w, flap[1])
            tr = Trainer(config, {"dp": 1, "tp": 1}, seed=11,
                         learning_rate=1e-2, cross_slice_sync=hooked,
                         elastic=ElasticPolicy(
                             os.path.join(ckpt_dir, f"rank{r}"),
                             save_every=1, max_resumes=4,
                             rebuild=dict(max_attempts=10, backoff_s=0.05,
                                          backoff_cap_s=1.0,
                                          timeout_ms=10000)),
                         device=device, params=params)
            for i in range(steps):
                tr.step(batches[i][r])
            results[r] = {name: t.detach().cpu()
                          for name, t in tr.state_dict().items()}
            finals[r] = (w.generation, getattr(w, "_ctl_epoch", 0))
        except BaseException as e:  # surfaced after join
            errs[r] = e
        finally:
            # Close promptly either way so a failed rank never leaves
            # its peer riding out the stall deadline.
            closers = []
            if sync is not None:
                closers.append(sync.close)
            if w is not None:
                closers.append(w.close)
            for closer in closers:
                try:
                    closer()
                except Exception:
                    pass

    threads = [threading.Thread(target=run_rank, args=(r,))
               for r in range(world)]
    try:
        if concurrent:
            # Side-world port arena BEYOND the training world's tier
            # arenas (a hierarchical world carves base + world*(1+g)
            # and base + world*(1+hosts) + l*hosts for its tier
            # rings; world*(2 + world//2) upper-bounds that span).
            side_threads, side_finish = _run_side_world(
                engines, world, steps, seed,
                None if ctl_address
                else base_port + world * (2 + world // 2) + 8,
                ctl_address, side_errs)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for t in side_threads:
            t.join(timeout=300)
    finally:
        if side_finish is not None:
            side_finish()
        hits = sum(fault_plan_hits(i)
                   for i in range(fault_plan_clauses()))
        if prev_plan is None:
            os.environ.pop("TDR_FAULT_PLAN", None)
        else:
            os.environ["TDR_FAULT_PLAN"] = prev_plan
        for k, v in prev_topo.items():
            if topology:
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        fault_plan_reset()
        for eng in engines:
            try:
                eng.close()
            except Exception:
                pass
        if coord is not None:
            coord.stop()
    for e in errs + side_errs:
        if e is not None:
            raise e

    for r in range(1, world):
        if not params_equal(results[0], results[r]):
            raise AssertionError(
                f"ranks 0 and {r} diverged: DP lockstep broken")
    gens = sorted(set(f[0] for f in finals if f is not None))
    ctl1 = trace.counters_prefixed("ctl.")
    seal1 = seal_counters()
    stats = {
        "fault_hits": int(hits),
        "resumes": trace.counter("trainer.resume") - resumes0,
        "rebuilds": trace.counter("world.rebuild") - rebuilds0,
        # Integrity ladder activity during the run: detected
        # corruptions and the retransmissions that healed them.
        "integrity_failed": seal1["failed"] - seal0["failed"],
        "retransmits": seal1["retransmitted"] - seal0["retransmitted"],
        # Arbitration activity (coordinator runs only): every
        # generation decision observable as ctl.* counters.
        "ctl": {k: v - ctl0.get(k, 0) for k, v in ctl1.items()
                if v - ctl0.get(k, 0) > 0},
        "generations": gens,
        "flapped": bool(flap),
        "side_ok": concurrent and all(e is None for e in side_errs),
        # Hierarchical collectives actually ran (a --topology soak
        # whose syncs silently fell back to flat would prove nothing).
        "hier_collectives": trace.counter("algo.hier") - hier0,
        "topology": topology or None,
    }
    return results[0], stats


def params_equal(a, b) -> bool:
    """Two state dicts hold the same names, dtypes, shapes and bytes."""
    import torch

    def raw(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and torch.equal(raw(a[k]), raw(b[k])) for k in a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--plan", default=None,
                    help="explicit TDR_FAULT_PLAN (default: seeded random)")
    ap.add_argument("--coordinator", action="store_true",
                    help="arbitrate rebuilds through an in-process "
                         "rendezvous coordinator")
    ap.add_argument("--flap", default=None, metavar="R@N",
                    help="rank R tears its transport down on its Nth "
                         "gradient sync and rejoins")
    ap.add_argument("--concurrent", action="store_true",
                    help="run a second named world over the same "
                         "engines for the whole soak")
    ap.add_argument("--topology", default=None, metavar="KEYS",
                    help="host-key list ('a,a,b,b', one key per rank): "
                         "run every gradient sync on the HIERARCHICAL "
                         "schedule; both the clean and the faulty run "
                         "use it")
    ap.add_argument("--netem", default=None, metavar="RIDERS",
                    help="comma list of netem riders (delay=<us>[:jit], "
                         "reorder=N, dup=N, throttle=<MBps>) applied at "
                         "every send site for the faulty run; given "
                         "alone, it REPLACES the seeded plan")
    ap.add_argument("--perfetto", default=None, metavar="PATH",
                    help="write a merged Perfetto trace of the faulty "
                         "run (ctl.* arbitration events included)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (the kernels' plain versions) "
                         "instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    flap = None
    if args.flap:
        r, _, n = args.flap.partition("@")
        flap = (int(r), int(n or 2))

    if args.plan is not None:
        plan = args.plan
    elif args.netem:
        # Pure netem soak: the riders are self-healing by design, so
        # the interesting predicate is parity WITHOUT rebuilds.
        plan = ""
    elif args.concurrent:
        # Self-healing corrupt riders only: a process-wide ring/conn
        # fault could land on the deliberately elastic-free side world
        # (see _run_side_world).
        rng = random.Random(args.seed)
        plan = ",".join(
            f"send:nth={rng.randrange(1, max(2, args.steps * args.world * k))}"
            f":corrupt={rng.randrange(1, 5)}" for k in (1, 4))
    else:
        plan = make_fault_plan(args.seed, args.steps, args.world)
    if args.netem:
        riders = [r.strip() for r in args.netem.split(",") if r.strip()]
        netem = ",".join(f"send:{r}" for r in riders)
        plan = f"{plan},{netem}" if plan else netem
    if args.topology:
        keys = [k for k in args.topology.split(",") if k]
        if len(keys) != args.world:
            ap.error(f"--topology needs {args.world} comma-separated "
                     f"keys, got {len(keys)}")
    with tempfile.TemporaryDirectory(prefix="tdr_soak_") as d:
        clean, _ = run_soak(args.steps, args.seed, world=args.world,
                            ckpt_dir=os.path.join(d, "clean"),
                            topology=args.topology, device=device)
        faulty, stats = run_soak(args.steps, args.seed, world=args.world,
                                 ckpt_dir=os.path.join(d, "faulty"),
                                 fault_plan=plan or None,
                                 coordinator=args.coordinator,
                                 flap=flap, concurrent=args.concurrent,
                                 topology=args.topology, device=device)
    if args.perfetto:
        from rocnrdma_tpu_torch.telemetry.perfetto import export_trace

        export_trace(args.perfetto)
    ok = params_equal(clean, faulty)
    out = {"steps": args.steps, "seed": args.seed, "world": args.world,
           "plan": plan, "parity": ok, **stats}
    print(json.dumps(out))
    if plan and stats["fault_hits"] == 0:
        print("WARNING: fault plan never fired (plan points past the "
              "run?) — parity is vacuous", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
