"""Ring-world bootstrap: N ranks connected in a ring over the engine —
the port's own copy of ``rocnrdma_tpu/collectives/world.py``, whose
buffers may be numpy arrays or CPU torch tensors.

The reference delegated rendezvous entirely to its consumers (perftest
and MPI bring their own TCP bootstrap); here it is part of the
framework. Each rank accepts a connection from its left neighbor on
``base_port + rank`` and dials its right neighbor at
``base_port + (rank+1) % world`` — a deadlock-free scheme because
connects retry until the listener is up (tcp_connect_retry) and the
accept itself is deadline-bounded (no thread is ever stranded holding
the port).

Works identically for in-process multi-rank tests (one Engine per rank,
threads), multi-process single-host, and multi-host (pass ``peers``).

**Elasticity.** A world is an *incarnation* of the ring, identified by
a monotonic ``generation`` number agreed at bootstrap (every rank
proposes its own; the ring maximum wins, so a freshly-restarted rank
adopts the survivors' count). ``rebuild()`` tears the incarnation down
— leaving the Engine reusable — bumps the generation, and
re-rendezvouses with exponential backoff + jitter under a bounded
retry budget. The generation is stamped into every schedule-digest
exchange, so traffic from a previous incarnation (a rank that missed
the rebuild) is FENCED: it fails the digest comparison with an
explicit stale-generation error instead of desynchronizing — let alone
corrupting — the new ring.

**Black-box postmortem.** With ``TDR_POSTMORTEM_DIR`` set, every
``rebuild()`` first dumps this rank's flight-recorder ring, counters,
the error that forced it and the schedule digest (format
``tdr-postmortem-v1``, the JAX package's), which ``python3 -m
rocnrdma_tpu_torch.tools.explain --postmortem`` merges.

**Arbitrated rendezvous.** Pass ``controller=`` (a coordinator
address or ``ControlClient``) and a ``world_name`` and the per-rank
guesswork above is replaced by a single owner of lifecycle state
(``rocnrdma_tpu_torch.control``): the coordinator names the world, hands
out the base port and generation, holds member leases renewed by a
background heartbeat, and arbitrates elastic rejoin — every surviving
or rejoining rank parks at the coordinator's rendezvous barrier and
receives the SAME membership view (generation + epoch), so no rank
ever guesses the next generation locally. The legacy pairwise path
(no coordinator) is unchanged and test-pinned as the fallback.

**Multi-tenancy.** One Engine may host several concurrent named
worlds (``qp_budget`` bounds each world's QP appetite at bring-up;
``Engine.set_qp_limit`` caps the engine natively). Engines shared by
more than one world run with the engine-wide seal incarnation stamp
cleared — co-tenant worlds at different generations would fence each
other's frames — so stale-world protection there degrades to the
schedule-digest generation check, which is per world.

**Hierarchical topologies.** A world whose host-key topology map
(``topology=`` / TDR_TOPOLOGY / coordinator-view ``host_keys``)
partitions the ranks into >= 2 uniform intra-host groups can run its
allreduces on the two-tier schedule: intra-host reduce-scatter →
inter-host delegate-ring allreduce over the owned shard → intra-host
all-gather, chosen per call by a message-size-aware selector
(``TDR_ALGO``, ``TDR_HIER_MIN_BYTES``; collectives/topology.py). Tier
rings are ordinary RingWorlds built lazily per incarnation — the
inter-host ring pinned to the stream tier so it keeps full payload
seals — and they die and rebuild with the parent's generation, so the
elastic ladder holds per tier. See README "Hierarchical collectives".
"""

from __future__ import annotations

import json
import os
import random
import struct
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from rocnrdma_tpu_torch.collectives import health as _health
from rocnrdma_tpu_torch.collectives.topology import (TopologyMap, algo_stamp,
                                                     choose_algo,
                                                     fallback_reason,
                                                     resolve_topology)
from rocnrdma_tpu_torch.transport.engine import (Engine, QueuePair, Ring,
                                                 RED_SUM, RingOp,
                                                 TransportError,
                                                 note_fault_injections,
                                                 note_integrity,
                                                 ring_channels_default,
                                                 seal_retry_budget)
from rocnrdma_tpu_torch.utils.trace import trace


def _np_view(array):
    """A numpy view of a ring buffer for the host-side math of the
    degradation ladder's wire rungs: numpy arrays as they are, CPU
    tensors through ``.numpy()`` (shared memory). bf16 tensors stay
    tensors — the rungs act on f32 payloads only."""
    if isinstance(array, np.ndarray) or str(array.dtype) == "torch.bfloat16":
        return array
    return array.numpy()


class CollectiveHandle:
    """Handle for a nonblocking collective started with
    :meth:`RingWorld.allreduce_async`.

    ``wait()`` blocks until the wire work completes and raises the
    taxonomy-classified :class:`TransportError` on failure — the same
    error surface the blocking collectives have, so the elastic
    TransportError → ``rebuild()`` ladder applies to async failures
    unchanged. ``test()`` polls without blocking. The handle holds the
    data buffer alive until completion; completion accounting feeds
    ``RingWorld.pending_async`` (the handle-leak census)."""

    def __init__(self, world: "RingWorld", op: RingOp, nbytes: int,
                 what: str = "allreduce", coll: int = 0):
        self._world = world
        self._op = op
        self._nbytes = nbytes
        self._what = what
        # Collective trace id (the fleet-timeline join key); exposed
        # so span emitters (jax_shim buckets) can label their bars.
        self.coll = int(coll)
        self._t0 = time.monotonic()
        self._settled = False

    @property
    def done(self) -> bool:
        return self._op.done

    def _settle(self) -> None:
        if not self._settled:
            self._settled = True
            self._world._async_live -= 1

    def test(self) -> bool:
        """True once the collective completed OK; raises on failure."""
        if self._settled:
            return True
        try:
            ok = self._op.test()
        except TransportError:
            self._settle()
            raise
        if ok:
            self._settle()
            trace.event(f"world.{self._what}_done",
                        rank=self._world.rank, bytes=self._nbytes,
                        coll=self.coll,
                        dur_s=time.monotonic() - self._t0)
        return ok

    def wait(self, timeout_ms: int = -1) -> None:
        """Block until completion; raises the handle's TransportError
        on failure. A positive expired timeout raises retryable and
        leaves the handle live (wait again)."""
        if self._settled:
            return
        try:
            self._op.wait(timeout_ms)
        except TransportError as e:
            if "still in flight" in str(e):
                raise  # handle stays live; do not settle
            self._settle()
            raise
        self._settle()
        trace.event(f"world.{self._what}_done", rank=self._world.rank,
                    bytes=self._nbytes, coll=self.coll,
                    dur_s=time.monotonic() - self._t0)

class _PhasedHandle:
    """Handle for a chained multi-phase async collective — the
    hierarchical allreduce (intra reduce-scatter → delegate-ring
    allreduce → intra all-gather) or the staged two-phase flat
    composition (RS → AG). Same surface and failure semantics as
    :class:`CollectiveHandle`.

    **Ordering.** Phase 0 is submitted at creation, so creation order
    across handles IS phase-0 submission order. Later phases submit
    only after (a) the handle's own previous phase completed and (b)
    every EARLIER handle's chain fully submitted — enforced by driving
    the predecessor chain first — so each underlying ring sees phase
    submissions in creation order on every rank, whatever order the
    caller polls handles in. That per-ring determinism is the SPMD
    submission-order contract the native async driver requires.

    Failures are recorded and raised to THIS handle's waiter exactly
    once (driving a predecessor on behalf of a later handle never
    steals its error)."""

    def __init__(self, world: "RingWorld", array, op: int, hier: bool):
        self._world = world
        self._array = array
        self._op = op
        self._nbytes = int(array.nbytes)
        self._what = "hier_allreduce" if hier else "staged_allreduce"
        self._t0 = time.monotonic()
        self._settled = False
        self._err: Optional[TransportError] = None
        self._raised = False
        flat = array.reshape(-1)
        # One fleet-level collective id for the whole chain: each
        # phase's submission seeds its tier/world sequence with it, so
        # a merged trace shows one id across intra RS, delegate AR,
        # and intra AG (attributable per tier by lane).
        self.coll = world._next_coll()
        coll = self.coll

        def _seeded(w, fn):
            def run():
                w._seed_coll(coll)
                return fn()
            return run

        if hier:
            intra, inter = world._ensure_tiers()
            shard = flat[intra.owned_slice(flat)]
            self._pending = [
                _seeded(intra,
                        lambda: intra.reduce_scatter_async(flat, op)),
                _seeded(inter,
                        lambda: inter.allreduce_async(shard, op,
                                                      algo="flat")),
                _seeded(intra, lambda: intra.all_gather_async(flat)),
            ]
        else:
            self._pending = [
                _seeded(world,
                        lambda: world.reduce_scatter_async(flat, op)),
                _seeded(world, lambda: world.all_gather_async(flat)),
            ]
        # Phase 0 submits NOW — creation order is submission order.
        # Submission happens BEFORE this handle registers in the chain
        # tail / census: a phase-0 failure (ring torn down between
        # ops) must abort construction cleanly — the caller gets the
        # retryable TransportError from allreduce_async itself — and
        # must not leave a half-built handle linked as a later
        # handle's predecessor or counted as pending forever.
        self._cur = self._pending.pop(0)()
        self._prev = world._phased_tail
        if self._prev is not None and self._prev._settled:
            self._prev = None
        world._phased_tail = self
        world._async_live += 1
        trace.add("algo.hier" if hier else "algo.staged", 1)
        trace.event(f"world.{self._what}_async", rank=world.rank,
                    bytes=self._nbytes, coll=self.coll)

    @property
    def done(self) -> bool:
        return self._settled

    def _finish(self, err: Optional[TransportError]) -> None:
        self._err = err
        self._settled = True
        self._world._async_live -= 1
        if self._world._phased_tail is self:
            self._world._phased_tail = None
        self._prev = None
        self._array = None
        if err is None:
            trace.event(f"world.{self._what}_done",
                        rank=self._world.rank, bytes=self._nbytes,
                        dur_s=time.monotonic() - self._t0)

    def _drive(self, blocking: bool) -> bool:
        """Advance the chain; True when terminal (ok or failed).
        Never raises — errors are recorded for _raise_once, so a later
        handle driving this one as its predecessor cannot consume the
        error its own waiter must see."""
        if self._settled:
            return True
        if self._prev is not None:
            if not self._prev._drive(blocking):
                return False
            self._prev = None
        try:
            while True:
                if blocking:
                    self._cur.wait()
                elif not self._cur.test():
                    return False
                if not self._pending:
                    self._finish(None)
                    return True
                self._cur = self._pending.pop(0)()
        except TransportError as e:
            self._finish(e)
            return True

    def _raise_once(self) -> None:
        if self._err is not None and not self._raised:
            self._raised = True
            raise self._err

    def test(self) -> bool:
        """True once the whole chain completed OK; raises on failure
        (once). Advances this handle's phases — and any predecessor
        chain — nonblocking."""
        if not self._drive(blocking=False):
            return False
        self._raise_once()
        return True

    def wait(self, timeout_ms: int = -1) -> None:
        """Block until the chain completes; raises the first phase's
        TransportError on failure. Phase chains always run to a
        terminal state (each phase is bounded by the ring stall
        deadline); a positive ``timeout_ms`` is accepted for interface
        parity but the wait is to completion."""
        del timeout_ms
        self._drive(blocking=True)
        self._raise_once()


# wr_id tags for the schedule-digest exchange — distinct from the
# ring's kWrRecv/kWrSend tag space (0x5245/0x5345 << 48).
_WR_DIGEST_RECV = 0x4447 << 48
_WR_DIGEST_SEND = (0x4447 << 48) | 1

# Digest frame: 32 digest bytes + 8 generation bytes + 1 status/pad
# byte = 41, deliberately indivisible by every ring dtype size: if
# steady-state skew ever mismatches a digest frame against a posted
# reduce-recv, the fold VALIDATION rejects it — the frame can error a
# step but can never be silently summed into a live gradient buffer.
_DG_BYTES = 41
# Generation frame: 8 generation bytes + 1 pad = 9 (same property).
_GEN_BYTES = 9


def rebuild_jitter_seed() -> int:
    """Base seed for rebuild backoff jitter (TDR_REBUILD_SEED, default
    0). The jitter rng is seeded per (seed, rank, generation), so a
    soak failure replays exactly under the same TDR_FAULT_PLAN — the
    global random module never participates."""
    try:
        return int(os.environ.get("TDR_REBUILD_SEED", "0"))
    except ValueError:
        return 0


def auto_channel_cap(peers: Optional[Sequence[str]] = None,
                     rank: int = 0, rings: int = 1) -> int:
    """Per-host channel cap applied by ``RingWorld(channels="auto")``:
    the TDR_RING_CHANNELS default capped at usable-cores-per-local-rank.
    On an in-process or in-host world every channel is another pair of
    transport progress threads; past cores/ranks they only preempt each
    other, which is why blind channel counts sweep non-monotonically
    (the JAX package's CPU sweeps record it). Local ranks are counted as peers
    sharing this rank's host entry; an ABSENT peer list carries no
    locality information, so only the core count caps (RingWorld
    always passes its resolved peer list, where a defaulted world is
    all-loopback and every rank counts as local).

    ``rings`` divides the budget across CONCURRENTLY LIVE rings: a
    hierarchical world pipelines its intra-host and inter-host
    delegate rings, so each tier gets cores/(local*rings) — two rings
    each independently claiming the full core budget would double the
    progress-thread pressure the cap exists to avoid."""
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    if peers:
        me = peers[rank] if 0 <= rank < len(peers) else peers[0]
        local = max(1, sum(1 for p in peers if p == me))
    else:
        local = 1
    denom = local * max(1, int(rings))
    return max(1, min(ring_channels_default(), max(1, cores // denom)))


class RingWorld:
    def __init__(
        self,
        engine: Engine,
        rank: int,
        world: int,
        base_port: Optional[int] = None,
        peers: Optional[Sequence[str]] = None,
        bind_host: str = "0.0.0.0",
        timeout_ms: int = 30000,
        generation: int = 0,
        channels=None,  # int, None (env default), or "auto" (host cap)
        controller=None,
        world_name: str = "default",
        qp_budget: Optional[int] = None,
        topology=None,  # host-key list, None (env/view), or "flat"
        tier: str = "auto",  # "stream" pins connections off the CMA tier
        resizable: bool = False,  # opt into coordinator RESIZE
        max_size: int = 0,        # grow ceiling (0 = unbounded)
        weight: float = 1.0,      # fair-share weight for the QP pool
    ):
        if world < 2:
            raise ValueError("RingWorld needs world >= 2")
        if base_port is None and controller is None:
            raise ValueError("base_port is required without a "
                             "controller (arbitrated worlds get their "
                             "port range from the coordinator)")
        self.engine = engine
        self.rank = rank
        self.world = world
        self.base_port = base_port
        self.peers = list(peers) if peers else ["127.0.0.1"] * world
        self.bind_host = bind_host
        self.timeout_ms = timeout_ms
        # Channels per neighbor (TDR_RING_CHANNELS, default 4): the
        # striped schedules route chunk i over channel i % channels,
        # so consecutive chunks transfer/verify/fold on independent
        # progress engines. Channel c of my right neighbor link IS
        # channel c of that rank's left link — guaranteed by bringing
        # the connections up strictly in channel order below.
        # channels="auto" applies the per-host cores-vs-ranks cap
        # (auto_channel_cap) instead of blindly taking the env count;
        # the digest still carries the RESOLVED count, so ranks whose
        # auto answers diverge fail the first collective fast.
        self._channels_auto = channels == "auto"
        if isinstance(channels, str):
            if channels != "auto":
                raise ValueError(f"channels={channels!r}: expected an "
                                 "int or 'auto'")
            # self.peers, never the raw argument: a None peer list has
            # already defaulted to all-loopback above, which is the
            # all-ranks-local case the cap exists for.
            self.channels = auto_channel_cap(self.peers, rank)
        elif channels is not None:
            self.channels = int(channels)
        else:
            self.channels = ring_channels_default()
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        # Incarnation number of this ring; monotonic. Legacy path: the
        # bootstrap exchange adopts the ring maximum, so a restarted
        # rank (proposing its stale or zero count) catches up with the
        # survivors' rebuild() bumps. Arbitrated path: the COORDINATOR
        # owns this number — every bump is a membership or failure
        # decision it made, and ranks only ever adopt its view.
        self.generation = int(generation)
        # Arbitrated-rendezvous state (None controller = legacy path).
        if isinstance(controller, str):
            from rocnrdma_tpu_torch.control.client import ControlClient

            controller = ControlClient(controller)
        self.controller = controller
        self.world_name = str(world_name)
        self.qp_budget = None if qp_budget is None else int(qp_budget)
        self._ctl_inc: Optional[int] = None  # coordinator incarnation
        self._ctl_epoch = 0                  # membership view counter
        self._ctl_lease_ms = 5000
        self._hb = None                      # background lease renewal
        # ---- Elastic membership (world RESIZE) ----
        # resizable opts this world into coordinator-arbitrated
        # shrink-to-survivors / grow-on-join; the coordinator's resize
        # counter rides the view and (when nonzero) the schedule
        # digest, so ranks disagreeing on the membership SHAPE fail
        # the first collective fast. _resize_pending is raised by the
        # heartbeat's resize hint: the next collective fails RETRYABLE
        # so the elastic ladder re-rendezvouses at a collective
        # boundary, where the coordinator cuts the new-size view.
        self.resizable = bool(resizable)
        self.max_size = int(max_size)
        self.weight = float(weight)
        self._ctl_resizes = 0
        self._resize_pending = False
        # QP appetite this incarnation reserved at bring-up (flat ring
        # + hierarchical tier rings), heartbeat-pushed so the
        # coordinator serves tdr_ctl_qp_reserved{world=}.
        self._qp_reserved = 0
        # Warn-once latch for the hier->flat topology fallback.
        self._fallback_warned = False
        # Per-channel neighbor QPs; left_qp/right_qp alias channel 0
        # (the digest exchange and capability probes ride channel 0).
        self.left_qps: List[QueuePair] = []
        self.right_qps: List[QueuePair] = []
        self.left_qp: Optional[QueuePair] = None
        self.right_qp: Optional[QueuePair] = None
        self.ring: Optional[Ring] = None
        self._barrier_buf = None
        # Seal configuration string, fixed per incarnation at
        # bootstrap: part of the schedule digest (jax_shim) so a rank
        # pair with mismatched seal settings fails fast with a
        # schedule-mismatch error instead of mis-parsing frames.
        self.seal_config = ""
        # Training step stamped into outbound seals (set_seal_step).
        self._seal_step = 0
        # Schedule-digest buffers (check_schedule), registered lazily
        # on the ENGINE (they survive rebuilds; QPs do not).
        self._dg_send = self._dg_recv = None
        self._dg_smr = self._dg_rmr = None
        # Last ring-verified schedule digest: steady-state calls with
        # an unchanged digest skip the exchange entirely.
        self._sched_verified: bytes = b""
        # Outstanding async collective handles (pending_async).
        self._async_live = 0
        # ---- Hierarchical topology (ROADMAP item 1) ----
        # ``topology``: an explicit host-key list, None (resolve from
        # TDR_TOPOLOGY, else the coordinator view's host_keys), or
        # "flat" (disabled — what the tier sub-worlds themselves pass
        # so tiers never recurse). ``tier="stream"`` pins every
        # connection of THIS world off the CMA fast path (the
        # emulated inter-host delegate ring keeps full payload seals).
        if isinstance(topology, str) and topology != "flat":
            raise ValueError(f"topology={topology!r}: expected a "
                             "host-key list, None, or 'flat'")
        self._topology_arg = topology
        self._force_stream = tier == "stream"
        if tier not in ("auto", "stream"):
            raise ValueError(f"tier={tier!r}: expected 'auto' or "
                             "'stream'")
        self.topology: Optional[TopologyMap] = None
        self._ctl_host_keys: Optional[List[str]] = None
        # Tier sub-worlds (lazily built at the first hierarchical
        # collective of each incarnation; torn down with it).
        self._tier_intra: Optional["RingWorld"] = None
        self._tier_inter: Optional["RingWorld"] = None
        self._tier_gen: Optional[int] = None
        # Tail of the phased-handle chain (per-ring submission-order
        # determinism for async hier/staged collectives).
        self._phased_tail = None
        # ---- Fleet tracing (collective ids + postmortems) ----
        # Per-world monotonic collective trace id: stamped on the
        # ring before EVERY native collective (and wire-carried to the
        # peer under FEAT_COLL_ID), so two ranks' flight-recorder
        # events for one collective join by key in a merged timeline.
        # Hier collectives seed all three tier phases with the parent
        # id via _seed_coll. SPMD keeps the sequence identical across
        # ranks — same collectives, same order.
        self._coll_seq = 0
        self._coll_override: Optional[int] = None
        # Black-box postmortem bundles this world has written
        # (TDR_POSTMORTEM_DIR; pushed via heartbeat so the coordinator
        # serves tdr_postmortems_total{world=}).
        self._postmortems = 0
        try:
            self._bootstrap(timeout_ms)
        except BaseException:
            # A failed CONSTRUCTION leaves no world behind: detach so
            # the engine's tenancy count (which gates the seal stamp)
            # never counts a world the caller never received. rebuild()
            # failures keep the attachment — that world still exists
            # and still occupies the engine.
            self.engine.detach_world(self)
            raise

    # ------------------------------------------------------ bootstrap

    def _listen(self, host: str, port: int, timeout_ms: int) -> QueuePair:
        """Accept one neighbor connection. EADDRINUSE is a FAST-retry
        condition, not a failed attempt: when a new incarnation races a
        lingering listener from the torn-down one (the accept socket
        sets SO_REUSEADDR natively, so TIME_WAIT never binds-blocks,
        but a live listener still does), burning a full backoff attempt
        on it can eat the whole rebuild budget. Retry the bind every
        50 ms inside this attempt's deadline instead."""
        deadline = time.monotonic() + max(timeout_ms, 0) / 1000.0
        while True:
            left_ms = int(max((deadline - time.monotonic()) * 1000, 1))
            try:
                return self.engine.listen(
                    host, port, left_ms,
                    force_stream=getattr(self, "_force_stream", False))
            except TransportError as e:
                if "address already in use" not in str(e).lower():
                    raise
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)

    def _connect(self, host: str, port: int, timeout_ms: int) -> QueuePair:
        """Dial one neighbor (the native layer already retries until
        the listener is up, bounded by the deadline)."""
        return self.engine.connect(
            host, port, timeout_ms,
            force_stream=getattr(self, "_force_stream", False))

    def _bootstrap(self, timeout_ms: int) -> None:
        """Bring up neighbor QPs + ring and agree on the generation.
        On failure nothing usable is left behind (partial QPs are
        closed); the Engine stays reusable."""
        self.engine.attach_world(self)
        arbitrated = self.controller is not None
        if arbitrated:
            # The coordinator's rendezvous barrier replaces the
            # per-rank generation guesswork: every rank of this
            # incarnation receives the SAME membership view here (and,
            # on a RESIZE, the new world size and this rank's repacked
            # position).
            self._ctl_rendezvous(timeout_ms)
        if self._channels_auto:
            # Re-derive the per-host channel cap from THIS
            # incarnation's membership: a RESIZE changes the peer
            # list, and with it the local-rank count the cap divides
            # the core budget by.
            self.channels = auto_channel_cap(self.peers, self.rank)
        # Topology map for the hierarchical schedule: explicit param >
        # TDR_TOPOLOGY > the coordinator view's host keys. Resolved
        # per incarnation (an arbitrated rebuild or RESIZE may release
        # different membership — a shrink that restores uniform groups
        # re-enables hier here); tiers themselves pass topology="flat"
        # and never recurse. A non-hierarchical map (one host,
        # singleton groups, uneven groups) still resolves — the
        # selector just never picks hier for it — and the multi-host
        # shapes that LOOK hierarchical but cannot carry the schedule
        # get a warn-once fallback counter + digest note below.
        if self._topology_arg == "flat":
            self.topology = None
        else:
            self.topology = resolve_topology(
                self.world, self.rank, explicit=self._topology_arg,
                view_keys=self._ctl_host_keys)
        fb = fallback_reason(self.topology)
        if fb and not self._fallback_warned:
            self._fallback_warned = True
            trace.add("algo.fallback", 1)
            trace.event("algo.fallback", rank=self.rank,
                        world_name=self.world_name, why=fb)
        nchan = self.channels
        # Per-world QP budget, enforced at bring-up against the FULL
        # per-incarnation appetite: the flat ring needs 2 * channels
        # QPs (one accept + one dial per channel), and a hierarchical
        # world's intra + delegate tier rings each add 2 * tier
        # channels more. Reserving only the flat appetite would let a
        # hier world pass admission and then blow the engine budget
        # mid-collective when the tiers come up lazily. An over-budget
        # world must die HERE, before it consumes a co-tenant world's
        # native QP headroom or its peer's accept.
        reserved = 2 * nchan
        if self.topology is not None and self.topology.hierarchical:
            reserved += 4 * self._tier_channels()
        self._qp_reserved = reserved
        if self.qp_budget is not None and reserved > self.qp_budget:
            raise TransportError(
                f"world {self.world_name!r} needs {reserved} QPs "
                f"({nchan} channels"
                + (f" + two tier rings of {self._tier_channels()}"
                   if reserved > 2 * nchan else "")
                + f") but its qp_budget is "
                f"{self.qp_budget}; lower TDR_RING_CHANNELS or raise "
                "the budget", retryable=False)
        rank, world = self.rank, self.world
        right = (rank + 1) % world
        # Drop any seal stamp retained from a previous incarnation
        # BEFORE new QPs come up: bootstrap's generation-reconciliation
        # frames must travel unfenced (wire gen 0). Without this, a
        # rebuild where one rank stamped its new generation while its
        # neighbor's attempt failed pre-stamp would integrity-fence
        # the reconciliation itself on every retry — a livelock in
        # exactly the fault regime rebuild() exists to survive. Ghost
        # frames from the old incarnation cannot reach the new QPs
        # (connections are incarnation-scoped), so the fence loses
        # nothing during the window. On an engine hosting MULTIPLE
        # worlds this also protects the co-tenants: an engine-wide
        # stamp naming one world's generation would fence the others'
        # frames, so shared engines run permanently unstamped.
        self.engine.clear_seal_context()
        seal_exclusive = self.engine.world_count <= 1
        accepted: List[Optional[QueuePair]] = [None] * nchan
        err: List[Optional[BaseException]] = [None]

        def _accept():
            # Channels are accepted strictly in order on ONE port: the
            # dialer's connect for channel c returns only after the
            # full QP handshake — which requires this accept — so its
            # dial for channel c+1 can never race into channel c's
            # listener backlog. Connection order IS channel identity.
            try:
                host = ("127.0.0.1"
                        if self.peers[rank] in ("127.0.0.1", "localhost")
                        else self.bind_host)
                for c in range(nchan):
                    accepted[c] = self._listen(
                        host, self.base_port + rank, timeout_ms)
            except BaseException as e:  # surfaced after join
                err[0] = e

        t = threading.Thread(target=_accept, daemon=True)
        t.start()
        dialed: List[QueuePair] = []
        try:
            for c in range(nchan):
                dialed.append(self._connect(
                    self.peers[right], self.base_port + right, timeout_ms))
        except BaseException:
            # The accept side is deadline-bounded; reap whatever it
            # produced so the port is free for the next attempt.
            t.join(nchan * (timeout_ms / 1000 + 5))
            for qp in dialed + [q for q in accepted if q is not None]:
                qp.close()
            raise
        t.join(nchan * (timeout_ms / 1000 + 5))
        if err[0] is not None or any(q is None for q in accepted):
            for qp in dialed + [q for q in accepted if q is not None]:
                qp.close()
            if err[0] is not None:
                raise err[0]
            raise TimeoutError("left neighbor never connected")
        self.left_qps = [q for q in accepted if q is not None]
        self.right_qps = dialed
        self.left_qp = self.left_qps[0]
        self.right_qp = self.right_qps[0]
        try:
            self.ring = Ring(self.engine, self.left_qps, self.right_qps,
                             rank, world)
            self._sched_verified = b""
            self._barrier_buf = None
            self._ensure_digest_bufs()
            if not arbitrated:
                # Legacy pairwise path: circulate the ring-maximum
                # proposal. Arbitrated worlds already HOLD the
                # coordinator's generation — exchanging proposals
                # would reintroduce exactly the rank-local guessing
                # the coordinator exists to remove (and it saves
                # world-1 bootstrap hops).
                self._exchange_generation(timeout_ms)
            # Seal context only AFTER the generation is agreed (ring
            # maximum or coordinator view): a premature stamp would
            # fence the frames that reconcile differing proposals.
            # From here on, every outbound seal names this incarnation
            # and stale-world ghosts fail verification — unless the
            # engine hosts co-tenant worlds, which run unstamped (see
            # clear_seal_context above).
            if seal_exclusive and self.engine.world_count <= 1:
                self.engine.set_seal_context(self.generation,
                                             self._seal_step)
            self.seal_config = (
                f"seal={int(bool(self.left_qp.has_seal))}"
                f":retry={seal_retry_budget()}")
        except BaseException:
            self._teardown()
            raise
        if arbitrated:
            self._ensure_heartbeat()
        # tel_engine ties this rank to its native flight-recorder
        # track, so exporters label the engine timeline "rank N";
        # tel_left/tel_right name the per-channel QP lanes (chunk
        # events for channel c carry these qp track ids, which is how
        # tdr_top / Perfetto key per-channel histograms and lanes).
        trace.event("world.up", rank=rank, world=world,
                    generation=self.generation,
                    tel_engine=self.engine.telemetry_id,
                    channels=self.channels,
                    world_name=self.world_name,
                    arbitrated=int(arbitrated),
                    tel_left=[qp.telemetry_id for qp in self.left_qps],
                    tel_right=[qp.telemetry_id for qp in self.right_qps])

    # --------------------------------------------------- control plane

    def _ctl_rendezvous(self, timeout_ms: int) -> None:
        """Park at the coordinator's rendezvous barrier and adopt its
        membership view (generation, epoch, base port, peers). A
        surviving member re-syncs under its existing incarnation; a
        fresh or superseded member joins for a new one. Raises a
        retryable TransportError on arbitration refusal (rendezvous
        timeout, coordinator unreachable) so rebuild()'s attempt loop
        paces the retry."""
        from rocnrdma_tpu_torch.control.client import ControlError

        timeout_s = max(1.0, timeout_ms / 1000.0)
        view = None
        try:
            if self._ctl_inc is not None:
                view = self.controller.sync(self.world_name, self.rank,
                                            self._ctl_inc,
                                            timeout_s=timeout_s)
                if not view.get("ok"):
                    if view.get("error") != "superseded":
                        raise TransportError(
                            f"control sync failed on rank {self.rank}: "
                            f"{view.get('error')}", retryable=True)
                    # The coordinator lease-expired (or replaced) this
                    # incarnation while we were down: rejoin fresh.
                    self._ctl_inc = None
                    view = None
            if view is None:
                host = (self.peers[self.rank]
                        if self.peers and 0 <= self.rank < len(self.peers)
                        else "127.0.0.1")
                # Topology key for this member (explicit/env override
                # first; the dial address otherwise): released to
                # every slot in the view as host_keys.
                key = None
                keys = self._topology_arg
                if keys is None or keys == "flat":
                    from rocnrdma_tpu_torch.collectives.topology import \
                        parse_env_topology

                    try:
                        keys = parse_env_topology(self.world)
                    except ValueError:
                        keys = None
                if keys and keys != "flat" and \
                        0 <= self.rank < len(keys):
                    key = str(keys[self.rank])
                view = self.controller.join(self.world_name, self.world,
                                            rank=self.rank, host=host,
                                            host_key=key,
                                            timeout_s=timeout_s,
                                            resizable=self.resizable,
                                            max_size=self.max_size,
                                            weight=self.weight)
                if not view.get("ok"):
                    raise TransportError(
                        f"control join failed on rank {self.rank}: "
                        f"{view.get('error')}", retryable=True)
        except ControlError as e:
            raise TransportError(str(e), retryable=True) from e
        # Adopt the coordinator-ASSIGNED ring position: rank=-1 asks
        # for the lowest free slot, and the whole port/neighbor scheme
        # below keys off self.rank. A RESIZE view also moves the world
        # SIZE — a shrink repacked the survivors contiguously, a grow
        # admitted a parked joiner past the old end — so the size is
        # adopted with the same authority as the rank.
        self.rank = int(view.get("rank", self.rank))
        self.world = int(view.get("world_size", self.world))
        old_resizes = self._ctl_resizes
        self._ctl_resizes = int(view.get("resizes", 0))
        if self._ctl_resizes != old_resizes:
            trace.add("ctl.resize_adopted", 1)
            trace.event("ctl.resize_adopted", rank=self.rank,
                        world_name=self.world_name,
                        world=self.world, resizes=self._ctl_resizes)
        self._resize_pending = False
        self._ctl_inc = int(view["incarnation"])
        self.generation = int(view["generation"])
        self._ctl_epoch = int(view["epoch"])
        self.base_port = int(view["base_port"])
        self._ctl_lease_ms = int(view.get("lease_ms", 5000))
        peers = view.get("peers")
        if peers:
            self.peers = [str(p) for p in peers]
        # Adopt the view's topology keys only when EVERY slot carries
        # one: a partially-keyed membership must resolve flat, never
        # guess (and dial addresses are deliberately not a fallback).
        host_keys = view.get("host_keys")
        self._ctl_host_keys = (
            [str(k) for k in host_keys]
            if host_keys and all(k is not None for k in host_keys)
            else None)
        budget = int(view.get("qp_budget") or 0)
        if budget:
            # Coordinator-assigned per-world budget: the stricter of
            # the two bounds wins.
            self.qp_budget = (budget if self.qp_budget is None
                              else min(self.qp_budget, budget))
        trace.event("ctl.view", rank=self.rank,
                    world_name=self.world_name,
                    generation=self.generation, epoch=self._ctl_epoch,
                    base_port=self.base_port,
                    incarnation=self._ctl_inc)

    def _ensure_heartbeat(self) -> None:
        """Start (once) the background lease renewal, pushing native
        counter/histogram snapshots so the coordinator's /metrics
        serves this member's chunk latencies and integrity ladder.
        The thread holds only a WEAK reference to this world: an
        abandoned (never-closed) world must stay collectable — its
        engine tenancy entry is a WeakSet — and its lease must AGE OUT
        at the coordinator (a strong ref would renew a dead
        incarnation's lease forever and park surviving peers'
        rendezvous until timeout)."""
        if self._hb is not None:
            return
        import weakref

        wself = weakref.ref(self)

        def _state():
            w = wself()
            if w is None:
                return None  # world collected: heartbeat thread exits
            # Rank rides along: a RESIZE moves this member's ring
            # position under the SAME incarnation, and the heartbeat
            # must follow it (the old rank's pushes are superseded).
            return (w._ctl_inc, w.generation, w.rank)

        def _counters():
            from rocnrdma_tpu_torch.transport.engine import native_counters

            snap = dict(native_counters())
            snap.update(trace.counters_prefixed("world."))
            snap.update(trace.counters_prefixed("ctl."))
            snap.update(trace.counters_prefixed("trainer."))
            # Which algorithm carried the collectives (flat / hier /
            # staged call counts — the selector made observable on
            # /metrics as tdr_algo_*_total).
            snap.update(trace.counters_prefixed("algo."))
            # Serving SLO counters (tdr_serve_requests_total /
            # tdr_serve_tokens_total — the continuous batcher's
            # request/token tallies ride the same heartbeat).
            snap.update(trace.counters_prefixed("serve."))
            return snap

        def _hists():
            from rocnrdma_tpu_torch.transport.engine import \
                telemetry_histograms

            out = {name: {i: c for i, c in enumerate(buckets) if c}
                   for name, buckets in telemetry_histograms().items()}
            # Python-tier fine histograms (log2×8 — serving token
            # latency). The marker bucket {64: 0} forces the
            # coordinator's reconstructed row past 64 entries, so
            # hist_percentile reads it with fine-octave edges while
            # the native 64-octave rows keep their interpretation.
            for name, row in trace.hists().items():
                merged = out.setdefault(name, {})
                merged.setdefault(64, 0)
                for b, c in row.items():
                    merged[b] = merged.get(b, 0) + c
            return out

        def _trace_segment(max_events):
            # collect_trace pull: one bounded flight-recorder window
            # (destructive drain — flight-recorder semantics) plus the
            # cumulative drop count so the merge can mark a truncated
            # ring as tainted instead of silently under-reporting.
            from rocnrdma_tpu_torch import telemetry as tel
            from rocnrdma_tpu_torch.transport.engine import telemetry_dropped

            if not tel.enabled():
                return {"events": [], "dropped": 0, "disabled": True}
            dropped = int(telemetry_dropped())
            events = tel.timeline()
            if len(events) > max_events:
                # The truncation is a loss too: count it into the
                # taint signal, or the merge would mark a visibly
                # one-sided window as complete.
                dropped += len(events) - max_events
                events = events[-max_events:]
            return {"events": tel.events_to_wire(events),
                    "dropped": dropped}

        def _postmortems():
            w = wself()
            return 0 if w is None else w._postmortems

        def _notify(resp):
            # The coordinator's RESIZE hint: membership no longer
            # matches this incarnation's shape (a grow joiner parked,
            # or a slot died on a resizable world). Flag it so the
            # NEXT collective fails retryably at its entry boundary
            # and the elastic ladder re-parks for the new-size view —
            # heartbeats are how a healthy member learns about a
            # resize that broke nothing it can observe on the wire.
            w = wself()
            if w is not None and resp.get("resize_pending"):
                w._resize_pending = True

        def _extras():
            # Bring-up QP reservation, pushed so the coordinator can
            # serve tdr_ctl_qp_reserved{world=} (reserved appetite vs
            # the fair share it granted) — plus the link-health
            # snapshot and degradation tally, served as
            # tdr_link_health{world=,rank=,peer=} and
            # tdr_degraded_total{world=} (slow-rank quarantine: the
            # coordinator names WHICH link the ladder degraded).
            w = wself()
            if w is None:
                return {}
            ex = {"qp_reserved": w._qp_reserved}
            hs = _health.snapshot(w.world_name)
            if hs:
                ex["link_health"] = hs
                ex["degraded_total"] = _health.degraded_total(
                    w.world_name)
            return ex

        self._hb = self.controller.start_heartbeat(
            self.world_name, self.rank, state_fn=_state,
            interval_s=max(0.2, self._ctl_lease_ms / 3000.0),
            counters_fn=_counters, hists_fn=_hists,
            trace_fn=_trace_segment, postmortems_fn=_postmortems,
            notify_fn=_notify, extras_fn=_extras)

    @property
    def control_stamp(self) -> str:
        """Arbitration term for the schedule digest: the coordinator's
        generation and membership epoch. Empty (legacy digests are
        preserved byte-for-byte) without a controller; with one, two
        ranks acting on different membership views fail the first
        collective's digest exchange instead of desynchronizing. A
        RESIZE stamps its count in too — generation alone also moves,
        but the resize count makes "same generation, different world
        shape" (a restore racing a resize) structurally impossible to
        agree on. Worlds that never resized keep the legacy stamp
        byte-for-byte."""
        if self.controller is None:
            return ""
        stamp = (f"ctl={self.world_name}:g{self.generation}"
                 f":e{self._ctl_epoch}")
        if self._ctl_resizes:
            stamp += f":r{self._ctl_resizes}"
        return stamp

    def _ensure_digest_bufs(self) -> None:
        if self._dg_smr is not None:
            return
        self._dg_send = np.zeros(_DG_BYTES, dtype=np.uint8)
        self._dg_recv = np.zeros(_DG_BYTES, dtype=np.uint8)
        self._dg_smr = self.engine.reg_mr(self._dg_send)
        self._dg_rmr = self.engine.reg_mr(self._dg_recv)

    def _exchange_generation(self, timeout_ms: int) -> None:
        """Circulate the ring maximum generation (world-1 hops): every
        rank ends at the same, largest proposal — survivors keep their
        bumped count, a restarted rank adopts it."""
        gen = self.generation
        for _ in range(self.world - 1):
            self._dg_send[:8] = np.frombuffer(struct.pack("<q", gen),
                                              dtype=np.uint8)
            self._dg_hop(_GEN_BYTES, timeout_ms, "generation")
            left = struct.unpack("<q", self._dg_recv[:8].tobytes())[0]
            gen = max(gen, left)
        self.generation = gen

    # ---------------------------------------------------- collectives
    #
    # Every collective runs under a trace.span carrying rank and byte
    # count: in the merged flight-recorder timeline the span is the
    # bar over the native chunk instants (post/tx/land/retx/wc) it
    # contains, so a training step reads top-down from ring_allreduce
    # to an individual chunk retransmit.

    def _live_ring(self) -> Ring:
        """The ring, or a RETRYABLE error when this incarnation is
        torn down (a flapped rank's collectives between teardown and
        rebuild must surface as elastic-recoverable, not as an
        AttributeError the trainer cannot classify). A pending world
        RESIZE surfaces here too: the coordinator cuts the new-size
        view at a COLLECTIVE BOUNDARY, so a member that learned of one
        via its heartbeat must fail the next collective retryably and
        re-park rather than run it at a shape the fleet is leaving."""
        if self._resize_pending:
            raise TransportError(
                f"world RESIZE pending on rank {self.rank} (membership "
                "no longer matches this incarnation's shape); "
                "rebuild() required", retryable=True)
        ring = self.ring
        if ring is None:
            raise TransportError(
                f"world torn down on rank {self.rank} (no live "
                "incarnation); rebuild() required", retryable=True)
        return ring

    # ------------------------------------------- collective trace ids

    def _next_coll(self) -> int:
        """The per-world monotonic collective trace id for the NEXT
        collective: every rank runs the same collectives in the same
        order (the SPMD contract), so the sequence is identical
        fleet-wide and becomes the cross-rank join key. A parent
        hierarchical collective seeds its tier phases with its own id
        (_seed_coll), which this consumes one-shot."""
        if self._coll_override is not None:
            c, self._coll_override = self._coll_override, None
            return c
        self._coll_seq += 1
        return self._coll_seq

    def _seed_coll(self, coll: int) -> None:
        """One-shot override for the next collective's trace id — how
        a hier/staged parent makes its phase collectives (which run on
        the TIER worlds with their own sequences) carry the parent's
        id, so tdr_explain attributes all three phases to one
        fleet-level collective, split per tier."""
        self._coll_override = int(coll)

    def _coll_ring(self) -> tuple:
        """(live ring, fresh coll id) with the id already stamped on
        the ring — the preamble of every collective entry point."""
        ring = self._live_ring()
        coll = self._next_coll()
        ring.set_coll(coll)
        return ring, coll

    # ------------------------------------------- hierarchical tiers
    #
    # A world with a hierarchical TopologyMap lazily brings up two
    # tier sub-rings per incarnation: the intra-host ring (this rank's
    # co-located group — CMA tier, tag-only seals) and the inter-host
    # delegate ring (this rank's local index on every host — pinned to
    # the stream tier so the emulated "slow" links keep full payload
    # seals). The hierarchical allreduce then runs intra
    # reduce-scatter → delegate-ring allreduce over the owned shard →
    # intra all-gather; inter-host bytes shrink by the local group
    # size. Tiers are ordinary RingWorlds (legacy pairwise path,
    # topology="flat" so they never recurse) sharing this world's
    # generation, so the elastic ladder holds per tier: any tier
    # failure surfaces as a retryable TransportError, rebuild() tears
    # every tier down with the incarnation, and the next hierarchical
    # collective rebuilds them under the bumped generation.

    def _tier_channels(self) -> int:
        """Channel count for the tier sub-rings: with channels="auto"
        the usable-cores budget divides across the two concurrently
        live rings (intra + delegate) instead of each claiming the
        full cap; explicit channel counts are inherited as-is."""
        if self._channels_auto:
            return auto_channel_cap(self.peers, self.rank, rings=2)
        return self.channels

    def _ensure_tiers(self):
        """Bring up (or return) this incarnation's tier sub-rings.
        Deterministic port layout inside the world's port arena:
        intra group g listens on base + world*(1+g) + local_rank;
        inter ring l (one per local index) on base + world*(1+hosts)
        + l*hosts + host_index — disjoint from the flat ring's
        base + rank and from each other. All ranks reach this from
        the same (digest-agreed) collective, so the tier rendezvous
        is concurrent by construction."""
        topo = self.topology
        if topo is None or not topo.hierarchical:
            raise TransportError(
                f"hierarchical collective on rank {self.rank} without "
                "a hierarchical topology (set TDR_TOPOLOGY or pass "
                "topology=)", retryable=False)
        if self._tier_gen == self.generation and \
                self._tier_intra is not None:
            return self._tier_intra, self._tier_inter
        self._close_tiers()
        self._live_ring()  # torn down -> retryable, before bring-up
        world, hosts = self.world, topo.n_hosts
        nchan = self._tier_channels()
        # QP budget honesty: each tier ring carries its own slice of
        # this world's reservation (2 QPs per channel, already counted
        # in _qp_reserved at bootstrap) so the bookkeeping the
        # coordinator granted holds all the way down the hierarchy —
        # a tier can never quietly out-grow what the parent reserved.
        tier_budget = None if self.qp_budget is None else 2 * nchan
        intra_base = self.base_port + world * (1 + topo.host_index)
        try:
            intra = RingWorld(
                self.engine, topo.local_rank, topo.local_size,
                intra_base,
                peers=[self.peers[g] for g in topo.group],
                bind_host=self.bind_host, timeout_ms=self.timeout_ms,
                generation=self.generation, channels=nchan,
                topology="flat", qp_budget=tier_budget,
                world_name=self.world_name + ".intra")
            try:
                inter_base = (self.base_port + world * (1 + hosts)
                              + topo.local_rank * hosts)
                inter = RingWorld(
                    self.engine, topo.host_index, hosts, inter_base,
                    peers=[self.peers[g] for g in topo.delegate_ring()],
                    bind_host=self.bind_host,
                    timeout_ms=self.timeout_ms,
                    generation=self.generation, channels=nchan,
                    topology="flat", tier="stream",
                    qp_budget=tier_budget,
                    world_name=self.world_name + f".x{topo.local_rank}")
            except BaseException:
                try:
                    intra.close()
                except Exception:
                    pass
                raise
        except TransportError as e:
            if "qp budget exhausted" in str(e) and not e.retryable:
                # The NATIVE engine pool rejected a tier QP: at the
                # engine layer that is deliberately non-retryable (a
                # mis-sized single world must fail loudly, test-pinned)
                # — but DURING tier bring-up it usually means transient
                # co-tenant pressure on a shared engine, and the
                # rebuild ladder is exactly the fail-fast retry that
                # resolves it once the co-tenant releases QPs.
                raise TransportError(
                    f"tier bring-up on rank {self.rank}: {e}",
                    retryable=True) from e
            raise
        self._tier_intra, self._tier_inter = intra, inter
        self._tier_gen = self.generation
        trace.event("world.tiers_up", rank=self.rank,
                    hosts=hosts, local=topo.local_size,
                    channels=nchan, generation=self.generation)
        return intra, inter

    def _close_tiers(self) -> None:
        """Best-effort teardown of the tier sub-rings (never raises;
        rides every _teardown so a rebuild always rebuilds BOTH tiers
        under the new generation)."""
        for w in (self._tier_intra, self._tier_inter):
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass
        self._tier_intra = self._tier_inter = None
        self._tier_gen = None

    @property
    def topology_stamp(self) -> str:
        """Schedule-digest term for the hierarchical configuration:
        the topology shape/fingerprint plus the algorithm-selector
        mode. Empty for flat worlds (legacy digests byte-identical);
        with it, two ranks grouping the world differently — or
        switching algorithms at different sizes — fail the first
        collective's digest exchange instead of desynchronizing. A
        multi-host topology that RESOLVED but cannot carry the
        hierarchical schedule (non-uniform host groups after an uneven
        shrink, singleton groups) stamps its fallback reason instead:
        two ranks disagreeing on WHY the world fell back to flat is
        the same split-brain as disagreeing on the grouping."""
        topo = self.topology
        if topo is None:
            return ""
        if not topo.hierarchical:
            fb = fallback_reason(topo)
            return f"topo=fallback:{fb}" if fb else ""
        return f"{topo.stamp()} {algo_stamp(topo)}"

    @property
    def health_stamp(self) -> str:
        """Schedule-digest term for the degradation ladder's engaged
        rungs: hier→flat fallback and/or the bf16 wire downgrade are
        schedule/precision-changing, so ranks must agree on them the
        way they agree on topology. A healthy world contributes
        NOTHING — legacy digests stay byte-identical. Divergence
        (multi-process ranks whose scores crossed a rung at different
        times) fails the next digest exchange retryably; the scores
        converge and the following collective re-agrees."""
        terms = []
        if _health.fallback_active(self.world_name):
            terms.append("health=flat")
        if _health.wire_int8(self.world_name):
            # Rung between bf16 and fallback: the delegate payload
            # rides the int8 scale-carrying schedule. Shadows the
            # bf16 term (the deeper rung wins, the way fallback
            # shadows the whole hier schedule).
            terms.append("hwire=int8")
        elif _health.wire_downgrade(self.world_name):
            terms.append("hwire=bf16")
        return " ".join(terms)

    def _algo_for(self, nbytes: int, algo: Optional[str]) -> str:
        """Resolve the per-call algorithm (explicit override or the
        size/topology selector), degrading hier to flat when the
        topology cannot carry it or the message is smaller than the
        world (empty segments)."""
        if algo is None:
            algo = choose_algo(int(nbytes), self.topology)
        elif algo not in ("flat", "hier", "staged"):
            raise ValueError(f"algo={algo!r}: expected 'flat', "
                             "'hier', or 'staged'")
        if algo == "hier":
            topo = self.topology
            if topo is None or not topo.hierarchical:
                return "flat"
            # Every intra segment and every inter segment must be
            # non-empty: count >= world gives count/local >= hosts.
            if int(nbytes) == 0 or \
                    int(nbytes) < self.world * 8:  # conservative floor
                return "flat"
            # Degradation-ladder rung 2: a sick delegate link (EWMA
            # goodput collapsed vs its own history, or hard fault
            # evidence) falls the schedule back to the flat ring —
            # slower, but it stops riding the link that would
            # otherwise stall into the deadline/rebuild escalation.
            # TDR_NO_DEGRADE=1 disables the rung (health.py).
            # The verdict is frozen per collective, keyed on the NEXT
            # collective's sequence number (_next_coll has not run
            # yet): the rung state can flip mid-window under another
            # rank's observe/fault, and ranks reading it live would
            # split across hier/flat and deadlock. 'canary': an
            # every-Nth probe collective that rides the sick link so
            # the score can heal (health.schedule_verdict).
            v = _health.schedule_verdict(self.world_name,
                                         self._coll_seq + 1)
            if v == "flat":
                trace.add("algo.degraded", 1)
                return "flat"
            if v == "canary":
                trace.add("health.probation", 1)
        return algo

    def allreduce(self, array, op: int = RED_SUM,
                  algo: Optional[str] = None) -> None:
        """In-place ring allreduce of a C-contiguous numpy array.

        ``algo`` overrides the size/topology-aware selector
        (TDR_ALGO): 'flat' = the native fused/wavefront ring, 'hier' =
        intra-host reduce-scatter → inter-host delegate-ring allreduce
        → intra-host all-gather, 'staged' = explicit two-phase
        reduce-scatter + all-gather on the flat ring. All three are
        bitwise-identical for exactly-representable sums; float
        summation ORDER differs across algorithms (as across world
        sizes), which the schedule digest makes a cross-rank
        agreement, never a silent divergence."""
        algo = self._algo_for(int(array.nbytes), algo)
        if algo == "hier":
            self._hier_allreduce(array, op)
            return
        if algo == "staged":
            ring, coll = self._coll_ring()
            with trace.span("world.allreduce", rank=self.rank,
                            bytes=int(array.nbytes), algo="staged",
                            coll=coll):
                trace.add("algo.staged", 1)
                # One fleet-level collective, two phases: the sticky
                # ring stamp carries the same id into the all_gather.
                ring.reduce_scatter(array, op)
                ring.all_gather(array)
            return
        ring, coll = self._coll_ring()
        with trace.span("world.allreduce", rank=self.rank,
                        bytes=int(array.nbytes), coll=coll):
            trace.add("algo.flat", 1)
            ring.allreduce(array, op)

    def _hier_allreduce(self, array, op: int = RED_SUM) -> None:
        """The two-tier schedule, blocking: every phase is the
        first-class primitive it names, so the composition identity
        (allreduce ≡ RS; inter-AR on the owned shard; AG) is shared
        code, not a re-derivation."""
        intra, inter = self._ensure_tiers()
        topo = self.topology
        coll = self._next_coll()
        # Health attribution: the delegate link's peer is the NEXT
        # delegate on the inter ring (global rank) — the label
        # quarantine reporting and tdr_explain name stragglers by.
        ring_order = topo.delegate_ring()
        inter_peer = ring_order[(topo.host_index + 1) % topo.n_hosts]
        with trace.span("world.hier_allreduce", rank=self.rank,
                        bytes=int(array.nbytes), hosts=topo.n_hosts,
                        local=topo.local_size, coll=coll):
            trace.add("algo.hier", 1)
            # All three tier phases carry the PARENT's trace id: one
            # fleet-level collective, attributable per tier (the intra
            # ring's events vs the delegate ring's) by the tier-world
            # lanes they ride on.
            intra._seed_coll(coll)
            t0 = time.monotonic()
            own = intra.reduce_scatter(array, op)
            _health.observe(self.world_name, f"intra:r{self.rank}", -1,
                            int(array.nbytes), time.monotonic() - t0)
            shard = _np_view(array.reshape(-1)[own])
            # Degradation-ladder rung 1: quantize the inter-host
            # payload to bf16 PRECISION (mantissa truncation, in
            # place — ``shard`` is a view) when the delegate link is
            # degraded but not yet fallback-sick. Exactly-representable
            # values (the bitwise-parity test regime) survive the
            # truncation losslessly; the precision change is
            # digest-stamped (health_stamp) so ranks that disagree
            # fail the next schedule exchange retryably instead of
            # folding mixed precision.
            # FROZEN per-collective wire verdict, not the live rung
            # state: the int8 rung swaps the wire schedule itself, so
            # a mid-window rung flip read live would split the
            # delegates across the q8 and plain schedules — the same
            # deadlock _algo_for's frozen hier/flat verdict prevents.
            wire = _health.wire_verdict(self.world_name, self._coll_seq)
            wire_int8 = (shard.dtype == np.float32 and op == RED_SUM and
                         wire == "int8")
            if shard.dtype == np.float32 and not wire_int8 and \
                    wire == "bf16":
                trace.add("health.wire_bf16", 1)
                shard.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
            inter._seed_coll(coll)
            t0 = time.monotonic()
            try:
                if wire_int8:
                    # Degradation-ladder rung between bf16 and flat
                    # fallback: quantize the delegate payload to int8
                    # with a symmetric per-shard scale and run the
                    # scale-carrying q8 schedule — the wire halves
                    # again below bf16. Exact when every |value| is an
                    # integer multiple of absmax/127 (the brownout
                    # smoke's integer regime: absmax == 127 → scale 1,
                    # lossless); digest-stamped hwire=int8. No error
                    # feedback on this rung — the health ladder's
                    # collectives are one-shot, not a training stream.
                    trace.add("health.wire_int8", 1)
                    absmax = float(np.max(np.abs(shard))) if \
                        shard.size else 0.0
                    scale = absmax / 127.0
                    if scale > 0.0:
                        q8 = np.round(shard / scale).astype(np.int8)
                    else:
                        q8 = np.zeros(shard.size, np.int8)
                    inter.allreduce_q8(q8, scale, shard)
                else:
                    inter.allreduce(shard, op, algo="flat")
            except TransportError as e:
                # Hard evidence beats EWMA drift: stall/deadline/hung
                # verdicts on the delegate link halve its score NOW,
                # so the post-rebuild world comes back degraded
                # instead of re-riding the sick link at full speed.
                if e.retryable:
                    _health.fault(self.world_name,
                                  f"inter:r{self.rank}", inter_peer,
                                  kind=e.kind)
                raise
            _health.observe(self.world_name, f"inter:r{self.rank}",
                            inter_peer, int(shard.nbytes),
                            time.monotonic() - t0)
            intra._seed_coll(coll)
            intra.all_gather(array)

    def allreduce_async(self, array, op: int = RED_SUM,
                        algo: Optional[str] = None):
        """Nonblocking in-place allreduce: returns a
        :class:`CollectiveHandle` immediately; the wire work proceeds
        on the ring's async driver + progress shards while the caller
        computes. SPMD contract: every rank must start the same async
        ops in the same order (ops execute in submission order, so the
        wire sequence — and the result, bitwise — matches back-to-back
        blocking calls). Do not run other collectives on this world
        until every outstanding handle completed, and wait all handles
        before ``rebuild()``/``close()`` (teardown fails pending
        handles with a retryable error rather than wedging them).

        With a hierarchical algorithm (selector or ``algo=``), the
        returned handle is a phase CHAIN: the intra reduce-scatter is
        submitted immediately; the delegate-ring allreduce and intra
        all-gather submit as their predecessors complete, in creation
        order across outstanding handles — per-ring submission order
        stays deterministic (the SPMD contract) however the caller
        interleaves test()/wait()."""
        algo = self._algo_for(int(array.nbytes), algo)
        if algo in ("hier", "staged"):
            return _PhasedHandle(self, array, op, hier=algo == "hier")
        ring, coll = self._coll_ring()
        trace.add("algo.flat", 1)
        trace.event("world.allreduce_async", rank=self.rank,
                    bytes=int(array.nbytes), coll=coll)
        rop = ring.allreduce_async(array, op)
        self._async_live += 1
        return CollectiveHandle(self, rop, int(array.nbytes), coll=coll)

    def allreduce_q8(self, q8, scale: float, out) -> None:
        """Blocking int8 wire-compressed allreduce on the flat ring:
        ``q8`` (int8 scratch, destroyed) holds this rank's values
        quantized with the symmetric per-bucket ``scale``; ``out``
        (float32) receives the dequantized sum, bitwise identical on
        every rank. Requires FEAT_WIRE_Q8 on every ring QP (fails
        fast otherwise — the schedule digest carries the fleet-wide
        agreement, this carries the per-link handshake)."""
        ring, coll = self._coll_ring()
        with trace.span("world.allreduce_q8", rank=self.rank,
                        bytes=int(q8.nbytes), coll=coll):
            trace.add("algo.flat", 1)
            ring.allreduce_q8(q8, scale, out)

    def allreduce_q8_async(self, q8, scale: float,
                           out) -> "CollectiveHandle":
        """Nonblocking :meth:`allreduce_q8` on the ring's async driver
        (same submission-order SPMD contract as ``allreduce_async``).
        Both buffers must stay alive and untouched until the handle
        completes; the handle pins them."""
        ring, coll = self._coll_ring()
        trace.add("algo.flat", 1)
        trace.event("world.allreduce_q8_async", rank=self.rank,
                    bytes=int(q8.nbytes), coll=coll)
        rop = ring.allreduce_q8_async(q8, scale, out)
        self._async_live += 1
        return CollectiveHandle(self, rop, int(q8.nbytes),
                                what="allreduce_q8", coll=coll)

    @property
    def wire_q8(self) -> bool:
        """True when every ring QP (both directions, all channels)
        negotiated FEAT_WIRE_Q8 — the int8 schedule may run on this
        world. False on a closed/rebuilding world."""
        qps = list(getattr(self, "left_qps", None) or []) + \
            list(getattr(self, "right_qps", None) or [])
        if not qps or self.ring is None:
            return False
        try:
            return all(q.has_wire_q8 for q in qps)
        except TransportError:
            return False

    @property
    def link_tier(self) -> str:
        """How payloads reach the left neighbour: the engine's name, or
        on the emu engine "cma" (cross-memory attach) or "stream" (over
        the socket, where payloads are always sealed; on the CMA tier
        only with TDR_SEAL_CMA=1)."""
        if self.engine.name != "emu":
            return self.engine.name
        return "stream" if self.left_qp.has_seal_payload else "cma"

    def reduce_scatter_async(self, array,
                             op: int = RED_SUM) -> "CollectiveHandle":
        """Nonblocking in-place reduce-scatter on the ring's async
        driver (submission-order contract as ``allreduce_async``;
        results bitwise the blocking call's). Read the owned slice
        with :meth:`owned_slice` — it is a pure function of the
        layout, available before completion."""
        ring, coll = self._coll_ring()
        trace.event("world.reduce_scatter_async", rank=self.rank,
                    bytes=int(array.nbytes), coll=coll)
        rop = ring.reduce_scatter_async(array, op)
        self._async_live += 1
        return CollectiveHandle(self, rop, int(array.nbytes),
                                what="reduce_scatter", coll=coll)

    def all_gather_async(self, array) -> "CollectiveHandle":
        """Nonblocking in-place all-gather of per-rank owned segments
        (the layout ``reduce_scatter`` leaves), on the async driver."""
        ring, coll = self._coll_ring()
        trace.event("world.all_gather_async", rank=self.rank,
                    bytes=int(array.nbytes), coll=coll)
        rop = ring.all_gather_async(array)
        self._async_live += 1
        return CollectiveHandle(self, rop, int(array.nbytes),
                                what="all_gather", coll=coll)

    def owned_slice(self, array) -> slice:
        """The flat-element slice this rank owns after a
        reduce-scatter of ``array`` (native segment math — the async
        twin of ``reduce_scatter``'s return value)."""
        return self._live_ring().owned_slice(array)

    @property
    def pending_async(self) -> int:
        """Outstanding async collective handles on this world (handles
        started and not yet waited/tested to completion) — the
        handle-leak census smokes and tests assert returns to zero."""
        return self._async_live

    def reduce_scatter(self, array, op: int = RED_SUM) -> slice:
        """In-place reduce-scatter; returns the element slice this
        rank owns afterwards (allreduce ≡ reduce_scatter then
        all_gather on the same buffer)."""
        ring, coll = self._coll_ring()
        with trace.span("world.reduce_scatter", rank=self.rank,
                        bytes=int(array.nbytes), coll=coll):
            return ring.reduce_scatter(array, op)

    def all_gather(self, array) -> None:
        """In-place all-gather of per-rank owned segments (the layout
        ``reduce_scatter`` leaves)."""
        ring, coll = self._coll_ring()
        with trace.span("world.all_gather", rank=self.rank,
                        bytes=int(array.nbytes), coll=coll):
            ring.all_gather(array)

    def broadcast(self, array, root: int = 0) -> None:
        """Broadcast root's buffer to every rank (store-and-forward
        chunk pipeline down the ring)."""
        ring, coll = self._coll_ring()
        with trace.span("world.broadcast", rank=self.rank,
                        bytes=int(array.nbytes), coll=coll):
            ring.broadcast(array, root)

    def all_to_all(self, array) -> None:
        """In-place all-to-all: the flat buffer is ``world`` equal
        segments, segment j FOR rank j on entry, FROM rank j on
        return (MPI_Alltoall; sequence<->head resharding's primitive,
        collectives/ulysses.py)."""
        ring, coll = self._coll_ring()
        with trace.span("world.all_to_all", rank=self.rank,
                        bytes=int(array.nbytes), coll=coll):
            ring.all_to_all(array)

    def reduce(self, array, root: int = 0, op: int = RED_SUM) -> None:
        """Root-reduce: root's buffer ends holding the reduction over
        all ranks; non-root buffers are clobbered with the partials
        that passed through them (use allreduce when every rank needs
        the result intact)."""
        ring, coll = self._coll_ring()
        with trace.span("world.reduce", rank=self.rank,
                        bytes=int(array.nbytes), coll=coll):
            ring.reduce(array, root, op)

    def set_seal_step(self, step: int) -> None:
        """Stamp the training step into outbound seals (informational
        but CRC-covered: a corrupted tag fails verification like a
        corrupted payload). The sync layer forwards the elastic
        trainer's step token here. On an engine shared by several
        worlds the engine-wide stamp stays CLEARED (a restamp here
        would fence the co-tenant worlds' frames with THIS world's
        generation — see the bootstrap's multi-tenancy note)."""
        self._seal_step = int(step)
        if self.engine.world_count <= 1:
            self.engine.set_seal_context(self.generation, self._seal_step)

    def barrier(self) -> None:
        """Collective barrier: no rank returns before every rank has
        entered. A world-element allreduce — every segment non-empty,
        so each rank's result transitively depends on every other
        rank's contribution (a 1-element reduce would leave the
        zero-length-segment ranks free to return early). The buffer is
        created and ring-registered once, so steady-state barriers
        post work requests only (the front-loaded-registration
        invariant)."""
        ring = self._live_ring()
        buf = self._barrier_buf
        if buf is None:
            buf = self._barrier_buf = np.zeros(self.world,
                                               dtype=np.int32)
            ring.register_buffer(buf)
        else:
            buf[:] = 0
        # Barriers are collectives too: a fresh id keeps the sticky
        # ring stamp from attributing barrier frames to the previous
        # data collective.
        ring.set_coll(self._next_coll())
        ring.allreduce(buf)

    def _dg_hop(self, send_len: int, timeout: int, what: str) -> None:
        """One neighbor hop of the digest protocol: recv ``send_len``
        bytes from the left while sending the same from the right."""
        self.left_qp.post_recv(self._dg_rmr, 0, send_len,
                               wr_id=_WR_DIGEST_RECV)
        self.right_qp.post_send(self._dg_smr, 0, send_len,
                                wr_id=_WR_DIGEST_SEND)
        wc = self.right_qp.wait(_WR_DIGEST_SEND, timeout_ms=timeout)
        if not wc.ok:
            raise TransportError(
                f"schedule {what} send failed (status {wc.status})")
        wc = self.left_qp.wait(_WR_DIGEST_RECV, timeout_ms=timeout)
        if not wc.ok:
            raise TransportError(
                f"schedule {what} recv failed (status {wc.status})")

    def check_schedule(self, digest: bytes, describe: str = "") -> None:
        """Fail fast on SPMD schedule divergence.

        Round 1: each rank sends its 32-byte schedule digest — plus
        the ring GENERATION it believes it is in — to its right
        neighbor and compares the pair received from its left; on a
        CLOSED ring, every pair matching implies all ranks match.
        Round 2: a status byte (2 = my pair matched, 1 = stale
        generation, 0 = digest mismatch) circulates world-1 hops
        carrying the ring-wide minimum, so EVERY rank — not just the
        divergent pair — raises immediately, and with the right error
        class, instead of posting into a dead collective and stalling
        out the ~30 s ring timeout (the failure mode the reference
        world debugged from dmesg).

        **Generation fencing**: a rank still on a previous incarnation
        (it missed a ``rebuild()``) fails the comparison with an
        explicit stale-generation error — its packets are fenced off
        at the first collective instead of desynchronizing the new
        ring. The error is retryable: rebuilding re-syncs generations.

        TDR_NO_SCHED_CHECK=1 skips only the comparison/raise; the
        messages are still exchanged on every rank so a per-rank env
        divergence can never desynchronize the QP message stream
        (a skipped exchange would let the neighbor's digest frame be
        consumed by a gradient recv as data).

        **Steady-state amortization**: once a digest has gone through
        the full exchange, later calls with the SAME digest skip it —
        they post only ring work requests. This is deterministic
        across ranks: a successful exchange of digest D means every
        rank verified D, so every rank's cache holds D and every rank
        skips the same calls (env divergence included — the first
        call exchanges on every rank regardless of
        TDR_NO_SCHED_CHECK). A rank whose schedule CHANGES re-runs
        the exchange; if all ranks changed identically it verifies
        and re-caches, and if they diverged it fails fast here. A
        rebuild resets the cache, so the first collective of every
        incarnation re-verifies under the new generation. The
        residual (unchecked) case is a schedule change on a strict
        subset of ranks against a previously-verified steady state —
        that desynchronizes the ring and surfaces as a completion
        error or the ring stall deadline, never silent corruption of
        a fold (the 30 s failure mode the first-call check exists to
        beat; steady-state steps buy zero per-step hops for it).
        """
        if digest == self._sched_verified:
            trace.event("world.sched_cached")
            return
        self._live_ring()  # torn-down incarnation -> retryable, early
        self._ensure_digest_bufs()
        assert len(digest) == 32
        timeout = int(os.environ.get("TDR_RING_TIMEOUT_MS", "30000"))
        check = os.environ.get("TDR_NO_SCHED_CHECK", "0") in ("", "0")

        trace.event("world.sched_check", generation=self.generation)
        self._dg_recv[:] = 0
        self._dg_send[:32] = np.frombuffer(digest, dtype=np.uint8)
        self._dg_send[32:40] = np.frombuffer(
            struct.pack("<q", self.generation), dtype=np.uint8)
        self._dg_hop(_DG_BYTES, timeout, "digest")
        got = self._dg_recv[:32].tobytes()
        got_gen = struct.unpack("<q", self._dg_recv[32:40].tobytes())[0]
        ok_gen = got_gen == self.generation
        ok_digest = got == digest

        # Status circulation: 2 = pair matched, 1 = stale generation,
        # 0 = digest mismatch; world-1 hops carry the ring-wide
        # MINIMUM, so the most severe verdict reaches EVERY rank and
        # each raises the right error CLASS — generation skew is
        # retryable (a rebuild re-syncs it), layout divergence is
        # fatal — not just the ranks adjacent to the divergence.
        if not check or (ok_gen and ok_digest):
            status = 2
        elif not ok_gen:
            status = 1
        else:
            status = 0
        for _ in range(self.world - 1):
            self._dg_send[0] = status
            self._dg_hop(1, timeout, "status")
            status = min(status, int(self._dg_recv[0]))
        if status == 2:
            # Ring-wide agreement on this digest (or on skipping the
            # comparison): steady-state repeats can skip the exchange.
            self._sched_verified = digest
        if not check:
            return
        if not ok_gen or status == 1:
            detail = (f"left neighbor is at incarnation {got_gen}, "
                      f"local ring is at {self.generation}" if not ok_gen
                      else "reported by a peer (this rank's own pair "
                      "matched)")
            raise TransportError(
                f"stale ring generation on rank {self.rank}: {detail} "
                "— traffic from a previous incarnation is fenced off; "
                "rebuild() every rank", retryable=True)
        if not ok_digest:
            raise TransportError(
                f"SPMD schedule mismatch on rank {self.rank}: left "
                f"neighbor's collective layout digest {got.hex()[:16]}… "
                f"differs from local {digest.hex()[:16]}… — all ranks "
                "must call with identical tree structure, dtypes, "
                f"shapes AND residency. Local layout: {describe}")
        if status == 0:
            raise TransportError(
                f"SPMD schedule mismatch reported by a peer (rank "
                f"{self.rank}'s own pair matched); aborting the "
                "collective before posting. Local layout: " + describe)

    # ------------------------------------------------------ elasticity

    def _teardown(self) -> None:
        """Best-effort release of the ring and neighbor QPs — never
        raises, leaves the Engine reusable, and keeps the digest MRs
        (engine-scoped) for the next incarnation. Closing the QPs
        flushes everything the peers posted against us, so a wedged
        neighbor unblocks promptly instead of riding out the stall
        deadline."""
        # Tiers die with the incarnation: a delegate (or any tier)
        # failure escalates to THIS world's rebuild, which must not
        # leave a previous generation's tier rings alive underneath
        # the next one. The next hierarchical collective rebuilds
        # both tiers lazily under the bumped generation.
        self._close_tiers()
        ring, self.ring = self.ring, None
        lefts, self.left_qps = self.left_qps, []
        rights, self.right_qps = self.right_qps, []
        self.left_qp = self.right_qp = None
        closers = [ring and ring.destroy]
        closers += [qp.close for qp in lefts + rights]
        for closer in closers:
            if closer is None:
                continue
            try:
                closer()
            except Exception:
                pass
        self._sched_verified = b""
        self._barrier_buf = None

    def rebuild(self, max_attempts: int = 6, backoff_s: float = 0.2,
                backoff_cap_s: float = 5.0, jitter: float = 0.25,
                timeout_ms: Optional[int] = None,
                jitter_seed: Optional[int] = None,
                reason: str = "") -> "RingWorld":
        """Tear down this incarnation and re-rendezvous under the next
        generation: exponential backoff with jitter between attempts,
        a bounded retry budget, and a per-attempt accept/connect
        deadline. All ranks of the new incarnation must converge on a
        rebuild (survivors call this; a restarted rank constructs a
        fresh ``RingWorld`` at the same ports and adopts the bumped
        generation at bootstrap). Raises a non-retryable
        ``TransportError`` when the budget is exhausted.

        **Legacy path** (no controller): this rank bumps its own
        generation proposal; the bootstrap exchange circulates the
        ring maximum. **Arbitrated path**: the failure is REPORTED to
        the coordinator — the first report of an incident moves the
        world's generation, every later one just learns it — and each
        bootstrap attempt parks at the coordinator's rendezvous
        barrier, adopting whatever membership view it releases. No
        rank-local generation arithmetic happens at all.

        Backoff jitter is drawn from a ``random.Random`` seeded with
        (``jitter_seed`` or TDR_REBUILD_SEED, rank, generation) —
        never the global ``random`` module — so a soak failure
        replays exactly under the same ``TDR_FAULT_PLAN``.

        **Black-box postmortem**: with ``TDR_POSTMORTEM_DIR`` set,
        every rebuild first dumps this rank's flight-recorder ring,
        counter registry, last error (``reason``), and schedule digest
        to ``<dir>/<world>/incident-g<generation>/rank<rank>.json`` —
        keyed by the FAILED incarnation's generation, so all ranks of
        one incident land in one directory and ``python3 -m
        rocnrdma_tpu_torch.tools.explain --postmortem`` merges them."""
        timeout = int(self.timeout_ms if timeout_ms is None else timeout_ms)
        note_fault_injections()
        note_integrity()
        # Black-box postmortem BEFORE teardown: the flight recorder's
        # recent past — the incident's evidence — is dumped while it
        # still belongs to the failed incarnation (teardown appends
        # flush noise and the next incarnation overwrites the ring).
        self._write_postmortem(reason)
        self._teardown()
        arbitrated = self.controller is not None
        if arbitrated:
            self._ctl_report_failure()
        else:
            self.generation += 1
        trace.event("world.rebuild", rank=self.rank, phase="begin",
                    generation=self.generation,
                    arbitrated=int(arbitrated))
        # Deterministic per-(seed, rank, generation) jitter:
        # desynchronizes ranks' retry storms without making fault-plan
        # replays flaky (string seeding is stable across processes —
        # no PYTHONHASHSEED dependence).
        seed = rebuild_jitter_seed() if jitter_seed is None else jitter_seed
        rng = random.Random(f"{seed}:{self.rank}:{self.generation}")
        delay = float(backoff_s)
        last: Optional[BaseException] = None
        for attempt in range(1, max_attempts + 1):
            try:
                self._bootstrap(timeout)
                note_fault_injections()
                note_integrity()
                trace.event("world.rebuild", rank=self.rank, phase="ok",
                            generation=self.generation, attempts=attempt)
                if arbitrated:
                    trace.event("ctl.rebuild", rank=self.rank,
                                world_name=self.world_name,
                                generation=self.generation,
                                epoch=self._ctl_epoch, attempts=attempt)
                return self
            except (TransportError, TimeoutError, OSError) as e:
                last = e
                self._teardown()
                if attempt == max_attempts:
                    break
                sleep_s = delay * (1.0 + jitter * rng.random())
                trace.event("world.rebuild", rank=self.rank, phase="retry",
                            generation=self.generation, attempts=attempt,
                            sleep_s=round(sleep_s, 3))
                time.sleep(sleep_s)
                delay = min(delay * 2.0, backoff_cap_s)
        raise TransportError(
            f"world rebuild failed after {max_attempts} attempts (rank "
            f"{self.rank}, generation {self.generation}): {last}",
            retryable=False)

    def _write_postmortem(self, reason: str = "") -> None:
        """Dump the black-box bundle for a dying incarnation. Best
        effort end to end — diagnostics must never take the recovery
        ladder down — and a no-op without TDR_POSTMORTEM_DIR. The ring
        drain is destructive (flight-recorder semantics: the incident
        owns the recent past); counters/histograms are cumulative and
        unaffected. In-process multi-rank harnesses share one native
        ring, so bundles there interleave every co-located rank's
        events — one process per rank (the production shape) gives
        clean per-rank bundles."""
        pm_dir = os.environ.get("TDR_POSTMORTEM_DIR")
        if not pm_dir:
            return
        try:
            from rocnrdma_tpu_torch import telemetry as tel
            from rocnrdma_tpu_torch.transport.engine import telemetry_dropped

            events = tel.timeline() if tel.enabled() else []
            hb = self._hb
            bundle = {
                "format": "tdr-postmortem-v1",
                "world": self.world_name,
                "rank": self.rank,
                "generation": self.generation,
                "incarnation": self._ctl_inc,
                "error": str(reason)[:400],
                "wall_time": time.time(),
                "monotonic_ns": time.monotonic_ns(),
                "digest": self._sched_verified.hex(),
                "seal_config": self.seal_config,
                "coll_seq": self._coll_seq,
                "counters": {k: int(v)
                             for k, v in tel.counters().items()},
                "dropped": int(telemetry_dropped()),
                "clock_offset_ns": (hb.clock.offset_ns
                                    if hb is not None else 0),
                "events": tel.events_to_wire(events),
            }
            d = os.path.join(pm_dir, self.world_name,
                             f"incident-g{self.generation}")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"rank{self.rank}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(bundle, f)
            os.replace(tmp, path)
            self._postmortems += 1
            trace.event("world.postmortem", rank=self.rank,
                        generation=self.generation,
                        events=len(bundle["events"]), path=path)
        except Exception:
            pass

    def _ctl_report_failure(self) -> None:
        """Tell the coordinator this incarnation failed. Best-effort:
        if the coordinator is briefly unreachable, the rendezvous in
        the next bootstrap attempt still adopts whatever view it
        releases (a peer's report, or a lease expiry, moves the
        generation without us)."""
        from rocnrdma_tpu_torch.control.client import ControlError

        try:
            resp = self.controller.report(
                self.world_name, self.rank, self._ctl_inc or 0,
                self.generation, error="retryable transport failure")
            trace.event("ctl.report", rank=self.rank,
                        world_name=self.world_name,
                        generation=int(resp.get("generation",
                                                self.generation)))
        except ControlError:
            trace.event("ctl.report_unreachable", rank=self.rank,
                        world_name=self.world_name)

    def close(self) -> None:
        if self._hb is not None:
            hb, self._hb = self._hb, None
            try:
                hb.stop(flush=True)
            except Exception:
                pass
        if self.controller is not None and self._ctl_inc is not None:
            try:
                self.controller.leave(self.world_name, self.rank,
                                      self._ctl_inc)
            except Exception:
                pass
            self._ctl_inc = None
        self._teardown()
        for mr in (self._dg_smr, self._dg_rmr):
            if mr is not None:
                try:
                    mr.deregister()
                except Exception:
                    pass
        self._dg_smr = self._dg_rmr = None
        self.engine.detach_world(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def local_worlds(n: int, base_port: Optional[int] = None,
                 spec: str = "emu", engines: Optional[List[Engine]] = None,
                 **kwargs) -> List[RingWorld]:
    """Bring up an n-rank ring fully in-process (one Engine per rank,
    one thread per rank during bootstrap) — the test/bench topology.
    ``engines`` reuses caller-owned engines (concurrent-world tests
    share one engine set across several named worlds); ``kwargs``
    forward to RingWorld (controller=, world_name=, channels=, ...)."""
    engines = engines if engines is not None else \
        [Engine(spec) for _ in range(n)]
    out: List[Optional[RingWorld]] = [None] * n
    errs: List[Optional[BaseException]] = [None] * n

    def boot(r: int):
        try:
            out[r] = RingWorld(engines[r], r, n, base_port, **kwargs)
        except BaseException as e:
            errs[r] = e

    threads = [threading.Thread(target=boot, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errs:
        if e is not None:
            raise e
    return [w for w in out if w is not None]
