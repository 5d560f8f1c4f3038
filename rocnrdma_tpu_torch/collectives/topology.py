"""Topology map + size-aware collective algorithm selector.

The port's own copy of ``rocnrdma_tpu/collectives/topology.py``.

Production pods are two-level: fast intra-host links (the CMA tier —
kernel memcpy, tag-only seals) and slow inter-host links (verbs/DCN —
full payload seals). A :class:`TopologyMap` partitions a world's ranks
into intra-host groups by HOST KEY and derives, for each rank, the two
rings the hierarchical allreduce runs over:

- the **intra-host ring**: this rank's co-located group, and
- the **inter-host delegate ring**: one rank per host at this rank's
  local index — rank ``i`` of every host is the delegate for shard
  ``i``, so after the intra reduce-scatter each delegate allreduces
  exactly the shard it owns across hosts, and the intra all-gather
  redistributes. Inter-host bytes shrink by the local group size,
  which is the whole point.

Host keys come from, in priority order: an explicit ``topology=`` list
handed to ``RingWorld``, the ``TDR_TOPOLOGY`` env (comma-separated,
one key per rank — how tests and benches emulate two hosts on one
machine), or the coordinator's released view (``host_keys``, one per
slot, reported at join). A world with one host, one rank per host, or
UNEVEN groups is *flat*: the hierarchical schedule requires the shard
boundaries to agree across hosts, which only holds when every group
has the same size, so non-uniform topologies fall back to the flat
ring rather than approximate.

The **algorithm selector** (``choose_algo``) picks per collective
call, by message size and topology — the message-size-aware switch the
Omni-Path HPC paper templates (PAPERS.md):

- ``flat``: the native fused/wavefront allreduce — lowest latency,
  right for small messages and flat topologies;
- ``hier``: intra reduce-scatter → delegate-ring allreduce →
  intra all-gather, engaged at/above ``TDR_HIER_MIN_BYTES`` (default
  1 MiB) on hierarchical topologies;
- ``staged``: explicit two-phase reduce-scatter + all-gather on the
  flat ring (the textbook composition; a measurement baseline and an
  escape hatch — the fused schedules beat it, SWEEP_W4_r05.json).

``TDR_ALGO=flat|hier|staged|auto`` overrides. Everything the selector
reads is schedule-changing, so ``algo_stamp``/``TopologyMap.stamp``
join the schedule digest (legacy flat worlds contribute nothing — their
digests stay byte-identical).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

_ALGOS = ("flat", "hier", "staged", "auto")


class TopologyMap:
    """Host-key partition of a world, seen from one rank."""

    def __init__(self, host_keys: Sequence[str], rank: int):
        self.host_keys: List[str] = [str(k) for k in host_keys]
        self.world = len(self.host_keys)
        self.rank = int(rank)
        if not (0 <= self.rank < self.world):
            raise ValueError(f"rank {rank} out of range for "
                             f"{self.world} host keys")
        # Hosts in first-appearance order: deterministic from the key
        # list alone, so every rank derives the identical host order
        # (and therefore identical delegate rings).
        self.hosts: List[str] = []
        for k in self.host_keys:
            if k not in self.hosts:
                self.hosts.append(k)
        self.groups = {h: [r for r, k in enumerate(self.host_keys)
                           if k == h] for h in self.hosts}
        self.my_key = self.host_keys[self.rank]
        self.group = self.groups[self.my_key]
        self.local_rank = self.group.index(self.rank)
        self.local_size = len(self.group)
        self.host_index = self.hosts.index(self.my_key)

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def uniform(self) -> bool:
        """All hosts carry the same number of ranks — the condition
        for shard boundaries to agree across hosts."""
        sizes = {len(g) for g in self.groups.values()}
        return len(sizes) == 1

    @property
    def hierarchical(self) -> bool:
        """Whether the two-tier schedule is well-defined AND a win
        shape: >= 2 hosts, >= 2 ranks per host, uniform groups."""
        return (self.n_hosts >= 2 and self.local_size >= 2
                and self.uniform)

    def delegate_ring(self) -> List[int]:
        """Global ranks of this rank's inter-host ring: local index
        ``local_rank`` of every host, in host order."""
        return [self.groups[h][self.local_rank] for h in self.hosts]

    def stamp(self) -> str:
        """Digest term: the shape plus a key-list fingerprint, so two
        ranks with different topology views fail the first collective
        fast instead of building disagreeing tier rings."""
        fp = hashlib.sha256(
            ",".join(self.host_keys).encode()).hexdigest()[:10]
        return f"topo=h{self.n_hosts}x{self.local_size}:{fp}"

    def __repr__(self) -> str:  # debugging/trace ergonomics
        return (f"TopologyMap(hosts={self.n_hosts}, "
                f"local={self.local_size}, rank={self.rank}, "
                f"hier={self.hierarchical})")


def parse_env_topology(world: int) -> Optional[List[str]]:
    """TDR_TOPOLOGY as a host-key list ('a,a,b,b'), or None when
    unset. A set-but-wrong-length value raises: silently ignoring it
    would run flat on some ranks and hierarchical on others."""
    env = os.environ.get("TDR_TOPOLOGY", "").strip()
    if not env:
        return None
    keys = [k.strip() for k in env.split(",")]
    if len(keys) != world or any(not k for k in keys):
        raise ValueError(
            f"TDR_TOPOLOGY={env!r}: expected {world} comma-separated "
            f"host keys, got {len(keys)}")
    return keys


def resolve_topology(world: int, rank: int,
                     explicit: Optional[Sequence[str]] = None,
                     view_keys: Optional[Sequence[str]] = None
                     ) -> Optional[TopologyMap]:
    """Topology for a world, from explicit param > TDR_TOPOLOGY >
    coordinator view host keys. Peer ADDRESSES are deliberately not a
    source: a defaulted world is all-loopback, and inferring locality
    from connect addresses would silently flip algorithms under NAT /
    multi-homed hosts. Returns None (flat) when no source names keys
    or the keys name a single host."""
    keys = None
    if explicit is not None:
        keys = [str(k) for k in explicit]
        if len(keys) != world:
            raise ValueError(f"topology: expected {world} host keys, "
                             f"got {len(keys)}")
    if keys is None:
        keys = parse_env_topology(world)
    if keys is None and view_keys is not None and len(view_keys) == world:
        keys = [str(k) for k in view_keys]
    if keys is None or len(set(keys)) <= 1:
        return None
    return TopologyMap(keys, rank)


def fallback_reason(topo: Optional[TopologyMap]) -> str:
    """Why a RESOLVED multi-host topology cannot carry the
    hierarchical schedule — '' when it can, or when there is nothing
    to fall back FROM (no topology / a single host is flat by design,
    not by degradation). Non-empty exactly for the shapes a fleet
    operator would expect to run hier and silently doesn't: uneven
    host groups (the remainder case) and singleton groups. The string
    is deterministic from the key list alone, so it is digest-safe
    (every rank derives the identical note)."""
    if topo is None or topo.hierarchical or topo.n_hosts < 2:
        return ""
    if not topo.uniform:
        sizes = "x".join(str(len(topo.groups[h])) for h in topo.hosts)
        return f"nonuniform:h{topo.n_hosts}:{sizes}"
    return f"singleton:h{topo.n_hosts}"


def algo_mode() -> str:
    """TDR_ALGO as the selector parses it (default 'auto'); invalid
    values raise rather than silently running a different schedule
    than the operator asked for."""
    mode = os.environ.get("TDR_ALGO", "auto").strip() or "auto"
    if mode not in _ALGOS:
        raise ValueError(f"TDR_ALGO={mode!r}: expected one of {_ALGOS}")
    return mode


def hier_min_bytes() -> int:
    """Message-size threshold for the auto hier switch
    (TDR_HIER_MIN_BYTES, default 1 MiB): below it the flat ring's
    lower phase count wins; above it the inter-host byte reduction
    (factor local_size) dominates."""
    try:
        v = int(os.environ.get("TDR_HIER_MIN_BYTES", str(1 << 20)))
    except ValueError:
        return 1 << 20
    return max(0, v)


def algo_stamp(topo: Optional[TopologyMap]) -> str:
    """Digest term for the selector configuration. Empty for flat
    topologies — legacy digests are preserved byte-for-byte — else the
    mode plus the auto threshold (both schedule-selecting: ranks
    disagreeing on either would post different wire sequences)."""
    if topo is None or not topo.hierarchical:
        return ""
    mode = algo_mode()
    if mode == "auto":
        return f"algo=auto:{hier_min_bytes()}"
    return f"algo={mode}"


def choose_algo(nbytes: int, topo: Optional[TopologyMap]) -> str:
    """Per-call algorithm: 'flat', 'hier', or 'staged'. Deterministic
    from (message size, topology, env) — all digest-covered — so every
    rank picks the same schedule for the same collective."""
    mode = algo_mode()
    hier_ok = topo is not None and topo.hierarchical
    if mode == "flat":
        return "flat"
    if mode == "staged":
        return "staged"
    if mode == "hier":
        return "hier" if hier_ok else "flat"
    # auto: size-aware switch on hierarchical topologies.
    if hier_ok and int(nbytes) >= hier_min_bytes():
        return "hier"
    return "flat"
