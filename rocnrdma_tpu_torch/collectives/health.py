"""Link-health scoring and the degradation ladder (degrade, don't die).

The port's own copy of ``rocnrdma_tpu/collectives/health.py``.

Every completed collective phase reports its per-link goodput here;
stall/probe/retransmit evidence lands as explicit fault penalties. The
registry keeps one EWMA score per (world, link), normalized against the
best goodput that link has ever sustained, so "healthy" is defined by
the link's own history — no absolute MB/s threshold to mis-tune.

The score of DELEGATE (inter-host) links drives a three-rung ladder,
mildest rung first (intra links are scored and reported but never
steer the schedule — see ``_gates_schedule``):

  score < TDR_HEALTH_WIRE (default 0.75)
      -> per-link wire-dtype downgrade: float32 payloads crossing the
         degraded delegate link are quantized to bf16 precision
         (mantissa truncation) before the inter-host phase — the
         precision contract changes, digest-stamped so every rank
         agrees or fails fast.
  score < TDR_HEALTH_WIRE_INT8 (default 0.6)
      -> deeper wire downgrade: the delegate payload rides the int8
         scale-carrying q8 schedule (half the bf16 bytes). Engages
         only when the transport negotiated FEAT_WIRE_Q8
         (TDR_NO_WIRE_Q8 unset); digest-stamped ``hwire=int8``,
         shadowing the bf16 term.
  score < TDR_HEALTH_FALLBACK (default 0.5)
      -> hierarchical -> flat algorithm fallback: the schedule stops
         riding the sick delegate link entirely (``choose_algo``
         consumes this via ``RingWorld._algo_for``).

Engagement is evidence-gated twice over: goodput (soft) evidence must
stay below the rung threshold for TDR_HEALTH_ENGAGE_STREAK (default 3)
consecutive samples — one slow phase is scheduler noise, a run of them
is a link — while fault() (hard) evidence engages immediately.

Both rungs sit BELOW the existing escalation machinery: a link the
ladder keeps usable never reaches the collective deadline, the probe,
or the rebuild. TDR_NO_DEGRADE=1 disables the ladder (scores still
accumulate for observability) so the escalation path itself stays
testable. Scores heal through the same EWMA: sustained good phases
raise the score past the rung threshold plus hysteresis
(TDR_HEALTH_HEAL margin) and the rung disengages.

Scheduling consistency: the hier-vs-flat decision is never read live —
``schedule_verdict`` freezes ONE verdict per (world, collective seq),
because rung state can flip mid-window under another rank's
observe/fault and ranks reading it live would split across hier/flat
schedules and deadlock. The registry is process-global, so in-process
multi-rank harnesses (tests, single-host soaks) agree by construction;
multi-process ranks can transiently disagree — the schedule digest
(``health_stamp`` term) turns that into a retryable first-collective
failure, never silent divergence; the next collective re-agrees after
both sides' scores converge.

Scores survive ``rebuild()`` deliberately: a rebuilt world on the same
sick link should come back already degraded, not rediscover the
problem at full speed. ``reset()`` is for tests and world close.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from rocnrdma_tpu_torch.utils.trace import trace

__all__ = [
    "observe", "fault", "score", "fallback_active", "wire_downgrade",
    "wire_int8", "degraded_links", "snapshot", "degraded_total",
    "reset", "ladder_enabled", "schedule_verdict", "wire_verdict",
]


def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    try:
        v = float(os.environ.get(name, ""))
    except ValueError:
        return default
    if not (lo <= v <= hi):
        return default
    return v


def _gates_schedule(link: str) -> bool:
    """Only delegate (inter-host) links drive the ladder. Both rungs
    specifically mitigate the DELEGATE link — the bf16 downgrade
    applies to the inter-host payload, and hier->flat stops riding the
    delegate ring — so a slow intra link must never engage them: the
    flat schedule rides the intra links too (falling back buys
    nothing), and in-process intra phase timing is dominated by
    thread-scheduling noise, not link bandwidth. Intra links are still
    scored and reported (snapshot / tdr_link_health), just never
    allowed to steer the schedule."""
    return link.startswith("inter")


def ladder_enabled() -> bool:
    """False under TDR_NO_DEGRADE=1: scoring continues (observability)
    but no rung engages — failures escalate to deadline/probe/rebuild."""
    return os.environ.get("TDR_NO_DEGRADE", "0") in ("", "0")


class _Link:
    __slots__ = ("peer", "ewma", "peak", "samples", "faults",
                 "wire_down", "wire_int8", "fallback", "streak")

    def __init__(self, peer: int):
        self.peer = peer
        self.ewma = 0.0    # EWMA goodput, MB/s
        self.peak = 0.0    # best goodput ever sustained (EWMA'd too)
        self.samples = 0
        self.faults = 0
        # Engaged rungs (hysteresis state — see _requalify).
        self.wire_down = False
        self.wire_int8 = False
        self.fallback = False
        # Consecutive below-threshold evaluations per rung
        # [wire, fallback, wire_int8]: soft (goodput) evidence must
        # persist for TDR_HEALTH_ENGAGE_STREAK samples before a rung
        # engages — a single slow phase is scheduler noise, three in a
        # row is a link. fault() evidence is hard and bypasses the
        # streak.
        self.streak = [0, 0, 0]


class _Registry:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        # world_name -> link_name -> _Link
        self._worlds: Dict[str, Dict[str, _Link]] = {}
        self._degraded_total: Dict[str, int] = {}
        # (world -> {coll seq -> 'hier'|'flat'|'canary'}) — frozen
        # per-collective schedule verdicts (see schedule_verdict).
        self._verdicts: Dict[str, Dict[int, str]] = {}
        # (world -> {coll seq -> 'f32'|'bf16'|'int8'}) — frozen
        # per-collective wire verdicts (see wire_verdict).
        self._wire_verdicts: Dict[str, Dict[int, str]] = {}

    # ------------------------------------------------------------ feed

    def observe(self, world: str, link: str, peer: int,
                nbytes: int, seconds: float) -> None:
        if seconds <= 0.0 or nbytes <= 0:
            return
        # Tiny phases measure latency and scheduler jitter, not link
        # bandwidth — feeding them to the EWMA would degrade healthy
        # links on pure noise (in-process test harnesses interleave
        # threads 10x). Below the floor the phase is ignored; fault()
        # evidence always lands.
        if nbytes < int(_env_float("TDR_HEALTH_MIN_BYTES",
                                   float(1 << 20), 0.0, 1e12)):
            return
        mbps = (nbytes / 1e6) / seconds
        alpha = _env_float("TDR_HEALTH_ALPHA", 0.3, 0.01, 1.0)
        with self._mu:
            ln = self._link(world, link, peer)
            ln.samples += 1
            ln.ewma = mbps if ln.samples == 1 else \
                (1.0 - alpha) * ln.ewma + alpha * mbps
            # The peak chases the EWMA up, never down: a link's best
            # SUSTAINED rate, not a single lucky phase (one outlier
            # phase must not redefine healthy and degrade everything
            # after it).
            if ln.ewma > ln.peak:
                ln.peak = ln.ewma
            self._requalify(world, link, ln)

    def fault(self, world: str, link: str, peer: int,
              kind: str = "stall") -> None:
        """Hard evidence (stall expiry, probe timeout, collective
        deadline, retransmit burst): halve the score immediately —
        waiting for the EWMA to drift down would let the next
        collective ride a link we already know is sick."""
        with self._mu:
            ln = self._link(world, link, peer)
            ln.faults += 1
            if ln.samples == 0:
                # No goodput history yet: seed a fully-degraded score
                # so the ladder can still engage on fault evidence.
                ln.samples = 1
                ln.peak = 1.0
                ln.ewma = 0.0
            else:
                ln.ewma *= 0.5
            trace.event("health.fault", world_name=world, link=link,
                        peer=peer, kind=kind, faults=ln.faults)
            self._requalify(world, link, ln, hard=True)

    # --------------------------------------------------------- queries

    def score(self, world: str, link: str) -> float:
        with self._mu:
            ln = self._worlds.get(world, {}).get(link)
            if ln is None or ln.peak <= 0.0:
                return 1.0
            s = ln.ewma / ln.peak
            return 1.0 if s > 1.0 else s

    def fallback_active(self, world: str) -> bool:
        if not ladder_enabled():
            return False
        with self._mu:
            return any(ln.fallback
                       for ln in self._worlds.get(world, {}).values())

    def wire_downgrade(self, world: str) -> bool:
        """Any link on its wire rung: like ``fallback_active``, the
        decision is world-scoped so every in-process rank answers the
        same way (the digest stamp carries it across processes)."""
        if not ladder_enabled():
            return False
        with self._mu:
            return any(ln.wire_down
                       for ln in self._worlds.get(world, {}).values())

    def wire_int8(self, world: str) -> bool:
        """Any link on the int8 rung (the one below bf16). Gated on
        the q8 schedule being NEGOTIABLE (TDR_NO_WIRE_Q8 unset) here —
        not just at engagement time — so the digest stamp and the
        schedule the world actually runs can never disagree."""
        if not ladder_enabled():
            return False
        if os.environ.get("TDR_NO_WIRE_Q8", "0") not in ("", "0"):
            return False
        with self._mu:
            return any(ln.wire_int8
                       for ln in self._worlds.get(world, {}).values())

    def degraded_links(self, world: str) -> Dict[str, int]:
        """{link_name: peer_rank} for links with ANY engaged rung —
        what quarantine reporting and ``tdr_explain`` attribute
        straggling ranks to."""
        with self._mu:
            return {name: ln.peer
                    for name, ln in self._worlds.get(world, {}).items()
                    if ln.fallback or ln.wire_down or ln.wire_int8}

    def snapshot(self, world: str) -> Dict[str, Dict[str, float]]:
        """Heartbeat payload: per-link score/peer/rung state, served
        by the coordinator as tdr_link_health{world=,rank=,peer=}."""
        out: Dict[str, Dict[str, float]] = {}
        with self._mu:
            for name, ln in self._worlds.get(world, {}).items():
                s = 1.0 if ln.peak <= 0.0 else min(1.0, ln.ewma / ln.peak)
                out[name] = {"peer": ln.peer, "score": round(s, 4),
                             "degraded": int(ln.fallback or ln.wire_down
                                             or ln.wire_int8),
                             "faults": ln.faults}
        return out

    def degraded_total(self, world: str) -> int:
        with self._mu:
            return self._degraded_total.get(world, 0)

    def schedule_verdict(self, world: str, seq: int) -> str:
        """'hier' | 'flat' | 'canary' — ONE frozen verdict per (world,
        collective sequence number). The fallback rung can flip at any
        moment (another rank's observe/fault lands mid-window), so the
        live rung state must never be read per rank at schedule time:
        rank A reading "healthy" (hier) while rank B reads "degraded"
        (flat) for the SAME collective is a guaranteed cross-schedule
        deadlock. The first rank to ask locks the answer for that seq;
        everyone else replays it. ``seq`` is the caller's per-world
        collective counter, identical fleet-wide by the SPMD contract
        (multi-process ranks each freeze their own registry's verdict;
        disagreement there is caught by the digest's health stamp —
        retryable fail-fast, never silent divergence).

        'canary': every TDR_HEALTH_PROBE_EVERY-th (default 8)
        candidate runs hier ANYWAY while degraded, re-measuring the
        sick delegate link so the score can heal — without it an
        engaged fallback would be permanent (the flat path never
        touches the delegate link again). 0 disables canaries
        (fallback becomes one-way until reset)."""
        if not ladder_enabled():
            return "hier"
        seq = int(seq)
        with self._mu:
            dec = self._verdicts.setdefault(world, {})
            v = dec.get(seq)
            if v is None:
                engaged = any(
                    ln.fallback
                    for ln in self._worlds.get(world, {}).values())
                if not engaged:
                    v = "hier"
                else:
                    n = int(_env_float("TDR_HEALTH_PROBE_EVERY",
                                       8, 0, 1e9))
                    v = "canary" if n > 0 and seq % n == 0 else "flat"
                dec[seq] = v
                if len(dec) > 256:  # bound the memory; old seqs are dead
                    for k in sorted(dec)[:128]:
                        del dec[k]
            return v

    def wire_verdict(self, world: str, seq: int) -> str:
        """'f32' | 'bf16' | 'int8' — ONE frozen wire verdict per
        (world, collective sequence number), the wire-rung twin of
        ``schedule_verdict``. The bf16 rung only truncates mantissas
        in place (same ring schedule, same byte counts), so ranks
        transiently split across f32/bf16 still interoperate; the int8
        rung swaps the WIRE SCHEDULE itself (the scale-carrying q8
        piece format), so rank A reading the rung live as engaged
        while rank B reads it disengaged for the SAME collective runs
        mismatched schedules into a deadlock. The first rank to ask
        locks the answer for that seq; everyone else replays it
        (multi-process ranks each freeze their own registry's verdict;
        the digest's health stamp catches disagreement there)."""
        if not ladder_enabled():
            return "f32"
        seq = int(seq)
        with self._mu:
            dec = self._wire_verdicts.setdefault(world, {})
            v = dec.get(seq)
            if v is None:
                links = self._worlds.get(world, {}).values()
                q8_ok = os.environ.get("TDR_NO_WIRE_Q8",
                                       "0") in ("", "0")
                if q8_ok and any(ln.wire_int8 for ln in links):
                    v = "int8"
                elif any(ln.wire_down for ln in links):
                    v = "bf16"
                else:
                    v = "f32"
                dec[seq] = v
                if len(dec) > 256:  # bound the memory; old seqs are dead
                    for k in sorted(dec)[:128]:
                        del dec[k]
            return v

    def reset(self, world: Optional[str] = None) -> None:
        with self._mu:
            if world is None:
                self._worlds.clear()
                self._degraded_total.clear()
                self._verdicts.clear()
                self._wire_verdicts.clear()
            else:
                self._worlds.pop(world, None)
                self._degraded_total.pop(world, None)
                self._verdicts.pop(world, None)
                self._wire_verdicts.pop(world, None)

    # ------------------------------------------------------- internals

    def _link(self, world: str, link: str, peer: int) -> _Link:
        links = self._worlds.setdefault(world, {})
        ln = links.get(link)
        if ln is None:
            ln = links[link] = _Link(peer)
        elif peer >= 0:
            ln.peer = peer  # a RESIZE can re-seat the neighbor
        return ln

    def _requalify(self, world: str, link: str, ln: _Link,
                   hard: bool = False) -> None:
        """Engage/heal rungs with hysteresis (caller holds the lock).
        Engaging needs the score BELOW the rung threshold for
        TDR_HEALTH_ENGAGE_STREAK consecutive evaluations (``hard``
        fault evidence engages immediately); healing needs it ABOVE
        threshold + TDR_HEALTH_HEAL, so a link oscillating around the
        line doesn't flap the schedule. The streak is what keeps
        in-process emulation honest: one phase 2-4x off its peak is
        scheduler jitter, a RUN of them is a link."""
        if not _gates_schedule(link):
            return
        min_samples = int(_env_float("TDR_HEALTH_MIN_SAMPLES", 3, 1, 64))
        if ln.samples < min_samples and ln.faults == 0:
            return
        s = 1.0 if ln.peak <= 0.0 else ln.ewma / ln.peak
        wire_thr = _env_float("TDR_HEALTH_WIRE", 0.75, 0.0, 1.0)
        int8_thr = _env_float("TDR_HEALTH_WIRE_INT8", 0.6, 0.0, 1.0)
        fb_thr = _env_float("TDR_HEALTH_FALLBACK", 0.5, 0.0, 1.0)
        heal = _env_float("TDR_HEALTH_HEAL", 0.1, 0.0, 0.5)
        need = int(_env_float("TDR_HEALTH_ENGAGE_STREAK", 3, 1, 64))
        rungs = (("wire_down", wire_thr, 0), ("wire_int8", int8_thr, 2),
                 ("fallback", fb_thr, 1))
        for attr, thr, si in rungs:
            engaged = getattr(ln, attr)
            if not engaged and s < thr:
                ln.streak[si] += 1
                if not hard and ln.streak[si] < need:
                    continue
                setattr(ln, attr, True)
                self._degraded_total[world] = \
                    self._degraded_total.get(world, 0) + 1
                trace.add("health.degraded", 1)
                trace.event("health.degrade", world_name=world,
                            link=link, peer=ln.peer, rung=attr,
                            score=round(s, 4))
            elif engaged and s > min(1.0, thr + heal):
                setattr(ln, attr, False)
                ln.streak[si] = 0
                trace.event("health.heal", world_name=world, link=link,
                            peer=ln.peer, rung=attr, score=round(s, 4))
            elif not engaged:
                ln.streak[si] = 0


_REG = _Registry()

observe = _REG.observe
fault = _REG.fault
score = _REG.score
fallback_active = _REG.fallback_active
wire_downgrade = _REG.wire_downgrade
wire_int8 = _REG.wire_int8
degraded_links = _REG.degraded_links
snapshot = _REG.snapshot
degraded_total = _REG.degraded_total
schedule_verdict = _REG.schedule_verdict
wire_verdict = _REG.wire_verdict
reset = _REG.reset
