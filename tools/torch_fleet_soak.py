#!/usr/bin/env python3
"""Autoscaling fleet soak for the PyTorch port: elastic RESIZE +
coordinator failover gate. The port's counterpart of
``tools/fleet_soak.py``, the same drive over the port's own copies
(``rocnrdma_tpu_torch.control``, ``.collectives.world``,
``.transport.engine``) and ``tools/torch_fault_soak.py``'s thread
census.

    python3 tools/torch_fleet_soak.py                         # 8 rounds
    TDR_FLEET_SOAK_LITE=1 python3 tools/torch_fleet_soak.py   # 6 rounds

A SUBPROCESS coordinator (``python -m rocnrdma_tpu_torch.tools.rendezvous``
with periodic state snapshots, weighted fair-share QP division, and
heartbeat/scrape rate limits armed) arbitrates 12 named worlds that
churn join/leave/flap while driving bitwise-checked int32 allreduces,
two of them elastic:

- ``elastic-shrink`` (world 3, resizable): one member leaves mid-soak;
  the survivors' next collective fails retryably, they re-park, and
  the coordinator cuts a world_size-1 RESIZE view — they finish the
  soak at size 2 under a bumped generation.
- ``elastic-grow`` (world 2, resizable, max_size 3): a third member
  joins the FULL world and parks; the incumbents re-park at their next
  collective boundary (the heartbeat resize hint, or the explicit
  rebuild the trainer ladder would issue) and the coordinator cuts the
  world_size+1 view — the soak finishes at 3.

Mid-soak the coordinator process is SIGKILLed and restarted with
``--restore``: it resumes arbitration from the latest snapshot at the
SAME address (generations, incarnations, resize counts intact), the
members re-attach by simply continuing to heartbeat, and one world
flaps AFTER the failover to prove arbitrated rebuild still works.

Gates (all must hold; the verdict JSON carries each):

- bitwise parity on every completed collective, in every world, at
  every size the world passed through;
- both RESIZEs observed member-side (``w.world`` changed) AND served
  on /metrics: summed ``tdr_ctl_resizes_total`` >= 2 post-recovery;
- ``tdr_ctl_failovers_total`` >= 1 post-recovery, and at least one
  arbitrated rebuild completed THROUGH the restored coordinator;
- per-world generations monotone across every successful scrape,
  including across the failover;
- admission control observable: a join to a full non-resizable world
  is refused RETRYABLE with a deterministic retry-after, a scrape
  burst hits the 429 rate limit, a heartbeat burst gets throttled
  (lease still renewed), and the weighted fair share divides the QP
  pool (the weight-2 world's share beats a weight-1 world's);
- zero leaked heartbeat threads after every world closed.

Numpy-only: the members reduce numpy int32 buffers on the port's
``libtdr`` and touch no device, on the card's host as anywhere. The
sanitized sweep (``tests/test_torch_sanitize.py``) runs the lite drive
against ``libtdr_san.so`` with ASan preloaded; the members run no torch
operation that could throw a C++ exception (under ASan any such
exception aborts the process), and the coordinator child imports no
torch.

Prints a ``FLEET_RUN {json}`` line (the drive's seconds and the
coordinator child's seconds to a healthy ``/healthz``, at its first
start and at its ``--restore`` after the SIGKILL), then the
reference's verdict JSON with the reference's keys; exits 0 only if
every gate held.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.dirname(os.path.abspath(__file__))
for _p in (REPO, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

LITE = os.environ.get("TDR_FLEET_SOAK_LITE", "0") not in ("", "0")

# Gate-pinned metric names (tests/test_fleet_soak.py and
# tests/test_torch_fleet_soak.py pin the same).
PINNED = (
    "tdr_ctl_resizes_total{",
    "tdr_ctl_failovers_total",
    "tdr_ctl_qp_share{",
    "tdr_ctl_qp_reserved{",
    "tdr_ctl_admission_rejects_total{",
    "tdr_ctl_snapshot_age_s",
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_coordinator(port: int, port_base: int, snapshot_dir: str,
                      lease_ms: int, qp_budget: int,
                      restore: bool = False) -> subprocess.Popen:
    """The coordinator as a real process — the only shape a SIGKILL
    failover test means anything for. The port's rendezvous runs as a
    module (``-m``) from the repo root, where its package resolves. It
    imports no torch and loads no native library (a pure-python child),
    so the sanitized variant's LD_PRELOAD rides along safely."""
    cmd = [sys.executable, "-m", "rocnrdma_tpu_torch.tools.rendezvous",
           "--host", "127.0.0.1", "--port", str(port),
           "--lease-ms", str(lease_ms),
           "--port-base", str(port_base), "--port-stride", "64",
           "--snapshot-dir", snapshot_dir,
           "--snapshot-interval", "0.25",
           "--qp-budget", str(qp_budget), "--qp-fair", "--qp-floor", "2",
           "--hb-min-interval-ms", "100",
           "--scrape-min-interval-ms", "100"]
    if restore:
        cmd.append("--restore")
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def wait_health(port: int, timeout_s: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=1.0) as s:
                s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
                if b"200" in s.recv(256):
                    return True
        except OSError:
            pass
        time.sleep(0.1)
    return False


def metric_sum(text: str, prefix: str) -> float:
    """Sum every series whose name (incl. label block) starts with
    ``prefix`` — ``metric_sum(body, "tdr_ctl_resizes_total{")`` is the
    fleet-wide resize count."""
    total = 0.0
    for ln in text.splitlines():
        if ln.startswith(prefix):
            try:
                total += float(ln.rsplit(None, 1)[1])
            except (IndexError, ValueError):
                pass
    return total


def metric_world(text: str, name: str, world: str) -> float:
    for ln in text.splitlines():
        if ln.startswith(f'{name}{{world="{world}"}}'):
            try:
                return float(ln.rsplit(None, 1)[1])
            except (IndexError, ValueError):
                return 0.0
    return 0.0


def _boot_world(mk, attempts: int = 30, backoff_s: float = 0.3):
    """Construct a RingWorld through coordinator weather: a rendezvous
    refusal or an unreachable coordinator (the failover window) is
    retryable by contract, and a soak member must outlive it."""
    from rocnrdma_tpu_torch.transport.engine import TransportError

    last = None
    for _ in range(attempts):
        try:
            return mk()
        except TransportError as e:
            if not getattr(e, "retryable", False):
                raise
            last = e
            time.sleep(backoff_s)
    raise RuntimeError(f"world never came up: {last}")


def _checked_allreduce(w, value: int, label: str, budget: int = 16,
                       rebuild_attempts: int = 12,
                       rebuild_timeout_ms: int = 10000,
                       stop_ev=None) -> None:
    """One bitwise-checked int32 allreduce with the full elastic retry
    ladder: every member contributes ``value * (rank+1)``, so the
    expected sum is ``value * n(n+1)/2`` for whatever size ``n`` the
    world has WHEN THE COLLECTIVE COMPLETES — the parity predicate is
    resize-aware by construction (the schedule digest already
    guarantees all participants agreed on n)."""
    import numpy as np

    from rocnrdma_tpu_torch.transport.engine import TransportError

    last = None
    for _ in range(budget):
        if stop_ev is not None and stop_ev.is_set():
            raise RuntimeError(f"{label}: stopped")
        buf = np.full(512, value * (w.rank + 1), dtype=np.int32)
        try:
            w.allreduce(buf)
        except TransportError as e:
            if not getattr(e, "retryable", False):
                raise
            last = e
            try:
                w.rebuild(max_attempts=rebuild_attempts,
                          backoff_s=0.05, backoff_cap_s=1.0,
                          timeout_ms=rebuild_timeout_ms,
                          reason=str(e))
            except TransportError as e2:
                # Rebuild budget exhausted (e.g. the coordinator was
                # down for the whole attempt window): the outer budget
                # paces another full rebuild cycle.
                last = e2
            continue
        n = w.world
        exp = np.int32(value * n * (n + 1) // 2)
        if not (buf == exp).all():
            raise AssertionError(
                f"{label}: diverged at size {n} "
                f"(got {int(buf[0])}, want {int(exp)})")
        return
    raise RuntimeError(f"{label}: collective never converged "
                       f"after {budget} attempts: {last}")


def run_fleet(rounds: int = 8, lease_ms: int = 2500,
              snapshot_dir: str = None, runs: dict = None) -> dict:
    """Run the full soak; returns the verdict dict (see module doc).
    ``rounds`` is the per-world collective count (the last two rounds
    are the post-failover tail). A ``runs`` dict, where given, receives
    the coordinator child's seconds from spawn to a healthy
    ``/healthz`` (``coordinator_healthy_s``, ``restored_healthy_s``)
    and the failover's outage, from the SIGKILL to the restored child's
    health (``failover_outage_s``)."""
    runs = {} if runs is None else runs
    import numpy as np  # noqa: F401  (fail fast, before any threads)

    from rocnrdma_tpu_torch.collectives.world import RingWorld
    from rocnrdma_tpu_torch.control.client import ControlClient, ControlError
    from rocnrdma_tpu_torch.transport.engine import Engine, TransportError
    from rocnrdma_tpu_torch.utils.trace import trace

    from torch_fault_soak import hb_thread_census

    rounds = max(6, int(rounds))
    kill_round = rounds - 2  # members park here until the failover
    n_fleet = 10             # + 2 elastic = 12 named worlds
    qp_budget = 130
    # The soak's budgets (members park <=90 s for the failover, the
    # rebuild ladders pace in seconds) assume the ring STALL deadline
    # fires well inside them: a departed peer must fail its
    # survivors' collective promptly or the shrink/grow RESIZEs land
    # late and the members outrun the failover window entirely. The
    # ambient env may raise TDR_RING_TIMEOUT_MS far past that (the
    # test suite pins 120 s to keep slow collective tests off the
    # deadline under load) — clamp it to the 30 s default the soak
    # was sized against, and restore it on the way out.
    ring_ms_prev = os.environ.get("TDR_RING_TIMEOUT_MS")
    try:
        if int(ring_ms_prev or 0) > 30000:
            os.environ["TDR_RING_TIMEOUT_MS"] = "30000"
    except ValueError:
        pass
    own_snapdir = snapshot_dir is None
    if own_snapdir:
        snapshot_dir = tempfile.mkdtemp(prefix="tdr_fleet_snap_")
    port = _free_port()
    port_base = _free_port()
    address = f"127.0.0.1:{port}"
    t_spawn = time.monotonic()
    proc = spawn_coordinator(port, port_base, snapshot_dir, lease_ms,
                             qp_budget)
    healthy = wait_health(port)
    runs["coordinator_healthy_s"] = round(time.monotonic() - t_spawn, 3)
    if not healthy:
        proc.kill()
        raise RuntimeError("coordinator never became healthy")
    client = ControlClient(address)

    hb_base = hb_thread_census()
    engines = [Engine("emu") for _ in range(3)]
    errs: dict = {}
    completed: dict = {}
    lock = threading.Lock()
    restored = threading.Event()
    grow_armed = threading.Event()   # the grow joiner is parked
    shrink_done = threading.Event()
    grow_done = threading.Event()
    stop_joiner = threading.Event()
    gen_violations: list = []
    scrapes: list = []
    stop_scraper = threading.Event()

    def note_done(name):
        with lock:
            completed[name] = completed.get(name, 0) + 1

    def note_err(label, e):
        with lock:
            errs[label] = e

    # ---- scraper: /metrics throughout, generation monotonicity ----

    def scraper():
        last_gen: dict = {}
        while not stop_scraper.wait(0.7):
            try:
                text = client.metrics()
            except Exception:
                continue  # outage / rate limit: skip, never violate
            with lock:
                scrapes.append(text)
            for line in text.splitlines():
                if not line.startswith("tdr_ctl_generation{"):
                    continue
                wname = line.split('world="', 1)[1].split('"', 1)[0]
                gen = float(line.rsplit(None, 1)[1])
                if gen < last_gen.get(wname, gen):
                    gen_violations.append((wname, last_gen[wname], gen))
                last_gen[wname] = gen

    scraper_t = threading.Thread(target=scraper, daemon=True,
                                 name="fleet-scraper")
    scraper_t.start()

    # ---- member scripts ----

    def fleet_member(name, slot, flap_round, leave_round,
                     post_flap_round):
        w = None
        try:
            w = _boot_world(lambda: RingWorld(
                engines[slot], slot, 2, None, timeout_ms=15000,
                channels=1, controller=address, world_name=name))
            for i in range(rounds):
                if i == kill_round:
                    restored.wait(90)
                if slot == 1 and i == flap_round:
                    w._teardown()  # the flap: die before posting
                if slot == 1 and i == leave_round:
                    # Leave + rejoin churn: a clean departure (the
                    # coordinator sees the leave op, not a lease
                    # expiry) and a fresh join taking the freed slot
                    # under a new incarnation, rank auto-assigned.
                    w.close()
                    w = _boot_world(lambda: RingWorld(
                        engines[slot], -1, 2, None, timeout_ms=15000,
                        channels=1, controller=address,
                        world_name=name))
                if slot == 1 and i == post_flap_round:
                    w._teardown()  # post-failover arbitrated rebuild
                _checked_allreduce(w, i + 1, f"{name}/r{slot}")
                note_done(name)
                time.sleep(0.02)
        except BaseException as e:
            note_err(f"{name}/r{slot}", e)
        finally:
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass

    def shrink_member(slot):
        name = "elastic-shrink"
        w = None
        try:
            w = _boot_world(lambda: RingWorld(
                engines[slot], slot, 3, None, timeout_ms=15000,
                channels=1, controller=address, world_name=name,
                resizable=True))
            if slot == 2:
                # The leaver: two joint rounds, then a clean leave —
                # the survivors' next collective fails retryably and
                # the coordinator cuts the world_size-1 view.
                for _ in range(2):
                    _checked_allreduce(w, 1, f"{name}/r{slot}")
                    note_done(name)
                w.close()
                w = None
                return
            for i in range(rounds):
                if i == kill_round:
                    restored.wait(90)
                _checked_allreduce(w, 1, f"{name}/r{slot}")
                note_done(name)
                if w.world == 2:
                    shrink_done.set()
                time.sleep(0.02)
        except BaseException as e:
            note_err(f"{name}/r{slot}", e)
        finally:
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass

    def grow_member(slot):
        name = "elastic-grow"
        w = None
        try:
            w = _boot_world(lambda: RingWorld(
                engines[slot], slot, 2, None, timeout_ms=15000,
                channels=1, controller=address, world_name=name,
                resizable=True, max_size=3, weight=2.0))
            for i in range(rounds):
                if i == 2:
                    # The joiner is parked (grow_armed): re-park at
                    # this collective boundary so the coordinator can
                    # cut the world_size+1 view. The heartbeat hint
                    # may already have flagged _resize_pending — the
                    # explicit rebuild and the hint-triggered one are
                    # the same ladder.
                    grow_armed.wait(60)
                    try:
                        w.rebuild(max_attempts=12, backoff_s=0.05,
                                  backoff_cap_s=1.0, timeout_ms=10000,
                                  reason="grow boundary")
                    except TransportError:
                        pass  # the round below retries through it
                if i == kill_round:
                    restored.wait(90)
                _checked_allreduce(w, 1, f"{name}/r{slot}")
                note_done(name)
                if w.world == 3:
                    grow_done.set()
                time.sleep(0.02)
        except BaseException as e:
            note_err(f"{name}/r{slot}", e)
        finally:
            stop_joiner.set()  # incumbents done (or dead): release it
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass

    def grow_joiner():
        """Joins the FULL elastic-grow world mid-soak: the coordinator
        parks it on the slot past the end until the incumbents re-park,
        then the RESIZE view admits it at rank 2. From then on it just
        keeps the ring populated until the incumbents finish."""
        name = "elastic-grow"
        w = None
        try:
            w = _boot_world(lambda: RingWorld(
                engines[2], -1, 2, None, timeout_ms=30000, channels=1,
                controller=address, world_name=name, resizable=True,
                max_size=3, weight=2.0))
            grow_done.set()
            while not stop_joiner.is_set():
                try:
                    # Deliberately SHORT rebuild budgets: the joiner
                    # must cycle back to the stop check fast once the
                    # incumbents depart, or it parks at the rendezvous
                    # long past the shutdown join and leaks its world
                    # (heartbeat thread included) into engine close.
                    _checked_allreduce(w, 1, f"{name}/joiner", budget=3,
                                       rebuild_attempts=2,
                                       rebuild_timeout_ms=3000,
                                       stop_ev=stop_joiner)
                    note_done(name)
                except Exception:
                    # Peers gone (shutdown) or a failover window the
                    # budget did not cover: pace and retry — the
                    # incumbents' stop flag is the only exit.
                    time.sleep(0.2)
        except BaseException as e:
            if not stop_joiner.is_set():
                note_err(f"{name}/joiner", e)
        finally:
            if w is not None:
                try:
                    w.close()
                except Exception:
                    pass

    threads = []
    for i in range(n_fleet):
        name = f"fleet-{i:02d}"
        # Every world churns: even worlds flap, odd worlds leave +
        # rejoin, at staggered rounds; fleet-03 flaps AGAIN after the
        # failover (the post-recovery arbitrated-rebuild proof).
        flap_round = 2 + (i % 3) if i % 2 == 0 else -1
        leave_round = 2 + (i % 3) if i % 2 == 1 else -1
        post_flap_round = rounds - 1 if i == 3 else -1
        for slot in range(2):
            threads.append(threading.Thread(
                target=fleet_member,
                args=(name, slot, flap_round, leave_round,
                      post_flap_round),
                name=f"{name}-r{slot}"))
    for slot in range(3):
        threads.append(threading.Thread(target=shrink_member,
                                        args=(slot,),
                                        name=f"elastic-shrink-r{slot}"))
    for slot in range(2):
        threads.append(threading.Thread(target=grow_member,
                                        args=(slot,),
                                        name=f"elastic-grow-r{slot}"))
    for t in threads:
        t.start()

    # The grow joiner arrives once the grow world is churning; the
    # incumbents hold their round-2 boundary until it is PARKED at the
    # coordinator (alive members == 3 on /metrics).
    time.sleep(0.8)
    joiner_t = threading.Thread(target=grow_joiner, name="grow-joiner")
    joiner_t.start()

    def arm_grow():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not grow_armed.is_set():
            try:
                body = client.metrics()
                if metric_world(body, "tdr_ctl_members",
                                "elastic-grow") >= 3:
                    grow_armed.set()
                    return
            except Exception:
                pass
            time.sleep(0.3)
        grow_armed.set()  # let the members proceed; the gate will tell

    arm_t = threading.Thread(target=arm_grow, name="grow-armer")
    arm_t.start()

    verdict = {"lite": LITE, "rounds": rounds, "worlds": n_fleet + 2}
    admission = {}
    coord_proc = proc
    pre = final = ""
    try:
        # ---- wait for both RESIZEs, then fail the coordinator over --
        resizes_ok = (shrink_done.wait(120) and grow_done.wait(120))
        verdict["resizes_observed"] = resizes_ok
        # Quiet-window snapshot: generations are stable while members
        # park at the kill_round gate, so the last periodic snapshot
        # the SIGKILL leaves behind matches the live state.
        time.sleep(1.0)
        t_kill = time.monotonic()
        coord_proc.send_signal(signal.SIGKILL)
        coord_proc.wait(timeout=10)
        time.sleep(0.5)  # a visible outage window
        t_spawn = time.monotonic()
        coord_proc = spawn_coordinator(port, port_base, snapshot_dir,
                                       lease_ms, qp_budget,
                                       restore=True)
        verdict["restored_healthy"] = wait_health(port)
        now = time.monotonic()
        runs["restored_healthy_s"] = round(now - t_spawn, 3)
        runs["failover_outage_s"] = round(now - t_kill, 3)
        # Post-failover baseline: scraped from the RESTORED coordinator
        # BEFORE releasing the parked members, so the rebuild gate
        # compares against the restored state itself. (Comparing
        # against a pre-kill scrape races the snapshot interval: any
        # rebuild landing inside that staleness window makes the
        # restored counter start below the pre-kill value, and the
        # deliberate post-failover flap only brings it back level.)
        for _ in range(20):
            try:
                pre = client.metrics()
                break
            except (ControlError, OSError):
                time.sleep(0.15)
        restored.set()

        # ---- admission-control probes against the restored state ----
        burst_throttled = 0
        for _ in range(5):
            try:
                client.metrics()
            except ControlError:
                burst_throttled += 1
        admission["scrape_throttled"] = burst_throttled >= 1

        for t in threads:
            t.join(timeout=300)
        stop_joiner.set()
        joiner_t.join(timeout=60)
        arm_t.join(timeout=5)

        # Heartbeat-burst throttle probe: needs a live incarnation, so
        # a throwaway world joins here and beats back-to-back — the
        # coordinator must renew the lease but shed the payload.
        def _hb_probe():
            ws = [None, None]

            def boot(r):
                ws[r] = RingWorld(engines[r], r, 2, None,
                                  timeout_ms=15000, channels=1,
                                  controller=address,
                                  world_name="hb-probe")
            ts = [threading.Thread(target=boot, args=(r,))
                  for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            throttled = False
            w = ws[0]
            if w is not None and w._ctl_inc is not None:
                for _ in range(3):
                    resp = client.heartbeat(
                        "hb-probe", w.rank, w._ctl_inc, w.generation)
                    throttled = throttled or bool(resp.get("throttled"))
            for w in ws:
                if w is not None:
                    w.close()
            return throttled
        try:
            admission["hb_throttled"] = _hb_probe()
        except Exception:
            admission["hb_throttled"] = False

        # Join-backpressure probe: a NON-resizable world built full on
        # purpose (probing a churning fleet world races its members'
        # exits — a freed slot turns the expected reject into a park).
        # The extra rank=-1 join must bounce as RETRYABLE backpressure
        # with a deterministic retry-after, not park or hard-fail.
        def _join_probe():
            ws = [None, None]

            def boot(r):
                ws[r] = RingWorld(engines[r], r, 2, None,
                                  timeout_ms=15000, channels=1,
                                  controller=address,
                                  world_name="adm-probe")
            ts = [threading.Thread(target=boot, args=(r,))
                  for r in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            try:
                if any(w is None for w in ws):
                    return False
                r = client.join("adm-probe", 2, rank=-1, timeout_s=3.0)
                return (not r.get("ok") and bool(r.get("retryable"))
                        and float(r.get("retry_after_s", 0)) > 0)
            except ControlError:
                return False
            finally:
                for w in ws:
                    if w is not None:
                        w.close()
        try:
            admission["join_backpressure"] = _join_probe()
        except Exception:
            admission["join_backpressure"] = False

        # The verdict scrape: quiesce the background scraper first —
        # racing it against the scrape rate limit can starve this read
        # (two 429s in a row) and zero every metrics-derived gate —
        # then retry past the throttle window.
        stop_scraper.set()
        scraper_t.join(timeout=10)
        final = ""
        for _ in range(20):
            try:
                final = client.metrics()
                break
            except ControlError:
                time.sleep(0.15)
        with lock:
            scrapes.append(final)
    finally:
        stop_scraper.set()
        stop_joiner.set()
        restored.set()
        grow_armed.set()
        scraper_t.join(timeout=5)
        for t in threads:
            t.join(timeout=60)
        joiner_t.join(timeout=60)
        stuck = [t.name for t in threads + [joiner_t] if t.is_alive()]
        # Abandoned partial worlds (failed bring-up attempts) must be
        # collected while their engine is still LIVE — their MR
        # teardown against a closed engine is use-after-free at
        # interpreter exit.
        import gc

        gc.collect()
        for e in engines:
            try:
                e.close()
            except Exception:
                pass
        gc.collect()
        try:
            coord_proc.terminate()
            coord_proc.wait(timeout=10)
        except Exception:
            coord_proc.kill()
        if ring_ms_prev is None:
            os.environ.pop("TDR_RING_TIMEOUT_MS", None)
        else:
            os.environ["TDR_RING_TIMEOUT_MS"] = ring_ms_prev

    # Every member closed: the census must be back at the baseline —
    # a leaked tdr-ctl-hb-* thread is the heartbeat-after-leave bug.
    deadline = time.monotonic() + 10
    while hb_thread_census() > hb_base and time.monotonic() < deadline:
        time.sleep(0.2)
    hb_leaked = hb_thread_census() - hb_base
    hb_leaked_names = [t.name for t in threading.enumerate()
                       if t.name.startswith("tdr-ctl-hb-")
                       and t.is_alive()]

    resizes_served = metric_sum(final, "tdr_ctl_resizes_total{")
    failovers = metric_sum(final, "tdr_ctl_failovers_total ")
    rebuilds_baseline = metric_world(pre, "tdr_ctl_rebuilds_total",
                                     "fleet-03")
    rebuilds_final = metric_world(final, "tdr_ctl_rebuilds_total",
                                  "fleet-03")
    post_failover_rebuild = rebuilds_final > rebuilds_baseline
    share_grow = metric_world(final, "tdr_ctl_qp_share", "elastic-grow")
    share_flat = metric_world(final, "tdr_ctl_qp_share", "fleet-00")
    fair_share_ok = (0 < share_flat < qp_budget
                     and share_grow > share_flat)
    pinned_ok = all(any(p in s for s in scrapes) for p in PINNED)
    worlds_served = metric_sum(final, "tdr_ctl_worlds ")

    verdict.update({
        "errors": {k: repr(e) for k, e in sorted(errs.items())},
        "collectives_completed": dict(sorted(completed.items())),
        "parity": not errs and len(completed) >= n_fleet + 2,
        "resizes_served_on_metrics": resizes_served,
        "failovers_served_on_metrics": failovers,
        "post_failover_arbitrated_rebuild": post_failover_rebuild,
        "post_failover_rebuilds": {"baseline": rebuilds_baseline,
                                   "final": rebuilds_final},
        "generations_monotone": not gen_violations,
        "generation_violations": gen_violations[:8],
        "fair_share": {"elastic-grow": share_grow,
                       "fleet-00": share_flat, "ok": fair_share_ok},
        "admission": admission,
        "hb_threads_leaked": hb_leaked,
        "hb_threads_leaked_names": hb_leaked_names,
        "stuck_member_threads": stuck,
        "pinned_names_scraped": pinned_ok,
        "worlds_served": worlds_served,
        "scrapes": len(scrapes),
        "ctl_resize_adopted_events": trace.counter("ctl.resize_adopted"),
    })
    verdict["ok"] = bool(
        verdict["parity"] and verdict.get("resizes_observed")
        and verdict.get("restored_healthy")
        and resizes_served >= 2 and failovers >= 1
        and post_failover_rebuild and verdict["generations_monotone"]
        and fair_share_ok and admission.get("join_backpressure")
        and admission.get("scrape_throttled")
        and admission.get("hb_throttled")
        and hb_leaked == 0 and not stuck and pinned_ok
        and worlds_served >= 12)
    if own_snapdir:
        import shutil

        shutil.rmtree(snapshot_dir, ignore_errors=True)
    return verdict


def main() -> int:
    rounds = 6 if LITE else 8
    t0 = time.perf_counter()
    runs: dict = {}
    verdict = run_fleet(rounds=rounds, runs=runs)
    runs["seconds"] = round(time.perf_counter() - t0, 3)
    print("FLEET_RUN " + json.dumps(runs, sort_keys=True), flush=True)
    print(json.dumps(verdict, indent=2), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
