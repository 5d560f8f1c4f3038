"""Run the port's rendezvous coordinator as a standalone service: the
counterpart of ``tools/tdr_rendezvous.py``, with the same flags.

The control-plane process for a fleet: workers point
``RingWorld(controller="host:port", world_name=...)`` at it, it hands
out ring positions / base ports / generations, holds member leases,
arbitrates elastic rejoin and world RESIZE (shrink-to-survivors and
grow-on-join for ``resizable`` worlds), and serves Prometheus-style
SLOs on ``GET /metrics`` over the same port (chunk p99, retransmit
rate, NAK count, rebuild/generation/resize count, lease expiries).

    python -m rocnrdma_tpu_torch.tools.rendezvous --port 7070 \
        --lease-ms 5000 --port-base 36000

Redundancy: ``--snapshot-dir`` persists the full arbitration state
atomically every ``--snapshot-interval`` seconds; ``--restore`` boots
from the latest snapshot at the same address so members re-attach by
simply continuing to heartbeat (no fleet-wide re-rendezvous), and
``--standby`` runs a warm standby instead that tails the snapshots,
probes the primary's /healthz, and promotes itself on failure.

Admission control: ``--qp-fair`` divides ``--qp-budget`` across worlds
by join-time weight (``--qp-floor`` per-world minimum), ``--max-worlds``
caps the fleet (excess joins get a RETRYABLE "fleet full" with a
deterministic retry-after), and ``--hb-min-interval-ms`` /
``--scrape-min-interval-ms`` rate-limit per-world heartbeat pushes and
/metrics scrapes.

Stdlib-only; one process owns all lifecycle state (the "single owner
of lifecycle state" stance of the DMA streaming framework applied to
membership). SIGINT/SIGTERM shut it down cleanly (final snapshot
included when snapshotting is armed).
"""
import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="0.0.0.0",
                    help="bind address (default all interfaces)")
    ap.add_argument("--port", type=int, default=7070,
                    help="TCP port (0 = ephemeral, printed at start)")
    ap.add_argument("--lease-ms", type=int, default=5000,
                    help="member lease TTL; a rank that misses it is "
                         "declared dead and the generation bumps")
    ap.add_argument("--port-base", type=int, default=36000,
                    help="start of the port pool carved into per-world "
                         "base-port ranges")
    ap.add_argument("--port-stride", type=int, default=64,
                    help="ports reserved per world (>= world size)")
    ap.add_argument("--qp-budget", type=int, default=0,
                    help="per-world QP budget handed to members at "
                         "join (0 = unlimited)")
    ap.add_argument("--qp-fair", action="store_true",
                    help="divide --qp-budget across worlds by join "
                         "weight instead of handing every world the "
                         "full budget")
    ap.add_argument("--qp-floor", type=int, default=0,
                    help="per-world minimum QP share under --qp-fair")
    ap.add_argument("--snapshot-dir", default=None,
                    help="directory for periodic atomic state "
                         "snapshots (default $TDR_CTL_SNAPSHOT_DIR)")
    ap.add_argument("--snapshot-interval", type=float, default=2.0,
                    help="seconds between snapshots")
    ap.add_argument("--restore", action="store_true",
                    help="boot from the latest snapshot in "
                         "--snapshot-dir and resume arbitration")
    ap.add_argument("--standby", action="store_true",
                    help="run a warm standby: tail snapshots, probe "
                         "the primary, promote on failure")
    ap.add_argument("--probe-interval", type=float, default=1.0,
                    help="standby: seconds between primary /healthz "
                         "probes")
    ap.add_argument("--fail-threshold", type=int, default=3,
                    help="standby: consecutive probe failures before "
                         "promotion")
    ap.add_argument("--hb-min-interval-ms", type=int, default=0,
                    help="per-world heartbeat-push rate limit "
                         "(0 = off); throttled beats still renew the "
                         "lease but shed their telemetry payload")
    ap.add_argument("--scrape-min-interval-ms", type=int, default=0,
                    help="per-client /metrics rate limit (0 = off); "
                         "excess scrapes get HTTP 429")
    ap.add_argument("--max-worlds", type=int, default=0,
                    help="admission cap on named worlds (0 = no cap); "
                         "excess joins get a RETRYABLE 'fleet full'")
    args = ap.parse_args(argv)

    from rocnrdma_tpu_torch.control.coordinator import Coordinator, Standby

    done = threading.Event()

    def _stop(signum, frame):
        done.set()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)

    if args.standby:
        standby = Standby(args.snapshot_dir, host=args.host,
                          probe_interval_s=args.probe_interval,
                          fail_threshold=args.fail_threshold).start()
        print(f"tdr-rendezvous standby armed (snapshots: "
              f"{standby.snapshot_dir}, probing primary)", flush=True)
        while not done.is_set():
            if standby.promoted.wait(0.5):
                break
        if standby.promoted.is_set() and standby.coordinator is not None:
            print(f"tdr-rendezvous standby PROMOTED, listening on "
                  f"{standby.coordinator.address}", flush=True)
            done.wait()
        standby.stop()
        return 0

    coord = Coordinator(host=args.host, port=args.port,
                        lease_ms=args.lease_ms,
                        port_base=args.port_base,
                        port_stride=args.port_stride,
                        qp_budget=args.qp_budget,
                        qp_fair=args.qp_fair,
                        qp_floor=args.qp_floor,
                        snapshot_dir=args.snapshot_dir,
                        snapshot_interval_s=args.snapshot_interval,
                        restore=args.restore,
                        hb_min_interval_ms=args.hb_min_interval_ms,
                        scrape_min_interval_ms=args.scrape_min_interval_ms,
                        max_worlds=args.max_worlds).start()
    print(f"tdr-rendezvous listening on {coord.address} "
          f"(lease {args.lease_ms} ms, port pool {args.port_base}+"
          f"{args.port_stride}/world{', restored' if args.restore else ''}"
          f", metrics: GET /metrics)",
          flush=True)
    done.wait()
    coord.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
